"""Full engine-state checkpoints.

Counterpart of ``automix_tpu/io/checkpoint.py``: one ``.npz`` holding the
chain state with the chains' threefry keys (``chains.key``, uint32
[S, 2] as JAX stores its legacy keys), the proposal, the global sweep
counter and the host run statistics, so a killed run continues with
identical trajectories: a ``threefry`` word is a function of the chain's
key and the sweep, a ``hash`` word of seed, sweep, chain and slot, and
the stage-3 kernel's ``hw`` stream is reseeded from (seed, the launch's
first sweep, chain) at every launch.  As in JAX, an ``hw`` run resumed at
a chunk boundary and chunked the same way reproduces bitwise; chunked
otherwise (another ``sweep_chunk``, or a resume inside a chunk) it draws
other words.  A checkpoint without keys (written before the port carried
them) gets keys made as ``init_chains`` makes them from the sampler's
seed, and says so in a log line.  Written atomically.

A sampler across devices (``AMSampler(mesh=)``) saves the whole run: the
ranks' chains are gathered and the mesh's first rank writes them, the
others waiting until the file is there; loading splits the chains over
the loading sampler's mesh (JAX checkpoint.py:113-116).  So a checkpoint
written on several devices resumes on one, and one written on one
resumes on several, continuing the same trajectories.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from automix_tpu_torch.parallel import mesh as mesh_lib
from automix_tpu_torch.state import Chains, Proposal, RunStats

FORMAT_VERSION = 1

_CHAIN_FIELDS = ("k", "theta", "logp", "pk", "pkllim", "nreinit")
_PROP_FIELDS = ("lam", "mu", "B", "logdetB", "nmix", "sig")
_STATS_SCALARS = ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
                  "ntrytd", "nsweeps", "n_chains")
_STATS_ARRAYS = ("ksummary", "theta_sum", "theta_sqsum", "theta_count")


def save_checkpoint(path: str, sampler) -> None:
    """Serialize an AMSampler's resumable state to ``path`` (.npz).
    Under a mesh every rank calls it (module note)."""
    mesh = getattr(sampler, "mesh", None)
    chains = (None if sampler.chains is None
              else mesh_lib.gather_chains(sampler.chains, mesh))
    if mesh is not None and mesh.rank != 0:
        mesh_lib.barrier(mesh)
        return
    arrays = {}
    meta = {"version": FORMAT_VERSION, "seed": sampler.cfg.seed,
            "nmodels": sampler.modelset.nmodels,
            "dmax": sampler.modelset.dmax}
    if chains is not None:
        for f in _CHAIN_FIELDS:
            arrays[f"chains.{f}"] = getattr(chains, f).cpu().numpy()
        arrays["chains.sweep"] = np.asarray(chains.sweep)
        if chains.key is not None:
            arrays["chains.key"] = chains.key.cpu().numpy().astype(np.uint32)
    if sampler.proposal is not None:
        for f in _PROP_FIELDS:
            arrays[f"proposal.{f}"] = \
                getattr(sampler.proposal, f).cpu().numpy()
    if sampler.stats is not None:
        st = sampler.stats
        for f in _STATS_ARRAYS:
            arrays[f"stats.{f}"] = getattr(st, f)
        meta["stats_scalars"] = {f: int(getattr(st, f))
                                 for f in _STATS_SCALARS}
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    # a run killed mid-save leaves the old checkpoint, never a torn one
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    os.replace(tmp, path)
    mesh_lib.barrier(mesh)


def load_checkpoint(path: str, sampler) -> None:
    """Restore state saved by :func:`save_checkpoint` into ``sampler``,
    on the sampler's device, after checking the model-set shape; under
    the sampler's mesh each rank keeps its block of the chains."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} != "
                             f"{FORMAT_VERSION}")
        ms = sampler.modelset
        if meta["nmodels"] != ms.nmodels or meta["dmax"] != ms.dmax:
            raise ValueError(
                f"checkpoint is for nmodels={meta['nmodels']} "
                f"dmax={meta['dmax']}, sampler has nmodels={ms.nmodels} "
                f"dmax={ms.dmax}")
        dev = sampler.device

        def tensor(name, dtype):
            return torch.tensor(z[name], dtype=dtype, device=dev)

        if "proposal.lam" in z:
            sampler.proposal = Proposal(**{
                f: tensor(f"proposal.{f}", torch.int32 if f == "nmix"
                          else torch.float32) for f in _PROP_FIELDS})
            sampler.cpstats.initialized = True
        if "chains.k" in z:
            n = int(z["chains.k"].shape[0])
            if "chains.key" in z:
                key = torch.tensor(z["chains.key"].astype(np.int64),
                                   device=dev)
            else:
                from automix_tpu_torch.kernels.rjmcmc import init_keys
                key = init_keys(sampler.cfg, n, dev)
                logging.getLogger("automix_tpu_torch").info(
                    "checkpoint %s has no chains.key: made %d chain keys as "
                    "init_chains does from seed %d", path, n,
                    sampler.cfg.seed)
            sampler.chains = Chains(
                **{f: tensor(f"chains.{f}", torch.int32
                             if f in ("k", "nreinit") else torch.float32)
                   for f in _CHAIN_FIELDS},
                sweep=int(z["chains.sweep"]), key=key)
            mesh = getattr(sampler, "mesh", None)
            if mesh is not None:
                sampler.chains = mesh_lib.shard_chains(sampler.chains, mesh)
        if "stats.ksummary" in z:
            st = RunStats(ms.nmodels, ms.dmax)
            for f in _STATS_ARRAYS:
                setattr(st, f, z[f"stats.{f}"])
            for f, v in meta.get("stats_scalars", {}).items():
                setattr(st, f, v)
            sampler.stats = st
