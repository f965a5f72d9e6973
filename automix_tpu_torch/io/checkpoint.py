"""Full engine-state checkpoints.

Counterpart of ``automix_tpu/io/checkpoint.py``: one ``.npz`` holding the
chain state, the proposal, the global sweep counter and the host run
statistics, so a killed run continues with identical trajectories.  The
port's chains carry no PRNG keys (every word is a hash of seed, sweep,
chain and slot), so there is no ``chains.key`` entry.  Written atomically.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from automix_tpu_torch.state import Chains, Proposal, RunStats

FORMAT_VERSION = 1

_CHAIN_FIELDS = ("k", "theta", "logp", "pk", "pkllim", "nreinit")
_PROP_FIELDS = ("lam", "mu", "B", "logdetB", "nmix", "sig")
_STATS_SCALARS = ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
                  "ntrytd", "nsweeps", "n_chains")
_STATS_ARRAYS = ("ksummary", "theta_sum", "theta_sqsum", "theta_count")


def save_checkpoint(path: str, sampler) -> None:
    """Serialize an AMSampler's resumable state to ``path`` (.npz)."""
    arrays = {}
    meta = {"version": FORMAT_VERSION, "seed": sampler.cfg.seed,
            "nmodels": sampler.modelset.nmodels,
            "dmax": sampler.modelset.dmax}
    if sampler.chains is not None:
        for f in _CHAIN_FIELDS:
            arrays[f"chains.{f}"] = getattr(sampler.chains, f).cpu().numpy()
        arrays["chains.sweep"] = np.asarray(sampler.chains.sweep)
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


def load_checkpoint(path: str, sampler) -> None:
    """Restore state saved by :func:`save_checkpoint` into ``sampler``,
    on the sampler's device, after checking the model-set shape."""
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
            sampler.chains = Chains(
                **{f: tensor(f"chains.{f}", torch.int32
                             if f in ("k", "nreinit") else torch.float32)
                   for f in _CHAIN_FIELDS},
                sweep=int(z["chains.sweep"]))
        if "stats.ksummary" in z:
            st = RunStats(ms.nmodels, ms.dmax)
            for f in _STATS_ARRAYS:
                setattr(st, f, z[f"stats.{f}"])
            for f, v in meta.get("stats_scalars", {}).items():
                setattr(st, f, v)
            sampler.stats = st
