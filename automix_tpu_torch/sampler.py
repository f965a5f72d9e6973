"""The AMSampler: the three-stage pipeline of the port.

Counterpart of ``automix_tpu/sampler.py``: ``estimate_conditional_probs``
(stage 1 + stage 2), ``set_proposal``, ``burn_samples``,
``rjmcmc_samples``, ``model_probs``, ``retune_hmc``, ``smc_evidence`` and
``save``/``load``.  The sampler carries JAX's key chain: a threefry key
of the seed, split at each use in JAX's order (stage 1, stage 2, the HMC
tuner, the chains, SMC), so a run's stage-1 keys, chain keys, tuning
key and SMC key are JAX's.  Stage 2 draws its seeding indices from a
torch.Generator of the seed; it still takes its key, so the later keys
stay aligned.  Stage 3 runs
as a host loop over ``sweep_chunk``-sweep kernel launches; chunk
statistics stay on the device for ``chunk_flush_every`` chunks, then are
absorbed on the host in int64/float64.  The chain continues across
burn/sample calls through the global sweep counter.

The engine rule.  Each stage-3 runner build asks ``fused.eligible``
and each stage-1 run ``fused_stage1.stage1_eligible``: the CUDA kernels
serve a model set when every model has a CUDA density at a (K, D) they
are instantiated for (and, in stage 3, the proposal's L fits the sweep
kernel); the general engine (``kernels/rjmcmc.py``, ``kernels/rwm.py``,
plain torch on the same device, K4 for ``rng="pallas"``) serves every
other set, and every set under ``fused="off"`` / ``fused_stage1="off"``.
``"on"`` raises for a set the kernels cannot serve.  One line on the
``automix_tpu_torch`` logger names the engine and the reason at each
runner build, as JAX's ``_log_engine``, and for the kernel engine the
stage-3 stream ``fused_rng`` resolves to on the device ("kernel engine,
rng hw" on the card by default: ``fused.resolve_rng``).

Traces follow the JAX decimation (``trace_every``): a traced run on the
kernels launches ``trace_every``-sweep chunks and records a snapshot of
the state after each (at ``trace_every=1`` exactly a per-sweep trace).
The general engine records stride-1 traces inside its chunks, as JAX's
XLA engine does, and decimates as the kernels do.

The device is explicit: ``device="cuda"`` (the default) raises when CUDA
is missing, and nothing falls back to the CPU by itself.

Across devices (``mesh=``, a ``parallel.mesh.ChainMesh``; JAX's
``AMSampler(mesh=)``) the device is the mesh's.  Stage 1 and the EM run
with their chains and samples split over the ranks; the stage-3 chains
are built whole from the seed on every rank and then split
(``shard_chains``), and the proposal is replicated from rank 0.  Every
runner sums its statistics across the ranks, so every rank holds the
same ``RunStats``.  ``n_chains`` and ``n_chains_stage1`` must split
evenly over the ranks.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Union

import torch

from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.kernels import em, fused, rjmcmc, rwm
from automix_tpu_torch.model import Model, ModelSet
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.parallel import mesh as mesh_lib
from automix_tpu_torch.state import Chains, CondProbStats, Proposal, RunStats


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class AMSampler:
    """Automatic RJMCMC sampler over a set of models."""

    def __init__(self, models: Union[ModelSet, Sequence[Model]],
                 config: Optional[EngineConfig] = None, device=None,
                 mesh=None, **overrides):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.cfg = config
        self.modelset = (models if isinstance(models, ModelSet)
                         else ModelSet(models))
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"AMSampler: device={device} is not the "
                                 f"mesh's {mesh.device}")
            device = mesh.device
            for name in ("n_chains", "n_chains_stage1"):
                mesh.local(getattr(config, name), name)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("AMSampler(device='cuda'): CUDA is not "
                                   "available; pass device='cpu' to run the "
                                   "plain PyTorch path")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.generator = torch.Generator().manual_seed(int(config.seed))
        self.key = randoms.key(int(config.seed))
        self.proposal: Optional[Proposal] = None
        self.chains: Optional[Chains] = None
        self.cpstats = CondProbStats()
        self.stats: Optional[RunStats] = None
        self._runners = {}

    # -- internals --------------------------------------------------------

    def _next_key(self):
        self.key, sub = randoms.split_host(self.key, 2)
        return sub

    def _runner(self, burning: bool, collect: bool):
        """The stage-3 runner of the engine the rule picks; ``collect``
        (per-sweep traces inside the chunk) only on the general engine."""
        kernels, why = fused.eligible(self.modelset, self.cfg,
                                      self.proposal.lmax, self.device,
                                      self.mesh)
        key = (burning, collect and not kernels, kernels)
        if key not in self._runners:
            if kernels:
                self._runners[key] = fused.build_fused_chunk_runner(
                    self.modelset, self.cfg, burning=burning,
                    mesh=self.mesh)
            else:
                self._runners[key] = rjmcmc.build_chunk_runner(
                    self.modelset, self.cfg, burning=burning,
                    collect=key[1], mesh=self.mesh)
            engine = (f"kernel engine, rng "
                      f"{fused.resolve_rng(self.cfg.fused_rng, self.device)}"
                      if kernels else "general engine")
            logging.getLogger("automix_tpu_torch").info(
                "stage-3 %s runner: %s (%s)",
                "burn-in" if burning else "production", engine, why)
        return self._runners[key], kernels

    def _ensure_proposal(self):
        if self.proposal is None:
            self.estimate_conditional_probs()

    def _ensure_hmc_tuned(self):
        """Dual-average the per-model HMC step multipliers before the
        first stage-3 runner is built: a no-op unless within_move='hmc'
        with autotune on and a still-scalar hmc_step_scale."""
        if (self.cfg.within_move != "hmc" or not self.cfg.hmc_autotune
                or isinstance(self.cfg.hmc_step_scale, tuple)
                or self._runners):
            return
        self.retune_hmc()

    def _ensure_chains(self):
        if self.chains is None:
            self.chains = rjmcmc.init_chains(self.modelset, self.cfg,
                                             self._next_key(), self.device)
            if self.mesh is not None:
                self.chains = mesh_lib.shard_chains(self.chains, self.mesh)
                self.proposal = mesh_lib.replicate(self.proposal, self.mesh)

    def _run_sweeps(self, nsweeps: int, burning: bool, collect: bool,
                    stats: Optional[RunStats]):
        stride = self.cfg.trace_every
        runner, kernels = self._runner(burning, collect and stride == 1)
        snapshot = collect and (kernels or stride > 1)
        chunk_len = stride if snapshot else self.cfg.sweep_chunk
        done = 0
        chunks = []

        def flush():
            for c in chunks:
                stats.absorb_chunk({k: v.cpu() for k, v in c.items()})
            chunks.clear()

        while done < nsweeps:
            n = min(chunk_len, nsweeps - done)
            self.chains, chunk = runner(self.chains, self.proposal, n)
            if stats is not None:
                if snapshot:
                    chunk = dict(chunk, **self._trace_snapshot())
                if collect:
                    stats.trace_stride = stride
                # a bounded window of chunk results stays on the device
                # (a host sync per chunk would serialize the launches)
                chunks.append(chunk)
                if len(chunks) >= self.cfg.chunk_flush_every:
                    flush()
            done += n
        _sync(self.device)
        if stats is not None and chunks:
            flush()

    def _trace_snapshot(self):
        """One trace entry from the current chain state (of the global
        chain prefix: under a mesh, rank 0's chains, broadcast)."""
        ch = self.chains
        nt = min(self.cfg.n_trace_chains, ch.n_chains)
        return {name: mesh_lib.broadcast(v, self.mesh) for name, v in (
            ("k_trace", ch.k[None, :nt].to(torch.int8)),
            ("k0_trace", ch.k[None, 0].to(torch.int8)),
            ("pk0_trace", ch.pk[None, 0]),
            ("logp0_trace", ch.logp[None, 0]),
            ("theta0_trace", ch.theta[None, 0]))}

    # -- public API -------------------------------------------------------

    def estimate_conditional_probs(self, nsweep2: Optional[int] = None,
                                   n_chains_stage1: Optional[int] = None):
        """Stages 1 + 2: adapt the within-model RWM scales and fit the
        Normal-mixture proposals."""
        t0 = time.perf_counter()
        nsweeps = nsweep2 if nsweep2 is not None else self.cfg.stage1_sweeps
        sig, samples, tele = rwm.run_stage1(
            self.modelset, self.cfg, self._next_key(), nsweeps, self.device,
            n_chains_per_model=n_chains_stage1, mesh=self.mesh)
        _sync(self.device)
        t1 = time.perf_counter()
        self._next_key()          # stage 2's key in JAX's order
        self.proposal, em_tele = em.fit_proposal(
            self.modelset, self.cfg, samples, sig, generator=self.generator,
            mesh=self.mesh)
        _sync(self.device)
        t2 = time.perf_counter()
        self.cpstats.sig_trace = tele["sig_trace"].numpy()
        self.cpstats.accept_trace = tele["accept_trace"].numpy()
        if "em_trace" in em_tele:
            self.cpstats.em_trace = {k: v.cpu().numpy()
                                     for k, v in em_tele["em_trace"].items()}
            self.cpstats.em_iters = em_tele["em_iters"].cpu().numpy()
        self.cpstats.timesecs_stage1 = t1 - t0
        self.cpstats.timesecs_stage2 = t2 - t1
        self.cpstats.timesecs_condprobs = time.perf_counter() - t0
        self.cpstats.initialized = True
        if (self.cfg.within_move == "hmc" and self.cfg.hmc_autotune
                and isinstance(self.cfg.hmc_step_scale, tuple)):
            # tuned against the old fit's sig, which the re-fit changed
            self.retune_hmc()
        return self.proposal

    def set_proposal(self, proposal: Proposal):
        """Install externally supplied proposal parameters (moved to the
        sampler's device, slot axis trimmed to the live maximum; under a
        mesh, rank 0's on every rank)."""
        moved = Proposal(**{f: getattr(proposal, f).to(self.device)
                            for f in ("lam", "mu", "B", "logdetB", "nmix",
                                      "sig")})
        if self.mesh is not None:
            moved = mesh_lib.replicate(moved, self.mesh)
        self.proposal = em.trim_proposal(moved)
        self.cpstats.initialized = True

    def burn_samples(self, nsweeps: int):
        """Burn-in sweeps: pk adaptation off."""
        t0 = time.perf_counter()
        self._ensure_proposal()
        self._ensure_hmc_tuned()
        self._ensure_chains()
        self._run_sweeps(nsweeps, burning=True, collect=False, stats=None)
        if self.stats is None:
            self.stats = RunStats(self.modelset.nmodels, self.modelset.dmax)
        self.stats.timesecs_burn += time.perf_counter() - t0

    def rjmcmc_samples(self, nsweeps: int,
                       collect: Optional[bool] = None) -> RunStats:
        """Production RJMCMC sweeps; returns the accumulated RunStats.
        ``collect`` (default ``cfg.trace_chain0``) records traces every
        ``cfg.trace_every`` sweeps."""
        if collect is None:
            collect = self.cfg.trace_chain0
        t0 = time.perf_counter()
        self._ensure_proposal()
        self._ensure_hmc_tuned()
        self._ensure_chains()
        if self.stats is None:
            self.stats = RunStats(self.modelset.nmodels, self.modelset.dmax)
        stats = self.stats
        stats.n_chains = self.chains.n_chains * (
            1 if self.mesh is None else self.mesh.size)
        self._run_sweeps(nsweeps, burning=False, collect=collect,
                         stats=stats)
        stats.nsweeps += nsweeps
        stats.timesecs_rjmcmc += time.perf_counter() - t0
        return stats

    def model_probs(self):
        if self.stats is None:
            raise RuntimeError("run rjmcmc_samples first")
        return self.stats.model_probs

    def retune_hmc(self):
        """Run the HMC step-size tuner (``kernels/hmc.py
        tune_step_scale``) against the current proposal's sig with the
        next key, install the per-model multipliers as
        ``hmc_step_scale`` and drop the stage-3 runners built with the
        old ones.  Returns the [K] multipliers."""
        if self.cfg.within_move != "hmc":
            raise RuntimeError("retune_hmc requires within_move='hmc'")
        self._ensure_proposal()
        from automix_tpu_torch.kernels.hmc import tune_step_scale
        scales = tune_step_scale(self.modelset, self.cfg, self.proposal.sig,
                                 self._next_key(), device=self.device,
                                 mesh=self.mesh)
        self.cfg = dataclasses.replace(
            self.cfg, hmc_step_scale=tuple(float(x) for x in scales))
        self._runners.clear()
        return scales

    def smc_evidence(self, n_particles: int = 2048, n_temps: int = 20,
                     n_moves: int = 3, tempering: str = "adaptive",
                     ess_target: float = 0.5):
        """Annealed-SMC model evidences (``kernels/smc.py run_smc``) from
        the fitted proposal, with the next key: a dict of
        ``log_evidence``, ``model_probs``, ``ess``, ``betas_used``,
        ``theta`` and ``logp`` as numpy arrays."""
        from automix_tpu_torch.kernels import smc
        self._ensure_proposal()
        return smc.run_smc(self.modelset, self.cfg, self.proposal,
                           self._next_key(), n_particles=n_particles,
                           n_temps=n_temps, n_moves=n_moves,
                           tempering=tempering, ess_target=ess_target,
                           mesh=self.mesh)

    def save(self, path: str):
        """Checkpoint the resumable state (chains, proposal, statistics);
        see io/checkpoint.py.  Under a mesh every rank calls it: the
        chains are gathered and the primary writes."""
        from automix_tpu_torch.io import checkpoint
        checkpoint.save_checkpoint(path, self)

    def load(self, path: str):
        """Restore state written by :meth:`save`; the next burn/rjmcmc call
        continues the exact trajectories."""
        from automix_tpu_torch.io import checkpoint
        checkpoint.load_checkpoint(path, self)
