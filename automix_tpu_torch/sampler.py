"""The AMSampler: the three-stage pipeline of the port.

Counterpart of ``automix_tpu/sampler.py``: ``estimate_conditional_probs``
(stage 1 + stage 2), ``set_proposal``, ``burn_samples``,
``rjmcmc_samples`` and ``model_probs``.  Stage 3 runs as a host loop over
``sweep_chunk``-sweep kernel launches; chunk statistics stay on the
device for ``chunk_flush_every`` chunks, then are absorbed on the host in
int64/float64.  The chain continues across burn/sample calls through the
global sweep counter.

The device is explicit: ``device="cuda"`` (the default) raises when CUDA
is missing, and nothing falls back to the CPU by itself.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import torch

from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.kernels import em, fused, rjmcmc, rwm
from automix_tpu_torch.model import Model, ModelSet
from automix_tpu_torch.state import Chains, CondProbStats, Proposal, RunStats


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class AMSampler:
    """Automatic RJMCMC sampler over a set of models."""

    def __init__(self, models: Union[ModelSet, Sequence[Model]],
                 config: Optional[EngineConfig] = None, device="cuda",
                 **overrides):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.cfg = config
        self.modelset = (models if isinstance(models, ModelSet)
                         else ModelSet(models))
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("AMSampler(device='cuda'): CUDA is not "
                                   "available; pass device='cpu' to run the "
                                   "plain PyTorch path")
            # raises for models without CUDA density descriptors
            self.modelset.density_table(self.device)
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.generator = torch.Generator().manual_seed(int(config.seed))
        self.proposal: Optional[Proposal] = None
        self.chains: Optional[Chains] = None
        self.cpstats = CondProbStats()
        self.stats: Optional[RunStats] = None
        self._runners = {}

    # -- internals --------------------------------------------------------

    def _runner(self, burning: bool):
        if burning not in self._runners:
            self._runners[burning] = fused.build_fused_chunk_runner(
                self.modelset, self.cfg, burning=burning)
        return self._runners[burning]

    def _ensure_proposal(self):
        if self.proposal is None:
            self.estimate_conditional_probs()

    def _ensure_chains(self):
        if self.chains is None:
            self.chains = rjmcmc.init_chains(self.modelset, self.cfg,
                                             self.generator, self.device)

    def _run_sweeps(self, nsweeps: int, burning: bool,
                    stats: Optional[RunStats]):
        runner = self._runner(burning)
        done = 0
        chunks = []

        def flush():
            for c in chunks:
                stats.absorb_chunk({k: v.cpu() for k, v in c.items()})
            chunks.clear()

        while done < nsweeps:
            n = min(self.cfg.sweep_chunk, nsweeps - done)
            self.chains, chunk = runner(self.chains, self.proposal, n)
            if stats is not None:
                # a bounded window of chunk results stays on the device
                # (a host sync per chunk would serialize the launches)
                chunks.append(chunk)
                if len(chunks) >= self.cfg.chunk_flush_every:
                    flush()
            done += n
        _sync(self.device)
        if stats is not None and chunks:
            flush()

    # -- public API -------------------------------------------------------

    def estimate_conditional_probs(self, nsweep2: Optional[int] = None,
                                   n_chains_stage1: Optional[int] = None):
        """Stages 1 + 2: adapt the within-model RWM scales and fit the
        Normal-mixture proposals."""
        t0 = time.perf_counter()
        nsweeps = nsweep2 if nsweep2 is not None else self.cfg.stage1_sweeps
        sig, samples, tele = rwm.run_stage1(
            self.modelset, self.cfg, self.generator, nsweeps, self.device,
            n_chains_per_model=n_chains_stage1)
        _sync(self.device)
        t1 = time.perf_counter()
        self.proposal, em_tele = em.fit_proposal(
            self.modelset, self.cfg, samples, sig, generator=self.generator)
        _sync(self.device)
        t2 = time.perf_counter()
        self.cpstats.sig_trace = tele["sig_trace"].numpy()
        self.cpstats.accept_trace = tele["accept_trace"].numpy()
        self.cpstats.em_trace = {k: v.cpu().numpy()
                                 for k, v in em_tele["em_trace"].items()}
        self.cpstats.em_iters = em_tele["em_iters"].cpu().numpy()
        self.cpstats.timesecs_stage1 = t1 - t0
        self.cpstats.timesecs_stage2 = t2 - t1
        self.cpstats.timesecs_condprobs = time.perf_counter() - t0
        self.cpstats.initialized = True
        return self.proposal

    def set_proposal(self, proposal: Proposal):
        """Install externally supplied proposal parameters (moved to the
        sampler's device, slot axis trimmed to the live maximum)."""
        moved = Proposal(**{f: getattr(proposal, f).to(self.device)
                            for f in ("lam", "mu", "B", "logdetB", "nmix",
                                      "sig")})
        self.proposal = em.trim_proposal(moved)
        self.cpstats.initialized = True

    def burn_samples(self, nsweeps: int):
        """Burn-in sweeps: pk adaptation off."""
        t0 = time.perf_counter()
        self._ensure_proposal()
        self._ensure_chains()
        self._run_sweeps(nsweeps, burning=True, stats=None)
        if self.stats is None:
            self.stats = RunStats(self.modelset.nmodels, self.modelset.dmax)
        self.stats.timesecs_burn += time.perf_counter() - t0

    def rjmcmc_samples(self, nsweeps: int,
                       collect: Optional[bool] = None) -> RunStats:
        """Production RJMCMC sweeps; returns the accumulated RunStats.
        Per-sweep traces (``collect=True``) are not ported yet."""
        if collect:
            raise NotImplementedError(
                "rjmcmc_samples(collect=True): per-sweep traces are not "
                "ported to automix_tpu_torch yet")
        t0 = time.perf_counter()
        self._ensure_proposal()
        self._ensure_chains()
        if self.stats is None:
            self.stats = RunStats(self.modelset.nmodels, self.modelset.dmax)
        stats = self.stats
        stats.n_chains = self.chains.n_chains
        self._run_sweeps(nsweeps, burning=False, stats=stats)
        stats.nsweeps += nsweeps
        stats.timesecs_rjmcmc += time.perf_counter() - t0
        return stats

    def model_probs(self):
        if self.stats is None:
            raise RuntimeError("run rjmcmc_samples first")
        return self.stats.model_probs
