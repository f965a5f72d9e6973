"""Engine state: the proposal and chain tensors, and host statistics.

Counterpart of ``automix_tpu/state.py``.  ``Proposal`` and ``Chains`` are
dataclasses of tensors in the JAX package's layouts (padded to
``dmax`` and ``lmax``: coordinates beyond a model's dim are 0, dead
mixture components have lam 0, mu 0, B = I, logdetB 0).  Chains carry
one threefry key per chain, as JAX's do: the general engine's
``threefry`` stream folds it with the sweep, while the hash streams and
K4 draw words from (seed, sweep, chain, slot) and leave it as it is.
``RunStats`` and ``CondProbStats`` stay host numpy int64/float64,
so visit counters never overflow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Proposal:
    """Adapted proposal: lam [K, L], mu [K, L, D], B [K, L, D, D],
    logdetB [K, L], nmix [K] int32, sig [K, D]."""

    lam: torch.Tensor
    mu: torch.Tensor
    B: torch.Tensor
    logdetB: torch.Tensor
    nmix: torch.Tensor
    sig: torch.Tensor

    @property
    def lmax(self) -> int:
        return self.lam.shape[1]


@dataclasses.dataclass
class Chains:
    """Stage-3 chain batch: k [S] int32, theta [S, D], logp [S],
    pk [S, K], pkllim [S], nreinit [S] int32, the global 1-based sweep
    counter shared by all chains (a Python int) and the chains' threefry
    keys [S, 2] (uint32 words in int64; None for a batch made without
    them, which only the hash streams and K4 can sweep)."""

    k: torch.Tensor
    theta: torch.Tensor
    logp: torch.Tensor
    pk: torch.Tensor
    pkllim: torch.Tensor
    nreinit: torch.Tensor
    sweep: int
    key: Optional[torch.Tensor] = None

    @property
    def n_chains(self) -> int:
        return self.k.shape[0]


# Trace entries of a chunk and their host dtypes.
_TRACES = {"k_trace": np.int8, "k0_trace": np.int8, "pk0_trace": np.float64,
           "logp0_trace": np.float64, "theta0_trace": np.float64}


class RunStats:
    """Host-side accumulated stage-3 statistics (int64/float64), and the
    traces of a traced run: the model index of the first
    ``n_trace_chains`` chains and chain 0's k, pk, logp and theta, one
    entry every ``trace_stride`` sweeps."""

    def __init__(self, nmodels: int, dmax: int):
        self.nmodels = nmodels
        self.dmax = dmax
        self.ksummary = np.zeros(nmodels, np.int64)
        self.theta_sum = np.zeros((nmodels, dmax), np.float64)
        self.theta_sqsum = np.zeros((nmodels, dmax), np.float64)
        self.theta_count = np.zeros(nmodels, np.int64)
        self.naccrwmb = 0
        self.ntryrwmb = 0
        self.naccrwms = 0
        self.ntryrwms = 0
        self.nacctd = 0
        self.ntrytd = 0
        self.nsweeps = 0
        self.n_chains = 0
        # Sweeps between trace entries (RunStats.trace_stride of the JAX
        # package): Sokal tau of a trace is scaled by it into sweeps.
        self.trace_stride = 1
        self._traces = {name: [] for name in _TRACES}
        self.timesecs_burn = 0.0
        self.timesecs_rjmcmc = 0.0

    def absorb_chunk(self, chunk: dict):
        self.ksummary += np.asarray(chunk["ksummary"], np.int64)
        self.theta_sum += np.asarray(chunk["theta_sum"], np.float64)
        self.theta_sqsum += np.asarray(chunk["theta_sqsum"], np.float64)
        self.theta_count += np.asarray(chunk["ksummary"], np.int64)
        self.naccrwmb += int(chunk["naccrwmb"])
        self.ntryrwmb += int(chunk["ntryrwmb"])
        self.naccrwms += int(chunk["naccrwms"])
        self.ntryrwms += int(chunk["ntryrwms"])
        self.nacctd += int(chunk["nacctd"])
        self.ntrytd += int(chunk["ntrytd"])
        for name, dtype in _TRACES.items():
            if name in chunk:
                self._traces[name].append(np.asarray(chunk[name], dtype))

    def _trace(self, name: str):
        parts = self._traces[name]
        return np.concatenate(parts, axis=0) if parts else None

    @property
    def k_trace(self):
        """[n_entries, n_trace_chains] model-index traces (Sokal IACT)."""
        return self._trace("k_trace")

    @property
    def k0_trace(self):
        return self._trace("k0_trace")

    @property
    def pk_trace(self):
        return self._trace("pk0_trace")

    @property
    def logp_trace(self):
        return self._trace("logp0_trace")

    @property
    def theta0_trace(self):
        return self._trace("theta0_trace")

    @property
    def model_probs(self) -> np.ndarray:
        """Posterior model probabilities as visit fractions."""
        total = self.ksummary.sum()
        return self.ksummary / max(total, 1)

    def theta_mean(self) -> np.ndarray:
        cnt = np.maximum(self.theta_count, 1)[:, None]
        return self.theta_sum / cnt

    def theta_std(self) -> np.ndarray:
        cnt = np.maximum(self.theta_count, 1)[:, None]
        mean = self.theta_sum / cnt
        var = np.maximum(self.theta_sqsum / cnt - mean ** 2, 0.0)
        return np.sqrt(var)


class CondProbStats:
    """Host-side stage-1/2 telemetry."""

    def __init__(self):
        self.sig_trace = None        # [T, K, D] sig at segment boundaries
        self.accept_trace = None     # [T, K, D] pooled acceptance ratio
        self.em_trace = None         # dict of [K, max_iters] arrays
        self.em_iters = None         # [K] iterations used
        self.timesecs_condprobs = 0.0
        self.timesecs_stage1 = 0.0
        self.timesecs_stage2 = 0.0
        self.initialized = False
