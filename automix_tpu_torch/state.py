"""Engine state: the proposal and chain tensors, and host statistics.

Counterpart of ``automix_tpu/state.py``.  ``Proposal`` and ``Chains`` are
dataclasses of tensors in the JAX package's layouts (padded to
``dmax`` and ``lmax``: coordinates beyond a model's dim are 0, dead
mixture components have lam 0, mu 0, B = I, logdetB 0).  Chains carry no
per-chain PRNG key: every random word is a hash of (seed, sweep, chain,
slot).  ``RunStats`` and ``CondProbStats`` stay host numpy int64/float64,
so visit counters never overflow.
"""

from __future__ import annotations

import dataclasses

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
    pk [S, K], pkllim [S], nreinit [S] int32, and the global 1-based sweep
    counter shared by all chains (a Python int)."""

    k: torch.Tensor
    theta: torch.Tensor
    logp: torch.Tensor
    pk: torch.Tensor
    pkllim: torch.Tensor
    nreinit: torch.Tensor
    sweep: int

    @property
    def n_chains(self) -> int:
        return self.k.shape[0]


class RunStats:
    """Host-side accumulated stage-3 statistics (int64/float64)."""

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
