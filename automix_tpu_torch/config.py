"""Engine configuration of the PyTorch port.

Counterpart of ``automix_tpu/config.py``.  The constants are the same
numbers; ``EngineConfig`` keeps only the knobs this port honours and
rejects, with ``NotImplementedError``, the ones that select a path it has
not ported yet (Student-t, perm, pooled pk, HMC, AutoRJ, the log stage-1
rule, decimated traces).

The port has a single engine: the semantics of the JAX package's fused
kernels in their counter-hash (``fused_rng="hash"``) mode.  There is no
``fused`` / ``fused_rng`` / ``fused_stage1`` / ``rng`` switch.
"""

from __future__ import annotations

import dataclasses

import torch

# Value used in place of -DBL_MAX for out-of-support states (finite in
# float32 so arithmetic blends never see 0 * inf).
NEG_INF = -1e30

# MH acceptance clamp: accept with prob exp(max(-30, min(0, logratio))).
LOG_ACCEPT_CLAMP = -30.0

# Stage-1 target acceptance rate.
RWM_TARGET_ACCEPT = 0.25

# Figueiredo-Jain component annihilation threshold.
EM_ANNIHILATION_THRESHOLD = 0.005

# Degenerate E-step guard on the log scale (uniform responsibilities and a
# fixed log-likelihood penalty for points no component explains).
EM_DEGENERATE_LOGSUM = -700.0
EM_DEGENERATE_PENALTY = -500.0

# Knobs of the JAX EngineConfig that select paths this port has not ported
# yet, with the value that keeps the ported path.
_UNPORTED = {
    "perm": False,
    "student_t_dof": 0,
    "mix_fit": "figueiredo",
    "within_move": "rwm",
    "pk_mode": "per_chain",
    "stage1_adapt": "aap",
    "trace_every": 1,
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of the ported engine (float32, Gaussian
    proposals, per-chain pk, no perm, counter-hash randomness)."""

    seed: int
    adapt: bool                   # pk diminishing adaptation in stage 3
    max_mix_comps: int            # mixture components per model (L max)
    max_em_iters: int
    n_chains: int                 # stage-3 parallel chains
    n_chains_stage1: int          # stage-1 chains per model
    stage1_target_samples: int    # stage-2 fit samples per model; 0 = 1000*dmax
    stage1_sweeps: int            # stage-1 sweeps before the +10% burn-in
    sweep_chunk: int              # sweeps per stage-3 kernel launch
    chunk_flush_every: int        # chunks kept on the device between flushes
    trace_chain0: bool            # per-sweep traces are a later slice
    dtype: torch.dtype

    def __init__(self, seed: int = 0, adapt: bool = True,
                 max_mix_comps: int = 30, max_em_iters: int = 5000,
                 n_chains: int = 4096, n_chains_stage1: int = 2048,
                 stage1_target_samples: int = 0, stage1_sweeps: int = 10000,
                 sweep_chunk: int = 1000, chunk_flush_every: int = 8,
                 trace_chain0: bool = False,
                 dtype: torch.dtype = torch.float32, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unknown EngineConfig field {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to automix_tpu_torch "
                    f"yet (only {name}={_UNPORTED[name]!r})")
        if trace_chain0:
            raise NotImplementedError(
                "trace_chain0=True: per-sweep traces are not ported yet")
        if dtype != torch.float32:
            raise NotImplementedError("the port runs float32 only")
        if n_chains < 1:
            raise ValueError("n_chains must be >= 1")
        if sweep_chunk < 1 or chunk_flush_every < 1:
            raise ValueError("sweep_chunk and chunk_flush_every must be >= 1")
        fields = dict(seed=seed, adapt=adapt, max_mix_comps=max_mix_comps,
                      max_em_iters=max_em_iters, n_chains=n_chains,
                      n_chains_stage1=n_chains_stage1,
                      stage1_target_samples=stage1_target_samples,
                      stage1_sweeps=stage1_sweeps, sweep_chunk=sweep_chunk,
                      chunk_flush_every=chunk_flush_every,
                      trace_chain0=trace_chain0, dtype=dtype)
        for name, value in fields.items():
            object.__setattr__(self, name, value)
