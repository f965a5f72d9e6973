"""Engine configuration of the PyTorch port.

Counterpart of ``automix_tpu/config.py``.  The constants are the same
numbers, and every knob the port honours has the JAX default.  The knobs
that select a path the port has not ported yet (pooled pk, HMC, the log
stage-1 rule) are rejected with ``NotImplementedError``.

The port has a single engine: the semantics of the JAX package's fused
kernels in their counter-hash (``fused_rng="hash"``) mode.  There is no
``fused`` / ``fused_rng`` / ``fused_stage1`` / ``rng`` switch.
"""

from __future__ import annotations

import dataclasses

import torch

# Mixture-fit modes (automix_tpu/config.py FIGUEIREDO_MIX_FIT, AUTORJ_MIX_FIT).
FIGUEIREDO_MIX_FIT = "figueiredo"
AUTORJ_MIX_FIT = "autorj"

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
    "within_move": "rwm",
    "pk_mode": "per_chain",
    "stage1_adapt": "aap",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of the ported engine (float32, per-chain pk,
    counter-hash randomness).  Field meanings and defaults are those of
    the JAX ``EngineConfig``."""

    seed: int
    adapt: bool                   # pk diminishing adaptation in stage 3
    perm: bool                    # permute the RJ latent (doPerm)
    student_t_dof: int            # Student-t perturbations; 0 = Normal
    mix_fit: str                  # "figueiredo" or "autorj"
    max_mix_comps: int            # mixture components per model (L max)
    max_em_iters: int
    n_chains: int                 # stage-3 parallel chains
    n_chains_stage1: int          # stage-1 chains per model
    stage1_target_samples: int    # stage-2 fit samples per model; 0 = 1000*dmax
    stage1_sweeps: int            # stage-1 sweeps before the +10% burn-in
    sweep_chunk: int              # sweeps per stage-3 kernel launch
    n_trace_chains: int           # chains whose model index is traced
    chunk_flush_every: int        # chunks kept on the device between flushes
    trace_chain0: bool            # record chain 0's traces by default
    trace_every: int              # sweeps between trace records
    dtype: torch.dtype

    def __init__(self, seed: int = 0, adapt: bool = True, perm: bool = False,
                 student_t_dof: int = 0, mix_fit: str = FIGUEIREDO_MIX_FIT,
                 max_mix_comps: int = 30, max_em_iters: int = 5000,
                 n_chains: int = 4096, n_chains_stage1: int = 2048,
                 stage1_target_samples: int = 0, stage1_sweeps: int = 10000,
                 sweep_chunk: int = 1000, n_trace_chains: int = 8,
                 chunk_flush_every: int = 8, trace_chain0: bool = True,
                 trace_every: int = 1, dtype: torch.dtype = torch.float32,
                 **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unknown EngineConfig field {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to automix_tpu_torch "
                    f"yet (only {name}={_UNPORTED[name]!r})")
        if mix_fit not in (FIGUEIREDO_MIX_FIT, AUTORJ_MIX_FIT):
            raise ValueError(f"unknown mix_fit {mix_fit!r}")
        if dtype != torch.float32:
            raise NotImplementedError("the port runs float32 only")
        if n_chains < 1:
            raise ValueError("n_chains must be >= 1")
        if sweep_chunk < 1 or chunk_flush_every < 1:
            raise ValueError("sweep_chunk and chunk_flush_every must be >= 1")
        if trace_every < 1:
            raise ValueError("trace_every must be >= 1")
        if student_t_dof < 0:
            raise ValueError("student_t_dof must be >= 0")
        fields = dict(seed=seed, adapt=adapt, perm=perm,
                      student_t_dof=student_t_dof, mix_fit=mix_fit,
                      max_mix_comps=max_mix_comps, max_em_iters=max_em_iters,
                      n_chains=n_chains, n_chains_stage1=n_chains_stage1,
                      stage1_target_samples=stage1_target_samples,
                      stage1_sweeps=stage1_sweeps, sweep_chunk=sweep_chunk,
                      n_trace_chains=n_trace_chains,
                      chunk_flush_every=chunk_flush_every,
                      trace_chain0=trace_chain0, trace_every=trace_every,
                      dtype=dtype)
        for name, value in fields.items():
            object.__setattr__(self, name, value)
