"""Engine configuration of the PyTorch port.

Counterpart of ``automix_tpu/config.py``.  The constants are the same
numbers, and every knob has the JAX default and the JAX checks.

The port has two engines: the CUDA kernels, with the semantics of the
JAX package's fused kernels, and the general engine in plain torch
(``kernels/rjmcmc.py``, ``kernels/rwm.py``).  ``fused`` and
``fused_stage1`` ("auto", "on", "off") select between them for stage 3
and stage 1 (``AMSampler``'s engine rule).  ``fused_rng`` ("auto", "hw",
"hash") selects the stage-3 kernel's stream, as in JAX: "hash" is the
counter hash, every word a pure function of (seed, sweep, chain, slot)
and bitwise the JAX package's words; "hw" is the port's chunk-granular
stream in place of the TPU's hardware PRNG (``ops/randoms.py`` ``hw_*``,
other words than JAX's); "auto" is "hw" on the card and "hash" on the
CPU, as JAX's is "hw" on its chip and "hash" under its interpreter.  The
stage-1 kernels draw hash words only, as JAX's do.  ``rng`` ("auto",
"threefry", "fast", "pallas") selects the general engine's stage-3
stream: JAX's threefry words from per-chain keys (``ops/randoms.py``),
the ``fast`` counter hash, or K4; "auto" is "fast" for Gaussian runs
and "threefry" for Student-t, as in JAX.  The general engine's stage 1
always draws threefry words, as JAX's XLA scan does.

``within_move`` ("rwm", "hmc") and the ``hmc_*`` knobs select stage 3's
within-model move; HMC runs on the general engine (``kernels/hmc.py``).
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

# Stage-1 scale-adaptation rules (automix_tpu/config.py stage1_adapt): the
# reference's additive AAP update sig = max(sig + 10 gamma (acc - 0.25), 0),
# or the multiplicative sig * exp(gain gamma (acc - 0.25)), which adapts
# scales far below the additive gain (the change-point rates at 1e-3 from
# sig = 10).
STAGE1_RULES = ("aap", "log")

# Engine switches and the general engine's streams (automix_tpu/config.py
# fused, fused_stage1, rng).
ENGINE_SWITCHES = ("auto", "on", "off")
RNG_MODES = ("auto", "threefry", "fast", "pallas")
# The stage-3 kernel's streams (automix_tpu/config.py fused_rng).
FUSED_RNG_MODES = ("auto", "hw", "hash")

# Stage-3 within-model moves (automix_tpu/config.py within_move): the
# reference's RWM, or leapfrog HMC preconditioned by the stage-1 scales.
WITHIN_MOVES = ("rwm", "hmc")

# Stage-3 pk adaptation scopes (automix_tpu/config.py pk_mode): every chain
# adapts its own pk, or one shared pk adapts from the population's visit
# histogram (automix.c:1258-1281).
PK_MODES = ("per_chain", "pooled")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of the ported engine (float32).  Field
    meanings and defaults are those of the JAX ``EngineConfig``."""

    seed: int
    adapt: bool                   # pk diminishing adaptation in stage 3
    pk_mode: str                  # "per_chain" or "pooled"
    within_move: str              # stage-3 within-model move: rwm or hmc
    hmc_steps: int                # (max) leapfrog steps of an HMC move
    hmc_jitter: bool              # trajectory length uniform in 1..hmc_steps
    hmc_step_scale: object        # step = scale * sig; a float or K floats
    hmc_autotune: bool            # dual-average a scalar scale per model
    hmc_target_accept: float      # the tuner's target acceptance
    perm: bool                    # permute the RJ latent (doPerm)
    student_t_dof: int            # Student-t perturbations; 0 = Normal
    mix_fit: str                  # "figueiredo" or "autorj"
    max_mix_comps: int            # mixture components per model (L max)
    max_em_iters: int
    n_chains: int                 # stage-3 parallel chains
    n_chains_stage1: int          # stage-1 chains per model
    stage1_target_samples: int    # stage-2 fit samples per model; 0 = 1000*dmax
    stage1_sweeps: int            # stage-1 sweeps before the +10% burn-in
    stage1_adapt: str             # stage-1 rule: "aap" or "log"
    stage1_log_gain: float        # gain of the "log" rule
    sweep_chunk: int              # sweeps per stage-3 kernel launch
    n_trace_chains: int           # chains whose model index is traced
    chunk_flush_every: int        # chunks kept on the device between flushes
    trace_chain0: bool            # record chain 0's traces by default
    trace_every: int              # sweeps between trace records
    rng: str                      # general engine's stream: auto/threefry/
    #                               fast/pallas
    fused: str                    # stage-3 engine: auto/on/off (kernels)
    fused_rng: str                # stage-3 kernel's stream: auto/hw/hash
    fused_stage1: str             # stage-1 engine: auto/on/off (kernels)
    dtype: torch.dtype

    def __init__(self, seed: int = 0, adapt: bool = True,
                 pk_mode: str = "per_chain", within_move: str = "rwm",
                 hmc_steps: int = 5, hmc_jitter: bool = True,
                 hmc_step_scale=0.2, hmc_autotune: bool = True,
                 hmc_target_accept: float = 0.65, perm: bool = False,
                 student_t_dof: int = 0, mix_fit: str = FIGUEIREDO_MIX_FIT,
                 max_mix_comps: int = 30, max_em_iters: int = 5000,
                 n_chains: int = 4096, n_chains_stage1: int = 2048,
                 stage1_target_samples: int = 0, stage1_sweeps: int = 10000,
                 stage1_adapt: str = "aap", stage1_log_gain: float = 3.0,
                 sweep_chunk: int = 1000, n_trace_chains: int = 8,
                 chunk_flush_every: int = 8, trace_chain0: bool = True,
                 trace_every: int = 1, rng: str = "auto",
                 fused: str = "auto", fused_rng: str = "auto",
                 fused_stage1: str = "auto",
                 dtype: torch.dtype = torch.float32):
        if pk_mode not in PK_MODES:
            raise ValueError(f"unknown pk_mode {pk_mode!r}")
        if mix_fit not in (FIGUEIREDO_MIX_FIT, AUTORJ_MIX_FIT):
            raise ValueError(f"unknown mix_fit {mix_fit!r}")
        if stage1_adapt not in STAGE1_RULES:
            raise ValueError(f"unknown stage1_adapt {stage1_adapt!r}")
        if fused not in ENGINE_SWITCHES:
            raise ValueError(f"unknown fused {fused!r}")
        if fused_rng not in FUSED_RNG_MODES:
            raise ValueError(f"unknown fused_rng {fused_rng!r}")
        if fused_stage1 not in ENGINE_SWITCHES:
            raise ValueError(f"unknown fused_stage1 {fused_stage1!r}")
        if rng not in RNG_MODES:
            raise ValueError(f"unknown rng {rng!r}")
        if rng in ("fast", "pallas") and student_t_dof > 0:
            raise ValueError(
                f"rng={rng!r} draws Gaussian perturbations and cannot be "
                "combined with student_t_dof > 0; use rng='auto' or "
                "'threefry' for Student-t runs")
        if within_move not in WITHIN_MOVES:
            raise ValueError(f"unknown within_move {within_move!r}")
        if within_move == "hmc" and student_t_dof > 0:
            raise ValueError(
                "within_move='hmc' uses Gaussian momenta; combine it with "
                "student_t_dof=0")
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
        if isinstance(hmc_step_scale, (list, tuple)):
            hmc_step_scale = tuple(float(x) for x in hmc_step_scale)
        fields = dict(seed=seed, adapt=adapt, pk_mode=pk_mode,
                      within_move=within_move, hmc_steps=int(hmc_steps),
                      hmc_jitter=bool(hmc_jitter),
                      hmc_step_scale=hmc_step_scale,
                      hmc_autotune=bool(hmc_autotune),
                      hmc_target_accept=float(hmc_target_accept), perm=perm,
                      student_t_dof=student_t_dof, mix_fit=mix_fit,
                      max_mix_comps=max_mix_comps, max_em_iters=max_em_iters,
                      n_chains=n_chains, n_chains_stage1=n_chains_stage1,
                      stage1_target_samples=stage1_target_samples,
                      stage1_sweeps=stage1_sweeps,
                      stage1_adapt=stage1_adapt,
                      stage1_log_gain=float(stage1_log_gain),
                      sweep_chunk=sweep_chunk,
                      n_trace_chains=n_trace_chains,
                      chunk_flush_every=chunk_flush_every,
                      trace_chain0=trace_chain0, trace_every=trace_every,
                      rng=rng, fused=fused, fused_rng=fused_rng,
                      fused_stage1=fused_stage1,
                      dtype=dtype)
        for name, value in fields.items():
            object.__setattr__(self, name, value)
