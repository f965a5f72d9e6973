#!/usr/bin/env python3
"""Smoke run of the PyTorch port (automix_tpu_torch) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``automix_tpu_torch/csrc`` (first run
compiles into ``build/kernels/``), holds each kernel against its plain
PyTorch twin on the card, then drives the tutorial main path through
``AMSampler`` at the benchmark's size (131072 chains, 1024 stage-1 chains
per model, 2000 stage-1 sweeps, 1000-sweep chunks, seed 0) and checks the
posterior model probabilities against the published 0.7928 / 0.0239 /
0.1834.  Any failed check exits non-zero without printing a result.

    python3 chip_smoke.py

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

# Benchmark configuration of the main path (bench.py's tutorial run).
N_CHAINS = 131_072
N_CHAINS_STAGE1 = 1024
STAGE1_SWEEPS = 2000
SWEEP_CHUNK = 1000
BURN, WARMUP, TIMED = 1000, 1000, 20_000
PUBLISHED = (0.7928, 0.0239, 0.1834)
PARITY_TOL = 0.01

# Kernel-vs-twin checks (tolerances explained where they are applied).
K1_CHAINS, K1_SWEEPS = 16_384, 50
TIME_SWEEPS = 100


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    one warm-up run, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_segment(ms, dev):
    """K2 against segment_ref at the main path's stage-1 shape: K=3 models
    x C=1024 chains, one 100-sweep segment (componentwise sweeps 1-50,
    block-move coins after the burn-in at 50), seed 0."""
    import torch
    from automix_tpu_torch.kernels import fused_stage1
    K, D, C = ms.nmodels, ms.dmax, N_CHAINS_STAGE1
    N = K * C
    init = ms.init_points(torch.Generator())
    theta = init[torch.arange(N) // C].T.contiguous().to(dev)
    sig = torch.full((K, D), 10.0, device=dev)
    nacc = torch.zeros((K, D), dtype=torch.int32, device=dev)
    ntry = torch.zeros_like(nacc)
    kw = dict(C=C, sweep0=0, seed=777, nburn=50, n_active=100)
    got = fused_stage1.segment(ms, theta, sig, nacc, ntry, **kw)
    want = fused_stage1.segment_ref(ms, theta, sig, nacc, ntry, **kw)
    torch.cuda.synchronize()
    th_err = (got[0] - want[0]).abs()
    close = (th_err <= 1e-5 * (1 + want[0].abs())).all(0).float().mean()
    sig_rel = float(((got[1] - want[1]).abs()
                     / want[1].abs().clamp(min=1e-30)).max())
    log(f"K2 vs segment_ref: theta max|err| {float(th_err.max()):.3e}, "
        f"lanes within 1e-5: {float(close):.6f}, sig max rel err "
        f"{sig_rel:.3e}, nacc equal {bool(torch.equal(got[2], want[2]))}")
    # integer accept counts make the pooled sig update exact: 1e-6 relative
    if sig_rel > 1e-6:
        fail(f"K2 sig differs from segment_ref by {sig_rel:.3e} relative")
    # ulp-level libm differences may flip a marginal accept on a few lanes
    if float(close) < 0.99:
        fail(f"K2 theta agrees on only {float(close):.4f} of lanes")
    ms_k = cuda_ms(lambda: fused_stage1.segment(ms, theta, sig, nacc, ntry,
                                                **kw), 20)
    ms_p = cuda_ms(lambda: fused_stage1.segment_ref(ms, theta, sig, nacc,
                                                    ntry, **kw), 2)
    log(f"K2 segment (3072 chains x 100 sweeps): kernel {ms_k:.4f} ms, "
        f"plain {ms_p:.4f} ms")
    return float(th_err.max()), ms_k, ms_p


def check_sweep(am, dev):
    """K1 against sweep_chunk_ref: 16384 chains taken from the main path's
    final state, 50 production sweeps under its fitted proposal."""
    import torch
    from automix_tpu_torch.kernels import fused
    ms = am.modelset
    tabs = fused.prep_tables(am.proposal, ms.dims)
    ch = am.chains
    n = K1_CHAINS
    args = (ch.k[:n].contiguous(), ch.theta[:n].T.contiguous(),
            ch.logp[:n].contiguous(), ch.pk[:n].T.contiguous(),
            ch.pkllim[:n].contiguous(), ch.nreinit[:n].contiguous())
    kw = dict(seed=int(am.cfg.seed), sweep0=ch.sweep, n_sweeps=K1_SWEEPS,
              adapt=True)
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    want = fused.sweep_chunk_ref(ms, *args, tabs, **kw)
    torch.cuda.synchronize()
    same = got[0] == want[0]
    frac = float(same.float().mean())
    th_err = float((got[1] - want[1]).abs()[:, same].max())
    lp_err = float(((got[2] - want[2]).abs()
                    / (1 + want[2].abs()))[same].max())
    ks_g = got[6].sum(1).double()
    ks_w = want[6].sum(1).double()
    ks_rel = float(((ks_g - ks_w).abs() / ks_w.clamp(min=1)).max())
    log(f"K1 vs sweep_chunk_ref ({n} chains x {K1_SWEEPS} sweeps, L="
        f"{tabs.loglam.shape[1]}): k equal on {frac:.6f}, theta max|err| "
        f"{th_err:.3e}, logp max rel err {lp_err:.3e}, ksummary max rel "
        f"err {ks_rel:.3e}")
    # a flipped marginal accept moves a chain elsewhere: bound the share
    if frac < 0.99:
        fail(f"K1 k agrees on only {frac:.4f} of chains")
    # agreeing chains: ulp-level libm differences through 50 sweeps
    if th_err > 1e-3 or lp_err > 1e-4:
        fail(f"K1 theta/logp differ: {th_err:.3e} / {lp_err:.3e}")
    if ks_rel > 0.01:
        fail(f"K1 ksummary differs by {ks_rel:.3e}")

    # time both at the main path's shape: every chain, 100 sweeps
    full = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit)
    kw = dict(kw, n_sweeps=TIME_SWEEPS)
    ms_k = cuda_ms(lambda: fused.sweep_chunk(ms, *full, tabs, **kw), 5)
    ms_p = cuda_ms(lambda: fused.sweep_chunk_ref(ms, *full, tabs, **kw), 1)
    log(f"K1 sweep chunk ({N_CHAINS} chains x {TIME_SWEEPS} sweeps): kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.4f} ms")
    return th_err, ms_k, ms_p


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    import numpy as np

    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import _build, fused, fused_stage1
    from automix_tpu_torch.models.tutorial import tutorial_set

    # ---- 1. card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({lib_path.name})")

    ms = tutorial_set()

    # ---- 3. K2 vs its plain twin ---------------------------------------------
    k2_err, k2_ms, k2_plain = check_segment(ms, dev)

    # ---- 5. main path --------------------------------------------------------
    cfg = EngineConfig(n_chains=N_CHAINS, n_chains_stage1=N_CHAINS_STAGE1,
                       stage1_sweeps=STAGE1_SWEEPS, sweep_chunk=SWEEP_CHUNK,
                       seed=0)
    fused.sweep_chunk.launches = 0
    fused_stage1.segment.launches = 0
    am = AMSampler(ms, cfg, device="cuda")
    am.estimate_conditional_probs()
    am.burn_samples(BURN)
    am.rjmcmc_samples(WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = am.rjmcmc_samples(TIMED)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1_launches = fused.sweep_chunk.launches
    k2_launches = fused_stage1.segment.launches

    probs = stats.model_probs
    err = float(np.abs(probs - np.asarray(PUBLISHED)).max())
    rate = N_CHAINS * TIMED / elapsed
    cp = am.cpstats
    log(f"main path: stage 1 {cp.timesecs_stage1:.3f} s, stage 2 "
        f"{cp.timesecs_stage2:.3f} s (EM iterations "
        f"{cp.em_iters.tolist()}, L={am.proposal.lmax}), burn-in "
        f"{stats.timesecs_burn:.3f} s")
    log(f"main path: {TIMED} timed sweeps x {N_CHAINS} chains in "
        f"{elapsed:.3f} s = {rate:.6e} chain-sweeps/s")
    log(f"p(M) = {np.round(probs, 4).tolist()} vs published "
        f"{list(PUBLISHED)}: max err {err:.4f}")
    log(f"launches on the main path: K1 fused_sweep {k1_launches}, K2 "
        f"fused_stage1 {k2_launches}")
    if k1_launches == 0 or k2_launches == 0:
        fail("a kernel of the main path was never launched")
    if err > PARITY_TOL:
        fail(f"p(M) misses the published values by {err:.4f}")
    n_sweeps = WARMUP + TIMED
    if int(stats.ksummary.sum()) != N_CHAINS * n_sweeps \
            or stats.ntrytd != N_CHAINS * n_sweeps:
        fail("visit counts do not cover every chain-sweep")
    if not bool(torch.isfinite(am.chains.theta).all()
                and torch.isfinite(am.chains.logp).all()):
        fail("non-finite chain state")
    if not np.isfinite(stats.theta_mean()).all():
        fail("non-finite posterior means")

    # ---- 4. K1 vs its plain twin (on the main path's proposal and state) ----
    k1_err, k1_ms, k1_plain = check_sweep(am, dev)

    log(json.dumps({"kernels": [
        {"name": "fused_sweep", "route": "cuda",
         "source": "automix_tpu_torch/csrc/fused_sweep.cu",
         "replaces": "automix_tpu/kernels/fused.py:859",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fused_stage1_segment", "route": "cuda",
         "source": "automix_tpu_torch/csrc/fused_stage1.cu",
         "replaces": "automix_tpu/kernels/fused_stage1.py:696",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
