#!/usr/bin/env python3
"""Smoke run of the PyTorch port (automix_tpu_torch) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``automix_tpu_torch/csrc`` (first run
compiles into ``build/kernels/``) and holds each kernel against its plain
PyTorch twin on the card, then drives the port's paths at full size:

* the tutorial main path through ``AMSampler`` at the benchmark's size
  (131072 chains, 1024 stage-1 chains per model, 2000 stage-1 sweeps,
  1000-sweep chunks, seed 0), p(M) against the published 0.7928 / 0.0239
  / 0.1834;
* toy2: stages 1-2 through ``AMSampler`` at the CLI's 2048 stage-1
  chains per model (the one-sweep stage-1 kernel's path) with lmax 10,
  the ported report writers, then the CLI in mode 1 from the
  ``_mix.data`` at its defaults (perm on, traces every 16th sweep), p(M)
  against the exact 0.5 / 0.25 / 0.125 / 0.0625 / 0.0625;
* the CLI on toy1 with Student-t perturbations (``-t 5``), p(M) against
  the exact 0.3 / 0.7.

Every kernel's launch counter is set to 0 just before a path and read
just after it.  Any failed check exits non-zero without printing a
result.

    python3 chip_smoke.py

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# Benchmark configuration of the main path (bench.py's tutorial run).
N_CHAINS = 131_072
N_CHAINS_STAGE1 = 1024
STAGE1_SWEEPS = 2000
SWEEP_CHUNK = 1000
BURN, WARMUP, TIMED = 1000, 1000, 20_000
PUBLISHED = (0.7928, 0.0239, 0.1834)
TOY1_EXACT = (0.3, 0.7)
TOY2_EXACT = (0.5, 0.25, 0.125, 0.0625, 0.0625)
PARITY_TOL = 0.01
CLI_SWEEPS = 20_000

# Kernel-vs-twin checks (tolerances explained where they are applied).
K1_CHAINS, K1_SWEEPS = 16_384, 50
TIME_SWEEPS = 100
TOY2_C_K2 = 1024          # toy2 chains per model that fit K2's one block
TOY2_C_K3 = 2048          # the CLI default: the one-sweep kernel's path


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


def reset_counts():
    from automix_tpu_torch.kernels import fused, fused_stage1
    fused.sweep_chunk.launches = 0
    fused_stage1.segment.launches = 0
    fused_stage1.sweep.launches = 0


def read_counts():
    from automix_tpu_torch.kernels import fused, fused_stage1
    return {"K1": fused.sweep_chunk.launches,
            "K2": fused_stage1.segment.launches,
            "K3": fused_stage1.sweep.launches}


def stage1_start(ms, C, dev):
    import torch
    K, D = ms.nmodels, ms.dmax
    init = ms.init_points(torch.Generator().manual_seed(0))
    theta = init[torch.arange(K * C) // C].T.contiguous().to(dev)
    dims = torch.as_tensor(ms.dims)
    sig = (10.0 * (torch.arange(D)[None] < dims[:, None])).float().to(dev)
    zi = torch.zeros((K, D), dtype=torch.int32, device=dev)
    return theta, sig, zi


def check_segment(ms, C, dev, tdist=None, label="K2"):
    """K2 against segment_ref: K models x C chains, one 100-sweep segment
    (componentwise sweeps 1-50, block-move coins after the burn-in at
    50), seed 777."""
    import torch
    from automix_tpu_torch.kernels import fused_stage1
    theta, sig, zi = stage1_start(ms, C, dev)
    kw = dict(C=C, sweep0=0, seed=777, nburn=50, n_active=100, tdist=tdist)
    got = fused_stage1.segment(ms, theta, sig, zi, zi, **kw)
    want = fused_stage1.segment_ref(ms, theta, sig, zi, zi, **kw)
    torch.cuda.synchronize()
    th_err = (got[0] - want[0]).abs()
    close = (th_err <= 1e-5 * (1 + want[0].abs())).all(0).float().mean()
    sig_rel = float(((got[1] - want[1]).abs()
                     / want[1].abs().clamp(min=1e-30)).max())
    counts_equal = torch.equal(got[2], want[2]) and torch.equal(got[3],
                                                                want[3])
    log(f"{label} vs segment_ref ({ms.nmodels} x {C} chains): theta max|err| "
        f"{float(th_err.max()):.3e}, lanes within 1e-5: {float(close):.6f}, "
        f"sig max rel err {sig_rel:.3e}, counts equal {counts_equal}")
    # integer accept counts make the pooled sig update exact: 1e-6 relative
    if sig_rel > 1e-6:
        fail(f"{label} sig differs from segment_ref by {sig_rel:.3e}")
    # ulp-level libm differences may flip a marginal accept on a few lanes
    if float(close) < 0.99:
        fail(f"{label} theta agrees on only {float(close):.4f} of lanes")
    ms_k = cuda_ms(lambda: fused_stage1.segment(ms, theta, sig, zi, zi,
                                                **kw), 20)
    ms_p = cuda_ms(lambda: fused_stage1.segment_ref(ms, theta, sig, zi, zi,
                                                    **kw), 2)
    log(f"{label} segment ({ms.nmodels * C} chains x 100 sweeps): kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.4f} ms")
    return float(th_err.max()), ms_k, ms_p


def check_sweep_kernel(ms, C, dev):
    """K3 against sweep_ref: one 100-sweep segment of toy2 at 5 x 2048
    chains (the CLI default), sweep by sweep from the same state.  The
    per-sweep accept counts must be equal; theta and logp agree within
    float32 tolerance on >= 99% of lanes."""
    import torch
    from automix_tpu_torch.kernels import fused_stage1
    theta, sig, _ = stage1_start(ms, C, dev)
    sig = sig * 0.2
    kw = dict(C=C, seed=777, nburn=50)
    th_k = th_p = theta
    lp_k = lp_p = torch.zeros(theta.shape[1], device=dev)
    counts_equal = True
    for t in range(1, 101):
        th_k, lp_k, c_k = fused_stage1.sweep(ms, th_k, lp_k, sig, t=t,
                                             seg_start=t == 1, **kw)
        th_p, lp_p, c_p = fused_stage1.sweep_ref(ms, th_p, lp_p, sig, t=t,
                                                 seg_start=t == 1, **kw)
        counts_equal &= torch.equal(c_k, c_p)
    torch.cuda.synchronize()
    th_err = (th_k - th_p).abs()
    close = ((th_err <= 1e-5 * (1 + th_p.abs())).all(0)
             & ((lp_k - lp_p).abs() <= 1e-5 * (1 + lp_p.abs())))
    frac = float(close.float().mean())
    log(f"K3 vs sweep_ref ({ms.nmodels} x {C} chains x 100 sweeps): theta "
        f"max|err| {float(th_err.max()):.3e}, lanes within 1e-5: "
        f"{frac:.6f}, accept counts equal {counts_equal}")
    if not counts_equal:
        fail("K3 accept counts differ from sweep_ref")
    if frac < 0.99:
        fail(f"K3 agrees on only {frac:.4f} of lanes")
    ms_k = cuda_ms(lambda: fused_stage1.sweep(ms, theta, lp_k, sig, t=60,
                                              seg_start=False, **kw), 200)
    ms_p = cuda_ms(lambda: fused_stage1.sweep_ref(
        ms, theta, lp_k, sig, t=60, seg_start=False, **kw), 5)
    log(f"K3 sweep ({ms.nmodels * C} chains x 1 sweep): kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.4f} ms")
    return float(th_err.max()), ms_k, ms_p


def check_sweep_runner(ms, dev):
    """The one-sweep runner (K3) against the segment runner (K2) where
    both fit: toy2 at 5 x 1024 chains, 300 stage-1 sweeps.  sig within
    1e-6 relative (the runner's gain is a torch op, the segment kernel's
    an in-kernel one), the stage-2 samples equal on >= 99% of lanes."""
    import torch
    from automix_tpu_torch import EngineConfig
    from automix_tpu_torch.kernels import fused_stage1
    init = ms.init_points(torch.Generator())
    cfg = EngineConfig(seed=3)
    a = fused_stage1.run_fused_stage1_sweeps(ms, cfg, 300, TOY2_C_K2, init,
                                             dev)
    b = fused_stage1.run_fused_stage1(ms, cfg, 300, TOY2_C_K2, init, dev)
    torch.cuda.synchronize()
    sig_rel = float(((a[0] - b[0]).abs() / b[0].abs().clamp(min=1e-30))
                    .max())
    close = ((a[1] - b[1]).abs() <= 1e-5 * (1 + b[1].abs())).all(-1)
    frac = float(close.float().mean())
    log(f"K3 runner vs K2 runner (toy2, 5 x {TOY2_C_K2} chains, 330 "
        f"sweeps): sig max rel err {sig_rel:.3e}, samples equal on "
        f"{frac:.6f}")
    if sig_rel > 1e-6 or frac < 0.99:
        fail("the one-sweep runner disagrees with the segment runner")


def check_sweep(ms, prop, chains, dev, perm=False, tdist=None, label="K1"):
    """K1 against sweep_chunk_ref: 16384 chains taken from a run's state,
    50 production sweeps under its fitted proposal.  Timed on every chain
    of the state x 100 sweeps."""
    import torch
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    ch = chains
    n = K1_CHAINS
    args = (ch.k[:n].contiguous(), ch.theta[:n].T.contiguous(),
            ch.logp[:n].contiguous(), ch.pk[:n].T.contiguous(),
            ch.pkllim[:n].contiguous(), ch.nreinit[:n].contiguous())
    kw = dict(seed=11, sweep0=ch.sweep, n_sweeps=K1_SWEEPS, adapt=True,
              perm=perm, tdist=tdist)
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    want = fused.sweep_chunk_ref(ms, *args, tabs, **kw)
    torch.cuda.synchronize()
    same = got[0] == want[0]
    frac = float(same.float().mean())
    th_err = float((got[1] - want[1]).abs()[:, same].max())
    lp_err = float(((got[2] - want[2]).abs()
                    / (1 + want[2].abs()))[same].max())
    cnt_equal = torch.equal(got[9].sum(1), want[9].sum(1))
    ks_g = got[6].sum(1).double()
    ks_w = want[6].sum(1).double()
    ks_rel = float(((ks_g - ks_w).abs() / ks_w.clamp(min=1)).max())
    log(f"{label} vs sweep_chunk_ref ({n} chains x {K1_SWEEPS} sweeps, K="
        f"{ms.nmodels}, D={ms.dmax}, L={tabs.loglam.shape[1]}): k equal on "
        f"{frac:.6f}, theta max|err| {th_err:.3e}, logp max rel err "
        f"{lp_err:.3e}, counters equal {cnt_equal}, ksummary max rel err "
        f"{ks_rel:.3e}")
    # a flipped marginal accept moves a chain elsewhere: bound the share
    if frac < 0.99:
        fail(f"{label} k agrees on only {frac:.4f} of chains")
    # agreeing chains: ulp-level libm differences through 50 sweeps
    if th_err > 1e-3 or lp_err > 1e-4:
        fail(f"{label} theta/logp differ: {th_err:.3e} / {lp_err:.3e}")
    if ks_rel > 0.01:
        fail(f"{label} ksummary differs by {ks_rel:.3e}")
    if frac == 1.0 and not cnt_equal:
        fail(f"{label} counters differ on identical trajectories")
    full = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit)
    kw = dict(kw, n_sweeps=TIME_SWEEPS)
    ms_k = cuda_ms(lambda: fused.sweep_chunk(ms, *full, tabs, **kw), 5)
    ms_p = cuda_ms(lambda: fused.sweep_chunk_ref(ms, *full, tabs, **kw), 1)
    log(f"{label} sweep chunk ({ch.n_chains} chains x {TIME_SWEEPS} sweeps): "
        f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    return th_err, ms_k, ms_p


def run_cli(argv, reset=True):
    """``cli.main(argv)`` in process; returns (stdout text, launch counts
    since the last reset, seconds).  ``reset`` sets the counts to 0 just
    before the run."""
    from automix_tpu_torch import cli
    if reset:
        reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    counts = read_counts()
    for line in out.splitlines():
        log(f"  | {line}")
    if rc != 0:
        fail(f"cli {' '.join(argv)} returned {rc}")
    return out, counts, secs


def probs_of(out):
    return [float(line.split("=")[-1]) for line in out.splitlines()
            if line.startswith("p(M=")]


def check_probs(name, probs, exact):
    import numpy as np
    err = float(np.abs(np.asarray(probs) - np.asarray(exact)).max())
    log(f"{name}: p(M) = {[round(p, 4) for p in probs]} vs exact "
        f"{list(exact)}: max err {err:.4f}")
    if len(probs) != len(exact) or err > PARITY_TOL:
        fail(f"{name}: p(M) misses the exact values by {err:.4f}")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    import numpy as np

    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.io import reports
    from automix_tpu_torch.kernels import _build
    from automix_tpu_torch.models import toy
    from automix_tpu_torch.models.tutorial import tutorial_set
    from automix_tpu_torch.ops import randoms

    t_all = time.perf_counter()
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
    log(f"phase build: {time.perf_counter() - t0:.2f} s ({lib_path.name})")

    ms = tutorial_set()
    toy1, toy2 = toy.toy1_set(), toy.toy2_set()
    t5 = randoms.student_t(5)

    # ---- 3. stage-1 kernels against their twins ------------------------------
    t0 = time.perf_counter()
    k2_err, k2_ms, k2_plain = check_segment(ms, N_CHAINS_STAGE1, dev)
    check_segment(toy2, TOY2_C_K2, dev, tdist=t5, label="K2 Student-t toy2")
    k3_err, k3_ms, k3_plain = check_sweep_kernel(toy2, TOY2_C_K3, dev)
    check_sweep_runner(toy2, dev)
    log(f"phase stage-1 kernel checks: {time.perf_counter() - t0:.2f} s")

    # ---- 4. tutorial main path -----------------------------------------------
    t0 = time.perf_counter()
    cfg = EngineConfig(n_chains=N_CHAINS, n_chains_stage1=N_CHAINS_STAGE1,
                       stage1_sweeps=STAGE1_SWEEPS, sweep_chunk=SWEEP_CHUNK,
                       seed=0, trace_chain0=False, n_trace_chains=1)
    reset_counts()
    am = AMSampler(ms, cfg, device="cuda")
    am.estimate_conditional_probs()
    am.burn_samples(BURN)
    am.rjmcmc_samples(WARMUP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = am.rjmcmc_samples(TIMED)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    main_counts = read_counts()

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
    log(f"launches on the main path: {main_counts}")
    if main_counts["K1"] == 0 or main_counts["K2"] == 0:
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
    log(f"phase tutorial main path: {time.perf_counter() - t0:.2f} s")

    # ---- 5. K1 against its twin on the main path's proposal and state --------
    t0 = time.perf_counter()
    k1_err, k1_ms, k1_plain = check_sweep(ms, am.proposal, am.chains, dev)
    del am
    log(f"phase K1 check: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 6. toy2: stages 1-2, then the CLI in mode 1 at its defaults --
        # The CLI's own stage 2 on toy2 (lmax 30, 6144 samples per model)
        # took over two minutes on the card, so stages 1-2 run through
        # AMSampler with lmax 10 (stage 1 still at the CLI's 2048 chains
        # per model: the one-sweep kernel's path), the ported writers
        # write _adapt, _mix and _cf, and the CLI runs stage 3 from the
        # _mix.data at its defaults.
        stem = os.path.join(tmp, "toy2")
        reset_counts()
        t0 = time.perf_counter()
        am = AMSampler(toy2, EngineConfig(n_chains_stage1=TOY2_C_K3,
                                          max_mix_comps=10, seed=1),
                       device="cuda")
        am.estimate_conditional_probs()
        reports.report_cond_prob_estimation(stem, am)
        cp = am.cpstats
        log(f"toy2 stages 1-2: stage 1 {cp.timesecs_stage1:.3f} s "
            f"({TOY2_C_K3} chains per model, 11000 sweeps), stage 2 "
            f"{cp.timesecs_stage2:.3f} s (EM iterations "
            f"{cp.em_iters.tolist()}, L={am.proposal.lmax})")
        prop = am.proposal
        del am
        out, _, secs = run_cli(
            ["toy2", "-m", "1", "--chains", str(N_CHAINS), "-N",
             str(CLI_SWEEPS), "-s", "1", "-f", stem], reset=False)
        toy2_counts = read_counts()
        log(f"launches on the toy2 path: {toy2_counts}")
        check_probs("toy2 CLI mode 1", probs_of(out), TOY2_EXACT)
        if toy2_counts["K1"] == 0 or toy2_counts["K3"] == 0:
            fail("the toy2 path did not launch K1 and K3")
        files = [f"{stem}_{s}.data" for s in
                 ("mix", "log", "adapt", "cf", "k", "lp", "pk", "ac")] + [
            f"{stem}_theta{k}.data" for k in range(1, 6)]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            fail(f"the toy2 path did not write {missing}")
        log(f"phase toy2 stages 1-2 + CLI mode 1: "
            f"{time.perf_counter() - t0:.2f} s (CLI {secs:.2f} s)")

        # ---- 7. K1 perm + Student-t against its twin on toy2 -----------------
        t1 = time.perf_counter()
        am = AMSampler(toy2, EngineConfig(
            n_chains=N_CHAINS, seed=5, perm=True, student_t_dof=5,
            trace_chain0=False), device="cuda")
        am.set_proposal(prop)
        am.burn_samples(200)
        check_sweep(toy2, am.proposal, am.chains, dev, perm=True, tdist=t5,
                    label="K1 perm + Student-t toy2")
        check_sweep(toy2, am.proposal, am.chains, dev, perm=True,
                    label="K1 perm toy2")
        del am
        log(f"phase K1 variant checks: {time.perf_counter() - t1:.2f} s")

        # ---- 8. the CLI on toy1 with Student-t ---------------------------------
        out, counts, secs = run_cli(
            ["toy1", "-t", "5", "--chains", str(N_CHAINS), "-N",
             str(CLI_SWEEPS), "-s", "2", "-f", os.path.join(tmp, "toy1")])
        log(f"launches on the toy1 Student-t CLI path: {counts}")
        check_probs("toy1 -t 5 CLI", probs_of(out), TOY1_EXACT)
        if counts["K1"] == 0 or counts["K2"] == 0:
            fail("the toy1 CLI run did not launch K1 and K2")
        log(f"phase toy1 Student-t CLI: {secs:.2f} s")

    log(f"total: {time.perf_counter() - t_all:.2f} s")
    log(json.dumps({"kernels": [
        {"name": "fused_sweep", "route": "cuda",
         "source": "automix_tpu_torch/csrc/fused_sweep.cu",
         "replaces": "automix_tpu/kernels/fused.py:859",
         "launches": main_counts["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fused_stage1_segment", "route": "cuda",
         "source": "automix_tpu_torch/csrc/fused_stage1.cu",
         "replaces": "automix_tpu/kernels/fused_stage1.py:696",
         "launches": main_counts["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "fused_stage1_sweep", "route": "cuda",
         "source": "automix_tpu_torch/csrc/fused_stage1_sweep.cu",
         "replaces": "automix_tpu/kernels/fused_stage1.py:416",
         "launches": toy2_counts["K3"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
