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
  chains per model (the segment kernel over many SMs) with lmax 10,
  the ported report writers, then the CLI in mode 1 from the
  ``_mix.data`` at its defaults (perm on, traces every 16th sweep), p(M)
  against the exact 0.5 / 0.25 / 0.125 / 0.0625 / 0.0625;
* the sweep kernel's forms at toy2's (5, 5) on toy2's state, each
  bitwise equal to its twin and timed per launch of 100 and of 16
  sweeps (the CLI's launch), and a drive of its hw perm + Student-t form;
* the CLI on toy1 with Student-t perturbations (``-t 5``) in its AutoRJ
  mode (``-m 2``: one Normal per model, no lmax-30 EM), p(M) against
  the exact 0.3 / 0.7, then its (2, 2) perm + Student-t forms on the
  state of the CLI's proposal, bitwise and timed as toy2's;
* rb9 (10 models, dmax 5): stages 1-2 through ``AMSampler`` at the bench
  size (1024 stage-1 chains per model on the segment kernel, 2000
  stage-1 sweeps, seed 0) and the ported writers, then the CLI
  in mode 1 at its defaults (per-chain pk, perm, traces every 16th sweep)
  at 131072 chains, then pooled pk through ``AMSampler`` from the same
  proposal at 16384 chains (the in-kernel pooled kernel K1c) and 131072
  chains (K1d, the pooled route above K1c's bound, one cooperative launch
  a chunk), p(M) each against the reference C code's
  ``tests/data/heavy_oracle.json`` rb9 mean, a short K1d run forced on
  the 16384 chains, bitwise equal to K1c, and K1d bitwise equal to the
  one-sweep route it replaced (a K1 launch a sweep and the update in
  torch) on both streams;
* DDI (2 models of dims 16 and 10, the sweep kernel's cached form K1e):
  ``AMSampler`` at ``bench_suite.py``'s configuration (16384 chains, 512
  stage-1 chains per model, 1500 stage-1 sweeps, 500-sweep chunks, seed
  0, 500 burn-in and 10000 timed sweeps), the carried logp against a
  fresh evaluation at the end, the CLI in mode 1 from that run's
  ``_mix.data`` at its defaults, and pooled pk at 16384 chains on the
  route ``pooled_capacity`` picks, p(M) each against the C oracle's ddi
  mean; K1e, K1e + perm (100 sweeps, crossing six cache refreshes), K1e at
  L = 32, K1d with the cache (bitwise the one-sweep route on the run's
  chains repeated above K1c's bound, and its twin on the run's 16384;
  with K1e's registers and resident warps per SM),
  K1c with the cache and both stage-1 kernels with the DDI density each equal
  to its twin run on the card, and DDI's stage 1 on both routes, timed
  and bitwise equal;
* change-point (6 models of dims 3-13, D5): the segment kernel with the
  log rule (K2-log) and the one-sweep route (K3 with the log update in
  its launch, and in its moves-only mode with the update between
  launches), each equal to its twin on the card; stage 1 of cpt at 512
  chains per model (K2-log); ``AMSampler`` on cpt and on cptrs at the JAX
  package's change-point configuration (pooled pk, the log stage-1 rule,
  1024 stage-1 chains per model on K2-log, 2500 stage-1 sweeps; cptrs
  fitted at lmax 10) with 16384 chains on K1c, 1500 burn-in
  and 10000 timed sweeps; K1, K1 + perm and K1c on cpt's proposal and
  state, each equal to its twin, and K1d forced there, equal to the
  one-sweep route; the CLI in mode 1 at its defaults with
  ``-N 10000`` from each set's ``_mix.data``.  p(M) against the JAX
  package's own posterior (``tests/data/cpt_jax_reference.json``), the
  mean of eight cpt stage-3 runs from its proposal (each also held to
  JAX's posterior) against cptrs within the JAX test's atol, and the CLI
  on cpt against the JAX package's CLI run from the same proposal
  (``tests/data/cpt_cli_witness.json``);
* several devices: the chain base of the sweep kernel (K1 and K1f at the
  tutorial's (3, 2), K1e at DDI's (2, 16)) and of K3 (moves only, at both
  shapes), two launches over the halves of the chains bitwise one launch
  over all of them; then ``multihost.initialize`` with NCCL at world size
  1 (the card is one device, so NCCL across ranks is not measured) and
  ``AMSampler(tutorial_set(), mesh=make_global_mesh())`` at the main
  path's size on the hash: stage 1 on K3's moves-only route bitwise the
  main path's sig, then from the main path's proposal 1000 burn-in and
  2000 sweeps whose ksummary and chains equal a run without the mesh bit
  for bit, p(M) against the published values;
* the general engine (plain torch, for sets the kernels do not serve):
  K4, the ``rng="pallas"`` draw kernel, against its twin at the
  tutorial's stage-3 shapes and an odd shape; the tutorial at 131072
  chains with ``fused="off"`` from the main path's proposal, on K4 and on
  the ``fast`` hash, p(M) against the published values; toy2 with
  per-theta densities and no CUDA density at 16384 chains through the
  general stage 1, stage 2 at lmax 10 and stage 3, p(M) against the
  exact values; and the CLI on ``examples/model_selection_torch.py``'s
  per-theta set by ``module:function``, p(M) against its closed form;
* the general engine's extensions: toy2 per-theta with Student-t(5)
  perturbations on JAX's threefry stream (stage 1 on the general engine
  with AutoRJ, then stage 3 from the Gaussian toy2 run's proposal and
  chains at 16384), p(M) against the exact values; HMC
  within-model moves on the tutorial from the main path's proposal
  (autotuned scales, 16384 chains), p(M) against the published values;
  and SMC evidences on the tutorial from that proposal (16384 particles
  per model, adaptive tempering), p(M) against the published values and
  the ESS above 0.2 N.  These paths launch no kernel.

``fused_rng="auto"`` is the hw stream on the card, so every sampler path
above runs the sweep kernel's hw form (K1f).  Beside them: 20000 timed
sweeps of the main path's state on the hash (both streams' chain-sweeps/s
in one log) and K1 timed on that state with each stream in turns; K1f
against its twin on the card in seven forms (the tutorial, toy2 perm +
Student-t and perm, rb9's K1c and K1d, DDI's K1e bitwise, cpt at
(6, 13)); the two pooled routes held bitwise (K1c against the forced K1d
on rb9) pinned to the hash, which they need; and
each hash form whose own path now runs K1f driven through ``AMSampler``
pinned to the hash (the burn-ins of the toy2 and rb9 check states, and
short drives from the DDI and cpt states).

Every kernel's launch counter is set to 0 just before a path and read
just after it; the sweep kernel counts its two streams apart.  Any
failed check exits non-zero without printing a result.  The kernels' JSON
record gives each kernel's time, its plain twin's time and its bound: the
larger of the operations its function needs on these inputs over the
card's float32 peak and the bytes it must move over the card's memory
rate (``bound``).

    python3 chip_smoke.py

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import socket
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
TOY2_C_K2 = 1024          # toy2 chains per model of K2's Student-t check
TOY2_C_K3 = 2048          # the CLI default: K3's check, and K2's path

# rb9: the JAX package's heavy-model configuration (tests/test_heavy_models
# .py, bench_suite.py:368) held to the C oracle's p(M) mean.
RB9_C_STAGE1 = 1024       # bench size: K2's path, K3's check
RB9_C_K2 = 512            # rb9 chains per model for K2's twin check
RB9_POOLED_K1C = 16_384   # bench_suite.py:368, held resident: K1c
RB9_POOLED_K1D = 131_072  # above the co-residency bound: K1d
RB9_MAX_MIX = 30
RB9_BURN = 2000
RB9_FORCED = (100, 300)   # burn-in, production sweeps of the forced run
K1D_CHECK_SWEEPS = 20

# DDI: bench_suite.py's configuration (:90-94, :369) held to the C oracle.
DDI_CHAINS = 16_384
DDI_C_STAGE1 = 512        # bench_suite.py's stage-1 chains per model
DDI_STAGE1_SWEEPS = 1500
DDI_CHUNK = 500
DDI_BURN, DDI_TIMED = 500, 10_000
# The carried logp against a fresh evaluation (K1e, as the JAX kernel,
# recomputes both every 16 sweeps): exactly 0 after a refresh.  Between
# refreshes drift_window reads DDI_WINDOWS windows and bounds each chain by
# its class.  A chain that entered the 16-dim model by a jump within the
# window carries the jump's blend c + (cn - c) (automix_tpu/kernels/
# fused.py:748) of the statistics it grew as a 10-dim chain, whose
# coordinates 6-8 are model 1's alpha but model 2's precisions; every other
# chain only the float32 error of its own incremental updates.  The bounds
# leave a factor of 2 or more over the largest readings on the H100 (PERF.md
# section 6).  tools/ddi_drift.py shows the first class's drift gone when
# the jump stores cn, and tests/test_torch_ddi.py replays the jump with
# JAX's density on the CPU.  JAX records 3.4e-3 one sweep after a refresh
# (automix_tpu/models/ddi_cols.py:29-32) and asserts < 0.5 at the end of a
# run (bench/validate_tpu.py:126): that check passes or fails with the
# sweep a run stops at, so it is not used here.
DDI_DRIFT_JUMPED = 2.0
DDI_DRIFT_OTHER = 0.02
DDI_WINDOWS = 8
DDI_CHECK_SWEEPS = TIME_SWEEPS  # crosses six cache refreshes (t % 16 == 15)

# Change-point: the JAX package's configuration (tests/test_heavy_models.py
# :71-76: pooled pk, the log stage-1 rule, 2500 stage-1 sweeps, 500-sweep
# chunks, 1500 burn-in sweeps) held to the JAX package's own p(M), frozen
# by tools/cpt_jax_reference.py (the C binaries segfault).  JAX's 1024
# stage-1 chains per model run on K2-log, the log update in the kernel;
# the K3 route (the log update in its launch, or between launches in its
# moves-only mode) is held to its twin at the same population.  Stage 3
# at 16384 chains, as rb9's and DDI's pooled runs: K1c.  K2-log also runs
# a stage 1 at 512 chains per model.
CPT_CHAINS = 16_384
CPT_C_STAGE1, CPT_C_K2 = 1024, 512
CPT_SEEDS = {"cpt": 5, "cptrs": 6}
# cptrs' stage 2 at JAX's lmax 30 took 307-460 s on the H100 (1060-2475 EM
# iterations, L 11-23), and the whole run 897-1188 s of the 1200 s it is
# given (PERF.md section 4), so cptrs fits with lmax 10, as toy2 does; its
# p(M) at lmax 30 and at 10 agree within 0.0002.  cpt keeps 30 (L 2-4).
CPT_MAX_MIX = {"cpt": 30, "cptrs": 10}
CPT_STAGE1_SWEEPS = 2500
CPT_CHUNK = 500
CPT_BURN, CPT_TIMED = 1500, 10_000
CPT_CLI_SWEEPS = 10_000     # the CLI's -N, cut from 100000
CPT_ROUTE_SWEEPS = 20       # the K3 + log route against its twin
# p(M) within 0.03 of the JAX mean on every model, or 3 times the spread
# of the JAX runs where that is larger, and JAX's own assertions
# (tests/test_heavy_models.py:99-100).  The JAX package's stage-2 fit on
# cpt inflates the rate scales of its proposals hundreds of times (the
# Cholesky jitter, 1e-6 of the mean covariance diagonal, is not
# scale-free), so cpt's jumps barely mix and its p(M) depends on the
# proposal and the run's length.  cpt's AMSampler run, at JAX's
# configuration, is held to JAX's cpt runs; the CLI on cpt, at another
# configuration, is held to the JAX package's CLI run from the same
# _mix.data at 1024 chains (tests/data/cpt_cli_witness.json, written by
# tools/cpt_cli_witness.py); cpt and cptrs to each other within the
# JAX test's own atol (tests/test_heavy_models.py:96): the JAX means are
# 0.0844 apart, so a tighter bound fails the reference itself (PERF.md
# section 6).
CPT_TOL, CPT_SPREADS = 0.03, 3.0
CPT_PAIR_ATOL = 0.08
# The pair check compares cptrs with the mean of CPT_REPLICAS runs of
# cpt's stage 3 from the one fitted proposal (seeds 5, 105, ...): one
# run's largest gap reads 0.0735-0.0818 over 16 stage-3 seeds on either
# stream, mean 0.078 with a spread of 0.002, so a single run crosses 0.08
# in 1-3 of 16 (tools/cpt_stream_spread.py; PERF.md section 6), and the
# mean of eight has a spread of ~0.0007.  cptrs spreads 0.0002.
CPT_REPLICAS = 8

# The general engine (plain torch, eager: every sweep is a few hundred
# launches, ~8-25 ms, so its paths run fewer sweeps than the kernels').
# The tutorial from the main path's proposal: K4 (rng="pallas") for 500
# burn-in and 500 timed sweeps, then the fast hash for 500 timed sweeps
# from the same state (6.6e7 chain-sweeps for each p(M) check); toy2's
# whole pipeline at 16384 chains (stage 1 at the CLI's 2048 chains per
# model, 1000 sweeps; lmax 10; 300 burn-in and 1000 timed sweeps); the
# CLI on the example at 2048 chains.
GEN_BURN, GEN_TIMED, GEN_FAST_TIMED = 500, 500, 500
K4_SHAPES = ((N_CHAINS, 25, 4), (3000, 37, 5))
K4_ULPS = 2
TOY2_GEN_CHAINS = 16_384
TOY2_GEN_STAGE1 = 1000
TOY2_GEN_BURN, TOY2_GEN_TIMED = 300, 1000
# toy2's stage 1 starts every chain at the origin, between each model's
# modes at +5 and -5, so the fit weights the +5 modes of the higher models
# 0.007-0.09 instead of 0.3 and p(M) settles ~0.01 from the exact values:
# the JAX package's XLA engine at this configuration reads 0.0099-0.0101
# after 1000 sweeps and drifts on (tools/toy2_general_drift.py,
# tools/toy2_general_witness.py; PERF.md section 6).  The run is held to
# JAX's three runs (tests/data/toy2_general_jax_reference.json) within
# 0.005, or 3 times their spread where that is larger, and to the exact
# values within 0.02, twice JAX's own distance.
TOY2_GEN_TOL, TOY2_GEN_SPREADS, TOY2_GEN_EXACT = 0.005, 3.0, 0.02

# The general engine's extensions, each its own AMSampler run.  toy2
# per-theta with Student-t(5) on the threefry stream, its own pipeline:
# stage 1 at the CLI's 2048 chains per model for 220 sweeps, AutoRJ (one
# Normal per model), stage 3 from fresh chains at 16384, 50 burn-in and
# 300 timed sweeps (51-82 and 69-99 ms a sweep on the card, by host).  A
# single Normal over each model's modes 10 apart mixes slowly: the JAX
# package's XLA engine at this configuration reads p(M) 0.0250-0.0328
# from exact over three seeds, 0.0149 apart (tools/toy2_t_witness.py,
# tests/data/toy2_t_jax_reference.json), so the run is held to JAX's.
# Its seed is JAX's first, so stage 1 draws the same threefry words and
# the fit follows: p(M) must lie within 0.005 of that run (the port read
# it to 4 digits on the card and on the CPU) and within 3 spreads of the
# three runs' mean; its distance from exact is logged beside JAX's.  HMC
# on the tutorial (autotuned, 16384 chains).  SMC on the tutorial (16384
# particles per model, at most 20 steps of 3 moves): adaptive from the
# fitted proposal, which bridges in a step or two, and a linear ladder of
# SMC_TEMPS steps from that proposal with every scale widened SMC_WIDEN
# times, so the resampler and the moves carry the particles across.
# Bounds: PARITY_TOL for HMC, and 0.02 for SMC (the JAX test bounds 1024
# particles at 0.05; 16 times the particles gives a quarter of the
# spread), its ESS above 0.2 N.
T_STAGE1, T_BURN, T_TIMED = 200, 50, 300
T_CHAINS, T_SEED = 16_384, 1
T_JAX_TOL, T_JAX_SPREADS = 0.005, 3.0
HMC_CHAINS, HMC_BURN, HMC_TIMED = 16_384, 200, 500
SMC_PARTICLES, SMC_TEMPS, SMC_MOVES, SMC_WIDEN = 16_384, 20, 3, 3.0
SMC_TOL, SMC_ESS = 0.02, 0.2

# H100 SXM peaks (NVIDIA's data sheet, dense): float32 outside the tensor
# cores and HBM3.  Every bound below is against these.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# Operations per call, counted from csrc/common.cuh: the counter hash and
# u01 of one word ("word": two 32-bit hashes, 23, and u01, 4), K1f's word
# ("hw_word": lowbias32 of key ^ slot * golden, 10, and u01) and its state's
# step once per chain-sweep ("hw_step": the 64-bit LCG step in 32-bit
# operations and the XSH-RR output), and the accurate libdevice functions
# (no fast math), approximately.  A multiply and an add count as one
# operation each: -fmad=false forbids fusing them, while the 67 TFLOP/s
# peak counts a fused multiply-add as two, so this code can reach half the
# peak at most.
OPS = {"word": 27, "hw_word": 14, "hw_step": 16, "log": 16, "exp": 12,
       "log1p": 20, "trig": 24, "sqrt": 4, "div": 8}
OPS["gammaln"] = 2 * OPS["log"] + OPS["div"] + 16
OPS["gumbel"] = OPS["log1p"] + OPS["log"] + 2
OPS["normal"] = OPS["log1p"] + OPS["sqrt"] + OPS["trig"] + 3
OPS["bailey"] = OPS["log"] + OPS["exp"] + OPS["sqrt"] + OPS["trig"] + 4


def ddi_stats_ops(part, nnz):
    """Operations of one model's statistics from scratch (``nnz`` nonzero
    coefficients): the features, a multiply and an add per coefficient,
    each column's start."""
    n_quad = part.n_fix * (part.n_fix + 1) // 2
    return part.n_fix + n_quad + 2 * nnz + 2 * part.n_cols


def ddi_lp_ops(part):
    """Operations of one model's lp from its statistics (csrc/ddi.cuh
    am_ddi_lp): the prior, and per class M, the adjugate, its determinant,
    the weighted trace, a division and a log."""
    per_class = (2 * part.ntri + (23 if part.d_re == 3 else 6)
                 + 3 * part.ntri + OPS["div"] + OPS["log"] + 8)
    prior = 4 * part.n_fix + 2 * OPS["log"] + OPS["div"] + 40
    return prior + part.n_cls * per_class


def model_ops(m):
    """Operations of one log-posterior evaluation of model ``m``, counted
    from the density's code, every term in full."""
    from automix_tpu_torch.models import changepoint, ddi, rb9
    kind, c, d = m.cuda.kind, m.cuda.consts, m.dim
    if kind == 1:          # Normal params
        ops = OPS["log"] + OPS["div"] + 12
    elif kind == 2:        # Beta params
        ops = 3 * OPS["gammaln"] + 12
    elif kind == 3:        # Gamma params
        ops = OPS["log"] + OPS["gammaln"] + 10
    elif kind in (4, 5):   # Normal and truncated-Normal samplers
        ops = 5
    elif kind == 6:        # Beta sampler
        ops = OPS["log"] + OPS["log1p"] + 5
    elif kind == 7:        # Normal mixture of c[0] components
        L = int(c[0])
        ops = L * (d * (d + 1) + 2 * d + 3) \
            + (L - 1) * (OPS["exp"] + OPS["log1p"] + 4)
    elif kind == 8:        # toy2
        ops = 6 * d + 8 + OPS["exp"] + OPS["log1p"] + 4
    elif kind == rb9.KIND_RB9:
        ops = d * (OPS["log"] + 6) + 2
        for g, stats in enumerate(rb9.group_stats()):
            if c[10 + g]:
                nv = len(stats[3])
                ops += (OPS["div"] + 2 * OPS["log"] + OPS["gammaln"]
                        + nv * (OPS["gammaln"] + 3) + 12)
            else:
                ops += 5
    elif kind == ddi.KIND_DDI:
        part = ddi.ddi_density().parts[int(c[0])]
        nnz = ddi.ddi_density().nonzeros()[int(c[0])][0]
        ops = ddi_stats_ops(part, nnz) + ddi_lp_ops(part)
    elif kind in (changepoint.KIND_CPT, changepoint.KIND_CPTRS):
        # csrc/changepoint.cuh: per segment its length, the support
        # test, two logs, the prior and likelihood terms and its count's
        # subtraction; the counts need a binary search of each of the
        # model's ns change points in the sorted events, one compare a
        # step.  The kernel's scan of every event against every change
        # point (2 * 191 * ns operations) is its own cost, not the
        # function's.
        ns = int(c[0])
        steps = math.ceil(math.log2(changepoint.N_EVENTS + 1))
        ops = (ns + 1) * (2 * OPS["log"] + 12) + ns * steps + 4
    else:
        raise ValueError(f"no operation count for density kind {kind}")
    return ops + 2         # the sanitizing clamp


def density_ops(ms, probs):
    """Operations of one log-posterior evaluation, averaged over the
    models with weights ``probs``, every term in full."""
    import numpy as np
    return float(np.dot(probs, [model_ops(m) for m in ms.models]))


def evals_ops(ms, probs, n_eval, n_kappa, full=False):
    """Operations of ``n_eval`` log-posterior evaluations of a chain,
    averaged over the models with weights ``probs``.  An rb9 model's terms
    of one over-dispersion kappa alone (km1, the bracket and the
    pal_gammaln of the distinct counts that its Negative-Binomial groups
    read, each once) are counted ``n_kappa`` times per kappa coordinate:
    only a move of that coordinate, a block move or a jump changes them,
    and the function needs them only then.  ``full`` counts every term of
    every evaluation (``density_ops``)."""
    import numpy as np
    from automix_tpu_torch.models import rb9
    per = []
    for m in ms.models:
        c, d = m.cuda.consts, m.dim
        if full or m.cuda.kind != rb9.KIND_RB9:
            per.append(n_eval * model_ops(m))
            continue
        each = d * (OPS["log"] + 6) + 2 + 2      # with the clamp
        counts = {}
        for g, stats in enumerate(rb9.group_stats()):
            if c[10 + g]:
                each += OPS["log"] + 2 * len(stats[3]) + 10
                counts.setdefault(int(c[6 + g]), set()).update(stats[3])
            else:
                each += 5
        kappa = sum(OPS["div"] + OPS["log"] + OPS["gammaln"] + 2
                    + len(v) * (OPS["gammaln"] + 1) for v in counts.values())
        per.append(n_eval * each + n_kappa * kappa)
    return float(np.dot(probs, per))


def sweep_ops(ms, L, probs, perm=False, tdist=False, density=None,
              rng="hash", full=False):
    """Operations of one stage-3 chain-sweep (K1): random words, the
    within-model move, both allocations (L triangular matvecs each), the
    destination draws, the latent fill, the accept, the pk update and the
    chunk sums, at the mean model dimension under ``probs``; ``density``
    replaces the operations of one density evaluation.  ``rng="hw"``
    counts K1f's words and its state's step in place of the hash's.  An
    rb9 kappa's own terms count at two evaluations of the chain-sweep
    (``evals_ops``): a componentwise move of it (0.9), the block move
    (0.1) and the jump's destination (1); ``full`` counts them at every
    evaluation."""
    import numpy as np
    K, D = ms.nmodels, ms.dmax
    dk = float(np.dot(probs, ms.dims))
    z = OPS["bailey"] if tdist else OPS["normal"]
    words = 3 * dk + 1 + 2 * L + K + 2 * (D - dk) + (D if perm else 0)
    moves = 0.9 * dk + 0.1            # componentwise, block every 10th
    alloc = L * (1.5 * dk * (dk + 1) + 2 * dk + 3) + L * OPS["exp"] \
        + OPS["log"] + 2 * L
    word = OPS["hw_word"] if rng == "hw" else OPS["word"]
    ops = (words * word + (OPS["hw_step"] if rng == "hw" else 0)
           + (2 * L + K) * OPS["gumbel"]
           + dk * z + moves * (OPS["exp"] + 8)
           + 2 * alloc
           + (D - dk) * (z + 4) + (D * D if perm else 0)
           + dk * (dk + 1) + OPS["exp"] + 20
           + K * (OPS["log"] + 6) + OPS["exp"] + OPS["log"]
           + 3 * D + 2
           + (evals_ops(ms, probs, moves + 1, 2.0, full) if density is None
              else (moves + 1) * density))
    return ops


def cache_sweep_ops(ms, L, probs, cnt, perm=False, rng="hash"):
    """Operations of one K1e chain-sweep on the DDI family: K1's work
    without its density (``sweep_ops`` at a zero-cost density), then the
    work the cached density needs for this run's data.  ``cnt`` holds the
    run's six counters summed over chains ([block accepts, block tries,
    componentwise accepts, componentwise tries, RJ accepts, chain-
    sweeps]).  Every try evaluates the chain's own model once: a
    componentwise try its coordinate update and lp, a block try and the RJ
    move its statistics from scratch and lp.  An accept adds only the
    other model's statistics (after an alpha move of a coordinate that
    model has, or from scratch after a block or RJ move) and the 2-op
    blend of each column it touches; what the kernel recomputes on an
    accept for want of a stored candidate is not counted.  Every 16th
    sweep refreshes both models' statistics and one lp."""
    import numpy as np
    from automix_tpu_torch.models import ddi
    dens = ddi.ddi_density()
    parts, nnz = dens.parts, dens.nonzeros()
    n = float(cnt[5])
    full = [ddi_stats_ops(p, z[0]) for p, z in zip(parts, nnz)]
    lp = [ddi_lp_ops(p) for p in parts]
    # one coordinate update of model m and the columns it touches,
    # averaged over its alpha coordinates
    coord = [2 * z[1] / p.n_fix + 2 * p.n_fix + 3
             for p, z in zip(parts, nnz)]
    touched = [float(np.mean([len(t) for t in p.touched])) for p in parts]
    own_full = own_coord = acc_full = acc_coord = 0.0
    for m, (pm, dm) in enumerate(zip(probs, ms.dims)):
        o = 1 - m
        f_own = parts[m].n_fix / dm          # own alpha among active coords
        f_oth = min(parts[o].n_fix, dm) / dm  # coords the other model has
        own_full += pm * (full[m] + lp[m])
        own_coord += pm * (f_own * coord[m] + lp[m])
        acc_full += pm * (full[o] + 2 * dens.n_cache)
        acc_coord += pm * (f_oth * coord[o]
                           + 2 * (f_own * touched[m] + f_oth * touched[o]))
    own_lp = float(np.dot(probs, lp))
    ops = (sweep_ops(ms, L, probs, perm, density=0.0, rng=rng)
           + float(cnt[1]) / n * own_full
           + float(cnt[3]) / n * own_coord
           + own_full                                     # RJ evaluation
           + (float(cnt[0]) + float(cnt[4])) / n * acc_full
           + float(cnt[2]) / n * acc_coord
           + (sum(full) + own_lp) / 16.0)
    return ops


def stage1_ops(ms, probs, full=False):
    """Operations of one stage-1 chain-sweep (K2, K3): 3 words and one
    perturbation per active coordinate, componentwise accepts; an rb9
    kappa's own terms at its one move of the sweep (``evals_ops``), or with
    ``full`` at every evaluation."""
    import numpy as np
    dk = float(np.dot(probs, ms.dims))
    return (3 * dk * OPS["word"] + dk * (OPS["normal"] + OPS["exp"] + 10)
            + evals_ops(ms, probs, dk, 1.0, full))


def state_bytes(K, D):
    """Bytes of one chain's stage-3 state read and written once: k, theta,
    logp, pk, pkllim and nreinit in and out, the chunk sums and counters
    out."""
    return 4 * 2 * (3 + D + K + 1) + 4 * (K + 2 * K * D + 6)


def tables_bytes(K, D, L):
    return 4 * (K * L * (2 * D * D + D + 3) + K * D)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of ops over the float32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bounds(ops_of, nbytes):
    """A check's bound keys: ``bound_ms`` and ``bound_by`` of the
    operations ``ops_of(False)``; where the full count ``ops_of(True)``
    differs (rb9's kappa terms at every evaluation), its bound as
    ``bound_full_ms``, comparable with the bounds of older readings."""
    b_ms, b_by = bound(ops_of(False), nbytes)
    out = dict(bound_ms=b_ms, bound_by=b_by)
    b_full = bound(ops_of(True), nbytes)[0]
    if b_full != b_ms:
        out["bound_full_ms"] = b_full
    return out


def bound_text(b):
    """``b`` (``bounds``) for a log line."""
    full = (f", {b['bound_full_ms']:.4f} ms counted in full"
            if "bound_full_ms" in b else "")
    return f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}){full}"


def unit_seconds(lib_path):
    """Seconds from the build's start to each compilation unit's object,
    from the build's log: (source and its -D definitions, seconds)."""
    import re
    text = lib_path.with_suffix(".log").read_text()
    out = []
    for block in text.split("$ ")[1:]:
        m = re.search(r"unit done after ([\d.]+) s", block)
        if m:
            cmd = block.split("\n", 1)[0].split()
            defs = [a[2:] for a in cmd if a.startswith("-DAM_")
                    and "SYMBOL" not in a]
            src = next(a for a in cmd if a.endswith(".cu"))
            out.append((" ".join([os.path.basename(src)] + defs),
                        float(m.group(1))))
    return out


def ptxas_summary(lib_path, K, D):
    """The ptxas -v record of every kernel instantiated at (K, D), from the
    build's log beside the library: one (kernel and its bool template
    argument, or its unit's Student-t flag where it has none, registers,
    stack frame, spill stores, spill loads) per compiled form, in the order
    of the log (its units and variants)."""
    import re
    text = lib_path.with_suffix(".log").read_text()
    out = []
    for unit in text.split("$ ")[1:]:
        t = re.search(r"-DAM_(?:STAGE1_T|TDIST)=(\d)",
                      unit.split("\n", 1)[0])
        for block in unit.split("Compiling entry function '")[1:]:
            name = block.split("'", 1)[0]
            m = re.search(rf"\d(fused_[a-z0-9_]*?_kernel)ILi{K}ELi{D}E"
                          r"(?:Lb([01])E)?", name)
            if not m:
                continue
            arg = m.group(2) if m.group(2) else f"t{t.group(1) if t else 0}"
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", block)
            regs = re.search(r"Used (\d+) registers", block)
            out.append((f"{m.group(1)}<{arg}>", int(regs.group(1)),
                        *map(int, frame.groups())))
    return out


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    one warm-up run unless ``warm`` is False, timed with CUDA events."""
    import torch
    if warm:
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


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` replayed from one CUDA graph of
    ``reps`` calls (after a warm-up call on a side stream): the kernels'
    time without the host's per-call launch and allocation cost."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def timed(fn):
    """(``fn()``, its milliseconds on the card), one run timed with CUDA
    events.  A plain twin is timed on the run that checks its kernel: it
    takes seconds, and the kernel has run at the same widths before it."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def reset_counts():
    from automix_tpu_torch.kernels import fused, fused_stage1, sweep_rng
    fused.sweep_chunk.launches = 0
    fused.sweep_chunk.pooled_launches = 0
    fused.sweep_chunk.hw_launches = 0
    fused.sweep_chunk.pooled_hw_launches = 0
    fused.sweep_chunk.scan_launches = 0
    fused.sweep_chunk.scan_hw_launches = 0
    fused_stage1.segment.launches = 0
    fused_stage1.sweep.launches = 0
    sweep_rng.draw.launches = 0


def read_counts():
    """Launches since the last reset: K1 (every per-chain kernel launch
    with the hash, the one-sweep pooled route's included), K1c (pooled,
    hash), K1d (pooled above K1c's bound, hash), K1f, K1fc and K1fd (the
    same three with the hw stream), K2, K3, K4."""
    from automix_tpu_torch.kernels import fused, fused_stage1, sweep_rng
    return {"K1": fused.sweep_chunk.launches,
            "K1c": fused.sweep_chunk.pooled_launches,
            "K1d": fused.sweep_chunk.scan_launches,
            "K1f": fused.sweep_chunk.hw_launches,
            "K1fc": fused.sweep_chunk.pooled_hw_launches,
            "K1fd": fused.sweep_chunk.scan_hw_launches,
            "K2": fused_stage1.segment.launches,
            "K3": fused_stage1.sweep.launches,
            "K4": sweep_rng.draw.launches}


def uniform(ms):
    import numpy as np
    return np.full(ms.nmodels, 1.0 / ms.nmodels)


def stage1_start(ms, C, dev):
    import torch
    from automix_tpu_torch.ops import randoms
    K, D = ms.nmodels, ms.dmax
    init = ms.init_points(randoms.key(0))
    theta = init[torch.arange(K * C) // C].T.contiguous().to(dev)
    dims = torch.as_tensor(ms.dims)
    sig = (10.0 * (torch.arange(D)[None] < dims[:, None])).float().to(dev)
    zi = torch.zeros((K, D), dtype=torch.int32, device=dev)
    return theta, sig, zi


def check_segment(ms, C, dev, tdist=None, label="K2", rule="aap"):
    """K2 against segment_ref run on the card: K models x C chains over
    many one-warp blocks, one 100-sweep segment (componentwise sweeps 1-50,
    block-move coins after the burn-in at 50), seed 777, the pooled
    ``rule`` ("aap" or "log", gain 3).  theta, logp, sig and the counts
    must be bitwise equal: integer accept counts make the pooled update
    exact, and kernel and twin call the same float32 functions."""
    import torch
    from automix_tpu_torch.kernels import fused_stage1
    theta, sig, zi = stage1_start(ms, C, dev)
    kw = dict(C=C, sweep0=0, seed=777, nburn=50, n_active=100, tdist=tdist,
              rule=rule, log_gain=3.0)
    got = fused_stage1.segment(ms, theta, sig, zi, zi, **kw)
    want, ms_p = timed(lambda: fused_stage1.segment_ref(ms, theta, sig, zi,
                                                        zi, **kw))
    th_err = (got[0] - want[0]).abs()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"{label} vs segment_ref ({ms.nmodels} x {C} chains): theta max|err| "
        f"{float(th_err.max()):.3e}, theta, sig, counts and logp equal "
        f"{equal}")
    if not equal:
        fail(f"{label} is not bitwise equal to segment_ref")
    ms_k = cuda_ms(lambda: fused_stage1.segment(ms, theta, sig, zi, zi,
                                                **kw), 20)
    N = ms.nmodels * C
    b = bounds(lambda full: 100 * N * stage1_ops(ms, uniform(ms), full),
               N * 4 * 2 * (ms.dmax + 1))
    log(f"{label} segment ({N} chains x 100 sweeps): kernel {ms_k:.4f} ms, "
        f"plain {ms_p:.4f} ms, {bound_text(b)}")
    return dict(max_abs_err=float(th_err.max()), ms=ms_k, plain_ms=ms_p,
                **b)


def check_sweep_kernel(ms, C, dev, label="K3"):
    """K3 in its moves-only mode against sweep_ref: one 100-sweep segment
    of K x C chains, sweep by sweep from the same state.  The per-sweep
    accept counts must be equal; theta and logp agree within float32
    tolerance on >= 99% of lanes.  Timed per sweep with the pooled update
    in its launch, the runner's form: launched from Python (``ms``, as
    before the update moved into the launch) and replayed from a CUDA
    graph (``graph_ms``, the device's time alone); moves only from
    Python beside it."""
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
    log(f"{label} vs sweep_ref ({ms.nmodels} x {C} chains x 100 sweeps): "
        f"theta max|err| {float(th_err.max()):.3e}, lanes within 1e-5: "
        f"{frac:.6f}, accept counts equal {counts_equal}")
    if not counts_equal:
        fail(f"{label} accept counts differ from sweep_ref")
    if frac < 0.99:
        fail(f"{label} agrees on only {frac:.4f} of lanes")
    # the update on copies of sig, nacc and ntry, which it updates in
    # place, with one work buffer as the runner's
    K, D = ms.nmodels, ms.dmax
    upd = dict(nacc=torch.zeros(sig.shape, dtype=torch.int32, device=dev),
               ntry=torch.zeros(sig.shape, dtype=torch.int32, device=dev),
               work=torch.zeros(K * D + 1, dtype=torch.int32, device=dev))
    sig_u = sig.clone()

    def in_launch():
        fused_stage1.sweep(ms, theta, lp_k, sig_u, t=60, seg_start=False,
                           **kw, **upd)

    ms_k = cuda_ms(in_launch, 200)
    ms_g = graph_ms(in_launch, 100)
    ms_m = cuda_ms(lambda: fused_stage1.sweep(ms, theta, lp_k, sig, t=60,
                                              seg_start=False, **kw), 200)
    ms_p = cuda_ms(lambda: fused_stage1.sweep_ref(
        ms, theta, lp_k, sig, t=60, seg_start=False, **kw), 5)
    N = ms.nmodels * C
    b = bounds(lambda full: N * stage1_ops(ms, uniform(ms), full) + 8 * K * D,
               N * 4 * 2 * (D + 1))
    grid = fused_stage1.sweep_grid(N, dev)
    log(f"{label} sweep ({N} chains x 1 sweep, blocks of {grid[0]} x "
        f"{grid[1]}): kernel {ms_k:.4f} ms with the update in its launch "
        f"({ms_g:.4f} ms from a graph), {ms_m:.4f} ms moves only; plain "
        f"{ms_p:.4f} ms, {bound_text(b)}")
    return dict(max_abs_err=float(th_err.max()), ms=ms_k, graph_ms=ms_g,
                plain_ms=ms_p, **b)


def runner_ms_per_sweep(run, n):
    """(``run()``'s result, host milliseconds per sweep of its ``n``
    sweeps), a synchronize before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / n


def check_sweep_runner(ms, dev):
    """The one-sweep runner (K3), which the routing rule sends only
    populations above K2's resident capacity, against the segment runner
    (K2) at toy2's CLI population, 5 x 2048 chains, 300 stage-1 sweeps
    (block-move sweeps after the 30 of burn-in), on the AAP rule, K3 with
    the pooled update in its launch: sig, samples, telemetry and logp
    bitwise equal to K2's (the segment kernel computes the rule's float32
    expressions in its launch, K3 in its last block).  Both runners timed
    on the host per sweep.  Returns the K3 runner's launches."""
    import torch
    from automix_tpu_torch import EngineConfig
    from automix_tpu_torch.kernels import fused_stage1
    from automix_tpu_torch.ops import randoms
    init = ms.init_points(randoms.key(0))
    cfg = EngineConfig(seed=3)
    n = 330
    reset_counts()
    a, ms_in = runner_ms_per_sweep(
        lambda: fused_stage1.run_fused_stage1_sweeps(
            ms, cfg, 300, TOY2_C_K3, init, dev), n)
    counts = read_counts()
    b, ms_seg = runner_ms_per_sweep(lambda: fused_stage1.run_fused_stage1(
        ms, cfg, 300, TOY2_C_K3, init, dev), n)
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"K3 runner (launches {counts}) vs K2 runner (toy2, 5 x "
        f"{TOY2_C_K3} chains, {n} sweeps, AAP): sig, samples, telemetry and "
        f"logp equal {equal}; host ms per sweep: K3 {ms_in:.4f}, K2 "
        f"{ms_seg:.4f}")
    if not equal or counts["K3"] != n or counts["K2"]:
        fail("the one-sweep runner disagrees with the segment runner")
    return counts


def stage1_routes(ms, C, nsweeps, dev, label):
    """Stage 1 of K models x C chains on both routes from the same start,
    ``nsweeps`` sweeps (+10% burn-in) at seed 0: the segment runner (K2)
    and the one-sweep runner (K3, the update in its launch), each timed on
    the host clock after a synchronize; sig, samples, telemetry and logp
    must be bitwise equal.  Returns the K3 run's launches."""
    import torch
    from automix_tpu_torch import EngineConfig
    from automix_tpu_torch.kernels import fused_stage1
    from automix_tpu_torch.ops import randoms
    cfg = EngineConfig(seed=0)
    init = ms.init_points(randoms.key(0))
    out, secs, counts = [], [], []
    for run in (fused_stage1.run_fused_stage1,
                fused_stage1.run_fused_stage1_sweeps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out.append(run(ms, cfg, nsweeps, C, init, dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(read_counts())
    equal = all(torch.equal(a, b) for a, b in zip(*out))
    n = nsweeps * 11 // 10
    log(f"{label} stage 1 ({ms.nmodels} x {C} chains, {n} sweeps): K2 "
        f"{secs[0]:.3f} s (launches {counts[0]}), K3 {secs[1]:.3f} s "
        f"({secs[1] * 1e3 / n:.4f} ms a sweep; launches {counts[1]}); sig, "
        f"samples, telemetry and logp equal {equal}")
    if not equal:
        fail(f"{label}: the stage-1 routes differ")
    return counts[1]


def k_probs(ms, k):
    """The share of chains in each model of a state."""
    import torch
    return (torch.bincount(k.long().cpu(), minlength=ms.nmodels).double()
            / k.numel()).numpy()


def check_sweep(ms, prop, chains, dev, perm=False, tdist=None, label="K1"):
    """K1 against sweep_chunk_ref: 16384 chains taken from a run's state,
    50 production sweeps under its fitted proposal.  The kernel is timed
    on every chain of the state x 100 sweeps, the twin on its check run
    (16384 chains x 50 sweeps)."""
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
    want, ms_p = timed(lambda: fused.sweep_chunk_ref(ms, *args, tabs, **kw))
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
    L = tabs.loglam.shape[1]
    K, D = ms.nmodels, ms.dmax
    b = bounds(
        lambda full: ch.n_chains * TIME_SWEEPS * sweep_ops(
            ms, L, k_probs(ms, ch.k), perm, tdist is not None, full=full),
        ch.n_chains * state_bytes(K, D) + tables_bytes(K, D, L))
    log(f"{label} sweep chunk ({ch.n_chains} chains x {TIME_SWEEPS} sweeps): "
        f"kernel {ms_k:.4f} ms, {bound_text(b)}; plain "
        f"{ms_p:.4f} ms ({n} chains x {K1_SWEEPS} sweeps, its check)")
    return dict(max_abs_err=th_err, ms=ms_k, plain_ms=ms_p, **b)


def launch_lengths(ms, prop, chains):
    """Milliseconds per sweep of K1 on every chain of a state with pk
    frozen, 100 sweeps run as launches of 1, 10 and 100 sweeps, each
    launch fed the previous one's chains."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    ch = chains
    rest = (ch.pk.T.contiguous(), ch.pkllim, ch.nreinit)
    out = {}
    for n in (1, 10, TIME_SWEEPS):
        def run():
            k, th, lp = ch.k, ch.theta.T.contiguous(), ch.logp
            for j in range(TIME_SWEEPS // n):
                k, th, lp = fused.sweep_chunk(
                    ms, k, th, lp, *rest, tabs, seed=5,
                    sweep0=ch.sweep + j * n, n_sweeps=n, adapt=False)[:3]
        out[n] = cuda_ms(run, 2) / TIME_SWEEPS
    return out


def check_pooled(ms, prop, chains, dev):
    """K1c against the pooled twin (run on the card) from a pooled run's
    state: every chain, 50 sweeps.  k equal on >= 99% of chains, theta and
    logp within float32 tolerance on those; where every chain agrees, the
    integer histogram makes the shared pk, pkllim and nreinit bitwise
    equal.  Timed on the same state x 100 sweeps (the twin on its
    check)."""
    import torch
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    ch = chains
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit)

    def kw(n):
        return dict(seed=13, sweep0=ch.sweep, n_sweeps=n, adapt=True,
                    pooled=True)

    kt = kw(TIME_SWEEPS)
    got = fused.sweep_chunk(ms, *args, tabs, **kt)
    want, ms_p = timed(lambda: fused.sweep_chunk_ref(ms, *args, tabs, **kt))
    same = got[0] == want[0]
    frac = float(same.float().mean())
    th_err = float((got[1] - want[1]).abs()[:, same].max())
    lp_err = float(((got[2] - want[2]).abs()
                    / (1 + want[2].abs()))[same].max())
    shared = all(torch.equal(got[i], want[i]) for i in (3, 4, 5))
    log(f"K1c vs pooled twin ({ch.n_chains} chains x {TIME_SWEEPS} sweeps): k "
        f"equal on {frac:.6f}, theta max|err| {th_err:.3e}, logp max rel "
        f"err {lp_err:.3e}, shared pk/pkllim/nreinit equal {shared}")
    if frac < 0.99:
        fail(f"K1c k agrees on only {frac:.4f} of chains")
    if th_err > 1e-3 or lp_err > 1e-4:
        fail(f"K1c theta/logp differ: {th_err:.3e} / {lp_err:.3e}")
    if frac == 1.0 and not shared:
        fail("K1c shared pk differs on identical trajectories")
    ms_k = cuda_ms(lambda: fused.sweep_chunk(ms, *args, tabs, **kt), 5)
    L, K, D = tabs.loglam.shape[1], ms.nmodels, ms.dmax
    b = bounds(
        lambda full: ch.n_chains * TIME_SWEEPS * (
            sweep_ops(ms, L, k_probs(ms, ch.k), full=full) + 2 * K),
        ch.n_chains * state_bytes(K, D) + tables_bytes(K, D, L))
    log(f"K1c pooled chunk ({ch.n_chains} chains x {TIME_SWEEPS} sweeps): "
        f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, {bound_text(b)}")
    return dict(max_abs_err=th_err, ms=ms_k, plain_ms=ms_p, **b)


def scan_against_route(ms, tabs, chains, n_sweeps, rng, label):
    """K1d (``pooled_scan``: one cooperative launch) and the one-sweep
    route it replaces (``pooled_sweeps`` over ``sweep_chunk``: a K1 launch
    a sweep and the shared update in torch), both on the card from
    ``chains``: k, theta, logp, pk, pkllim, nreinit, the visit counts and
    the six counters bitwise equal, the theta sums within 1e-5 relative
    (another summation order).  Fails otherwise.  Returns K1d's (chains,
    chunk)."""
    import torch
    from automix_tpu_torch.kernels import fused
    a, ca = fused.pooled_scan(ms, chains, tabs, n_sweeps, seed=17, rng=rng)
    b, cb = fused.pooled_sweeps(ms, chains, tabs, n_sweeps, seed=17, rng=rng,
                                sweep_fn=fused.sweep_chunk)
    torch.cuda.synchronize()
    fields = all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "k", "theta", "logp", "pk", "pkllim", "nreinit"))
    counts = all(torch.equal(ca[n], cb[n]) for n in ca
                 if not n.startswith("theta"))
    sums = max(float(((ca[n] - cb[n]).abs()
                      / (1e-2 + cb[n].abs())).max())
               for n in ("theta_sum", "theta_sqsum"))
    jumps = float((a.k != chains.k).float().mean())
    log(f"{label} vs the one-sweep route, {rng} ({chains.n_chains} chains x "
        f"{n_sweeps} sweeps from sweep {chains.sweep}): chain fields equal "
        f"{fields}, visit counts and counters equal {counts}, theta sums "
        f"max rel diff {sums:.3e}; chains that jumped {jumps:.4f}")
    if not (fields and counts and sums <= 1e-5):
        fail(f"{label} differs from the one-sweep route")
    return a, ca


def route_turns(ms, tabs, chains, rng):
    """ms per sweep of the one-sweep route (K1D_CHECK_SWEEPS sweeps) and of
    K1d (a launch of TIME_SWEEPS sweeps) on ``chains``, in turns (route,
    K1d, K1d, route): ([route, route], [K1d, K1d])."""
    from automix_tpu_torch.kernels import fused

    def route():
        return cuda_ms(lambda: fused.pooled_sweeps(
            ms, chains, tabs, K1D_CHECK_SWEEPS, seed=17, rng=rng,
            sweep_fn=fused.sweep_chunk), 2) / K1D_CHECK_SWEEPS

    def scan():
        return cuda_ms(lambda: fused.pooled_scan(
            ms, chains, tabs, TIME_SWEEPS, seed=17, rng=rng), 2) \
            / TIME_SWEEPS

    r1, s1, s2, r2 = route(), scan(), scan(), route()
    return [r1, r2], [s1, s2]


def scan_bound(ms, L, chains, rng, ops_of=None):
    """``bounds`` of one sweep of K1d over ``chains``, from the work its
    function needs: every chain's sweep (``sweep_ops``, rb9's kappa terms
    where kappa can change; in full beside them) and its count in the
    histogram, and the chains' k, theta and logp read and written once a
    chunk of TIME_SWEEPS sweeps, with the tables."""
    K, D = ms.nmodels, ms.dmax
    S = chains.n_chains
    if ops_of is None:
        def ops_of(full):
            return sweep_ops(ms, L, k_probs(ms, chains.k), rng=rng,
                             full=full)
    return bounds(lambda full: S * (ops_of(full) + 1),
                  (S * 4 * 2 * (D + 2) + tables_bytes(K, D, L)) / TIME_SWEEPS)


def check_pooled_runner(ms, prop, chains, dev, rng="hash"):
    """K1d against the one-sweep route on every chain of a pooled run's
    state (``scan_against_route``, K1D_CHECK_SWEEPS sweeps) and, on the
    first 16384 chains, against the same route over the twin (both on the
    card): k equal on >= 99% of chains; where all agree, the shared pk and
    the visit counts bitwise equal.  The stream is ``rng`` (pinned: "hash"
    by default).  K1d and the route are timed per sweep on every chain of
    the state, in turns; the twin on two sweeps."""
    import torch
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.state import Chains
    tabs = fused.prep_tables(prop, ms.dims)
    scan_against_route(ms, tabs, chains, K1D_CHECK_SWEEPS, rng, "K1d")
    n = K1_CHAINS
    sub = Chains(**{f: getattr(chains, f)[:n].contiguous() for f in
                    ("k", "theta", "logp", "pk", "pkllim", "nreinit")},
                 sweep=chains.sweep)
    a, ca = fused.pooled_scan(ms, sub, tabs, K1D_CHECK_SWEEPS, seed=17,
                              rng=rng)
    b, cb = fused.pooled_sweeps(ms, sub, tabs, K1D_CHECK_SWEEPS, seed=17,
                                sweep_fn=fused.sweep_chunk_ref, rng=rng)
    torch.cuda.synchronize()
    same = a.k == b.k
    frac = float(same.float().mean())
    th_err = float((a.theta - b.theta).abs()[same].max())
    shared = (torch.equal(a.pk, b.pk) and torch.equal(a.nreinit, b.nreinit)
              and torch.equal(ca["ksummary"], cb["ksummary"]))
    log(f"K1d vs the twin runner, {rng} ({n} chains x "
        f"{K1D_CHECK_SWEEPS} sweeps): k equal on {frac:.6f}, theta max|err| "
        f"{th_err:.3e}, shared pk and visit counts equal {shared}")
    if frac < 0.99:
        fail(f"K1d k agrees on only {frac:.4f} of chains")
    if th_err > 1e-3:
        fail(f"K1d theta differs by {th_err:.3e}")
    if frac == 1.0 and not shared:
        fail("K1d shared pk differs on identical trajectories")
    route_ms, scan_ms = route_turns(ms, tabs, chains, rng)
    ms_p = cuda_ms(lambda: fused.pooled_sweeps(
        ms, chains, tabs, 2, seed=17, sweep_fn=fused.sweep_chunk_ref,
        rng=rng), 1, warm=False) / 2
    b = scan_bound(ms, tabs.loglam.shape[1], chains, rng)
    log(f"K1d, {rng} ({chains.n_chains} chains, per sweep, in turns): K1d "
        f"{scan_ms[0]:.4f} / {scan_ms[1]:.4f} ms, the one-sweep route "
        f"{route_ms[0]:.4f} / {route_ms[1]:.4f} ms, plain {ms_p:.4f} ms, "
        f"{bound_text(b)}, share {b['bound_ms'] / min(scan_ms):.2%}")
    return dict(max_abs_err=th_err, ms=min(scan_ms), plain_ms=ms_p,
                route_ms=min(route_ms), **b)


def check_hw(ms, prop, chains, label, perm=False, tdist=None, pooled=False,
             exact=False):
    """K1f, the kernel with its hw stream, against its twin (the same
    stream in torch) run on the card: the first K1_CHAINS chains of a run's
    state x K1_SWEEPS sweeps.  ``exact`` (K1e) holds every output bitwise
    equal, as ``exact_check``; otherwise k equal on >= 99% of chains and
    theta / logp within check_sweep's tolerances on those.  The kernel is
    timed on the same inputs, the twin on its check run."""
    import torch
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.model import make_density
    from automix_tpu_torch.state import Chains
    tabs = fused.prep_tables(prop, ms.dims)
    n = min(K1_CHAINS, chains.n_chains)
    sub = Chains(**{f: getattr(chains, f)[:n].contiguous() for f in
                    ("k", "theta", "logp", "pk", "pkllim", "nreinit")},
                 sweep=chains.sweep)
    args = chunk_args(sub)
    kw = dict(seed=11, sweep0=sub.sweep, n_sweeps=K1_SWEEPS, adapt=True,
              perm=perm, tdist=tdist, pooled=pooled, rng="hw")
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    want, ms_p = timed(lambda: fused.sweep_chunk_ref(ms, *args, tabs, **kw))
    same = got[0] == want[0]
    frac = float(same.float().mean())
    th_err = float((got[1] - want[1]).abs()[:, same].max())
    lp_err = float(((got[2] - want[2]).abs()
                    / (1 + want[2].abs()))[same].max())
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    hashed = fused.sweep_chunk(ms, *args, tabs, **dict(kw, rng="hash"))
    other = float((hashed[0] != got[0]).float().mean())
    log(f"{label} vs its twin ({n} chains x {K1_SWEEPS} sweeps, K="
        f"{ms.nmodels}, D={ms.dmax}, L={tabs.loglam.shape[1]}): k equal on "
        f"{frac:.6f}, theta max|err| {th_err:.3e}, logp max rel err "
        f"{lp_err:.3e}, every output equal {equal}; k differs from the "
        f"hash kernel's on {other:.4f}")
    if exact and not equal:
        fail(f"{label} differs from its twin")
    if frac < 0.99:
        fail(f"{label} k agrees on only {frac:.4f} of chains")
    if th_err > 1e-3 or lp_err > 1e-4:
        fail(f"{label} theta/logp differ: {th_err:.3e} / {lp_err:.3e}")
    if pooled and frac == 1.0 and not all(
            torch.equal(got[i], want[i]) for i in (3, 4, 5)):
        fail(f"{label} shared pk differs on identical trajectories")
    ms_k = cuda_ms(lambda: fused.sweep_chunk(ms, *args, tabs, **kw), 5)
    L, K, D = tabs.loglam.shape[1], ms.nmodels, ms.dmax
    probs = k_probs(ms, sub.k)
    cached = make_density(ms).n_cache
    cnt = got[9].sum(1).double().cpu().numpy() if cached else None

    def ops(full):
        if cached:
            return cache_sweep_ops(ms, L, probs, cnt, perm, rng="hw")
        return sweep_ops(ms, L, probs, perm, tdist is not None, rng="hw",
                         full=full)

    b = bounds(lambda full: n * K1_SWEEPS * (ops(full)
                                             + (2 * K if pooled else 0)),
               n * state_bytes(K, D) + tables_bytes(K, D, L))
    log(f"{label} ({n} chains x {K1_SWEEPS} sweeps): kernel {ms_k:.4f} ms, "
        f"plain {ms_p:.4f} ms, {bound_text(b)}, share "
        f"{b['bound_ms'] / ms_k:.2%}")
    return dict(max_abs_err=th_err, ms=ms_k, plain_ms=ms_p, **b)


def stream_times(ms, prop, chains):
    """K1 with each stream on every chain of a state x TIME_SWEEPS sweeps,
    in turns (hash, hw, hw, hash) within one run: each stream's mean ms,
    its bound and its share of it."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    args = chunk_args(chains)
    times = {"hash": [], "hw": []}
    for rng in ("hash", "hw", "hw", "hash"):
        times[rng].append(cuda_ms(lambda: fused.sweep_chunk(
            ms, *args, tabs, seed=5, sweep0=chains.sweep,
            n_sweeps=TIME_SWEEPS, adapt=True, rng=rng), 5))
    L, K, D = tabs.loglam.shape[1], ms.nmodels, ms.dmax
    S = chains.n_chains
    out = {}
    for rng, t in times.items():
        ms_k = sum(t) / len(t)
        b_ms, b_by = bound(S * TIME_SWEEPS * sweep_ops(
            ms, L, k_probs(ms, chains.k), rng=rng),
            S * state_bytes(K, D) + tables_bytes(K, D, L))
        out[rng] = (ms_k, b_ms, b_by)
        log(f"K1 {rng} stream on the main path's state ({S} chains x "
            f"{TIME_SWEEPS} sweeps, turns hash/hw/hw/hash): "
            f"{' / '.join(f'{x:.4f}' for x in t)} ms, mean {ms_k:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms_k:.2%}")
    return out


# The sweep kernel's forms at the toy shapes: (label, perm, Student-t,
# stream).  toy2's (5, 5) forms on its state; toy1's (2, 2) forms, which its
# `-t 5` CLI (K1f) and a hash run of its state (K1a) launch, on toy1's.
TOY2_FORMS = (("K1", False, False, "hash"), ("K1a", True, True, "hash"),
              ("K1b", True, False, "hash"), ("K1f", False, False, "hw"),
              ("K1f + perm", True, False, "hw"),
              ("K1f + t + perm", True, True, "hw"))
TOY1_FORMS = (("K1a", True, True, "hash"),
              ("K1f + t + perm", True, True, "hw"))
TOY_CHECK_SWEEPS = 20
CLI_LAUNCH = 16            # the CLI's launch: a trace every 16th sweep


def check_toy_forms(ms, prop, chains, forms, label):
    """Each form of ``forms`` against its twin run on the card, every
    output bitwise equal (``exact_check``: K1_CHAINS chains of the state x
    TOY_CHECK_SWEEPS sweeps), then timed on every chain of the state per
    launch of TIME_SWEEPS and of CLI_LAUNCH sweeps, each against its
    bound.  Returns {form: its entry keys, the TIME_SWEEPS launch's time
    and bound}."""
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.ops import randoms
    tabs = fused.prep_tables(prop, ms.dims)
    small = chunk_args(grown(chains, K1_CHAINS))
    args = chunk_args(chains)
    L, K, D, S = tabs.loglam.shape[1], ms.nmodels, ms.dmax, chains.n_chains
    probs = k_probs(ms, chains.k)
    out = {}
    for form, perm, tdist, rng in forms:
        kw = dict(seed=11, adapt=True, perm=perm, rng=rng,
                  tdist=randoms.student_t(5) if tdist else None)
        _, err, ms_p = exact_check(ms, tabs, small, f"{label} {form}",
                                   sweep0=chains.sweep,
                                   n_sweeps=TOY_CHECK_SWEEPS, **kw)
        row = {}
        for n in (TIME_SWEEPS, CLI_LAUNCH):
            ms_k = cuda_ms(lambda: fused.sweep_chunk(
                ms, *args, tabs, sweep0=chains.sweep, n_sweeps=n, **kw), 5)
            b = bounds(lambda full: S * n * sweep_ops(
                ms, L, probs, perm, tdist, rng=rng, full=full),
                S * state_bytes(K, D) + tables_bytes(K, D, L))
            row[n] = (ms_k, b)
        log(f"{label} {form} ({S} chains, L={L}): "
            + "; ".join(f"{n} sweeps {ms_k:.4f} ms, {bound_text(b)}, share "
                        f"{b['bound_ms'] / ms_k:.2%}"
                        for n, (ms_k, b) in row.items())
            + f"; plain {ms_p:.4f} ms ({K1_CHAINS} chains x "
            f"{TOY_CHECK_SWEEPS} sweeps, its check)")
        ms_k, b = row[TIME_SWEEPS]
        out[form] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, **b)
    return out


def toy_drive(ms, prop, chains, label, **cfg):
    """A form's own path where no sampler path of this run launches it:
    ``AMSampler`` from a state and its proposal on the stream "auto"
    resolves to (K1f), TIME_SWEEPS production sweeps in one chunk, counts
    set to 0 just before.  Returns its launch counts."""
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    am = AMSampler(ms, EngineConfig(
        n_chains=chains.n_chains, seed=23, sweep_chunk=TIME_SWEEPS,
        trace_chain0=False, **cfg), device="cuda")
    am.set_proposal(prop)
    am.chains = chains
    reset_counts()
    am.rjmcmc_samples(TIME_SWEEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{label}, {chains.n_chains} chains x {TIME_SWEEPS} sweeps: "
        f"launches {counts}")
    if counts["K1f"] == 0 or counts["K1"]:
        fail(f"{label} did not launch K1f alone")
    return counts


def hash_drive(ms, prop, chains, label, seed=21, **cfg):
    """The path of a hash form whose sampler path now runs K1f ("auto" is
    hw on the card): ``AMSampler`` pinned to fused_rng="hash" from a run's
    proposal and state, TIME_SWEEPS production sweeps in one chunk, counts
    set to 0 just before.  Fails unless it launched the hash kernel and no
    K1f.  Returns its launch counts."""
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    am = AMSampler(ms, EngineConfig(
        n_chains=chains.n_chains, seed=seed, fused_rng="hash",
        sweep_chunk=TIME_SWEEPS, trace_chain0=False, **cfg), device="cuda")
    am.set_proposal(prop)
    am.chains = chains
    reset_counts()
    am.rjmcmc_samples(TIME_SWEEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{label}, fused_rng='hash', {chains.n_chains} chains x "
        f"{TIME_SWEEPS} sweeps: launches {counts}")
    if counts["K1"] + counts["K1c"] + counts["K1d"] == 0 \
            or counts["K1f"] + counts["K1fc"] + counts["K1fd"]:
        fail(f"{label} did not run the hash kernel alone")
    return counts


def chunk_args(chains):
    """A chain state in the sweep kernels' layouts: k, theta [D, S], logp,
    pk [K, S], pkllim, nreinit."""
    ch = chains
    return (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit)


def exact_check(ms, tabs, args, label, **kw):
    """A sweep kernel against its twin run on the card from the same state:
    every output bitwise equal.  Returns (the kernel's outputs, the largest
    theta / logp difference, the twin's milliseconds)."""
    import torch
    from automix_tpu_torch.kernels import fused
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    want, ms_p = timed(lambda: fused.sweep_chunk_ref(ms, *args, tabs, **kw))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
    jumps = float((got[0] != args[0]).float().mean())
    log(f"{label} vs its twin ({args[0].numel()} chains x {kw['n_sweeps']} "
        f"sweeps from sweep {kw['sweep0']}, L={tabs.loglam.shape[1]}): "
        f"every output equal {equal}, theta/logp max|err| {err:.3e}, "
        f"chains that jumped {jumps:.4f}")
    if not equal:
        fail(f"{label} differs from its twin")
    return got, err, ms_p


def check_cache_sweep(ms, prop, chains, perm=False, label="K1e"):
    """K1e against sweep_chunk_ref on the card: every chain of a DDI run's
    state, DDI_CHECK_SWEEPS sweeps placed so that the last sweep is the
    15th after a refresh (t % 16 == 14); every output bitwise equal.  Logs
    the carried logp's largest distance from a fresh evaluation there, the
    longest drift window.  Timed on the same sweeps (the twin on its
    check)."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    args = chunk_args(chains)
    last = chains.sweep + DDI_CHECK_SWEEPS - 1
    sweep0 = chains.sweep + (14 - last) % 16
    kw = dict(seed=11, sweep0=sweep0, n_sweeps=DDI_CHECK_SWEEPS, adapt=True,
              perm=perm)
    got, err, ms_p = exact_check(ms, tabs, args, label, **kw)
    fresh = ms.logpost_cols(got[0].long(), list(got[1]))
    drift = float((got[2] - fresh).abs().max())
    log(f"{label}: carried logp 15 sweeps after a refresh vs a fresh "
        f"evaluation: max|diff| {drift:.3e} (|logp| up to "
        f"{float(fresh.abs().max()):.1f})")
    ms_k = cuda_ms(lambda: fused.sweep_chunk(ms, *args, tabs, **kw), 3)
    L, K, D = tabs.loglam.shape[1], ms.nmodels, ms.dmax
    S = chains.n_chains
    cnt = got[9].sum(1).double().cpu().numpy()
    b_ms, b_by = bound(
        S * TIME_SWEEPS * cache_sweep_ops(ms, L, k_probs(ms, chains.k), cnt,
                                          perm),
        S * state_bytes(K, D) + tables_bytes(K, D, L))
    log(f"{label} sweep chunk ({S} chains x {TIME_SWEEPS} sweeps): kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by)


def drift_readings(ms, tabs, state, s0, sweep_fn, seed=9):
    """The carried logp against a fresh evaluation through one refresh
    window: from ``state`` (the sweep kernels' k, theta, logp, pk, pkllim,
    nreinit, with logp fresh) at sweep s0 = 0 mod 16, one chunk of n
    sweeps of ``sweep_fn`` for n = 1 ... 16, each from the same start, so
    that each is the first n sweeps of one chunk.  Returns the 16-sweep
    outputs and, per n, (the largest distance among the chains in the
    16-dim model that entered it by a jump within the first n sweeps,
    their number, the largest among the other chains)."""
    import torch
    k = state[0]
    entered = torch.zeros_like(k, dtype=torch.bool)
    rows = []
    for n in range(1, 17):
        out = sweep_fn(ms, *state, tabs, seed=seed, sweep0=s0, n_sweeps=n,
                       adapt=True)
        entered = entered | ((k == 1) & (out[0] == 0))
        k = out[0]
        jumped = entered & (k == 0)
        d = (out[2] - ms.logpost_cols(k.long(), list(out[1]))).abs()
        rows.append((float(d[jumped].max()) if bool(jumped.any()) else 0.0,
                     int(jumped.sum()), float(d[~jumped].max())))
    return out, rows


def drift_window(ms, prop, chains):
    """DDI_WINDOWS refresh windows of K1e in a row from a run's state
    (logp made fresh, the first starting at a sweep = 0 mod 16): logs each
    window's drift readings and fails unless the distance is exactly 0
    after each refresh and within DDI_DRIFT_JUMPED and DDI_DRIFT_OTHER
    before it.  Returns the largest readings of the two classes."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    state = chunk_args(chains)
    state = (state[0], state[1],
             ms.logpost_cols(state[0].long(), list(state[1])), *state[3:])
    s0 = chains.sweep + (-chains.sweep) % 16
    worst = [0.0, 0.0]
    for w in range(DDI_WINDOWS):
        out, rows = drift_readings(ms, tabs, state, s0 + 16 * w,
                                   fused.sweep_chunk)
        log(f"K1e drift window {w} from sweep {s0 + 16 * w} "
            f"({chains.n_chains} chains), max|diff| after 1..16 sweeps, "
            "chains that entered the 16-dim model (their number) / the "
            "others: " + " ".join(f"{a:.3e} ({c}) / {b:.3e}"
                                   for a, c, b in rows))
        if rows[-1][0] != 0.0 or rows[-1][2] != 0.0:
            fail(f"K1e's refresh left the carried logp away from a fresh "
                 f"evaluation in window {w}")
        worst = [max(worst[0], max(r[0] for r in rows)),
                 max(worst[1], max(r[2] for r in rows))]
        state = out[:6]
    log(f"K1e drift over {DDI_WINDOWS} windows: at most {worst[0]:.3e} "
        f"(bound {DDI_DRIFT_JUMPED}) in chains that entered the 16-dim "
        f"model, {worst[1]:.3e} (bound {DDI_DRIFT_OTHER}) in the others")
    if not (worst[0] <= DDI_DRIFT_JUMPED and worst[1] <= DDI_DRIFT_OTHER):
        fail("K1e's carried logp drifted beyond its bounds")
    return worst


def widen(prop, L):
    """A proposal of L components from a fitted one, its components
    repeated in turn and the weights renormalized."""
    from automix_tpu_torch.state import Proposal
    idx = [i % prop.lmax for i in range(L)]
    lam = prop.lam[:, idx]
    return Proposal(lam=lam / lam.sum(1, keepdim=True), mu=prop.mu[:, idx],
                    B=prop.B[:, idx], logdetB=prop.logdetB[:, idx],
                    nmix=prop.nmix, sig=prop.sig)


def check_cache_lmax(ms, prop, chains):
    """K1e at L = kLMax = 32 (the fitted proposal widened) against its twin
    on 4096 chains of a DDI state x 20 sweeps."""
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.state import Chains
    sub = Chains(**{f: getattr(chains, f)[:4096].contiguous() for f in
                    ("k", "theta", "logp", "pk", "pkllim", "nreinit")},
                 sweep=chains.sweep)
    tabs = fused.prep_tables(widen(prop, fused._MAX_L), ms.dims)
    exact_check(ms, tabs, chunk_args(sub), f"K1e at L={fused._MAX_L}",
                seed=7, sweep0=sub.sweep, n_sweeps=20, adapt=True)


def check_cache_pooled_runner(ms, prop, chains, dev):
    """K1d with the DDI cache (each chain's cache built fresh at each sweep,
    as the one-sweep route's K1e launches build it) on the card's stream:
    against the one-sweep route on the run's state repeated to one more
    block than K1c holds (``scan_against_route``: each thread of K1d's
    grid then carries two chains or one), and on the state itself against
    the same route over the twin, every chain field and visit count and
    counter bit for bit (the theta sums within 1e-5).  K1d and the route
    timed per sweep on the state, in turns.  Logs K1e's registers (ptxas)
    and resident warps per SM."""
    import torch
    from automix_tpu_torch.kernels import _build, fused
    tabs = fused.prep_tables(prop, ms.dims)
    rng = fused.resolve_rng("auto", dev)
    above = fused.pooled_capacity(ms, prop.lmax, dev) + 128
    scan_against_route(ms, tabs, grown(chains, above), K1D_CHECK_SWEEPS,
                       rng, "K1d with the cache")
    a, ca = fused.pooled_scan(ms, chains, tabs, K1D_CHECK_SWEEPS, seed=17,
                              rng=rng)
    b, cb = fused.pooled_sweeps(ms, chains, tabs, K1D_CHECK_SWEEPS, seed=17,
                                sweep_fn=fused.sweep_chunk_ref, rng=rng)
    torch.cuda.synchronize()
    equal = all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "k", "theta", "logp", "pk", "pkllim", "nreinit")) and all(
        torch.equal(ca[n], cb[n]) for n in ca if not n.startswith("theta"))
    sums = max(float(((ca[n] - cb[n]).abs() / (1e-2 + cb[n].abs())).max())
               for n in ("theta_sum", "theta_sqsum"))
    jumps = float((a.k != chains.k).float().mean())
    regs = [r for n, r, *_ in ptxas_summary(_build.build(),
                                            *_build.CACHED_SHAPE)
            if n == "fused_sweep_kernel<0>"]
    warps = fused.occupancy(ms, prop.lmax, dev)
    route_ms, scan_ms = route_turns(ms, tabs, chains, rng)
    log(f"K1d with the cache, {rng}, vs its twin runner ({chains.n_chains} "
        f"chains x {K1D_CHECK_SWEEPS} sweeps): chain fields, visit counts "
        f"and counters equal {equal}, theta sums max rel diff {sums:.3e}, "
        f"chains that jumped {jumps:.4f}; per sweep in turns: K1d "
        f"{scan_ms[0]:.4f} / {scan_ms[1]:.4f} ms, the one-sweep route "
        f"{route_ms[0]:.4f} / {route_ms[1]:.4f} ms; K1e: one thread per "
        f"chain, {warps} resident warps per SM, registers {regs} (ptxas, "
        "per variant)")
    if not equal or sums > 1e-5:
        fail("K1d with the cache differs from its twin")


def grown(chains, S):
    """The first S chains of ``chains``, repeated where it has fewer."""
    import torch
    from automix_tpu_torch.state import Chains
    reps = -(-S // chains.n_chains)
    return Chains(**{f: getattr(chains, f) if f == "sweep" else torch.cat(
        [getattr(chains, f)] * reps)[:S].contiguous()
        for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit",
                  "sweep")})


def check_cache_pooled(ms, prop, chains):
    """K1c with the DDI cache against the pooled twin on the card, every
    chain of a pooled run's state x DDI_CHECK_SWEEPS sweeps: every output
    bitwise equal.  Timed on the same sweeps (the twin on its check),
    beside K1e with per-chain pk."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    args = chunk_args(chains)
    kw = dict(seed=13, sweep0=chains.sweep, n_sweeps=DDI_CHECK_SWEEPS,
              adapt=True, pooled=True)
    got, err, ms_p = exact_check(ms, tabs, args, "K1c with the cache",
                                 **kw)
    ms_k = cuda_ms(lambda: fused.sweep_chunk(ms, *args, tabs, **kw), 3)
    ms_e = cuda_ms(lambda: fused.sweep_chunk(
        ms, *args, tabs, **dict(kw, pooled=False)), 3)
    L, K, D = tabs.loglam.shape[1], ms.nmodels, ms.dmax
    S = chains.n_chains
    cnt = got[9].sum(1).double().cpu().numpy()
    b_ms, b_by = bound(
        S * TIME_SWEEPS * (cache_sweep_ops(ms, L, k_probs(ms, chains.k), cnt)
                           + 2 * K),
        S * state_bytes(K, D) + tables_bytes(K, D, L))
    log(f"K1c with the cache ({S} chains x {TIME_SWEEPS} sweeps): kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"K1e with per-chain pk {ms_e:.4f} ms")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by)


def ddi_paths(dev):
    """The DDI paths: AMSampler at the bench configuration, the kernel
    checks on its state, the CLI in mode 1 and pooled pk.  Returns the
    kernels' entries of the JSON record."""
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.io import reports
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.models import ddi
    oracle = json.load(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "data",
        "heavy_oracle.json")))["ddi"]["mean"]
    dd = ddi.ddi_set()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- AMSampler at the bench configuration ---------------------------
        stem = os.path.join(tmp, "ddi")
        t0 = time.perf_counter()
        reset_counts()
        am = AMSampler(dd, EngineConfig(
            n_chains=DDI_CHAINS, n_chains_stage1=DDI_C_STAGE1,
            stage1_sweeps=DDI_STAGE1_SWEEPS, sweep_chunk=DDI_CHUNK, seed=0,
            trace_chain0=False, n_trace_chains=1), device="cuda")
        am.estimate_conditional_probs()
        reports.report_cond_prob_estimation(stem, am)
        am.burn_samples(DDI_BURN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = am.rjmcmc_samples(DDI_TIMED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = read_counts()
        cp = am.cpstats
        prop = am.proposal
        log(f"ddi: stage 1 {cp.timesecs_stage1:.3f} s on K2 ({DDI_C_STAGE1} "
            f"chains per model, {DDI_STAGE1_SWEEPS * 11 // 10} sweeps), "
            f"stage 2 {cp.timesecs_stage2:.3f} s (EM iterations "
            f"{cp.em_iters.tolist()}, L={prop.lmax}), burn-in "
            f"{stats.timesecs_burn:.3f} s")
        log(f"ddi: {DDI_TIMED} timed sweeps x {DDI_CHAINS} chains in "
            f"{secs:.3f} s = {DDI_CHAINS * DDI_TIMED / secs:.6e} "
            f"chain-sweeps/s; launches {counts}")
        check_probs("ddi AMSampler", stats.model_probs, oracle,
                    what="C oracle mean")
        if counts["K1f"] == 0 or counts["K2"] == 0 \
                or counts["K1"] + counts["K3"]:
            fail("the DDI path did not launch K1e on the hw stream (K1f) "
                 "alone and K2")
        fresh = dd.logpost_cols(am.chains.k.long(), list(am.chains.theta.T))
        d = (am.chains.logp - fresh).abs()
        drift = float(d.max())
        by_model = [float(d[am.chains.k == m].max()) if bool(
            (am.chains.k == m).any()) else 0.0 for m in range(2)]
        last = am.chains.sweep - 1
        log(f"ddi: carried logp vs a fresh evaluation after sweep {last} "
            f"({(last + 1) % 16} sweeps after a refresh): max|diff| "
            f"{drift:.3e} (model 1 / 2: {by_model[0]:.3e} / "
            f"{by_model[1]:.3e}; bounds {DDI_DRIFT_JUMPED} / "
            f"{DDI_DRIFT_OTHER}; |logp| up to "
            f"{float(fresh.abs().max()):.1f})")
        # the 16-dim model's chains may carry a jump's blend, the others
        # only their incremental error (drift_window)
        if not (by_model[0] <= DDI_DRIFT_JUMPED
                and by_model[1] <= DDI_DRIFT_OTHER):
            fail(f"ddi: the carried logp drifted by {drift:.3e}")
        drift_window(dd, prop, am.chains)
        out["main"] = counts
        log(f"phase ddi AMSampler: {time.perf_counter() - t0:.2f} s")

        # ---- kernel checks at (2, 16) --------------------------------------
        t0 = time.perf_counter()
        out["K1e"] = check_cache_sweep(dd, prop, am.chains)
        out["K1e perm"] = check_cache_sweep(dd, prop, am.chains, perm=True,
                                            label="K1e perm")
        check_cache_lmax(dd, prop, am.chains)
        check_cache_pooled_runner(dd, prop, am.chains, dev)
        out["K1e hw"] = check_hw(dd, prop, am.chains, "K1f K1e ddi",
                                 exact=True)
        out["drive"] = hash_drive(dd, prop, am.chains, "ddi K1e")
        out["drive perm"] = hash_drive(dd, prop, am.chains, "ddi K1e perm",
                                       perm=True)
        out["K2"] = check_segment(dd, DDI_C_STAGE1, dev, label="K2 ddi")
        out["K3"] = check_sweep_kernel(dd, DDI_C_STAGE1, dev,
                                       label="K3 ddi")
        out["K3 route"] = stage1_routes(dd, DDI_C_STAGE1, DDI_STAGE1_SWEEPS,
                                        dev, "ddi")
        out["K1e split"] = check_split(dd, prop, am.chains, "K1e ddi",
                                       cache=True)
        out["K3 split"] = check_split_k3(dd, DDI_C_STAGE1, dev, "K3 ddi")
        del am
        log(f"phase ddi kernel checks: {time.perf_counter() - t0:.2f} s")

        # ---- the CLI in mode 1 at its defaults ------------------------------
        cli_out, cli_counts, secs = run_cli(
            ["ddi", "-m", "1", "--chains", str(DDI_CHAINS), "-N",
             str(DDI_TIMED), "-s", "1", "-f", stem])
        log(f"launches on the ddi CLI path: {cli_counts}")
        check_probs("ddi CLI mode 1", probs_of(cli_out), oracle,
                    what="C oracle mean")
        if cli_counts["K1f"] == 0 or cli_counts["K1"]:
            fail("the ddi CLI run did not launch K1e on the hw stream")
        out["cli"] = cli_counts
        log(f"phase ddi CLI mode 1: {secs:.2f} s")

    # ---- pooled pk on the route pooled_capacity picks ----------------------
    t0 = time.perf_counter()
    cap = fused.pooled_capacity(dd, prop.lmax, dev)
    route = "K1c" if DDI_CHAINS <= cap else "K1d"
    am = AMSampler(dd, EngineConfig(n_chains=DDI_CHAINS, pk_mode="pooled",
                                    seed=11, sweep_chunk=DDI_CHUNK,
                                    trace_chain0=False), device="cuda")
    am.set_proposal(prop)
    am.burn_samples(DDI_BURN)
    reset_counts()
    t1 = time.perf_counter()
    stats = am.rjmcmc_samples(DDI_TIMED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = read_counts()
    log(f"ddi pooled, {DDI_CHAINS} chains (K1c holds {cap} at L="
        f"{prop.lmax}: route {route}): {DDI_TIMED} sweeps in {secs:.3f} s = "
        f"{DDI_CHAINS * DDI_TIMED / secs:.6e} chain-sweeps/s; launches "
        f"{counts}")
    check_probs("ddi pooled", stats.model_probs, oracle,
                what="C oracle mean")
    if {k: v for k, v in counts.items() if v} != {
            "K1fc" if route == "K1c" else "K1fd": DDI_TIMED // DDI_CHUNK}:
        fail(f"the ddi pooled run did not take {route} once a chunk on the "
             "hw stream alone")
    if not bool((am.chains.pk == am.chains.pk[0]).all()):
        fail("the ddi pooled pk rows differ")
    out["pooled"] = counts
    if route == "K1c":
        out["K1c"] = check_cache_pooled(dd, prop, am.chains)
        out["drive pooled"] = hash_drive(dd, prop, am.chains, "ddi pooled",
                                         pk_mode="pooled")
    del am
    log(f"phase ddi pooled: {time.perf_counter() - t0:.2f} s")
    return out


def check_stage1_route(ms, C, dev, label="K3 + log"):
    """The one-sweep stage-1 route with the log rule
    (``run_fused_stage1_sweeps``: a K3 launch per sweep, the log update in
    the launch) against the same runner over the one-sweep twin, both on
    the card: K models x C chains, CPT_ROUTE_SWEEPS stage-1 sweeps (+10%
    burn-in), seed 5; sig, samples, telemetry and logp must be bitwise
    equal.  Timed per sweep.  Returns the kernel's entry and the K3
    launches of the checked run."""
    import torch
    from automix_tpu_torch import EngineConfig
    from automix_tpu_torch.kernels import fused_stage1
    from automix_tpu_torch.ops import randoms
    cfg = EngineConfig(seed=5, stage1_adapt="log")
    init = ms.init_points(randoms.key(0))

    def run(sweep_fn=None):
        return fused_stage1.run_fused_stage1_sweeps(
            ms, cfg, CPT_ROUTE_SWEEPS, C, init, dev, sweep_fn=sweep_fn)

    reset_counts()
    got = run()
    torch.cuda.synchronize()
    launches = read_counts()["K3"]
    want = run(fused_stage1.sweep_ref)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = float((got[1] - want[1]).abs().max())
    n = CPT_ROUTE_SWEEPS + CPT_ROUTE_SWEEPS // 10
    log(f"{label} route vs its twin ({ms.nmodels} x {C} chains x {n} "
        f"sweeps): sig, samples, telemetry and logp equal {equal}, samples "
        f"max|err| {err:.3e}, rate sig {got[0][:, 0].tolist()}")
    if not equal or launches != n:
        fail(f"the {label} route differs from its twin")
    ms_k = cuda_ms(run, 2) / n
    ms_p = cuda_ms(lambda: run(fused_stage1.sweep_ref), 1, warm=False) / n
    N, K, D = ms.nmodels * C, ms.nmodels, ms.dmax
    b_ms, b_by = bound(N * stage1_ops(ms, uniform(ms)) + 8 * K * D,
                       N * 4 * 2 * (D + 1))
    log(f"{label} route ({N} chains, per sweep): {ms_k:.4f} ms, plain "
        f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by), launches


def check_exact_sweep(ms, prop, chains, label, perm=False, pooled=False):
    """K1 (``perm``: K1b; ``pooled``: K1c) against its twin run on the
    card from a run's state: every chain x TIME_SWEEPS sweeps, every output
    bitwise equal.  Timed on the same sweeps (the twin on its check)."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    args = chunk_args(chains)
    kw = dict(seed=11, sweep0=chains.sweep, n_sweeps=TIME_SWEEPS, adapt=True,
              perm=perm, pooled=pooled)
    _, err, ms_p = exact_check(ms, tabs, args, label, **kw)
    ms_k = cuda_ms(lambda: fused.sweep_chunk(ms, *args, tabs, **kw), 3)
    L, K, D = tabs.loglam.shape[1], ms.nmodels, ms.dmax
    S = chains.n_chains
    b = bounds(
        lambda full: S * TIME_SWEEPS * (
            sweep_ops(ms, L, k_probs(ms, chains.k), perm, full=full)
            + (2 * K if pooled else 0)),
        S * state_bytes(K, D) + tables_bytes(K, D, L))
    log(f"{label} sweep chunk ({S} chains x {TIME_SWEEPS} sweeps): kernel "
        f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, {bound_text(b)}")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, **b)


def check_cpt_probs(name, probs, ref, assertions=True):
    """p(M) against JAX runs' mean (``ref``: one set of
    cpt_jax_reference.json, or cpt_cli_witness.json) within max(CPT_TOL,
    CPT_SPREADS x their spread) on every model, and with ``assertions``
    JAX's own (p0 < 0.15, p1 + p2 + p3 > 0.5), which its change-point test
    makes of its own configuration."""
    import numpy as np
    probs = np.asarray(probs, np.float64)
    mean, spread = np.asarray(ref["mean"]), np.asarray(ref["spread"])
    tol = np.maximum(CPT_TOL, CPT_SPREADS * spread)
    err = np.abs(probs - mean)
    log(f"{name}: p(M) = {np.round(probs, 4).tolist()} vs the JAX mean "
        f"{np.round(mean, 4).tolist()} ({len(ref['runs'])} runs): max err "
        f"{float(err.max()):.4f} (bounds {np.round(tol, 4).tolist()}); p0 "
        f"{probs[0]:.4f}, p1 + p2 + p3 {probs[1:4].sum():.4f}")
    if len(probs) != len(mean) or (err > tol).any():
        fail(f"{name}: p(M) misses the JAX posterior")
    if assertions and not (probs[0] < 0.15 and probs[1:4].sum() > 0.5):
        fail(f"{name}: p(M) fails JAX's own assertions")


def cpt_config(name):
    """EngineConfig keywords of the change-point ``AMSampler`` runs: JAX's
    configuration at CPT_CHAINS chains (tools/cpt_cli_witness.py makes
    cpt's _mix.data with the same)."""
    return dict(n_chains=CPT_CHAINS, n_chains_stage1=CPT_C_STAGE1,
                max_mix_comps=CPT_MAX_MIX[name],
                stage1_sweeps=CPT_STAGE1_SWEEPS, sweep_chunk=CPT_CHUNK,
                seed=CPT_SEEDS[name], pk_mode="pooled", stage1_adapt="log",
                trace_chain0=False)


def check_scan_cpt(ms, prop, chains):
    """K1d at (6, 13), forced on cpt's state (16384 chains, one a thread),
    K1D_CHECK_SWEEPS sweeps on the hash: bitwise the one-sweep route
    (``scan_against_route``); both timed per sweep in turns.  Returns its
    entry of the JSON record, its launches the check's own."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    reset_counts()
    scan_against_route(ms, tabs, chains, K1D_CHECK_SWEEPS, "hash", "K1d cpt")
    launches = read_counts()["K1d"]
    a, _ = fused.pooled_scan(ms, chains, tabs, 2, seed=17)
    (b, _), ms_p = timed(lambda: fused.pooled_sweeps(
        ms, chains, tabs, 2, seed=17, sweep_fn=fused.sweep_chunk_ref))
    same = a.k == b.k
    err = float((a.theta - b.theta).abs()[same].max())
    route_ms, scan_ms = route_turns(ms, tabs, chains, "hash")
    bd = scan_bound(ms, tabs.loglam.shape[1], chains, "hash")
    log(f"K1d cpt ({chains.n_chains} chains, per sweep, in turns): K1d "
        f"{scan_ms[0]:.4f} / {scan_ms[1]:.4f} ms, the one-sweep route "
        f"{route_ms[0]:.4f} / {route_ms[1]:.4f} ms, plain {ms_p / 2:.4f} "
        f"ms (k equal on {float(same.float().mean()):.6f}, theta max|err| "
        f"{err:.3e} after 2 sweeps), {bound_text(bd)}")
    if float(same.float().mean()) < 0.99 or err > 1e-3:
        fail("K1d cpt differs from its twin runner")
    return launches, dict(max_abs_err=err, ms=min(scan_ms), plain_ms=ms_p / 2,
                          route_ms=min(route_ms), **bd)


def changepoint_paths(dev):
    """The change-point paths: K2-log and the K3 + log route against their
    twins; stage 1 of cpt at 512 chains per model (K2-log); ``AMSampler``
    on cpt and on cptrs at JAX's configuration (stage 1 on K2-log) with
    16384 chains and pooled pk (K1c), K1 / K1b / K1c on cpt's proposal and
    state; the CLI in mode 1 on each set.  Returns the kernels' entries of
    the JSON record."""
    import numpy as np
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.io import reports
    from automix_tpu_torch.kernels import fused, rwm
    from automix_tpu_torch.models import changepoint
    from automix_tpu_torch.ops import randoms
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    ref = json.load(open(os.path.join(data, "cpt_jax_reference.json")))
    witness = json.load(open(os.path.join(data, "cpt_cli_witness.json")))
    cpt = changepoint.cpt_set()
    out = {}
    # ---- the stage-1 kernels from the start points ------------------------
    t0 = time.perf_counter()
    out["K2-log"] = check_segment(cpt, CPT_C_K2, dev, label="K2-log cpt",
                                  rule="log")
    out["K3-log"], out["K3-log launches"] = check_stage1_route(
        cpt, CPT_C_STAGE1, dev)
    log(f"phase cpt stage-1 kernel checks: {time.perf_counter() - t0:.2f} s")

    # ---- stage 1 at 512 chains per model: K2-log ---------------------------
    t0 = time.perf_counter()
    reset_counts()
    sig, _, tele = rwm.run_stage1(
        cpt, EngineConfig(n_chains_stage1=CPT_C_K2,
                          stage1_sweeps=CPT_STAGE1_SWEEPS, seed=5,
                          stage1_adapt="log"),
        randoms.key(5), CPT_STAGE1_SWEEPS, dev)
    torch.cuda.synchronize()
    out["stage1"] = read_counts()
    rate_sig = [float(sig[m, :m + 2].max()) for m in range(cpt.nmodels)]
    log(f"cpt stage 1 at {CPT_C_K2} chains per model ({tele['nsweeps']} "
        f"sweeps): {time.perf_counter() - t0:.3f} s, launches "
        f"{out['stage1']}, largest rate sig per model "
        f"{np.round(rate_sig, 6).tolist()}, last pooled acceptance "
        f"{np.round(tele['accept_trace'][-1, :, 0].numpy(), 3).tolist()}")
    if out["stage1"]["K2"] == 0 or max(rate_sig) > 0.02:
        fail("cpt stage 1 did not run K2-log to the rates' scale")

    probs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("cpt", "cptrs"):
            # ---- AMSampler at JAX's change-point configuration ------------
            ms = getattr(changepoint, f"{name}_set")()
            t0 = time.perf_counter()
            reset_counts()
            am = AMSampler(ms, EngineConfig(**cpt_config(name)),
                           device="cuda")
            am.estimate_conditional_probs()
            reports.report_cond_prob_estimation(os.path.join(tmp, name), am)
            prop = am.proposal
            cap = fused.pooled_capacity(ms, prop.lmax, dev)
            am.burn_samples(CPT_BURN)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            stats = am.rjmcmc_samples(CPT_TIMED)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            counts = read_counts()
            cp = am.cpstats
            # the fit's first-rate scale against stage 1's (both ~ the
            # posterior's): the EM's Cholesky jitter, 1e-6 of the mean
            # covariance diagonal, is not scale-free
            sd0 = torch.where(prop.lam > 0, prop.B[:, :, 0, 0], 0.0)
            inflate = (sd0.amax(1) / prop.sig[:, 0]).tolist()
            log(f"{name}: stage 1 {cp.timesecs_stage1:.3f} s on K2-log "
                f"({CPT_C_STAGE1} chains per model, "
                f"{CPT_STAGE1_SWEEPS * 11 // 10} sweeps), stage 2 "
                f"{cp.timesecs_stage2:.3f} s (EM iterations "
                f"{cp.em_iters.tolist()}, L per model "
                f"{prop.nmix.tolist()}), burn-in {stats.timesecs_burn:.3f} "
                f"s; the fit's largest first-rate sd over stage 1's sig per "
                f"model {np.round(inflate, 2).tolist()}")
            log(f"{name}: {CPT_TIMED} timed sweeps x {CPT_CHAINS} chains in "
                f"{secs:.3f} s = {CPT_CHAINS * CPT_TIMED / secs:.6e} "
                f"chain-sweeps/s (K1c holds {cap} at L={prop.lmax}); "
                f"launches {counts}")
            check_cpt_probs(f"{name} AMSampler", stats.model_probs, ref[name])
            if not (counts["K1f"] > 0 and counts["K1fc"] > 0
                    and counts["K2"] > 0) \
                    or counts["K1"] + counts["K1c"] + counts["K3"]:
                fail(f"the {name} path did not launch K1 and K1c on the hw "
                     "stream (K1f) alone, and K2-log")
            if not bool((am.chains.pk == am.chains.pk[0]).all()):
                fail(f"the {name} pooled pk rows differ")
            out[name] = counts
            probs[name] = np.asarray(stats.model_probs)
            log(f"phase {name} AMSampler: {time.perf_counter() - t0:.2f} s")

            # ---- K1, K1b and K1c at (6, 13) on cpt's proposal and state ----
            if name == "cpt":
                t0 = time.perf_counter()
                out["K1"] = check_exact_sweep(ms, prop, am.chains, "K1 cpt")
                out["K1b"] = check_exact_sweep(ms, prop, am.chains,
                                               "K1 perm cpt", perm=True)
                out["K1c"] = check_exact_sweep(ms, prop, am.chains,
                                               "K1c cpt", pooled=True)
                out["K1d"] = check_scan_cpt(ms, prop, am.chains)
                out["K1f"] = check_hw(ms, prop, am.chains, "K1f cpt")
                out["drive"] = hash_drive(ms, prop, am.chains, "cpt K1")
                out["drive perm"] = hash_drive(ms, prop, am.chains,
                                               "cpt K1 perm", perm=True)
                out["drive pooled"] = hash_drive(ms, prop, am.chains,
                                                 "cpt K1c", pk_mode="pooled")
                log(f"phase cpt kernel checks: "
                    f"{time.perf_counter() - t0:.2f} s")

                # ---- replicas of cpt's stage 3 for the pair check ------
                t0 = time.perf_counter()
                runs = [probs[name]]
                for r in range(1, CPT_REPLICAS):
                    seed = CPT_SEEDS[name] + 100 * r
                    rep = AMSampler(ms, EngineConfig(**dict(
                        cpt_config(name), seed=seed)), device="cuda")
                    rep.set_proposal(prop)
                    rep.burn_samples(CPT_BURN)
                    runs.append(np.asarray(
                        rep.rjmcmc_samples(CPT_TIMED).model_probs))
                    check_cpt_probs(f"cpt stage-3 replica at seed {seed}",
                                    runs[-1], ref[name])
                probs["cpt runs"] = np.stack(runs)
                log(f"phase cpt replicas: {time.perf_counter() - t0:.2f} s")
            del am
        singles = np.abs(probs["cpt runs"] - probs["cptrs"]).max(1)
        gap = np.abs(probs["cpt runs"].mean(0) - probs["cptrs"])
        jax_gap = np.abs(np.asarray(ref["cpt"]["mean"])
                         - np.asarray(ref["cptrs"]["mean"]))
        log(f"|cpt - cptrs| (time rescaled by 1459), cpt the mean of "
            f"{CPT_REPLICAS} stage-3 runs: p(M) {np.round(gap, 4).tolist()}, "
            f"max {gap.max():.4f} (atol {CPT_PAIR_ATOL}); each run's max "
            f"{np.round(singles, 4).tolist()}; the JAX means' max "
            f"{jax_gap.max():.4f}")
        if gap.max() > CPT_PAIR_ATOL:
            fail("cpt and cptrs differ by more than the JAX test's atol")

        # ---- the CLI in mode 1 at its defaults from each _mix.data --------
        # cpt against the JAX CLI's runs from the same proposal
        with open(os.path.join(tmp, "cpt_mix.data"), "rb") as f:
            same = hashlib.sha256(f.read()).hexdigest() \
                == witness["mix_sha256"]
        log(f"cpt _mix.data equal to the JAX CLI witness's input: {same}")
        for name in ("cpt", "cptrs"):
            cli_out, cli_counts, secs = run_cli(
                [name, "-m", "1", "--chains", str(N_CHAINS), "-N",
                 str(CPT_CLI_SWEEPS), "-s", "1", "-f",
                 os.path.join(tmp, name)])
            log(f"launches on the {name} CLI path: {cli_counts}")
            if name == "cpt":
                check_cpt_probs("cpt CLI mode 1 (against the JAX CLI)",
                                probs_of(cli_out), witness, assertions=False)
            else:
                check_cpt_probs("cptrs CLI mode 1", probs_of(cli_out),
                                ref[name])
            if cli_counts["K1f"] == 0 or cli_counts["K1"]:
                fail(f"the {name} CLI run did not launch K1 (perm) on the hw "
                     "stream")
            out[f"cli {name}"] = cli_counts
            log(f"phase {name} CLI mode 1: {secs:.2f} s")
    return out


def k4_ops(mu, mz):
    """Operations of one row of K4's function: ceil(W / 4) Philox-4x32-10
    calls (10 rounds of 2 high and 2 low products and 4 xors, 9 key
    bumps of 2 adds: 98), 5 per uniform, ~77 per Box-Muller pair."""
    n_pairs = (mz + 1) // 2
    words = mu + 2 * n_pairs
    pair = OPS["log1p"] + OPS["sqrt"] + 2 * OPS["trig"] + 5
    return -(-words // 4) * 98 + 5 * words + n_pairs * pair


def check_k4(dev):
    """K4 against draw_ref on the card at each of K4_SHAPES: uniforms
    bitwise, normals within K4_ULPS ulps (kernel and twin call the same
    libdevice functions), and the block-offset property.  Times the
    kernel, the twin and torch.rand + torch.randn into the same shapes
    (the same distributions from another generator, not the same words),
    at the first shape: kernel and library called one by one from Python,
    as the general engine calls them (``ms``, ``library_ms``), and replayed
    from a CUDA graph, their device time without the host's per-call cost
    (``graph_ms``, ``library_graph_ms``)."""
    import torch
    from automix_tpu_torch.kernels import sweep_rng
    out = None
    for S, MU, MZ in K4_SHAPES:
        u, z = sweep_rng.draw(7, 12, 0, S, MU, MZ, dev)
        (ur, zr), ms_p = timed(
            lambda: sweep_rng.draw_ref(7, 12, 0, S, MU, MZ, dev))
        ulps = (z.view(torch.int32).long()
                - zr.view(torch.int32).long()).abs()
        u_equal = torch.equal(u, ur)
        z_err = float((z - zr).abs().max())
        cb = sweep_rng.choose_block(S)
        offset = True
        if (S // 2) % cb == 0:
            uh, zh = sweep_rng.draw(7, 12, (S // 2) // cb, S // 2, MU, MZ,
                                    dev)
            offset = torch.equal(uh, u[S // 2:]) and torch.equal(
                zh, z[S // 2:])
        inside = bool((u > 0).all() and (u < 1).all()
                      and torch.isfinite(z).all())
        log(f"K4 vs draw_ref ({S} x {MU} uniforms, {MZ} normals): uniforms "
            f"bitwise {u_equal}, normals max ulps {int(ulps.max())} (max "
            f"|err| {z_err:.3e}), block offset {offset}, inside (0, 1) and "
            f"finite {inside}")
        if not (u_equal and int(ulps.max()) <= K4_ULPS and offset
                and inside):
            fail(f"K4 disagrees with its twin at {S} x ({MU}, {MZ})")
        if out is None:
            def draw():
                return sweep_rng.draw(7, 12, 0, S, MU, MZ, dev)

            def library():
                return (torch.rand(S, MU, device=dev),
                        torch.randn(S, MZ, device=dev))

            eager_k, eager_l = cuda_ms(draw, 200), cuda_ms(library, 200)
            ms_k, ms_l = graph_ms(draw, 100), graph_ms(library, 100)
            b_ms, b_by = bound(S * k4_ops(MU, MZ), S * (MU + MZ) * 4)
            log(f"K4 ({S} x {MU + MZ}): kernel {eager_k:.4f} ms, plain "
                f"{ms_p:.4f} ms, torch.rand + torch.randn {eager_l:.4f} ms "
                f"(called from Python); CUDA graph replays: kernel "
                f"{ms_k:.4f} ms, library {ms_l:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by})")
            out = dict(max_abs_err=z_err, ms=eager_k, plain_ms=ms_p,
                       bound_ms=b_ms, bound_by=b_by, library_ms=eager_l,
                       graph_ms=ms_k, library_graph_ms=ms_l)
    return out


def per_theta(ms):
    """The set's column densities wrapped as per-theta logp, with no CUDA
    density: a set only the general engine serves."""
    from automix_tpu_torch import Model, ModelSet
    return ModelSet([Model(m.name, m.dim, init=m.init,
                           logp=(lambda th, f=m.logp_cols:
                                 f(list(th.unbind(0)))))
                     for m in ms.models])


def general_paths(tut, tut_prop, k1_rate, dev):
    """The general engine's phase: K4 against its twin, the tutorial on
    K4 and on the fast hash (beside ``k1_rate``, the main path's K1
    chain-sweeps/s), toy2 per-theta end to end, the CLI on the example.
    Returns K4's check and the launch counts of each path."""
    import numpy as np
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.models import toy
    out = {}
    t0 = time.perf_counter()
    out["K4"] = check_k4(dev)
    log(f"phase K4 check: {time.perf_counter() - t0:.2f} s")

    # the tutorial at full width from the main path's proposal
    t0 = time.perf_counter()
    rates = {}
    am = AMSampler(tut, EngineConfig(
        n_chains=N_CHAINS, seed=0, fused="off", rng="pallas",
        sweep_chunk=SWEEP_CHUNK, trace_chain0=False), device="cuda")
    am.set_proposal(tut_prop)
    reset_counts()
    am.burn_samples(GEN_BURN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = am.rjmcmc_samples(GEN_TIMED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = read_counts()
    rates["pallas"] = N_CHAINS * GEN_TIMED / secs
    log(f"tutorial, general engine, K4: {GEN_TIMED} timed sweeps x "
        f"{N_CHAINS} chains in {secs:.3f} s = {rates['pallas']:.6e} "
        f"chain-sweeps/s ({secs / GEN_TIMED * 1e3:.3f} ms per sweep; K1 on "
        f"the main path: {k1_rate:.6e}); launches {counts}")
    check_probs("tutorial general engine (K4)", stats.model_probs, PUBLISHED,
                what="published")
    if counts["K4"] != GEN_BURN + GEN_TIMED or counts["K1"] or counts["K2"]:
        fail("the general engine's tutorial run did not launch K4 once per "
             "sweep, or launched a stage-3/stage-1 kernel")
    if not bool(torch.isfinite(am.chains.theta).all()):
        fail("non-finite chain state on the general engine")
    out["tutorial"] = counts
    fast = AMSampler(tut, EngineConfig(
        n_chains=N_CHAINS, seed=0, fused="off", rng="fast",
        sweep_chunk=SWEEP_CHUNK, trace_chain0=False), device="cuda")
    fast.set_proposal(tut_prop)
    fast.chains = am.chains
    fast.stats = None
    del am
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = fast.rjmcmc_samples(GEN_FAST_TIMED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    rates["fast"] = N_CHAINS * GEN_FAST_TIMED / secs
    log(f"tutorial, general engine, fast hash: {GEN_FAST_TIMED} timed sweeps "
        f"in {secs:.3f} s = {rates['fast']:.6e} chain-sweeps/s "
        f"({secs / GEN_FAST_TIMED * 1e3:.3f} ms per sweep); launches "
        f"{read_counts()}")
    check_probs("tutorial general engine (fast)", stats.model_probs,
                PUBLISHED, what="published")
    if any(read_counts().values()):
        fail("the fast-hash run launched a kernel")
    del fast
    log(f"phase tutorial general engine: {time.perf_counter() - t0:.2f} s")

    # toy2 with per-theta densities, end to end at 16384 chains
    t0 = time.perf_counter()
    am = AMSampler(per_theta(toy.toy2_set()), EngineConfig(
        n_chains=TOY2_GEN_CHAINS, n_chains_stage1=TOY2_C_K3,
        stage1_sweeps=TOY2_GEN_STAGE1, max_mix_comps=10, seed=1,
        trace_chain0=False), device="cuda")
    reset_counts()
    am.estimate_conditional_probs()
    cp = am.cpstats
    am.burn_samples(TOY2_GEN_BURN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = am.rjmcmc_samples(TOY2_GEN_TIMED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = read_counts()
    log(f"toy2 per-theta, general engine: stage 1 {cp.timesecs_stage1:.3f} s "
        f"({TOY2_C_K3} chains per model, {TOY2_GEN_STAGE1 * 11 // 10} "
        f"sweeps), stage 2 {cp.timesecs_stage2:.3f} s (EM iterations "
        f"{cp.em_iters.tolist()}, L={am.proposal.lmax}), burn-in "
        f"{stats.timesecs_burn:.3f} s, {TOY2_GEN_TIMED} timed sweeps x "
        f"{TOY2_GEN_CHAINS} in {secs:.3f} s = "
        f"{TOY2_GEN_CHAINS * TOY2_GEN_TIMED / secs:.6e} chain-sweeps/s; "
        f"launches {counts}")
    ref = json.load(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "data",
        "toy2_general_jax_reference.json")))
    probs = np.asarray(stats.model_probs)
    err_jax = float(np.abs(probs - np.asarray(ref["mean"])).max())
    err_exact = float(np.abs(probs - np.asarray(TOY2_EXACT)).max())
    tol = max(TOY2_GEN_TOL, TOY2_GEN_SPREADS * ref["spread"])
    log(f"toy2 per-theta general engine: p(M) = "
        f"{np.round(probs, 4).tolist()}; vs the JAX XLA engine's mean "
        f"{np.round(ref['mean'], 4).tolist()} (spread {ref['spread']:.4f}): "
        f"max err {err_jax:.4f} (bound {tol:.4f}); vs exact "
        f"{list(TOY2_EXACT)}: max err {err_exact:.4f} (bound "
        f"{TOY2_GEN_EXACT}; within {PARITY_TOL}: {err_exact <= PARITY_TOL})")
    if err_jax > tol or err_exact > TOY2_GEN_EXACT:
        fail("toy2 per-theta on the general engine misses the JAX package's "
             "p(M) or the exact values")
    if any(counts.values()):
        fail("the toy2 per-theta run launched a kernel")
    del am
    log(f"phase toy2 per-theta general engine: "
        f"{time.perf_counter() - t0:.2f} s")

    # the CLI on the example's per-theta set
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from examples import model_selection_torch as example
    text, counts, secs = run_cli(
        ["examples.model_selection_torch:model_set", "-m", "2", "--chains",
         "2048", "-n", "500", "-b", "200", "-N", "1000", "-s", "3",
         "--no-reports"])
    check_probs("model_selection_torch CLI", probs_of(text),
                example.exact_model_probs(), what="closed form")
    if any(counts.values()):
        fail("the CLI on the per-theta example launched a kernel")
    log(f"phase model_selection_torch CLI: {secs:.2f} s")
    out["rates"] = rates
    return out


def student_t_path(smi):
    """toy2 per-theta with Student-t(5) perturbations on the threefry
    stream, its whole pipeline on the general engine: stage 1, AutoRJ,
    stage 3 from fresh chains; p(M) held to the JAX package's runs of
    the same configuration, and no kernel launched.  Every reading is
    logged beside ``smi``, the card's name and power limit."""
    import numpy as np
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import sweep_rng
    from automix_tpu_torch.models import toy
    t0 = time.perf_counter()
    cfg = EngineConfig(n_chains=T_CHAINS, n_chains_stage1=TOY2_C_K3,
                       stage1_sweeps=T_STAGE1, mix_fit="autorj",
                       student_t_dof=5, seed=T_SEED, trace_chain0=False)
    if sweep_rng.resolve_rng(cfg) != "threefry":
        fail("a Student-t run did not resolve to the threefry stream")
    ref = json.load(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "data",
        "toy2_t_jax_reference.json")))
    want = dict(n_chains=T_CHAINS, n_chains_stage1=TOY2_C_K3,
                stage1_sweeps=T_STAGE1, mix_fit="autorj", student_t_dof=5,
                burn=T_BURN, timed=T_TIMED)
    if any(ref["config"][k] != v for k, v in want.items()):
        fail("the Student-t JAX reference was made at another configuration")
    am = AMSampler(per_theta(toy.toy2_set()), cfg, device="cuda")
    reset_counts()
    am.estimate_conditional_probs()
    cp = am.cpstats
    if not bool(torch.isfinite(am.proposal.sig).all()):
        fail("the Student-t stage 1 gave non-finite scales")
    am.burn_samples(T_BURN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = am.rjmcmc_samples(T_TIMED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = read_counts()
    probs = np.asarray(stats.model_probs)
    same = np.asarray(ref["runs"][str(T_SEED)])
    err_seed = float(np.abs(probs - same).max())
    err_jax = float(np.abs(probs - np.asarray(ref["mean"])).max())
    tol = max(T_JAX_TOL, T_JAX_SPREADS * ref["spread"])
    err = float(np.abs(probs - np.asarray(TOY2_EXACT)).max())
    jax_err = float(np.abs(np.asarray(ref["mean"])
                           - np.asarray(TOY2_EXACT)).max())
    n1 = T_STAGE1 * 11 // 10
    log(f"toy2 per-theta, Student-t(5), threefry [{smi}]: stage 1 "
        f"{cp.timesecs_stage1:.3f} s ({TOY2_C_K3} chains per model, {n1} "
        f"sweeps: {cp.timesecs_stage1 / n1 * 1e3:.3f} ms per sweep), "
        f"AutoRJ {cp.timesecs_stage2:.3f} s; burn-in "
        f"{stats.timesecs_burn:.3f} s, {T_TIMED} timed sweeps x {T_CHAINS} "
        f"in {secs:.3f} s ({secs / T_TIMED * 1e3:.3f} ms per sweep); p(M) "
        f"= {np.round(probs, 4).tolist()}; vs the JAX XLA engine's run of "
        f"seed {T_SEED} {np.round(same, 4).tolist()}: max err "
        f"{err_seed:.4f} (bound {T_JAX_TOL}); vs its mean of three "
        f"{np.round(ref['mean'], 4).tolist()} (spread {ref['spread']:.4f}): "
        f"max err {err_jax:.4f} (bound {tol:.4f}); vs exact "
        f"{list(TOY2_EXACT)}: max err {err:.4f} (JAX's mean {jax_err:.4f}); "
        f"launches {counts}")
    if err_seed > T_JAX_TOL or err_jax > tol:
        fail("toy2 per-theta with Student-t misses the JAX package's p(M)")
    if any(counts.values()):
        fail("the Student-t general-engine run launched a kernel")
    if am.chains.key is None or not bool(
            torch.isfinite(am.chains.theta).all()):
        fail("the threefry run lost its keys or its chain state is not "
             "finite")
    log(f"phase toy2 Student-t threefry: {time.perf_counter() - t0:.2f} s")


def hmc_path(tut, tut_prop, smi):
    """HMC within-model moves on the tutorial from the main path's
    proposal: the tuner, then burn-in and timed sweeps, p(M) against the
    published values, no kernel launched."""
    import numpy as np
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    t0 = time.perf_counter()
    am = AMSampler(tut, EngineConfig(
        n_chains=HMC_CHAINS, within_move="hmc", seed=3,
        sweep_chunk=SWEEP_CHUNK, trace_chain0=False), device="cuda")
    am.set_proposal(tut_prop)
    reset_counts()
    t1 = time.perf_counter()
    scales = am.retune_hmc()
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t1
    am.burn_samples(HMC_BURN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats = am.rjmcmc_samples(HMC_TIMED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = read_counts()
    probs = np.asarray(stats.model_probs)
    err = float(np.abs(probs - np.asarray(PUBLISHED)).max())
    acc = stats.naccrwmb / max(stats.ntryrwmb, 1)
    log(f"tutorial HMC [{smi}]: tuned scales "
        f"{[round(float(x), 5) for x in scales]} in {tune_s:.3f} s, "
        f"burn-in {stats.timesecs_burn:.3f} s, {HMC_TIMED} timed sweeps x "
        f"{HMC_CHAINS} in {secs:.3f} s ({secs / HMC_TIMED * 1e3:.3f} ms "
        f"per sweep), HMC acceptance {acc:.4f}, jump acceptance "
        f"{stats.nacctd / max(stats.ntrytd, 1):.4f}; p(M) = "
        f"{np.round(probs, 4).tolist()} vs published {list(PUBLISHED)}: "
        f"max err {err:.4f} (bound {PARITY_TOL}); launches {counts}")
    if err > PARITY_TOL:
        fail("the tutorial with HMC misses the published p(M)")
    if any(counts.values()):
        fail("the HMC run launched a kernel")
    if not 0.2 < acc < 0.999:
        fail(f"HMC acceptance {acc:.4f} is off its tuned target")
    log(f"phase tutorial HMC: {time.perf_counter() - t0:.2f} s")


def smc_path(tut, tut_prop, smi):
    """SMC evidences on the tutorial: adaptive from the main path's
    proposal, then a linear ladder of SMC_TEMPS steps from that proposal
    widened SMC_WIDEN times; each run's p(M) against the published
    values, its ESS bound and its steps, no kernel launched."""
    import numpy as np
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    t0 = time.perf_counter()
    dims = torch.as_tensor(tut.dims, dtype=torch.float32,
                           device=tut_prop.B.device)
    wide = dataclasses.replace(
        tut_prop, B=tut_prop.B * SMC_WIDEN,
        logdetB=tut_prop.logdetB + dims[:, None] * math.log(SMC_WIDEN))
    for name, prop, tempering in (("adaptive", tut_prop, "adaptive"),
                                  (f"linear, scales x{SMC_WIDEN:g}", wide,
                                   "linear")):
        am = AMSampler(tut, EngineConfig(seed=4), device="cuda")
        am.set_proposal(prop)
        reset_counts()
        t1 = time.perf_counter()
        out = am.smc_evidence(n_particles=SMC_PARTICLES, n_temps=SMC_TEMPS,
                              n_moves=SMC_MOVES, tempering=tempering)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = read_counts()
        probs = np.asarray(out["model_probs"])
        err = float(np.abs(probs - np.asarray(PUBLISHED)).max())
        steps = (np.asarray(out["betas_used"]) < 1.0).sum(axis=0) + 1
        ess_min = float(np.min(out["ess"]))
        log(f"tutorial SMC, {name} [{smi}]: {SMC_PARTICLES} particles per "
            f"model, cap {SMC_TEMPS} steps of {SMC_MOVES} moves, steps per "
            f"model {steps.tolist()}, {secs:.3f} s; log Z = "
            f"{[round(float(x), 4) for x in out['log_evidence']]}; p(M) = "
            f"{[round(float(x), 4) for x in probs]} vs published "
            f"{list(PUBLISHED)}: max err {err:.4f} (bound {SMC_TOL}); min "
            f"ESS {ess_min:.1f} (bound {SMC_ESS * SMC_PARTICLES:.1f}); "
            f"launches {counts}")
        if err > SMC_TOL or not ess_min > SMC_ESS * SMC_PARTICLES:
            fail(f"SMC ({name}) on the tutorial misses the published p(M) "
                 f"or its ESS")
        if tempering == "linear" and steps.tolist() != [SMC_TEMPS] * len(
                steps):
            fail(f"the linear SMC ladder took {steps.tolist()} steps, not "
                 f"{SMC_TEMPS}")
        if any(counts.values()):
            fail("the SMC run launched a kernel")
        if not np.isfinite(out["theta"]).all():
            fail("non-finite SMC particles")
    log(f"phase tutorial SMC: {time.perf_counter() - t0:.2f} s")


SPLIT_CHAINS = 16_384     # chains of the split-launch checks of K1 / K1f
SPLIT_SWEEPS = 20         # sweeps of every split-launch check
SPLIT_C_K3 = 1024         # chains per model of the K3 split checks
MESH_BURN, MESH_SWEEPS = 1000, 2000   # the run on the mesh, stage 3


def check_split(ms, prop, chains, label, rng="hash", cache=False):
    """The sweep kernel's chain base: the first SPLIT_CHAINS chains of a
    run's state (all of a smaller one) over SPLIT_SWEEPS sweeps as one
    launch, and as two launches over the halves at chain bases 0 and
    S / 2 (a population split across two devices): every output, state,
    per-chain chunk sums and counters, bitwise equal.  The split pair is
    timed on the card and its twin (the two halves on the card) on its
    check run."""
    import torch
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    S = min(SPLIT_CHAINS, chains.n_chains)
    h = S // 2
    full = chunk_args(chains)

    def args(a, b):
        return tuple(x[..., a:b].contiguous() for x in full)

    kw = dict(seed=13, sweep0=chains.sweep, n_sweeps=SPLIT_SWEEPS,
              adapt=True, rng=rng)
    whole = fused.sweep_chunk(ms, *args(0, S), tabs, **kw)

    def halves(fn=fused.sweep_chunk):
        return [fn(ms, *args(i * h, (i + 1) * h), tabs, chain0=i * h, **kw)
                for i in (0, 1)]

    parts = halves()
    joined = [torch.cat([a, b], dim=-1) for a, b in zip(*parts)]
    equal = all(torch.equal(a, b) for a, b in zip(whole, joined))
    err = max(float((whole[i] - joined[i]).abs().max()) for i in (1, 2))
    twin, ms_p = timed(lambda: halves(fused.sweep_chunk_ref))
    twin_equal = all(torch.equal(a, torch.cat([x, y], dim=-1))
                     for a, x, y in zip(joined, *twin))
    log(f"{label} split ({S} chains x {SPLIT_SWEEPS} sweeps, {rng}): two "
        f"launches at chain bases 0 and {h} vs one launch: every output "
        f"equal {equal}, max|err| {err:.3e}; the halves equal their twin "
        f"{twin_equal}")
    if not (equal and twin_equal):
        fail(f"{label}: launches split at a chain base differ from one "
             "launch or from the twin")
    ms_k = cuda_ms(halves, 5)
    L, K, D = tabs.loglam.shape[1], ms.nmodels, ms.dmax
    probs = k_probs(ms, chains.k[:S])
    if cache:
        cnt = whole[9].sum(1).double().cpu().numpy()
        ops = S * SPLIT_SWEEPS * cache_sweep_ops(ms, L, probs, cnt, rng=rng)
        b = dict(zip(("bound_ms", "bound_by"), bound(
            ops, S * state_bytes(K, D) + 2 * tables_bytes(K, D, L))))
    else:
        b = bounds(lambda f: S * SPLIT_SWEEPS * sweep_ops(
            ms, L, probs, rng=rng, full=f),
            S * state_bytes(K, D) + 2 * tables_bytes(K, D, L))
    log(f"{label} split pair: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
        f"{bound_text(b)}")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, **b)


def check_split_k3(ms, C, dev, label):
    """K3's chain base, moves only: SPLIT_SWEEPS stage-1 sweeps of K x C
    chains as one launch a sweep, and as two launches a sweep over each
    model's first and last C / 2 chains (``C_total`` C, ``chain_off`` 0 and
    C / 2): theta and logp bitwise equal lane for lane and the halves'
    counts summing to the launch's, every sweep.  One sweep's pair timed
    on the card, its twin on the check."""
    import torch
    from automix_tpu_torch.kernels import fused_stage1
    K, D = ms.nmodels, ms.dmax
    h = C // 2
    theta, sig, _ = stage1_start(ms, C, dev)
    sig = sig * 0.05
    lp = torch.zeros(K * C, device=dev)

    def half(x, i):
        return x.reshape(*x.shape[:-1], K, C)[..., i * h:(i + 1) * h] \
            .reshape(*x.shape[:-1], K * h).contiguous()

    parts = [(half(theta, i), half(lp, i)) for i in (0, 1)]
    kw = dict(seed=777, nburn=10)

    def pair(t, parts, fn=fused_stage1.sweep):
        return [fn(ms, *parts[i], sig, C=h, C_total=C, chain_off=i * h, t=t,
                   seg_start=t == 1, **kw) for i in (0, 1)]

    equal = True
    for t in range(1, SPLIT_SWEEPS + 1):
        theta, lp, cnt = fused_stage1.sweep(ms, theta, lp, sig, C=C, t=t,
                                            seg_start=t == 1, **kw)
        got = pair(t, parts)
        equal &= torch.equal(got[0][2] + got[1][2], cnt)
        parts = [g[:2] for g in got]
        equal &= all(torch.equal(parts[i][j], half(x, i))
                     for i in (0, 1) for j, x in enumerate((theta, lp)))
    twin, ms_p = timed(lambda: pair(SPLIT_SWEEPS + 1, parts,
                                    fused_stage1.sweep_ref))
    kern = pair(SPLIT_SWEEPS + 1, parts)
    twin_equal = all(torch.equal(a[2], b[2]) for a, b in zip(kern, twin))
    log(f"{label} split ({K} x {C} chains x {SPLIT_SWEEPS} sweeps): two "
        f"launches a sweep at chain_off 0 and {h} vs one: theta, logp and "
        f"counts equal {equal}; the pair's counts equal its twin's "
        f"{twin_equal}")
    if not (equal and twin_equal):
        fail(f"{label}: launches split at a chain base differ from one "
             "launch")
    ms_k = cuda_ms(lambda: pair(SPLIT_SWEEPS + 1, parts), 50)
    N = K * C
    b = bounds(lambda full: N * stage1_ops(ms, uniform(ms), full),
               N * 4 * 2 * (D + 1))
    log(f"{label} split pair (one sweep): kernel {ms_k:.4f} ms, plain "
        f"{ms_p:.4f} ms, {bound_text(b)}")
    return dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p, **b)


def several_devices(ms, prop, chains, dev):
    """The port across devices on the card: the split-launch checks of the
    sweep kernel (hash and K1f) and K3 at the tutorial's (3, 2), then
    ``multihost.initialize`` with NCCL at world size 1 (the card is one
    device) and ``AMSampler(tutorial_set(), mesh=make_global_mesh())`` at
    the main path's size on the hash: its stage 1 on K3's moves-only route
    (the counts summed over the mesh every sweep) bitwise the main path's
    sig (K2's segments), then from the main path's proposal 1000 burn-in
    and 2000 sweeps, ksummary and chains bitwise a run without the mesh,
    and p(M) against the published values.  Returns (the checks' entries,
    the sharded run's launches)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import rwm
    from automix_tpu_torch.ops import randoms
    from automix_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    out = {"K1": check_split(ms, prop, chains, "K1"),
           "K1f": check_split(ms, prop, chains, "K1f", rng="hw"),
           "K3": check_split_k3(ms, SPLIT_C_K3, dev, "K3")}
    log(f"several devices: split checks {time.perf_counter() - t0:.2f} s")

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    multihost.initialize(f"localhost:{port}", num_processes=1,
                         process_id=0)
    try:
        mesh = multihost.make_global_mesh()
        log(f"several devices: {dist.get_backend()} group of "
            f"{dist.get_world_size()}, mesh on {mesh.device}, primary "
            f"{multihost.is_primary()}")
        if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
            fail("the mesh is not an NCCL group on the card")
        cfg = EngineConfig(n_chains=N_CHAINS, n_chains_stage1=N_CHAINS_STAGE1,
                           stage1_sweeps=STAGE1_SWEEPS,
                           sweep_chunk=SWEEP_CHUNK, seed=0, fused_rng="hash",
                           trace_chain0=False, n_trace_chains=1)
        reset_counts()
        sh = AMSampler(ms, cfg, mesh=mesh)
        t1 = time.perf_counter()
        # the sampler's stage-1 key (its first), without a second EM
        _, k1 = randoms.split_host(randoms.key(cfg.seed), 2)
        sig, _, _ = rwm.run_stage1(ms, cfg, k1, STAGE1_SWEEPS, sh.device,
                                   mesh=mesh)
        torch.cuda.synchronize()
        s1 = time.perf_counter() - t1
        sh.set_proposal(prop)
        sh.burn_samples(MESH_BURN)
        t1 = time.perf_counter()
        stats = sh.rjmcmc_samples(MESH_SWEEPS)
        torch.cuda.synchronize()
        s3 = time.perf_counter() - t1
        counts = read_counts()
        sig_equal = torch.equal(sig, prop.sig)
        ref = AMSampler(ms, cfg, device=mesh.device)
        ref.set_proposal(prop)
        ref.burn_samples(MESH_BURN)
        rstats = ref.rjmcmc_samples(MESH_SWEEPS)
        same = all(torch.equal(getattr(sh.chains, f), getattr(ref.chains, f))
                   for f in ("k", "theta", "logp", "pk", "pkllim",
                             "nreinit"))
        ks_equal = bool((stats.ksummary == rstats.ksummary).all())
        probs = stats.model_probs
        err = float(np.abs(probs - np.asarray(PUBLISHED)).max())
        log(f"several devices: stage 1 on the mesh ({ms.nmodels} x "
            f"{N_CHAINS_STAGE1} chains, {STAGE1_SWEEPS * 11 // 10} sweeps) "
            f"{s1:.3f} s, sig bitwise the main path's {sig_equal}; "
            f"{MESH_SWEEPS} sweeps x {N_CHAINS} chains {s3:.3f} s; chains "
            f"bitwise the run without the mesh {same}, ksummary {ks_equal}; "
            f"p(M) {np.round(probs, 4).tolist()}, max err {err:.4f}; "
            f"launches {counts}")
        if not (sig_equal and same and ks_equal):
            fail("the run on the mesh differs from the run without it")
        if err > PARITY_TOL:
            fail(f"p(M) on the mesh misses the published values by {err:.4f}")
        if counts["K3"] != STAGE1_SWEEPS * 11 // 10 or counts["K1"] == 0 \
                or counts["K2"] + counts["K1f"]:
            fail("the run on the mesh did not take K3 moves only and K1 on "
                 "the hash alone")
    finally:
        dist.destroy_process_group()
    log(f"phase several devices: {time.perf_counter() - t0:.2f} s")
    return out, counts


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


def check_probs(name, probs, exact, what="exact"):
    import numpy as np
    err = float(np.abs(np.asarray(probs) - np.asarray(exact)).max())
    log(f"{name}: p(M) = {[round(float(p), 4) for p in probs]} vs {what} "
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
    from automix_tpu_torch.kernels import _build, fused, fused_stage1
    from automix_tpu_torch.models import rb9, toy
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
    log("build units, seconds to each object: " + "; ".join(
        f"{u} {t:.1f}" for u, t in unit_seconds(lib_path)))
    for K, D in ((2, 2), (3, 2), (5, 5), (10, 5), (2, 16), (6, 13)):
        log(f"ptxas at ({K}, {D}), per form (registers, stack frame, spill "
            "stores, spill loads): " + "; ".join(
                f"{n} {r}, {f}, {st}, {ld}"
                for n, r, f, st, ld in ptxas_summary(lib_path, K, D)))

    ms = tutorial_set()
    toy1, toy2 = toy.toy1_set(), toy.toy2_set()
    t5 = randoms.student_t(5)

    # ---- 3. stage-1 kernels against their twins ------------------------------
    t0 = time.perf_counter()
    # torch's first use of each of its kernels on the card (module loads)
    # would fall into the first twin's time, which is taken on its check
    theta, sig, zi = stage1_start(ms, 32, dev)
    fused_stage1.segment_ref(ms, theta, sig, zi, zi, C=32, sweep0=0, seed=1,
                             nburn=50, n_active=100)
    k2 = check_segment(ms, N_CHAINS_STAGE1, dev)
    check_segment(toy2, TOY2_C_K2, dev, tdist=t5, label="K2 Student-t toy2")
    k2_toy2 = check_segment(toy2, TOY2_C_K3, dev, label="K2 toy2")
    k3 = check_sweep_kernel(toy2, TOY2_C_K3, dev)
    k3_counts = check_sweep_runner(toy2, dev)
    from automix_tpu_torch.models import changepoint, ddi
    log("K2's resident capacity (chains; Normal, Student-t): " + "; ".join(
        f"{s.nmodels, s.dmax} {fused_stage1.segment_capacity(s, dev)}, "
        f"{fused_stage1.segment_capacity(s, dev, t5)}"
        for s in (ms, toy2, rb9.rb9_set(), ddi.ddi_set(),
                  changepoint.cpt_set())))
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
    if main_counts["K1f"] == 0 or main_counts["K2"] == 0:
        fail("a kernel of the main path was never launched")
    # fused_rng="auto" is the hw stream on the card: no hash launch
    if main_counts["K1"] or main_counts["K1c"]:
        fail("fused_rng='auto' did not resolve to the hw stream (K1f)")
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

    # ---- 4b. the main path's state on the hash stream --------------------
    t0 = time.perf_counter()
    hs = AMSampler(ms, dataclasses.replace(cfg, fused_rng="hash"),
                   device="cuda")
    hs.set_proposal(am.proposal)
    hs.chains = am.chains
    reset_counts()
    hs.rjmcmc_samples(WARMUP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hstats = hs.rjmcmc_samples(TIMED)
    torch.cuda.synchronize()
    h_elapsed = time.perf_counter() - t1
    hash_counts = read_counts()
    h_rate = N_CHAINS * TIMED / h_elapsed
    log(f"main path's state, fused_rng='hash': {TIMED} timed sweeps x "
        f"{N_CHAINS} chains in {h_elapsed:.3f} s = {h_rate:.6e} "
        f"chain-sweeps/s (hw, the main path: {rate:.6e}); launches "
        f"{hash_counts}")
    check_probs("tutorial on the hash", hstats.model_probs, PUBLISHED,
                what="published")
    if hash_counts["K1"] == 0 or hash_counts["K1f"]:
        fail("the hash run did not launch K1 on the hash alone")
    del hs
    log(f"phase tutorial hash run: {time.perf_counter() - t0:.2f} s")

    # ---- 5. K1 against its twin on the main path's proposal and state --------
    t0 = time.perf_counter()
    k1 = check_sweep(ms, am.proposal, am.chains, dev)
    k1f = check_hw(ms, am.proposal, am.chains, "K1f tutorial")
    stream_times(ms, am.proposal, am.chains)
    tut_prop, tut_chains = am.proposal, am.chains
    del am
    log(f"phase K1 check: {time.perf_counter() - t0:.2f} s")

    # ---- 5a. several devices: chain bases, NCCL at world size 1 -----------
    mesh_out, mesh_counts = several_devices(ms, tut_prop, tut_chains, dev)
    del tut_chains

    # ---- 5b. the general engine: K4, tutorial, toy2 per-theta, the CLI -----
    gen = general_paths(ms, tut_prop, rate, dev)
    student_t_path(smi)
    hmc_path(ms, tut_prop, smi)
    smc_path(ms, tut_prop, smi)

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
        log(f"toy2 stages 1-2: stage 1 {cp.timesecs_stage1:.3f} s on K2 "
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
        if toy2_counts["K1f"] == 0 or toy2_counts["K2"] == 0 \
                or toy2_counts["K1"] + toy2_counts["K3"]:
            fail("the toy2 path did not launch K1f (perm) alone and K2")
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
        # the burn-in pinned to the hash: the path of K1a on the hash
        am = AMSampler(toy2, EngineConfig(
            n_chains=N_CHAINS, seed=5, perm=True, student_t_dof=5,
            fused_rng="hash", trace_chain0=False), device="cuda")
        am.set_proposal(prop)
        reset_counts()
        am.burn_samples(200)
        k1a_counts = read_counts()
        log(f"launches on the toy2 perm + Student-t burn-in (hash): "
            f"{k1a_counts}")
        if k1a_counts["K1"] == 0 or k1a_counts["K1f"]:
            fail("the toy2 hash burn-in did not launch K1 on the hash")
        k1a = check_sweep(toy2, am.proposal, am.chains, dev, perm=True,
                          tdist=t5, label="K1 perm + Student-t toy2")
        check_sweep(toy2, am.proposal, am.chains, dev, perm=True,
                    label="K1 perm toy2")
        k1fa = check_hw(toy2, am.proposal, am.chains,
                        "K1f perm + Student-t toy2", perm=True, tdist=t5)
        k1fb = check_hw(toy2, am.proposal, am.chains, "K1f perm toy2",
                        perm=True)
        check_toy_forms(toy2, am.proposal, am.chains, TOY2_FORMS,
                        "toy2 (5, 5)")
        # no sampler path of this run takes the hw perm + t form at (5, 5)
        k1fa_counts = toy_drive(toy2, am.proposal, am.chains,
                                "toy2 perm + Student-t drive", perm=True,
                                student_t_dof=5)
        del am
        log(f"phase K1 variant checks: {time.perf_counter() - t1:.2f} s")

        # ---- 8. the CLI on toy1 with Student-t, AutoRJ (no EM) ------------
        out, t_counts, secs = run_cli(
            ["toy1", "-t", "5", "-m", "2", "--chains", str(N_CHAINS), "-N",
             str(CLI_SWEEPS), "-s", "2", "-f", os.path.join(tmp, "toy1")])
        log(f"launches on the toy1 Student-t CLI path: {t_counts}")
        check_probs("toy1 -t 5 CLI", probs_of(out), TOY1_EXACT)
        if t_counts["K1f"] == 0 or t_counts["K2"] == 0 or t_counts["K1"]:
            fail("the toy1 CLI run did not launch K1f alone and K2")
        log(f"phase toy1 Student-t CLI: {secs:.2f} s")

        # ---- 8b. the (2, 2) Student-t + perm forms on toy1's state -------
        # the CLI's proposal (its _mix.data), the state after a hash
        # burn-in at the CLI's width: the path of K1a at (2, 2)
        t1 = time.perf_counter()
        from automix_tpu_torch.io import mixfile
        prop1 = mixfile.read_mix_file(
            os.path.join(tmp, "toy1_mix.data"), toy1.dims,
            lmax=EngineConfig().max_mix_comps, dmax=toy1.dmax)
        am = AMSampler(toy1, EngineConfig(
            n_chains=N_CHAINS, seed=5, perm=True, student_t_dof=5,
            fused_rng="hash", trace_chain0=False), device="cuda")
        am.set_proposal(prop1)
        reset_counts()
        am.burn_samples(200)
        toy1_counts = read_counts()
        log(f"launches on the toy1 perm + Student-t burn-in (hash): "
            f"{toy1_counts}")
        if toy1_counts["K1"] == 0 or toy1_counts["K1f"]:
            fail("the toy1 hash burn-in did not launch K1 on the hash")
        toy1_forms = check_toy_forms(toy1, am.proposal, am.chains,
                                     TOY1_FORMS, "toy1 (2, 2)")
        del am
        log(f"phase toy1 (2, 2) form checks: "
            f"{time.perf_counter() - t1:.2f} s")

        # ---- 9. rb9: stages 1-2 at the bench size, reports -----------------
        oracle = json.load(open(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "data",
            "heavy_oracle.json")))["rb9"]["mean"]
        rb = rb9.rb9_set()
        stem = os.path.join(tmp, "rb9")
        reset_counts()
        t0 = time.perf_counter()
        am = AMSampler(rb, EngineConfig(
            n_chains_stage1=RB9_C_STAGE1, stage1_sweeps=STAGE1_SWEEPS,
            max_mix_comps=RB9_MAX_MIX, seed=0), device="cuda")
        am.estimate_conditional_probs()
        reports.report_cond_prob_estimation(stem, am)
        cp = am.cpstats
        rb_prop = am.proposal
        log(f"rb9 stages 1-2: stage 1 {cp.timesecs_stage1:.3f} s on K2 "
            f"({RB9_C_STAGE1} chains per model, {STAGE1_SWEEPS * 11 // 10} "
            f"sweeps), stage 2 {cp.timesecs_stage2:.3f} s (lmax "
            f"{RB9_MAX_MIX}, EM iterations {cp.em_iters.tolist()}, "
            f"L={rb_prop.lmax})")
        del am
        log(f"phase rb9 stages 1-2: {time.perf_counter() - t0:.2f} s")

        # ---- 10. rb9: the CLI in mode 1 at its defaults ----------------------
        out, _, secs = run_cli(
            ["rb9", "-m", "1", "--chains", str(N_CHAINS), "-N",
             str(CLI_SWEEPS), "-s", "1", "-f", stem], reset=False)
        rb_counts = read_counts()
        log(f"launches on the rb9 path (stages 1-2 + CLI): {rb_counts}")
        check_probs("rb9 CLI mode 1", probs_of(out), oracle,
                    what="C oracle mean")
        if rb_counts["K1f"] == 0 or rb_counts["K2"] == 0 \
                or rb_counts["K1"] + rb_counts["K3"]:
            fail("the rb9 path did not launch K1f (perm) alone and K2")
        log(f"phase rb9 CLI mode 1: {secs:.2f} s")

        # ---- 11. rb9 kernel checks at (10, 5) --------------------------------
        t0 = time.perf_counter()
        k2_rb9 = check_segment(rb, RB9_C_K2, dev, label="K2 rb9")
        check_sweep_kernel(rb, RB9_C_STAGE1, dev, label="K3 rb9")
        # the burn-in pinned to the hash with perm: the path of K1b on rb9
        am = AMSampler(rb, EngineConfig(n_chains=N_CHAINS, seed=7, perm=True,
                                        fused_rng="hash",
                                        trace_chain0=False), device="cuda")
        am.set_proposal(rb_prop)
        reset_counts()
        am.burn_samples(200)
        k1b_counts = read_counts()
        log(f"launches on the rb9 perm burn-in (hash): {k1b_counts}")
        if k1b_counts["K1"] == 0 or k1b_counts["K1f"]:
            fail("the rb9 hash burn-in did not launch K1 on the hash")
        check_sweep(rb, am.proposal, am.chains, dev, label="K1 rb9")
        per_sweep = launch_lengths(rb, am.proposal, am.chains)
        log(f"K1 rb9 ms per sweep of {N_CHAINS} chains, pk frozen, by "
            f"launch length (1 / 10 / {TIME_SWEEPS} sweeps): "
            f"{' / '.join(f'{v:.4f}' for v in per_sweep.values())}")
        k1b = check_sweep(rb, am.proposal, am.chains, dev, perm=True,
                          label="K1 perm rb9")
        del am
        log(f"phase rb9 kernel checks: {time.perf_counter() - t0:.2f} s")

    # ---- 12. rb9 pooled pk: K1c, K1d, and K1d forced against K1c -------------
    pooled_cfg = dict(pk_mode="pooled", seed=11, trace_chain0=False)
    pooled = {}
    for n_chains, route in ((RB9_POOLED_K1C, "K1c"),
                            (RB9_POOLED_K1D, "K1d")):
        t0 = time.perf_counter()
        am = AMSampler(rb, EngineConfig(n_chains=n_chains, **pooled_cfg),
                       device="cuda")
        am.set_proposal(rb_prop)
        am.burn_samples(RB9_BURN)
        reset_counts()
        t1 = time.perf_counter()
        stats = am.rjmcmc_samples(CLI_SWEEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = read_counts()
        log(f"rb9 pooled, {n_chains} chains: {CLI_SWEEPS} sweeps in "
            f"{secs:.3f} s = {n_chains * CLI_SWEEPS / secs:.6e} "
            f"chain-sweeps/s; launches {counts}")
        check_probs(f"rb9 pooled {n_chains} chains", stats.model_probs,
                    oracle, what="C oracle mean")
        # one launch of the route's kernel per chunk (K1c, or K1d above
        # K1c's bound) and no other launch, on the hw stream ("auto" on
        # the card)
        want = {"K1fc" if route == "K1c" else "K1fd":
                CLI_SWEEPS // SWEEP_CHUNK}
        if {k: v for k, v in counts.items() if v} != want:
            fail(f"the pooled run at {n_chains} chains did not take {route} "
                 "once a chunk on the hw stream alone")
        if not bool((am.chains.pk == am.chains.pk[0]).all()):
            fail("the pooled pk rows differ")
        pooled[route] = (am, counts["K1fc" if route == "K1c" else "K1fd"])
        log(f"phase rb9 pooled {route}: {time.perf_counter() - t0:.2f} s")

    # K1c and the forced K1d are bitwise equal on the hash only (K1d
    # reseeds the hw stream at every sweep), so this pins it
    t0 = time.perf_counter()
    short = {}
    for force in (False, True):
        fused._FORCE_POOLED_SCAN = force
        try:
            am = AMSampler(rb, EngineConfig(n_chains=RB9_POOLED_K1C,
                                            sweep_chunk=100, fused_rng="hash",
                                            **pooled_cfg),
                           device="cuda")
            am.set_proposal(rb_prop)
            am.burn_samples(RB9_FORCED[0])
            reset_counts()
            st = am.rjmcmc_samples(RB9_FORCED[1])
            short[force] = (am.chains, st.ksummary.copy(), read_counts())
        finally:
            fused._FORCE_POOLED_SCAN = False
    (a, ka, ca), (b, kb, cb) = short[False], short[True]
    equal = (torch.equal(a.k, b.k) and torch.equal(a.pk, b.pk)
             and torch.equal(a.theta, b.theta) and bool((ka == kb).all()))
    log(f"rb9 pooled {RB9_POOLED_K1C} chains, {RB9_FORCED[1]} sweeps: K1c "
        f"(launches {ca}) vs K1d forced (launches {cb}): k, theta, pk and "
        f"ksummary bitwise equal {equal}")
    if not equal or ca["K1c"] == 0 or ca["K1"] + ca["K1d"] != 0 \
            or cb["K1c"] + cb["K1"] != 0 or cb["K1d"] != RB9_FORCED[1] // 100:
        fail("the forced K1d run is not bitwise equal to K1c, or did not "
             "launch K1d once a chunk")
    k1c = check_pooled(rb, rb_prop, pooled["K1c"][0].chains, dev)
    k1d = check_pooled_runner(rb, rb_prop, pooled["K1d"][0].chains, dev,
                              rng="hash")
    k1fc = check_hw(rb, rb_prop, pooled["K1c"][0].chains, "K1f pooled rb9",
                    pooled=True)
    k1fd = check_pooled_runner(rb, rb_prop, pooled["K1d"][0].chains, dev,
                               rng="hw")
    log(f"phase rb9 pooled checks: {time.perf_counter() - t0:.2f} s")

    # ---- 13. DDI: AMSampler, kernel checks, the CLI, pooled pk -------------
    ddi_out = ddi_paths(dev)

    # ---- 14. change-point: stage-1 kernels, AMSampler, K1 checks, the CLI --
    cpt_out = changepoint_paths(dev)

    log(f"total: {time.perf_counter() - t_all:.2f} s")

    def entry(name, source, replaces, launches, check):
        return {"name": name, "route": "cuda",
                "source": f"automix_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **check,
                "library_ms": None}

    # The hash forms' launches come from the paths that run them on the
    # hash (the hw stream is "auto" on the card): the main path's state on
    # the hash, the hash-pinned burn-ins and forced-K1d comparison, and the
    # hash drives; the K1f forms' from the sampler paths.
    k1_src, k1_at = "fused_sweep.cu", "automix_tpu/kernels/fused.py:859"
    log(json.dumps({"kernels": [
        entry("fused_sweep", k1_src, k1_at, hash_counts["K1"], k1),
        entry("fused_sweep_student_t", k1_src, k1_at, k1a_counts["K1"], k1a),
        entry("fused_sweep_perm_rb9", k1_src, k1_at, k1b_counts["K1"], k1b),
        entry("fused_sweep_pooled", k1_src, k1_at, ca["K1c"], k1c),
        entry("fused_sweep_pooled_runner", k1_src, k1_at, cb["K1d"], k1d),
        entry("fused_sweep_hw", k1_src, k1_at, main_counts["K1f"], k1f),
        entry("fused_sweep_student_t_hw", k1_src, k1_at,
              k1fa_counts["K1f"], k1fa),
        entry("fused_sweep_student_t_hw_toy1", k1_src, k1_at,
              t_counts["K1f"], toy1_forms["K1f + t + perm"]),
        entry("fused_sweep_perm_hw", k1_src, k1_at, toy2_counts["K1f"],
              k1fb),
        entry("fused_sweep_pooled_hw", k1_src, k1_at, pooled["K1c"][1],
              k1fc),
        entry("fused_sweep_pooled_runner_hw", k1_src, k1_at,
              pooled["K1d"][1], k1fd),
        entry("fused_stage1_segment", "fused_stage1.cu",
              "automix_tpu/kernels/fused_stage1.py:696", main_counts["K2"],
              k2),
        entry("fused_stage1_segment_toy2", "fused_stage1.cu",
              "automix_tpu/kernels/fused_stage1.py:696", toy2_counts["K2"],
              k2_toy2),
        entry("fused_stage1_segment_rb9", "fused_stage1.cu",
              "automix_tpu/kernels/fused_stage1.py:696", rb_counts["K2"],
              k2_rb9),
        entry("fused_stage1_sweep", "fused_stage1_sweep.cu",
              "automix_tpu/kernels/fused_stage1.py:416", k3_counts["K3"],
              k3),
        entry("fused_sweep_cache_ddi", k1_src, k1_at,
              ddi_out["drive"]["K1"], ddi_out["K1e"]),
        entry("fused_sweep_cache_perm_ddi", k1_src, k1_at,
              ddi_out["drive perm"]["K1"], ddi_out["K1e perm"]),
        entry("fused_sweep_cache_ddi_hw", k1_src, k1_at,
              ddi_out["main"]["K1f"], ddi_out["K1e hw"]),
        entry("fused_stage1_segment_ddi", "fused_stage1.cu",
              "automix_tpu/kernels/fused_stage1.py:696",
              ddi_out["main"]["K2"], ddi_out["K2"]),
        entry("fused_stage1_sweep_ddi", "fused_stage1_sweep.cu",
              "automix_tpu/kernels/fused_stage1.py:416",
              ddi_out["K3 route"]["K3"], ddi_out["K3"]),
    ] + ([entry("fused_sweep_cache_pooled_ddi", k1_src, k1_at,
                ddi_out["drive pooled"]["K1c"], ddi_out["K1c"])]
         if "K1c" in ddi_out else []) + [
        entry("fused_stage1_segment_log_cpt", "fused_stage1.cu",
              "automix_tpu/kernels/fused_stage1.py:696",
              cpt_out["cpt"]["K2"], cpt_out["K2-log"]),
        entry("fused_stage1_sweep_log_cpt", "fused_stage1_sweep.cu",
              "automix_tpu/kernels/fused_stage1.py:416",
              cpt_out["K3-log launches"], cpt_out["K3-log"]),
        entry("fused_sweep_cpt", k1_src, k1_at, cpt_out["drive"]["K1"],
              cpt_out["K1"]),
        entry("fused_sweep_perm_cpt", k1_src, k1_at,
              cpt_out["drive perm"]["K1"], cpt_out["K1b"]),
        entry("fused_sweep_pooled_cpt", k1_src, k1_at,
              cpt_out["drive pooled"]["K1c"], cpt_out["K1c"]),
        entry("fused_sweep_cpt_hw", k1_src, k1_at, cpt_out["cpt"]["K1f"],
              cpt_out["K1f"]),
        entry("fused_sweep_pooled_runner_cpt", k1_src, k1_at,
              *cpt_out["K1d"]),
        dict(entry("sweep_rng", "sweep_rng.cu",
                   "automix_tpu/kernels/sweep_rng.py:139",
                   gen["tutorial"]["K4"], gen["K4"]),
             library_ms=gen["K4"]["library_ms"]),
        # the chain base: split launches against one launch; launches of
        # the run on the mesh (K1 on the hash, K3 moves only), else of the
        # path that runs the form
        entry("fused_sweep_chain_base", k1_src, k1_at, mesh_counts["K1"],
              mesh_out["K1"]),
        entry("fused_sweep_chain_base_hw", k1_src, k1_at,
              main_counts["K1f"], mesh_out["K1f"]),
        entry("fused_sweep_cache_chain_base_ddi", k1_src, k1_at,
              ddi_out["drive"]["K1"], ddi_out["K1e split"]),
        entry("fused_stage1_sweep_chain_base", "fused_stage1_sweep.cu",
              "automix_tpu/kernels/fused_stage1.py:416", mesh_counts["K3"],
              mesh_out["K3"]),
        entry("fused_stage1_sweep_chain_base_ddi", "fused_stage1_sweep.cu",
              "automix_tpu/kernels/fused_stage1.py:416",
              ddi_out["K3 route"]["K3"], ddi_out["K3 split"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
