#!/usr/bin/env python3
"""Time the sweep and stage-1 kernels on one NVIDIA GPU, to compare two
versions of the kernel sources.  Each part is chosen with ``--parts``
(a comma list, every part by default):

* ``sweep``: every form of the stage-3 sweep kernel at the change-point
  (6, 13) and rb9 (10, 5) shapes, beside the main path's (3, 2), DDI's
  cached form K1e at (2, 16) and the change-point stage-1 kernels;
* ``tutorial``: the main path's sweep kernel at (3, 2) alone, on the
  tutorial's state: its ptxas records, warps per SM and SASS instructions
  by class, K1 and K1f held bitwise to their twins on the card, ms per
  100-sweep launch of K1f and K1, and the main path's chain-sweeps/s
  (``AMSampler`` on the state, as ``chip_smoke.py`` times it);
* ``k1c``: K1c with DDI's cache on every chain of DDI's state and on the
  state repeated to 33792 chains (two blocks of 128 on each of an H100's
  132 SMs), against K1e (the same sweeps with per-chain pk) on the same
  chains, ms per launch of 100 sweeps on the hash and the hw stream;
* ``k2``: K2, ms per 100-sweep segment from the start points at the
  tutorial (3 x 1024), toy2 (5 x 2048), rb9 (10 x 512), DDI (2 x 512) and
  cpt (6 x 512, the log rule), and the stage-1 kernels' registers;
* ``stage1``: stage 1 of each ``AMSampler`` path of ``chip_smoke.py``
  (its populations, sweeps and rules) on the segment runner (K2) where
  the population fits and on the one-sweep runner (K3), host seconds with
  a synchronize, after a short warm-up run of the same shape;
* ``scan``: K1d (one cooperative launch a chunk) against the one-sweep
  route it replaced (a K1 launch a sweep and the update in torch), ms per
  sweep in turns (route, K1d, K1d, route; ``chip_smoke.route_turns``) on
  the rb9 (131072), DDI and cpt (16384) states, on both streams, each
  first held bitwise to the route (``chip_smoke.scan_against_route``);
* ``pooled_run``: rb9's pooled run of ``chip_smoke.py`` (131072 chains,
  20000 sweeps after its burn-in, from the fit's proposal) through
  ``AMSampler`` on K1d and on the one-sweep route, seconds each and
  whether their visit counts are equal;
* ``toy``: the sweep kernel's forms at toy2's (5, 5) (K1 / K1a / K1b
  on the hash, K1f / K1f + perm / K1f + t + perm on the hw stream) on a
  toy2 state and its Student-t and perm forms at toy1's (2, 2) on a toy1
  state (each ``AMSampler``'s fit, 131072 chains after 200 burn-in
  sweeps), each first held bitwise to its twin on the card (16384 chains
  x 20 sweeps; whether it is equal is recorded, not asserted), then ms
  per launch of 100 and of 16 sweeps (the CLI's launch, a trace every
  16th sweep), the forms' ptxas records and warps per SM, and the CLI in
  mode 1 on toy2 and on toy1 with ``-t 5`` from those fits (131072
  chains, 20000 sweeps), in seconds;
* ``k3``: K3, the stage-1 one-sweep kernel, from the start points at
  DDI's 2 x 512 and toy2's 5 x 2048, and above K2's resident capacity at
  DDI's 2 x 15000 and toy2's 5 x 27100: ms per launch (CUDA events,
  from Python and replayed from a CUDA graph) in its moves-only mode
  and, where the checkout has it, with the update in the launch; the
  one-sweep runner's host ms per sweep (a synchronize after 330 sweeps)
  in two turns; K2's capacity and K3's grid;
* ``sass``: a hash of each compiled sweep and stage-1 kernel's SASS
  instructions (``cuobjdump -sass``, the anonymous namespace's per-build
  name taken out), by kernel and occurrence, so that two builds' forms
  are compared function by function.

Every part prints the seconds the library's build took (0 where it was
built before).

The ``sweep`` part (the ``tutorial`` part the tutorial's alone) makes the
states of ``chip_smoke.py``'s checks with its own functions and
configurations: cpt's and cptrs' ``AMSampler`` runs
(JAX's change-point configuration, 16384 chains on K1c, 1500 burn-in and
10000 sweeps, cptrs fitted at lmax 10), rb9's fit with 131072 chains
after 200 burn-in sweeps (as ``tools/time_rb9_sweeps.py``), the tutorial
main path's fit with 131072 chains after 1000 burn-in sweeps, DDI's run
as ``tools/time_k1e_k4.py`` (the ``k1c`` part's state too), and the
proposals (``_mix.data``) of cpt, cptrs and rb9 that the CLI reads.  Then it
times, in milliseconds per launch of 100 sweeps with pk adapting (CUDA
events):

* at (6, 13) (cpt, cptrs) and (10, 5) (rb9), at 16384 and 131072 chains
  (a state of 16384 repeated): K1 and K1 + perm on the hash, K1f and
  K1f + perm (hw), K1c and K1f pooled where the population is resident
  (``pooled_capacity``), and K1d and the one-sweep route (ms per sweep)
  on both streams;
* the tutorial's K1f and K1 at 131072 chains, DDI's K1e at 16384 on both
  streams with and without perm;
* K2-log (one 100-sweep segment of 6 x 512 cpt chains) and the K3 + log
  route (6 x 1024, ms per stage-1 sweep) from cpt's start points;
* the CLI in mode 1 at ``chip_smoke.py``'s size (131072 chains): on cpt
  and cptrs (burn-in 10000 and 10000 sweeps) and on rb9 (10000 and
  20000), in seconds;

and reads each shape's registers (``ptxas -v``), the sweep kernel's SASS
instructions per form (``cuobjdump -sass``; at (3, 2) and (10, 5) also
by class: ``SASS_CLASSES``), the per-chain kernel's
resident warps per SM, K1c's capacity, and how often a chain's model
changes per sweep on cpt, cptrs and rb9 (100 one-sweep launches on the
hash).
The script imports the port from the checkout it lies in and builds its
kernels there, so two checkouts are compared by running each one's copy
in turn on one machine (parent, change, change, parent); ``--state DIR``
keeps the states and proposals there, made by the first run, so that
every copy times the same chains:

    python3 tools/time_sweep_shapes.py --state DIR [--parts k1c,k2]
        [--sets cpt,cptrs]

``--sets`` limits the ``sweep`` part to some of the model sets (a comma
list of SETS, every set by default), so that a build cut to their shapes
times them.

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SIZES = (16_384, 131_072)
PARTS = ("sweep", "tutorial", "k1c", "k2", "stage1", "scan", "pooled_run",
         "toy", "k3", "sass")
# the toy forms: (label, perm, Student-t, stream) at toy2's (5, 5), and
# the (2, 2) forms the toy1 `-t 5` CLI and its hash burn-in run
TOY2_FORMS = (("K1", False, False, "hash"), ("K1a", True, True, "hash"),
              ("K1b", True, False, "hash"), ("K1f", False, False, "hw"),
              ("K1f + perm", True, False, "hw"),
              ("K1f + t + perm", True, True, "hw"))
TOY1_FORMS = (("K1a", True, True, "hash"), ("K1f + t + perm", True, True, "hw"))
# (name, set, chains per model) of the K3 timings
K3_POPULATIONS = (("ddi", "ddi", 512), ("toy2", "toy2", 2048),
                  ("ddi", "ddi", 15000), ("toy2", "toy2", 27100))
# the model sets whose states the sweep part makes and times
SETS = ("cpt", "cptrs", "rb9", "tutorial", "ddi")
# (name, set, chains per model, rule) of the K2 segment timings
SEGMENTS = (("tutorial", "tutorial", 1024, "aap"),
            ("toy2", "toy2", 2048, "aap"), ("rb9", "rb9", 512, "aap"),
            ("ddi", "ddi", 512, "aap"), ("cpt", "cpt", 512, "log"))
# (name, set, chains per model, stage-1 sweeps, rule) of the AMSampler
# paths of chip_smoke.py
STAGE1_PATHS = (("tutorial", "tutorial", 1024, 2000, "aap"),
                ("toy2", "toy2", 2048, 10000, "aap"),
                ("rb9", "rb9", 1024, 2000, "aap"),
                ("ddi", "ddi", 512, 1500, "aap"),
                ("cpt", "cpt", 1024, 2500, "log"),
                ("cptrs", "cptrs", 1024, 2500, "log"))


def model_set(name):
    from automix_tpu_torch.models import changepoint, ddi, rb9, toy
    from automix_tpu_torch.models.tutorial import tutorial_set
    return {"tutorial": tutorial_set, "toy2": toy.toy2_set,
            "rb9": rb9.rb9_set, "ddi": ddi.ddi_set,
            "cpt": changepoint.cpt_set, "cptrs": changepoint.cptrs_set}[name]()


def saved(path, make):
    """(chains, proposal) from ``path`` where it exists, else ``make()``'s
    AMSampler state, written there."""
    import torch
    from automix_tpu_torch.state import Chains, Proposal
    if os.path.exists(path):
        got = torch.load(path, map_location="cuda")
        return Chains(**got["chains"]), Proposal(**got["proposal"])
    am = make()
    torch.save({"chains": dataclasses.asdict(am.chains),
                "proposal": dataclasses.asdict(am.proposal)}, path)
    return am.chains, am.proposal


grown = cs.grown


def sweep_forms(ms, prop, ch, dev, perm=True, pooled=True):
    """ms per 100-sweep launch of each per-chain form on ``ch`` (with
    ``perm``, the perm variants too) and, with ``pooled``, of each pooled
    form where the population is resident, and ms per sweep of K1d (a
    100-sweep launch) and of the one-sweep route."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    args = cs.chunk_args(ch)
    n = cs.TIME_SWEEPS

    def chunk(**kw):
        return cs.cuda_ms(lambda: fused.sweep_chunk(
            ms, *args, tabs, seed=11, sweep0=ch.sweep, n_sweeps=n,
            adapt=True, **kw), 3)

    out = {}
    for rng, name in (("hash", "K1"), ("hw", "K1f")):
        out[name] = chunk(rng=rng)
        if perm:
            out[f"{name} perm"] = chunk(rng=rng, perm=True)
    if not pooled:
        return out
    if ch.n_chains <= fused.pooled_capacity(ms, prop.lmax, dev):
        out["K1c"] = chunk(pooled=True)
        out["K1f pooled"] = chunk(pooled=True, rng="hw")
    for rng, name in (("hash", "K1d"), ("hw", "K1f")):
        out[f"{name} per sweep"] = cs.cuda_ms(
            lambda: fused.pooled_scan(ms, ch, tabs, n, seed=17, rng=rng),
            2) / n
        out[f"{name} one-sweep route per sweep"] = cs.cuda_ms(
            lambda: fused.pooled_sweeps(ms, ch, tabs, 20, seed=17, rng=rng,
                                        sweep_fn=fused.sweep_chunk), 2) / 20
    return out


def model_changes(ms, prop, ch, n=100):
    """Model changes per chain-sweep over n one-sweep hash launches."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    state = cs.chunk_args(ch)
    changed = 0
    for t in range(n):
        out = fused.sweep_chunk(ms, *state, tabs, seed=3,
                                sweep0=ch.sweep + t, n_sweeps=1, adapt=True)
        changed += int((out[0] != state[0]).sum())
        state = out[:6]
    return changed / (n * ch.n_chains)


# SASS opcodes by class, for the instruction mix of the sweep kernel at the
# tutorial's (3, 2) and rb9's (10, 5): local memory, shared loads, the
# special-function unit, conversions, float and integer arithmetic; anything
# else is "other".
SASS_CLASSES = {
    "LDL": ("LDL",), "STL": ("STL",), "LDS": ("LDS",), "MUFU": ("MUFU",),
    "conversions": ("I2F", "F2I", "I2FP", "F2IP", "F2F", "I2I"),
    "float ALU": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
                  "FCHK", "FRND"),
    "integer ALU": ("IADD3", "IADD", "IMAD", "IMUL", "LOP3", "LOP", "SHF",
                    "SHL", "SHR", "LEA", "ISETP", "IMNMX", "SEL", "PRMT",
                    "POPC", "FLO", "BREV", "IABS", "VIADD", "VIMNMX",
                    "BMSK", "SGXT")}


def sass_sizes(lib_path, classes_at=((3, 2), (10, 5))):
    """Instructions of each compiled form of the sweep kernel in the
    library's SASS (one ``cuobjdump -sass``), by "(K, D)": a list of
    (kernel and its bool template argument, instructions) in the
    library's order, and under "classes (K, D)" the forms at each shape
    of ``classes_at`` with their instructions counted by SASS_CLASSES;
    empty where the toolkit has no cuobjdump."""
    import re
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    of = {op: name for name, ops in SASS_CLASSES.items() for op in ops}
    at = {"({}, {})".format(*kd) for kd in classes_at}
    out = {}
    for block in text.split("Function : ")[1:]:
        m = re.search(r"fused_sweep_kernelILi(\d+)ELi(\d+)ELb([01])E",
                      block.split("\n", 1)[0])
        if not m:
            continue
        shape, form = f"({m.group(1)}, {m.group(2)})", \
            f"fused_sweep_kernel<{m.group(3)}>"
        ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", block, re.M)
        out.setdefault(shape, []).append((form, len(ops)))
        if shape in at:
            counts = dict.fromkeys(SASS_CLASSES, 0)
            counts["other"] = 0
            for op in ops:
                counts[of.get(op, "other")] += 1
            out.setdefault(f"classes {shape}", []).append((form, counts))
    return out


def sass_hashes(lib_path):
    """{kernel#occurrence: sha256 of its SASS instructions} of every
    compiled form of the sweep kernels (K1, K1c, K1e: fused_sweep_kernel;
    K1d: fused_scan_kernel) and the stage-1 kernels (K2, K3) in the
    library, the occurrence counting each name's units in link order;
    empty where the toolkit has no cuobjdump."""
    import hashlib
    import re
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    out, seen = {}, {}
    for block in text.split("Function : ")[1:]:
        head, body = block.split("\n", 1)
        m = re.search(r"(fused_(?:sweep|scan|stage1|stage1_sweep)_kernel)"
                      r"I(\w+?)EEv", head)
        if not m:
            continue
        name = f"{m.group(1)}<{m.group(2)}>"
        seen[name] = seen.get(name, 0) + 1
        ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body, re.M)
        out[f"{name}#{seen[name]}"] = hashlib.sha256(
            "\n".join(ops).encode()).hexdigest()[:16]
    return out


def scan_part(states, dev):
    """K1d against the one-sweep route on the rb9, DDI and cpt states,
    each stream: held bitwise (20 sweeps), then ms per sweep in turns
    (route, K1d, K1d, route)."""
    from automix_tpu_torch.kernels import fused
    out = {}
    for name in ("rb9", "ddi", "cpt"):
        if name not in states:
            continue
        ms, ch, prop = states[name]
        tabs = fused.prep_tables(prop, ms.dims)
        for rng in ("hash", "hw"):
            cs.scan_against_route(ms, tabs, ch, cs.K1D_CHECK_SWEEPS, rng,
                                  f"K1d {name}")
            route, scan = cs.route_turns(ms, tabs, ch, rng)
            out[f"{name} {ch.n_chains} {rng}"] = {"route": route,
                                                  "K1d": scan}
    return out


def pooled_run(prop):
    """rb9's pooled run of chip_smoke.py from ``prop`` through
    ``AMSampler``: K1d (the runner's route above K1c's bound), then the
    one-sweep route in its place; the timed sweeps' seconds and visit
    counts of each, and whether the counts are equal."""
    import numpy as np
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.models.rb9 import rb9_set
    scan = fused.pooled_scan

    def route(*args, **kw):
        return fused.pooled_sweeps(*args, sweep_fn=fused.sweep_chunk, **kw)

    out = {}
    for name, fn in (("K1d", scan), ("route", route)):
        fused.pooled_scan = fn
        try:
            am = AMSampler(rb9_set(), EngineConfig(
                n_chains=cs.RB9_POOLED_K1D, pk_mode="pooled", seed=11,
                trace_chain0=False), device="cuda")
            am.set_proposal(prop)
            am.burn_samples(cs.RB9_BURN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = am.rjmcmc_samples(cs.CLI_SWEEPS)
            torch.cuda.synchronize()
            out[f"{name} s"] = time.perf_counter() - t0
            out[f"{name} ksummary"] = np.asarray(stats.ksummary).tolist()
        finally:
            fused.pooled_scan = scan
    out["ksummary equal"] = out["K1d ksummary"] == out["route ksummary"]
    return out


def cli_seconds(name, mix_stem, sweeps=cs.CPT_CLI_SWEEPS, extra=()):
    """Seconds of the CLI in mode 1 on ``name`` from the proposal at
    ``mix_stem``_mix.data, at chip_smoke.py's size (131072 chains,
    ``-N sweeps``), with the arguments ``extra``."""
    from automix_tpu_torch import cli
    with tempfile.TemporaryDirectory() as tmp:
        stem = os.path.join(tmp, name)
        shutil.copy(mix_stem + "_mix.data", stem + "_mix.data")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([name, "-m", "1", "--chains", str(cs.N_CHAINS),
                           "-N", str(sweeps), "-s", "1", "-f", stem,
                           *extra])
        secs = time.perf_counter() - t0
    if rc != 0:
        sys.exit(f"time_sweep_shapes: the {name} CLI returned {rc}")
    return secs


def toy_forms(ms, ch, prop, forms):
    """Each of ``forms`` on ``ch``: held bitwise to its twin on the card
    (16384 chains x 20 sweeps), then ms per launch of 100 and of 16
    sweeps on every chain of ``ch``."""
    import torch
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.ops import randoms
    tabs = fused.prep_tables(prop, ms.dims)
    small = cs.chunk_args(grown(ch, cs.K1_CHAINS))
    args = cs.chunk_args(ch)
    out = {}
    for label, perm, tdist, rng in forms:
        kw = dict(seed=11, adapt=True, perm=perm, rng=rng,
                  tdist=randoms.student_t(5) if tdist else None)
        got = fused.sweep_chunk(ms, *small, tabs, sweep0=ch.sweep,
                                n_sweeps=20, **kw)
        want = fused.sweep_chunk_ref(ms, *small, tabs, sweep0=ch.sweep,
                                     n_sweeps=20, **kw)
        row = {"bitwise": all(torch.equal(a, b) for a, b in zip(got, want)),
               "k equal": float((got[0] == want[0]).float().mean())}
        for n in (cs.TIME_SWEEPS, 16):
            row[f"ms per {n} x {ch.n_chains}"] = cs.cuda_ms(
                lambda: fused.sweep_chunk(ms, *args, tabs, sweep0=ch.sweep,
                                          n_sweeps=n, **kw), 5)
        out[label] = row
    return out


def toy_part(lib, path, dev):
    """The toy forms at (5, 5) and (2, 2) on the toy2 and toy1 states (made
    once into the state directory with their _mix.data), the forms'
    registers and warps per SM, and the two CLI runs' seconds."""
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.io import reports
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.models import toy
    from automix_tpu_torch.ops import randoms

    def run(name, ms, **cfg):
        def make():
            fit = AMSampler(ms, EngineConfig(max_mix_comps=10, seed=1,
                                             **cfg), device="cuda")
            fit.estimate_conditional_probs()
            reports.report_cond_prob_estimation(path(name), fit)
            am = AMSampler(ms, EngineConfig(
                n_chains=cs.N_CHAINS, seed=5, trace_chain0=False, **cfg),
                device="cuda")
            am.set_proposal(fit.proposal)
            am.burn_samples(200)
            return am
        return saved(path(f"{name}.pt"), make)

    out = {}
    for name, ms, forms, cfg in (
            ("toy2", toy.toy2_set(), TOY2_FORMS,
             dict(n_chains_stage1=cs.TOY2_C_K3)),
            ("toy1", toy.toy1_set(), TOY1_FORMS,
             dict(n_chains_stage1=cs.TOY2_C_K3, student_t_dof=5,
                  perm=True))):
        ch, prop = run(name, ms, **cfg)
        K, D = ms.nmodels, ms.dmax
        out[f"{name} ({K}, {D}) L={prop.lmax}"] = toy_forms(ms, ch, prop,
                                                            forms)
        out[f"ptxas ({K}, {D})"] = [
            f"{n} {r}, frame {f}, spills {st}/{ld}"
            for n, r, f, st, ld in cs.ptxas_summary(lib, K, D)]
        out[f"warps per SM ({K}, {D})"] = {
            f"perm {p} t {t}": fused.occupancy(
                ms, prop.lmax, dev, perm=p,
                tdist=randoms.student_t(5) if t else None)
            for p in (False, True) for t in (False, True)}
    out["cli_s"] = {
        "toy2": cli_seconds("toy2", path("toy2"), cs.CLI_SWEEPS),
        "toy1 -t 5": cli_seconds("toy1", path("toy1"), cs.CLI_SWEEPS,
                                 extra=("-t", "5"))}
    return out


def k3_part(dev):
    """K3's ms per launch and the one-sweep runner's host ms per sweep at
    each of K3_POPULATIONS (two below K2's resident capacity, two above
    it, where the routing rule sends K3): the kernel in its moves-only
    mode and, where this checkout has it, with the update in the launch,
    each launched from Python and replayed from a CUDA graph; the runner
    in this checkout's form, in two turns; K2's capacity and, where this
    checkout has it, K3's grid."""
    import inspect
    import torch
    from automix_tpu_torch import EngineConfig
    from automix_tpu_torch.kernels import fused_stage1
    from automix_tpu_torch.ops import randoms
    has_update = "nacc" in inspect.signature(fused_stage1.sweep).parameters
    out = {}
    for name, setname, C in K3_POPULATIONS:
        ms = model_set(setname)
        K, D = ms.nmodels, ms.dmax
        at = f"{name} {K} x {C}"
        out[f"{at} K2 capacity"] = fused_stage1.segment_capacity(ms, dev)
        if hasattr(fused_stage1, "sweep_grid"):
            out[f"{at} grid"] = fused_stage1.sweep_grid(K * C, dev)
        theta, sig, _ = cs.stage1_start(ms, C, dev)
        lp = torch.zeros(theta.shape[1], device=dev)
        kw = dict(C=C, t=60, seed=777, nburn=50, seg_start=False)
        forms = {"moves only": functools.partial(
            fused_stage1.sweep, ms, theta, lp, sig, **kw)}
        if has_update:
            zi = dict(dtype=torch.int32, device=dev)
            forms["update in launch"] = functools.partial(
                fused_stage1.sweep, ms, theta, lp, sig.clone(), **kw,
                nacc=torch.zeros((K, D), **zi), ntry=torch.zeros((K, D), **zi),
                work=torch.zeros(K * D + 1, **zi))
        for form, one in forms.items():
            out[f"{at} kernel ms, {form}, from Python"] = cs.cuda_ms(one, 200)
            out[f"{at} kernel ms, {form}, graph"] = cs.graph_ms(one, 100)
        init = ms.init_points(randoms.key(0))
        cfg = EngineConfig(seed=0)
        fused_stage1.run_fused_stage1_sweeps(ms, cfg, 20, C, init, dev)
        for turn in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused_stage1.run_fused_stage1_sweeps(ms, cfg, 300, C, init, dev)
            torch.cuda.synchronize()
            out[f"{at} runner ms per sweep, turn {turn}"] = \
                (time.perf_counter() - t0) * 1e3 / 330
    return out


def tutorial_part(lib, ch, prop, dev):
    """The main path's sweep kernel at (3, 2) on the tutorial's state: its
    ptxas records, resident warps per SM and SASS by class, K1 and K1f
    against their twins run on the card (every output bitwise, 16384
    chains x 20 sweeps), ms per 100-sweep launch of K1f and K1 at the
    state's 131072 chains, and the main path's rate: ``AMSampler`` on the
    state, fused_rng "auto" (K1f), WARMUP then TIMED sweeps as
    ``chip_smoke.py``, chain-sweeps per second."""
    import torch
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import fused
    from automix_tpu_torch.models.tutorial import tutorial_set
    ms = tutorial_set()
    out = {"ptxas": [f"{n} {r}, frame {f}, spills {st}/{ld}"
                     for n, r, f, st, ld in cs.ptxas_summary(lib, 3, 2)],
           "L": prop.lmax,
           "warps_per_sm": fused.occupancy(ms, prop.lmax, dev)}
    tabs = fused.prep_tables(prop, ms.dims)
    small = grown(ch, cs.K1_CHAINS)
    for rng in ("hash", "hw"):
        cs.exact_check(ms, tabs, cs.chunk_args(small), f"tutorial {rng}",
                       seed=5, sweep0=small.sweep, n_sweeps=20, adapt=True,
                       rng=rng)
    out["bitwise"] = True
    out["ms"] = sweep_forms(ms, prop, ch, dev, perm=False, pooled=False)
    am = AMSampler(ms, EngineConfig(
        n_chains=ch.n_chains, sweep_chunk=cs.SWEEP_CHUNK, seed=0,
        trace_chain0=False, n_trace_chains=1), device="cuda")
    am.set_proposal(prop)
    am.chains = ch
    am.rjmcmc_samples(cs.WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    am.rjmcmc_samples(cs.TIMED)
    torch.cuda.synchronize()
    out["main_path_chain_sweeps_per_s"] = \
        ch.n_chains * cs.TIMED / (time.perf_counter() - t0)
    out["sass"] = sass_sizes(lib).get("classes (3, 2)", [])
    return out


def k1c_part(ms, ch, prop, dev):
    """K1c with DDI's cache and K1e on DDI's chains and on them repeated to
    33792, ms per 100-sweep launch on each stream."""
    from automix_tpu_torch.kernels import fused
    tabs = fused.prep_tables(prop, ms.dims)
    out = {"L": prop.lmax,
           "k1c_capacity": fused.pooled_capacity(ms, prop.lmax, dev)}
    for S in (ch.n_chains, 33792):
        big = grown(ch, S)
        args = cs.chunk_args(big)
        for rng in ("hash", "hw"):
            for pooled, form in ((True, "K1c"), (False, "K1e")):
                out[f"{S} {form} {rng}"] = cs.cuda_ms(
                    lambda: fused.sweep_chunk(
                        ms, *args, tabs, seed=11, sweep0=big.sweep,
                        n_sweeps=cs.TIME_SWEEPS, adapt=True, pooled=pooled,
                        rng=rng), 3)
    return out


def k2_part(lib, dev):
    """K2's ms per 100-sweep segment at each of SEGMENTS, and the stage-1
    kernels' registers at their shapes."""
    from automix_tpu_torch.kernels import fused_stage1
    out = {"ms": {}, "registers": {}}
    for name, setname, C, rule in SEGMENTS:
        ms = model_set(setname)
        theta, sig, zi = cs.stage1_start(ms, C, dev)
        out["ms"][f"{name} {ms.nmodels} x {C}"] = cs.cuda_ms(
            lambda: fused_stage1.segment(
                ms, theta, sig, zi, zi, C=C, sweep0=0, seed=777, nburn=50,
                n_active=100, rule=rule, log_gain=3.0), 10)
        out["registers"][f"({ms.nmodels}, {ms.dmax})"] = [
            f"{n} {r}, frame {f}, spills {st}/{ld}"
            for n, r, f, st, ld in cs.ptxas_summary(lib, ms.nmodels, ms.dmax)
            if n.startswith("fused_stage1_kernel")]
    return out


def stage1_part(dev):
    """Seconds of stage 1 of each of STAGE1_PATHS on each route it fits."""
    import torch
    from automix_tpu_torch import EngineConfig
    from automix_tpu_torch.kernels import fused_stage1
    from automix_tpu_torch.ops import randoms
    out = {}
    for name, setname, C, nsweeps, rule in STAGE1_PATHS:
        ms = model_set(setname)
        cfg = EngineConfig(seed=0, n_chains_stage1=C, stage1_sweeps=nsweeps,
                           stage1_adapt=rule)
        init = ms.init_points(randoms.key(0))
        routes = [("K3", fused_stage1.run_fused_stage1_sweeps)]
        if ms.nmodels * C <= fused_stage1.segment_capacity(ms, dev):
            routes.insert(0, ("K2", fused_stage1.run_fused_stage1))
        for route, run in routes:
            run(ms, cfg, 20, C, init, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(ms, cfg, nsweeps, C, init, dev)
            torch.cuda.synchronize()
            out[f"{name} {ms.nmodels} x {C} {route}"] = \
                time.perf_counter() - t0
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_sweep_shapes: needs an NVIDIA GPU")
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.io import reports
    from automix_tpu_torch.kernels import _build, fused, fused_stage1
    from automix_tpu_torch.models import changepoint, ddi
    from automix_tpu_torch.models.rb9 import rb9_set
    from automix_tpu_torch.models.tutorial import tutorial_set
    from automix_tpu_torch.ops import randoms
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", required=True)
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--sets", default=",".join(SETS))
    opts = ap.parse_args()
    parts, sets = opts.parts.split(","), opts.sets.split(",")
    if not set(parts) <= set(PARTS):
        sys.exit(f"time_sweep_shapes: --parts takes some of {PARTS}")
    if not set(sets) <= set(SETS):
        sys.exit(f"time_sweep_shapes: --sets takes some of {SETS}")
    os.makedirs(opts.state, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    print(lib, flush=True)
    dev = torch.device("cuda", 0)
    path = lambda name: os.path.join(opts.state, name)  # noqa: E731

    def fit(ms, **cfg):
        am = AMSampler(ms, EngineConfig(**cfg), device="cuda")
        am.estimate_conditional_probs()
        return am

    def cpt_run(name):
        am = fit(getattr(changepoint, f"{name}_set")(), **cs.cpt_config(name))
        reports.report_cond_prob_estimation(path(name), am)
        am.burn_samples(cs.CPT_BURN)
        am.rjmcmc_samples(cs.CPT_TIMED)
        return am

    def rb9_run():
        fitted = fit(rb9_set(), n_chains_stage1=cs.RB9_C_STAGE1,
                     stage1_sweeps=cs.STAGE1_SWEEPS,
                     max_mix_comps=cs.RB9_MAX_MIX, seed=0)
        reports.report_cond_prob_estimation(path("rb9"), fitted)
        prop = fitted.proposal
        am = AMSampler(rb9_set(), EngineConfig(
            n_chains=cs.N_CHAINS, seed=7, trace_chain0=False), device="cuda")
        am.set_proposal(prop)
        am.burn_samples(200)
        return am

    def tutorial_run():
        am = fit(tutorial_set(), n_chains=cs.N_CHAINS,
                 n_chains_stage1=cs.N_CHAINS_STAGE1,
                 stage1_sweeps=cs.STAGE1_SWEEPS, sweep_chunk=cs.SWEEP_CHUNK,
                 seed=0, trace_chain0=False, n_trace_chains=1)
        am.burn_samples(cs.BURN)
        return am

    def ddi_run():
        am = fit(ddi.ddi_set(), n_chains=cs.DDI_CHAINS,
                 n_chains_stage1=cs.DDI_C_STAGE1,
                 stage1_sweeps=cs.DDI_STAGE1_SWEEPS, sweep_chunk=cs.DDI_CHUNK,
                 seed=0, trace_chain0=False, n_trace_chains=1)
        am.burn_samples(cs.DDI_BURN)
        return am

    out = {"build_s": build_s}
    if "sass" in parts:
        out["sass"] = sass_hashes(lib)
    if "pooled_run" in parts:
        out["pooled_run"] = pooled_run(
            saved(path("rb9.pt"), rb9_run)[1])
    if "tutorial" in parts:
        out["tutorial"] = tutorial_part(
            lib, *saved(path("tutorial.pt"), tutorial_run), dev)
    if "k1c" in parts:
        out["k1c_ms"] = k1c_part(ddi.ddi_set(),
                                 *saved(path("ddi.pt"), ddi_run), dev)
    if "k2" in parts:
        out["k2"] = k2_part(lib, dev)
    if "stage1" in parts:
        out["stage1_s"] = stage1_part(dev)
    if "toy" in parts:
        out["toy"] = toy_part(lib, path, dev)
    if "k3" in parts:
        out["k3"] = k3_part(dev)
    if "sweep" not in parts and "scan" not in parts:
        print(json.dumps(out), flush=True)
        return

    t0 = time.perf_counter()
    makers = {"cpt": lambda: cpt_run("cpt"), "cptrs": lambda: cpt_run("cptrs"),
              "rb9": rb9_run, "tutorial": tutorial_run, "ddi": ddi_run}
    states = {name: (model_set(name),
                     *saved(path(f"{name}.pt"), makers[name]))
              for name in SETS if name in sets}
    made = time.perf_counter() - t0
    if "scan" in parts:
        out["scan_ms"] = scan_part(states, dev)
    if "sweep" not in parts:
        print(json.dumps(out), flush=True)
        return

    out.update({"registers": {}, "warps_per_sm": {}, "k1c_capacity": {},
                "L": {}, "ms": {}})
    for name, (ms, ch, prop) in states.items():
        K, D = ms.nmodels, ms.dmax
        out["registers"][f"({K}, {D})"] = [
            f"{n} {r}, frame {f}, spills {st}/{ld}"
            for n, r, f, st, ld in cs.ptxas_summary(lib, K, D)]
        out["L"][name] = prop.lmax
        out["warps_per_sm"][name] = fused.occupancy(ms, prop.lmax, dev)
        if name in ("cpt", "cptrs", "rb9"):
            out["k1c_capacity"][name] = fused.pooled_capacity(
                ms, prop.lmax, dev)
    large = [name for name in ("cpt", "cptrs", "rb9") if name in states]
    for name in large:
        ms, ch, prop = states[name]
        for S in SIZES:
            for form, ms_ in sweep_forms(ms, prop, grown(ch, S),
                                         dev).items():
                out["ms"][f"{name} {S} {form}"] = ms_
    if "tutorial" in states:
        ms, ch, prop = states["tutorial"]
        for form, ms_ in sweep_forms(ms, prop, ch, dev, perm=False,
                                     pooled=False).items():
            out["ms"][f"tutorial {ch.n_chains} {form}"] = ms_
    if "ddi" in states:
        ms, ch, prop = states["ddi"]
        for form, ms_ in sweep_forms(ms, prop, ch, dev,
                                     pooled=False).items():
            out["ms"][f"ddi {ch.n_chains} K1e {form}"] = ms_

    if "cpt" in states:
        cpt = states["cpt"][0]
        theta, sig, zi = cs.stage1_start(cpt, cs.CPT_C_K2, dev)
        out["ms"]["cpt K2-log 6 x 512 x 100 sweeps"] = cs.cuda_ms(
            lambda: fused_stage1.segment(
                cpt, theta, sig, zi, zi, C=cs.CPT_C_K2, sweep0=0, seed=777,
                nburn=50, n_active=100, rule="log", log_gain=3.0), 10)
        init = cpt.init_points(randoms.key(0))
        n = cs.CPT_ROUTE_SWEEPS + cs.CPT_ROUTE_SWEEPS // 10
        out["ms"]["cpt K3 + log route 6 x 1024, per sweep"] = cs.cuda_ms(
            lambda: fused_stage1.run_fused_stage1_sweeps(
                cpt, EngineConfig(seed=5, stage1_adapt="log"),
                cs.CPT_ROUTE_SWEEPS, cs.CPT_C_STAGE1, init, dev), 3) / n

    out["model_changes_per_chain_sweep"] = {
        name: model_changes(states[name][0], states[name][2],
                            grown(states[name][1], SIZES[0]))
        for name in large}
    out["cli_s"] = {name: cli_seconds(name, path(name))
                    for name in ("cpt", "cptrs") if name in states}
    if "rb9" in states:
        out["cli_s"]["rb9"] = cli_seconds("rb9", path("rb9"), cs.CLI_SWEEPS)
    out["sass_instructions"] = sass_sizes(lib)
    out["states_made_s"] = made
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
