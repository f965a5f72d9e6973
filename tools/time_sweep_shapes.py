#!/usr/bin/env python3
"""Time every form of the stage-3 sweep kernel at the change-point (6, 13)
and rb9 (10, 5) shapes on one NVIDIA GPU, beside the main path's (3, 2),
DDI's cached form K1e at (2, 16) and the change-point stage-1 kernels, to
compare two versions of the kernel sources.

Makes the states of ``chip_smoke.py``'s checks with its own functions and
configurations: cpt's and cptrs' ``AMSampler`` runs (JAX's change-point
configuration, 16384 chains on K1c, 1500 burn-in and 10000 sweeps, cptrs
fitted at lmax 10), rb9's fit with
131072 chains after 200 burn-in sweeps (as ``tools/time_rb9_sweeps.py``),
the tutorial main path's fit with 131072 chains after 1000 burn-in sweeps,
DDI's run as ``tools/time_k1e_k4.py``, and the proposals (``_mix.data``)
of cpt and cptrs that the CLI reads.  Then it times, in milliseconds per
launch of 100 sweeps with pk adapting (CUDA events):

* at (6, 13) (cpt, cptrs) and (10, 5) (rb9), at 16384 and 131072 chains
  (a state of 16384 repeated): K1 and K1 + perm on the hash, K1f and K1f + perm (hw), K1c
  and K1f pooled where the population is resident (``pooled_capacity``),
  and the K1d runner (one launch a sweep, ms per sweep) on both streams;
* the tutorial's K1f and K1 at 131072 chains, DDI's K1e at 16384 on both
  streams with and without perm;
* K2-log (one 100-sweep segment of 6 x 512 cpt chains) and the K3 + log
  route (6 x 1024, ms per stage-1 sweep) from cpt's start points;
* the CLI in mode 1 on cpt and cptrs at ``chip_smoke.py``'s size (131072
  chains, burn-in 10000 and 10000 sweeps), in seconds;

and reads each shape's registers (``ptxas -v``), the sweep kernel's SASS
instructions per form (``cuobjdump -sass``), the per-chain kernel's
resident warps per SM, K1c's capacity, and how often a chain's model
changes per sweep on cpt, cptrs and rb9 (100 one-sweep launches on the
hash).
The script imports the port from the checkout it lies in and builds its
kernels there, so two checkouts are compared by running each one's copy
in turn on one machine (parent, change, change, parent); ``--state DIR``
keeps the states and proposals there, made by the first run, so that
every copy times the same chains:

    python3 tools/time_sweep_shapes.py --state DIR

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import contextlib
import dataclasses
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


def grown(ch, S):
    """The first S chains of ``ch``, repeated where it has fewer."""
    import torch
    from automix_tpu_torch.state import Chains
    reps = -(-S // ch.n_chains)
    return Chains(**{f: v if f == "sweep" else torch.cat([v] * reps)[:S]
                     for f, v in dataclasses.asdict(ch).items()})


def sweep_forms(ms, prop, ch, dev, perm=True, pooled=True):
    """ms per 100-sweep launch of each per-chain form on ``ch`` (with
    ``perm``, the perm variants too) and, with ``pooled``, of each pooled
    form where the population is resident, and ms per sweep of the K1d
    runner."""
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
            lambda: fused.pooled_sweeps(ms, ch, tabs, 20, seed=17, rng=rng),
            2) / 20
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


def sass_sizes(lib_path):
    """Instructions of each compiled form of the sweep kernel in the
    library's SASS (one ``cuobjdump -sass``), by "(K, D)": a list of
    (kernel and its bool template argument, instructions) in the
    library's order; empty where the toolkit has no cuobjdump."""
    import re
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        m = re.search(r"fused_sweep_kernelILi(\d+)ELi(\d+)ELb([01])E",
                      block.split("\n", 1)[0])
        if m:
            out.setdefault(f"({m.group(1)}, {m.group(2)})", []).append(
                (f"fused_sweep_kernel<{m.group(3)}>", len(re.findall(
                    r"^\s+/\*[0-9a-f]{4,}\*/", block, re.M))))
    return out


def cli_seconds(name, mix_stem):
    """Seconds of the CLI in mode 1 on ``name`` from the proposal at
    ``mix_stem``_mix.data, at chip_smoke.py's size."""
    from automix_tpu_torch import cli
    with tempfile.TemporaryDirectory() as tmp:
        stem = os.path.join(tmp, name)
        shutil.copy(mix_stem + "_mix.data", stem + "_mix.data")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([name, "-m", "1", "--chains", str(cs.N_CHAINS),
                           "-N", str(cs.CPT_CLI_SWEEPS), "-s", "1", "-f",
                           stem])
        secs = time.perf_counter() - t0
    if rc != 0:
        sys.exit(f"time_sweep_shapes: the {name} CLI returned {rc}")
    return secs


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", required=True)
    opts = ap.parse_args()
    os.makedirs(opts.state, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = _build.build()
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
        prop = fit(rb9_set(), n_chains_stage1=cs.RB9_C_STAGE1,
                   stage1_sweeps=cs.STAGE1_SWEEPS,
                   max_mix_comps=cs.RB9_MAX_MIX, seed=0).proposal
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

    t0 = time.perf_counter()
    states = {name: (getattr(changepoint, f"{name}_set")(),
                     *saved(path(f"{name}.pt"), lambda: cpt_run(name)))
              for name in ("cpt", "cptrs")}
    states.update({
        "rb9": (rb9_set(), *saved(path("rb9.pt"), rb9_run)),
        "tutorial": (tutorial_set(),
                     *saved(path("tutorial.pt"), tutorial_run)),
        "ddi": (ddi.ddi_set(), *saved(path("ddi.pt"), ddi_run))})
    made = time.perf_counter() - t0

    out = {"registers": {}, "warps_per_sm": {}, "k1c_capacity": {},
           "L": {}, "ms": {}}
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
    for name in ("cpt", "cptrs", "rb9"):
        ms, ch, prop = states[name]
        for S in SIZES:
            for form, ms_ in sweep_forms(ms, prop, grown(ch, S),
                                         dev).items():
                out["ms"][f"{name} {S} {form}"] = ms_
    ms, ch, prop = states["tutorial"]
    for form, ms_ in sweep_forms(ms, prop, ch, dev, perm=False,
                                 pooled=False).items():
        out["ms"][f"tutorial {ch.n_chains} {form}"] = ms_
    ms, ch, prop = states["ddi"]
    for form, ms_ in sweep_forms(ms, prop, ch, dev, pooled=False).items():
        out["ms"][f"ddi {ch.n_chains} K1e {form}"] = ms_

    cpt = states["cpt"][0]
    theta, sig, zi = cs.stage1_start(cpt, cs.CPT_C_K2, dev)
    out["ms"]["cpt K2-log 6 x 512 x 100 sweeps"] = cs.cuda_ms(
        lambda: fused_stage1.segment(cpt, theta, sig, zi, zi, C=cs.CPT_C_K2,
                                     sweep0=0, seed=777, nburn=50,
                                     n_active=100, rule="log", log_gain=3.0),
        10)
    init = cpt.init_points(torch.Generator())
    n = cs.CPT_ROUTE_SWEEPS + cs.CPT_ROUTE_SWEEPS // 10
    out["ms"]["cpt K3 + log route 6 x 1024, per sweep"] = cs.cuda_ms(
        lambda: fused_stage1.run_fused_stage1_sweeps(
            cpt, EngineConfig(seed=5, stage1_adapt="log"),
            cs.CPT_ROUTE_SWEEPS, cs.CPT_C_STAGE1, init, dev), 3) / n

    out["model_changes_per_chain_sweep"] = {
        name: model_changes(states[name][0], states[name][2],
                            grown(states[name][1], SIZES[0]))
        for name in ("cpt", "cptrs", "rb9")}
    out["cli_s"] = {name: cli_seconds(name, path(name))
                    for name in ("cpt", "cptrs")}
    out["sass_instructions"] = sass_sizes(lib)
    out["states_made_s"] = made
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
