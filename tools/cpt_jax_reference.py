#!/usr/bin/env python3
"""Freeze the JAX package's change-point posterior as a fixture.

The reference C binaries ``amcpt`` and ``amcptrs`` segfault
(``automix_tpu/models/changepoint.py:24-28``), so the change-point
families have no C posterior oracle.  This script runs the JAX package's
``AMSampler`` on the CPU at the change-point configuration of
``tests/test_heavy_models.py`` (``_run_changepoint``: 1024 chains, 1024
stage-1 chains per model, 2500 stage-1 sweeps, 500-sweep chunks, pooled
pk, the log stage-1 rule, 1500 burn-in and 6000 sweeps) for cpt and
cptrs, one run per seed, and writes ``tests/data/cpt_jax_reference.json``:
per set the p(M) of every run, their mean and spread (the largest
distance of a run from the mean, per model), the seeds, the command and
the commit it ran on.  ``chip_smoke.py`` reads the file; it never runs
JAX.  The file is rewritten after every run, so a cut run keeps what it
finished.

    JAX_PLATFORMS=cpu python3 tools/cpt_jax_reference.py [--seeds 5 6 7] \
        [--jobs 6]

Each run takes tens of minutes on the CPU; ``--jobs`` runs that many at
once, each in its own single-threaded process.
"""

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "cpt_jax_reference.json")

# tests/test_heavy_models.py _run_changepoint
CONFIG = dict(n_chains=1024, n_chains_stage1=1024, stage1_sweeps=2500,
              sweep_chunk=500, trace_chain0=False, pk_mode="pooled",
              stage1_adapt="log")
BURN, SWEEPS = 1500, 6000


def run(set_name, seed):
    """p(M) of one run and its seconds, in a fresh process on the CPU."""
    os.environ["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from automix_tpu.config import EngineConfig
    from automix_tpu.models import changepoint
    from automix_tpu.sampler import AMSampler
    ms = getattr(changepoint, f"{set_name}_set")()
    am = AMSampler(ms, EngineConfig(seed=seed, **CONFIG))
    t0 = time.perf_counter()
    am.burn_samples(BURN)
    stats = am.rjmcmc_samples(SWEEPS)
    return [float(p) for p in stats.model_probs], time.perf_counter() - t0


def summary(runs):
    import numpy as np
    p = np.asarray([r["p"] for r in runs])
    mean = p.mean(0)
    return {"runs": runs, "mean": mean.tolist(),
            "spread": np.abs(p - mean).max(0).tolist()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7])
    ap.add_argument("--sets", nargs="+", default=["cpt", "cptrs"])
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args()
    import jax
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = {"_comment": [
        "p(M) of the JAX package (automix_tpu) on the CPU at the",
        "change-point configuration of tests/test_heavy_models.py",
        "(_run_changepoint), one run per seed; spread is the largest",
        "distance of a run from the mean, per model.  Written by",
        "tools/cpt_jax_reference.py."],
        "command": "JAX_PLATFORMS=cpu python3 tools/cpt_jax_reference.py "
                   + " ".join(sys.argv[1:]),
        "commit": commit, "jax": jax.__version__,
        "config": dict(CONFIG, burn=BURN, sweeps=SWEEPS)}
    runs = {name: [] for name in args.sets}
    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        todo = {ex.submit(run, name, seed): (name, seed)
                for name in args.sets for seed in args.seeds}
        for fut in concurrent.futures.as_completed(todo):
            name, seed = todo[fut]
            p, secs = fut.result()
            print(f"{name} seed {seed}: p(M) = {[round(x, 4) for x in p]} "
                  f"({secs:.1f} s)", flush=True)
            runs[name].append({"seed": seed, "p": p,
                               "seconds": round(secs, 1)})
            for n, r in runs.items():
                if r:
                    out[n] = summary(sorted(r, key=lambda x: x["seed"]))
            with open(OUT, "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")


if __name__ == "__main__":
    main()
