#!/usr/bin/env python3
"""The JAX package's CLI on cpt from the port's own proposal.

``chip_smoke.py`` runs the port's CLI on cpt in mode 1 (per-chain pk,
perm, ``-N 10000`` after 10000 burn-in sweeps) from the ``_mix.data`` of
its cpt ``AMSampler`` run.  cpt's fitted proposals barely mix (the EM's
Cholesky jitter inflates the rate scales), so that p(M) depends on the
proposal and the run's length, and the JAX runs at the change-point test
configuration (``tests/data/cpt_jax_reference.json``) do not bound it.
This script gives it a witness in two steps:

    python3 tools/cpt_cli_witness.py mix OUT        # on the card
    JAX_PLATFORMS=cpu python3 tools/cpt_cli_witness.py jax [--seeds 1 2 3] \
        [--chains 1024] [--jobs 3]

``mix`` runs stages 1-2 of ``chip_smoke.py``'s cpt ``AMSampler`` run with
the port (``chip_smoke.cpt_config``) and writes its proposal to ``OUT``;
copy it to ``tests/data/cpt_port_mix.data``.  ``jax`` runs the JAX
package's CLI in mode 1 from that file on the CPU, with the port CLI's
sweeps, pk and perm at a reduced chain count, one single-threaded process
per seed, and writes ``tests/data/cpt_cli_witness.json``: the p(M) of
every run, their mean and spread (the largest distance of a run from the
mean, per model), the file's sha256, the command and the commit.
``chip_smoke.py`` reads the JSON; it never runs JAX.  A run of 1024
chains x 20000 sweeps takes about 45 minutes on one CPU core.
"""

import argparse
import concurrent.futures
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MIX = os.path.join(ROOT, "tests", "data", "cpt_port_mix.data")
OUT = os.path.join(ROOT, "tests", "data", "cpt_cli_witness.json")


def make_mix(path):
    """Stages 1-2 of chip_smoke.py's cpt run on the card; the proposal to
    ``path``."""
    import chip_smoke
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.io import reports
    from automix_tpu_torch.models import changepoint
    am = AMSampler(changepoint.cpt_set(),
                   EngineConfig(**chip_smoke.cpt_config("cpt")),
                   device="cuda")
    am.estimate_conditional_probs()
    with tempfile.TemporaryDirectory() as tmp:
        reports.report_cond_prob_estimation(os.path.join(tmp, "cpt"), am)
        shutil.copy(os.path.join(tmp, "cpt_mix.data"), path)
    print(f"L per model {am.proposal.nmix.tolist()}; wrote {path}")


def run(seed, chains):
    """p(M) of one JAX CLI run from MIX and its seconds, on the CPU."""
    os.environ["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import chip_smoke
    import jax
    jax.config.update("jax_platforms", "cpu")
    from automix_tpu import cli
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(MIX, os.path.join(tmp, "cpt_mix.data"))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["cpt", "-m", "1", "--chains", str(chains), "-N",
                      str(chip_smoke.CPT_CLI_SWEEPS), "-s", str(seed),
                      "-f", os.path.join(tmp, "cpt"), "--platform", "cpu",
                      "--trace-every", "16", "--no-reports"])
    return chip_smoke.probs_of(buf.getvalue()), time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="step", required=True)
    sub.add_parser("mix").add_argument("out")
    jp = sub.add_parser("jax")
    jp.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    jp.add_argument("--chains", type=int, default=1024)
    jp.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args()
    if args.step == "mix":
        make_mix(args.out)
        return
    import jax
    import numpy as np
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    with open(MIX, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    runs = []
    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        todo = {ex.submit(run, seed, args.chains): seed
                for seed in args.seeds}
        for fut in concurrent.futures.as_completed(todo):
            p, secs = fut.result()
            print(f"seed {todo[fut]}: p(M) = {[round(x, 4) for x in p]} "
                  f"({secs:.1f} s)", flush=True)
            runs.append({"seed": todo[fut], "p": p,
                         "seconds": round(secs, 1)})
    runs.sort(key=lambda r: r["seed"])
    p = np.asarray([r["p"] for r in runs])
    out = {"_comment": [
        "p(M) of the JAX package's CLI (automix_tpu.cli) on cpt in mode 1",
        "from tests/data/cpt_port_mix.data, the port's proposal of",
        "chip_smoke.py's cpt AMSampler run, on the CPU at a reduced chain",
        "count; spread is the largest distance of a run from the mean,",
        "per model.  Written by tools/cpt_cli_witness.py."],
        "command": "JAX_PLATFORMS=cpu python3 tools/cpt_cli_witness.py "
                   + " ".join(sys.argv[1:]),
        "commit": commit, "jax": jax.__version__, "mix_sha256": sha,
        "chains": args.chains, "runs": runs, "mean": p.mean(0).tolist(),
        "spread": np.abs(p - p.mean(0)).max(0).tolist()}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
