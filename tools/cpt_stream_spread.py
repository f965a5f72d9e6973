"""Spread of the change-point posteriors across stage-3 streams and seeds.

``chip_smoke.py`` holds ``AMSampler`` on cpt and cptrs at the JAX
package's change-point configuration (pooled pk, 16384 chains, 1500
burn-in and 10000 timed sweeps) to the JAX package's p(M) and to each
other within the JAX test's atol 0.08.  cpt barely mixes (the EM's
Cholesky jitter inflates its rate scales, PERF.md section 6), so its p(M)
depends on the run's words.  This script fits each set's proposal once,
as ``chip_smoke.py`` does (cpt at seed 5, cptrs at seed 6), then runs
stage 3 from that proposal on each stream (``fused_rng`` "hash" and "hw")
at several stage-3 seeds, and prints each run's p(M), its largest distance
from the JAX mean (``tests/data/cpt_jax_reference.json``) and the largest
cpt - cptrs gap of each (stream, seed) pair (cptrs at the seed + 1, so
the first pair has ``chip_smoke.py``'s seeds), and per set each stream's
mean and spread over the seeds and the two streams' difference in
standard errors.

Run on a card from the repository's root (the build and ~2 minutes):

    python3 tools/cpt_stream_spread.py [--seeds 5 105 205] [--sets cpt]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch
    import chip_smoke as cs
    from automix_tpu_torch import AMSampler, EngineConfig
    from automix_tpu_torch.kernels import _build
    from automix_tpu_torch.models import changepoint

    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[5, 105, 205])
    p.add_argument("--sets", nargs="+", default=["cpt", "cptrs"],
                   choices=("cpt", "cptrs"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cpt_stream_spread: needs an NVIDIA GPU")
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.library()
    ref = json.load(open(os.path.join(ROOT, "tests", "data",
                                      "cpt_jax_reference.json")))
    probs = {}
    for name in args.sets:
        ms = getattr(changepoint, f"{name}_set")()
        am = AMSampler(ms, EngineConfig(**cs.cpt_config(name)),
                       device="cuda")
        am.estimate_conditional_probs()
        for rng in ("hash", "hw"):
            for seed in args.seeds:
                cfg = dict(cs.cpt_config(name), fused_rng=rng,
                           seed=seed + (name == "cptrs"))
                run = AMSampler(ms, EngineConfig(**cfg), device="cuda")
                run.set_proposal(am.proposal)
                run.burn_samples(cs.CPT_BURN)
                pm = np.asarray(run.rjmcmc_samples(cs.CPT_TIMED).model_probs)
                probs[name, rng, seed] = pm
                err = float(np.abs(pm - np.asarray(ref[name]["mean"])).max())
                print(f"{name} {rng} stage-3 seed {cfg['seed']}: p(M) "
                      f"{np.round(pm, 4).tolist()}, max distance from the "
                      f"JAX mean {err:.4f}", flush=True)
    for name in args.sets:
        runs = {rng: np.stack([probs[name, rng, s] for s in args.seeds])
                for rng in ("hash", "hw")}
        for rng, x in runs.items():
            print(f"{name} {rng} over {len(args.seeds)} seeds: mean "
                  f"{np.round(x.mean(0), 4).tolist()}, sd "
                  f"{np.round(x.std(0, ddof=1), 4).tolist()}")
        diff = runs["hw"].mean(0) - runs["hash"].mean(0)
        se = np.sqrt(runs["hw"].var(0, ddof=1) / len(args.seeds)
                     + runs["hash"].var(0, ddof=1) / len(args.seeds))
        print(f"{name} hw - hash means: {np.round(diff, 4).tolist()}, "
              f"in standard errors {np.round(diff / se, 2).tolist()}")
    if set(args.sets) == {"cpt", "cptrs"}:
        for rng in ("hash", "hw"):
            for seed in args.seeds:
                gap = np.abs(probs["cpt", rng, seed]
                             - probs["cptrs", rng, seed])
                print(f"|cpt - cptrs| {rng}, seed {seed}: max "
                      f"{gap.max():.4f} (model {int(gap.argmax())}; atol "
                      f"{cs.CPT_PAIR_ATOL})", flush=True)
    jgap = np.abs(np.asarray(ref["cpt"]["mean"])
                  - np.asarray(ref["cptrs"]["mean"]))
    print(f"|cpt - cptrs| of the JAX means: max {jgap.max():.4f}")


if __name__ == "__main__":
    main()
