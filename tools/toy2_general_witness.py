"""The JAX package's own p(M) on toy2 at the configuration of
``chip_smoke.py``'s general-engine toy2 run, frozen for the card run.

toy2 starts every stage-1 chain at the origin, between its two modes
(+5 and -5 in every coordinate), so the stage-1 fit weights the modes of
the higher models far from 0.3 / 0.7, and over a run of a thousand
sweeps p(M) settles ~0.01 from the exact values in the JAX package as in
the port (``tools/toy2_general_drift.py``).  The card run is held to the
JAX package's XLA engine at the same configuration instead of only to
the exact values: this script runs it (``fused="off"``,
``fused_stage1="off"``, ``rng="fast"``) for three seeds on the CPU and
writes each seed's p(M), their mean and spread.

    JAX_PLATFORMS=cpu python3 tools/toy2_general_witness.py \\
        [--out tests/data/toy2_general_jax_reference.json]

About 70 s a seed on one CPU core.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# chip_smoke.py's general-engine toy2 configuration
CONFIG = dict(n_chains=16_384, n_chains_stage1=2048, stage1_sweeps=1000,
              max_mix_comps=10)
BURN, TIMED = 300, 1000
SEEDS = (1, 2, 3)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from automix_tpu import AMSampler, EngineConfig
    from automix_tpu.models.toy import TOY2_MODEL_PROBS, toy2_set

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "toy2_general_jax_reference.json"))
    args = p.parse_args()
    runs = {}
    for seed in SEEDS:
        t0 = time.perf_counter()
        am = AMSampler(toy2_set(), EngineConfig(
            **CONFIG, seed=seed, fused="off", fused_stage1="off",
            rng="fast", sweep_chunk=500, trace_chain0=False))
        am.estimate_conditional_probs()
        am.burn_samples(BURN)
        probs = am.rjmcmc_samples(TIMED, collect=False).model_probs
        runs[str(seed)] = [float(x) for x in probs]
        print(f"seed {seed}: p(M) {np.round(probs, 4)}, max err from exact "
              f"{np.abs(probs - TOY2_MODEL_PROBS).max():.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    arr = np.array(list(runs.values()))
    out = {"config": dict(CONFIG, burn=BURN, timed=TIMED, fused="off",
                          fused_stage1="off", rng="fast"),
           "runs": runs, "mean": arr.mean(0).tolist(),
           "spread": float((arr.max(0) - arr.min(0)).max())}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
