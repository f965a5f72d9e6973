"""The JAX package's own p(M) on toy2 with Student-t(5) perturbations at
the configuration of ``chip_smoke.py``'s Student-t phase, frozen for the
card run.

The phase runs toy2 from its own stage 1 (every chain at the origin,
between each model's modes at +5 and -5) with AutoRJ, one Normal per
model, then stage 3 from fresh chains.  A single Normal over two modes
10 apart mixes slowly, so after a run of this length p(M) need not sit
at the exact values; the card run is held to the JAX package's XLA
engine at the same configuration (``fused="off"``,
``fused_stage1="off"``; ``rng="auto"`` resolves to threefry for a
Student-t run).  This script runs it for three seeds on the CPU and
writes each seed's p(M), their mean and spread.

    JAX_PLATFORMS=cpu python3 tools/toy2_t_witness.py \\
        [--out tests/data/toy2_t_jax_reference.json]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# chip_smoke.py's Student-t configuration
CONFIG = dict(n_chains=16_384, n_chains_stage1=2048, stage1_sweeps=200,
              mix_fit="autorj", student_t_dof=5)
BURN, TIMED = 50, 300
SEEDS = (1, 2, 3)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from automix_tpu import AMSampler, EngineConfig
    from automix_tpu.kernels import sweep_rng
    from automix_tpu.models.toy import TOY2_MODEL_PROBS, toy2_set

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "toy2_t_jax_reference.json"))
    p.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    args = p.parse_args()
    runs = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        cfg = EngineConfig(**CONFIG, seed=seed, fused="off",
                           fused_stage1="off", sweep_chunk=100,
                           trace_chain0=False)
        assert sweep_rng.resolve_rng(cfg) == "threefry"
        am = AMSampler(toy2_set(), cfg)
        am.estimate_conditional_probs()
        am.burn_samples(BURN)
        probs = am.rjmcmc_samples(TIMED, collect=False).model_probs
        runs[str(seed)] = [float(x) for x in probs]
        print(f"seed {seed}: p(M) {np.round(probs, 4)}, max err from exact "
              f"{np.abs(probs - TOY2_MODEL_PROBS).max():.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    arr = np.array(list(runs.values()))
    out = {"config": dict(CONFIG, burn=BURN, timed=TIMED, fused="off",
                          fused_stage1="off", rng="threefry"),
           "runs": runs, "mean": arr.mean(0).tolist(),
           "spread": float((arr.max(0) - arr.min(0)).max())}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
