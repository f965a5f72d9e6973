"""toy2's p(M) on the general engine through a run: how far the visit
fractions sit from the exact 0.5 / 0.25 / 0.125 / 0.0625 / 0.0625 after
each 500 sweeps, for a given stage-1 length and seed.

toy2's models are two-mode mixtures (+5 and -5 in every coordinate) and
stage 1 starts every chain at the origin, so the stage-1 fit can weight
the modes of the higher models far from their 0.3 / 0.7.  This script
prints each model's fitted weights and means beside the trajectory of
p(M), to show whether an error comes from the fit or from the run's
length.  The set is toy2 with per-theta densities and no CUDA density,
so nothing here needs a kernel build.

    python3 tools/toy2_general_drift.py [--chains 16384] [--stage1 1000]
        [--seed 1] [--sweeps 3000] [--device cuda]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    from automix_tpu_torch import AMSampler, EngineConfig, Model, ModelSet
    from automix_tpu_torch.models import toy

    p = argparse.ArgumentParser()
    p.add_argument("--chains", type=int, default=16384)
    p.add_argument("--chains-stage1", type=int, default=2048)
    p.add_argument("--stage1", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--burn", type=int, default=300)
    p.add_argument("--sweeps", type=int, default=3000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    ms = ModelSet([Model(m.name, m.dim, init=m.init,
                         logp=(lambda th, f=m.logp_cols:
                               f(list(th.unbind(0)))))
                   for m in toy.toy2_set().models])
    exact = toy.TOY2_MODEL_PROBS
    t0 = time.perf_counter()
    am = AMSampler(ms, EngineConfig(
        n_chains=args.chains, n_chains_stage1=args.chains_stage1,
        stage1_sweeps=args.stage1, max_mix_comps=10, seed=args.seed,
        trace_chain0=False), device=args.device)
    am.estimate_conditional_probs()
    prop = am.proposal
    print(f"stage 1 of {args.stage1} sweeps, seed {args.seed}: stages 1-2 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k in range(ms.nmodels):
        lam = prop.lam[k].cpu().numpy()
        live = lam > 0
        print(f"  model {k + 1}: weights {np.round(lam[live], 3)}, first "
              f"coordinate of the means "
              f"{np.round(prop.mu[k, :, 0].cpu().numpy()[live], 2)}")
    am.burn_samples(args.burn)
    prev = np.zeros(ms.nmodels)
    for done in range(500, args.sweeps + 1, 500):
        stats = am.rjmcmc_samples(500)
        ks = stats.ksummary.astype(float)
        chunk = (ks - prev) / (ks - prev).sum()
        prev = ks.copy()
        err = np.abs(stats.model_probs - exact).max()
        print(f"  after {done} sweeps: max err {err:.4f}, p(M) "
              f"{np.round(stats.model_probs, 4)}, last 500 sweeps "
              f"{np.round(chunk, 4)}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
