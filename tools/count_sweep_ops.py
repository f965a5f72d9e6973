"""Count the torch operations of one general-engine sweep on the CPU.

The general engine (``kernels/rjmcmc.py``) runs eagerly, one launch per
torch operation on the card, so its time per sweep there follows the
operation count more than the chain count.  This script counts, with a
``TorchDispatchMode``, the operations of one stage-3 sweep of the
tutorial (column densities), toy2 (column densities) and toy2 with
per-theta densities, and of the ``fast`` stream's draw alone, at 256
chains (the count does not depend on it).  Then the same for one
Student-t(5) sweep of toy2 per-theta on the threefry stream at the card
run's 16384 chains, where it does: the gamma's masked loop runs until
the last of the chains' draws accepts, and the script prints its rounds.

    python3 tools/count_sweep_ops.py
"""

import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from automix_tpu_torch import EngineConfig, Model, ModelSet
    from automix_tpu_torch.kernels import rjmcmc
    from automix_tpu_torch.models import toy, tutorial
    from automix_tpu_torch.ops import randoms
    from automix_tpu_torch.state import Proposal

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    def proposal(ms, L=2):
        K, D = ms.nmodels, ms.dmax
        B = torch.eye(D).repeat(K, L, 1, 1)
        return Proposal(lam=torch.full((K, L), 1.0 / L),
                        mu=torch.zeros(K, L, D), B=B,
                        logdetB=torch.zeros(K, L),
                        nmix=torch.full((K,), L, dtype=torch.int32),
                        sig=torch.ones(K, D))

    per_theta = ModelSet([Model(m.name, m.dim, init=m.init,
                                logp=(lambda th, f=m.logp_cols:
                                      f(list(th.unbind(0)))))
                          for m in toy.toy2_set().models])
    for name, ms in (("tutorial", tutorial.tutorial_set()),
                     ("toy2", toy.toy2_set()),
                     ("toy2 per-theta", per_theta)):
        cfg = EngineConfig(n_chains=256, fused="off", seed=1)
        chains = rjmcmc.init_chains(ms, cfg, randoms.key(0), "cpu")
        chains.sweep = 3              # a componentwise sweep
        prop = proposal(ms)
        tables = rjmcmc.precompute_tables(prop, np.asarray(ms.dims))
        sweep = rjmcmc.build_sweep_all(ms, cfg, False, "fast")
        with Count() as total:
            sweep(chains, prop, tables)
        _, mu, mz = rjmcmc.rand_slots(ms.dmax, 2, ms.nmodels)
        with Count() as draw:
            randoms.fast_sweep_randoms(1, 3, 0, 256, mu, mz)
        with Count() as dens:
            ms.logpost_batch(chains.k.long(), chains.theta)
        print(f"{name}: {sum(total.ops.values())} operations per sweep, "
              f"{sum(draw.ops.values())} of them the fast draw, "
              f"{sum(dens.ops.values())} per logpost_batch of every "
              f"model; most frequent {total.ops.most_common(5)}")

    # Student-t(5) on threefry: the gamma's outer rounds counted by its
    # uniform U, drawn once a round
    cfg = EngineConfig(n_chains=16_384, fused="off", seed=1,
                       student_t_dof=5)
    chains = rjmcmc.init_chains(per_theta, cfg, randoms.key(0), "cpu")
    chains.sweep = 3
    prop = proposal(per_theta)
    tables = rjmcmc.precompute_tables(prop, np.asarray(per_theta.dims))
    sweep = rjmcmc.build_sweep_all(per_theta, cfg, False, "threefry")
    rounds = []
    gamma_one, u_of_bits = randoms._gamma_one, randoms.uniform_of_bits

    def counted_gamma(keys, alpha):
        rounds.append(0)
        return gamma_one(keys, alpha)

    def counted_u(bits, *args):
        if rounds:
            rounds[-1] += 1
        return u_of_bits(bits, *args)

    randoms._gamma_one, randoms.uniform_of_bits = counted_gamma, counted_u
    try:
        with Count() as total:
            sweep(chains, prop, tables)
    finally:
        randoms._gamma_one, randoms.uniform_of_bits = gamma_one, u_of_bits
    print(f"toy2 per-theta, Student-t(5), threefry, 16384 chains: "
          f"{sum(total.ops.values())} operations per sweep; the gamma's "
          f"rounds {rounds} ({sum(rounds)} in all)")


if __name__ == "__main__":
    main()
