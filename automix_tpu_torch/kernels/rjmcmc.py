"""Stage-3 chain initialization.

Counterpart of ``init_chains`` in ``automix_tpu/kernels/rjmcmc.py``.  The
XLA sweep engine of that module is not ported: the port has one engine,
the fused sweep kernel (``kernels/fused.py``).
"""

from __future__ import annotations

import torch

from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.state import Chains


def init_chains(modelset, cfg: EngineConfig, generator: torch.Generator,
                device, n_chains: int | None = None) -> Chains:
    """Chain batch at the start of stage 3: model index uniform, theta at
    the chosen model's stage-1 start point, pk uniform, pkllim 0.1,
    nreinit 1 and the sweep counter at 1.

    logp comes from the column densities (``ModelSet.logpost_cols``),
    where the JAX function evaluates the scalar ``logp`` with ``gammaln``;
    the two agree to float32 rounding at the start points."""
    S = n_chains or cfg.n_chains
    K = modelset.nmodels
    k0 = torch.randint(0, K, (S,), generator=generator, dtype=torch.int64)
    init_theta = modelset.init_points(generator)             # [K, D]
    theta0 = init_theta[k0]
    logp0 = modelset.logpost_cols(k0, list(theta0.T))
    f32 = torch.float32
    return Chains(
        k=k0.to(torch.int32).to(device),
        theta=theta0.to(device),
        logp=logp0.to(device),
        pk=torch.full((S, K), 1.0 / K, dtype=f32, device=device),
        pkllim=torch.full((S,), 0.1, dtype=f32, device=device),
        nreinit=torch.ones((S,), dtype=torch.int32, device=device),
        sweep=1,
    )
