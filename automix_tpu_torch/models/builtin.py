"""Built-in column densities: Normal, Beta and Gamma likelihoods of a
fixed data set.

Counterpart of ``_make_params_targets_cols`` in
``automix_tpu/models/builtin.py``.  Each density reduces the data to five
sufficient statistics (n, s1 = sum x, s2 = sum x^2, sl = sum log x,
sl1 = sum log(1 - x)) and evaluates in the same operation order as the
JAX column forms.  Each also gets a :class:`CudaDensity` whose kind id
selects the same formula in ``csrc/common.cuh`` (``density_normal``,
``density_beta``, ``density_gamma``).
"""

from __future__ import annotations

import numpy as np
import torch

from automix_tpu_torch.config import NEG_INF
from automix_tpu_torch.model import CudaDensity
from automix_tpu_torch.ops.plmath import pal_gammaln

# Density kinds of csrc/common.cuh.
KIND_NORMAL_PARAMS = 1
KIND_BETA_PARAMS = 2
KIND_GAMMA_PARAMS = 3


def _where(ok, x, other: float):
    return torch.where(ok, x, torch.full_like(x, other))


def make_params_targets_cols(data):
    """((cols_normal, cols_beta, cols_gamma), their CudaDensity tuple) for
    the data: theta = (sigma, x0), (alpha, beta) and (alpha, beta)."""
    d = np.asarray(data, np.float64)
    n = float(d.shape[0])
    s1 = float(d.sum())
    s2 = float((d * d).sum())
    sl = float(np.log(d).sum())
    sl1 = float(np.log1p(-d).sum())
    consts = (n, s1, s2, sl, sl1)

    def cols_normal(rows):
        sigma, x0 = rows[0], rows[1]
        ok = sigma > 0.0
        ssafe = _where(ok, sigma, 1.0)
        ss = -(s2 - 2.0 * x0 * s1 + n * x0 * x0)
        lp = -n * torch.log(ssafe) + ss / (2.0 * ssafe * ssafe)
        return _where(ok, lp, NEG_INF)

    def cols_beta(rows):
        a, b = rows[0], rows[1]
        ok = (a > 0.0) & (b > 0.0)
        asafe = _where(ok, a, 1.0)
        bsafe = _where(ok, b, 1.0)
        lp = (asafe - 1.0) * sl + (bsafe - 1.0) * sl1 + n * (
            pal_gammaln(asafe + bsafe) - pal_gammaln(asafe)
            - pal_gammaln(bsafe))
        return _where(ok, lp, NEG_INF)

    def cols_gamma(rows):
        a, b = rows[0], rows[1]
        ok = (a > 0.0) & (b > 0.0)
        asafe = _where(ok, a, 1.0)
        bsafe = _where(ok, b, 1.0)
        lp = (asafe - 1.0) * sl - bsafe * s1 + n * (
            asafe * torch.log(bsafe) - pal_gammaln(asafe))
        return _where(ok, lp, NEG_INF)

    cuda = (CudaDensity(KIND_NORMAL_PARAMS, consts),
            CudaDensity(KIND_BETA_PARAMS, consts),
            CudaDensity(KIND_GAMMA_PARAMS, consts))
    return (cols_normal, cols_beta, cols_gamma), cuda
