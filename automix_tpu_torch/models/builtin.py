"""Built-in targets: the reference test-suite scenarios.

Counterpart of ``automix_tpu/models/builtin.py``: the three 1-D direct
samplers (``cols_*_sampler``), the Normal, Beta and Gamma likelihoods of a
fixed data set (``_make_params_targets_cols``) and the nine model sets
built from them.  The likelihoods reduce the data to five sufficient
statistics (n, s1 = sum x, s2 = sum x^2, sl = sum log x, sl1 = sum
log(1 - x)).  Every density evaluates in the same operation order as the
JAX column form, and gets a :class:`CudaDensity` whose kind id selects the
same formula in ``csrc/common.cuh``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from automix_tpu_torch.config import NEG_INF
from automix_tpu_torch.model import CudaDensity, Model, ModelSet
from automix_tpu_torch.ops.plmath import pal_gammaln

# Density kinds of csrc/common.cuh.
KIND_NORMAL_PARAMS = 1
KIND_BETA_PARAMS = 2
KIND_GAMMA_PARAMS = 3
KIND_NORMAL_SAMPLER = 4
KIND_TRUNCNORMAL_SAMPLER = 5
KIND_BETA_SAMPLER = 6

# Ten fixed observations shared by the parameter-estimation targets
# (automix_tpu/models/builtin.py DATA_SAMPLES).
DATA_SAMPLES = np.array([
    0.50613293, 0.70961096, 0.28166951, 0.12532996, 0.46374168,
    0.58337466, 0.52458217, 0.56052633, 0.57215576, 0.68698825,
])

# gammaln(4) - 2 * gammaln(2) = log 6, the Beta(2, 2) normalizer.
_LOG_BETA_2_2 = 1.791759469228055


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


# --- 1-D direct samplers -------------------------------------------------

def cols_normal_sampler(rows):
    """N(0.5, 1) up to a constant."""
    d = rows[0] - 0.5
    return -0.5 * (d * d)


def cols_truncnormal_sampler(rows):
    """N(1, 1) truncated to (0, 10)."""
    x = rows[0]
    d = x - 1.0
    lp = -0.5 * (d * d)
    return _where((x > 0.0) & (x < 10.0), lp, NEG_INF)


def cols_beta_sampler(rows):
    """Beta(2, 2)."""
    x = rows[0]
    inside = (x > 0.0) & (x < 1.0)
    xs = _where(inside, x, 0.5)
    lp = torch.log(xs) + torch.log1p(-xs) + _LOG_BETA_2_2
    return _where(inside, lp, NEG_INF)


_SAMPLER_CUDA = {
    "normal": CudaDensity(KIND_NORMAL_SAMPLER, ()),
    "truncnormal": CudaDensity(KIND_TRUNCNORMAL_SAMPLER, ()),
    "beta": CudaDensity(KIND_BETA_SAMPLER, (_LOG_BETA_2_2,)),
}


# --- the nine scenarios (model sets are immutable: one instance each) ------

@functools.cache
def normal_sampler_set() -> ModelSet:
    return ModelSet([Model("normal_sampler", 1, cols_normal_sampler,
                           init=np.array([0.5]),
                           cuda=_SAMPLER_CUDA["normal"])])


@functools.cache
def truncnormal_sampler_set() -> ModelSet:
    return ModelSet([Model("truncnormal_sampler", 1,
                           cols_truncnormal_sampler, init=np.array([1.0]),
                           cuda=_SAMPLER_CUDA["truncnormal"])])


@functools.cache
def beta_sampler_set() -> ModelSet:
    return ModelSet([Model("beta_sampler", 1, cols_beta_sampler,
                           init=np.array([0.5]),
                           cuda=_SAMPLER_CUDA["beta"])])


@functools.cache
def _params_models():
    """The Normal, Beta and Gamma likelihood models of DATA_SAMPLES with
    the reference's start points."""
    (normal, beta, gamma), (cu_n, cu_b, cu_g) = \
        make_params_targets_cols(DATA_SAMPLES)
    return {
        "normal": Model("normal_params", 2, normal,
                        init=np.array([0.5, 0.5]), cuda=cu_n),
        "beta": Model("beta_params", 2, beta, init=np.array([2.0, 2.0]),
                      cuda=cu_b),
        "gamma": Model("gamma_params", 2, gamma, init=np.array([9.0, 2.0]),
                       cuda=cu_g),
    }


@functools.cache
def normal_params_set() -> ModelSet:
    return ModelSet([_params_models()["normal"]])


@functools.cache
def beta_params_set() -> ModelSet:
    return ModelSet([_params_models()["beta"]])


@functools.cache
def gamma_params_set() -> ModelSet:
    return ModelSet([_params_models()["gamma"]])


@functools.cache
def gamma_beta_set() -> ModelSet:
    m = _params_models()
    return ModelSet([m["gamma"], m["beta"]])


@functools.cache
def normal_beta_set() -> ModelSet:
    m = _params_models()
    return ModelSet([m["normal"], m["beta"]])


@functools.cache
def normal_gamma_set() -> ModelSet:
    m = _params_models()
    return ModelSet([m["normal"], m["gamma"]])
