"""Toy examples with exact model posteriors.

Counterpart of ``automix_tpu/models/toy.py``: ``toy1`` (a 1-D and a 2-D
Normal mixture with model priors 0.3 / 0.7) and ``toy2`` (five models of
dims 1..5, each a two-component isotropic mixture with geometric model
weights).  The per-model densities are normalized, so the exact model
posteriors are the weights.  The column forms follow the JAX
``_mixture_cols`` and toy2 ``logp_cols`` operation by operation; constants
are folded in float64 on the host and rounded once to float32, as JAX
folds them.  ``logaddexp`` is ``max + log1p(exp(-|a - b|))``, as in
``jnp.logaddexp`` and in ``csrc/common.cuh``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from automix_tpu_torch.model import CudaDensity, Model, ModelSet

_LOG_2PI = 1.8378770664093453

# Density kinds of csrc/common.cuh.
KIND_MIXTURE = 7
KIND_TOY2 = 8

TOY1_MODEL_PROBS = np.array([0.3, 0.7])
TOY2_MODEL_PROBS = np.array([0.5, 0.25, 0.125, 0.0625, 0.0625])


def logaddexp(a, b):
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def _mixture(weights, mus, Bs, log_prior):
    """(column density, CudaDensity) of sum_l w_l N(mu_l, B_l B_l^T) plus
    ``log_prior``, for lower-triangular factors B_l.

    The CUDA constants are [L, then per component: const_l, mu_l (d),
    the strict lower rows of B_l row by row, 1 / B_l[i, i] (d)]."""
    w = np.asarray(weights, np.float64)
    mu = np.asarray(mus, np.float64)          # [L, d]
    B = np.asarray(Bs, np.float64)            # [L, d, d]
    L, d = mu.shape
    logdet = np.log(np.abs(np.diagonal(B, axis1=-2, axis2=-1))).sum(-1)
    const = np.log(w) - 0.5 * d * _LOG_2PI - logdet + log_prior
    f32 = lambda x: float(np.float32(x))  # noqa: E731

    def cols(rows):
        out = None
        for li in range(L):
            quad = None
            work = []
            for i in range(d):
                resid = rows[i] - f32(mu[li, i])
                for j in range(i):
                    resid = resid - f32(B[li, i, j]) * work[j]
                wi = resid * f32(1.0 / B[li, i, i])
                work.append(wi)
                quad = wi * wi if quad is None else quad + wi * wi
            comp = f32(const[li]) - 0.5 * quad
            out = comp if out is None else logaddexp(out, comp)
        return out

    consts = [float(L)]
    for li in range(L):
        consts += [const[li], *mu[li]]
        for i in range(d):
            consts += [*B[li, i, :i], 1.0 / B[li, i, i]]
    return cols, CudaDensity(KIND_MIXTURE, tuple(consts))


@functools.cache
def toy1_set() -> ModelSet:
    """usertoy1: model 0 a 1-D 2-component mixture (prior 0.3), model 1 a
    2-D 3-component mixture with correlations (prior 0.7).  No start
    points: stage 1 starts from uniform [0, 1) draws."""
    m0 = ([0.2, 0.8], [[-3.0], [2.0]], [[[2.0]], [[1.0]]])
    m1 = ([1 / 3, 1 / 3, 1 / 3], [[0.0, 3.0], [-4.0, 1.0], [4.0, 1.0]],
          [[[2.0, 0.0], [0.0, 0.7071068]],
           [[1.414214, 0.0], [1.060660, 0.9354143]],
           [[1.414214, 0.0], [-1.060660, 0.9354143]]])
    models = []
    for k, (spec, prior) in enumerate(((m0, 0.3), (m1, 0.7))):
        cols, cuda = _mixture(*spec, np.log(prior))
        lik, _ = _mixture(*spec, 0.0)
        models.append(Model(f"toy1_k{k + 1}", k + 1, cols, cuda=cuda,
                            loglik=lik))
    return ModelSet(models)


def _toy2_model(k: int) -> Model:
    """Model k of toy2: dim k + 1, 0.3 N(+5, I) + 0.7 N(-5, 4 I), model
    weight TOY2_MODEL_PROBS[k]."""
    d = k + 1
    half_d_log2pi = 0.5 * d * _LOG_2PI
    d_log2 = d * float(np.log(2.0))
    log3, log7 = float(np.log(0.3)), float(np.log(0.7))
    log_w = float(np.log(TOY2_MODEL_PROBS[k]))

    def cols(rows):
        q1 = None
        q2 = None
        for i in range(d):
            a = rows[i] - 5.0
            b = rows[i] + 5.0
            q1 = a * a if q1 is None else q1 + a * a
            q2 = b * b if q2 is None else q2 + b * b
        c1 = -0.5 * q1 - half_d_log2pi + log3
        c2 = -0.125 * q2 - half_d_log2pi - d_log2 + log7
        return logaddexp(c1, c2) + log_w

    cuda = CudaDensity(KIND_TOY2, (half_d_log2pi, log3, d_log2, log7, log_w))
    return Model(f"toy2_k{d}", d, cols, init=np.zeros(d), cuda=cuda)


@functools.cache
def toy2_set() -> ModelSet:
    """usertoy2: 5 models of dims 1..5, started at the origin."""
    return ModelSet([_toy2_model(k) for k in range(5)])
