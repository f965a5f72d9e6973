"""Padded small-matrix linear algebra for the EM fit and the sweep tables.

Counterpart of the parts of ``automix_tpu/ops/linalg.py`` that stage 2
and the stage-3 tables use.  Padding convention, engine-wide: vectors are
0 beyond the model dim, matrices carry an identity block there, so
factorizations, determinants and solves on the padded shape equal those
of the true leading block.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = 1.8378770664093453


def dim_mask(dim, dmax: int, dtype=torch.float32):
    """[..., dmax] mask: 1 for coordinates < dim (``dim`` a tensor)."""
    ar = torch.arange(dmax, device=dim.device)
    return (ar < dim[..., None]).to(dtype)


def pad_cov_identity(cov, dim):
    """Overwrite rows/cols >= dim of [..., D, D] with the identity."""
    d = cov.shape[-1]
    inside = torch.arange(d, device=cov.device) < dim[..., None]
    keep = inside[..., :, None] & inside[..., None, :]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    return torch.where(keep, cov, eye)


def chol(cov, dim, jitter: float = 0.0):
    """Lower Cholesky factor of an identity-padded covariance with a jitter
    relative to the mean diagonal.  A factorization that fails comes back
    all-NaN, as ``jnp.linalg.cholesky`` does, so callers can replace it."""
    d = cov.shape[-1]
    cov = pad_cov_identity(cov, dim)
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    if jitter:
        diag_mean = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / d
        cov = cov + (jitter * diag_mean)[..., None, None] * eye
    L, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info != 0)[..., None, None], math.nan, L)


def forward_substitute(B, y):
    """Solve B w = y for lower-triangular B [..., D, D], unrolled over rows
    in the reference order."""
    w = []
    for i in range(y.shape[-1]):
        s = y[..., i]
        for j in range(i):
            s = s - B[..., i, j] * w[j]
        w.append(s / B[..., i, i])
    return torch.stack(w, dim=-1)


def lower_matvec(B, w):
    """B @ w for lower-triangular B [..., D, D] and w [..., D] (the
    de-standardizing step, automix.c:1206-1211)."""
    return torch.einsum("...ij,...j->...i", torch.tril(B), w)


def tri_inverse(B):
    """Inverse of lower-triangular B [..., D, D] (the standardizing factor
    of the stage-3 allocation step)."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return torch.linalg.solve_triangular(B, eye.expand_as(B), upper=False)


def log_det_tri(B, dim):
    """log |det B| of lower-triangular B over the first ``dim`` coords."""
    logd = torch.log(torch.abs(torch.diagonal(B, dim1=-2, dim2=-1)))
    return torch.sum(logd * dim_mask(dim, B.shape[-1], logd.dtype), dim=-1)


def lnormprob(x, mu, B, dim):
    """Log-pdf of N(mu, B B^T) at x on padded shapes.  ``dim`` broadcasts
    against the batch shape of ``x``."""
    d = x.shape[-1]
    w = forward_substitute(B, x - mu)
    quad = torch.sum(w * w * dim_mask(dim, d, x.dtype), dim=-1)
    dimf = dim.to(x.dtype)
    return -0.5 * quad - 0.5 * dimf * _LOG_2PI - log_det_tri(B, dim)
