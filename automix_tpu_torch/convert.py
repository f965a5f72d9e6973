"""Carry proposal and chain state across from the JAX package.

The JAX package's values are handed over as numpy arrays (this module
imports no JAX), in the JAX layouts, and come back as the port's tensors,
so that both packages compute from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from automix_tpu_torch.state import Chains, Proposal


def _t(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def proposal_from_numpy(lam, mu, B, logdetB, nmix, sig,
                        device="cpu") -> Proposal:
    """Proposal from lam [K, L], mu [K, L, D], B [K, L, D, D],
    logdetB [K, L], nmix [K], sig [K, D]."""
    f32 = torch.float32
    return Proposal(lam=_t(lam, f32, device), mu=_t(mu, f32, device),
                    B=_t(B, f32, device), logdetB=_t(logdetB, f32, device),
                    nmix=_t(nmix, torch.int32, device),
                    sig=_t(sig, f32, device))


def proposal_from_arrays(prop, device="cpu") -> Proposal:
    """Proposal from any object whose lam, mu, B, logdetB, nmix and sig
    attributes convert to numpy arrays (a JAX ``Proposal`` of any K, L and
    D, for one)."""
    return proposal_from_numpy(
        **{f: np.asarray(getattr(prop, f)) for f in
           ("lam", "mu", "B", "logdetB", "nmix", "sig")}, device=device)


def chains_from_numpy(k, theta, logp, pk, pkllim, nreinit, sweep,
                      device="cpu") -> Chains:
    """Chains from k [S], theta [S, D], logp [S], pk [S, K], pkllim [S],
    nreinit [S] and the scalar global sweep counter."""
    f32 = torch.float32
    return Chains(k=_t(k, torch.int32, device), theta=_t(theta, f32, device),
                  logp=_t(logp, f32, device), pk=_t(pk, f32, device),
                  pkllim=_t(pkllim, f32, device),
                  nreinit=_t(nreinit, torch.int32, device),
                  sweep=int(np.asarray(sweep)))


def stage1_state_from_numpy(theta, sig, nacc, ntry, C: int, device="cpu"):
    """Stage-1 segment state from the JAX kernel's lane tiles (theta, sig,
    nacc, ntry each [D, 8, W] with K*C = 8*W lanes) to the port's
    (theta [D, K*C], sig [K, D], nacc [K, D], ntry [K, D])."""
    theta = np.asarray(theta)
    D = theta.shape[0]

    def per_model(x):
        return np.asarray(x).reshape(D, -1)[:, ::C].T

    return (_t(theta.reshape(D, -1), torch.float32, device),
            _t(per_model(sig), torch.float32, device),
            _t(per_model(nacc), torch.int32, device),
            _t(per_model(ntry), torch.int32, device))
