"""``_mix.data`` proposal files: reference-compatible import and export.

Counterpart of ``automix_tpu/io/mixfile.py``.  The file is the reference's
checkpoint of the adapted proposal (per-model sig, Lkk, lambda / mu /
lower-triangular B), written by ``write_mix_to_file`` and read by
``read_mixture_params`` (logwrite.c:27-109, 247-277).  CLI mode ``-m 1``
resumes stage 3 from it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from automix_tpu_torch.ops import linalg
from automix_tpu_torch.state import Proposal


def write_mix_file(path: str, proposal: Proposal, model_dims: Sequence[int],
                   fmt: str = "%.6f"):
    """Serialize a Proposal to the reference text format.  Dead component
    slots are left out, as in the reference's dense Lkk-length arrays;
    ``fmt`` is the C writer's ``%lf``."""
    lam = proposal.lam.cpu().numpy()
    mu = proposal.mu.cpu().numpy()
    B = proposal.B.cpu().numpy()
    sig = proposal.sig.cpu().numpy()
    K = lam.shape[0]
    lines = [str(K)] + [str(int(d)) for d in model_dims]
    for k in range(K):
        d = int(model_dims[k])
        lines += [fmt % sig[k, j] for j in range(d)]
        live = np.nonzero(lam[k] > 0)[0]
        lines.append(str(len(live)))
        for l in live:
            lines.append(fmt % lam[k, l])
            lines += [fmt % mu[k, l, j] for j in range(d)]
            for i in range(d):
                lines += [fmt % B[k, l, i, j] for j in range(i + 1)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_mix_file(path: str, model_dims: Sequence[int], lmax: int,
                  dmax: int) -> Proposal:
    """Parse a reference-format mix file into a padded float32 Proposal
    on the CPU, with the C reader's checks: model count and dims must
    match, and each model's weights must sum to 1 within 1e-5 (they are
    renormalized)."""
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def next_tok():
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError("end of file encountered before parameters read")
        pos += 1
        return tokens[pos - 1]

    K = int(next_tok())
    if K != len(model_dims):
        raise ValueError(
            f"file nmodels {K} contradicts model set ({len(model_dims)})")
    for k in range(K):
        d = int(next_tok())
        if d != int(model_dims[k]):
            raise ValueError(f"file dim {d} for model {k} contradicts model "
                             f"set ({model_dims[k]})")

    lam = np.zeros((K, lmax))
    mu = np.zeros((K, lmax, dmax))
    B = np.tile(np.eye(dmax), (K, lmax, 1, 1))
    sig = np.full((K, dmax), 10.0)
    nmix = np.zeros(K, np.int32)
    for k in range(K):
        d = int(model_dims[k])
        for j in range(d):
            sig[k, j] = float(next_tok())
        Lkk = int(next_tok())
        if Lkk < 1 or Lkk > lmax:
            raise ValueError(
                f"model {k}: nMixComps {Lkk} out of range 1..{lmax}")
        nmix[k] = Lkk
        for l in range(Lkk):
            lam[k, l] = float(next_tok())
            for j in range(d):
                mu[k, l, j] = float(next_tok())
            for i in range(d):
                for j in range(i + 1):
                    B[k, l, i, j] = float(next_tok())
        s = lam[k, :Lkk].sum()
        if abs(s - 1.0) > 1e-5:
            raise ValueError(
                f"component weights for model {k} sum to {s}, not 1")
        lam[k, :Lkk] /= s

    f32 = torch.float32
    lam_t = torch.tensor(lam, dtype=f32)
    B_t = torch.tensor(B, dtype=f32)
    dims = torch.tensor(np.asarray(model_dims, np.int64))
    logdetB = linalg.log_det_tri(B_t, dims[:, None])
    # dead slots carry an identity factor; their logdet is 0 anyway
    logdetB = torch.where(lam_t > 0, logdetB, 0.0)
    return Proposal(lam=lam_t, mu=torch.tensor(mu, dtype=f32), B=B_t,
                    logdetB=logdetB, nmix=torch.tensor(nmix),
                    sig=torch.tensor(sig, dtype=f32))
