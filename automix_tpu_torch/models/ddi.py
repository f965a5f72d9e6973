"""DDI AIDS clinical-trial model choice (thesis section 5.5.4, Han & Carlin
2001).

Counterpart of ``automix_tpu/models/ddi.py``: two longitudinal
random-effects models of 467 patients' sqrt-CD4 counts over up to 5
visits (userddi.c).

* Model 0 (dim 16): fixed effects alpha[9], the lower triangle of the 3x3
  random-effects precision (theta[9..14], userddi.c:271-276) and the error
  variance sigma^2 at theta[15].
* Model 1 (dim 10): gamma[6], the 2x2 precision (theta[6..8]), tau^2 at
  theta[9].

Normal priors on the fixed effects, Wishart(rho = 24, R) on the
precision, InvGamma(3, 0.005) on the variance (userddi.c:471-531); the
likelihood (userddi.c:533-670) in the class-statistics form of
``models/ddi_stats.py``, evaluated column by column by
``models/ddi_cols.py``.  Out of support (a precision not positive
definite, a variance <= 0) the density is -1e7, as in the reference.

The sweep kernel carries the statistics per chain (``fused_density``, the
incremental cache); stage 1, the chains' start and every stateless use
evaluate them from scratch.  The data are the port's own copy of the JAX
package's ``ddi_data.npz``.  HMC differentiates the class-statistics
form (``ModelSet.logpost_and_grad``), whose gradient is held to that of
the JAX package's patient-level density (``_make_logp``) in
tests/test_torch_hmc.py.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from automix_tpu_torch.model import CudaDensity, Model, ModelSet
from automix_tpu_torch.models import ddi_cols, ddi_stats

_DATA_PATH = os.path.join(os.path.dirname(__file__), "ddi_data.npz")

# Density kind of csrc/common.cuh; the constant is the model's index.
KIND_DDI = 10

# hyperparameters (userddi.c:21-29; a, b, rho and the Wishart constant
# are in models/ddi_cols.py)
C0 = np.array([10.0, 0.0, 0.0, 0.0, 0.0, 0.0, -3.0, 0.0, 0.0])
C1 = np.array([10.0, 0.0, 0.0, 0.0, -3.0, 0.0])
D0MIN1 = np.array([0.25, 1.0, 1.0, 100.0, 1.0, 1.0, 1.0, 1.0, 1.0])
D1MIN1 = np.array([0.25, 1.0, 100.0, 1.0, 1.0, 1.0])
R0_DIAG = np.array([4.0, 1.0 / 16.0, 1.0 / 16.0])
R1_DIAG = np.array([4.0, 1.0 / 16.0])


def _load_data():
    z = np.load(_DATA_PATH)
    S = z["S"].astype(np.int32)
    counts = z["counts"]
    n, vmax = counts.shape
    visit_mask = (np.arange(vmax)[None, :] < S[:, None])
    # Observed responses: sqrt counts, compacted per patient like the C's
    # Y[i][j] < 90 filter (userddi.c:593-599; sentinel 9999 -> ~100).
    Y = np.zeros((n, vmax))
    for i in range(n):
        vals = np.sqrt(counts[i][np.sqrt(counts[i]) < 90.0])
        assert len(vals) == S[i], (i, len(vals), S[i])
        Y[i, : S[i]] = vals
    # Zero the padded rows of the design tensors (the file stores -10
    # sentinels there).
    W = z["W"] * visit_mask[:, :, None]
    X = z["X"] * visit_mask[:, :, None]
    Q = z["Q"] * visit_mask[:, :, None]
    P = z["P"] * visit_mask[:, :, None]
    return dict(S=S, Y=Y, W=W, X=X, Q=Q, P=P, visit_mask=visit_mask)


@functools.cache
def ddi_density() -> ddi_cols.DDIFusedDensity:
    """The family's incremental density, built once from the data."""
    data = _load_data()
    tab0 = ddi_stats.build_class_tables(
        data["W"], data["X"], data["Y"], data["visit_mask"], data["S"])
    tab1 = ddi_stats.build_class_tables(
        data["Q"], data["P"], data["Y"], data["visit_mask"], data["S"])
    # model 0: theta[9..14] packs the LOWER triangle of the 3x3 precision
    # row-wise (userddi.c:271-276): (0,0)(1,0)(1,1)(2,0)(2,1)(2,2) = rows
    # 9..14; the upper-tri (a <= b) order of the tables is rows 9, 10, 12,
    # 11, 13, 14.
    m0 = ddi_cols.ModelPart(tab0, n_fix=9, d_re=3, var_row=15,
                            prec_rows=(9, 10, 12, 11, 13, 14), c_prior=C0,
                            dmin1=D0MIN1, r_diag=R0_DIAG)
    m1 = ddi_cols.ModelPart(tab1, n_fix=6, d_re=2, var_row=9,
                            prec_rows=(6, 7, 8), c_prior=C1, dmin1=D1MIN1,
                            r_diag=R1_DIAG)
    return ddi_cols.DDIFusedDensity((m0, m1))


def header() -> str:
    """``am_ddi.h`` for the kernel build (``DDIFusedDensity.header``)."""
    return ddi_density().header()


@functools.cache
def ddi_set() -> ModelSet:
    """The two DDI models.  Stage-1 starts at the prior centres with the
    precisions at identity and the variance at 100 (userddi.c:52-193 draw
    random starts near these, :75, :142)."""
    density = ddi_density()
    m0, m1 = density.parts
    init0 = np.concatenate([C0, [1.0, 0.0, 1.0, 0.0, 0.0, 1.0], [100.0]])
    init1 = np.concatenate([C1, [1.0, 0.0, 1.0], [100.0]])

    def family_cols(k, rows):
        return density.full(k, rows)[0]

    return ModelSet([
        Model("ddi_full", 16, m0.logp_cols, init=init0,
              cuda=CudaDensity(KIND_DDI, (0.0,))),
        Model("ddi_reduced", 10, m1.logp_cols, init=init1,
              cuda=CudaDensity(KIND_DDI, (1.0,))),
    ], batched_logpost_cols=family_cols, fused_density=density)
