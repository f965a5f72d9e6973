"""The DDI tables the cached sweep kernel copies into shared memory.

``DDIFusedDensity.header()`` (``automix_tpu_torch/models/ddi_cols.py``)
emits each model's coefficient rows (column by column: the quadratic
features, then the linear ones), its column constants and the feature
indices of a coordinate move as ``__constant__`` arrays; K1e copies the
coefficients and feature indices into shared memory unchanged
(``csrc/ddi.cuh`` ``am_ddi_shared_load``) and reads both copies with the
same indexing.  Parsed back from the header text, every entry must be the
twin's coefficient, constant or feature index; the layout has no padding.
CPU only: the header is generated here as the build writes it.
"""

import re

import numpy as np
import pytest

from automix_tpu_torch.models import ddi


def _array(text, name):
    """The numbers of the C array ``name`` in ``text`` and its declared
    length."""
    m = re.search(rf"static __constant__ (float|int) {name}\[(\d+)\] = "
                  r"\{([^}]*)\};", text)
    assert m, name
    vals = [v.strip().rstrip("f") for v in m.group(3).split(",")]
    dtype = np.float32 if m.group(1) == "float" else np.int64
    return np.asarray([float(v) for v in vals]).astype(dtype), \
        int(m.group(2))


@pytest.fixture(scope="module")
def header():
    return ddi.ddi_density().header()


@pytest.mark.parametrize("m", [0, 1])
def test_coefficient_rows(header, m):
    """Row ``col`` of model m's coefficients holds the twin's tab_quad
    then tab_lin entries of that column, feature by feature, and its
    constant is tab_const; the array holds exactly n_cols rows."""
    part = ddi.ddi_density().parts[m]
    n_quad = len(part.quad_pairs)
    F = n_quad + part.n_fix
    coef, n = _array(header, f"am_ddi{m}_coef")
    assert n == coef.size == part.n_cols * F
    assert f"#define AM_DDI{m}_QUAD {n_quad}\n" in header
    assert f"#define AM_DDI{m}_FIX {part.n_fix}\n" in header
    rows = coef.reshape(part.n_cols, F)
    for col in range(part.n_cols):
        np.testing.assert_array_equal(rows[col, :n_quad],
                                      part.tab_quad[:, col])
        np.testing.assert_array_equal(rows[col, n_quad:],
                                      part.tab_lin[:, col])
    const, n = _array(header, f"am_ddi{m}_const")
    assert n == part.n_cols
    np.testing.assert_array_equal(const, part.tab_const)


@pytest.mark.parametrize("m", [0, 1])
def test_feature_indices(header, m):
    """Row j of model m's feature indices lists the quadratic features
    holding coordinate j in feature order (the twin's coord_feats), each
    the index of a coefficient within a row."""
    part = ddi.ddi_density().parts[m]
    fidx, n = _array(header, f"am_ddi{m}_fidx")
    assert n == fidx.size == part.n_fix ** 2
    for j, row in enumerate(fidx.reshape(part.n_fix, part.n_fix)):
        assert row.tolist() == part.coord_feats[j]
        assert all(j in part.quad_pairs[f] for f in row)
    assert 0 <= fidx.min() and fidx.max() < len(part.quad_pairs)
