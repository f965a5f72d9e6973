"""The port's column densities and log-gamma against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.kernels.fused import make_logpost_cols
from automix_tpu.models import tutorial as jtutorial
from automix_tpu.ops.plmath import pal_gammaln as jax_gammaln
from automix_tpu_torch.models import tutorial
from automix_tpu_torch.ops.plmath import pal_gammaln
from _torch_threads import one_torch_thread  # noqa: F401


def test_pal_gammaln_matches_jax():
    """Same float32 formula in the same order; the two libraries' log
    differ by at most an ulp or two, so 2e-6 relative (1e-6 absolute near
    the zeros of lgamma) bounds the difference."""
    x = np.concatenate([np.linspace(0.01, 2.0, 500),
                        np.linspace(2.0, 500.0, 500)]).astype(np.float32)
    want = np.asarray(jax_gammaln(jnp.asarray(x)), np.float64)
    got = pal_gammaln(torch.as_tensor(x)).numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def _points(seed, n=2000):
    """Random (theta0, theta1) pairs over and beyond the support,
    including exact zeros and negative values (off-support -> NEG_INF)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-2.0, 12.0, size=(n, 2)).astype(np.float32)
    th[:50, 0] = 0.0
    th[50:100, 1] = -rng.uniform(0.0, 1.0, 50).astype(np.float32)
    return th


@pytest.mark.parametrize("m", [0, 1, 2])
def test_tutorial_logp_cols_match_jax(m):
    """Each tutorial density, sanitized as the kernels see it, torch vs the
    JAX column form.  Off-support points must both give exactly NEG_INF;
    elsewhere 1e-5 relative (float32 log/pal_gammaln ulps through sums of
    ten-observation sufficient statistics)."""
    th = _points(m)
    jms = jtutorial.tutorial_set()
    jcols = make_logpost_cols(jms)
    mks = [jnp.asarray(np.full(len(th), float(i == m), np.float32))
           for i in range(3)]
    want = np.asarray(jcols(mks, [jnp.asarray(th[:, 0]),
                                  jnp.asarray(th[:, 1])]), np.float64)
    ms = tutorial.tutorial_set()
    k = torch.full((len(th),), m, dtype=torch.int64)
    got = ms.logpost_cols(k, list(torch.as_tensor(th).T)).numpy()
    off = want <= -1e29
    assert off.sum() >= 50
    np.testing.assert_array_equal(got[off], np.float32(-1e30))
    np.testing.assert_allclose(got[~off], want[~off], rtol=1e-5, atol=1e-4)


def test_tutorial_constants_match():
    np.testing.assert_array_equal(tutorial.TUTORIAL_DATA,
                                  jtutorial.TUTORIAL_DATA)
    np.testing.assert_array_equal(tutorial.TUTORIAL_MODEL_PROBS,
                                  jtutorial.TUTORIAL_MODEL_PROBS)
    ms = tutorial.tutorial_set()
    assert [m.dim for m in ms.models] == [2, 2, 2]
    np.testing.assert_array_equal(
        ms.init_points(torch.Generator()).numpy(),
        np.asarray(jtutorial.tutorial_set().init_points(None)))
