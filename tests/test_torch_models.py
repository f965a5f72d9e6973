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


_SETS = ["toy1", "toy2", "normal", "truncnormal", "beta", "normal_params",
         "beta_params", "gamma_params", "gamma_beta", "normal_beta",
         "normal_gamma"]


def _set_pair(name):
    from automix_tpu.models import builtin as jbuiltin
    from automix_tpu.models import toy as jtoy
    from automix_tpu_torch.models import builtin, toy
    if name.startswith("toy"):
        return (getattr(jtoy, f"{name}_set")(),
                getattr(toy, f"{name}_set")())
    fn = f"{name}_sampler_set" if name in ("normal", "truncnormal",
                                            "beta") else f"{name}_set"
    return getattr(jbuiltin, fn)(), getattr(builtin, fn)()


@pytest.mark.parametrize("name", _SETS)
def test_model_set_logp_cols_match_jax(name):
    """Every model of the toy and builtin sets, sanitized as the kernels
    see it, against the JAX column form at random points over and beyond
    the support.  Off-support points give exactly NEG_INF in both; the
    rest agree within 1e-5 relative and 1e-4 absolute, the tutorial
    test's bound (float32 log/exp/log1p ulps of the two libraries through
    sums of a few terms, absolute where the sum cancels near 0)."""
    jms, ms = _set_pair(name)
    assert list(ms.dims) == list(jms.dims)
    jcols = make_logpost_cols(jms)
    rng = np.random.default_rng(len(name))
    n = 2000
    for m in range(ms.nmodels):
        scale = 8.0 if name.startswith("toy") else 3.0
        th = rng.uniform(-scale, scale, size=(n, ms.dmax))
        th[: n // 2] = np.abs(th[: n // 2]) / scale     # inside (0, 1)
        th = th.astype(np.float32)
        mks = [jnp.asarray(np.full(n, float(i == m), np.float32))
               for i in range(ms.nmodels)]
        want = np.asarray(jcols(mks, [jnp.asarray(c) for c in th.T]),
                          np.float64)
        k = torch.full((n,), m, dtype=torch.int64)
        got = ms.logpost_cols(k, list(torch.as_tensor(th).T)).numpy()
        off = want <= -1e29
        np.testing.assert_array_equal(got[off], np.float32(-1e30))
        np.testing.assert_allclose(got[~off], want[~off], rtol=1e-5,
                                   atol=1e-4)
        assert ms.models[m].cuda is not None


def test_toy_loglik_is_logp_without_the_prior():
    from automix_tpu_torch.models import toy
    ms = toy.toy1_set()
    rows = list(torch.linspace(-3, 3, 40).reshape(2, 20))
    for m, prior in zip(ms.models, (0.3, 0.7)):
        torch.testing.assert_close(m.loglik(rows[:m.dim]),
                                   m.logp_cols(rows[:m.dim])
                                   - float(np.log(prior)),
                                   rtol=0, atol=2e-5)
    np.testing.assert_array_equal(toy.TOY2_MODEL_PROBS,
                                  [0.5, 0.25, 0.125, 0.0625, 0.0625])


def test_cuda_tables_match_the_kernel_sources():
    """The shape list, density kinds and constant slots the Python side
    uses are the ones csrc/common.cuh compiles in."""
    from pathlib import Path

    from automix_tpu_torch.kernels import _build
    from automix_tpu_torch.model import N_DENSITY_CONSTS
    from automix_tpu_torch.models import builtin, toy
    src = (Path(_build.__file__).parents[1] / "csrc" / "common.cuh"
           ).read_text()
    import re
    assert '#include "am_shapes.h"' in src
    shapes = re.search(r"#define AM_SHAPES\(X\) (.*)",
                       _build.shapes_header()).group(1)
    assert tuple((int(a), int(b)) for a, b in re.findall(
        r"X\((\d+), (\d+)\)", shapes)) == _build.SHAPES
    assert re.search(r"#define AM_N_CONSTS (\d+)", src).group(1) == \
        str(N_DENSITY_CONSTS)
    kinds = dict(re.findall(r"#define AM_KIND_(\w+) (\d+)", src))
    for mod in (builtin, toy):
        for name in dir(mod):
            if name.startswith("KIND_"):
                assert kinds[name[5:]] == str(getattr(mod, name)), name
    for name in _SETS:
        ms = _set_pair(name)[1]
        assert (ms.nmodels, ms.dmax) in _build.SHAPES
        kinds_t, consts, dims = ms.density_table("cpu")
        assert consts.shape == (ms.nmodels, N_DENSITY_CONSTS)
