"""The rb9 family of the port against the JAX package's family column form
and the reference C code's pointwise log-posteriors."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.kernels.fused import make_logpost_cols
from automix_tpu.models import rb9 as jrb9
from automix_tpu_torch.model import N_DENSITY_CONSTS
from automix_tpu_torch.models import rb9
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401

_ORACLE = os.path.join(os.path.dirname(__file__), "data",
                       "logp_oracle.json")


def _states(seed, n=2048):
    """Random (k, theta) over and beyond the support: positive rates and
    dispersions across the posterior's scale, a share of tiny dispersions
    (large 1/kappa), and states with a negative coordinate inside or
    outside the model's dimension."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 10, n)
    th = rng.uniform(0.5, 80.0, size=(n, 5))
    th[:, 3:] = rng.uniform(0.01, 5.0, size=(n, 2))
    th[:200, 3:] = rng.uniform(1e-4, 1e-2, size=(200, 2))
    th[200:300, 0] = -rng.uniform(0.1, 5.0, 100)
    th[300:400, 4] = -rng.uniform(0.1, 5.0, 100)
    return k, th.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_family_cols_match_jax(seed):
    """2048 random states against JAX ``batched_logpost_cols`` (through
    ``make_logpost_cols``, sanitized as the kernels see it).  Same float32
    formula in the same order; only the two libraries' log differ, by an
    ulp or two, through sums of large terms that cancel: sum x log lambda
    reaches ~1e4, and at a small dispersion kappa the NB terms reach
    n / kappa * log(1 / kappa), ~1e6 at kappa = 1e-4.  So the bound is
    1e-5 relative to the largest of 1, |lp| and that term.  Out of
    support both give exactly -1e6, also where the negative coordinate
    lies beyond the model's dimension (no rejection there)."""
    k, th = _states(seed)
    mks = [jnp.asarray((k == m).astype(np.float32)) for m in range(10)]
    want = np.asarray(make_logpost_cols(jrb9.rb9_set())(
        mks, [jnp.asarray(c) for c in th.T]), np.float64)
    ms = rb9.rb9_set()
    got = ms.logpost_cols(torch.as_tensor(k), list(torch.as_tensor(th).T))
    got = got.numpy().astype(np.float64)
    off = want == -1e6
    assert off.sum() >= 100
    np.testing.assert_array_equal(got[off], -1e6)
    km1 = 1.0 / np.clip(th[:, 3:].min(axis=1), 1e-30, None)
    scale = np.maximum.reduce([np.ones_like(want), np.abs(want),
                               16.0 * km1 * np.abs(np.log(km1))])
    assert (np.abs(got - want) / scale).max() < 1e-5
    # beyond the dimension: models 0-5 have dim 4, so a negative theta[4]
    # is no rejection for them
    beyond = (np.arange(len(k)) >= 300) & (np.arange(len(k)) < 400) \
        & (k < 6)
    assert beyond.any() and (got[beyond] > -1e6).all()


def test_family_cols_match_the_c_oracle():
    """Every rb9 entry of ``tests/data/logp_oracle.json`` (the reference
    C code's log-posterior) within 5e-5 relative, the JAX package's own
    tolerance (tests/test_models_oracle.py)."""
    entries = json.load(open(_ORACLE))["rb9"]
    assert len(entries) >= 10
    ms = rb9.rb9_set()
    k = torch.tensor([e["k"] for e in entries])
    th = np.zeros((len(entries), 5), np.float32)
    for i, e in enumerate(entries):
        th[i, :len(e["theta"])] = e["theta"]
    got = ms.logpost_cols(k, list(torch.as_tensor(th).T)).numpy()
    want = np.array([e["lp"] for e in entries])
    rel = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert rel.max() < 5e-5, rel.max()


def test_models_match_jax_structure():
    """Ten models of the JAX dims and start points; each model's own
    column form equals the family form at its index; the CUDA constants
    fit the slots and carry the index maps."""
    jms, ms = jrb9.rb9_set(), rb9.rb9_set()
    assert list(ms.dims) == list(jms.dims)
    np.testing.assert_array_equal(
        ms.init_points(randoms.key(0)).numpy(),
        np.asarray(jms.init_points(None)))
    np.testing.assert_array_equal(rb9.X_DATA, jrb9.X_DATA)
    k, th = _states(5, 512)
    rows = list(torch.as_tensor(th).T)
    for m, model in enumerate(ms.models):
        assert model.cuda.kind == rb9.KIND_RB9
        consts = model.cuda.consts
        assert len(consts) <= N_DENSITY_CONSTS
        assert consts[2:6] == tuple(map(float, jrb9._lambda_map(m)))
        assert consts[6:10] == tuple(map(float, jrb9._kappa_map(m)))
        assert consts[10:14] == tuple(map(float, jrb9._pindic(m)))
        own = model.logp_cols(rows[:model.dim])
        fam = ms.logpost_cols(torch.full((512,), m), rows)
        assert torch.equal(torch.clamp(own, -1e30, 1e30), fam)


def test_header_holds_the_family_data():
    """The generated am_rb9.h holds the per-group statistics and the
    distinct counts, 66 observations in all, as float32 values."""
    text = rb9.header()
    stats = rb9.group_stats()
    assert sum(sum(s[4]) for s in stats) == 66
    for name in ("am_rb9_n", "am_rb9_sx", "am_rb9_clg", "am_rb9_val",
                 "am_rb9_cnt", "am_rb9_off"):
        assert f"static __constant__" in text and name in text
    n_vals = sum(len(s[3]) for s in stats)
    assert f"am_rb9_val[{n_vals}]" in text
    assert "#define AM_RB9_BETA1 0.10000000149011612f" in text
