"""The general engine's random streams and model registry on the CPU.

The ``fast`` counter-hash stream (``ops/randoms.py fast_sweep_randoms``)
against the JAX package's, K4's plain twin (``kernels/sweep_rng.py
draw_ref``) against the contracts of JAX's ``tests/test_sweep_rng.py`` and
Philox's published answers, the stage-3 tables against JAX's
``precompute_tables``, and ``ModelSet.logpost_batch``,
``from_callback`` and ``memoized_set`` against the JAX registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.kernels import rjmcmc as jrjmcmc
from automix_tpu.model import ModelSet as JaxModelSet
from automix_tpu.models import toy as jtoy
from automix_tpu.models import tutorial as jtutorial
from automix_tpu.ops import randoms as jrandoms
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch import EngineConfig, Model, ModelSet
from automix_tpu_torch.config import NEG_INF
from automix_tpu_torch.convert import proposal_from_arrays
from automix_tpu_torch.kernels import rjmcmc, sweep_rng
from automix_tpu_torch.model import memoized_set
from automix_tpu_torch.models import toy, tutorial
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_general import _per_theta


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# --- the fast stream -----------------------------------------------------


# (seed, sweep, chain0, S, MU, MZ): the tutorial's stage-3 slots at L = 8,
# a wider draw, and a shard offset
FAST_CASES = [(3, 17, 0, 16384, 25, 4), (0, 1, 0, 4096, 30, 10),
              (123456, 99999, 1024, 8192, 7, 9)]


@pytest.mark.parametrize("case", FAST_CASES)
def test_fast_stream_matches_jax(case):
    """Uniforms bitwise JAX's; normals within 2 ulps, and bitwise on all
    but ~0.003% (readings below 1e-4 of the normals; torch's log1p and
    log on the few words where XLA's own polynomial rounds otherwise)."""
    ju, jz = jrandoms.fast_sweep_randoms(*case)
    tu, tz = randoms.fast_sweep_randoms(*case)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    d = _ulps(tz.numpy(), jz)
    assert d.max() <= 2, d.max()
    assert (d > 0).mean() < 1e-4, (d > 0).mean()


def test_fast_stream_share_over_many_sweeps():
    """40 sweeps of the tutorial's slots (2621440 normals): the share not
    bitwise JAX's (read: 121) and the largest ulp distance.  XLA's log is
    a Cephes polynomial whose float32 rounding the port follows on all
    but ~0.04% of its inputs, so one of these normals is 3 ulps off."""
    n = bad = 0
    worst = 0
    for sweep in range(1, 41):
        _, jz = jrandoms.fast_sweep_randoms(0, sweep, 0, 16384, 25, 4)
        _, tz = randoms.fast_sweep_randoms(0, sweep, 0, 16384, 25, 4)
        d = _ulps(tz.numpy(), jz)
        n += d.size
        bad += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    assert bad / n < 1e-4 and worst <= 3, (bad, n, worst)


# Counters whose word at (seed 0, sweep 1) has its top 24 bits all ones,
# found by a search over 2^28 counters: with MU + MZ = 29 columns, counter
# 5927885 is column 24 of row 204409 (a uniform) and 98394474 column 26
# of row 3392912 (the second normal).
ONES_U = (204409, 24)
ONES_Z = (3392912, 26)


def test_fast_stream_gives_one_and_inf_as_jax():
    """A word whose top 24 bits are all ones gives u = 1.0 exactly and
    z = +inf, in JAX and in the port (no clamp: the reference
    behaviour)."""
    for row, col in (ONES_U, ONES_Z):
        ju, jz = jrandoms.fast_sweep_randoms(0, 1, row, 1, 25, 4)
        tu, tz = randoms.fast_sweep_randoms(0, 1, row, 1, 25, 4)
        jall = np.concatenate([np.asarray(ju), np.asarray(jz)], axis=1)
        tall = torch.cat([tu, tz], dim=1).numpy()
        if col < 25:
            assert jall[0, col] == 1.0 and tall[0, col] == 1.0
        else:
            assert jall[0, col] == np.inf and tall[0, col] == np.inf
        np.testing.assert_array_equal(tall[:, :25], jall[:, :25])


def test_erf_inv_against_xla():
    """erf_inv on 200000 points of (-1, 1) and at +-1: within 2 ulps of
    jax.lax.erf_inv, +-inf at +-1; torch.erfinv is far further off."""
    rng = np.random.default_rng(0)
    x = (rng.random(200_000, dtype=np.float32) * 2 - 1).astype(np.float32)
    x = np.concatenate([x, np.float32([1.0, -1.0, 0.0])])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = randoms.erf_inv(torch.from_numpy(x)).numpy()
    assert got[-3] == np.inf and got[-2] == -np.inf and got[-1] == 0.0
    d = _ulps(got[:-3], want[:-3])
    assert d.max() <= 2 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    d_torch = _ulps(torch.erfinv(torch.from_numpy(x[:-3])).numpy(),
                    want[:-3])
    assert (d_torch > 0).mean() > 0.1


def test_latent_log_pdf_matches_jax():
    z = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_array_equal(
        randoms.latent_lpdf(torch.from_numpy(z), None).numpy(),
        np.asarray(jrandoms.latent_log_pdf(jnp.asarray(z), 0)))


# --- K4's plain twin -----------------------------------------------------


# Random123's known-answer vectors for Philox-4x32-10 (kat_vectors):
# counter, key, result.
_M = 0xFFFFFFFF
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_M, _M, _M, _M), (_M, _M),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr, key, want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    t = [torch.tensor([v], dtype=torch.int64) for v in ctr + key]
    got = sweep_rng.philox4x32(*t)
    assert tuple(int(g) for g in got) == want


def _draw(seed, sweep, block0, s, mu, mz):
    u, z = sweep_rng.draw(seed, sweep, block0, s, mu, mz, "cpu")
    return u.numpy(), z.numpy()


def test_k4_shapes_and_open_range():
    u, z = _draw(1, 2, 0, 512, 25, 4)
    assert u.shape == (512, 25) and z.shape == (512, 4)
    assert u.dtype == np.float32 and z.dtype == np.float32
    assert u.min() > 0.0 and u.max() < 1.0
    assert np.all(np.isfinite(z))
    _, z = _draw(1, 2, 0, 512, 3, 5)           # odd MZ: cos half first
    assert z.shape == (512, 5)


def test_k4_marginals():
    """Mean, variance and kurtosis of JAX's contract, on 8192 rows."""
    u, z = _draw(7, 3, 0, 8192, 25, 4)
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.var() - 1.0 / 12.0) < 0.002
    assert abs(z.mean()) < 0.02 and abs(z.var() - 1.0) < 0.03
    kurt = (z.ravel() ** 4).mean() / z.var() ** 2
    assert abs(kurt - 3.0) < 0.3
    counts, _ = np.histogram(u, bins=256, range=(0.0, 1.0))
    expected = u.size / 256
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert abs(chi2 - 255) < 5 * 22.6, chi2


def test_k4_deterministic_in_seed_and_sweep():
    u1, z1 = _draw(5, 11, 0, 256, 9, 2)
    u2, z2 = _draw(5, 11, 0, 256, 9, 2)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(z1, z2)
    assert not np.array_equal(u1, _draw(5, 12, 0, 256, 9, 2)[0])
    assert not np.array_equal(u1, _draw(6, 11, 0, 256, 9, 2)[0])


@pytest.mark.parametrize("s", [4096, 6144])
def test_k4_block_offset_addresses_global_rows(s):
    """Rows [S/2:] of a draw equal a half draw at block0 = S/2/1024: a
    shard drawing its own rows gets the unsharded stream."""
    cb = sweep_rng.choose_block(s)
    assert sweep_rng.choose_block(s // 2) == cb
    u, z = _draw(3, 9, 0, s, 9, 3)
    uh, zh = _draw(3, 9, (s // 2) // cb, s // 2, 9, 3)
    np.testing.assert_array_equal(u[s // 2:], uh)
    np.testing.assert_array_equal(z[s // 2:], zh)


def test_k4_choose_block_and_resolve_rng():
    assert sweep_rng.choose_block(131072) == 1024
    assert sweep_rng.choose_block(3000) == 8
    assert sweep_rng.choose_block(7) == 1
    assert sweep_rng.resolve_rng(EngineConfig()) == "fast"
    assert sweep_rng.resolve_rng(EngineConfig(student_t_dof=4)) == "threefry"
    assert sweep_rng.resolve_rng(EngineConfig(rng="pallas")) == "pallas"
    assert sweep_rng.resolve_rng(EngineConfig(rng="fast")) == "fast"
    assert sweep_rng.resolve_rng(EngineConfig(rng="threefry")) == "threefry"
    with pytest.raises(ValueError):
        EngineConfig(rng="pallas", student_t_dof=3)


# --- tables and the registry ---------------------------------------------


def _random_proposal(K, L, D, dims, seed):
    rng = np.random.default_rng(seed)
    lam = rng.random((K, L)).astype(np.float32)
    lam[:, -1] = 0.0                               # a dead component
    lam /= lam.sum(1, keepdims=True)
    mu = rng.normal(size=(K, L, D)).astype(np.float32)
    B = np.tile(np.eye(D, dtype=np.float32), (K, L, 1, 1))
    for k, d in enumerate(dims):
        A = np.tril(rng.normal(size=(L, d, d))) * 0.3
        A[:, range(d), range(d)] = rng.random((L, d)) + 0.5
        B[k, :, :d, :d] = A
        mu[k, :, d:] = 0.0
    logdet = np.log(np.abs(np.diagonal(B, axis1=-2, axis2=-1))).sum(-1)
    return JaxProposal(lam=lam, mu=mu, B=B, logdetB=logdet.astype(np.float32),
                       nmix=np.full(K, L, np.int32),
                       sig=rng.random((K, D)).astype(np.float32))


def test_precompute_tables_match_jax():
    dims = np.array([1, 3, 2])
    jp = _random_proposal(3, 4, 3, dims, 0)
    want = jrjmcmc.precompute_tables(jp, jnp.asarray(dims), jnp.float32)
    got = rjmcmc.precompute_tables(proposal_from_arrays(jp), dims)
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_rand_slots_match_jax():
    for D, L, K in ((2, 8, 3), (5, 10, 5), (3, 1, 2)):
        assert rjmcmc.rand_slots(D, L, K) == jrjmcmc.rand_slots(D, L, K)


@pytest.mark.parametrize("name", ["tutorial", "toy2", "toy2_per_theta"])
def test_logpost_batch_matches_jax(name):
    """logpost_batch on random padded states, some off-support, against
    JAX's logpost_batch: float32 tolerance on finite values, NEG_INF on
    the same chains."""
    if name == "tutorial":
        ms, jms = tutorial.tutorial_set(), jtutorial.tutorial_set()
    else:
        ms, jms = (_per_theta(toy.toy2_set()) if name == "toy2_per_theta"
                   else toy.toy2_set()), jtoy.toy2_set()
    rng = np.random.default_rng(1)
    S = 512
    k = rng.integers(0, ms.nmodels, S).astype(np.int32)
    theta = rng.normal(size=(S, ms.dmax)).astype(np.float32) * 2 + 1
    theta[:8] = -1.0                               # tutorial off-support
    want = np.asarray(jms.logpost_batch(jnp.asarray(k), jnp.asarray(theta)))
    got = ms.logpost_batch(torch.from_numpy(k).long(),
                           torch.from_numpy(theta)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got == NEG_INF, want == NEG_INF)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_logpost_batch_sends_non_finite_to_neg_inf():
    """JAX's rule: NaN, +inf and -inf all become NEG_INF; large finite
    values stay (the kernels' sanitize clamps +inf to 1e30)."""
    vals = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e35,
                         -2.0])
    ms = ModelSet([Model("m", 1, logp_cols=lambda rows: vals)])
    got = ms.logpost_batch(torch.zeros(5, dtype=torch.long),
                           torch.zeros(5, 1))
    np.testing.assert_array_equal(
        got.numpy(), np.float32([NEG_INF, NEG_INF, NEG_INF, 3e35, -2.0]))


def test_from_callback_and_memoized_set():
    """from_callback splits the flat start vector and calls the callback
    with each model's static k, as JAX's does; memoized_set returns one
    object per keyword set."""
    def logpost(k, th):
        return -0.5 * (th * th).sum() * (k + 1)

    ms = ModelSet.from_callback(2, [1, 3], logpost, init=[0.5, 1, 2, 3])
    jms = JaxModelSet.from_callback(
        2, [1, 3], lambda k, th: -0.5 * jnp.sum(th * th) * (k + 1),
        init=[0.5, 1, 2, 3])
    np.testing.assert_array_equal(ms.models[1].init, jms.models[1].init)
    assert [m.name for m in ms.models] == [m.name for m in jms.models]
    theta = np.float32([[1, 2, 3], [1, 2, 3]])
    k = np.int32([0, 1])
    np.testing.assert_allclose(
        ms.logpost_batch(torch.from_numpy(k).long(),
                         torch.from_numpy(theta)).numpy(),
        np.asarray(jms.logpost_batch(jnp.asarray(k), jnp.asarray(theta))))

    calls = []

    @memoized_set
    def factory(scale=1.0):
        calls.append(scale)
        return ms

    assert factory(scale=2.0) is factory(scale=2.0)
    assert factory() is factory()
    assert calls == [2.0, 1.0]
    with pytest.raises(ValueError, match="needs logp or logp_cols"):
        Model("empty", 1)
