"""The port's counter hash against the JAX fused kernels' hash.

Every random word of the ported kernels is a pure function of (seed,
sweep, chain, slot); these tests hold the torch words, uniforms and the
stage-1 block coin BITWISE equal to the JAX package's (no tolerance: the
hash is integer arithmetic and the uniform is an exact conversion).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from automix_tpu.kernels import fused as jfused
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401

_U = jnp.uint32


def _jax_words(seed, t, chain_ids, nw):
    """``draw_words`` of the fused kernel in hash mode (fused.py:437-445)."""
    seed_u = _U(seed & 0xFFFFFFFF)
    sweep_u = jnp.asarray(t, jnp.int32).astype(_U)
    salt1 = jfused._triple32(sweep_u ^ (seed_u * _U(0x9E3779B9)))
    salt2 = jfused._lowbias32(sweep_u + _U(0x85EBCA6B)
                              + seed_u * _U(0xC2B2AE35))
    cbase = jnp.asarray(chain_ids, jnp.int32).astype(_U) * _U(nw)
    c = cbase[None, :] + jnp.arange(nw, dtype=jnp.int32).astype(_U)[:, None]
    return np.asarray(jfused._triple32(c ^ salt1) ^ jfused._lowbias32(c + salt2))


@pytest.mark.parametrize("seed", [0, 3, 777, 2 ** 31 - 1, 123456789])
@pytest.mark.parametrize("t", [1, 10, 2001, 2 ** 20 + 7])
def test_sweep_words_bitwise(seed, t):
    rng = np.random.default_rng(seed % 1000 + t)
    chains = np.concatenate([np.arange(64),
                             rng.integers(0, 2 ** 22, size=64)])
    nw = 29
    want = _jax_words(seed, t, chains, nw)
    got = randoms.sweep_words(seed, t, torch.as_tensor(chains), range(nw))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_triple32_lowbias32_bitwise_on_random_words():
    x = np.random.default_rng(0).integers(0, 2 ** 32, size=4096,
                                          dtype=np.uint64)
    xj = jnp.asarray(x.astype(np.uint32))
    xt = torch.as_tensor(x.astype(np.int64))
    np.testing.assert_array_equal(
        randoms.triple32(xt).numpy().astype(np.uint32),
        np.asarray(jfused._triple32(xj)))
    np.testing.assert_array_equal(
        randoms.lowbias32(xt).numpy().astype(np.uint32),
        np.asarray(jfused._lowbias32(xj)))


def test_u01_bitwise_and_clamped():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 2 ** 32, size=8192, dtype=np.uint64)
    w[:4] = [0, 255, 2 ** 32 - 1, 2 ** 32 - 256]     # extremes of the range
    w = w.reshape(64, 128)

    def kernel(w_ref, o_ref):           # _u01 lowers inside a kernel only
        o_ref[...] = jfused._u01(w_ref[...])

    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(w.shape, jnp.float32),
        interpret=True)(jnp.asarray(w.astype(np.uint32))))
    got = randoms.u01(torch.as_tensor(w.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.max() < 1.0 and got.min() > 0.0


def test_block_coin_bitwise():
    seed = (5 * 1000003 + 777) & 0x7FFFFFFF
    seed_u = _U(seed)
    ts = np.arange(1, 3001)
    h = jfused._triple32((jnp.asarray(ts, jnp.int32).astype(_U)
                          * _U(2654435761) + seed_u) ^ _U(0xB5297A4D))
    want = np.asarray((h >> 8) < _U(int(0.1 * 2 ** 24)))
    got = np.array([randoms.block_coin(seed, int(t)) for t in ts])
    np.testing.assert_array_equal(got, want)
    assert 0.07 < got.mean() < 0.13
