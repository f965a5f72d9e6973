"""Stage-2 Figueiredo-Jain EM: the port against the JAX fit on the same
samples with the same seeding indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.kernels import em as jem
from automix_tpu_torch.kernels import em
from _torch_threads import one_torch_thread  # noqa: F401

LMAX, MAX_ITERS = 8, 300


def _samples(seed, n=600):
    """Three 2-D data sets of mixtures with 1, 2 and 3 well separated
    modes (one per model of the batch)."""
    rng = np.random.default_rng(seed)
    out = []
    for nmodes in (1, 2, 3):
        centers = rng.uniform(-6, 6, size=(nmodes, 2))
        comp = rng.integers(0, nmodes, size=n)
        scale = rng.uniform(0.3, 1.0, size=(nmodes, 2))
        out.append(centers[comp] + rng.normal(size=(n, 2)) * scale[comp])
    return np.stack(out).astype(np.float32)


def _jax_fit(x, key):
    """JAX fit of each model (as fit_proposal vmaps it) and its seeding
    indices (em.py:146-148)."""
    K, N, _ = x.shape
    keys = jax.random.split(key, K)
    outs, idx = [], []
    for m in range(K):
        out = jem.fit_figueiredo(jnp.asarray(x[m]), jnp.int32(2), keys[m],
                                 LMAX, MAX_ITERS)
        outs.append(jax.device_get(out))
        i = jax.random.choice(keys[m], N, (min(LMAX, N),), replace=False)
        idx.append(np.asarray(jnp.resize(i, (LMAX,))))
    return outs, np.stack(idx)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_figueiredo_matches_jax(seed):
    """Same samples, same seeding: the live component count is equal and
    the fitted mixture agrees within 2e-3 (float32 sums over 600 samples
    taken in another order, through up to MAX_ITERS EM iterations)."""
    x = _samples(seed)
    outs, idx = _jax_fit(x, jax.random.PRNGKey(seed))
    got = em.fit_figueiredo(torch.as_tensor(x), torch.tensor([2, 2, 2]),
                            LMAX, MAX_ITERS, seed_idx=torch.as_tensor(idx))
    for m, want in enumerate(outs):
        assert int(got["nmix"][m]) == int(want["nmix"]), m
        # the mixture is slot-order invariant: compare live slots in order
        live_w = np.asarray(want["alive"])
        live_g = got["alive"][m].numpy()
        np.testing.assert_array_equal(live_g, live_w)
        for name in ("lam", "mu", "B"):
            np.testing.assert_allclose(got[name][m].numpy()[live_g],
                                       np.asarray(want[name])[live_w],
                                       rtol=2e-3, atol=2e-3,
                                       err_msg=f"model {m} {name}")


def test_fit_proposal_and_trim_shapes():
    """fit_proposal trims the slot axis to the largest live mixture and
    gives dead slots lam 0, mu 0, B = I, logdetB 0."""
    from automix_tpu_torch.config import EngineConfig
    from automix_tpu_torch.models.tutorial import tutorial_set
    x = torch.as_tensor(_samples(2))
    cfg = EngineConfig(max_mix_comps=LMAX, max_em_iters=MAX_ITERS)
    prop, tele = em.fit_proposal(tutorial_set(), cfg, x,
                                 torch.ones(3, 2),
                                 generator=torch.Generator().manual_seed(0))
    L = int(prop.nmix.max())
    assert prop.lam.shape == (3, L) and prop.B.shape == (3, L, 2, 2)
    np.testing.assert_allclose(prop.lam.sum(1).numpy(), 1.0, rtol=1e-5)
    for m in range(3):
        n = int(prop.nmix[m])
        assert (prop.lam[m, :n] > 0).all() and (prop.lam[m, n:] == 0).all()
        assert torch.equal(prop.B[m, n:], torch.eye(2).expand(L - n, 2, 2))
        assert (prop.logdetB[m, n:] == 0).all()
    assert tele["em_iters"].shape == (3,)
