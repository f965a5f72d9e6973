"""SMC evidences in the port (``kernels/smc.py``,
``AMSampler.smc_evidence``) against the JAX package on the CPU: the
resampling indices, the mixture density and draws from the same keys,
a whole run from the same key and proposal, and the contracts of JAX's
``tests/test_smc.py`` (toy1's exact evidences, the tutorial's published
probabilities, adaptive against linear tempering)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import smc as jsmc
from automix_tpu.models import toy as jtoy
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.convert import proposal_from_arrays
from automix_tpu_torch.kernels import smc
from automix_tpu_torch.models import toy, tutorial
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_general import _proposal


def _tup(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("n", [1024, 4096])
def test_systematic_resample_matches_jax(n):
    """Systematic resampling of 16 seeded log-weight vectors, each with
    its own key: the indices JAX's on all but 1e-3 of them (XLA sums the
    cumulative weights in another order than torch, so a point within an
    ulp of a boundary can take its neighbour)."""
    rng = np.random.default_rng(n)
    bad = 0
    for i in range(16):
        logw = (rng.normal(size=n) * (1 + i % 4)).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(n), i)
        want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(logw),
                                                    n))
        got = smc._systematic_resample(_tup(key), torch.tensor(logw),
                                       n).numpy()
        assert got.shape == want.shape and got.min() >= 0
        bad += int((got != want).sum())
    assert bad <= 1e-3 * 16 * n, bad


def test_systematic_resample_past_the_end_stays_in_range():
    """16384 seeded log-weights (spread 4) whose float32 cumulative sum
    ends below 1, in XLA's order as in torch's, and a key whose offset
    (0.99401) puts the last point past that end: JAX gives it the index N, which its gather fills with
    NaN (``automix_tpu/kernels/smc.py:77,193``), and with it the model's
    evidence.  The port gives it the last particle of positive weight,
    and JAX's other indices on all but 1% (the sums' order differs)."""
    n = 16384
    logw = (np.random.default_rng(0).normal(size=n) * 4).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(1), 131)
    want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(logw), n))
    past = want >= n
    assert past.sum() == 1
    assert bool(jnp.isnan(jnp.take_along_axis(
        jnp.asarray(logw), jnp.asarray(want), axis=0)).any())
    got = smc._systematic_resample(_tup(key), torch.tensor(logw), n).numpy()
    lw = torch.tensor(logw)
    last = np.flatnonzero((torch.exp(lw - torch.logsumexp(lw, 0)) > 0)
                          .numpy())[-1]
    assert got.max() < n and (got[past] == last).all()
    assert (got[~past] != want[~past]).sum() <= 0.01 * n


def test_mixture_density_and_draws_match_jax():
    """On toy2's proposal, from the same per-particle keys: the mixture
    components drawn equal JAX's, the particles within 1e-5, and log q of
    them within 1e-5 relative of JAX's ``_mixture_logq``."""
    jprop = _proposal("toy2")
    prop = proposal_from_arrays(jprop)
    ms = toy.toy2_set()
    K, D, N = 5, 5, 512
    dims = torch.as_tensor(ms.dims).long()
    keys = jax.random.split(jax.random.PRNGKey(5), K * N).reshape(K, N, 2)
    want = jax.vmap(lambda keys_k, lam_k, mu_k, B_k, d: jax.vmap(
        lambda kk: jsmc._sample_mixture(kk, lam_k, mu_k, B_k, d, D,
                                        jnp.float32))(keys_k))(
        keys, jprop.lam, jprop.mu, jprop.B, jnp.asarray(ms.dims))
    got = smc._sample_mixture(torch.tensor(np.asarray(keys).astype(np.int64)),
                              prop.lam, prop.mu, prop.B, dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    jq = jax.vmap(lambda th, lam_k, mu_k, B_k, d: jsmc._mixture_logq(
        th, lam_k, mu_k, B_k, None, d))(
        want, jprop.lam, jprop.mu, jprop.B, jnp.asarray(ms.dims))
    q = smc._mixture_logq(torch.tensor(np.asarray(want)), prop.lam, prop.mu,
                          prop.B, dims)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tempering", ["adaptive", "linear"])
def test_run_smc_matches_jax_on_one_key(tempering):
    """A whole run on toy1's seeded proposal from JAX's key (1024
    particles, 10 steps, 2 moves): the same ladder (the adaptive betas
    within 1e-3), log evidences within 0.02 and ESS within 2% of JAX's
    (the draws are JAX's words; ulp-flipped accepts let a few particles'
    paths split)."""
    ms, jms = toy.toy1_set(), jtoy.toy1_set()
    K, L, D = 2, 3, 2
    lam = np.float32([[0.2, 0.8, 0.0], [1 / 3, 1 / 3, 1 / 3]])
    mu = np.float32([[[-3, 0], [2, 0], [0, 0]],
                     [[0, 3], [-4, 1], [4, 1]]])
    B = np.tile(np.eye(D, dtype=np.float32), (K, L, 1, 1)) * 1.2
    B[0, :, 1, 1] = 1.0
    logdet = np.log(np.abs(np.diagonal(B, axis1=-2, axis2=-1)))
    logdet = (logdet * (np.arange(D) < ms.dims[:, None, None])).sum(-1)
    jprop = JaxProposal(
        lam=jnp.asarray(lam), mu=jnp.asarray(mu), B=jnp.asarray(B),
        logdetB=jnp.asarray(logdet, jnp.float32),
        nmix=jnp.int32(np.int32([2, 3])),
        sig=jnp.asarray(np.float32([[1.5, 1.0], [2.0, 2.0]])))
    kw = dict(n_particles=1024, n_temps=10, n_moves=2, tempering=tempering)
    want = jsmc.run_smc(jms, JaxConfig(), jprop, jax.random.PRNGKey(9), **kw)
    got = smc.run_smc(ms, EngineConfig(), proposal_from_arrays(jprop),
                      randoms.key(9), **kw)
    np.testing.assert_allclose(got["betas_used"],
                               np.asarray(want["betas_used"]), atol=1e-3)
    np.testing.assert_allclose(got["log_evidence"],
                               np.asarray(want["log_evidence"]), atol=0.02)
    np.testing.assert_allclose(got["ess"], np.asarray(want["ess"]),
                               rtol=0.02)
    assert got["theta"].shape == np.asarray(want["theta"]).shape


def _cfg(**kw):
    base = dict(n_chains=64, n_chains_stage1=256, stage1_sweeps=500,
                sweep_chunk=100, max_em_iters=150, max_mix_comps=10, seed=41)
    base.update(kw)
    return EngineConfig(**base)


def test_smc_toy1_exact_evidences():
    """JAX's contract: toy1's evidences are its weights, p(M) within 0.04
    of (0.3, 0.7) and log Z within 0.1 of their logs (1024 particles,
    n_temps 10, n_moves 2)."""
    am = AMSampler(toy.toy1_set(), _cfg(), device="cpu")
    out = am.smc_evidence(n_particles=1024, n_temps=10, n_moves=2)
    np.testing.assert_allclose(out["model_probs"], toy.TOY1_MODEL_PROBS,
                               atol=0.04)
    np.testing.assert_allclose(out["log_evidence"],
                               np.log(toy.TOY1_MODEL_PROBS), atol=0.1)


def test_smc_tutorial_matches_published():
    """JAX's contract: the tutorial's p(M) within 0.05 of the published
    values and every step's ESS above 0.2 N (1024 particles)."""
    am = AMSampler(tutorial.tutorial_set(), _cfg(seed=42), device="cpu")
    out = am.smc_evidence(n_particles=1024, n_temps=12, n_moves=2)
    np.testing.assert_allclose(out["model_probs"],
                               tutorial.TUTORIAL_MODEL_PROBS, atol=0.05)
    assert np.min(out["ess"]) > 0.2 * 1024


def test_smc_adaptive_tempering_matches_linear():
    """JAX's contract: adaptive and linear tempering on toy1 both within
    0.06 of the exact p(M) and 0.15 of each other in log Z; the adaptive
    ladder is monotone, ends at 1 and stops far below its cap of 40."""
    cfg = EngineConfig(n_chains_stage1=256, stage1_sweeps=400, seed=3,
                       max_mix_comps=8, max_em_iters=100)
    am = AMSampler(toy.toy1_set(), cfg, device="cpu")
    am.estimate_conditional_probs()
    out_a = am.smc_evidence(n_particles=1024, n_temps=40, n_moves=2,
                            tempering="adaptive")
    out_l = am.smc_evidence(n_particles=1024, n_temps=20, n_moves=2,
                            tempering="linear")
    for out in (out_a, out_l):
        np.testing.assert_allclose(out["model_probs"], toy.TOY1_MODEL_PROBS,
                                   atol=0.06)
    np.testing.assert_allclose(out_a["log_evidence"], out_l["log_evidence"],
                               atol=0.15)
    bu = np.asarray(out_a["betas_used"])
    assert np.all(np.diff(np.vstack([np.zeros((1, 2)), bu]), axis=0) >= 0)
    assert np.all(bu[-1] == 1.0)
    n_steps = int((bu < 1.0).sum(axis=0).max()) + 1
    assert n_steps < 40, n_steps
