"""HMC within-model moves in the port (``kernels/hmc.py``, the general
engine's hook, ``AMSampler.retune_hmc``) against the JAX package on the
CPU: one move on identical inputs against JAX's ``build_hmc_move``, the
shared trajectory length, the tuner from JAX's key, the contracts of
JAX's ``tests/test_hmc.py`` (moments, jumps, retune), and DDI's
gradient against JAX's patient-level density."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import hmc as jhmc
from automix_tpu.kernels import rjmcmc as jrjmcmc
from automix_tpu.models import ddi as jddi
from automix_tpu.models import toy as jtoy
from automix_tpu.models import tutorial as jtutorial
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.convert import chains_from_arrays, proposal_from_arrays
from automix_tpu_torch.kernels import hmc, rjmcmc
from automix_tpu_torch.models import builtin, ddi, toy, tutorial
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_general import _proposal


def _sets(name):
    if name == "tutorial":
        return tutorial.tutorial_set(), jtutorial.tutorial_set()
    return toy.toy1_set(), jtoy.toy1_set()


@pytest.mark.parametrize("name, n_steps", [("tutorial", 3), ("toy1", 5)])
def test_hmc_move_matches_jax(name, n_steps):
    """One HMC move of 1024 chains on identical inputs (JAX's chains
    after 20 sweeps, seeded momenta, uniforms and steps): the accept
    decision equal on >= 99% of chains, theta and logp of the agreeing
    chains within 1e-4 relative (float32 gradients of two libraries'
    log-densities)."""
    ms, jms = _sets(name)
    S = 1024
    jcfg = JaxConfig(seed=2, n_chains=S, fused="off", within_move="hmc")
    jchains = jrjmcmc.init_chains(jms, jcfg, jax.random.PRNGKey(1))
    prop = _proposal("tutorial") if name == "tutorial" else None
    if prop is not None:
        burn = jrjmcmc.build_chunk_runner(jms, jcfg, burning=True,
                                          collect=False)
        jchains, _ = burn(jchains, prop, 20)
    rng = np.random.default_rng(n_steps)
    D = jms.dmax
    k = np.asarray(jchains.k)
    theta = np.asarray(jchains.theta)
    logp = np.asarray(jchains.logp)
    mask = (np.arange(D)[None, :] < jms.dims[k][:, None]).astype(np.float32)
    u = rng.random(S).astype(np.float32)
    z = rng.normal(size=(S, D)).astype(np.float32)
    eps = (0.3 * rng.random((S, D)) + 0.05).astype(np.float32)
    move = jax.vmap(jhmc.build_hmc_move(jms, jcfg),
                    in_axes=(0, None, 0, 0, 0, 0, 0, 0))
    jt, jl, ja = move(u, jnp.int32(n_steps), z, k, theta, logp, eps, mask)
    t = torch.tensor
    th, lp, acc = hmc.hmc_move(ms, t(u), n_steps, t(z), t(k).long(),
                               t(theta), t(logp), t(eps), t(mask))
    same = acc.numpy() == np.asarray(ja)
    assert same.mean() >= 0.99, same.mean()
    assert 0.05 < acc.numpy().mean() < 0.999
    np.testing.assert_allclose(th.numpy()[same], np.asarray(jt)[same],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lp.numpy()[same], np.asarray(jl)[same],
                               rtol=1e-4, atol=1e-4)


def test_trajectory_length_stream_matches_jax():
    """The shared length per sweep from fold_in(key(seed ^ 0x177A7EC7),
    sweep), with and without jitter, equals JAX's over 300 sweeps."""
    for jitter in (True, False):
        cfg = EngineConfig(seed=12, within_move="hmc", hmc_steps=7,
                           hmc_jitter=jitter)
        jcfg = JaxConfig(seed=12, within_move="hmc", hmc_steps=7,
                         hmc_jitter=jitter)
        lk = jax.random.PRNGKey(12 ^ 0x177A7EC7)
        want = [int(jhmc.sample_n_steps(jcfg, jax.random.uniform(
            jax.random.fold_in(lk, np.uint32(s)), ()))) for s in range(300)]
        got = [rjmcmc.hmc_length(cfg, s) for s in range(300)]
        assert got == want
    assert set(got) == {7}


def test_tune_step_scale_matches_jax():
    """tune_step_scale on toy1 from JAX's key and sig (30 rounds, 128
    chains per model): the tuned multipliers within 2% of JAX's (the
    rounds' draws are JAX's words; an ulp-flipped accept moves a pooled
    rate by 1/128)."""
    ms, jms = _sets("toy1")
    sig = np.float32([[1.2, 0.0], [2.0, 1.5]])
    kw = dict(n_rounds=30, n_chains_per_model=128)
    jcfg = JaxConfig(seed=1, within_move="hmc")
    want = jhmc.tune_step_scale(jms, jcfg, jnp.asarray(sig),
                                jax.random.PRNGKey(17), **kw)
    got = hmc.tune_step_scale(ms, EngineConfig(seed=1, within_move="hmc"),
                              torch.tensor(sig), randoms.key(17), **kw)
    np.testing.assert_allclose(got, want, rtol=0.02)


def test_hmc_sweeps_match_jax():
    """3 general-engine sweeps with within_move='hmc' (fast stream, per-
    model scales) against JAX's XLA engine from the same chains: k
    agrees on >= 98% of chains, theta of those to 1e-4 and logp to 1e-4
    relative or 1e-3 absolute (JAX evaluates the tutorial's per-theta
    densities with gammaln, the port its column forms: 3e-4 apart read
    where the Beta density is steep)."""
    ms, jms = _sets("tutorial")
    S = 1024
    kw = dict(seed=6, n_chains=S, fused="off", within_move="hmc",
              hmc_step_scale=(0.3, 0.5, 0.4))
    jcfg, cfg = JaxConfig(**kw), EngineConfig(**kw)
    jprop = _proposal("tutorial")
    jchains = jrjmcmc.init_chains(jms, jcfg, jax.random.PRNGKey(3))
    burn = jrjmcmc.build_chunk_runner(jms, jcfg, burning=True,
                                      collect=False)
    jchains, _ = burn(jchains, jprop, 10)
    jrun = jrjmcmc.build_chunk_runner(jms, jcfg, burning=False,
                                      collect=False)
    jout, jchunk = jrun(jchains, jprop, 3)
    run = rjmcmc.build_chunk_runner(ms, cfg, burning=False, collect=False)
    out, chunk = run(chains_from_arrays(jchains), proposal_from_arrays(jprop),
                     3)
    same = out.k.numpy() == np.asarray(jout.k)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(out.theta.numpy()[same],
                               np.asarray(jout.theta)[same], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.logp.numpy()[same],
                               np.asarray(jout.logp)[same], rtol=1e-4,
                               atol=1e-3)
    assert int(chunk["ntryrwmb"]) == int(jchunk["ntryrwmb"]) == 3 * S
    assert abs(int(chunk["naccrwmb"]) - int(jchunk["naccrwmb"])) \
        <= 0.02 * 3 * S


def _cfg(**kw):
    base = dict(n_chains=256, n_chains_stage1=128, stage1_sweeps=400,
                sweep_chunk=200, max_em_iters=100, max_mix_comps=8, seed=31,
                within_move="hmc", hmc_steps=5, hmc_step_scale=0.2)
    base.update(kw)
    return EngineConfig(**base)


def test_hmc_normal_sampler_moments():
    """JAX's contract (tests/test_hmc.py): the N(0.5, 1) target's mean
    within 0.1 and sd within 0.1 after 200 + 800 sweeps of 256 chains,
    acceptance above 0.6; the general engine serves it."""
    am = AMSampler(builtin.normal_sampler_set(), _cfg(), device="cpu")
    am.burn_samples(200)
    stats = am.rjmcmc_samples(800)
    assert abs(stats.theta_mean()[0, 0] - 0.5) < 0.1
    assert abs(stats.theta_std()[0, 0] - 1.0) < 0.1
    assert stats.naccrwmb / stats.ntryrwmb > 0.6
    assert stats.ntryrwms == 0


def test_hmc_with_trans_dimensional_jumps():
    """JAX's contract: HMC within models and RJ across them keeps toy1's
    exact model probabilities within 0.06 (300 + 1500 sweeps)."""
    am = AMSampler(toy.toy1_set(), _cfg(seed=32), device="cpu")
    am.burn_samples(300)
    stats = am.rjmcmc_samples(1500)
    np.testing.assert_allclose(stats.model_probs, toy.TOY1_MODEL_PROBS,
                               atol=0.06)


def test_hmc_retune_api():
    """JAX's contract: the first burn tunes (per-model tuple installed,
    runners built), retune_hmc re-tunes and drops the runners, a re-fit
    re-tunes with a fresh key; the sampler's key chain is JAX's, so the
    first tuning's key is JAX's too."""
    cfg = EngineConfig(n_chains=64, n_chains_stage1=64, stage1_sweeps=200,
                       sweep_chunk=50, seed=7, within_move="hmc",
                       max_mix_comps=6, max_em_iters=60, trace_chain0=False)
    am = AMSampler(builtin.normal_params_set(), cfg, device="cpu")
    am.burn_samples(30)
    first = am.cfg.hmc_step_scale
    assert isinstance(first, tuple) and len(first) == 1
    assert am._runners
    scales = am.retune_hmc()
    assert not am._runners
    assert isinstance(am.cfg.hmc_step_scale, tuple)
    assert scales.shape == (1,)
    am.rjmcmc_samples(50)
    before = am.cfg.hmc_step_scale
    am.estimate_conditional_probs()
    assert isinstance(am.cfg.hmc_step_scale, tuple)
    assert am.cfg.hmc_step_scale != before
    # JAX's sampler: PRNGKey(7), split for stage 1, stage 2, the tuner
    k = jax.random.PRNGKey(7)
    for _ in range(3):
        k, sub = jax.random.split(k)
    k = randoms.key(7)
    for _ in range(3):
        k, mine = randoms.split_host(k, 2)
    assert mine == tuple(int(x) for x in np.asarray(sub))
    with pytest.raises(RuntimeError):
        AMSampler(builtin.normal_params_set(), dataclasses.replace(
            cfg, within_move="rwm"), device="cpu").retune_hmc()


def test_ddi_gradient_matches_the_patient_level_density():
    """DDI's HMC gradient: the port's autograd of the class-statistics
    density against jax.grad of JAX's patient-level ``_make_logp``
    (ddi_set(fused=False)) at 8 seeded points per model near the prior
    centres: every component within 1e-5 relative to the gradient's
    largest component (read: 6.4e-7; float32 sums over 467 patients in
    two orders), and 0 in the padded coordinates."""
    ms = ddi.ddi_set()
    jms = jddi.ddi_set(fused=False)
    rng = np.random.default_rng(0)
    for m, dim in enumerate(ms.dims):
        base = np.asarray(ms.models[m].init, np.float64)
        theta = np.zeros((8, ms.dmax), np.float32)
        theta[:, :dim] = base + rng.normal(scale=0.05, size=(8, dim)) \
            * np.maximum(np.abs(base), 0.2)
        k = np.full(8, m, np.int32)
        want = np.asarray(jax.vmap(jax.grad(jms.logpost_padded, argnums=1))(
            jnp.asarray(k), jnp.asarray(theta)))
        lp, got = ms.logpost_and_grad(torch.tensor(k).long(),
                                      torch.tensor(theta))
        assert bool(torch.isfinite(lp).all())
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert (np.abs(got.numpy() - want) <= 1e-5 * scale).all()
        np.testing.assert_array_equal(got.numpy()[:, dim:], 0.0)
