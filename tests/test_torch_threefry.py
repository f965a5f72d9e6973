"""JAX's threefry stream in the port (``ops/randoms.py``) against JAX 0.9
on the CPU, and the general engine's threefry runs.

The key functions and the uniform, randint and categorical words are
bitwise JAX's; the normals go through the port's ``erf_inv`` (XLA's
float32 polynomial, bitwise on all but ~1e-4 of the words, within 2
ulps).  Gamma is Marsaglia-Tsang with a key per draw: its accept
decisions follow JAX's words, and the float32 arithmetic of the accepted
draw matches XLA's on a stated share (XLA's CPU code contracts some
products into fused multiply-adds the port cannot see).  Then the
general engine's stage 3 and stage 1 on threefry against JAX's XLA
engine for a few sweeps from one state and key, Gaussian and Student-t,
a toy2 Student-t run end to end against its exact probabilities and its
whole AutoRJ pipeline against JAX's from one seed, and a checkpoint
resumed bit for bit."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from automix_tpu import AMSampler as JaxSampler
from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import rjmcmc as jrjmcmc
from automix_tpu.kernels import rwm as jrwm
from automix_tpu.models import toy as jtoy
from automix_tpu.ops import randoms as jrandoms
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.convert import chains_from_arrays, proposal_from_arrays
from automix_tpu_torch.kernels import rjmcmc, rwm
from automix_tpu_torch.models import toy
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_general import _per_theta, _proposal, _sets


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _keys(n, seed=0):
    """n JAX keys and the same words as the port's int64 tensor."""
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.tensor(np.asarray(jk).astype(np.int64))


# --- the words -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
def test_key_split_and_fold_in_bitwise(seed):
    """PRNGKey, split (one key, a batch of keys, a shape) and fold_in (an
    int, a per-key tensor) bitwise JAX's."""
    jk = jax.random.PRNGKey(seed)
    k = randoms.key(seed)
    assert k == tuple(int(x) for x in np.asarray(jk))
    np.testing.assert_array_equal(randoms.split(k, 5).numpy(),
                                  np.asarray(jax.random.split(jk, 5)))
    assert randoms.split_host(k, 3) == [
        tuple(int(x) for x in r) for r in np.asarray(jax.random.split(jk, 3))]
    jb, tb = _keys(1024, seed & 0xFFFF)
    np.testing.assert_array_equal(
        randoms.split(tb, (2, 3)).numpy(),
        np.asarray(jax.vmap(lambda kk: jax.random.split(kk, (2, 3)))(jb)))
    for data in (0, 1, 7, 123456, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            randoms.fold_in(tb, data).numpy(),
            np.asarray(jax.vmap(lambda kk: jax.random.fold_in(
                kk, np.uint32(data)))(jb)))
        assert randoms.fold_in(k, data) == tuple(
            int(x) for x in np.asarray(jax.random.fold_in(jk,
                                                          np.uint32(data))))
    sweeps = np.arange(1024, dtype=np.uint32) * 977
    np.testing.assert_array_equal(
        randoms.fold_in(tb, torch.tensor(sweeps.astype(np.int64))).numpy(),
        np.asarray(jax.vmap(jax.random.fold_in)(jb, sweeps)))


# (S, MU, MZ): draw_sweep_randoms' shapes for the tutorial at L = 8 and
# toy2 at L = 2, and stage 1's (D, D) at toy2
SHAPES = [(1024, 25, 4), (1024, 21, 10), (1024, 5, 5)]


@pytest.mark.parametrize("S, MU, MZ", SHAPES)
def test_uniform_normal_randint_categorical_bitwise(S, MU, MZ):
    """Per-key uniform [S, MU] and randint words bitwise JAX's; the
    normals [S, MZ] bitwise on all but 1e-4 of them and within 2 ulps;
    categorical draws over masked logits bitwise; a uniform of one key
    on the host bitwise."""
    jk, tk = _keys(S, MU)
    np.testing.assert_array_equal(
        randoms.uniform(tk, (MU,)).numpy(),
        np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (MU,)))(jk)))
    d = _ulps(randoms.normal(tk, (MZ,)).numpy(),
              np.asarray(jax.vmap(lambda kk: jax.random.normal(
                  kk, (MZ,)))(jk)))
    assert d.max() <= 2 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())
    for lo, hi in ((0, 5), (0, 3), (2, 1000)):
        np.testing.assert_array_equal(
            randoms.randint(tk, (MZ,), lo, hi).numpy(),
            np.asarray(jax.vmap(lambda kk: jax.random.randint(
                kk, (MZ,), lo, hi))(jk)))
    rng = np.random.default_rng(MU)
    logits = rng.normal(size=(S, MU)).astype(np.float32)
    logits[:, -1] = -np.inf
    want = np.asarray(jax.random.categorical(jk[0], logits))
    np.testing.assert_array_equal(
        randoms.categorical(tk[0], torch.tensor(logits)).numpy(), want)
    np.testing.assert_array_equal(
        randoms.categorical(randoms.key(MU), torch.tensor(logits)).numpy(),
        np.asarray(jax.random.categorical(jax.random.PRNGKey(MU), logits)))
    for i in range(8):
        assert randoms.uniform_host(tuple(int(x) for x in np.asarray(
            jk[i]))) == np.asarray(jax.random.uniform(jk[i], ()))


@pytest.mark.parametrize("dof, share", [(5, 0.8), (3, 0.99), (1, 0.99)])
def test_gamma_against_jax(dof, share):
    """Gamma(dof / 2) draws, [1024, 10] with a key per draw as rand_t
    makes them: every draw within 2e-6 relative of JAX's (its accept
    decisions are JAX's), at least ``share`` bitwise (read: 0.85 at dof 5,
    1.0 at dof 3, 0.999 at dof 1), and the draws pass a KS test against
    scipy's Gamma(dof / 2) at the 0.001 level."""
    jk, tk = _keys(1024, dof)
    want = np.asarray(jax.vmap(lambda kk: jax.random.gamma(
        jax.random.fold_in(kk, 1), 0.5 * dof, (10,)))(jk))
    got = randoms.gamma(randoms.fold_in(tk, 1), 0.5 * dof, (10,)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    assert (got == want).mean() >= share, (got == want).mean()
    assert scipy.stats.kstest(got.ravel(), "gamma",
                              args=(0.5 * dof,)).pvalue > 1e-3


@pytest.mark.parametrize("dof", [5, 3])
def test_rand_t_against_jax_and_student_t(dof):
    """rand_t [2048, 10] against JAX's ``rand_t`` from the same keys
    within 4e-6 relative (the gamma's ulps), and against scipy's t(dof)
    by a KS test at the 0.001 level."""
    jk, tk = _keys(2048, 10 + dof)
    want = np.asarray(jax.vmap(lambda kk: jrandoms.rand_t(kk, (10,),
                                                          dof))(jk))
    got = randoms.rand_t(tk, (10,), dof).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-6, atol=1e-6)
    assert scipy.stats.kstest(got.ravel(), "t", args=(dof,)).pvalue > 1e-3


@pytest.mark.parametrize("dof", [0, 5])
def test_draw_sweep_randoms_matches_jax(dof):
    """One sweep's (u, z) from the chains' keys at toy2's slots: u
    bitwise JAX's ``draw_sweep_randoms``, z within 4e-6 relative and
    bitwise on at least 80% (Gaussian: all but 1e-4)."""
    S, MU, MZ = 1024, 21, 10
    jk, tk = _keys(S, 3)
    ju, jz = jrjmcmc.draw_sweep_randoms(jk, jnp.int32(17), MU, MZ, dof,
                                        jnp.float32)
    u, z = rjmcmc.draw_sweep_randoms(tk, 17, MU, MZ, dof)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=4e-6,
                               atol=1e-6)
    same = (z.numpy() == np.asarray(jz)).mean()
    assert same >= (1 - 1e-4 if dof == 0 else 0.8), same


# --- stage 3 and stage 1 on threefry -------------------------------------


@pytest.mark.parametrize("name, dof", [("tutorial", 0), ("toy2", 0),
                                       ("toy2", 5)])
def test_threefry_sweeps_match_jax(name, dof):
    """5 sweeps of 1024 chains on JAX's threefry stream from JAX's
    init_chains after 20 JAX sweeps, keys included: k and the counters
    agree on >= 99% of chains, theta and logp of the agreeing chains to
    1e-4 relative, pk and the keys exactly where k agrees."""
    ms, jms = _sets(name)
    S = 1024
    jcfg = JaxConfig(seed=4, n_chains=S, fused="off", rng="threefry",
                     student_t_dof=dof)
    cfg = EngineConfig(seed=4, n_chains=S, fused="off", rng="threefry",
                       student_t_dof=dof)
    jprop = _proposal(name)
    jchains = jrjmcmc.init_chains(jms, jcfg, jax.random.PRNGKey(2))
    burn = jrjmcmc.build_chunk_runner(jms, jcfg, burning=True,
                                      collect=False)
    jchains, _ = burn(jchains, jprop, 20)
    start = chains_from_arrays(jchains)
    jrun = jrjmcmc.build_chunk_runner(jms, jcfg, burning=False,
                                      collect=False)
    jout, jchunk = jrun(jchains, jprop, 5)
    run = rjmcmc.build_chunk_runner(ms, cfg, burning=False, collect=False)
    out, chunk = run(start, proposal_from_arrays(jprop), 5)
    assert out.sweep == int(jout.sweep) == 26
    np.testing.assert_array_equal(out.key.numpy(), np.asarray(jout.key))
    same = out.k.numpy() == np.asarray(jout.k)
    assert same.mean() >= 0.99, same.mean()
    for got, want in ((out.theta, jout.theta), (out.logp, jout.logp),
                      (out.pk, jout.pk)):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=1e-4, atol=1e-4)
    assert int(jchunk["nacctd"]) > 0
    for key in ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
                "ntrytd"):
        want = int(jchunk[key])
        assert abs(int(chunk[key]) - want) <= 0.01 * max(want, 100), key


def test_init_chains_matches_jax():
    """init_chains from one key: the chain keys and k bitwise JAX's,
    theta equal, logp to float32 rounding."""
    ms, jms = _sets("toy2")
    cfg = EngineConfig(seed=1, n_chains=4096)
    jc = jrjmcmc.init_chains(jms, JaxConfig(seed=1, n_chains=4096),
                             jax.random.PRNGKey(11))
    c = rjmcmc.init_chains(ms, cfg, randoms.key(11), "cpu")
    np.testing.assert_array_equal(c.key.numpy(), np.asarray(jc.key))
    np.testing.assert_array_equal(c.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(c.theta.numpy(), np.asarray(jc.theta))
    np.testing.assert_allclose(c.logp.numpy(), np.asarray(jc.logp),
                               rtol=1e-6)


def test_sampler_key_chain_matches_jax():
    """AMSampler splits the seed's key in JAX's order: from a set
    proposal the chains' keys and k equal JAX's AMSampler's, and so do
    the keys of the next two uses (the SMC key, then the tuner's)."""
    from automix_tpu.sampler import AMSampler as JaxSampler
    ms, jms = _sets("toy2")
    jam = JaxSampler(jms, JaxConfig(seed=13, n_chains=512))
    jam.set_proposal(_proposal("toy2"))
    jam._ensure_chains()
    am = AMSampler(ms, EngineConfig(seed=13, n_chains=512), device="cpu")
    am.set_proposal(proposal_from_arrays(_proposal("toy2")))
    am._ensure_chains()
    np.testing.assert_array_equal(am.chains.key.numpy(),
                                  np.asarray(jam.chains.key))
    np.testing.assert_array_equal(am.chains.k.numpy(),
                                  np.asarray(jam.chains.k))
    for _ in range(2):
        assert am._next_key() == tuple(int(x) for x in
                                       np.asarray(jam._next_key()))


@pytest.mark.parametrize("name, dof", [("tutorial", 0), ("toy2", 5)])
def test_stage1_scan_matches_jax_on_one_key(name, dof):
    """The general stage 1 against JAX's ``_build_stage1_core`` from the
    same keys (64 chains per model, 33 sweeps, 4 snapshots): the final
    logp and the samples of the chains whose logp agrees (>= 97%) to
    1e-4 relative, sig to 2e-3 relative (a marginal accept that flips by
    an ulp moves a pooled count by one, and sig by 10 gamma / C)."""
    ms, jms = _sets(name)
    C, nsw, tail = 64, 30, 4
    jcfg = JaxConfig(seed=3, fused_stage1="off", student_t_dof=dof)
    cfg = EngineConfig(seed=3, fused_stage1="off", student_t_dof=dof)
    key, k_init, k_chains = jax.random.split(jax.random.PRNGKey(8), 3)
    init = jms.init_points(k_init)
    core, _ = jrwm._build_stage1_core(
        jms, jcfg, nsw, C, init, jax.random.fold_in(key, 7), n_tail=tail)
    K = jms.nmodels
    keys_kc = jax.random.split(k_chains, K * C).reshape(K, C, 2)
    jsig, jsmp, _, _, jlp = core(keys_kc)

    def tup(k):
        return tuple(int(x) for x in np.asarray(k))

    sig, smp, _, _, lp = rwm.run_general_stage1(
        ms, cfg, nsw, C, torch.tensor(np.asarray(init)), "cpu", tup(key),
        tup(k_chains), n_tail=tail)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=2e-3)
    same = np.isclose(lp.numpy(), np.asarray(jlp), rtol=1e-4, atol=1e-4)
    assert same.mean() >= 0.97, same.mean()
    jsmp = np.asarray(jsmp).reshape(K, C, tail, -1)
    smp = smp.numpy().reshape(K, C, tail, -1)
    np.testing.assert_allclose(smp[same], jsmp[same], rtol=1e-4, atol=1e-4)


# --- end to end ----------------------------------------------------------


def test_toy2_per_theta_student_t_meets_exact():
    """toy2 with per-theta densities and Student-t(5) perturbations on
    the general engine ("auto" resolves to threefry), at the sizes of
    tests/test_torch_general_posteriors.py (512 chains x 1000 sweeps after
    200 burn-in, toy2's own mixture as the proposal): p(M) within 0.02
    of the exact values."""
    am = AMSampler(_per_theta(toy.toy2_set()), EngineConfig(
        n_chains=512, sweep_chunk=500, seed=5, trace_chain0=False,
        student_t_dof=5), device="cpu")
    am.set_proposal(proposal_from_arrays(_proposal("toy2")))
    am.burn_samples(200)
    probs = am.rjmcmc_samples(1000).model_probs
    np.testing.assert_allclose(probs, toy.TOY2_MODEL_PROBS, atol=0.02)


def test_toy2_student_t_autorj_pipeline_matches_jax():
    """toy2 with Student-t(5) through stage 1 (256 chains per model, 110
    sweeps), AutoRJ and stage 3 (512 chains, 50 burn-in and 150 sweeps)
    from one seed, the port's general engine against JAX's XLA engine:
    both draw the same threefry words, so the stage-1 scales agree within
    1e-5 relative and p(M) within 1e-3 (read: equal; an ulp-flipped
    accept could part a chain)."""
    kw = dict(n_chains=512, n_chains_stage1=256, stage1_sweeps=100,
              mix_fit="autorj", student_t_dof=5, seed=7, sweep_chunk=100,
              trace_chain0=False)
    jam = JaxSampler(jtoy.toy2_set(), JaxConfig(**kw, fused="off",
                                                fused_stage1="off"))
    jam.estimate_conditional_probs()
    jam.burn_samples(50)
    want = jam.rjmcmc_samples(150, collect=False).model_probs
    am = AMSampler(_per_theta(toy.toy2_set()), EngineConfig(**kw),
                   device="cpu")
    am.estimate_conditional_probs()
    am.burn_samples(50)
    got = am.rjmcmc_samples(150).model_probs
    np.testing.assert_allclose(am.proposal.sig.numpy(),
                               np.asarray(jam.proposal.sig), rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_threefry_checkpoint_resumes_bitwise(tmp_path, caplog):
    """A Student-t run on threefry saved after 6 sweeps and resumed in a
    new sampler equals the unbroken run bit for bit; the checkpoint holds
    the keys as uint32 [S, 2].  A checkpoint without keys loads with the
    keys a whole run of that seed makes, and says so."""
    def sampler():
        am = AMSampler(_per_theta(toy.toy2_set()), EngineConfig(
            n_chains=128, sweep_chunk=4, seed=9, trace_chain0=False,
            student_t_dof=5), device="cpu")
        am.set_proposal(proposal_from_arrays(_proposal("toy2")))
        return am

    whole = sampler()
    whole.burn_samples(6)
    path = str(tmp_path / "ck.npz")
    whole.save(path)
    whole.rjmcmc_samples(10)
    again = sampler()
    again.load(path)
    again.rjmcmc_samples(10)
    for f in ("k", "theta", "logp", "pk", "key"):
        assert torch.equal(getattr(again.chains, f),
                           getattr(whole.chains, f)), f
    np.testing.assert_array_equal(again.stats.ksummary, whole.stats.ksummary)
    with np.load(path) as z:
        assert z["chains.key"].dtype == np.uint32
        assert z["chains.key"].shape == (128, 2)
        old = {n: z[n] for n in z.files if n != "chains.key"}
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, **old)
    third = sampler()
    with caplog.at_level(logging.INFO, logger="automix_tpu_torch"):
        third.load(legacy)
    assert "has no chains.key" in caplog.text
    np.testing.assert_array_equal(
        third.chains.key.numpy(),
        rjmcmc.init_keys(third.cfg, 128, "cpu").numpy())
    third.rjmcmc_samples(2)
