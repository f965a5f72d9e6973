"""The general engine against the JAX package's XLA engine on the CPU.

Stage 3: a few sweeps of ``kernels/rjmcmc.py``'s chunk runner against
JAX's ``build_chunk_runner`` (``fused="off"``, ``rng="fast"``) from the same
converted chains and proposal.  Stage 1: the general scan against JAX's
XLA scan (``fused_stage1="off"``), statistically (its words are JAX's
threefry words, and tests/test_torch_threefry.py holds a few sweeps of
it to JAX's scan from one key).  And the engine
rule of ``AMSampler``: which engine serves which set, and its log line."""

import logging

import jax
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import rjmcmc as jrjmcmc
from automix_tpu.kernels import rwm as jrwm
from automix_tpu.models import toy as jtoy
from automix_tpu.models import tutorial as jtutorial
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch import AMSampler, EngineConfig, Model, ModelSet
from automix_tpu_torch.convert import chains_from_arrays, proposal_from_arrays
from automix_tpu_torch.kernels import fused, fused_stage1, rjmcmc, rwm
from automix_tpu_torch.kernels import sweep_rng
from automix_tpu_torch.models import toy, tutorial
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401

S = 1024
SWEEPS = 5


def _proposal(name):
    """A fixed proposal near each set's posterior: the tutorial's three
    models with two components each, toy2's five with its two mixture
    components (+5 with scale 1, -5 with scale 2)."""
    if name == "tutorial":
        modes = np.float32([[0.26, 0.38], [2.2, 4.0], [3.0, 8.0]])
        scale = np.float32([[0.06, 0.08], [0.8, 1.5], [1.0, 2.5]])
        K, L, D = 3, 2, 2
        lam = np.full((K, L), 0.5, np.float32)
        mu = np.stack([modes * 0.9, modes * 1.1], axis=1)
        B = np.zeros((K, L, D, D), np.float32)
        for k in range(K):
            for li, f in enumerate((1.0, 1.5)):
                B[k, li] = np.diag(scale[k] * f)
                B[k, li, 1, 0] = 0.1 * scale[k, 1]
        sig = scale
    else:
        K, L, D = 5, 2, 5
        lam = np.tile(np.float32([0.3, 0.7]), (K, 1))
        mu = np.zeros((K, L, D), np.float32)
        B = np.tile(np.eye(D, dtype=np.float32), (K, L, 1, 1))
        for k in range(K):
            mu[k, 0, :k + 1], mu[k, 1, :k + 1] = 5.0, -5.0
            B[k, 1, range(k + 1), range(k + 1)] = 2.0
        sig = np.tile(np.float32([2.0] * D), (K, 1))
    logdet = np.log(np.abs(np.diagonal(B, axis1=-2, axis2=-1)))
    dims = np.arange(1, D + 1) if name == "toy2" else np.full(K, D)
    logdet = (logdet * (np.arange(D)[None, None] < dims[:, None, None])
              ).sum(-1).astype(np.float32)
    return JaxProposal(lam=lam, mu=mu, B=B, logdetB=logdet,
                       nmix=np.full(K, L, np.int32), sig=sig)


def _sets(name):
    if name == "tutorial":
        return tutorial.tutorial_set(), jtutorial.tutorial_set()
    return toy.toy2_set(), jtoy.toy2_set()


CASES = [(name, pk_mode, perm) for name in ("tutorial", "toy2")
         for pk_mode in ("per_chain", "pooled") for perm in (False, True)]


@pytest.mark.parametrize("name, pk_mode, perm", CASES)
def test_chunk_runner_matches_jax(name, pk_mode, perm):
    """5 sweeps of 1024 chains, from JAX's init_chains after 20 JAX
    sweeps: k and the counters of the chunk agree on >= 99% of chains,
    theta and logp of the agreeing chains to 1e-4 relative (float32: the
    two libraries' exp, log and log1p differ by ulps, which moves an
    accepted state by as much), and the Kahan sums agree to the share of
    chains whose trajectories split."""
    ms, jms = _sets(name)
    jcfg = JaxConfig(seed=4, n_chains=S, fused="off", rng="fast",
                     pk_mode=pk_mode, perm=perm)
    cfg = EngineConfig(seed=4, n_chains=S, fused="off", rng="fast",
                       pk_mode=pk_mode, perm=perm)
    jprop = _proposal(name)
    jchains = jrjmcmc.init_chains(jms, jcfg, jax.random.PRNGKey(2))
    burn = jrjmcmc.build_chunk_runner(jms, jcfg, burning=True,
                                      collect=False)
    jchains, _ = burn(jchains, jprop, 20)
    start = chains_from_arrays(jchains)
    jrun = jrjmcmc.build_chunk_runner(jms, jcfg, burning=False,
                                      collect=False)
    jout, jchunk = jrun(jchains, jprop, SWEEPS)
    run = rjmcmc.build_chunk_runner(ms, cfg, burning=False, collect=False)
    out, chunk = run(start, proposal_from_arrays(jprop), SWEEPS)
    assert out.sweep == int(jout.sweep) == 1 + 20 + SWEEPS

    jk = np.asarray(jout.k)
    same = out.k.numpy() == jk
    assert same.mean() >= 0.99, same.mean()
    assert int(jchunk["nacctd"]) > 0
    for got, want in ((out.theta, jout.theta), (out.logp, jout.logp),
                      (out.pk, jout.pk)):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out.nreinit.numpy()[same],
                                  np.asarray(jout.nreinit)[same])
    assert int(jchunk["ntrytd"]) == int(chunk["ntrytd"]) == S * SWEEPS
    for key in ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd"):
        want = int(jchunk[key])
        assert abs(int(chunk[key]) - want) <= 0.01 * max(want, 100), key
    np.testing.assert_allclose(chunk["ksummary"].numpy(),
                               np.asarray(jchunk["ksummary"]),
                               rtol=0.01, atol=S * SWEEPS * 0.002)
    split = 1.0 - same.mean()
    for key in ("theta_sum", "theta_sqsum"):
        want = np.asarray(jchunk[key], np.float64)
        scale = np.abs(want).max() * (2 * split + 1e-4)
        np.testing.assert_allclose(chunk[key].numpy(), want, atol=scale,
                                   err_msg=key)


def test_collected_traces_follow_the_chains():
    """collect=True records per-sweep traces: chain 0's k, pk, logp and
    theta after each sweep, and the first n_trace_chains' k, as JAX's
    chunk scan does."""
    ms, _ = _sets("toy2")
    cfg = EngineConfig(seed=1, n_chains=64, fused="off", n_trace_chains=4)
    prop = proposal_from_arrays(_proposal("toy2"))
    chains = rjmcmc.init_chains(ms, cfg, randoms.key(0),
                                "cpu")
    run = rjmcmc.build_chunk_runner(ms, cfg, burning=False, collect=True)
    out, chunk = run(chains, prop, 6)
    assert chunk["k_trace"].shape == (6, 4)
    assert chunk["theta0_trace"].shape == (6, 5)
    assert int(chunk["k0_trace"][-1]) == int(out.k[0])
    np.testing.assert_array_equal(chunk["theta0_trace"][-1].numpy(),
                                  out.theta[0].numpy())
    assert int(chunk["ksummary"].sum()) == 64 * 6


@pytest.mark.parametrize("name, rule", [("toy2", "aap"),
                                        ("tutorial", "log")])
def test_stage1_scan_matches_jax_statistically(name, rule):
    """The general stage-1 scan (256 chains per model, 600 sweeps) against
    JAX's XLA scan at the same size: the final sig within 25% relative
    (each run's sig wanders by ~10% from the pooled acceptance noise of
    its last sweeps), and the tail samples' means and standard deviations
    within 5 Monte Carlo standard errors (the snapshots are thinned from
    an autocorrelated chain: the error counts 4 effective draws per
    chain)."""
    ms, jms = _sets(name)
    C, nsw = 256, 600
    cfg = EngineConfig(seed=3, fused_stage1="off", stage1_adapt=rule,
                       n_chains_stage1=C, stage1_target_samples=1024)
    jcfg = JaxConfig(seed=3, fused_stage1="off", stage1_adapt=rule,
                     n_chains_stage1=C, stage1_target_samples=1024)
    sig, samples, tele = rwm.run_stage1(ms, cfg, randoms.key(0), nsw,
                                        "cpu")
    jsig, jsamples, _ = jrwm.run_stage1(jms, jcfg, jax.random.PRNGKey(3),
                                        nsw)
    jsig, jsamples = np.asarray(jsig), np.asarray(jsamples)
    assert samples.shape == jsamples.shape
    assert tele["sig_trace"].shape == (6, ms.nmodels, ms.dmax)
    for k, m in enumerate(ms.models):
        d = m.dim
        np.testing.assert_allclose(sig[k, :d].numpy(), jsig[k, :d],
                                   rtol=0.25)
        x, y = samples[k, :, :d].numpy(), jsamples[k, :, :d]
        err = y.std(0) / np.sqrt(4 * C)
        assert (np.abs(x.mean(0) - y.mean(0)) < 5 * err + 1e-3).all(), k
        assert (np.abs(x.std(0) - y.std(0))
                < 5 * err + 0.05 * y.std(0)).all(), k


def _per_theta(ms):
    """The set's column densities wrapped as per-theta logp, with no CUDA
    density: a set only the general engine serves."""
    return ModelSet([Model(m.name, m.dim, init=m.init,
                           logp=(lambda th, f=m.logp_cols:
                                 f(list(th.unbind(0)))))
                     for m in ms.models])


def _log_lines(caplog):
    return [r.getMessage() for r in caplog.records
            if r.name == "automix_tpu_torch"]


def test_engine_rule_picks_and_logs(caplog):
    """Kernels for a set with CUDA densities at a compiled shape, the
    general engine for a per-theta set, for fused='off', and for a
    (K, D) the kernels lack; each runner build logs its engine and why.
    On the CPU the kernels' wrappers run their twins and K4 its twin."""
    caplog.set_level(logging.INFO, logger="automix_tpu_torch")
    cfg = EngineConfig()
    ms = toy.toy2_set()
    assert fused.eligible(ms, cfg, 10, "cpu")[0]
    assert fused_stage1.stage1_eligible(ms, cfg)[0]
    for other, reason in ((_per_theta(ms), "no CUDA density"),
                          (ms, "fused='off'")):
        c = EngineConfig(fused="off") if reason == "fused='off'" else cfg
        ok, why = fused.eligible(other, c, 10, "cpu")
        assert not ok and reason in why
    lin = ModelSet.from_callback(2, [2, 3],
                                 lambda k, th: -0.5 * (th * th).sum())
    ok, why = fused.eligible(lin, cfg, 4, "cpu")
    assert not ok and "no CUDA density" in why
    wide = ModelSet([Model(f"m{i}", 7, logp_cols=lambda r: -0.5 * r[0] ** 2,
                           cuda=toy.toy2_set().models[0].cuda)
                     for i in range(2)])
    ok, why = fused.eligible(wide, cfg, 4, "cpu")
    assert not ok and "(K, D) = (2, 7)" in why
    ok, why = fused.eligible(ms, cfg, 40, "cpu")
    assert not ok and "L=40" in why

    am = AMSampler(_per_theta(ms), EngineConfig(
        n_chains=64, n_chains_stage1=32, stage1_sweeps=40,
        stage1_target_samples=64, max_mix_comps=3, max_em_iters=30,
        sweep_chunk=10, seed=2, rng="pallas", trace_chain0=False),
        device="cpu")
    before = (fused.sweep_chunk.launches, sweep_rng.draw.launches)
    am.estimate_conditional_probs()
    am.burn_samples(10)
    am.rjmcmc_samples(10)
    assert (fused.sweep_chunk.launches, sweep_rng.draw.launches) == before
    lines = _log_lines(caplog)
    assert any(line.startswith("stage 1: general engine") for line in lines)
    assert any(line.startswith("stage-3 burn-in runner: general engine "
                               "(models ") for line in lines)
    assert any(line.startswith("stage-3 production runner: general")
               for line in lines)


def test_fused_on_raises_for_a_set_the_kernels_cannot_serve():
    ms = _per_theta(toy.toy2_set())
    with pytest.raises(ValueError, match="fused='on'"):
        fused.eligible(ms, EngineConfig(fused="on"), 4, "cpu")
    with pytest.raises(ValueError, match="fused_stage1='on'"):
        fused_stage1.stage1_eligible(ms, EngineConfig(fused_stage1="on"))
    am = AMSampler(ms, EngineConfig(fused_stage1="on"), device="cpu")
    with pytest.raises(ValueError, match="fused_stage1='on'"):
        am.estimate_conditional_probs(nsweep2=10)


def test_student_t_and_threefry_raise_on_the_general_engine():
    """JAX sends Student-t runs on its XLA engine to threefry, and so does
    the port: the general engine builds both stages' runs for them
    (tests/test_torch_threefry.py holds their words and sweeps to JAX's).
    What raises is what raises in JAX: a Gaussian-only stream asked for
    a Student-t run.  The kernels keep running Student-t."""
    ms = _per_theta(toy.toy2_set())
    cfg = EngineConfig(student_t_dof=5)
    assert sweep_rng.resolve_rng(cfg) == "threefry"
    rjmcmc.build_chunk_runner(ms, cfg, burning=True, collect=False)
    sig, _, _ = rwm.run_stage1(ms, cfg, randoms.key(0), 10, "cpu",
                               n_chains_per_model=8)
    assert bool(torch.isfinite(sig).all())
    for rng in ("fast", "pallas"):
        with pytest.raises(ValueError, match="student_t_dof"):
            EngineConfig(rng=rng, student_t_dof=5)
    assert EngineConfig(rng="threefry").rng == "threefry"
    assert fused.eligible(toy.toy2_set(), cfg, 4, "cpu")[0]


def test_cuda_device_without_cuda_still_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AMSampler(_per_theta(toy.toy2_set()), EngineConfig(fused="off"))
