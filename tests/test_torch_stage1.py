"""Stage 1: the port's segment loop (plain twin of the segment kernel)
against the JAX fused stage-1 kernel run in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import fused_stage1 as jstage1
from automix_tpu.models import toy as jtoy
from automix_tpu.models import tutorial as jtutorial
from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.convert import stage1_state_from_numpy
from automix_tpu_torch.kernels import fused_stage1, rwm
from automix_tpu_torch.models import toy, tutorial
from _torch_threads import one_torch_thread  # noqa: F401

C, NSWEEPS, SEED = 64, 200, 5


def test_schedule_matches_jax():
    for c, n, target in ((64, 200, 0), (1024, 2000, 0), (128, 500, 512),
                         (16, 50, 4000)):
        jcfg = JaxConfig(stage1_target_samples=target)
        cfg = EngineConfig(stage1_target_samples=target)
        assert fused_stage1.schedule(cfg, n, c, 2) == \
            jstage1._schedule(jcfg, n, c, 2)


def test_run_fused_stage1_matches_jax_interpret():
    """Tutorial, C=64 chains per model, 200 sweeps (+20 burn-in).  The
    words are bitwise equal and the integer accept counts make the pooled
    sig update exact, so trajectories agree except where CPU torch and
    XLA:CPU log/exp/cos differ by an ulp at a marginal accept.  Checked:
    every chain's final theta within 1e-4 on at least 95% of chains (on
    this CPU all agree, to 7e-6), the adapted sig within 1e-5 relative
    (seen: 7e-7 absolute), the samples' moments within 2%."""
    jcfg = JaxConfig(seed=SEED, fused_stage1="on")
    init = np.asarray(jtutorial.tutorial_set().init_points(None))
    want = [np.asarray(x) for x in jstage1.run_fused_stage1(
        jtutorial.tutorial_set(), jcfg, NSWEEPS, C, jnp.asarray(init))]
    cfg = EngineConfig(seed=SEED)
    got = [x.numpy() for x in fused_stage1.run_fused_stage1(
        tutorial.tutorial_set(), cfg, NSWEEPS, C, torch.tensor(init),
        "cpu")]
    sig, samples, tele_sig, tele_acc, lp = got
    assert samples.shape == want[1].shape and tele_sig.shape == want[2].shape
    np.testing.assert_allclose(sig, want[0], rtol=1e-5)
    np.testing.assert_allclose(tele_sig, want[2], rtol=1e-5)
    np.testing.assert_allclose(tele_acc, want[3], atol=2e-3)
    close = np.all(np.abs(samples - want[1]) <= 1e-4 * (1 + np.abs(want[1])),
                   axis=-1)
    assert close.mean() >= 0.95, close.mean()
    for m in range(3):
        np.testing.assert_allclose(samples[m].mean(0), want[1][m].mean(0),
                                   rtol=0.02)
        np.testing.assert_allclose(samples[m].std(0), want[1][m].std(0),
                                   rtol=0.02)
    ok = np.abs(lp - want[4]) <= 1e-4 * (1 + np.abs(want[4]))
    assert ok.mean() >= 0.95


def test_segment_ref_from_jax_state_is_segment_invariant():
    """A state handed over from the JAX lane tiles (convert.py) runs on:
    two half segments give the same result as one whole segment, since
    every word depends on the global sweep only."""
    K, D = 3, 2
    ms = tutorial.tutorial_set()
    rng = np.random.default_rng(0)
    W = K * C // 8
    th = rng.uniform(0.5, 3.0, size=(D, 8, W)).astype(np.float32)
    sig = np.ones((D, 8, W), np.float32)
    zi = np.zeros((D, 8, W), np.int32)
    theta, sig_t, nacc, ntry = stage1_state_from_numpy(th, sig, zi, zi, C)
    assert theta.shape == (D, K * C) and sig_t.shape == (K, D)
    kw = dict(C=C, seed=9, nburn=10)
    whole = fused_stage1.segment_ref(ms, theta, sig_t, nacc, ntry,
                                     sweep0=0, n_active=40, **kw)
    half = fused_stage1.segment_ref(ms, theta, sig_t, nacc, ntry,
                                    sweep0=0, n_active=20, **kw)
    half = fused_stage1.segment_ref(ms, *half[:4], sweep0=20, n_active=20,
                                    **kw)
    for a, b in zip(whole, half):
        assert torch.equal(a, b)


def test_run_stage1_telemetry():
    cfg = dataclasses.replace(EngineConfig(seed=1), n_chains_stage1=32)
    sig, samples, tele = rwm.run_stage1(tutorial.tutorial_set(), cfg,
                                        torch.Generator(), 100, "cpu")
    assert sig.shape == (3, 2) and tele["nsweeps"] == 110
    assert samples.shape[0] == 3 and samples.shape[2] == 2
    acc = tele["accept_trace"].numpy()
    assert np.all((acc >= 0) & (acc <= 1))
    assert np.isfinite(samples.numpy()).all()


# toy1 and toy2 have no or zero start points; a fixed numpy start point
# goes to both packages.
_TOY_INIT = {"toy1": np.array([[0.3, 0.0], [0.2, 0.6]], np.float32),
             "toy2": np.linspace(-0.4, 0.4, 25).reshape(5, 5)
             .astype(np.float32) * np.tri(5, 5).astype(np.float32)}


def _toy_sets(name):
    return getattr(jtoy, f"{name}_set")(), getattr(toy, f"{name}_set")()


def _agree_with_jax(got, want):
    """The tolerance of test_run_fused_stage1_matches_jax_interpret."""
    sig, samples, tele_sig, tele_acc, lp = got
    assert samples.shape == want[1].shape and tele_sig.shape == want[2].shape
    np.testing.assert_allclose(sig, want[0], rtol=1e-5)
    np.testing.assert_allclose(tele_sig, want[2], rtol=1e-5)
    np.testing.assert_allclose(tele_acc, want[3], atol=2e-3)
    close = np.all(np.abs(samples - want[1]) <= 1e-4 * (1 + np.abs(want[1])),
                   axis=-1)
    assert close.mean() >= 0.95, close.mean()
    ok = np.abs(lp - want[4]) <= 1e-4 * (1 + np.abs(want[4]))
    assert ok.mean() >= 0.95


def test_segment_ref_student_t_matches_jax_interpret():
    """toy1 (dims 1 and 2) with Bailey t perturbations (dof 5): the
    segment runner against JAX ``run_fused_stage1`` at C=64, 200 sweeps,
    with the Normal test's tolerances (the t draws add one exp and one
    log per variate, each within an ulp between the libraries)."""
    init = _TOY_INIT["toy1"]
    jms, ms = _toy_sets("toy1")
    want = [np.asarray(x) for x in jstage1.run_fused_stage1(
        jms, JaxConfig(seed=SEED, fused_stage1="on", student_t_dof=5),
        NSWEEPS, C, jnp.asarray(init))]
    got = [x.numpy() for x in fused_stage1.run_fused_stage1(
        ms, EngineConfig(seed=SEED, student_t_dof=5), NSWEEPS, C,
        torch.tensor(init), "cpu")]
    _agree_with_jax(got, want)
    assert np.all(got[1][0, :, 1:] == 0.0)        # model 1 lacks coord 1


@pytest.mark.parametrize("name,dof", [("toy2", 0), ("toy1", 5)])
def test_sweep_runner_matches_jax_sharded_and_segment_runner(name, dof):
    """The one-sweep runner (K3's twin plus the pooled update between
    sweeps) against JAX ``run_fused_stage1_sharded`` on a 1-device CPU
    mesh, with the tolerances of the segment runner's JAX test, and
    BITWISE against the port's own segment runner: same sig, samples,
    telemetry and logp."""
    from automix_tpu.parallel import mesh as mesh_lib
    init = _TOY_INIT[name]
    jms, ms = _toy_sets(name)
    nsweeps = 120
    jcfg = JaxConfig(seed=SEED, fused_stage1="on", student_t_dof=dof)
    want = [np.asarray(x) for x in jstage1.run_fused_stage1_sharded(
        jms, jcfg, nsweeps, C, jnp.asarray(init), mesh_lib.make_mesh(1))]
    cfg = EngineConfig(seed=SEED, student_t_dof=dof)
    args = (ms, cfg, nsweeps, C, torch.tensor(init), "cpu")
    got = fused_stage1.run_fused_stage1_sweeps(*args)
    seg = fused_stage1.run_fused_stage1(*args)
    for a, b in zip(got, seg):
        assert torch.equal(a, b)
    _agree_with_jax([x.numpy() for x in got], want)


def test_stage1_routes_by_one_block_capacity():
    """K2's one block holds (D + 1) * K * C floats of 4 bytes beside its
    static shared arrays within 227 KiB: toy2 at the CLI's 2048 chains per
    model does not fit (K3), the tutorial at 1024 does (K2).  At toy2's
    bound the static arrays decide: 1930 chains per model would fit the
    dynamic part alone."""
    assert not fused_stage1.fits_one_block(5, 5, 2048)
    assert fused_stage1.fits_one_block(5, 5, 1024)
    assert fused_stage1.fits_one_block(3, 2, 1024)
    assert fused_stage1.fits_one_block(5, 5, 1929)
    assert 6 * 5 * 1930 * 4 <= fused_stage1._MAX_SMEM
    assert not fused_stage1.fits_one_block(5, 5, 1930)
    before = (fused_stage1.segment.launches, fused_stage1.sweep.launches)
    cfg = dataclasses.replace(EngineConfig(seed=1), n_chains_stage1=16)
    rwm.run_stage1(toy.toy2_set(), cfg, torch.Generator(), 20, "cpu")
    # the CPU path runs the twins and counts no launch
    assert (fused_stage1.segment.launches,
            fused_stage1.sweep.launches) == before
