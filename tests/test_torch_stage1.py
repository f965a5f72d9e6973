"""Stage 1: the port's segment loop (plain twin of the segment kernel)
against the JAX fused stage-1 kernel run in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import fused_stage1 as jstage1
from automix_tpu.models import tutorial as jtutorial
from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.convert import stage1_state_from_numpy
from automix_tpu_torch.kernels import fused_stage1, rwm
from automix_tpu_torch.models import tutorial
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
