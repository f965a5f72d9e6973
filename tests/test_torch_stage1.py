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
from automix_tpu_torch.ops import randoms
from _k3_moves import moves_then_update
from _torch_threads import one_torch_thread  # noqa: F401

C, NSWEEPS, SEED = 64, 200, 5


def test_schedule_matches_jax():
    for c, n, target in ((64, 200, 0), (1024, 2000, 0), (128, 500, 512),
                         (16, 50, 4000)):
        jcfg = JaxConfig(stage1_target_samples=target)
        cfg = EngineConfig(stage1_target_samples=target)
        assert fused_stage1.schedule(cfg, n, c, 2) == \
            jstage1._schedule(jcfg, n, c, 2)


@pytest.mark.parametrize("rule", ["aap", "log"])
def test_run_fused_stage1_matches_jax_interpret(rule):
    """Tutorial, C=64 chains per model, 200 sweeps (+20 burn-in), with
    the AAP or the log rule (JAX's in-kernel update of
    fused_stage1.py:669-673).  The words are bitwise equal and the
    integer accept counts make the pooled sig update exact, so
    trajectories agree except where CPU torch and XLA:CPU log/exp/cos
    differ by an ulp at a marginal accept.  Checked: every chain's final
    theta within 1e-4 on at least 95% of chains (on this CPU all agree,
    to 7e-6), the adapted sig within 1e-5 relative (seen: 7e-7
    absolute), the samples' moments within 2%."""
    jcfg = JaxConfig(seed=SEED, fused_stage1="on", stage1_adapt=rule)
    init = np.asarray(jtutorial.tutorial_set().init_points(None))
    want = [np.asarray(x) for x in jstage1.run_fused_stage1(
        jtutorial.tutorial_set(), jcfg, NSWEEPS, C, jnp.asarray(init))]
    cfg = EngineConfig(seed=SEED, stage1_adapt=rule)
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
                                        randoms.key(0), 100, "cpu")
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
    if name == "tutorial":
        return jtutorial.tutorial_set(), tutorial.tutorial_set()
    return getattr(jtoy, f"{name}_set")(), getattr(toy, f"{name}_set")()


def _init(name):
    if name == "tutorial":
        return np.asarray(jtutorial.tutorial_set().init_points(None))
    return _TOY_INIT[name]


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


@pytest.mark.parametrize("name,dof,rule", [
    pytest.param("toy2", 0, "aap", id="toy2-0"),
    pytest.param("toy1", 5, "aap", id="toy1-5"),
    pytest.param("tutorial", 0, "log", id="tutorial-0-log")])
def test_sweep_runner_matches_jax_sharded_and_segment_runner(name, dof,
                                                              rule):
    """The one-sweep runner (K3's twin with the pooled update inside each
    sweep, as the kernel applies it in its launch) against JAX
    ``run_fused_stage1_sharded`` on a 1-device CPU mesh, with the
    tolerances of the segment runner's JAX test, and BITWISE against the
    port's own segment runner (the rule in its kernel's twin) and against
    the moves-only runner (the twin's counts alone, the update between
    sweeps, the log rule's as JAX's seg_fn applies it outside its kernel,
    fused_stage1.py:239-243): same sig, samples, telemetry and logp."""
    from automix_tpu.parallel import mesh as mesh_lib
    init = _init(name)
    jms, ms = _toy_sets(name)
    nsweeps = 120
    jcfg = JaxConfig(seed=SEED, fused_stage1="on", student_t_dof=dof,
                     stage1_adapt=rule)
    want = [np.asarray(x) for x in jstage1.run_fused_stage1_sharded(
        jms, jcfg, nsweeps, C, jnp.asarray(init), mesh_lib.make_mesh(1))]
    cfg = EngineConfig(seed=SEED, student_t_dof=dof, stage1_adapt=rule)
    args = (ms, cfg, nsweeps, C, torch.tensor(init), "cpu")
    got = fused_stage1.run_fused_stage1_sweeps(*args)
    seg = fused_stage1.run_fused_stage1(*args)
    moves = fused_stage1.run_fused_stage1_sweeps(
        *args, sweep_fn=moves_then_update(fused_stage1.sweep_ref))
    for a, b, c in zip(got, seg, moves):
        assert torch.equal(a, b) and torch.equal(a, c)
    _agree_with_jax([x.numpy() for x in got], want)


@pytest.mark.parametrize("rule", ["aap", "log"])
def test_sweep_ref_update_mode_matches_moves_and_pooled_update(rule):
    """The one-sweep twin with the update (nacc and ntry given): the same
    theta and logp as its moves-only form, sig, nacc and ntry updated in
    place to what ``pooled_update`` makes of the moves-only counts, and
    left as they were on a block-move sweep (toy2, 5 x 64 chains, sweeps
    from the start, block moves after sweep 4)."""
    ms = toy.toy2_set()
    K, D, Cn = ms.nmodels, ms.dmax, 64
    theta = ms.init_points(randoms.key(0)).repeat_interleave(Cn, 0).T
    theta = theta.contiguous()
    sig = torch.where(torch.arange(D)[None] < torch.tensor(ms.dims)[:, None],
                      2.0, 0.0)
    sig0 = sig.clone()
    nacc = torch.zeros((K, D), dtype=torch.int32)
    ntry = torch.zeros((K, D), dtype=torch.int32)
    lp = torch.zeros(K * Cn)
    seed, nburn = 9, 4
    kinds = set()
    for t in range(1, 31):
        kw = dict(C=Cn, t=t, seed=seed, nburn=nburn, seg_start=t == 1)
        th_m, lp_m, cnt = fused_stage1.sweep_ref(ms, theta, lp, sig, **kw)
        block = t > nburn and randoms.block_coin(seed, t)
        want = fused_stage1.pooled_update(
            ms, sig, nacc, ntry, cnt, C=Cn, t=t, adapt=not block, rule=rule,
            log_gain=3.0)
        before = sig.clone()
        th_u, lp_u, none = fused_stage1.sweep_ref(
            ms, theta, lp, sig, nacc=nacc, ntry=ntry, rule=rule,
            log_gain=3.0, **kw)
        assert none is None
        assert torch.equal(th_u, th_m) and torch.equal(lp_u, lp_m)
        for got, w in zip((sig, nacc, ntry), want):
            assert torch.equal(got, w), t
        if block:
            assert torch.equal(sig, before)
        kinds.add(block)
        theta, lp = th_u, lp_u
    assert kinds == {True, False}
    assert int(ntry.sum()) > 0 and not torch.equal(sig, sig0)


@pytest.mark.parametrize("n,cap,segment", [
    (3 * 1024, 135168, True), (5 * 2048, 135168, True),
    (2 * 512, 29568, True), (29568, 29568, True), (29569, 29568, False),
    (1024, 0, False)])
def test_stage1_routing_rule(n, cap, segment):
    """The stage-1 rule is a function of the population and the segment
    kernel's resident capacity alone: K2 up to the capacity, inclusive
    (the H100's at the tutorial's and toy2's shapes, 135168, and at DDI's,
    29568), K3 above it, and K3 for everything where the card has no
    cooperative launch (capacity 0)."""
    assert fused_stage1.runs_segment_kernel(n, cap) is segment


def test_stage1_cpu_path_runs_the_twins():
    """On the CPU every population takes the segment runner, whose kernel
    is its plain twin there (toy2 at the CLI's 2048 chains per model,
    which K3 took while K2 was one block), and stage 1 counts no launch of
    either kernel."""
    cfg = EngineConfig(seed=1)
    assert fused_stage1.stage1_runner(toy.toy2_set(), cfg, 2048, "cpu") \
        is fused_stage1.run_fused_stage1
    before = (fused_stage1.segment.launches, fused_stage1.sweep.launches)
    cfg = dataclasses.replace(cfg, n_chains_stage1=16)
    rwm.run_stage1(toy.toy2_set(), cfg, randoms.key(0), 20, "cpu")
    assert (fused_stage1.segment.launches,
            fused_stage1.sweep.launches) == before
