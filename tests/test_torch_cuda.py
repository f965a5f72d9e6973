"""The port's CUDA kernels against their plain PyTorch twins on the card.

Marked ``cuda``: without an NVIDIA GPU (and nvcc) every test here skips.
This file imports no JAX, so it runs where JAX is not installed; on a
machine with a card (``--noconftest`` skips the JAX-side test settings):

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist \
        -o addopts= --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.kernels import _build, fused, fused_stage1
from automix_tpu_torch.model import ModelSet
from automix_tpu_torch.models import builtin, changepoint, ddi, rb9, toy
from automix_tpu_torch.models.tutorial import TUTORIAL_MODEL_PROBS, \
    tutorial_set
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.state import Proposal
from _k3_moves import moves_then_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_sweep_kernel_matches_twin(cuda):
    """K1, 4096 chains x 30 sweeps after a short CUDA run: k equal on
    >= 99% of chains, theta and logp within 1e-4 on those."""
    am = AMSampler(tutorial_set(), EngineConfig(
        n_chains=4096, n_chains_stage1=256, stage1_sweeps=300,
        max_mix_comps=10, seed=2), device="cuda")
    am.burn_samples(50)
    tabs = fused.prep_tables(am.proposal, am.modelset.dims)
    ch = am.chains
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit)
    for adapt in (False, True):
        kw = dict(seed=2, sweep0=ch.sweep, n_sweeps=30, adapt=adapt)
        got = fused.sweep_chunk(am.modelset, *args, tabs, **kw)
        want = fused.sweep_chunk_ref(am.modelset, *args, tabs, **kw)
        same = got[0] == want[0]
        assert same.float().mean() >= 0.99
        torch.testing.assert_close(got[1][:, same], want[1][:, same],
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-4,
                                   atol=1e-4)


def test_wrappers_check_inputs(cuda):
    ms = tutorial_set()
    theta = torch.zeros((2, 96), dtype=torch.float64, device=cuda)
    sig = torch.ones((3, 2), device=cuda)
    zi = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fused_stage1.segment(ms, theta, sig, zi, zi, C=32, sweep0=0, seed=1,
                             nburn=0, n_active=1)


def test_tutorial_on_the_card(cuda):
    """The whole slice on the card at a small size: p(M) within 0.02 of
    the published values (8192 chains x 2000 sweeps)."""
    am = AMSampler(tutorial_set(), EngineConfig(
        n_chains=8192, n_chains_stage1=512, stage1_sweeps=1000,
        max_mix_comps=10, sweep_chunk=500, seed=4), device="cuda")
    am.burn_samples(500)
    stats = am.rjmcmc_samples(2000)
    assert abs(stats.model_probs - TUTORIAL_MODEL_PROBS).max() < 0.02


def _toy2_proposal(L=3):
    """A toy2 proposal around the two modes (+5 and -5 on each coordinate)
    of every model, made from a numpy seed."""
    rng = np.random.default_rng(0)
    K, D = 5, 5
    mask = np.arange(D)[None, :] < np.arange(1, 6)[:, None]
    mu = np.where(np.arange(L) % 2 == 0, -5.0, 5.0)[None, :, None] \
        + 0.3 * rng.normal(size=(K, L, D))
    B = np.eye(D) * rng.uniform(0.8, 2.0, (K, L, 1, D))
    keep = mask[:, None, :, None] & mask[:, None, None, :]
    B = np.where(keep, B, np.eye(D))
    logdet = np.sum(np.log(np.diagonal(B, axis1=-2, axis2=-1))
                    * mask[:, None, :], axis=-1)
    t = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return Proposal(lam=t(rng.dirichlet(np.ones(L), size=K)),
                    mu=t(mu * mask[:, None, :]), B=t(B), logdetB=t(logdet),
                    nmix=torch.full((K,), L, dtype=torch.int32),
                    sig=t(1.5 * mask))


@pytest.mark.parametrize("name,C,rule", [("toy2", 2048, "aap"),
                                         ("cpt", 1024, "log")])
def test_sweep_runner_matches_segment_runner(cuda, name, C, rule):
    """The K3 runner against the K2 runner, both on the card, at the
    populations the CLI and JAX's configuration give stage 1 (toy2 at 5 x
    2048 chains, cpt at 6 x 1024 with the log rule), 300 sweeps (+30
    burn-in): sig, samples, telemetry and logp bitwise equal, with one K2
    launch per segment and one K3 launch per sweep."""
    ms = _SHAPE_SETS[name]()
    init = ms.init_points(randoms.key(0))
    cfg = EngineConfig(seed=3, stage1_adapt=rule)
    before = (fused_stage1.segment.launches, fused_stage1.sweep.launches)
    a = fused_stage1.run_fused_stage1_sweeps(ms, cfg, 300, C, init, cuda)
    b = fused_stage1.run_fused_stage1(ms, cfg, 300, C, init, cuda)
    n_seg = fused_stage1.schedule(cfg, 300, C, ms.dmax)[3]
    assert (fused_stage1.segment.launches,
            fused_stage1.sweep.launches) == (before[0] + n_seg,
                                             before[1] + 330)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("variant", [dict(perm=True),
                                     dict(tdist=randoms.student_t(5)),
                                     dict(perm=True,
                                          tdist=randoms.student_t(5))],
                         ids=["perm", "student_t", "perm_student_t"])
def test_sweep_kernel_variants_match_twin(cuda, variant):
    """K1's perm and Student-t variants on toy2, 4096 chains x 30 sweeps
    from the origin under a two-mode proposal: k equal on >= 99% of
    chains, theta and logp within 1e-4 on those."""
    ms = toy.toy2_set()
    S = 4096
    tabs = fused.prep_tables(_toy2_proposal(), ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(cuda)
                         for f in tabs.__dataclass_fields__})
    k = (torch.arange(S, device=cuda) % 5).to(torch.int32)
    theta = torch.zeros((5, S), device=cuda)
    logp = ms.logpost_cols(k.long(), list(theta))
    pk = torch.full((5, S), 0.2, device=cuda)
    args = (k, theta, logp, pk, torch.full((S,), 0.1, device=cuda),
            torch.ones(S, dtype=torch.int32, device=cuda))
    kw = dict(seed=2, sweep0=11, n_sweeps=30, adapt=True, **variant)
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    want = fused.sweep_chunk_ref(ms, *args, tabs, **kw)
    same = got[0] == want[0]
    assert same.float().mean() >= 0.99
    assert (got[0] != k).float().mean() > 0.05        # dimension changes
    torch.testing.assert_close(got[1][:, same], want[1][:, same],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("variant", [dict(), dict(perm=True),
                                     dict(tdist=randoms.student_t(5)),
                                     dict(perm=True,
                                          tdist=randoms.student_t(5))],
                         ids=["normal", "perm", "student_t",
                              "perm_student_t"])
def test_hw_sweep_kernel_variants_match_twin(cuda, variant):
    """K1f, the hw stream, in each of the four variants on toy2: 4096
    chains x 30 sweeps from the origin under a two-mode proposal, one
    launch counted in ``hw_launches`` and none in ``launches``; k equal to
    the twin's (the same stream in torch) on >= 99% of chains, theta and
    logp within 1e-4 on those."""
    ms = toy.toy2_set()
    S = 4096
    tabs = fused.prep_tables(_toy2_proposal(), ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(cuda)
                         for f in tabs.__dataclass_fields__})
    k = (torch.arange(S, device=cuda) % 5).to(torch.int32)
    theta = torch.zeros((5, S), device=cuda)
    logp = ms.logpost_cols(k.long(), list(theta))
    pk = torch.full((5, S), 0.2, device=cuda)
    args = (k, theta, logp, pk, torch.full((S,), 0.1, device=cuda),
            torch.ones(S, dtype=torch.int32, device=cuda))
    kw = dict(seed=2, sweep0=11, n_sweeps=30, adapt=True, rng="hw",
              **variant)
    before = (fused.sweep_chunk.launches, fused.sweep_chunk.hw_launches)
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    assert (fused.sweep_chunk.launches,
            fused.sweep_chunk.hw_launches) == (before[0], before[1] + 1)
    want = fused.sweep_chunk_ref(ms, *args, tabs, **kw)
    hashed = fused.sweep_chunk(ms, *args, tabs, **dict(kw, rng="hash"))
    same = got[0] == want[0]
    assert same.float().mean() >= 0.99
    assert (got[0] != k).float().mean() > 0.05        # dimension changes
    assert (got[0] != hashed[0]).float().mean() > 0.05   # other words
    torch.testing.assert_close(got[1][:, same], want[1][:, same],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-4,
                               atol=1e-4)


def test_toy2_on_the_card(cuda):
    """toy2 with perm on the card at 8192 chains x 2000 sweeps: p(M)
    within 0.02 of the exact 0.5 / 0.25 / 0.125 / 0.0625 / 0.0625."""
    am = AMSampler(toy.toy2_set(), EngineConfig(
        n_chains=8192, n_chains_stage1=512, stage1_sweeps=1000,
        max_mix_comps=10, sweep_chunk=500, seed=4, perm=True,
        trace_every=16), device="cuda")
    am.burn_samples(500)
    stats = am.rjmcmc_samples(2000)
    assert abs(stats.model_probs - toy.TOY2_MODEL_PROBS).max() < 0.02
    assert stats.k_trace.shape == (125, 8)


# One model set for each instantiated (K, D): the builtin sets (1, 1),
# (1, 2) and (2, 2), toy1 (2, 2), the tutorial (3, 2), toy2 (5, 5), rb9
# (10, 5), DDI (2, 16), whose sweep kernel is the cached form K1e, and
# change-point (6, 13).
_SHAPE_SETS = {"normal": builtin.normal_sampler_set,
               "normal_params": builtin.normal_params_set,
               "gamma_beta": builtin.gamma_beta_set,
               "toy1": toy.toy1_set, "tutorial": tutorial_set,
               "toy2": toy.toy2_set, "rb9": rb9.rb9_set, "ddi": ddi.ddi_set,
               "cpt": changepoint.cpt_set}


def test_shape_sets_cover_every_instantiation():
    assert {(f().nmodels, f().dmax) for f in _SHAPE_SETS.values()} \
        == set(_build.SHAPES)


def _stage1_state(ms, C, dev, scale):
    K, D = ms.nmodels, ms.dmax
    init = ms.init_points(randoms.key(0))
    theta = init[torch.arange(K * C) // C].T.contiguous().to(dev)
    mask = torch.arange(D)[None] < torch.as_tensor(ms.dims)[:, None]
    return theta, (scale * mask).float().to(dev)


def _assert_segment_matches(ms, C, dev, tdist):
    """K2 against segment_ref on the card, one 100-sweep segment (block
    moves after sweep 50): one launch, sig within 1e-6 relative and
    counts exact (integer accept counts), theta within 1e-5 on >= 99% of
    lanes (ulp-level libm differences could flip a marginal accept)."""
    theta, sig = _stage1_state(ms, C, dev, 10.0)
    zi = torch.zeros(sig.shape, dtype=torch.int32, device=dev)
    kw = dict(C=C, sweep0=0, seed=777, nburn=50, n_active=100, tdist=tdist)
    before = fused_stage1.segment.launches
    got = fused_stage1.segment(ms, theta, sig, zi, zi, **kw)
    assert fused_stage1.segment.launches == before + 1
    want = fused_stage1.segment_ref(ms, theta, sig, zi, zi, **kw)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    close = ((got[0] - want[0]).abs() <= 1e-5 * (1 + want[0].abs())).all(0)
    assert close.float().mean() >= 0.99


@pytest.mark.parametrize("dof", [0, 5])
@pytest.mark.parametrize("name", list(_SHAPE_SETS))
def test_stage1_kernels_match_twins_at_every_shape(cuda, name, dof):
    """K2 (one segment, 256 chains per model) and K3 (2048 chains per
    model, the CLI default, over several blocks; 40 sweeps, one launch
    each, equal accept counts every sweep, theta and logp within 1e-5 on
    >= 99% of lanes) against their twins run on the card, at every
    instantiated (K, D), Normal and Student-t."""
    ms = _SHAPE_SETS[name]()
    tdist = randoms.student_t(dof) if dof else None
    _assert_segment_matches(ms, 256, cuda, tdist)
    C = 2048
    a, sig = _stage1_state(ms, C, cuda, 1.0)
    b = a
    la = lb = torch.zeros(a.shape[1], device=cuda)
    kw = dict(C=C, seed=777, nburn=20, tdist=tdist)
    before = fused_stage1.sweep.launches
    for t in range(1, 41):
        a, la, ca = fused_stage1.sweep(ms, a, la, sig, t=t,
                                       seg_start=t == 1, **kw)
        b, lb, cb = fused_stage1.sweep_ref(ms, b, lb, sig, t=t,
                                           seg_start=t == 1, **kw)
        assert torch.equal(ca, cb), t
    assert fused_stage1.sweep.launches == before + 40
    close = (((a - b).abs() <= 1e-5 * (1 + b.abs())).all(0)
             & ((la - lb).abs() <= 1e-5 * (1 + lb.abs())))
    assert close.float().mean() >= 0.99


def _start_proposal(ms, L=2):
    """A two-component proposal around each model's start point, scale
    0.5 on its own coordinates."""
    K, D = ms.nmodels, ms.dmax
    init = ms.init_points(randoms.key(0))
    dm = torch.arange(D)[None, None] < torch.as_tensor(ms.dims)[:, None, None]
    mu = (init[:, None, :] + torch.tensor([0.1, -0.1])[None, :, None]) * dm
    B = torch.where(dm[..., None] & dm[..., None, :],
                    torch.eye(D).repeat(K, L, 1, 1) * 0.5, torch.eye(D))
    logdet = (torch.log(torch.diagonal(B, dim1=-2, dim2=-1)) * dm).sum(-1)
    sig = 0.3 * (torch.arange(D)[None] < torch.as_tensor(ms.dims)[:, None])
    return Proposal(lam=torch.full((K, L), 0.5), mu=mu, B=B, logdetB=logdet,
                    nmix=torch.full((K,), L, dtype=torch.int32),
                    sig=sig.float())


@pytest.mark.parametrize("perm", [False, True], ids=["noperm", "perm"])
@pytest.mark.parametrize("dof", [0, 5])
@pytest.mark.parametrize("name", list(_SHAPE_SETS))
def test_sweep_kernel_matches_twin_at_every_shape(cuda, name, dof, perm):
    """K1 against sweep_chunk_ref on the card at every instantiated
    (K, D), each of its four variants: 2048 chains x 30 sweeps from the
    start points under a two-component proposal.  k equal on >= 99% of
    chains, theta and logp within 1e-4 on those, and the counters exact
    where every chain agrees."""
    ms = _SHAPE_SETS[name]()
    K = ms.nmodels
    tabs = fused.prep_tables(_start_proposal(ms), ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(cuda)
                         for f in tabs.__dataclass_fields__})
    S = 2048
    init = ms.init_points(randoms.key(0))
    k = torch.as_tensor(np.random.default_rng(1).integers(0, K, S),
                        dtype=torch.int32)
    theta = init[k.long()].T.contiguous()
    logp = ms.logpost_cols(k.long(), list(theta))
    args = [x.to(cuda) for x in (k, theta, logp, torch.full((K, S), 1.0 / K),
                                 torch.full((S,), 0.1),
                                 torch.ones(S, dtype=torch.int32))]
    kw = dict(seed=3, sweep0=5, n_sweeps=30, adapt=True, perm=perm,
              tdist=randoms.student_t(dof) if dof else None)
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    want = fused.sweep_chunk_ref(ms, *args, tabs, **kw)
    same = got[0] == want[0]
    assert same.float().mean() >= 0.99
    torch.testing.assert_close(got[1][:, same], want[1][:, same],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-4,
                               atol=1e-4)
    if bool(same.all()):
        assert torch.equal(got[9].sum(1), want[9].sum(1))


@pytest.mark.parametrize("C", [256, 77])
@pytest.mark.parametrize("dof", [0, 5])
@pytest.mark.parametrize("name", list(_SHAPE_SETS))
def test_segment_kernel_matches_twin_exactly(cuda, name, dof, C):
    """K2 against segment_ref run on the card at every instantiated
    (K, D), Normal and Student-t, the AAP rule (the log rule's own tests
    are below): K x C chains over several one-warp blocks, C = 256 (every
    warp in one model) and C = 77 (warps spanning two models, the last
    block part-filled), one 100-sweep segment (block moves after sweep
    50): one launch and every output bit for bit."""
    ms = _SHAPE_SETS[name]()
    theta, sig = _stage1_state(ms, C, cuda, 10.0)
    zi = torch.zeros(sig.shape, dtype=torch.int32, device=cuda)
    kw = dict(C=C, sweep0=0, seed=777, nburn=50, n_active=100,
              tdist=randoms.student_t(dof) if dof else None)
    before = fused_stage1.segment.launches
    got = fused_stage1.segment(ms, theta, sig, zi, zi, **kw)
    assert fused_stage1.segment.launches == before + 1
    want = fused_stage1.segment_ref(ms, theta, sig, zi, zi, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert int(got[2].sum()) > 0                       # accepts counted


def test_segment_capacity(cuda):
    """segment_capacity counts whole one-warp blocks on every SM, at least
    6 a SM at every instantiation (8 at K2's 255 registers at most, 7 at
    DDI's with its 28.9 KB of shared tables), so toy2's 5 x 2048 and
    rb9's 10 x 1024 stage-1 chains fit.  One chain above the capacity, K2
    raises without a launch; the rule sends a toy2 population to K2 up to
    the capacity and to K3 above it."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name, f in _SHAPE_SETS.items():
        for tdist in (None, randoms.student_t(5)):
            cap = fused_stage1.segment_capacity(f(), cuda, tdist)
            assert cap % (32 * sms) == 0 and cap >= 6 * 32 * sms, (name, cap)
    ms = ddi.ddi_set()
    cap = fused_stage1.segment_capacity(ms, cuda)
    C = cap // 2 + 1
    theta, sig = _stage1_state(ms, C, cuda, 1.0)
    zi = torch.zeros(sig.shape, dtype=torch.int32, device=cuda)
    before = fused_stage1.segment.launches
    with pytest.raises(ValueError, match="resident"):
        fused_stage1.segment(ms, theta, sig, zi, zi, C=C, sweep0=0, seed=1,
                             nburn=0, n_active=2)
    assert fused_stage1.segment.launches == before
    toy2 = toy.toy2_set()
    cap = fused_stage1.segment_capacity(toy2, cuda)
    for C, run in ((cap // 5, fused_stage1.run_fused_stage1),
                   (cap // 5 + 1, fused_stage1.run_fused_stage1_sweeps)):
        assert fused_stage1.stage1_runner(toy2, EngineConfig(), C, cuda) \
            is run


def test_segment_kernel_registers(cuda):
    """K2 at rb9's (10, 5) and DDI's (2, 16), in its Normal and Student-t
    units, spills nothing (ptxas -v of the build, kept in the log beside
    the library): its one-warp block lets the compiler use up to 255
    registers."""
    import re
    log = _build.build().with_suffix(".log").read_text()
    found = {}
    for unit in log.split("$ ")[1:]:
        t = re.search(r"-DAM_STAGE1_T=(\d)", unit.split("\n", 1)[0])
        for block in unit.split("Compiling entry function '")[1:]:
            m = re.search(r"\dfused_stage1_kernelILi(\d+)ELi(\d+)E",
                          block.split("'", 1)[0])
            if not (m and t):
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            regs = re.search(r"Used (\d+) registers", block)
            found[(*map(int, m.groups()), int(t.group(1)))] = (
                int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))
    for K, D in ((10, 5), (2, 16)):
        for t in (0, 1):
            regs, st, ld = found[(K, D, t)]
            assert regs <= 255 and st == ld == 0, (K, D, t, found[(K, D, t)])


def _rb9_state(dev, S, seed=0):
    """rb9 chains at the start points under the two-component start
    proposal; pk uniform, so every row is the shared pooled vector."""
    return _start_state(rb9.rb9_set(), dev, S, seed)


def _start_state(ms, dev, S, seed=0, sweep=5):
    """Chains of ``ms`` at its start points, their models drawn from a
    numpy seed, under the two-component start proposal; pk uniform."""
    K = ms.nmodels
    tabs = fused.prep_tables(_start_proposal(ms), ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(dev)
                         for f in tabs.__dataclass_fields__})
    init = ms.init_points(randoms.key(0))
    k = torch.as_tensor(np.random.default_rng(seed).integers(0, K, S),
                        dtype=torch.int32)
    theta = init[k.long()]
    logp = ms.logpost_cols(k.long(), list(theta.T))
    from automix_tpu_torch.state import Chains
    chains = Chains(k=k.to(dev), theta=theta.to(dev), logp=logp.to(dev),
                    pk=torch.full((S, K), 1.0 / K, device=dev),
                    pkllim=torch.full((S,), 0.1, device=dev),
                    nreinit=torch.ones(S, dtype=torch.int32, device=dev),
                    sweep=sweep)
    return ms, chains, tabs


@pytest.mark.parametrize("perm", [False, True], ids=["noperm", "perm"])
def test_pooled_kernel_matches_twin(cuda, perm):
    """K1c at rb9's (10, 5) against the pooled twin run on the card, 4096
    chains x 30 sweeps: one launch; k equal on >= 99% of chains, theta
    and logp within 1e-4 on those; where every chain agrees the
    histogram is the same integer every sweep, so the shared pk, pkllim
    and nreinit are bitwise equal."""
    ms, ch, tabs = _rb9_state(cuda, 4096)
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit, tabs)
    kw = dict(seed=3, sweep0=ch.sweep, n_sweeps=30, adapt=True, perm=perm,
              pooled=True)
    before = fused.sweep_chunk.pooled_launches
    got = fused.sweep_chunk(ms, *args, **kw)
    assert fused.sweep_chunk.pooled_launches == before + 1
    want = fused.sweep_chunk_ref(ms, *args, **kw)
    same = got[0] == want[0]
    assert same.float().mean() >= 0.99
    assert (got[0] != ch.k).float().mean() > 0.05
    torch.testing.assert_close(got[1][:, same], want[1][:, same],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-4,
                               atol=1e-4)
    assert bool((got[3] == got[3][:, :1]).all())         # one shared pk
    if bool(same.all()):
        for i in (3, 4, 5):
            assert torch.equal(got[i], want[i]), i


def test_hw_pooled_kernel_matches_twin(cuda):
    """K1c with the hw stream at rb9's (10, 5), 4096 chains x 30 sweeps:
    one launch counted in ``pooled_hw_launches``; k equal to the pooled
    twin's on >= 99% of chains, theta and logp within 1e-4 on those; one
    shared pk, bitwise the twin's where every chain agrees."""
    ms, ch, tabs = _rb9_state(cuda, 4096)
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit, tabs)
    kw = dict(seed=3, sweep0=ch.sweep, n_sweeps=30, adapt=True, pooled=True,
              rng="hw")
    before = (fused.sweep_chunk.pooled_launches,
              fused.sweep_chunk.pooled_hw_launches)
    got = fused.sweep_chunk(ms, *args, **kw)
    assert (fused.sweep_chunk.pooled_launches,
            fused.sweep_chunk.pooled_hw_launches) == (before[0],
                                                      before[1] + 1)
    want = fused.sweep_chunk_ref(ms, *args, **kw)
    same = got[0] == want[0]
    assert same.float().mean() >= 0.99
    assert (got[0] != ch.k).float().mean() > 0.05
    torch.testing.assert_close(got[1][:, same], want[1][:, same],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2][same], want[2][same], rtol=1e-4,
                               atol=1e-4)
    assert bool((got[3] == got[3][:, :1]).all())         # one shared pk
    if bool(same.all()):
        for i in (3, 4, 5):
            assert torch.equal(got[i], want[i]), i


def test_pooled_runner_matches_twin(cuda):
    """The K1d runner (one K1 launch per sweep) against the same loop over
    the twin on the card, 4096 rb9 chains x 20 sweeps: 20 launches of the
    per-chain kernel and none of K1c; k equal on >= 99% of chains; where
    all agree, pk, pkllim, nreinit and the visit counts are bitwise
    equal."""
    ms, ch, tabs = _rb9_state(cuda, 4096, seed=1)
    before = (fused.sweep_chunk.launches, fused.sweep_chunk.pooled_launches)
    a, ca = fused.pooled_sweeps(ms, ch, tabs, 20, seed=4)
    assert (fused.sweep_chunk.launches,
            fused.sweep_chunk.pooled_launches) == (before[0] + 20, before[1])
    b, cb = fused.pooled_sweeps(ms, ch, tabs, 20, seed=4,
                                sweep_fn=fused.sweep_chunk_ref)
    same = a.k == b.k
    assert same.float().mean() >= 0.99
    if bool(same.all()):
        for f in ("pk", "pkllim", "nreinit"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(ca["ksummary"], cb["ksummary"])


def test_pooled_routes_bitwise_on_card(cuda):
    """K1c and the K1d runner through the chunk runner on 4096 rb9 chains,
    two chunks (15 + 10 sweeps): bitwise equal in k, theta, pk, pkllim,
    nreinit and the visit counts and counters; the float sums within
    1e-5 (another summation order).  The stream is pinned to the hash:
    the hw stream ("auto" on the card) reseeds at every launch, so K1d's
    one-sweep launches draw other words than K1c's chunk, as in JAX."""
    ms, ch, tabs = _rb9_state(cuda, 4096, seed=2)
    prop = _start_proposal(ms)
    prop = Proposal(**{f: getattr(prop, f).to(cuda)
                       for f in prop.__dataclass_fields__})
    out = {}
    for force in (False, True):
        fused._FORCE_POOLED_SCAN = force
        try:
            run = fused.build_fused_chunk_runner(
                ms, EngineConfig(seed=6, pk_mode="pooled",
                                 fused_rng="hash"), burning=False)
            c, chunks = ch, []
            for n in (15, 10):
                c, chunk = run(c, prop, n)
                chunks.append(chunk)
            out[force] = (c, chunks)
        finally:
            fused._FORCE_POOLED_SCAN = False
    (a, ca), (b, cb) = out[False], out[True]
    for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(ca, cb):
        for name in x:
            if name.startswith("theta"):
                torch.testing.assert_close(x[name], y[name], rtol=1e-5,
                                           atol=1e-2)
            else:
                assert torch.equal(x[name], y[name]), name


def test_pooled_kernel_raises_above_its_bound(cuda):
    """One chain above the co-residency bound, K1c raises: no launch, no
    fallback to another route."""
    ms = rb9.rb9_set()
    cap = fused.pooled_capacity(ms, 2, cuda)
    assert cap >= 128
    ms, ch, tabs = _rb9_state(cuda, cap + 1)
    before = (fused.sweep_chunk.launches, fused.sweep_chunk.pooled_launches)
    with pytest.raises(ValueError, match="resident"):
        fused.sweep_chunk(ms, ch.k, ch.theta.T.contiguous(), ch.logp,
                          ch.pk.T.contiguous(), ch.pkllim, ch.nreinit, tabs,
                          seed=1, sweep0=5, n_sweeps=2, adapt=True,
                          pooled=True)
    assert (fused.sweep_chunk.launches,
            fused.sweep_chunk.pooled_launches) == before


# K1d, one cooperative launch a chunk (fused.pooled_scan), against the
# one-sweep route it replaces: (set, variant) of each case.
_SCAN_CASES = {"rb9": ("rb9", {}), "rb9 perm": ("rb9", dict(perm=True)),
               "ddi": ("ddi", {}), "cpt": ("cpt", {}),
               "tutorial": ("tutorial", {}), "toy1": ("toy1", {}),
               "toy2 t": ("toy2", dict(tdist=randoms.student_t(5)))}


def _scan_state(name, dev, S):
    """S chains of set ``name`` from sweep 7 (block moves at 10 and 20, a
    DDI cache refresh after 15): DDI's and cpt's at their posterior
    scales, the others at their start points."""
    if name == "ddi":
        return _ddi_state(dev, S, seed=3, sweep=7)
    if name == "cpt":
        return _cpt_state(dev, S, seed=3, sweep=7)
    return _start_state(_SHAPE_SETS[name](), dev, S, seed=3, sweep=7)


def _assert_scan_matches_route(ms, ch, tabs, n_sweeps, rng, **kw):
    """K1d against the one-sweep route (a per-chain launch a sweep and the
    update in torch) from the same chains: one launch counted on ``rng``'s
    counter and none of the per-chain kernel; k, theta, logp, pk, pkllim,
    nreinit, the visit counts and the six counters bit for bit, the theta
    sums within 1e-5 relative (summed in another order)."""
    key = "scan_hw_launches" if rng == "hw" else "scan_launches"
    before = (getattr(fused.sweep_chunk, key), fused.sweep_chunk.launches,
              fused.sweep_chunk.hw_launches)
    a, ca = fused.pooled_scan(ms, ch, tabs, n_sweeps, seed=4, rng=rng, **kw)
    assert (getattr(fused.sweep_chunk, key), fused.sweep_chunk.launches,
            fused.sweep_chunk.hw_launches) == (before[0] + 1, *before[1:])
    b, cb = fused.pooled_sweeps(ms, ch, tabs, n_sweeps, seed=4, rng=rng,
                                sweep_fn=fused.sweep_chunk, **kw)
    for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.sweep == b.sweep == ch.sweep + n_sweeps
    for name in ca:
        if name.startswith("theta"):
            torch.testing.assert_close(ca[name], cb[name], rtol=1e-5,
                                       atol=1e-2)
        else:
            assert torch.equal(ca[name], cb[name]), name
    assert int(ca["ksummary"].sum()) == ch.n_chains * n_sweeps
    assert (a.k != ch.k).any()                          # jumps happened
    return a


def _scan_capacity(ms, L, perm, tdist, index):
    """Chains K1d holds resident at one a thread: the largest multiple of
    its block whose grid is the population itself (above it the launcher
    gives every thread two chains or more, on a smaller grid)."""
    lo, hi = 1, 4096                                  # blocks of 128
    while lo < hi:
        mid = (lo + hi + 1) // 2
        S = 128 * mid
        if fused._scan_grid(ms.nmodels, ms.dmax, S, L, perm, tdist,
                            index) == S:
            lo = mid
        else:
            hi = mid - 1
    return 128 * lo


@pytest.mark.parametrize("rng", ["hash", "hw"])
@pytest.mark.parametrize("case", list(_SCAN_CASES))
def test_pooled_scan_matches_one_sweep_route(cuda, case, rng):
    """K1d above K1c's capacity (the route's population) and its own: the
    larger + 1001 chains, so every thread of its grid carries two chains
    or one, and the population is a multiple neither of a block nor of
    the grid; 20 sweeps from sweep 7.  Bitwise the one-sweep route on
    either stream, at rb9's (10, 5) with and without perm, DDI's (2, 16)
    with its cache across a refresh, cpt's (6, 13) and the small shapes
    (the tutorial's (3, 2), toy1's (2, 2), toy2's (5, 5) with Student-t
    draws)."""
    name, kw = _SCAN_CASES[case]
    ms = _SHAPE_SETS[name]()
    L = 2
    perm, tdist = kw.get("perm", False), "tdist" in kw
    S = max(fused.pooled_capacity(ms, L, cuda, perm, kw.get("tdist")),
            _scan_capacity(ms, L, perm, tdist, cuda.index)) + 1001
    G = fused._scan_grid(ms.nmodels, ms.dmax, S, L, perm, tdist, cuda.index)
    assert S % 128 and S % G and G % 128 == 0 and S > G
    ms, ch, tabs = _scan_state(name, cuda, S)
    _assert_scan_matches_route(ms, ch, tabs, 20, rng, **kw)


def test_pooled_scan_at_one_chain_a_thread(cuda):
    """K1d on 4096 rb9 chains, within K1c's capacity (one chain a thread,
    the forced route's population), 30 sweeps on the hash: bitwise the
    one-sweep route."""
    ms, ch, tabs = _rb9_state(cuda, 4096, seed=5)
    _assert_scan_matches_route(ms, ch, tabs, 30, "hash")


def test_pooled_runner_takes_k1d_per_chunk(cuda):
    """The chunk runner: above K1c's capacity, and below it when forced,
    an adapting pooled run launches K1d once a chunk and nothing else (two
    chunks, hw and hash); burn-in keeps the per-chain kernel."""
    ms = rb9.rb9_set()
    prop = _start_proposal(ms)
    prop = Proposal(**{f: getattr(prop, f).to(cuda)
                       for f in prop.__dataclass_fields__})
    cap = fused.pooled_capacity(ms, 2, cuda)
    for S, force, rng in ((cap + 1001, False, "hw"), (4096, True, "hash")):
        _, ch, _ = _rb9_state(cuda, S, seed=6)
        fused._FORCE_POOLED_SCAN = force
        try:
            run = fused.build_fused_chunk_runner(
                ms, EngineConfig(seed=6, pk_mode="pooled", fused_rng=rng),
                burning=False)
            keys = ("launches", "hw_launches", "pooled_launches",
                    "pooled_hw_launches", "scan_launches",
                    "scan_hw_launches")
            before = [getattr(fused.sweep_chunk, k) for k in keys]
            for n in (15, 10):
                ch, _ = run(ch, prop, n)
            moved = {k: getattr(fused.sweep_chunk, k) - b
                     for k, b in zip(keys, before)}
        finally:
            fused._FORCE_POOLED_SCAN = False
        want = "scan_hw_launches" if rng == "hw" else "scan_launches"
        assert moved == {k: 2 if k == want else 0 for k in keys}, moved
        assert bool((ch.pk == ch.pk[0]).all())


def test_pooled_scan_refuses_what_it_cannot_take(cuda):
    """K1d raises before any launch on a per-chain pk model set of one
    model, a wrong dtype and an unknown stream: nothing falls back."""
    ms, ch, tabs = _rb9_state(cuda, 1024)
    before = (fused.sweep_chunk.scan_launches, fused.sweep_chunk.launches)
    bad = dataclasses.replace(ch, logp=ch.logp.double())
    with pytest.raises(ValueError, match="logp"):
        fused.pooled_scan(ms, bad, tabs, 2, seed=1)
    with pytest.raises(ValueError, match="rng"):
        fused.pooled_scan(ms, ch, tabs, 2, seed=1, rng="philox")
    one = builtin.normal_sampler_set()
    _, ch1, tabs1 = _start_state(one, cuda, 256)
    with pytest.raises(ValueError, match="K > 1"):
        fused.pooled_scan(one, ch1, tabs1, 2, seed=1)
    assert (fused.sweep_chunk.scan_launches,
            fused.sweep_chunk.launches) == before


def test_kernel_gain_matches_the_runners_gain(cuda):
    """The pk gain the kernel computes (am_gain, read by K1 and K1c) is
    bit for bit the one the K1d runner and the pooled twin compute in
    torch (fused._gains), at 300 sweep indices up to 2^24 - 1: after one
    adapting sweep with the re-init off (pkllim -1), every chain's pk is
    pk + gamma_t * (onehot(k) - pk)."""
    ms = toy.toy2_set()
    S, K = 1024, 5
    tabs = fused.prep_tables(_toy2_proposal(), ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(cuda)
                         for f in tabs.__dataclass_fields__})
    rng = np.random.default_rng(1)
    k = torch.as_tensor(rng.integers(0, K, S), dtype=torch.int32,
                        device=cuda)
    theta = torch.zeros((5, S), device=cuda)
    logp = ms.logpost_cols(k.long(), list(theta))
    pk = torch.as_tensor(rng.dirichlet(np.ones(K), S).T, dtype=torch.float32,
                         device=cuda).contiguous()
    pkl = torch.full((S,), -1.0, device=cuda)
    nri = torch.ones(S, dtype=torch.int32, device=cuda)
    ts = np.unique(np.concatenate([np.arange(60), np.geomspace(
        60, 2 ** 24 - 1, 240).astype(np.int64)]))
    for t in ts.tolist():
        out = fused.sweep_chunk(ms, k, theta, logp, pk, pkl, nri, tabs,
                                seed=3, sweep0=t, n_sweeps=1, adapt=True)
        oh = torch.nn.functional.one_hot(out[0].long(), K).T.float()
        gamma = fused._gains(t, 1, cuda)
        assert torch.equal(out[3], pk + gamma * (oh - pk)), t


def _ddi_state(dev, S, L=2, seed=0, sweep=5):
    """DDI chains at the start points under an L-component proposal around
    them (alpha and precision scales 0.1, variance 5), made from a numpy
    seed; pk uniform."""
    ms = ddi.ddi_set()
    K, D = ms.nmodels, ms.dmax
    scale = np.where(np.arange(D) == 15, 5.0, 0.1)[None].repeat(K, 0)
    scale[1, 9] = 5.0
    return _scaled_state(ms, scale, dev, S, L, seed, sweep)


def _cpt_state(dev, S, L=2, seed=0, sweep=5):
    """cpt chains at the start points under an L-component proposal around
    them at the posterior's scales (rates 1e-3, change points 2000), made
    from a numpy seed; pk uniform."""
    ms = changepoint.cpt_set()
    K, D = ms.nmodels, ms.dmax
    rate = np.arange(D)[None] < (np.arange(K) + 2)[:, None]
    return _scaled_state(ms, np.where(rate, 1e-3, 2000.0), dev, S, L, seed,
                         sweep)


def _scaled_state(ms, scale, dev, S, L, seed, sweep):
    """Chains of ``ms`` at its start points, their models drawn from a
    numpy seed, under an L-component proposal around the start points with
    per-coordinate scales ``scale`` [K, D]; pk uniform."""
    K, D = ms.nmodels, ms.dmax
    rng = np.random.default_rng(seed)
    init = ms.init_points(randoms.key(0)).numpy()
    dm = np.arange(D)[None] < ms.dims[:, None]                  # [K, D]
    scale = scale * dm
    mu = (init[:, None] + 0.3 * scale[:, None]
          * rng.standard_normal((K, L, D))) * dm[:, None]
    B = np.where(dm[:, None, :, None] & dm[:, None, None, :],
                 np.eye(D) * (scale[:, None, None, :]
                              * rng.uniform(0.8, 1.2, (K, L, 1, D))),
                 np.eye(D))
    logdet = (np.log(np.diagonal(B, axis1=-2, axis2=-1)) * dm[:, None]).sum(-1)
    t = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    prop = Proposal(lam=t(rng.dirichlet(np.ones(L), K)), mu=t(mu), B=t(B),
                    logdetB=t(logdet),
                    nmix=torch.full((K,), L, dtype=torch.int32),
                    sig=t(0.3 * scale))
    tabs = fused.prep_tables(prop, ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(dev)
                         for f in tabs.__dataclass_fields__})
    k = torch.as_tensor(rng.integers(0, K, S), dtype=torch.int32)
    theta = torch.tensor(init)[k.long()]
    logp = ms.logpost_cols(k.long(), list(theta.T))
    from automix_tpu_torch.state import Chains
    chains = Chains(k=k.to(dev), theta=theta.to(dev), logp=logp.to(dev),
                    pk=torch.full((S, K), 1.0 / K, device=dev),
                    pkllim=torch.full((S,), 0.1, device=dev),
                    nreinit=torch.ones(S, dtype=torch.int32, device=dev),
                    sweep=sweep)
    return ms, chains, tabs


def _assert_sweep_exact(ms, ch, tabs, n_sweeps, **kw):
    """A sweep kernel (K1e, or K1 / K1c at a stateless shape; with
    ``rng="hw"`` its K1f stream) against its twin on the card from the
    same state: one launch, and every output bitwise equal."""
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit, tabs)
    kw = dict(seed=3, sweep0=ch.sweep, n_sweeps=n_sweeps, adapt=True, **kw)
    key = ("pooled_" if kw.get("pooled") else "") + (
        "hw_launches" if kw.get("rng") == "hw" else "launches")
    before = getattr(fused.sweep_chunk, key)
    got = fused.sweep_chunk(ms, *args, **kw)
    assert getattr(fused.sweep_chunk, key) == before + 1
    want = fused.sweep_chunk_ref(ms, *args, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert (got[0] != ch.k).any()                      # jumps happened
    assert int(got[9][2].sum()) > 0                    # coordinate accepts
    return got


@pytest.mark.parametrize("perm", [False, True], ids=["noperm", "perm"])
def test_ddi_cache_kernel_matches_twin_exactly(cuda, perm):
    """K1e and K1e + perm at DDI's (2, 16): 4096 chains x 40 sweeps from
    sweep 5 (block moves at 10, 20, 30, 40; cache refreshes after 15, 31)
    equal to the twin run on the card, every output bit for bit."""
    ms, ch, tabs = _ddi_state(cuda, 4096)
    _assert_sweep_exact(ms, ch, tabs, 40, perm=perm)


@pytest.mark.parametrize("perm", [False, True], ids=["noperm", "perm"])
def test_ddi_cache_kernel_hw_matches_twin_exactly(cuda, perm):
    """K1e with the hw stream (K1f), with and without perm: 4096 DDI
    chains x 40 sweeps from sweep 5 equal to the hw twin run on the card,
    every output bit for bit."""
    ms, ch, tabs = _ddi_state(cuda, 4096)
    _assert_sweep_exact(ms, ch, tabs, 40, perm=perm, rng="hw")


def test_ddi_cache_kernel_at_the_largest_l(cuda):
    """K1e launches at L = kLMax = 32 and equals its twin (1024 chains x
    20 sweeps)."""
    ms, ch, tabs = _ddi_state(cuda, 1024, L=fused._MAX_L, seed=1)
    _assert_sweep_exact(ms, ch, tabs, 20)


def test_ddi_pooled_cache_kernel_matches_twin(cuda):
    """K1c with the DDI cache against the pooled twin on the card, 4096
    chains x 40 sweeps: every output bit for bit (one shared pk)."""
    ms, ch, tabs = _ddi_state(cuda, 4096, seed=2)
    got = _assert_sweep_exact(ms, ch, tabs, 40, pooled=True)
    assert bool((got[3] == got[3][:, :1]).all())


@pytest.mark.parametrize("n_sweeps", [11, 27])
def test_ddi_pooled_cache_kernel_across_a_refresh(cuda, n_sweeps):
    """K1c with the DDI cache, 8192 chains from sweep 5: every output bit
    for bit the twin's, over 11 sweeps (a block move at 10, the launch
    ending on t = 15, a cache refresh) and 27 (refreshes after 15 and 31,
    the last)."""
    ms, ch, tabs = _ddi_state(cuda, 8192, seed=4)
    got = _assert_sweep_exact(ms, ch, tabs, n_sweeps, pooled=True)
    assert bool((got[3] == got[3][:, :1]).all())


@pytest.mark.parametrize("L", [4, 32])
def test_ddi_pooled_capacity(cuda, L):
    """K1c with the cache at DDI's (2, 16): the shared copy of the tables
    beside the cache keeps two blocks of 128 chains per SM, 33792 chains
    on an H100's 132 SMs, above the 16384 of DDI's pooled run, in every
    variant."""
    ms = ddi.ddi_set()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for perm in (False, True):
        for tdist in (None, randoms.student_t(5)):
            assert fused.pooled_capacity(ms, L, cuda, perm=perm,
                                         tdist=tdist) == 2 * 128 * sms


def test_ddi_pooled_runner_with_the_cache_matches_twin(cuda):
    """K1d with the DDI cache: the per-sweep pooled runner (one K1e launch
    a sweep, which rebuilds the cache; the route of a population above
    K1c's bound, forced here on 4096 chains) on the card's stream, 20
    sweeps from sweep 7 (a block move at 10, a refresh after 15), against
    the same runner over the twin on the card: every chain field and every
    chunk statistic bit for bit."""
    ms, ch, tabs = _ddi_state(cuda, 4096, seed=3, sweep=7)
    rng = fused.resolve_rng("auto", cuda)
    key = "hw_launches" if rng == "hw" else "launches"
    before = (getattr(fused.sweep_chunk, key),
              fused.sweep_chunk.pooled_launches,
              fused.sweep_chunk.pooled_hw_launches)
    a, ca = fused.pooled_sweeps(ms, ch, tabs, 20, seed=6, rng=rng)
    assert (getattr(fused.sweep_chunk, key),
            fused.sweep_chunk.pooled_launches,
            fused.sweep_chunk.pooled_hw_launches) == (before[0] + 20,
                                                      *before[1:])
    b, cb = fused.pooled_sweeps(ms, ch, tabs, 20, seed=6, rng=rng,
                                sweep_fn=fused.sweep_chunk_ref)
    for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for name in ca:
        assert torch.equal(ca[name], cb[name]), name
    assert (a.k != ch.k).any()


def test_ddi_stateless_forms_refused_at_the_cached_shape(cuda):
    """At (2, 16) only the cached form exists: a stateless model set of
    that shape (DDI's models without their incremental density) is refused
    by the per-chain and the pooled wrapper and launches nothing."""
    ms, ch, tabs = _ddi_state(cuda, 256)
    stateless = ModelSet(ms.models)
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit, tabs)
    before = (fused.sweep_chunk.launches, fused.sweep_chunk.pooled_launches)
    for pooled in (False, True):
        with pytest.raises(ValueError, match="only its cached"):
            fused.sweep_chunk(stateless, *args, seed=3, sweep0=5,
                              n_sweeps=2, adapt=True, pooled=pooled)
    with pytest.raises(ValueError, match="only its cached"):
        fused.pooled_capacity(stateless, 2, cuda)
    assert (fused.sweep_chunk.launches,
            fused.sweep_chunk.pooled_launches) == before


# The sweep kernel at the tutorial's (3, 2): ptxas -v registers (lo, hi) of
# every form, and the per-chain kernel's resident warps per SM at L = 8.  It
# is built for 8 blocks of 128 per SM (at most 64 registers), its chunk sums
# and allocation logits in the threads' columns of shared memory.
TUTORIAL_REGS = (58, 64)
TUTORIAL_WARPS = 32


def _tutorial_ptxas():
    """(registers, stack frame, spill stores, spill loads) of every form
    of the sweep kernel at the tutorial's (3, 2): ptxas -v of the build,
    kept in the log beside the library."""
    import re
    log = _build.build().with_suffix(".log").read_text()
    found = []
    for block in log.split("Compiling entry function '")[1:]:
        if "fused_sweep_kernelILi3ELi2ELb" not in block.split("'", 1)[0]:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        found.append((int(regs.group(1)), *map(int, frame.groups())))
    assert len(found) == 8, found             # 4 variants x K1 and K1c
    return found


def test_tutorial_sweep_kernel_registers(cuda):
    """DDI's density stays out of the other shapes: the tutorial's K1 at
    (3, 2) keeps TUTORIAL_REGS registers in every variant and form."""
    lo, hi = TUTORIAL_REGS
    assert all(lo <= r <= hi for r, *_ in _tutorial_ptxas())


def test_tutorial_sweep_kernel_stack_frame(cuda):
    """The main path's sweep kernel keeps its allocation logits out of
    local memory: at (3, 2) every form has a stack frame of at most 32
    bytes (libdevice's sinf / cosf range reduction) and spills nothing."""
    found = _tutorial_ptxas()
    assert all(f <= 32 and st == ld == 0 for _, f, st, ld in found), found


def test_tutorial_sweep_kernel_occupancy(cuda):
    """The per-chain sweep kernel at (3, 2) at the tutorial's L = 8 in
    every variant: TUTORIAL_WARPS resident warps per SM, the blocks its
    launch bounds ask for."""
    ms = tutorial_set()
    for perm in (False, True):
        for tdist in (None, randoms.student_t(5)):
            assert fused.occupancy(ms, 8, cuda, perm=perm, tdist=tdist) \
                == TUTORIAL_WARPS, (perm, tdist)


def test_ddi_cache_kernel_registers(cuda):
    """K1e, the per-chain kernel's cached form at DDI's (2, 16): one thread
    per chain with the tables in shared memory keeps 212-232 registers and
    spills nothing in every variant (220 on the H100; at most 256 keeps two
    blocks per SM; ptxas -v of the build, kept in the log beside the
    library)."""
    import re
    log = _build.build().with_suffix(".log").read_text()
    found = []
    for block in log.split("Compiling entry function '")[1:]:
        if "fused_sweep_kernelILi2ELi16ELb0EE" not in block.split("'", 1)[0]:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        found.append((int(regs.group(1)), int(spill.group(1)),
                      int(spill.group(2))))
    assert len(found) == 4, found             # 4 variants
    assert all(212 <= r <= 232 and st == ld == 0 for r, st, ld in found), \
        found


@pytest.mark.parametrize("L", [4, 32])
def test_ddi_cache_kernel_occupancy(cuda, L):
    """K1e's block (the 84.5 KB cache after the 28.9 KB of shared tables)
    leaves room for two blocks of 4 warps per SM in every variant, as the
    cache alone did: a population above one block per SM keeps the
    warps of the form before the tables moved."""
    ms = ddi.ddi_set()
    for perm in (False, True):
        for tdist in (None, randoms.student_t(5)):
            assert fused.occupancy(ms, L, cuda, perm=perm, tdist=tdist) \
                == 8, (perm, tdist)


def test_changepoint_segment_log_rule_matches_twin_exactly(cuda):
    """K2 with the log rule (K2-log) at (6, 13): 6 x 512 cpt chains, one
    100-sweep segment (block moves after sweep 50), equal to its twin run
    on the card in every output, the kernel's expf and the twin's
    torch.exp included; the rates' sig comes down from 10."""
    ms = changepoint.cpt_set()
    theta, sig = _stage1_state(ms, 512, cuda, 10.0)
    zi = torch.zeros(sig.shape, dtype=torch.int32, device=cuda)
    kw = dict(C=512, sweep0=0, seed=777, nburn=50, n_active=100,
              rule="log", log_gain=3.0)
    before = fused_stage1.segment.launches
    got = fused_stage1.segment(ms, theta, sig, zi, zi, **kw)
    assert fused_stage1.segment.launches == before + 1
    want = fused_stage1.segment_ref(ms, theta, sig, zi, zi, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert bool((got[1][:, :2] < 0.1).all())


def test_changepoint_sweep_runner_log_rule_matches_twin(cuda):
    """The K3 route with the log rule at (6, 13): 6 x 1024 cpt chains
    (JAX's stage-1 population), 30 stage-1 sweeps (+3 burn-in) of
    ``run_fused_stage1_sweeps``, one K3 launch per sweep with the log
    update in the launch, against the same runner over the one-sweep
    twin on the card: sig, samples, telemetry and logp bitwise equal."""
    ms = changepoint.cpt_set()
    cfg = EngineConfig(seed=5, stage1_adapt="log")
    init = ms.init_points(randoms.key(0))
    before = fused_stage1.sweep.launches
    a = fused_stage1.run_fused_stage1_sweeps(ms, cfg, 30, 1024, init, cuda)
    assert fused_stage1.sweep.launches == before + 33
    b = fused_stage1.run_fused_stage1_sweeps(
        ms, cfg, 30, 1024, init, cuda, sweep_fn=fused_stage1.sweep_ref)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("variant", ["K1", "K1b", "K1c"])
def test_changepoint_sweep_kernels_match_twin_exactly(cuda, variant):
    """K1, K1b (perm) and K1c (pooled) at (6, 13): 4096 cpt chains x 40
    sweeps from sweep 5 under a proposal at the posterior's scales, equal
    to the twin run on the card in every output; chains jumped and
    coordinate moves were accepted."""
    ms, ch, tabs = _cpt_state(cuda, 4096)
    got = _assert_sweep_exact(ms, ch, tabs, 40, perm=variant == "K1b",
                              pooled=variant == "K1c")
    if variant == "K1c":
        assert bool((got[3] == got[3][:, :1]).all())     # one shared pk


def test_changepoint_tables_bound_raises_before_launch(cuda):
    """At (6, 13) the proposal tables of L = 28 components (238,816 bytes
    with the static arrays) exceed one block's 227 KiB: the per-chain and
    the pooled wrapper and pooled_capacity raise before any launch.  At
    L = 27, the largest that fits, K1 launches and equals its twin."""
    ms, ch, tabs = _cpt_state(cuda, 1024, L=28)
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit, tabs)
    before = (fused.sweep_chunk.launches, fused.sweep_chunk.pooled_launches)
    for pooled in (False, True):
        with pytest.raises(ValueError, match="shared memory"):
            fused.sweep_chunk(ms, *args, seed=3, sweep0=5, n_sweeps=2,
                              adapt=True, pooled=pooled)
    with pytest.raises(ValueError, match="at most L=27"):
        fused.pooled_capacity(ms, 28, cuda)
    assert (fused.sweep_chunk.launches,
            fused.sweep_chunk.pooled_launches) == before
    ms, ch, tabs = _cpt_state(cuda, 1024, L=27, seed=1)
    _assert_sweep_exact(ms, ch, tabs, 10)
    # every other shape holds kLMax components in both forms
    for K, D in _build.SHAPES:
        for pooled in (False, True):
            if (K, D) != (6, 13):
                fused.check_tables(K, D, fused._MAX_L, cuda, pooled=pooled)


def test_changepoint_pooled_capacity(cuda):
    """pooled_capacity at (6, 13) counts the kernel's registers and shared
    memory: whole blocks of 128 on every SM, at least one block per SM at
    L = 27 (its largest tables), never more at a larger L, and room at
    L = 2 for the 16384 chains chip_smoke.py runs on K1c.  One chain above
    it, K1c raises without a launch."""
    ms = changepoint.cpt_set()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    caps = [fused.pooled_capacity(ms, L, cuda) for L in (2, 8, 27)]
    assert all(c % (128 * sms) == 0 for c in caps), caps
    assert caps[0] >= caps[1] >= caps[2] >= 128 * sms, caps
    assert caps[0] >= 16384, caps
    ms, ch, tabs = _cpt_state(cuda, caps[2] + 1, L=27)
    before = fused.sweep_chunk.pooled_launches
    with pytest.raises(ValueError, match="resident"):
        fused.sweep_chunk(ms, ch.k, ch.theta.T.contiguous(), ch.logp,
                          ch.pk.T.contiguous(), ch.pkllim, ch.nreinit, tabs,
                          seed=1, sweep0=5, n_sweeps=2, adapt=True,
                          pooled=True)
    assert fused.sweep_chunk.pooled_launches == before


# --- the general engine and K4 (rng="pallas") -------------------------------


# --- the large shapes (6, 13) and (10, 5) and D5's search ------------------

def _cpt_edge_states(spec, C, seed=0):
    """C float32 states per model of the change-point set ``spec``, [K, C,
    D], whose change points sit where D5's search decides a count: each on
    an event or on one of its float32 neighbours, and by kind (chain c %
    10): the first on the first event (1), the last on the last event (2),
    the first on 0's float32 neighbour (3), the last on T's (4), one on a
    tied event value (5); or out of support: a change point at 0 (6), at T
    (7), past T or two swapped (8), a rate of 0 (9)."""
    rng = np.random.default_rng(seed)
    ev = spec.events
    vals, reps = np.unique(ev, return_counts=True)
    tie = vals[reps > 1][0]
    T = np.float32(spec.t_end)
    K, D = changepoint.K, changepoint.D
    up, down = np.float32(np.inf), np.float32(-np.inf)
    out = np.zeros((K, C, D), np.float32)
    for m in range(K):
        ns = m + 1
        for c in range(C):
            kind = c % 10
            pts = np.sort(rng.choice(vals[vals != tie], ns, replace=False))
            side = rng.integers(-1, 2, ns)
            pts = np.where(side < 0, np.nextafter(pts, down),
                           np.where(side > 0, np.nextafter(pts, up), pts))
            if kind == 1:
                pts[0] = ev[0]
            elif kind == 2:
                pts[-1] = ev[-1]
            elif kind == 3:
                pts[0] = np.nextafter(np.float32(0), up)
            elif kind == 4:
                pts[-1] = np.nextafter(T, down)
            elif kind == 5:
                pts = np.sort(np.append(pts[1:], tie))
            elif kind == 6:
                pts[0] = 0.0
            elif kind == 7:
                pts[-1] = T
            elif kind == 8:
                if ns > 1:
                    pts[[0, 1]] = pts[[1, 0]]
                else:
                    pts[0] = 2 * T
            rates = np.float32(len(ev) / T) * rng.uniform(0.5, 1.5, ns + 1)
            if kind == 9:
                rates[rng.integers(ns + 1)] = 0.0
            out[m, c, :ns + 1] = rates
            out[m, c, ns + 1:2 * ns + 1] = pts
    return out


@pytest.mark.parametrize("name", ["cpt", "cptrs"])
def test_changepoint_density_edges_match_twin(cuda, name):
    """D5 at change points on an event, on its float32 neighbours, on a
    tied event, next to 0 and T, and out of support (at 0, at T, past T,
    swapped, a zero rate), 6 x 250 states of each set, through every
    kernel that inlines it, each against its twin on the card bit for bit:
    K3 one sweep with sig = 0 (its logp is D5 at the states); K2-log one
    segment of 2 sweeps with sig = 0 (the same logp); and K1, 3 sweeps
    (a componentwise, a block and a componentwise sweep) with sig = 0 from
    the twin's logp, so that each coordinate move evaluates D5 at the
    state itself and keeps logp only where the two agree, then the jump."""
    import dataclasses
    ms = getattr(changepoint, f"{name}_set")()
    spec = getattr(changepoint, name.upper())
    K, D, C = ms.nmodels, ms.dmax, 250
    states = _cpt_edge_states(spec, C)
    theta = torch.from_numpy(states.reshape(K * C, D).T.copy()).to(cuda)
    sig = torch.zeros((K, D), device=cuda)
    lp0 = torch.zeros(K * C, device=cuda)
    kw = dict(C=C, t=1, seed=3, nburn=0, seg_start=True)
    got = fused_stage1.sweep(ms, theta, lp0, sig, **kw)
    want = fused_stage1.sweep_ref(ms, theta, lp0, sig, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), ("K3", i)
    lp = got[1].reshape(K, C).cpu()
    reject = torch.as_tensor(np.arange(C) % 10 >= 6)
    assert bool((lp[:, reject] == spec.reject_value).all())
    assert bool((lp[:, ~reject] > spec.reject_value).all())
    zi = torch.zeros((K, D), dtype=torch.int32, device=cuda)
    kw = dict(C=C, sweep0=0, seed=777, nburn=1, n_active=2, rule="log",
              log_gain=3.0)
    got = fused_stage1.segment(ms, theta, sig, zi, zi, **kw)
    want = fused_stage1.segment_ref(ms, theta, sig, zi, zi, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), ("K2-log", i)
    assert torch.equal(got[4].reshape(K, C).cpu(), lp)
    rate = np.arange(D)[None] < (np.arange(K) + 2)[:, None]
    tabs = _scaled_state(ms, np.where(rate, 1e-3, 0.05 * spec.t_end), cuda,
                         16, 2, 0, 9)[2]
    tabs = dataclasses.replace(tabs, sig=torch.zeros_like(tabs.sig))
    from automix_tpu_torch.state import Chains
    k = torch.arange(K, device=cuda, dtype=torch.int32).repeat_interleave(C)
    S = K * C
    ch = Chains(k=k, theta=theta.T.contiguous(), logp=lp.reshape(-1).to(cuda),
                pk=torch.full((S, K), 1.0 / K, device=cuda),
                pkllim=torch.full((S,), 0.1, device=cuda),
                nreinit=torch.ones(S, dtype=torch.int32, device=cuda),
                sweep=9)
    _assert_sweep_exact(ms, ch, tabs, 3)


@pytest.mark.parametrize("variant", ["K1", "K1b", "K1c"])
@pytest.mark.parametrize("name", ["rb9", "cpt"])
def test_large_shape_sweep_kernels_hw_match_twin_exactly(cuda, name,
                                                         variant):
    """K1f, the hw stream, in the per-chain, perm and pooled forms at
    rb9's (10, 5) and the change-point (6, 13): 4096 chains x 40 sweeps
    from sweep 5, equal to the hw twin run on the card in every output."""
    if name == "rb9":
        ms, ch, tabs = _rb9_state(cuda, 4096, seed=1)
    else:
        ms, ch, tabs = _cpt_state(cuda, 4096, seed=3)
    _assert_sweep_exact(ms, ch, tabs, 40, perm=variant == "K1b",
                        pooled=variant == "K1c", rng="hw")


@pytest.mark.parametrize("variant", ["K1", "K1b", "K1c"])
def test_rb9_sweep_kernels_match_twin_exactly(cuda, variant):
    """K1, K1b (perm) and K1c (pooled) on the hash at rb9's (10, 5): 4096
    chains x 40 sweeps from sweep 5 equal to the twin run on the card in
    every output."""
    ms, ch, tabs = _rb9_state(cuda, 4096, seed=1)
    _assert_sweep_exact(ms, ch, tabs, 40, perm=variant == "K1b",
                        pooled=variant == "K1c")


def _rb9_table_state(dev, S, seed=0, L=2):
    """rb9 chains near the posterior, a quarter of them in model 6 (the
    one with a second dispersion), the rest spread over the other models:
    each rate at the mean of the counts of the groups it serves, each
    dispersion ~0.1, under an L-component proposal around those points
    (rates 10%, dispersions 0.05) from a numpy seed; pk uniform.  The
    sweeps then accept and reject many dispersion moves and jump into and
    out of model 6."""
    ms = rb9.rb9_set()
    K, D = ms.nmodels, ms.dmax
    rng = np.random.default_rng(seed)
    means = [np.mean(rb9.X_DATA[rb9.GROUPS == g]) for g in range(rb9.G)]
    point = np.ones((K, D))
    scale = np.zeros((K, D))
    for m in range(K):
        lmap = rb9.lambda_map(m)
        for d in range(rb9.N_LAMBDA[m]):
            point[m, d] = np.mean([means[g] for g in range(rb9.G)
                                   if lmap[g] == d])
            scale[m, d] = 0.1 * point[m, d]
        for d in set(rb9.kappa_map(m)):
            point[m, d], scale[m, d] = 0.1, 0.05
    dm = np.arange(D)[None] < ms.dims[:, None]
    mu = (point[:, None] + scale[:, None] * rng.standard_normal((K, L, D))
          ) * dm[:, None]
    B = np.where(dm[:, None, :, None] & dm[:, None, None, :],
                 np.eye(D) * scale[:, None, None, :], np.eye(D))
    B = np.repeat(B, L, axis=1)
    logdet = (np.log(np.diagonal(B, axis1=-2, axis2=-1)) * dm[:, None]).sum(-1)
    t = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    prop = Proposal(lam=t(rng.dirichlet(np.ones(L), K)), mu=t(mu), B=t(B),
                    logdetB=t(logdet),
                    nmix=torch.full((K,), L, dtype=torch.int32),
                    sig=t(0.5 * scale))
    tabs = fused.prep_tables(prop, ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(dev)
                         for f in tabs.__dataclass_fields__})
    other = rng.integers(0, K - 1, S)
    other = other + (other >= 6)               # models 0-5 and 7-9
    k = np.where(rng.uniform(size=S) < 0.25, 6, other)
    theta = point[k] * (1.0 + 0.1 * rng.standard_normal((S, D))) * dm[k]
    theta = torch.tensor(theta, dtype=torch.float32)
    k = torch.as_tensor(k, dtype=torch.int32)
    logp = ms.logpost_cols(k.long(), list(theta.T))
    from automix_tpu_torch.state import Chains
    chains = Chains(k=k.to(dev), theta=theta.to(dev), logp=logp.to(dev),
                    pk=torch.full((S, K), 1.0 / K, device=dev),
                    pkllim=torch.full((S,), 0.1, device=dev),
                    nreinit=torch.ones(S, dtype=torch.int32, device=dev),
                    sweep=5)
    return ms, chains, tabs


def test_rb9_table_state_moves_dispersions_and_model_6(cuda):
    """The state of the kappa-table tests does what they need: over 40
    one-sweep launches of the twin on the card (hash), many chains keep
    their model and change a dispersion (an accepted move) or keep it
    (a rejected one), and many jump into and out of model 6."""
    ms, ch, tabs = _rb9_table_state(cuda, 4096)
    state = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
             ch.pkllim, ch.nreinit)
    kap = torch.tensor([rb9.kappa_map(m)[0] for m in range(ms.nmodels)],
                       device=cuda)
    moved = kept = into6 = outof6 = 0
    for t in range(40):
        out = fused.sweep_chunk_ref(ms, *state, tabs, seed=3,
                                    sweep0=ch.sweep + t, n_sweeps=1,
                                    adapt=True)
        k0, k1 = state[0].long(), out[0].long()
        same = k0 == k1
        kd = kap[k0]
        before = state[1].gather(0, kd[None])[0]
        after = out[1].gather(0, kd[None])[0]
        moved += int((same & (before != after)).sum())
        kept += int((same & (before == after)).sum())
        into6 += int(((k0 != 6) & (k1 == 6)).sum())
        outof6 += int(((k0 == 6) & (k1 != 6)).sum())
        state = out[:6]
    n = 40 * ch.n_chains
    print(f"dispersion changed {moved / n:.3f}, kept {kept / n:.3f}; "
          f"jumps into model 6 {into6}, out of it {outof6}")
    assert moved > 0.1 * n and kept > 0.1 * n, (moved, kept)
    assert into6 > 500 and outof6 > 500, (into6, outof6)


@pytest.mark.parametrize("rng", ["hash", "hw"])
@pytest.mark.parametrize("variant", ["K1", "K1b", "K1c"])
def test_rb9_kappa_table_forms_match_twin_exactly(cuda, variant, rng):
    """Every form of the sweep kernel at rb9's (10, 5), which reads rb9's
    dispersion terms from the chain's kappa tables: K1, K1b (perm) and
    K1c (pooled) on the hash and on hw (K1f), 4096 chains x 40 sweeps of
    the table state from sweep 5 (block moves at 10, 20, 30, 40), equal
    to the unchanged twin run on the card in every output, bit for
    bit."""
    ms, ch, tabs = _rb9_table_state(cuda, 4096, seed=1)
    _assert_sweep_exact(ms, ch, tabs, 40, perm=variant == "K1b",
                        pooled=variant == "K1c", rng=rng)


def test_rb9_kappa_table_pooled_runner_matches_twin_exactly(cuda):
    """The K1d runner (one-sweep launches of the per-chain kernel, whose
    kappa tables start empty at every launch) on the table state, 4096
    chains x 30 sweeps on the hash: 30 launches, and every field of the
    chains and the chunk equal to the same runner over the twin on the
    card, bit for bit."""
    ms, ch, tabs = _rb9_table_state(cuda, 4096, seed=2)
    before = fused.sweep_chunk.launches
    a, ca = fused.pooled_sweeps(ms, ch, tabs, 30, seed=4)
    assert fused.sweep_chunk.launches == before + 30
    b, cb = fused.pooled_sweeps(ms, ch, tabs, 30, seed=4,
                                sweep_fn=fused.sweep_chunk_ref)
    for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.k != ch.k).any()
    for name in ca:
        assert torch.equal(ca[name], cb[name]), name


def _model_changes(ms, ch, tabs, n):
    """One-sweep launches of the hash stream (a function of the global
    sweep, so they run the chains of one n-sweep launch) from ``ch``: the
    state after n sweeps, the chunk sums accumulated in sweep order, and
    per chain the model changes and whether it came back to a model it had
    left."""
    state = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
             ch.pkllim, ch.nreinit)
    k = ch.k.long()
    seen = torch.ones_like(k) << k
    changes = torch.zeros_like(k)
    back = torch.zeros_like(k, dtype=torch.bool)
    sums = None
    for t in range(n):
        out = fused.sweep_chunk(ms, *state, tabs, seed=3,
                                sweep0=ch.sweep + t, n_sweeps=1, adapt=True)
        kn = out[0].long()
        moved = kn != k
        changes += moved
        back |= moved & ((seen >> kn) & 1).bool()
        seen |= torch.ones_like(kn) << kn
        sums = out[6:9] if sums is None else tuple(
            a + b for a, b in zip(sums, out[6:9]))
        state, k = out[:6], kn
    return state, sums, changes, back


@pytest.mark.parametrize("name", ["rb9", "cpt"])
def test_chunk_sums_across_model_changes_match_twin(cuda, name):
    """The chunk sums under model changes: 4096 chains x 200 sweeps of rb9
    (10, 5) or cpt (6, 13).  One-sweep launches show that many chains
    changed model and many came back to a model they had left; the one
    200-sweep launch equals their state and their sums added in sweep
    order (each sweep adds to one model), and the twin on the card in
    every output, ks / ts / tq included, bit for bit."""
    if name == "rb9":
        ms, ch, tabs = _rb9_state(cuda, 4096, seed=2)
    else:
        ms, ch, tabs = _cpt_state(cuda, 4096, seed=4)
    n = 200
    state, sums, changes, back = _model_changes(ms, ch, tabs, n)
    moved = float((changes > 0).float().mean())
    came_back = float(back.float().mean())
    print(f"{name}: model changes per chain-sweep "
          f"{float(changes.sum()) / (n * ch.n_chains):.4f}, chains that "
          f"changed {moved:.4f}, came back {came_back:.4f}")
    assert moved >= 0.25 and came_back >= 0.05, (moved, came_back)
    got = _assert_sweep_exact(ms, ch, tabs, n)
    for i in range(6):
        assert torch.equal(got[i], state[i]), i
    for i in range(3):
        assert torch.equal(got[6 + i], sums[i]), 6 + i


# The sweep kernel at the change-point (6, 13) and rb9 (10, 5): ptxas -v
# registers (lo, hi) and the most bytes of spill stores of K1 and K1c in
# every variant, and the per-chain kernel's resident warps per SM at the L
# of the fits (cpt 4, rb9 6), as the H100 build gives them.  At (6, 13)
# the interleaved D5 search spills 120-128 bytes at the 255-register
# ceiling; at (10, 5), with rb9's kappa tables, every form holds 204-210
# and spills nothing.
_LARGE_SHAPES = {(6, 13): (changepoint.cpt_set, (248, 255), 160, 4, 8),
                 (10, 5): (rb9.rb9_set, (200, 214), 0, 6, 8)}


@pytest.mark.parametrize("shape", list(_LARGE_SHAPES), ids=str)
def test_large_shape_sweep_kernel_registers(cuda, shape):
    """The sweep kernel at (6, 13) and (10, 5), every model's chunk sums
    in registers: K1 and K1c in every variant within the registers and
    spills the build gave (ptxas -v, kept in the log beside the
    library)."""
    import re
    K, D = shape
    _, (lo, hi), max_spill, _, _ = _LARGE_SHAPES[shape]
    log = _build.build().with_suffix(".log").read_text()
    found = []
    for block in log.split("Compiling entry function '")[1:]:
        if f"fused_sweep_kernelILi{K}ELi{D}ELb" not in block.split("'", 1)[0]:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        found.append((int(regs.group(1)), int(spill.group(1)),
                      int(spill.group(2))))
    assert len(found) == 8, found             # 4 variants x K1 and K1c
    assert all(lo <= r <= hi and st <= max_spill and ld <= max_spill
               for r, st, ld in found), found


@pytest.mark.parametrize("shape", list(_LARGE_SHAPES), ids=str)
def test_large_shape_sweep_kernel_occupancy(cuda, shape):
    """The per-chain sweep kernel's resident warps per SM at (6, 13) and
    (10, 5) at the L of their fits in every variant: two blocks of 4
    warps, bound by the registers."""
    make, _, _, L, warps = _LARGE_SHAPES[shape]
    ms = make()
    for perm in (False, True):
        for tdist in (None, randoms.student_t(5)):
            assert fused.occupancy(ms, L, cuda, perm=perm, tdist=tdist) \
                == warps, (perm, tdist)


# K1d (fused_scan_kernel) at every shape it is compiled for (K > 1):
# ptxas -v registers (lo, hi) and the most bytes of spill stores and loads,
# as the H100 build gives them: the per-chain body with its chains' loop
# and counts, 226-237 registers at (10, 5) and (2, 16), within 64 at the
# small shapes (8 blocks per SM), 94-103 at toy2's (5, 5) with its chunk
# sums in shared memory (139-141 before), and at (6, 13) 184 / 212 bytes
# of spills at the 255-register ceiling.
_SCAN_REGS = {(2, 2): ((54, 64), 0), (3, 2): ((54, 64), 0),
              (5, 5): ((90, 108), 0), (10, 5): ((220, 234), 0),
              (2, 16): ((228, 244), 0), (6, 13): ((248, 255), 256)}


def test_pooled_scan_kernel_registers(cuda):
    """K1d in every variant at every shape within the registers and spills
    the build gave (ptxas -v, kept in the log beside the library)."""
    import re
    log = _build.build().with_suffix(".log").read_text()
    found = {}
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(r"fused_scan_kernelILi(\d+)ELi(\d+)E",
                      block.split("'", 1)[0])
        if not m:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        found.setdefault(tuple(map(int, m.groups())), []).append(
            (int(regs.group(1)), int(spill.group(1)), int(spill.group(2))))
    assert set(found) == set(_SCAN_REGS), found
    for shape, forms in found.items():
        (lo, hi), max_spill = _SCAN_REGS[shape]
        assert len(forms) == 4, (shape, forms)      # 4 variants
        assert all(lo <= r <= hi and st <= max_spill and ld <= max_spill
                   for r, st, ld in forms), (shape, forms)


@pytest.mark.parametrize("name", ["toy1", "tutorial", "toy2", "rb9", "ddi",
                                  "cpt"])
def test_pooled_scan_grid(cuda, name):
    """K1d's grid, in every variant, for K1c's capacity, one chain more
    and three times as many: whole blocks, resident (within K1d's own
    capacity at one chain a thread), and every thread carrying
    ceil(S / G) chains or one fewer.  K1d's registers give at least K1c's
    blocks per SM at every shape (at toy2's (5, 5), with the chunk sums
    in shared memory, 4-5 against K1c's 4), so K1c's population runs at
    one chain a thread."""
    ms = _SHAPE_SETS[name]()
    K, D = ms.nmodels, ms.dmax
    for perm in (False, True):
        for tdist in (None, randoms.student_t(5)):
            cap = fused.pooled_capacity(ms, 2, cuda, perm, tdist)
            own = _scan_capacity(ms, 2, perm, tdist is not None, cuda.index)
            assert own >= cap, (cap, own)
            for S in (cap, cap + 1, 3 * cap + 5):
                G = fused._scan_grid(K, D, S, 2, perm, tdist is not None,
                                     cuda.index)
                nc = -(-S // G)
                assert G % 128 == 0 and (nc - 1) * G < S <= nc * G, (S, G)
                assert G <= own, (S, G)
            one = fused._scan_grid(K, D, cap, 2, perm, tdist is not None,
                                   cuda.index)
            assert one == cap, (cap, one)


def _ulps(a, b):
    a = a.cpu().view(torch.int32).to(torch.int64)
    b = b.cpu().view(torch.int32).to(torch.int64)
    return (a - b).abs()


@pytest.mark.parametrize("shape", [
    (131072, 25, 4), (3000, 37, 5), (1024, 0, 4), (1024, 25, 0), (1, 25, 4),
    (4096, 6, 1), (64, 500, 7), (4, 20000, 3), (2, 58200, 3)])
def test_sweep_rng_kernel_matches_twin(cuda, shape):
    """K4 against draw_ref on the card: uniforms bitwise, normals within 2
    ulps (both call the same libdevice log1pf, sqrtf, cosf and sinf), and
    the block-offset property of the kernel's own rows.  The shapes cover
    the tile's edges: MU = 0, MZ = 0, odd MZ, one row, a ragged last tile
    (3000 rows), tiles cut to fit 48 KB, a one-row tile above 48 KB, and a
    row wider than a block's shared memory (one thread per row)."""
    from automix_tpu_torch.kernels import sweep_rng
    S, MU, MZ = shape
    u, z = sweep_rng.draw(7, 12, 0, S, MU, MZ, cuda)
    torch.cuda.synchronize()
    ur, zr = sweep_rng.draw_ref(7, 12, 0, S, MU, MZ, cuda)
    assert torch.equal(u, ur)
    assert z.shape == zr.shape == (S, MZ)
    assert MZ == 0 or int(_ulps(z, zr).max()) <= 2
    cb = sweep_rng.choose_block(S)
    half = S // 2
    if half and half % cb == 0:
        uh, zh = sweep_rng.draw(7, 12, half // cb, half, MU, MZ, cuda)
        assert torch.equal(uh, u[half:]) and torch.equal(zh, z[half:])


def test_general_engine_on_the_card_matches_the_cpu(cuda):
    """5 sweeps of the general engine (fused='off', the fast stream) on the
    card and on the CPU from the same chains and proposal: k equal on
    >= 99% of chains (libm ulps can flip a marginal accept), theta and
    logp within 1e-4 on those; and the same with K4 against its twin."""
    from automix_tpu_torch.kernels import rjmcmc, sweep_rng
    ms = toy.toy2_set()
    am = AMSampler(ms, EngineConfig(n_chains=8192, n_chains_stage1=256,
                                    stage1_sweeps=300, max_mix_comps=4,
                                    seed=3, trace_chain0=False),
                   device="cuda")
    am.burn_samples(30)
    prop_c = Proposal(**{f: getattr(am.proposal, f).cpu() for f in
                         ("lam", "mu", "B", "logdetB", "nmix", "sig")})
    ch = am.chains
    ch_c = type(ch)(**{f: (getattr(ch, f).cpu() if f != "sweep"
                           else ch.sweep) for f in
                       ("k", "theta", "logp", "pk", "pkllim", "nreinit",
                        "sweep")})
    for rng in ("fast", "pallas"):
        cfg = EngineConfig(n_chains=8192, seed=3, fused="off", rng=rng)
        run = rjmcmc.build_chunk_runner(ms, cfg, burning=False,
                                        collect=False)
        launches = sweep_rng.draw.launches
        out, chunk = run(ch, am.proposal, 5)
        out_c, chunk_c = run(ch_c, prop_c, 5)
        if rng == "pallas":
            assert sweep_rng.draw.launches == launches + 5
        same = out.k.cpu() == out_c.k
        assert same.float().mean() >= 0.99
        torch.testing.assert_close(out.theta.cpu()[same], out_c.theta[same],
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(out.logp.cpu()[same], out_c.logp[same],
                                   rtol=1e-4, atol=1e-4)
        assert int(chunk["ntrytd"]) == int(chunk_c["ntrytd"]) == 8192 * 5


# ---- K3: the pooled update in the launch, its moves-only mode, its grid --

def _k3_block_sweeps(ms, cfg, nsweeps, C):
    """The block-move sweeps of a stage-1 schedule (the batch coin after
    the burn-in), on which K3 counts nothing and does not adapt."""
    total, nburn = fused_stage1.schedule(cfg, nsweeps, C, ms.dmax)[:2]
    seed = (int(cfg.seed) * 1000003 + 777) & 0x7FFFFFFF
    return [t for t in range(nburn + 1, total + 1)
            if randoms.block_coin(seed, t)]


@pytest.mark.parametrize("rule", ["aap", "log"])
@pytest.mark.parametrize("name,C,nsweeps", [("toy2", 2048, 300),
                                            ("ddi", 512, 60)])
def test_k3_update_in_launch_matches_twin_runner(cuda, name, C, nsweeps,
                                                rule):
    """K3 with the pooled update in its launch (its last block applies
    the rule to sig, nacc and ntry in device memory): the one-sweep runner
    on it against the same runner over the twin on the card (the update in
    torch, sweep_ref's), and against the moves-only runner (K3 writing
    its counts, the update in torch between launches), at toy2's 5 x 2048
    and DDI's 2 x 512, on the AAP and log rules, over a schedule with
    block-move sweeps: sig, samples, telemetry and logp bitwise equal, one
    launch a sweep."""
    ms = _SHAPE_SETS[name]()
    cfg = EngineConfig(seed=3, stage1_adapt=rule)
    assert _k3_block_sweeps(ms, cfg, nsweeps, C)
    init = ms.init_points(randoms.key(0))
    n = nsweeps * 11 // 10
    before = fused_stage1.sweep.launches
    got = fused_stage1.run_fused_stage1_sweeps(ms, cfg, nsweeps, C, init,
                                               cuda)
    assert fused_stage1.sweep.launches == before + n
    twin = fused_stage1.run_fused_stage1_sweeps(
        ms, cfg, nsweeps, C, init, cuda, sweep_fn=fused_stage1.sweep_ref)
    moves = fused_stage1.run_fused_stage1_sweeps(
        ms, cfg, nsweeps, C, init, cuda,
        sweep_fn=moves_then_update(fused_stage1.sweep))
    for i, (a, b, c) in enumerate(zip(got, twin, moves)):
        assert torch.equal(a, b) and torch.equal(a, c), i


@pytest.mark.parametrize("name", ["toy2", "ddi"])
def test_k3_moves_only_counts_match_twin(cuda, name):
    """K3's moves-only mode writes the sweep's accept counts alone, as the
    kernel did before its update moved into the launch: 50 sweeps (block
    moves after sweep 20, the coin's first at sweep 42 for seed 777)
    sweep by sweep from the same state, the counts equal to sweep_ref's
    on the card every sweep and zero on block-move sweeps, theta and logp
    equal, sig untouched."""
    ms = _SHAPE_SETS[name]()
    C = 512
    a, sig = _stage1_state(ms, C, cuda, 1.0)
    sig0 = sig.clone()
    b = a
    la = lb = torch.zeros(a.shape[1], device=cuda)
    kw = dict(C=C, seed=777, nburn=20)
    seen_block = False
    for t in range(1, 51):
        a, la, ca = fused_stage1.sweep(ms, a, la, sig, t=t,
                                       seg_start=t == 1, **kw)
        b, lb, cb = fused_stage1.sweep_ref(ms, b, lb, sig, t=t,
                                           seg_start=t == 1, **kw)
        assert torch.equal(ca, cb), t
        if t > 20 and randoms.block_coin(777, t):
            seen_block = True
            assert int(ca.sum()) == 0, t
    assert seen_block
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert torch.equal(sig, sig0)


def test_k3_grid_covers_every_chain(cuda):
    """K3's grid, the launcher's choice: one-warp blocks while they put at
    most four on each SM, then blocks of 2, 4 or 8 warps; whole warps,
    every chain covered by exactly one thread, at populations below and
    above K2's resident capacity.  One sweep above the capacity (toy2)
    equals its twin on the card in every chain."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    toy2 = toy.toy2_set()
    cap = fused_stage1.segment_capacity(toy2, cuda)
    for N in (1024, 10240, 4 * 32 * sms, 4 * 32 * sms + 1, cap, cap + 1,
              3 * cap + 5):
        threads, blocks = fused_stage1.sweep_grid(N, cuda)
        assert threads in (32, 64, 128, 256), (N, threads)
        assert (blocks - 1) * threads < N <= blocks * threads, (N, threads)
        assert (threads == 32) == (N <= 4 * 32 * sms), (N, threads)
        assert (threads == 256) == (N > 16 * 32 * sms), (N, threads)
    C = cap // 5 + 1
    theta, sig = _stage1_state(toy2, C, cuda, 1.0)
    lp = torch.zeros(theta.shape[1], device=cuda)
    kw = dict(C=C, t=1, seed=777, nburn=0, seg_start=True)
    got = fused_stage1.sweep(toy2, theta, lp, sig, **kw)
    want = fused_stage1.sweep_ref(toy2, theta, lp, sig, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert bool((got[0] != theta).any(0).float().mean() > 0.2)


# ---- the sweep kernel's forms at the toy shapes ---------------------------

# ptxas -v registers (lo, hi) and the largest stack frame of K1 and K1c at
# toy2's (5, 5) in every variant (its chunk sums and logits in shared
# memory: 95-128 registers, libdevice's 32-byte frame, where its logits in
# local memory took a 160-byte frame) and of the Student-t forms at toy1's
# (2, 2) (the small shapes' layout, within 64 registers); no spills; and
# the per-chain kernel's resident warps per SM at the L of the toy fits
# (toy2's lmax 10, toy1's 3).
_TOY_SHAPES = {(5, 5): (toy.toy2_set, (92, 128), (0, 1), 10, 16),
               (2, 2): (toy.toy1_set, (56, 64), (1,), 3, 32)}


def _ptxas_by_unit(K, D):
    """(Student-t flag of the unit, kernel name, registers, stack frame,
    spill stores, spill loads) of every per-chain and pooled form of the
    sweep kernel at (K, D), from the build's ptxas -v log."""
    import re
    log = _build.build().with_suffix(".log").read_text()
    found = []
    for unit in log.split("$ ")[1:]:
        t = re.search(r"-DAM_TDIST=(\d)", unit.split("\n", 1)[0])
        for block in unit.split("Compiling entry function '")[1:]:
            name = block.split("'", 1)[0]
            if not (t and f"fused_sweep_kernelILi{K}ELi{D}ELb" in name):
                continue
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", block)
            regs = re.search(r"Used (\d+) registers", block)
            found.append((int(t.group(1)), name, int(regs.group(1)),
                          *map(int, frame.groups())))
    return found


@pytest.mark.parametrize("shape", list(_TOY_SHAPES), ids=str)
def test_toy_sweep_kernel_registers(cuda, shape):
    """The sweep kernel's forms at toy2's (5, 5) (every variant) and the
    Student-t forms at toy1's (2, 2), K1 and K1c: registers within the
    build's range, a stack frame of at most 32 bytes (libdevice's trig
    reduction; no local array of logits) and no spills."""
    _, (lo, hi), tflags, _, _ = _TOY_SHAPES[shape]
    found = [f for f in _ptxas_by_unit(*shape) if f[0] in tflags]
    assert len(found) == 4 * len(tflags), found   # 2 perm units x K1, K1c
    assert all(lo <= r <= hi and fr <= 32 and st == ld == 0
               for _, _, r, fr, st, ld in found), found


@pytest.mark.parametrize("shape", list(_TOY_SHAPES), ids=str)
def test_toy_sweep_kernel_occupancy(cuda, shape):
    """The per-chain sweep kernel's resident warps per SM at the toy fits'
    L: 16 at (5, 5) in every variant (4 blocks of 4 warps), 32 for the
    Student-t forms at (2, 2) (8 blocks)."""
    make, _, tflags, L, warps = _TOY_SHAPES[shape]
    ms = make()
    for perm in (False, True):
        for t in tflags:
            tdist = randoms.student_t(5) if t else None
            assert fused.occupancy(ms, L, cuda, perm=perm, tdist=tdist) \
                == warps, (perm, t)


# toy2's (5, 5) and toy1's (2, 2) forms (perm, Student-t): the toy2 CLI
# runs K1f + perm at (5, 5), toy1's `-t 5` CLI K1f + t + perm at (2, 2).
_TOY_FORMS = [("toy2", False, 0), ("toy2", True, 0), ("toy2", True, 5),
              ("toy2", False, 5), ("toy1", True, 5), ("toy1", False, 5)]


@pytest.mark.parametrize("rng", ["hash", "hw"])
@pytest.mark.parametrize("name,perm,dof", _TOY_FORMS,
                         ids=[f"{n}-perm{int(p)}-t{d}"
                              for n, p, d in _TOY_FORMS])
def test_toy_sweep_kernel_forms_match_twin_exactly(cuda, name, perm, dof,
                                                   rng):
    """The sweep kernel's forms at toy2's (5, 5) and toy1's (2, 2) against
    their twin on the card: 4096 chains x 30 sweeps (three block moves)
    from the start points under a two-component proposal, one launch,
    every output bitwise equal, on both streams; the chains jump."""
    ms = _SHAPE_SETS[name]()
    K = ms.nmodels
    tabs = fused.prep_tables(_start_proposal(ms), ms.dims)
    tabs = type(tabs)(**{f: getattr(tabs, f).to(cuda)
                         for f in tabs.__dataclass_fields__})
    S = 4096
    init = ms.init_points(randoms.key(0))
    k = torch.as_tensor(np.random.default_rng(2).integers(0, K, S),
                        dtype=torch.int32)
    theta = init[k.long()].T.contiguous()
    logp = ms.logpost_cols(k.long(), list(theta))
    args = [x.to(cuda) for x in (k, theta, logp, torch.full((K, S), 1.0 / K),
                                 torch.full((S,), 0.1),
                                 torch.ones(S, dtype=torch.int32))]
    kw = dict(seed=3, sweep0=5, n_sweeps=30, adapt=True, perm=perm, rng=rng,
              tdist=randoms.student_t(dof) if dof else None)
    got = fused.sweep_chunk(ms, *args, tabs, **kw)
    want = fused.sweep_chunk_ref(ms, *args, tabs, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert (got[0] != args[0]).float().mean() > 0.05


def _assert_halves_match_whole(ms, ch, tabs, n_sweeps, **kw):
    """The sweep kernel over all S chains in one launch, and over the two
    halves of the chains in two launches at chain bases 0 and S / 2 (a
    population split across two devices): every output, state, per-chain
    chunk sums and counters, bitwise equal to the one launch's."""
    S = ch.n_chains
    h = S // 2

    def args(rows):
        return (ch.k[rows].contiguous(), ch.theta[rows].T.contiguous(),
                ch.logp[rows].contiguous(), ch.pk[rows].T.contiguous(),
                ch.pkllim[rows].contiguous(), ch.nreinit[rows].contiguous(),
                tabs)

    kw = dict(seed=3, sweep0=ch.sweep, n_sweeps=n_sweeps, adapt=True, **kw)
    key = "hw_launches" if kw.get("rng") == "hw" else "launches"
    before = getattr(fused.sweep_chunk, key)
    whole = fused.sweep_chunk(ms, *args(slice(None)), **kw)
    halves = [fused.sweep_chunk(ms, *args(slice(i * h, (i + 1) * h)),
                                chain0=i * h, **kw) for i in (0, 1)]
    assert getattr(fused.sweep_chunk, key) == before + 3
    for i, w in enumerate(whole):
        assert torch.equal(w, torch.cat([halves[0][i], halves[1][i]],
                                        dim=-1)), i
    assert (whole[0] != ch.k).any()                     # jumps happened


@pytest.mark.parametrize("rng", ["hash", "hw"])
def test_sweep_kernel_chain_base_splits(cuda, rng):
    """K1 / K1f at the tutorial's (3, 2): 4096 chains x 30 sweeps from
    sweep 5 as one launch and as two launches over the halves at chain
    bases 0 and 2048, bitwise equal."""
    ms, ch, tabs = _start_state(tutorial_set(), cuda, 4096)
    _assert_halves_match_whole(ms, ch, tabs, 30, rng=rng)


@pytest.mark.parametrize("rng", ["hash", "hw"])
def test_cache_kernel_chain_base_splits(cuda, rng):
    """K1e at DDI's (2, 16): 2048 chains x 20 sweeps (a cache refresh
    after sweep 15) as one launch and as two halves at bases 0 and 1024,
    bitwise equal."""
    ms, ch, tabs = _ddi_state(cuda, 2048)
    _assert_halves_match_whole(ms, ch, tabs, 20, rng=rng)


@pytest.mark.parametrize("name", ["tutorial", "ddi"])
def test_k3_chain_base_splits(cuda, name):
    """K3 moves only at the tutorial's (3, 2) and DDI's (2, 16): 20 sweeps
    of K x 512 chains as one launch a sweep, and as two launches a sweep
    over each model's first and last 256 chains (``C_total`` 512,
    ``chain_off`` 0 and 256): theta and logp bitwise equal lane for lane
    and the two launches' counts summing to the one launch's."""
    ms = tutorial_set() if name == "tutorial" else ddi.ddi_set()
    K, D = ms.nmodels, ms.dmax
    C, h = 512, 256
    theta, sig = _stage1_state(ms, C, cuda, 0.5)
    lp = torch.zeros(K * C, device=cuda)

    def half(x, i):
        return x.reshape(*x.shape[:-1], K, C)[..., i * h:(i + 1) * h] \
            .reshape(*x.shape[:-1], K * h).contiguous()

    parts = [(half(theta, i), half(lp, i)) for i in (0, 1)]
    kw = dict(seed=777, nburn=10)
    before = fused_stage1.sweep.launches
    accepts = 0
    for t in range(1, 21):
        theta, lp, cnt = fused_stage1.sweep(ms, theta, lp, sig, C=C, t=t,
                                            seg_start=t == 1, **kw)
        cnts = []
        for i in (0, 1):
            th_i, lp_i, c_i = fused_stage1.sweep(
                ms, *parts[i], sig, C=h, C_total=C, chain_off=i * h, t=t,
                seg_start=t == 1, **kw)
            parts[i] = (th_i, lp_i)
            cnts.append(c_i.clone())
        assert torch.equal(cnts[0] + cnts[1], cnt), t
        accepts += int(cnt.sum())
        for i in (0, 1):
            assert torch.equal(parts[i][0], half(theta, i)), t
            assert torch.equal(parts[i][1], half(lp, i)), t
    assert fused_stage1.sweep.launches == before + 60
    assert accepts > 0
