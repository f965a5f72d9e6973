"""The port's CUDA kernels against their plain PyTorch twins on the card.

Marked ``cuda``: without an NVIDIA GPU (and nvcc) every test here skips.
This file imports no JAX, so it runs where JAX is not installed; on a
machine with a card (``--noconftest`` skips the JAX-side test settings):

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist \
        -o addopts= --noconftest
"""

import ctypes

import numpy as np
import pytest
import torch

from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.kernels import _build, fused, fused_stage1
from automix_tpu_torch.models import builtin, toy
from automix_tpu_torch.models.tutorial import TUTORIAL_MODEL_PROBS, \
    tutorial_set
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.state import Proposal

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


def test_sweep_runner_matches_segment_runner(cuda):
    """The K3 runner against the K2 runner where both fit (toy2, 5 x 512
    chains, 300 sweeps): sig within 1e-6 relative, samples equal on
    >= 99% of lanes."""
    ms = toy.toy2_set()
    init = ms.init_points(torch.Generator())
    cfg = EngineConfig(seed=3)
    a = fused_stage1.run_fused_stage1_sweeps(ms, cfg, 300, 512, init, cuda)
    b = fused_stage1.run_fused_stage1(ms, cfg, 300, 512, init, cuda)
    torch.testing.assert_close(a[0], b[0], rtol=1e-6, atol=0)
    close = ((a[1] - b[1]).abs() <= 1e-5 * (1 + b[1].abs())).all(-1)
    assert close.float().mean() >= 0.99


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
# (1, 2) and (2, 2), toy1 (2, 2), the tutorial (3, 2) and toy2 (5, 5).
_SHAPE_SETS = {"normal": builtin.normal_sampler_set,
               "normal_params": builtin.normal_params_set,
               "gamma_beta": builtin.gamma_beta_set,
               "toy1": toy.toy1_set, "tutorial": tutorial_set,
               "toy2": toy.toy2_set}


def test_shape_sets_cover_every_instantiation():
    assert {(f().nmodels, f().dmax) for f in _SHAPE_SETS.values()} \
        == set(_build.SHAPES)


def _stage1_state(ms, C, dev, scale):
    K, D = ms.nmodels, ms.dmax
    init = ms.init_points(torch.Generator().manual_seed(0))
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
    init = ms.init_points(torch.Generator().manual_seed(0))
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
    init = ms.init_points(torch.Generator().manual_seed(0))
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


def test_segment_static_smem_within_the_routing_bound(cuda):
    """The routing rule's static shared-memory bound covers the segment
    kernel's own count at every instantiation and variant, and the card
    opts in to the shared memory the rule assumes."""
    lib = _build.library()
    for K, D in _build.SHAPES:
        for use_t in (0, 1):
            static, optin = ctypes.c_int(), ctypes.c_int()
            _build.check(lib.am_fused_stage1_smem(
                K, D, use_t, ctypes.byref(static), ctypes.byref(optin)),
                "am_fused_stage1_smem")
            assert 0 < static.value <= fused_stage1.static_smem_bound(K, D)
            assert optin.value >= fused_stage1._MAX_SMEM


@pytest.mark.parametrize("dof", [0, 5])
def test_segment_kernel_at_the_block_bound(cuda, dof):
    """K2 launches and matches its twin at the largest toy2 population
    the routing rule gives it (1929 chains per model)."""
    ms = toy.toy2_set()
    C = max(c for c in range(1024, 2048)
            if fused_stage1.fits_one_block(5, 5, c))
    assert not fused_stage1.fits_one_block(5, 5, C + 1)
    _assert_segment_matches(ms, C, cuda,
                            randoms.student_t(dof) if dof else None)
