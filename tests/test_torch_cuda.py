"""The port's CUDA kernels against their plain PyTorch twins on the card.

Marked ``cuda``: without an NVIDIA GPU (and nvcc) every test here skips.
On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -n 0
"""

import pytest
import torch

from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.kernels import fused, fused_stage1
from automix_tpu_torch.models.tutorial import TUTORIAL_MODEL_PROBS, \
    tutorial_set

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_segment_kernel_matches_twin(cuda):
    """K2 at 3 x 512 chains, 100 sweeps: integer accept counts make the
    pooled sig exact (1e-6 relative); theta within 1e-5 on >= 99% of
    lanes (ulp-level libm differences can flip a marginal accept)."""
    ms = tutorial_set()
    K, D, C = 3, 2, 512
    init = ms.init_points(torch.Generator())
    theta = init[torch.arange(K * C) // C].T.contiguous().to(cuda)
    sig = torch.full((K, D), 10.0, device=cuda)
    zi = torch.zeros((K, D), dtype=torch.int32, device=cuda)
    kw = dict(C=C, sweep0=0, seed=777, nburn=50, n_active=100)
    before = fused_stage1.segment.launches
    got = fused_stage1.segment(ms, theta, sig, zi, zi, **kw)
    want = fused_stage1.segment_ref(ms, theta, sig, zi, zi, **kw)
    assert fused_stage1.segment.launches == before + 1
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    close = ((got[0] - want[0]).abs() <= 1e-5 * (1 + want[0].abs())).all(0)
    assert close.float().mean() >= 0.99


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
