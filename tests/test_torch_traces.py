"""Traces, AutoRJ and checkpoints of the port's sampler on the CPU.

Traces are held against the JAX sampler at the setting of
``tests/test_fused.py::test_fused_decimated_traces`` (tutorial, 1024
chains, trace_every 5, 4 traced chains), with both samplers started from
the same numpy-made proposal and chain state, and stride-1 traces against
the state after each single sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import em as jem
from automix_tpu.models import tutorial as jtutorial
from automix_tpu.sampler import AMSampler as JaxSampler
from automix_tpu.state import Chains as JaxChains
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.convert import chains_from_numpy, proposal_from_numpy
from automix_tpu_torch.kernels import em
from automix_tpu_torch.models import tutorial
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_fused import S, SEED, _chains, _proposal


def _port_sampler(p, c, **cfg):
    am = AMSampler(tutorial.tutorial_set(), EngineConfig(
        n_chains=S, seed=SEED, **cfg), device="cpu")
    am.set_proposal(proposal_from_numpy(**p))
    am.chains = chains_from_numpy(**c)
    return am


def test_decimated_traces_match_jax():
    """trace_every=5 over 60 production sweeps: 12 boundary snapshots of
    4 chains' k and chain 0's pk, logp and theta, trace_stride 5, and
    aggregates over every sweep, as in the JAX sampler.  The snapshots
    agree with the JAX run's on >= 99% of the k entries (the two
    libraries' ulp differences can flip a marginal accept), and chain 0's
    logp within 1e-4 relative wherever its k agrees."""
    rng = np.random.default_rng(SEED)
    p = _proposal(rng)
    c = _chains(rng, p)
    jam = JaxSampler(jtutorial.tutorial_set(), JaxConfig(
        n_chains=S, seed=SEED, fused="on", fused_rng="hash",
        trace_every=5, n_trace_chains=4))
    jam.set_proposal(JaxProposal(**{n: jnp.asarray(v) for n, v in p.items()}))
    jam.chains = JaxChains(key=jax.random.split(jax.random.PRNGKey(0), S),
                           **{n: jnp.asarray(v) for n, v in c.items()
                              if n != "sweep"},
                           sweep=jnp.asarray(c["sweep"], jnp.int32))
    jst = jam.rjmcmc_samples(60, collect=True)

    am = _port_sampler(p, c, trace_every=5, n_trace_chains=4)
    st = am.rjmcmc_samples(60)                    # collect = trace_chain0
    assert st.trace_stride == jst.trace_stride == 5
    assert st.ksummary.sum() == S * 60
    for name in ("k_trace", "k0_trace", "pk_trace", "logp_trace",
                 "theta0_trace"):
        assert getattr(st, name).shape == getattr(jst, name).shape, name
    assert st.k_trace.shape == (12, 4) and st.k_trace.dtype == np.int8
    assert (st.k_trace == jst.k_trace).mean() >= 0.99
    same = st.k0_trace == jst.k0_trace
    np.testing.assert_allclose(st.logp_trace[same], jst.logp_trace[same],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.pk_trace[same], jst.pk_trace[same],
                               atol=1e-5)


def test_stride_one_traces_are_the_per_sweep_state():
    """trace_every=1: one entry per sweep, equal to the state after each
    single sweep of the same chains."""
    rng = np.random.default_rng(SEED + 2)
    p = _proposal(rng)
    c = _chains(rng, p)
    st = _port_sampler(p, c, n_trace_chains=3).rjmcmc_samples(8)
    assert st.trace_stride == 1 and st.k_trace.shape == (8, 3)
    step = _port_sampler(p, c, trace_chain0=False)
    for i in range(8):
        step.rjmcmc_samples(1)
        ch = step.chains
        np.testing.assert_array_equal(st.k_trace[i], ch.k[:3].numpy())
        assert st.logp_trace[i] == float(ch.logp[0])
        np.testing.assert_array_equal(st.theta0_trace[i],
                                      ch.theta[0].numpy())
        np.testing.assert_array_equal(st.pk_trace[i], ch.pk[0].numpy())
    np.testing.assert_array_equal(st.ksummary, step.stats.ksummary)


def test_fit_autorj_matches_jax():
    """AutoRJ's one Normal per model, against JAX ``fit_autorj`` on the
    same samples (float32 means and covariances summed in another order:
    1e-5 relative)."""
    rng = np.random.default_rng(7)
    dims = np.array([1, 2, 3])
    x = (rng.normal(size=(3, 500, 3)) * [1.0, 0.3, 2.0] + [0.5, -1.0, 3.0])
    x = (x * (np.arange(3)[None, None, :] < dims[:, None, None])).astype(
        np.float32)
    mean, B = em.fit_autorj(torch.tensor(x), torch.tensor(dims))
    for k in range(3):
        jmean, jB = jem.fit_autorj(jnp.asarray(x[k]), int(dims[k]))
        np.testing.assert_allclose(mean[k].numpy(), np.asarray(jmean),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(B[k].numpy(), np.asarray(jB), rtol=1e-5,
                                   atol=1e-6)


def test_autorj_proposal_has_one_component_per_model():
    ms = tutorial.tutorial_set()
    cfg = EngineConfig(mix_fit="autorj", max_mix_comps=6)
    x = torch.tensor(np.random.default_rng(8).normal(
        1.0, 0.2, size=(3, 300, 2)).astype(np.float32))
    prop, tele = em.fit_proposal(ms, cfg, x, torch.ones((3, 2)))
    assert tele == {} and prop.lam.shape == (3, 1)
    assert torch.equal(prop.nmix, torch.ones(3, dtype=torch.int32))
    torch.testing.assert_close(prop.lam, torch.ones((3, 1)))


@pytest.mark.parametrize("collect", [False, True])
def test_save_load_resumes_exactly(tmp_path, collect):
    """A run split by save/load into a fresh sampler equals the straight
    run: visit counts and chain state bitwise, moment sums to float32
    rounding (each chunk sums in float32, and the split moves the chunk
    boundaries)."""
    rng = np.random.default_rng(SEED + 3)
    p = _proposal(rng)
    c = _chains(rng, p)
    cfg = dict(trace_chain0=collect, trace_every=4, sweep_chunk=7)
    ref = _port_sampler(p, c, **cfg)
    ref.burn_samples(5)
    ref.rjmcmc_samples(30)
    a = _port_sampler(p, c, **cfg)
    a.burn_samples(5)
    a.rjmcmc_samples(12)
    path = str(tmp_path / "ckpt.npz")
    a.save(path)
    b = AMSampler(tutorial.tutorial_set(), EngineConfig(
        n_chains=S, seed=SEED, **cfg), device="cpu")
    b.load(path)
    b.rjmcmc_samples(18)
    np.testing.assert_array_equal(b.stats.ksummary, ref.stats.ksummary)
    np.testing.assert_allclose(b.stats.theta_sum, ref.stats.theta_sum,
                               rtol=1e-6)
    assert b.stats.nsweeps == 30 and b.chains.sweep == ref.chains.sweep
    for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(b.chains, f), getattr(ref.chains, f)), f
