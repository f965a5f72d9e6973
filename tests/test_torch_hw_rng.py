"""K1f's stream: the stage-3 kernel's ``hw`` words, on the CPU through their
plain twin (``ops/randoms.py`` ``hw_state``, ``hw_step``, ``hw_words``).

JAX's ``hw`` stream is the TPU's hardware PRNG, which its interpreter
cannot emulate, so nothing here is held to JAX bitwise: the twin's
arithmetic is held to a Python big-integer PCG32, the stream to its
contract (reproducible, keyed by the global chain, uniform, uncorrelated,
chunk-granular), and runs under ``hw`` to exact posteriors and to the JAX
package's fused ``hash`` runs in interpret mode.  Proposals and chain
states are made with numpy from a seed.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import fused as jfused
from automix_tpu.models import toy as jtoy
from automix_tpu.state import Chains as JaxChains
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.convert import (chains_from_numpy, proposal_from_arrays,
                                       proposal_from_numpy)
from automix_tpu_torch.kernels import fused
from automix_tpu_torch.models import toy
from automix_tpu_torch.ops import randoms
from test_torch_fused import S, SEED, _toy2_chains, _toy2_proposal
from _torch_threads import one_torch_thread  # noqa: F401

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def _draw(seed, sweep0, chain0, n_chains, n_sweeps, nw=32):
    """[n_sweeps, nw, n_chains] hw words of one launch over global chains
    chain0 ..."""
    st = randoms.hw_state(seed, sweep0,
                          torch.arange(chain0, chain0 + n_chains))
    out = []
    for _ in range(n_sweeps):
        st, key = randoms.hw_step(st)
        out.append(randoms.hw_words(key, range(nw)))
    return torch.stack(out)


def _pcg32(state):
    """Python big-integer PCG32 (XSH-RR): (next state, output)."""
    x = (((state >> 18) ^ state) >> 27) & _M32
    rot = state >> 59
    out = ((x >> rot) | (x << ((32 - rot) & 31))) & _M32
    return (state * 6364136223846793005 + 1442695040888963407) & _M64, out


def _lowbias32(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def test_hw_twin_matches_big_integer_pcg32():
    """The twin's 64-bit state in 32-bit halves and its 16-bit partial
    products equal Python integers: the seed is the hash words of (seed,
    sweep0) at counters 2 chain and 2 chain + 1, each step PCG32's, each
    word lowbias32(key ^ slot * 0x9E3779B9)."""
    chains = torch.arange(0, 1 << 20, 997)
    st = randoms.hw_state(9, 1234, chains)
    seed_lo = randoms.hash_words(9, 1234, (2 * chains) & _M32)
    seed_hi = randoms.hash_words(9, 1234, (2 * chains + 1) & _M32)
    assert torch.equal(st[0], seed_lo) and torch.equal(st[1], seed_hi)
    ref = [int(lo) | (int(hi) << 32) for lo, hi in zip(*st)]
    for _ in range(6):
        st, key = randoms.hw_step(st)
        words = randoms.hw_words(key, range(0, 200, 7))
        for j, s in enumerate(ref):
            ref[j], out = _pcg32(s)
            assert int(key[j]) == out
            assert int(st[0][j]) | (int(st[1][j]) << 32) == ref[j]
            assert [int(w) for w in words[:, j]] == [
                _lowbias32(out ^ ((slot * 0x9E3779B9) & _M32))
                for slot in range(0, 200, 7)]


def test_hw_stream_reproducible_and_keyed_by_global_chain():
    """The same launch draws the same words; chains 1024-2047 of a
    2048-chain draw equal a draw started at chain 1024; another seed or
    another first sweep draws other words."""
    a = _draw(5, 300, 0, 2048, 4)
    assert torch.equal(a, _draw(5, 300, 0, 2048, 4))
    assert torch.equal(a[..., 1024:], _draw(5, 300, 1024, 1024, 4))
    assert (a != _draw(6, 300, 0, 2048, 4)).float().mean() > 0.99
    assert (a != _draw(5, 301, 0, 2048, 4)).float().mean() > 0.99


def test_hw_words_uniform():
    """2^20 words (1024 chains x 32 slots x 32 sweeps) in [0, 2^32): the
    uniforms' mean and variance within 6 standard errors of 1/2 and 1/12,
    every bit set with frequency 1/2 within 6 standard errors, and a
    Kolmogorov-Smirnov p-value above 1e-3."""
    w = _draw(3, 17, 0, 1024, 32).reshape(-1)
    n = w.numel()
    assert n == 1 << 20
    assert int(w.min()) >= 0 and int(w.max()) <= _M32
    u = w.double() / 2.0 ** 32
    assert abs(float(u.mean()) - 0.5) < 6 * (1 / 12) ** 0.5 / n ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 6 * (1 / 180) ** 0.5 / n ** 0.5
    bits = torch.stack([(w >> b) & 1 for b in range(32)]).double().mean(1)
    assert float((bits - 0.5).abs().max()) < 6 * 0.5 / n ** 0.5
    assert sps.kstest(u.numpy(), "uniform").pvalue > 1e-3


@pytest.mark.parametrize("pair", ["slot", "chain", "sweep", "chunk"])
def test_hw_words_uncorrelated(pair):
    """|correlation| < 0.01 (~5 standard errors at 2^18 pairs) between
    the uniforms of adjacent slots, adjacent chains and adjacent sweeps of
    one launch, and across a chunk boundary: a chain's last sweep of one
    launch against its first sweep of the next, which reseeds."""
    if pair == "chunk":
        a = _draw(7, 40, 0, 1 << 14, 16, nw=16)[-1]   # sweeps 40 ... 55
        b = _draw(7, 56, 0, 1 << 14, 1, nw=16)[0]     # the next launch
    else:
        u = _draw(7, 40, 0, 4096, 16, nw=16)
        a, b = {"slot": (u[:, :-1], u[:, 1:]),
                "chain": (u[..., :-1], u[..., 1:]),
                "sweep": (u[:-1], u[1:])}[pair]
    a, b = (x.reshape(-1).double() / 2.0 ** 32 for x in (a, b))
    assert a.numel() >= 1 << 18
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    assert abs(corr) < 0.01, corr


def _toy1_proposal(rng, L=3):
    """Three components near toy1's modes, correlated factors in 2-D."""
    K, D = 2, 2
    mask = np.arange(D)[None] < np.array([1, 2])[:, None]
    lam = rng.dirichlet(np.ones(L) * 3, size=K)
    modes = np.array([[[-3.0, 0.0], [2.0, 0.0], [0.0, 0.0]],
                      [[0.0, 3.0], [-4.0, 1.0], [4.0, 1.0]]])
    mu = (modes + 0.3 * rng.normal(size=(K, L, D))) * mask[:, None, :]
    B = np.zeros((K, L, D, D))
    B[..., 0, 0] = rng.uniform(0.8, 2.0, (K, L))
    B[..., 1, 1] = rng.uniform(0.6, 1.5, (K, L))
    B[..., 1, 0] = 0.3 * rng.uniform(-1, 1, (K, L))
    B = np.where(mask[:, None, :, None] & mask[:, None, None, :], B,
                 np.eye(D))
    logdet = (np.log(np.diagonal(B, axis1=-2, axis2=-1))
              * mask[:, None, :]).sum(-1)
    f32 = np.float32
    return proposal_from_numpy(
        lam=lam.astype(f32), mu=mu.astype(f32), B=B.astype(f32),
        logdetB=logdet.astype(f32), nmix=np.full(K, L, np.int32),
        sig=(1.5 * mask).astype(f32))


def _toy1_sampler(n_chains, **cfg):
    am = AMSampler(toy.toy1_set(), EngineConfig(
        n_chains=n_chains, trace_chain0=False, fused="on", **cfg),
        device="cpu")
    am.set_proposal(_toy1_proposal(np.random.default_rng(2)))
    return am


def test_hw_resume_at_a_chunk_boundary_is_bitwise(tmp_path):
    """A twin run under ``fused_rng="hw"`` of 2 x 20 sweeps, saved and
    loaded between the chunks, ends bitwise where the unbroken run ends:
    the stream is reseeded from (seed, the launch's first sweep, chain) at
    every launch, so a checkpoint carries no stream state.  Chunked
    otherwise (10-sweep launches) the run draws other words."""
    path = str(tmp_path / "hw_ckpt.npz")
    cfg = dict(sweep_chunk=20, seed=13, fused_rng="hw")
    a = _toy1_sampler(512, **cfg)
    a.rjmcmc_samples(40)
    b = _toy1_sampler(512, **cfg)
    b.rjmcmc_samples(20)
    b.save(path)
    c = AMSampler(toy.toy1_set(), EngineConfig(
        n_chains=512, trace_chain0=False, fused="on", **cfg), device="cpu")
    c.load(path)
    c.rjmcmc_samples(20)
    for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(a.chains, f), getattr(c.chains, f)), f
    np.testing.assert_array_equal(a.stats.ksummary, c.stats.ksummary)
    assert a.chains.sweep == c.chains.sweep
    d = _toy1_sampler(512, **dict(cfg, sweep_chunk=10))
    d.rjmcmc_samples(40)
    assert not torch.equal(a.chains.theta, d.chains.theta)


def test_toy1_hw_posterior_matches_exact():
    """toy1 under ``hw`` (2048 chains, 100 burn-in and 400 sweeps, pk
    fixed): p(M) within 0.01 of the exact 0.3 / 0.7, the Monte Carlo error
    being ~0.003 (adapting per-chain pk biases a run this short by ~0.012
    on either stream, so pk stays fixed here)."""
    am = _toy1_sampler(2048, sweep_chunk=200, seed=7, fused_rng="hw",
                       adapt=False)
    am.burn_samples(100)
    st = am.rjmcmc_samples(400)
    np.testing.assert_allclose(st.model_probs, toy.TOY1_MODEL_PROBS,
                               atol=0.01)


def test_pooled_hw_runs_on_both_routes():
    """Pooled pk under ``hw`` on toy1 (1024 chains, 100 burn-in and 400
    sweeps) through K1c's twin and through the K1d runner: each within
    0.01 of the exact p(M) with one shared pk; unlike the hash the two
    routes are not bitwise equal, since K1d's one-sweep launches reseed
    the stream every sweep."""
    out = {}
    for force in (False, True):
        fused._FORCE_POOLED_SCAN = force
        try:
            am = _toy1_sampler(1024, sweep_chunk=200, seed=8, fused_rng="hw",
                               pk_mode="pooled")
            am.burn_samples(100)
            st = am.rjmcmc_samples(400)
        finally:
            fused._FORCE_POOLED_SCAN = False
        np.testing.assert_allclose(st.model_probs, toy.TOY1_MODEL_PROBS,
                                   atol=0.01)
        assert bool((am.chains.pk == am.chains.pk[0]).all())
        out[force] = am.chains
    assert not torch.equal(out[False].theta, out[True].theta)


@functools.lru_cache(maxsize=None)
def _jax_toy2_hash(variant: tuple, nsweeps: int):
    """JAX's fused runner in interpret mode with the hash: (visit
    fractions, RJ acceptance) of ``nsweeps`` sweeps from the numpy state."""
    rng = np.random.default_rng(SEED + 1)
    p, c = _toy2_proposal(rng), _toy2_chains(rng)
    jcfg = JaxConfig(seed=SEED, n_chains=S, fused="on", fused_rng="hash",
                     **dict(variant))
    jrun = jfused.build_fused_chunk_runner(jtoy.toy2_set(), jcfg,
                                           burning=False)
    jprop = JaxProposal(**{n: jnp.asarray(v) for n, v in p.items()})
    jch = JaxChains(key=jax.random.split(jax.random.PRNGKey(0), S),
                    **{n: jnp.asarray(v) for n, v in c.items()
                       if n != "sweep"},
                    sweep=jnp.asarray(c["sweep"], jnp.int32))
    _, chunk = jax.device_get(jrun(jch, jprop, nsweeps))
    return (np.asarray(chunk["ksummary"]) / (S * nsweeps),
            int(chunk["nacctd"]) / int(chunk["ntrytd"]))


@pytest.mark.parametrize("variant", [(("perm", True),),
                                     (("student_t_dof", 5),)],
                         ids=["perm", "student_t"])
def test_toy2_hw_matches_jax_hash_statistically(variant):
    """toy2 (dims 1..5) with perm and with Student-t perturbations, 1024
    chains x 60 sweeps from the same numpy state and proposal: the port's
    runner under ``hw`` against JAX's fused runner with the hash.  Visit
    fractions within 0.04 (the two streams' fractions differ by ~0.01, one
    standard deviation measured over seeds and streams) and the RJ
    acceptance rate within 0.01 (its spread ~0.003)."""
    nsweeps = 60
    rng = np.random.default_rng(SEED + 1)
    p, c = _toy2_proposal(rng), _toy2_chains(rng)
    run = fused.build_fused_chunk_runner(
        toy.toy2_set(), EngineConfig(seed=SEED, fused_rng="hw",
                                     **dict(variant)), burning=False)
    prop = proposal_from_arrays(JaxProposal(**{n: jnp.asarray(v)
                                               for n, v in p.items()}))
    ch2, chunk = run(chains_from_numpy(**c), prop, nsweeps)
    frac = chunk["ksummary"].numpy() / (S * nsweeps)
    acc = int(chunk["nacctd"]) / int(chunk["ntrytd"])
    jfrac, jacc = _jax_toy2_hash(variant, nsweeps)
    np.testing.assert_allclose(frac, jfrac, atol=0.04)
    assert abs(acc - jacc) < 0.01, (acc, jacc)
    assert (ch2.k.numpy() != c["k"]).mean() > 0.05


def test_auto_resolves_by_device_and_the_engine_line_names_it(caplog):
    """"auto" is "hw" on the card and "hash" on the CPU, JAX's rule on its
    chip and under its interpreter; an unknown stream raises; the kernel
    engine's log line names the stream it runs."""
    assert fused.resolve_rng("auto", "cuda") == "hw"
    assert fused.resolve_rng("auto", torch.device("cuda", 0)) == "hw"
    assert fused.resolve_rng("auto", "cpu") == "hash"
    assert fused.resolve_rng("hash", "cuda") == "hash"
    assert fused.resolve_rng("hw", "cpu") == "hw"
    with pytest.raises(ValueError):
        fused.resolve_rng("bogus", "cpu")
    caplog.set_level(logging.INFO, logger="automix_tpu_torch")
    for rng, word in (("auto", "hash"), ("hw", "hw")):
        caplog.clear()
        _toy1_sampler(64, sweep_chunk=2, fused_rng=rng).burn_samples(2)
        assert any(r.getMessage().startswith(
            f"stage-3 burn-in runner: kernel engine, rng {word} (")
            for r in caplog.records), word
    am = _toy1_sampler(64, sweep_chunk=1)
    am.burn_samples(1)
    tabs = fused.prep_tables(am.proposal, am.modelset.dims)
    ch = am.chains
    with pytest.raises(ValueError, match="rng"):
        fused.sweep_chunk(am.modelset, ch.k, ch.theta.T.contiguous(),
                          ch.logp, ch.pk.T.contiguous(), ch.pkllim,
                          ch.nreinit, tabs, seed=1, sweep0=0, n_sweeps=1,
                          adapt=True, rng="bogus")
