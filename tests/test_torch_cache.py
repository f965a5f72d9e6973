"""K1e's control flow, the sweep's incremental-density cache, against the
JAX fused kernel itself.

The DDI kernel of the JAX package cannot run in interpret mode on the CPU
(its ~60k-equation body, ``automix_tpu/models/ddi_cols.py:38-41``), so the
cache's control flow is held here with a small incremental density of
this file's own, written once for both packages: two models of dims 3
and 2, each with a cached linear and quadratic statistic updated
incrementally on coordinate moves (model 1's statistics untouched by
coordinate 2, which come back as the same objects).  It implements the
JAX ``FusedColsDensity`` protocol (``automix_tpu/kernels/fused.py:209-
230``) and the port's (``automix_tpu_torch/model.py:make_density``), so
nothing in the JAX package changes.

The JAX fused runner runs in interpret mode with the counter hash, 1024
chains x 40 sweeps from sweep 5: block moves at 10, 20, 30 and 40, cache
refreshes after 15 and 31, so the last 13 sweeps' logp is carried by the
cache alone.  The port's twin (``sweep_chunk_ref``) runs from the same
state and proposal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import fused as jfused
from automix_tpu.model import Model as JaxModel
from automix_tpu.model import ModelSet as JaxModelSet
from automix_tpu.state import Chains as JaxChains
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.convert import chains_from_numpy, proposal_from_numpy
from automix_tpu_torch.kernels import fused
from automix_tpu_torch.model import Model, ModelSet
from _torch_threads import one_torch_thread  # noqa: F401

S, NSWEEPS, L, SWEEP0, SEED = 1024, 40, 3, 5, 17
DIMS = (3, 2)
LOGW = (math.log(0.4), math.log(0.6))


# The density's arithmetic, shared by both packages (+, -, * only).
def _stats_full(rows):
    s0 = (rows[0] + 2.0 * rows[1]) - rows[2]
    q0 = (rows[0] * rows[0] + rows[1] * rows[1]) + 0.5 * (rows[2] * rows[2])
    s1 = rows[0] - rows[1]
    q1 = rows[0] * rows[0] + 2.0 * (rows[1] * rows[1])
    return (s0, q0, s1, q1)


def _stats_coord(j, rows, old_j, cache):
    s0, q0, s1, q1 = cache
    dd = rows[j] - old_j
    dq = (rows[j] + old_j) * dd
    s0 = s0 + (1.0, 2.0, -1.0)[j] * dd
    q0 = q0 + (1.0, 1.0, 0.5)[j] * dq
    if j < 2:
        s1 = s1 + (1.0, -1.0)[j] * dd
        q1 = q1 + (1.0, 2.0)[j] * dq
    return (s0, q0, s1, q1)


def _lps(cache):
    s0, q0, s1, q1 = cache
    return (LOGW[0] + 0.3 * s0 - 0.5 * q0, LOGW[1] + 0.2 * s1 - 0.5 * q1)


class _JaxDensity:
    """The JAX FusedColsDensity: one-hot model masks ``mks``."""

    n_cache = 4

    def table_arrays(self, ndim):
        return ()

    def full(self, mks, rows, tabs=()):
        cache = _stats_full(rows)
        lp0, lp1 = _lps(cache)
        return mks[0] * lp0 + mks[1] * lp1, cache

    def coord(self, j, mks, rows, old_j, cache, tabs=()):
        cache = _stats_coord(j, rows, old_j, cache)
        lp0, lp1 = _lps(cache)
        return mks[0] * lp0 + mks[1] * lp1, cache


class _TorchDensity:
    """The port's protocol: model indices ``k``."""

    n_cache = 4

    def full(self, k, rows):
        cache = _stats_full(rows)
        lp0, lp1 = _lps(cache)
        return torch.where(k == 0, lp0, lp1), cache

    def coord(self, j, k, rows, old_j, cache):
        cache = _stats_coord(j, rows, old_j, cache)
        lp0, lp1 = _lps(cache)
        return torch.where(k == 0, lp0, lp1), cache


def _logp_scalar(m):
    def logp(theta):
        rows = [theta[i] for i in range(DIMS[m])] + [0.0] * (3 - DIMS[m])
        return _lps(_stats_full(rows))[m]
    return logp


def _model_sets():
    jms = JaxModelSet([JaxModel(f"toy_k{m}", DIMS[m], _logp_scalar(m))
                       for m in range(2)], fused_density=_JaxDensity())
    ms = ModelSet([Model(f"toy_k{m}", DIMS[m], _logp_scalar(m))
                   for m in range(2)], fused_density=_TorchDensity())
    return jms, ms


def _proposal(rng):
    K, D = 2, 3
    mask = np.arange(D)[None] < np.asarray(DIMS)[:, None]
    mu = 0.5 * rng.normal(size=(K, L, D)) * mask[:, None]
    B = np.tril(0.3 * rng.normal(size=(K, L, D, D)), -1) + np.eye(D) \
        * rng.uniform(0.6, 1.2, (K, L, 1, D))
    keep = mask[:, None, :, None] & mask[:, None, None, :]
    B = np.where(keep, B, np.eye(D))
    logdet = np.sum(np.log(np.diagonal(B, axis1=-2, axis2=-1))
                    * mask[:, None], axis=-1)
    f32 = np.float32
    return dict(lam=rng.dirichlet(np.ones(L), size=K).astype(f32),
                mu=mu.astype(f32), B=B.astype(f32),
                logdetB=logdet.astype(f32),
                nmix=np.full(K, L, np.int32),
                sig=(0.8 * mask).astype(f32))


def _chains(rng):
    k = rng.integers(0, 2, size=S).astype(np.int32)
    theta = rng.normal(size=(S, 3)).astype(np.float32)
    theta[k == 1, 2] = 0.0
    mks = [jnp.asarray((k == m).astype(np.float32)) for m in range(2)]
    logp = np.asarray(_JaxDensity().full(
        mks, [jnp.asarray(theta[:, d]) for d in range(3)])[0])
    pk = rng.dirichlet(np.ones(2) * 5, size=S).astype(np.float32)
    return dict(k=k, theta=theta, logp=logp, pk=pk,
                pkllim=np.full(S, 0.1, np.float32),
                nreinit=np.ones(S, np.int32), sweep=SWEEP0)


def test_cache_twin_matches_jax_interpret():
    """k equal on >= 99% of chains (the words are bitwise equal; CPU torch
    and XLA:CPU exp and log differ by ulps, and a flipped marginal accept
    sends a chain elsewhere); on those, theta and logp within 1e-4
    relative (the RJ latent goes through log and cos), pk within 1e-5; the
    carried logp's distance from a fresh evaluation (what the cache
    carries since the refresh after sweep 31) within 1e-5 of JAX's; the
    visit counts and acceptance counters within 1%."""
    rng = np.random.default_rng(SEED)
    p = _proposal(rng)
    c = _chains(rng)
    jms, ms = _model_sets()

    jcfg = JaxConfig(seed=SEED, n_chains=S, fused="on", fused_rng="hash")
    jrun = jfused.build_fused_chunk_runner(jms, jcfg, burning=False)
    jprop = JaxProposal(**{n: jnp.asarray(v) for n, v in p.items()})
    jch = JaxChains(key=jax.random.split(jax.random.PRNGKey(0), S),
                    k=jnp.asarray(c["k"]), theta=jnp.asarray(c["theta"]),
                    logp=jnp.asarray(c["logp"]), pk=jnp.asarray(c["pk"]),
                    pkllim=jnp.asarray(c["pkllim"]),
                    nreinit=jnp.asarray(c["nreinit"]),
                    sweep=jnp.asarray(SWEEP0, jnp.int32))
    jch2, jchunk = jax.device_get(jrun(jch, jprop, NSWEEPS))

    run = fused.build_fused_chunk_runner(ms, EngineConfig(seed=SEED),
                                         burning=False)
    ch2, chunk = run(chains_from_numpy(**c), proposal_from_numpy(**p),
                     NSWEEPS)

    jk, jth, jlp = (np.asarray(jch2.k), np.asarray(jch2.theta),
                    np.asarray(jch2.logp))
    k, th, lp = ch2.k.numpy(), ch2.theta.numpy(), ch2.logp.numpy()
    same = k == jk
    assert same.mean() >= 0.99, same.mean()
    assert (k != c["k"]).mean() > 0.05                 # jumps happened
    np.testing.assert_allclose(th[same], jth[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lp[same], jlp[same], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ch2.pk.numpy()[same],
                               np.asarray(jch2.pk)[same], atol=1e-5)

    # what the cache carries: logp against a fresh evaluation
    def fresh(kk, theta):
        rows = [torch.tensor(theta[:, d]) for d in range(3)]
        return _TorchDensity().full(torch.tensor(kk), rows)[0].numpy()

    drift, jdrift = lp - fresh(k, th), jlp - fresh(jk, jth)
    assert np.abs(drift).max() > 0.0          # incremental, not recomputed
    np.testing.assert_allclose(drift[same], jdrift[same], atol=1e-5)

    ks, jks = chunk["ksummary"].numpy(), np.asarray(jchunk["ksummary"])
    assert ks.sum() == jks.sum() == S * NSWEEPS
    np.testing.assert_allclose(ks, jks, rtol=0.01)
    for name in ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
                 "ntrytd"):
        np.testing.assert_allclose(int(chunk[name]), int(jchunk[name]),
                                   rtol=0.01, atol=5, err_msg=name)


def test_cache_refresh_and_chunk_start():
    """The twin's cache bookkeeping on its own: a chunk ending on a refresh
    sweep (t % 16 == 15) leaves logp equal to a fresh evaluation bit for
    bit, one ending elsewhere carries it incrementally; a chunk start
    rebuilds the cache but keeps logp (two chunks of 20 and 20 sweeps
    differ from one of 40 only through that rebuild)."""
    rng = np.random.default_rng(SEED + 1)
    p = proposal_from_numpy(**_proposal(rng))
    c = chains_from_numpy(**_chains(rng))
    _, ms = _model_sets()
    tabs = fused.prep_tables(p, ms.dims)
    args = (c.k, c.theta.T.contiguous(), c.logp, c.pk.T.contiguous(),
            c.pkllim, c.nreinit, tabs)

    def run(sweep0, n, state=args):
        return fused.sweep_chunk_ref(ms, *state, seed=SEED, sweep0=sweep0,
                                     n_sweeps=n, adapt=False)

    def fresh(out):
        return _TorchDensity().full(out[0].long(), list(out[1]))[0]

    at_refresh = run(SWEEP0, 31 - SWEEP0 + 1)          # ends on t = 31
    assert torch.equal(at_refresh[2], fresh(at_refresh))
    past = run(SWEEP0, 31 - SWEEP0 + 6)                # ends on t = 36
    assert not torch.equal(past[2], fresh(past))
    one = run(SWEEP0, 40)
    first = run(SWEEP0, 20)
    two = run(SWEEP0 + 20, 20, first[:6] + (tabs,))
    same = one[0] == two[0]
    assert same.float().mean() >= 0.99
    torch.testing.assert_close(one[1][:, same], two[1][:, same], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("route", ["K1d", "K1c"])
def test_pooled_runner_with_the_cache_matches_jax_interpret(route,
                                                            monkeypatch):
    """Pooled pk with the cached density against the JAX package in
    interpret mode, 1024 chains x 6 sweeps from sweep 12 (a cache refresh
    after 15): ``route="K1d"`` is the port's per-sweep runner
    (``fused.pooled_sweeps``, one cache rebuild a sweep) against JAX's
    ``_compiled_pooled`` (forced by its test hook
    ``_FORCE_POOLED_SCAN``), ``"K1c"`` the port's chunk runner with its
    in-kernel pooled update (K1c's twin) against JAX's in-kernel pooled
    branch (its one lane block holds the 1024 chains).  Both start from
    one shared pk.  Tolerances as the per-chain test's: k equal on >= 99%
    of chains (ulp-level exp and log between CPU torch and XLA:CPU can
    flip a marginal accept), theta and logp within 1e-4 relative on those;
    the shared pk, from integer histograms that differ only by those
    flips, within 1e-4 (within 1e-6 where every chain agrees: the gain
    is one float32 exp-log expression in both), pkllim and nreinit equal;
    the visit counts within 1%."""
    n_sweeps, sweep0 = 6, 12
    rng = np.random.default_rng(SEED + 2)
    p = _proposal(rng)
    c = _chains(rng)
    c["pk"][:] = (0.45, 0.55)
    c["sweep"] = sweep0
    jms, ms = _model_sets()

    monkeypatch.setattr(jfused, "_FORCE_POOLED_SCAN", route == "K1d")
    jcfg = JaxConfig(seed=SEED, n_chains=S, fused="on", fused_rng="hash",
                     pk_mode="pooled")
    jrun = jfused.build_fused_chunk_runner(jms, jcfg, burning=False)
    jprop = JaxProposal(**{n: jnp.asarray(v) for n, v in p.items()})
    jch = JaxChains(key=jax.random.split(jax.random.PRNGKey(0), S),
                    k=jnp.asarray(c["k"]), theta=jnp.asarray(c["theta"]),
                    logp=jnp.asarray(c["logp"]), pk=jnp.asarray(c["pk"]),
                    pkllim=jnp.asarray(c["pkllim"]),
                    nreinit=jnp.asarray(c["nreinit"]),
                    sweep=jnp.asarray(sweep0, jnp.int32))
    jch2, jchunk = jax.device_get(jrun(jch, jprop, n_sweeps))

    chains, prop = chains_from_numpy(**c), proposal_from_numpy(**p)
    if route == "K1d":
        ch2, chunk = fused.pooled_sweeps(
            ms, chains, fused.prep_tables(prop, ms.dims), n_sweeps,
            seed=SEED)
    else:
        run = fused.build_fused_chunk_runner(
            ms, EngineConfig(seed=SEED, pk_mode="pooled"), burning=False)
        ch2, chunk = run(chains, prop, n_sweeps)

    k, jk = ch2.k.numpy(), np.asarray(jch2.k)
    same = k == jk
    assert same.mean() >= 0.99, same.mean()
    assert (k != c["k"]).mean() > 0.02                 # jumps happened
    np.testing.assert_allclose(ch2.theta.numpy()[same],
                               np.asarray(jch2.theta)[same], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ch2.logp.numpy()[same],
                               np.asarray(jch2.logp)[same], rtol=1e-4,
                               atol=1e-4)
    pk, jpk = ch2.pk.numpy(), np.asarray(jch2.pk)
    assert np.all(pk == pk[:1]) and np.all(jpk == jpk[:1])   # one shared pk
    np.testing.assert_allclose(pk, jpk, atol=1e-6 if same.all() else 1e-4)
    np.testing.assert_array_equal(ch2.pkllim.numpy(),
                                  np.asarray(jch2.pkllim))
    np.testing.assert_array_equal(ch2.nreinit.numpy(),
                                  np.asarray(jch2.nreinit))
    ks, jks = chunk["ksummary"].numpy(), np.asarray(jchunk["ksummary"])
    assert ks.sum() == jks.sum() == S * n_sweeps
    np.testing.assert_allclose(ks, jks, rtol=0.01)
