"""Pooled pk (``pk_mode="pooled"``): the port's two routes, K1c's twin
(``sweep_chunk_ref(pooled=True)``) and K1d (``pooled_scan``, on the CPU
its plain version, the one-sweep route ``pooled_sweeps`` over the twin),
against the JAX fused runner in interpret mode with the counter hash,
through both of its pooled routes, and against each other.  Proposal and
chain state are made with numpy from a seed."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import fused as jfused
from automix_tpu.models import toy as jtoy
from automix_tpu.state import Chains as JaxChains
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.convert import chains_from_numpy, proposal_from_numpy
from automix_tpu_torch.kernels import fused
from automix_tpu_torch.models import changepoint, rb9, toy
from _torch_threads import one_torch_thread  # noqa: F401

S, L, NSWEEPS, SWEEP0, SEED = 1024, 3, 20, 41, 5
_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                        "rb9_pooled_fixture.npz")
_CPT_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                            "cpt_pooled_fixture.npz")


def _toy1_proposal(rng):
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
    return dict(lam=lam.astype(f32), mu=mu.astype(f32), B=B.astype(f32),
                logdetB=logdet.astype(f32), nmix=np.full(K, L, np.int32),
                sig=(1.5 * mask).astype(f32))


def _toy1_chains(rng, pkllim):
    """Chains spread over both models; pkllim 0.45 makes the shared pk
    fall below it within the first sweeps, so the re-init blend runs."""
    K, D = 2, 2
    k = rng.integers(0, K, S).astype(np.int32)
    theta = (2.0 * rng.normal(size=(S, D))
             * (np.arange(D)[None] <= k[:, None])).astype(np.float32)
    cols = jfused.make_logpost_cols(jtoy.toy1_set())
    logp = np.asarray(cols([jnp.asarray((k == m).astype(np.float32))
                            for m in range(K)],
                           [jnp.asarray(theta[:, d]) for d in range(D)]))
    return dict(k=k, theta=theta, logp=logp,
                pk=np.full((S, K), 0.5, np.float32),
                pkllim=np.full(S, pkllim, np.float32),
                nreinit=np.ones(S, np.int32), sweep=SWEEP0)


def _port_run(p, c, force: bool, chunks=(NSWEEPS,)):
    """The port's pooled runner on toy1 through K1c's twin (force False)
    or the K1d runner (force True), over the given chunk lengths."""
    fused._FORCE_POOLED_SCAN = force
    try:
        run = fused.build_fused_chunk_runner(
            toy.toy1_set(), EngineConfig(seed=SEED, pk_mode="pooled"),
            burning=False)
        ch, prop, out = chains_from_numpy(**c), proposal_from_numpy(**p), []
        for n in chunks:
            ch, chunk = run(ch, prop, n)
            out.append(chunk)
    finally:
        fused._FORCE_POOLED_SCAN = False
    return ch, out


@pytest.mark.parametrize("jax_scan", [False, True],
                         ids=["jax_inkernel", "jax_scan"])
@pytest.mark.parametrize("pkllim", [0.1, 0.45], ids=["plain", "reinit"])
def test_pooled_routes_match_jax_on_toy1(jax_scan, pkllim):
    """1024 toy1 chains x 20 sweeps.  Both port routes against the JAX
    route: words are bitwise equal and the histogram is an integer, so
    only libm ulps separate the runs: k equal on >= 99% of chains, theta
    and logp within 1e-4 relative on those, the shared pk within 1e-7
    (a few float32 ulps: torch's and XLA's float32 exp and log on the CPU
    differ in the last bit for some sweep indices, so the gains can),
    pkllim and nreinit equal, visit counts and counters within 1% (the
    tolerances of test_torch_fused.py)."""
    rng = np.random.default_rng(SEED)
    p = _toy1_proposal(rng)
    c = _toy1_chains(rng, pkllim)
    jfused._FORCE_POOLED_SCAN = jax_scan
    try:
        jrun = jfused.build_fused_chunk_runner(
            jtoy.toy1_set(), JaxConfig(seed=SEED, n_chains=S, fused="on",
                                       fused_rng="hash", pk_mode="pooled"),
            burning=False)
        jch = JaxChains(key=jax.random.split(jax.random.PRNGKey(0), S),
                        **{n: jnp.asarray(v) for n, v in c.items()
                           if n != "sweep"},
                        sweep=jnp.asarray(SWEEP0, jnp.int32))
        jch2, jchunk = jax.device_get(jrun(
            jch, JaxProposal(**{n: jnp.asarray(v) for n, v in p.items()}),
            NSWEEPS))
    finally:
        jfused._FORCE_POOLED_SCAN = False
    if pkllim > 0.4:
        assert int(np.asarray(jch2.nreinit)[0]) > 1      # re-init ran
    for force in (False, True):
        ch, (chunk,) = _port_run(p, c, force)
        same = ch.k.numpy() == np.asarray(jch2.k)
        assert same.mean() >= 0.99, (force, same.mean())
        np.testing.assert_allclose(ch.theta.numpy()[same],
                                   np.asarray(jch2.theta)[same], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(ch.logp.numpy()[same],
                                   np.asarray(jch2.logp)[same], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(ch.pk.numpy(), np.asarray(jch2.pk),
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(ch.pkllim.numpy(),
                                      np.asarray(jch2.pkllim))
        np.testing.assert_array_equal(ch.nreinit.numpy(),
                                      np.asarray(jch2.nreinit))
        ks, jks = chunk["ksummary"].numpy(), np.asarray(jchunk["ksummary"])
        assert ks.sum() == jks.sum() == S * NSWEEPS
        np.testing.assert_allclose(ks, jks, rtol=0.01, atol=20)
        for name in ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms",
                     "nacctd", "ntrytd"):
            np.testing.assert_allclose(int(chunk[name]), int(jchunk[name]),
                                       rtol=0.01, atol=5, err_msg=name)
        np.testing.assert_allclose(chunk["theta_sum"].numpy(),
                                   np.asarray(jchunk["theta_sum"]),
                                   rtol=0.01)


def test_pooled_port_routes_bitwise_equal():
    """K1c's twin and the K1d runner over two chunks (12 + 8 sweeps, with
    the re-init blend): bitwise equal in k, theta, logp, pk, pkllim,
    nreinit, the visit counts and the counters; the float sums, summed in
    another order, within 1e-5 relative.  Every row of pk is the shared
    vector."""
    rng = np.random.default_rng(SEED + 1)
    p = _toy1_proposal(rng)
    c = _toy1_chains(rng, 0.45)
    a, ca = _port_run(p, c, False, chunks=(12, 8))
    b, cb = _port_run(p, c, True, chunks=(12, 8))
    for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.sweep == b.sweep == SWEEP0 + NSWEEPS
    assert bool((a.pk == a.pk[0]).all()) and int(a.nreinit[0]) > 1
    for x, y in zip(ca, cb):
        for name in x:
            if name.startswith("theta"):
                torch.testing.assert_close(x[name], y[name], rtol=1e-5,
                                           atol=1e-3)
            else:
                assert torch.equal(x[name], y[name]), name


def test_rb9_pooled_matches_jax_fixture():
    """rb9 (K = 10, D = 5) pooled, 1024 chains x 5 sweeps, L = 2, through
    both port routes against the JAX package's frozen run
    (``tests/data/make_rb9_pooled_fixture.py``, both JAX routes equal):
    k equal on >= 99% of chains, theta and logp within 1e-4 relative on
    those, the shared pk, pkllim and nreinit equal, visit counts within
    1%."""
    z = np.load(_FIXTURE)
    n_chains, _, nsweeps, sweep0, seed = (int(x) for x in z["meta"])
    p = {n[5:]: z[n] for n in z.files if n.startswith("prop_")}
    c = {n[3:]: z[n] for n in z.files if n.startswith("in_")}
    ms = rb9.rb9_set()
    for force in (False, True):
        fused._FORCE_POOLED_SCAN = force
        try:
            run = fused.build_fused_chunk_runner(
                ms, EngineConfig(seed=seed, pk_mode="pooled"),
                burning=False)
            ch, chunk = run(chains_from_numpy(**c, sweep=sweep0),
                            proposal_from_numpy(**p), nsweeps)
        finally:
            fused._FORCE_POOLED_SCAN = False
        same = ch.k.numpy() == z["out_k"]
        assert same.mean() >= 0.99, same.mean()
        assert (ch.k.numpy() != c["k"]).mean() > 0.05      # models change
        np.testing.assert_allclose(ch.theta.numpy()[same],
                                   z["out_theta"][same], rtol=1e-4)
        np.testing.assert_allclose(ch.logp.numpy()[same],
                                   z["out_logp"][same], rtol=1e-4)
        np.testing.assert_array_equal(ch.pk.numpy(), z["out_pk"])
        np.testing.assert_array_equal(ch.pkllim.numpy(), z["out_pkllim"])
        np.testing.assert_array_equal(ch.nreinit.numpy(), z["out_nreinit"])
        ks = chunk["ksummary"].numpy()
        assert ks.sum() == n_chains * nsweeps
        np.testing.assert_allclose(ks, z["chunk_ksummary"], rtol=0.01,
                                   atol=20)


def test_pooled_checkpoint_resume_through_k1d(tmp_path):
    """A pooled toy1 run through the K1d runner, saved after 50 of 100
    production sweeps and resumed in a new sampler, ends bitwise where the
    run that was never stopped ends (tests/test_fused.py:404): the shared
    pk, pkllim and nreinit ride the per-chain arrays."""
    path = str(tmp_path / "pooled_ckpt.npz")
    prop = proposal_from_numpy(**_toy1_proposal(np.random.default_rng(2)))
    cfg = EngineConfig(n_chains=1024, sweep_chunk=50, seed=19,
                       pk_mode="pooled", trace_chain0=False)

    def mk():
        am = AMSampler(toy.toy1_set(), cfg, device="cpu")
        am.set_proposal(prop)
        return am

    fused._FORCE_POOLED_SCAN = True
    try:
        a = mk()
        a.burn_samples(20)
        a.rjmcmc_samples(100)
        b = mk()
        b.burn_samples(20)
        b.rjmcmc_samples(50)
        b.save(path)
        c = AMSampler(toy.toy1_set(), cfg, device="cpu")
        c.load(path)
        c.rjmcmc_samples(50)
    finally:
        fused._FORCE_POOLED_SCAN = False
    for f in ("k", "theta", "pk", "pkllim", "nreinit"):
        assert torch.equal(getattr(a.chains, f), getattr(c.chains, f)), f
    np.testing.assert_array_equal(a.stats.ksummary, c.stats.ksummary)
    assert a.chains.sweep == c.chains.sweep == 121


def test_pooled_wrapper_rules():
    """Pooled adaptation needs adapt and K > 1; on CPU tensors both routes
    are twins and no launch counter moves; burn-in keeps the per-chunk
    path with pk frozen."""
    rng = np.random.default_rng(3)
    p = _toy1_proposal(rng)
    c = _toy1_chains(rng, 0.1)
    ch, prop = chains_from_numpy(**c), proposal_from_numpy(**p)
    tabs = fused.prep_tables(prop, toy.toy1_set().dims)
    args = (ch.k, ch.theta.T.contiguous(), ch.logp, ch.pk.T.contiguous(),
            ch.pkllim, ch.nreinit, tabs)
    with pytest.raises(ValueError, match="pooled"):
        fused.sweep_chunk(toy.toy1_set(), *args, seed=1, sweep0=5,
                          n_sweeps=2, adapt=False, pooled=True)
    before = (fused.sweep_chunk.launches, fused.sweep_chunk.pooled_launches)
    for force in (False, True):
        _port_run(p, c, force, chunks=(3,))
    burn = fused.build_fused_chunk_runner(
        toy.toy1_set(), EngineConfig(pk_mode="pooled"), burning=True)
    ch2, _ = burn(ch, prop, 4)
    assert torch.equal(ch2.pk, ch.pk)
    assert (fused.sweep_chunk.launches,
            fused.sweep_chunk.pooled_launches) == before


def test_k1d_at_the_changepoint_shape_matches_jax():
    """K1d at (6, 13), the route of a pooled cpt run above K1c's bound
    (forced with ``_FORCE_POOLED_SCAN``), 1024 cpt chains x 4 sweeps (a
    block move at 50) against JAX's ``_compiled_pooled`` in interpret mode
    with the hash, frozen by ``tests/data/make_cpt_pooled_fixture.py``
    (its compile takes minutes): the tolerances of the toy1 test (k equal
    on >= 99% of chains, theta and logp within 1e-4 relative on those,
    the shared pk within 1e-7, pkllim and nreinit equal, visit counts and
    counters within 1%)."""
    z = np.load(_CPT_FIXTURE)
    n_chains, _, n, sweep0, seed = (int(x) for x in z["meta"])
    p = {f[5:]: z[f] for f in z.files if f.startswith("prop_")}
    c = {f[3:]: z[f] for f in z.files if f.startswith("in_")}
    fused._FORCE_POOLED_SCAN = True
    try:
        run = fused.build_fused_chunk_runner(
            changepoint.cpt_set(), EngineConfig(seed=seed, pk_mode="pooled"),
            burning=False)
        ch, chunk = run(chains_from_numpy(**c, sweep=sweep0),
                        proposal_from_numpy(**p), n)
    finally:
        fused._FORCE_POOLED_SCAN = False
    same = ch.k.numpy() == z["out_k"]
    assert same.mean() >= 0.99, same.mean()
    assert (ch.k.numpy() != c["k"]).any()                   # jumps
    np.testing.assert_allclose(ch.theta.numpy()[same], z["out_theta"][same],
                               rtol=1e-4)
    np.testing.assert_allclose(ch.logp.numpy()[same], z["out_logp"][same],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ch.pk.numpy(), z["out_pk"], rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(ch.pkllim.numpy(), z["out_pkllim"])
    np.testing.assert_array_equal(ch.nreinit.numpy(), z["out_nreinit"])
    ks = chunk["ksummary"].numpy()
    assert ks.sum() == z["chunk_ksummary"].sum() == n_chains * n
    np.testing.assert_allclose(ks, z["chunk_ksummary"], rtol=0.01, atol=20)
    for name in ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
                 "ntrytd"):
        np.testing.assert_allclose(int(chunk[name]),
                                   int(z[f"chunk_{name}"]), rtol=0.01,
                                   atol=5, err_msg=name)


def test_k1d_on_the_cpu_is_its_plain_version():
    """``pooled_scan`` on CPU tensors is the one-sweep route over the twin,
    bit for bit in every chain field and chunk statistic, and launches
    nothing (toy1, 1024 chains x 12 sweeps with the re-init blend)."""
    rng = np.random.default_rng(SEED + 3)
    p, c = _toy1_proposal(rng), _toy1_chains(rng, 0.45)
    ms, ch = toy.toy1_set(), chains_from_numpy(**c)
    tabs = fused.prep_tables(proposal_from_numpy(**p), ms.dims)
    counters = ("launches", "hw_launches", "scan_launches",
                "scan_hw_launches")
    before = [getattr(fused.sweep_chunk, n) for n in counters]
    for rng_name in ("hash", "hw"):
        a, ca = fused.pooled_scan(ms, ch, tabs, 12, seed=SEED, rng=rng_name)
        b, cb = fused.pooled_sweeps(ms, ch, tabs, 12, seed=SEED,
                                    sweep_fn=fused.sweep_chunk_ref,
                                    rng=rng_name)
        for f in ("k", "theta", "logp", "pk", "pkllim", "nreinit"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.sweep == b.sweep == SWEEP0 + 12
        for name in ca:
            assert torch.equal(ca[name], cb[name]), name
        assert int(a.nreinit[0]) > 1                        # re-init ran
    assert [getattr(fused.sweep_chunk, n) for n in counters] == before
