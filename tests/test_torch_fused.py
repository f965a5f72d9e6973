"""Stage-3 sweeps: the plain twin of the port's sweep kernel against the
JAX fused chunk runner run in interpret mode with the counter hash.

Proposal and chain state are made with numpy from a seed and carried to
both packages (``convert.py`` on the torch side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import fused as jfused
from automix_tpu.models import tutorial as jtutorial
from automix_tpu.state import Chains as JaxChains
from automix_tpu.state import Proposal as JaxProposal
from automix_tpu_torch.config import EngineConfig
from automix_tpu_torch.convert import (chains_from_numpy, proposal_from_arrays,
                                       proposal_from_numpy)
from automix_tpu_torch.kernels import fused
from automix_tpu_torch.models import tutorial
from _torch_threads import one_torch_thread  # noqa: F401

S, NSWEEPS, L, SWEEP0, SEED = 1024, 20, 4, 37, 11

# Rough posterior locations and spreads of the three tutorial models:
# Normal (sigma, x0), Beta (alpha, beta), Gamma (alpha, beta).
_CENTERS = np.array([[0.27, 0.38], [1.6, 2.8], [2.3, 6.0]])
_SPREADS = np.array([[0.07, 0.08], [0.6, 1.1], [0.9, 2.4]])


def _proposal(rng):
    K, D = 3, 2
    lam = rng.dirichlet(np.ones(L), size=K)
    mu = _CENTERS[:, None, :] + 0.5 * _SPREADS[:, None, :] \
        * rng.normal(size=(K, L, D))
    B = np.zeros((K, L, D, D))
    B[..., 0, 0] = _SPREADS[:, None, 0] * rng.uniform(0.5, 1.0, (K, L))
    B[..., 1, 1] = _SPREADS[:, None, 1] * rng.uniform(0.5, 1.0, (K, L))
    B[..., 1, 0] = 0.3 * np.sqrt(B[..., 0, 0] * B[..., 1, 1]) \
        * rng.uniform(-1, 1, (K, L))
    logdetB = np.log(B[..., 0, 0]) + np.log(B[..., 1, 1])
    sig = _SPREADS * 1.5
    f32 = np.float32
    return dict(lam=lam.astype(f32), mu=mu.astype(f32), B=B.astype(f32),
                logdetB=logdetB.astype(f32),
                nmix=np.full(K, L, np.int32), sig=sig.astype(f32))


def _chains(rng, prop):
    k = rng.integers(0, 3, size=S).astype(np.int32)
    theta = (_CENTERS[k] + 0.7 * _SPREADS[k] * rng.normal(size=(S, 2)))
    theta = np.abs(theta).astype(np.float32)
    cols = jfused.make_logpost_cols(jtutorial.tutorial_set())
    mks = [jnp.asarray((k == m).astype(np.float32)) for m in range(3)]
    logp = np.asarray(cols(mks, [jnp.asarray(theta[:, 0]),
                                 jnp.asarray(theta[:, 1])]))
    pk = rng.dirichlet(np.ones(3) * 5, size=S).astype(np.float32)
    return dict(k=k, theta=theta, logp=logp, pk=pk,
                pkllim=np.full(S, 0.1, np.float32),
                nreinit=np.ones(S, np.int32), sweep=SWEEP0)


@pytest.mark.parametrize("burning", [True, False])
def test_sweep_chunk_ref_matches_jax_interpret(burning):
    """1024 chains x 20 sweeps (two of them block-move sweeps).  Words are
    bitwise equal; CPU torch and XLA:CPU exp/log/cos differ by ulps, and
    one flipped marginal accept sends a chain elsewhere, so the check is
    per chain: k equal on >= 99% of chains; on those, theta and logp
    within 1e-4 relative and pk within 1e-5; chunk visit counts and
    acceptance counters within 1%."""
    rng = np.random.default_rng(SEED)
    p = _proposal(rng)
    c = _chains(rng, p)

    jcfg = JaxConfig(seed=SEED, n_chains=S, fused="on", fused_rng="hash")
    jrun = jfused.build_fused_chunk_runner(jtutorial.tutorial_set(), jcfg,
                                           burning=burning)
    jprop = JaxProposal(**{n: jnp.asarray(v) for n, v in p.items()})
    jch = JaxChains(key=jax.random.split(jax.random.PRNGKey(0), S),
                    k=jnp.asarray(c["k"]), theta=jnp.asarray(c["theta"]),
                    logp=jnp.asarray(c["logp"]), pk=jnp.asarray(c["pk"]),
                    pkllim=jnp.asarray(c["pkllim"]),
                    nreinit=jnp.asarray(c["nreinit"]),
                    sweep=jnp.asarray(SWEEP0, jnp.int32))
    jch2, jchunk = jax.device_get(jrun(jch, jprop, NSWEEPS))

    run = fused.build_fused_chunk_runner(tutorial.tutorial_set(),
                                         EngineConfig(seed=SEED),
                                         burning=burning)
    ch2, chunk = run(chains_from_numpy(**c), proposal_from_numpy(**p),
                     NSWEEPS)

    assert ch2.sweep == int(jch2.sweep) == SWEEP0 + NSWEEPS
    same = ch2.k.numpy() == np.asarray(jch2.k)
    assert same.mean() >= 0.99, same.mean()
    th, jth = ch2.theta.numpy()[same], np.asarray(jch2.theta)[same]
    np.testing.assert_allclose(th, jth, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ch2.logp.numpy()[same],
                               np.asarray(jch2.logp)[same], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ch2.pk.numpy()[same],
                               np.asarray(jch2.pk)[same], atol=1e-5)
    np.testing.assert_array_equal(ch2.nreinit.numpy()[same],
                                  np.asarray(jch2.nreinit)[same])
    if burning:      # pk frozen during burn-in
        np.testing.assert_array_equal(ch2.pk.numpy(), c["pk"])
    ks, jks = chunk["ksummary"].numpy(), np.asarray(jchunk["ksummary"])
    assert ks.sum() == jks.sum() == S * NSWEEPS
    np.testing.assert_allclose(ks, jks, rtol=0.01, atol=20)
    for name in ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
                 "ntrytd"):
        np.testing.assert_allclose(int(chunk[name]), int(jchunk[name]),
                                   rtol=0.01, atol=5, err_msg=name)
    np.testing.assert_allclose(chunk["theta_sum"].numpy(),
                               np.asarray(jchunk["theta_sum"]), rtol=0.01)


def test_prep_tables_match_jax_layout():
    """The sweep tables: inverse factor, log-weights and allocation base in
    the JAX kernel's [K*L, ...] layout, within float32 rounding."""
    p = _proposal(np.random.default_rng(3))
    p["lam"][0, 1] = 0.0                   # a dead slot -> loglam NEG_INF
    tabs = fused.prep_tables(proposal_from_numpy(**p),
                             tutorial.tutorial_set().dims)
    B = np.tril(p["B"]).reshape(3 * L, 2, 2)
    binv = np.linalg.inv(B.astype(np.float64)).reshape(3 * L, 4)
    np.testing.assert_allclose(tabs.binv.numpy(), binv, rtol=1e-5,
                               atol=1e-6)
    assert tabs.loglam[0, 1] == np.float32(-1e30)
    np.testing.assert_allclose(
        tabs.abase.numpy()[1:],
        np.log(p["lam"][1:]) - p["logdetB"][1:] - np.log(2 * np.pi),
        rtol=1e-5)
    assert tabs.packed().shape == (3 * 2 + 3 * 3 * L + 3 * L * 2
                                   + 2 * 3 * L * 4,)


def _toy2_proposal(rng, L=3):
    """A toy2 proposal near the two modes (+5 and -5 on every coordinate)
    of each model, with correlated lower-triangular factors."""
    K, D = 5, 5
    dims = np.arange(1, 6)
    lam = rng.dirichlet(np.ones(L) * 3, size=K)
    sign = np.where(np.arange(L) % 2 == 0, -5.0, 5.0)
    mu = sign[None, :, None] + 0.3 * rng.normal(size=(K, L, D))
    B = np.zeros((K, L, D, D))
    for i in range(D):
        B[..., i, i] = rng.uniform(0.8, 2.0, (K, L))
        B[..., i, :i] = 0.2 * rng.uniform(-1, 1, (K, L, i))
    mask = np.arange(D)[None, :] < dims[:, None]                  # [K, D]
    mu = mu * mask[:, None, :]
    eye = np.eye(D)
    keep = mask[:, None, :, None] & mask[:, None, None, :]
    B = np.where(keep, B, eye)
    logdetB = np.sum(np.log(np.diagonal(B, axis1=-2, axis2=-1))
                     * mask[:, None, :], axis=-1)
    f32 = np.float32
    return dict(lam=lam.astype(f32), mu=mu.astype(f32), B=B.astype(f32),
                logdetB=logdetB.astype(f32), nmix=np.full(K, L, np.int32),
                sig=np.full((K, D), 1.5, f32) * mask.astype(f32))


def _toy2_chains(rng):
    from automix_tpu.models import toy as jtoy
    k = rng.integers(0, 5, size=S).astype(np.int32)
    mode = np.where(rng.random(S) < 0.3, 5.0, -5.0)
    theta = mode[:, None] + rng.normal(size=(S, 5))
    theta = (theta * (np.arange(5)[None, :] <= k[:, None])).astype(np.float32)
    cols = jfused.make_logpost_cols(jtoy.toy2_set())
    mks = [jnp.asarray((k == m).astype(np.float32)) for m in range(5)]
    logp = np.asarray(cols(mks, [jnp.asarray(theta[:, d]) for d in range(5)]))
    pk = rng.dirichlet(np.ones(5) * 5, size=S).astype(np.float32)
    return dict(k=k, theta=theta, logp=logp, pk=pk,
                pkllim=np.full(S, 0.1, np.float32),
                nreinit=np.ones(S, np.int32), sweep=SWEEP0)


@pytest.mark.parametrize("variant", [dict(perm=True), dict(student_t_dof=5)],
                         ids=["perm", "student_t"])
def test_sweep_chunk_ref_variants_match_jax_on_toy2(variant):
    """K1's perm and Student-t variants through the trans-dimensional half
    of the move: toy2 (dims 1..5), 1024 chains x 12 sweeps (one block
    sweep) under a 3-component proposal, against the JAX fused runner in
    interpret mode.  Words are bitwise equal; the tolerances are those of
    the tutorial test: k equal on >= 99% of chains, theta and logp within
    1e-4 relative on those, counters within 1%."""
    from automix_tpu.models import toy as jtoy
    from automix_tpu_torch.models import toy
    nsweeps = 12
    rng = np.random.default_rng(SEED + 1)
    p = _toy2_proposal(rng)
    c = _toy2_chains(rng)

    jcfg = JaxConfig(seed=SEED, n_chains=S, fused="on", fused_rng="hash",
                     **variant)
    jrun = jfused.build_fused_chunk_runner(jtoy.toy2_set(), jcfg,
                                           burning=False)
    jprop = JaxProposal(**{n: jnp.asarray(v) for n, v in p.items()})
    jch = JaxChains(key=jax.random.split(jax.random.PRNGKey(0), S),
                    **{n: jnp.asarray(v) for n, v in c.items()
                       if n != "sweep"},
                    sweep=jnp.asarray(SWEEP0, jnp.int32))
    jch2, jchunk = jax.device_get(jrun(jch, jprop, nsweeps))

    run = fused.build_fused_chunk_runner(
        toy.toy2_set(), EngineConfig(seed=SEED, **variant), burning=False)
    ch2, chunk = run(chains_from_numpy(**c), proposal_from_arrays(jprop),
                     nsweeps)

    same = ch2.k.numpy() == np.asarray(jch2.k)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(ch2.theta.numpy()[same],
                               np.asarray(jch2.theta)[same], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ch2.logp.numpy()[same],
                               np.asarray(jch2.logp)[same], rtol=1e-4,
                               atol=1e-4)
    ks, jks = chunk["ksummary"].numpy(), np.asarray(jchunk["ksummary"])
    assert ks.sum() == jks.sum() == S * nsweeps
    np.testing.assert_allclose(ks, jks, rtol=0.01, atol=20)
    for name in ("naccrwmb", "ntryrwmb", "naccrwms", "ntryrwms", "nacctd",
                 "ntrytd"):
        np.testing.assert_allclose(int(chunk[name]), int(jchunk[name]),
                                   rtol=0.01, atol=5, err_msg=name)
    # the move really changed dimension on a share of chains
    assert (ch2.k.numpy() != c["k"]).mean() > 0.05
