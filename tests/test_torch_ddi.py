"""The DDI family (models/ddi*.py) against the JAX package on the CPU.

States are made with numpy from a seed, 24-64 of them, in and out of
support (a precision not positive definite, a negative variance), as in
``tests/test_ddi_fused.py``.  The JAX DDI kernel cannot run on the CPU, so
the port's density is held at density level against
``DDIFusedDensity.full`` / ``.coord`` and ``ddi_set().logpost_batch``, and
its sweep twin carries the cache as the kernel does.
"""

import filecmp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.models import ddi as jddi
from automix_tpu.models import ddi_stats as jddi_stats
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.kernels import _build, fused
from automix_tpu_torch.model import ModelSet
from automix_tpu_torch.models import ddi, ddi_stats
from automix_tpu_torch.ops import randoms
from automix_tpu_torch.state import Proposal
from _torch_threads import one_torch_thread  # noqa: F401

INIT0 = np.concatenate([[10, 0, 0, 0, 0, 0, -3, 0, 0],
                        [1, 0, 1, 0, 0, 1], [100.0]])
INIT1 = np.concatenate([[10, 0, 0, 0, -3, 0], [1, 0, 1], [100.0],
                        np.zeros(6)])
ROOT = Path(__file__).resolve().parents[1]


def _random_states(seed, S, scale=0.2):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2, S).astype(np.int32)
    theta = np.zeros((S, 16), np.float32)
    for i in range(S):
        theta[i] = (INIT0 if k[i] == 0 else INIT1) \
            + scale * rng.standard_normal(16)
        if i % 7 == 0:          # precision not positive definite: reject
            theta[i, 9 if k[i] == 0 else 6] = -1.0
        if i % 11 == 0:         # negative error variance: reject
            theta[i, 15 if k[i] == 0 else 9] = -5.0
    return k, theta


def _both(k, theta):
    """(JAX masks and rows, port k and rows) of one state."""
    mks = [jnp.asarray((k == m).astype(np.float32)) for m in range(2)]
    jrows = [jnp.asarray(theta[:, d]) for d in range(16)]
    rows = [torch.tensor(theta[:, d]) for d in range(16)]
    return mks, jrows, torch.tensor(k).long(), rows


def _jax_density():
    return jddi.ddi_set(fused=True).fused_density


def test_data_copy_is_byte_equal():
    assert filecmp.cmp(ROOT / "automix_tpu_torch/models/ddi_data.npz",
                       ROOT / "automix_tpu/models/ddi_data.npz",
                       shallow=False)


def test_class_tables_match_jax():
    """build_class_tables equals JAX's array by array, both models."""
    data = ddi._load_data()
    for design, fixed in (("W", "X"), ("Q", "P")):
        args = (data[design], data[fixed], data["Y"], data["visit_mask"],
                data["S"])
        got = ddi_stats.build_class_tables(*args)
        want = jddi_stats.build_class_tables(*args)
        assert got.keys() == want.keys()
        for name in ("alpha_hat", "table", "G", "N", "s", "const", "iu"):
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]), name)
        for name in ("tri", "d_re", "n_fix", "ntri", "n_cls"):
            assert got[name] == want[name], name


def test_density_matches_jax_density():
    """full, coord (every coordinate) and lp of the port against JAX's
    DDIFusedDensity on in- and out-of-support states: the statistics
    columns bitwise equal (+, -, * in the same order), lp within 2 ulps
    (float32 log of torch and XLA may differ by an ulp), the same
    rejections; untouched columns come back as the same objects exactly
    where JAX's do."""
    jd, d = _jax_density(), ddi.ddi_density()
    k, theta = _random_states(5, 48)
    mks, jrows, tk, rows = _both(k, theta)

    def same_lp(got, want):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got <= -1e6, want <= -1e6)
        np.testing.assert_array_max_ulp(got, want, maxulp=2)

    jlp, jc = jd.full(mks, jrows)
    lp, c = d.full(tk, rows)
    same_lp(lp, jlp)
    assert len(c) == d.n_cache == len(jc) == 165
    for a, b in zip(c, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for m, (part, jpart) in enumerate(zip(d.parts, (jd._m0, jd._m1))):
        n0 = 0 if m == 0 else d.parts[0].n_cols
        cols = c[n0:n0 + part.n_cols]
        jcols = jc[n0:n0 + part.n_cols]
        same_lp(part.lp(cols, rows), jpart.lp(jcols, jrows))

    rng = np.random.default_rng(6)
    for j in range(16):
        step = (0.05 * rng.standard_normal(48)).astype(np.float32)
        nrows = list(rows)
        nrows[j] = rows[j] + torch.tensor(step)
        njrows = list(jrows)
        njrows[j] = jrows[j] + jnp.asarray(step)
        lp2, c2 = d.coord(j, tk, nrows, rows[j], c)
        jlp2, jc2 = jd.coord(j, mks, njrows, jrows[j], jc)
        active = (j < np.where(k == 0, 16, 10))
        np.testing.assert_array_max_ulp(lp2.numpy()[active],
                                        np.asarray(jlp2)[active], maxulp=2)
        assert [a is b for a, b in zip(c2, c)] \
            == [a is b for a, b in zip(jc2, jc)], j
        for a, b in zip(c2, jc2):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_full_matches_logpost_batch():
    """density.full against the JAX package's sufficient-statistic batched
    path (a matmul form, another summation order): the same rejections,
    within 2e-3 relative elsewhere, as tests/test_ddi_fused.py holds
    JAX's own column form."""
    k, theta = _random_states(5, 48)
    _, _, tk, rows = _both(k, theta)
    ref = np.asarray(jddi.ddi_set(fused=True).logpost_batch(
        jnp.asarray(k), jnp.asarray(theta)))
    got = ddi.ddi_density().full(tk, rows)[0].numpy()
    rejected = ref <= -1e6
    np.testing.assert_array_equal(rejected, got <= -1e6)
    rel = np.abs(got - ref)[~rejected] / np.maximum(1.0,
                                                    np.abs(ref)[~rejected])
    assert rel.max() < 2e-3, rel.max()
    # the model set's stateless column forms are the same function
    torch.testing.assert_close(ddi.ddi_set().logpost_cols(tk, rows),
                               torch.tensor(got), rtol=0, atol=0)


def test_density_coord_identity_skip():
    """Columns a coordinate move does not touch come back as the SAME
    objects: a variance move (15) and a model-0 precision move (12) touch
    nothing, a model-0 alpha move (8) touches model 0's columns only."""
    d = ddi.ddi_density()
    theta = np.tile(INIT0.astype(np.float32), (8, 1))
    _, _, tk, rows = _both(np.zeros(8, np.int32), theta)
    _, cache = d.full(tk, rows)
    n0 = d.parts[0].n_cols
    for j, step, touched0 in ((15, 1.0, False), (12, 0.1, False),
                              (8, 0.1, True)):
        nrows = list(rows)
        nrows[j] = rows[j] + step
        _, c2 = d.coord(j, tk, nrows, rows[j], cache)
        assert any(a is not b for a, b in zip(c2[:n0], cache[:n0])) \
            == touched0, j
        assert all(a is b for a, b in zip(c2[n0:], cache[n0:])), j


def test_jump_blend_is_the_drift():
    """The cause of DDI's carried-logp drift between refreshes, replayed at
    density level with JAX's DDIFusedDensity and the port's.  48 chains of
    the 10-dim model, their coordinates 6-8 where its posterior puts them
    (its precisions, 16-52 in coordinate 8, which the 16-dim model reads as
    alpha), carry the 16-dim model's statistics at ~4.5e9.  They jump into
    the 16-dim model and make one sweep of coordinate moves there, every
    move accepted.  With the jump's blend c + (cn - c) (automix_tpu/
    kernels/fused.py:748) the carried lp ends >= 1e-2 from a fresh
    evaluation; with the jump storing cn, within 1e-3 (|lp| ~ 4.9e3, whose
    float32 ulp is 4.9e-4).  Both densities carry the same statistics bit
    for bit."""
    rng = np.random.default_rng(8)
    S = 48
    t1 = (INIT1 + 0.1 * rng.standard_normal((S, 16))).astype(np.float32)
    t1[:, 6] = rng.uniform(0.05, 0.09, S)
    t1[:, 7] = rng.uniform(-0.2, 0.6, S)
    t1[:, 8] = rng.uniform(16.0, 52.0, S)
    t1[:, 10:] = 0.0
    t0 = (INIT0 + 0.1 * rng.standard_normal((S, 16))).astype(np.float32)
    steps = (0.01 * rng.standard_normal((S, 16))).astype(np.float32)
    steps[:, 15] *= 5.0
    k1, k0 = np.ones(S, np.int32), np.zeros(S, np.int32)

    def replay(density, mask, rows_of, store):
        _, c = density.full(mask(k1), rows_of(t1))
        rows, step = rows_of(t0), rows_of(steps)
        lp, cn = density.full(mask(k0), rows)
        cache = tuple(cn) if store else tuple(
            a + 1.0 * (b - a) for a, b in zip(c, cn))
        for j in range(16):
            prop = list(rows)
            prop[j] = rows[j] + step[j]
            lp, moved = density.coord(j, mask(k0), prop, rows[j], cache)
            cache = tuple(a if b is a else a + 1.0 * (b - a)
                          for a, b in zip(cache, moved))
            rows = prop
        fresh = density.full(mask(k0), rows)[0]
        drift = float(np.abs(np.asarray(lp) - np.asarray(fresh)).max())
        return drift, [np.asarray(x) for x in cache], float(
            np.abs(np.stack([np.asarray(x) for x in c])).max())

    jax_side = (_jax_density(),
                lambda k: [jnp.asarray((k == m).astype(np.float32))
                           for m in range(2)],
                lambda t: [jnp.asarray(t[:, d]) for d in range(16)])
    port_side = (ddi.ddi_density(), lambda k: torch.tensor(k).long(),
                 lambda t: [torch.tensor(t[:, d]) for d in range(16)])
    for store in (False, True):
        (jdrift, jcache, big), (drift, cache, _) = (
            replay(*side, store) for side in (jax_side, port_side))
        for a, b in zip(cache, jcache):
            np.testing.assert_array_equal(a, b)
        assert big > 1e9, big
        if store:
            assert max(drift, jdrift) <= 1e-3, (drift, jdrift)
        else:
            assert min(drift, jdrift) >= 1e-2, (drift, jdrift)


def _proposal(L=2, seed=0):
    """A DDI proposal around the start points (alpha and precision scales
    0.1, variance 5), made from a numpy seed."""
    ms = ddi.ddi_set()
    K, D = 2, 16
    rng = np.random.default_rng(seed)
    init = ms.init_points(randoms.key(0)).numpy()
    dm = np.arange(D)[None] < ms.dims[:, None]
    scale = np.where(np.arange(D) == 15, 5.0, 0.1)[None].repeat(K, 0)
    scale[1, 9] = 5.0
    scale = scale * dm
    mu = (init[:, None] + 0.3 * scale[:, None]
          * rng.standard_normal((K, L, D))) * dm[:, None]
    B = np.where(dm[:, None, :, None] & dm[:, None, None, :],
                 np.eye(D) * scale[:, None, None, :]
                 * rng.uniform(0.8, 1.2, (K, L, 1, D)), np.eye(D))
    logdet = (np.log(np.diagonal(B, axis1=-2, axis2=-1)) * dm[:, None]).sum(-1)
    t = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return Proposal(lam=t(rng.dirichlet(np.ones(L), K)), mu=t(mu), B=t(B),
                    logdetB=t(logdet),
                    nmix=torch.full((K,), L, dtype=torch.int32),
                    sig=t(0.3 * scale))


def test_twin_carries_the_cache():
    """The sweep twin on 64 DDI chains from the start points: after 47
    sweeps from sweep 1 (the last, t = 47, refreshes) the carried logp
    equals a fresh evaluation bit for bit; after 48 (one sweep past the
    refresh, where JAX recorded its drift) it is within 3.4e-3
    (automix_tpu/models/ddi_cols.py:29-32) but not exact."""
    ms = ddi.ddi_set()
    S = 64
    init = ms.init_points(randoms.key(0))
    k = torch.as_tensor(np.random.default_rng(1).integers(0, 2, S),
                        dtype=torch.int32)
    theta = init[k.long()].T.contiguous()
    logp = ms.logpost_cols(k.long(), list(theta))
    args = (k, theta, logp, torch.full((2, S), 0.5), torch.full((S,), 0.1),
            torch.ones(S, dtype=torch.int32))
    tabs = fused.prep_tables(_proposal(), ms.dims)
    kw = dict(seed=3, sweep0=1, adapt=True)
    at = fused.sweep_chunk_ref(ms, *args, tabs, n_sweeps=47, **kw)
    assert torch.equal(at[2], ms.logpost_cols(at[0].long(), list(at[1])))
    past = fused.sweep_chunk_ref(ms, *args, tabs, n_sweeps=48, **kw)
    drift = (past[2] - ms.logpost_cols(past[0].long(),
                                       list(past[1]))).abs().max()
    assert 0.0 < float(drift) <= 3.4e-3, float(drift)
    assert int(past[9][2].sum()) > 0 and (past[0] != k).any()


def test_sampler_runs_on_the_cpu():
    """A tiny DDI run through AMSampler on the CPU: stages 1-3 complete
    and the chains stay finite."""
    am = AMSampler(ddi.ddi_set(), EngineConfig(
        n_chains=32, n_chains_stage1=16, stage1_sweeps=60,
        stage1_target_samples=64, max_mix_comps=3, sweep_chunk=10, seed=2,
        trace_chain0=False), device="cpu")
    am.burn_samples(10)
    stats = am.rjmcmc_samples(20)
    assert stats.ksummary.sum() == 32 * 20
    assert np.isclose(stats.model_probs.sum(), 1.0)
    assert bool(torch.isfinite(am.chains.theta).all()
                and torch.isfinite(am.chains.logp).all())


def test_ddi_never_falls_back(monkeypatch):
    """Without CUDA the default device raises; on the card the DDI set
    takes K1e, the only form at (2, 16), while a cached density the kernels
    do not implement, and DDI's models without their cache, are refused
    before any launch."""
    ms = ddi.ddi_set()
    assert (ms.nmodels, ms.dmax) == _build.CACHED_SHAPE
    fused.check_form(ms)
    other = ModelSet(ms.models, fused_density=type(
        "Cached", (), {"n_cache": 1})())
    with pytest.raises(ValueError, match="no incremental density"):
        fused.check_form(other)
    with pytest.raises(ValueError, match="only its cached"):
        fused.check_form(ModelSet(ms.models))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AMSampler(ms, EngineConfig())
