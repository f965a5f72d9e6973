"""The change-point family of the port (D5) against the JAX package's
per-theta ``logp`` and the reference C code's pointwise log-posteriors,
and the family through the port's stage 1 and sampler on the CPU."""

import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.config import EngineConfig as JaxConfig
from automix_tpu.kernels import rwm as jrwm
from automix_tpu.models import changepoint as jcp
from automix_tpu_torch import AMSampler, EngineConfig
from automix_tpu_torch.kernels import rwm
from automix_tpu_torch.model import N_DENSITY_CONSTS
from automix_tpu_torch.models import changepoint as cp
from automix_tpu_torch.ops import randoms
from _torch_threads import one_torch_thread  # noqa: F401

_ORACLE = os.path.join(os.path.dirname(__file__), "data",
                       "logp_oracle.json")
_SETS = {"cpt": (jcp.cpt_set, cp.cpt_set, cp.CPT),
         "cptrs": (jcp.cptrs_set, cp.cptrs_set, cp.CPTRS)}


def _states(spec, m, kind, rng, n=256):
    """n float32 states of model m (m + 1 change points): rates at the
    data's scale and change points spread over (0, T) in order
    (``valid``); with a segment that holds no event, two change points in
    one gap between neighbouring events or an end segment before the first
    event or after the last (``empty``); or out of support: a negative
    rate, two change points swapped (model 1: its one point at 0, a
    segment of length 0), the first below 0, the last beyond T."""
    ns = m + 1
    T = spec.t_end
    th = np.empty((n, 2 * ns + 1))
    th[:, :ns + 1] = (len(cp.COAL_DATA) / T) * rng.uniform(0.2, 3.0,
                                                         (n, ns + 1))
    th[:, ns + 1:] = np.sort(rng.uniform(0.0, T, (n, ns)), axis=1)
    if kind == "empty":
        ev = spec.events.astype(np.float64)
        gaps = np.flatnonzero(np.diff(ev) > 2e-3 * T)
        for i in range(n):
            pts = rng.uniform(0.0, T, ns)
            if ns == 1 or rng.random() < 0.3:
                if rng.random() < 0.5:
                    pts[0] = ev[0] * rng.uniform(0.1, 0.9)
                else:
                    pts[0] = ev[-1] + (T - ev[-1]) * rng.uniform(0.1, 0.9)
            else:
                g = rng.choice(gaps)
                pts[:2] = ev[g] + (ev[g + 1] - ev[g]) * np.array([0.25,
                                                                  0.75])
            th[i, ns + 1:] = np.sort(pts)
    elif kind == "negative_rate":
        th[np.arange(n), rng.integers(0, ns + 1, n)] *= -1.0
    elif kind == "unordered":
        if ns == 1:
            th[:, ns + 1] = 0.0
        else:
            th[:, [ns + 1, ns + 2]] = th[:, [ns + 2, ns + 1]]
    elif kind == "below_zero":
        th[:, ns + 1] = -rng.uniform(1e-3, 1.0, n) * T
    elif kind == "beyond_t":
        th[:, -1] = T * (1.0 + rng.uniform(1e-3, 1.0, n))
    return th.astype(np.float32)


@functools.cache
def _jax_logp(name, m):
    """JAX's logp of model m of a set, vmapped over states and jitted once
    for every test of this file."""
    return jax.jit(jax.vmap(_SETS[name][0]().models[m].logp))


def _both(name, m, th):
    """JAX's logp (vmapped) and the port's model column form on ``th``."""
    tset = _SETS[name][1]
    want = np.asarray(_jax_logp(name, m)(jnp.asarray(th)))
    got = tset().models[m].logp_cols(list(torch.from_numpy(th).T))
    return got.numpy(), want


@pytest.mark.parametrize("kind", ["valid", "empty"])
@pytest.mark.parametrize("name", sorted(_SETS))
def test_family_matches_jax_logp(name, kind):
    """All 6 models, 256 seeded states each, in support.  The same
    float32 formula in JAX's order, the segment counts exact; only the
    two libraries' log and the order of JAX's two 7-term reductions
    differ.  So the port is within 8 float32 ulps of the largest term,
    max(|lp|, 191 max |log h|) with h the rates (the likelihood's
    n_j log h_j reach ~1e3 for cpt, and cancel to |lp| ~ 1e2 for cptrs;
    seen: at most 4 ulps).  ``empty``: a segment holds no event, where
    JAX's histogram (and the port's counts) are the exact likelihood."""
    spec = _SETS[name][2]
    rng = np.random.default_rng(7)
    for m in range(cp.K):
        th = _states(spec, m, kind, rng)
        got, want = _both(name, m, th)
        assert (want > spec.reject_value).all()
        scale = np.maximum(np.abs(want), cp.N_EVENTS * np.abs(
            np.log(th[:, :m + 2])).max(axis=1))
        ulp = np.spacing(scale.astype(np.float32))
        assert (np.abs(got - want) <= 8 * ulp).all(), (m, np.max(
            np.abs(got - want) / ulp))


@pytest.mark.parametrize("kind", ["negative_rate", "unordered", "below_zero",
                                  "beyond_t"])
@pytest.mark.parametrize("name", sorted(_SETS))
def test_out_of_support_gives_the_reject_value(name, kind):
    """Each out-of-support kind returns the set's reject value exactly
    (-10000 for cpt, -100000 for cptrs), in JAX and in the port."""
    spec = _SETS[name][2]
    rng = np.random.default_rng(11)
    for m in range(cp.K):
        got, want = _both(name, m, _states(spec, m, kind, rng, 64))
        np.testing.assert_array_equal(want, spec.reject_value)
        np.testing.assert_array_equal(got, spec.reject_value)


@pytest.mark.parametrize("name", sorted(_SETS))
def test_family_matches_the_c_oracle(name):
    """Every entry of ``tests/data/logp_oracle.json`` (states whose
    segments are all non-empty, where the C walk is exact) within 5e-4
    relative, the JAX package's tolerance (tests/test_models_oracle.py)."""
    entries = json.load(open(_ORACLE))[name]
    assert len(entries) >= 10
    ms = _SETS[name][1]()
    k = torch.tensor([e["k"] for e in entries])
    th = np.zeros((len(entries), cp.D), np.float32)
    for i, e in enumerate(entries):
        th[i, :len(e["theta"])] = e["theta"]
    got = ms.logpost_cols(k, list(torch.as_tensor(th).T)).numpy()
    want = np.array([e["lp"] for e in entries])
    rel = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert rel.max() < 5e-4, rel.max()


@pytest.mark.parametrize("name", sorted(_SETS))
def test_models_match_jax_structure(name):
    """Six models of the JAX dims, names and start points; the events as
    JAX makes them (sorted in float64, cptrs' rounded to 2 decimals there,
    then cast); each model's column form equals the family form at its
    index; the CUDA constants fit the slots."""
    jset, tset, spec = _SETS[name]
    jms, ms = jset(), tset()
    assert list(ms.dims) == list(jms.dims) == [3, 5, 7, 9, 11, 13]
    assert [m.name for m in ms.models] == [m.name for m in jms.models]
    np.testing.assert_array_equal(
        ms.init_points(randoms.key(0)).numpy(),
        np.asarray(jms.init_points(None)))
    np.testing.assert_array_equal(cp.COAL_DATA, jcp.COAL_DATA)
    data = (jcp.COAL_DATA if name == "cpt"
            else np.round(jcp.COAL_DATA / 1459.0, 2))
    np.testing.assert_array_equal(
        spec.events, np.asarray(jnp.asarray(np.sort(data), jnp.float32)))
    rng = np.random.default_rng(3)
    th = _states(spec, cp.K - 1, "valid", rng, 128)
    rows = list(torch.from_numpy(th).T)
    for m, model in enumerate(ms.models):
        assert model.cuda.kind == spec.kind
        assert len(model.cuda.consts) <= N_DENSITY_CONSTS
        assert model.cuda.consts[0] == m + 1
        own = model.logp_cols(rows[:model.dim])
        fam = ms.logpost_cols(torch.full((128,), m), rows)
        assert torch.equal(own, fam)


def test_header_holds_both_event_sets():
    """The generated am_cpt.h holds the family's shape and the 191 events
    of cpt then cptrs, each the float32 value of the twin's events."""
    text = cp.header()
    assert "#define AM_CPT_K 6" in text and "#define AM_CPT_D 13" in text
    assert f"#define AM_CPT_N {cp.N_EVENTS}" in text
    body = re.search(r"am_cpt_events\[(\d+)\] = \{(.*)\};", text)
    assert int(body.group(1)) == 2 * cp.N_EVENTS == 382
    vals = np.array([float(v) for v in body.group(2).split(",")],
                    np.float32)
    np.testing.assert_array_equal(
        vals, np.concatenate([cp.CPT.events, cp.CPTRS.events]))


def _header_events():
    """Each set's events as the generated am_cpt.h hands them to the
    kernels, parsed back into float32."""
    text = cp.header()
    n = int(re.search(r"#define AM_CPT_N (\d+)", text).group(1))
    body = re.search(r"am_cpt_events\[\d+\] = \{(.*)\};", text).group(1)
    vals = np.array([float(v) for v in body.split(",")], np.float32)
    return {"cpt": vals[:n], "cptrs": vals[n:]}


def _count_le(ev, s):
    """The kernel's fixed-step search (``am_density_cpt`` in
    csrc/changepoint.cuh) in numpy: the number of events <= each s, and
    the number of steps.  Every read lies inside the events (numpy raises
    on an index past the end; no index is below 0)."""
    n = len(ev)
    p = 1 << (n.bit_length() - 1)
    g = np.where(ev[n - p] <= s, n - p + 1, 0)
    steps, step = 1, p // 2
    while step:
        g = g + np.where(ev[g + step - 1] <= s, step, 0)
        steps, step = steps + 1, step // 2
    return g, steps


def _around(x):
    """x and its float32 neighbours on both sides."""
    x = np.asarray(x, np.float32)
    return np.concatenate([x, np.nextafter(x, np.float32(-np.inf)),
                           np.nextafter(x, np.float32(np.inf))])


@pytest.mark.parametrize("name", sorted(_SETS))
def test_header_events_are_sorted_and_finite(name):
    """The search's precondition: each set's 191 events in am_cpt.h are
    finite and in order (ties allowed: cpt has 9106 twice)."""
    ev = _header_events()[name]
    assert len(ev) == cp.N_EVENTS
    assert np.isfinite(ev).all()
    assert (np.diff(ev) >= 0).all()


@pytest.mark.parametrize("name", sorted(_SETS))
def test_segment_count_search_matches_searchsorted(name):
    """At every event and its float32 neighbours, at 0 and T and their
    neighbours, and outside (0, T), the kernel's search counts in 8 steps
    what the twin's ``torch.searchsorted(..., right=True)`` and numpy's
    ``searchsorted(side="right")`` count."""
    ev = _header_events()[name]
    t_end = _SETS[name][2].t_end
    s = np.concatenate([_around(ev), _around([0.0, t_end]),
                        np.float32([-1.0, 2.0 * t_end])])
    g, steps = _count_le(ev, s)
    assert steps == 8
    np.testing.assert_array_equal(g, np.searchsorted(ev, s, side="right"))
    np.testing.assert_array_equal(g, torch.searchsorted(
        torch.from_numpy(ev), torch.from_numpy(s), right=True).numpy())


def test_segment_count_search_at_every_size():
    """The same search over n = 1..300 sorted float32 values with ties
    counts the values <= every value and its neighbours, in
    1 + floor(log2 n) steps."""
    rng = np.random.default_rng(0)
    for n in range(1, 301):
        ev = np.sort(rng.integers(0, n, n)).astype(np.float32)
        s = _around(np.concatenate([ev, [-1.0, n + 1.0]]))
        g, steps = _count_le(ev, s)
        assert steps == n.bit_length(), n
        np.testing.assert_array_equal(g, np.searchsorted(ev, s,
                                                         side="right"))


def test_stage1_log_rule_moves_sig_to_the_rates_scale():
    """The log rule's twin on cpt, 6 x 64 chains, 150 sweeps (+15 burn-in)
    from sig = 10: every model's rate scales come down below 0.02, to the
    data's rate scale (191 / 40907 ~ 4.7e-3), while the additive AAP rule
    leaves each model a rate scale 10 times larger than the log rule's
    largest (tests/test_stage1.py:60-90).  JAX's own stage 1 with the log
    rule (its XLA engine, another random stream) on the same set lands on
    the same rate scales within a factor of 2 (seen: 0.84-1.19)."""
    ms = cp.cpt_set()
    sig = {}
    for rule in ("log", "aap"):
        cfg = EngineConfig(seed=2, n_chains_stage1=64, stage1_adapt=rule)
        sig[rule] = rwm.run_stage1(ms, cfg, randoms.key(0), 150,
                                   "cpu")[0].numpy()
    jsig = np.asarray(jrwm.run_stage1(
        jcp.cpt_set(), JaxConfig(seed=2, n_chains_stage1=64,
                                 stage1_adapt="log"),
        jax.random.PRNGKey(2), 150)[0])
    for m in range(cp.K):
        rates = slice(0, m + 2)
        assert (sig["log"][m, rates] < 0.02).all(), sig["log"][m]
        assert sig["aap"][m, rates].max() > 10 * sig["log"][m, rates].max()
        ratio = sig["log"][m, rates] / jsig[m, rates]
        assert ((ratio > 0.5) & (ratio < 2.0)).all(), (m, ratio)


def test_sampler_runs_on_the_cpu():
    """A tiny cptrs run through AMSampler on the CPU at JAX's change-point
    settings (log stage-1 rule, pooled pk): stages 1-3 complete, the
    chains stay finite and in support, and every model is visited."""
    am = AMSampler(cp.cptrs_set(), EngineConfig(
        n_chains=64, n_chains_stage1=16, stage1_sweeps=60,
        stage1_target_samples=64, max_mix_comps=2, sweep_chunk=20, seed=4,
        pk_mode="pooled", stage1_adapt="log", trace_chain0=False),
        device="cpu")
    am.burn_samples(20)
    stats = am.rjmcmc_samples(40)
    assert stats.ksummary.sum() == 64 * 40
    assert np.isclose(stats.model_probs.sum(), 1.0)
    assert bool(torch.isfinite(am.chains.theta).all())
    assert bool((am.chains.logp > cp.CPTRS.reject_value).all())


def test_sweep_tables_bound_at_the_changepoint_shape():
    """check_tables refuses an L outside 1..kLMax before it asks the
    sweep kernel's launcher for its shared-memory bound (here, with no
    card, before the library would be built).  The bound itself, L <= 27
    at (6, 13) on the H100, is the launcher's own count of the kernel's
    tables and static arrays, held on the card by
    tests/test_torch_cuda.py."""
    from automix_tpu_torch.kernels import fused
    for L in (0, fused._MAX_L + 1):
        with pytest.raises(ValueError, match="outside"):
            fused.check_tables(6, 13, L, "cpu")
