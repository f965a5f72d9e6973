"""The stage-3 sweep kernel's rb9 kappa tables (``am_density_rb9_tab`` in
``automix_tpu_torch/csrc/common.cuh``) as a float32 torch model, held bit
for bit to the family column form ``models/rb9.py family_cols``.

A chain keeps, per over-dispersion kappa, a table of what depends on
kappa alone: its key (kappa's bits after the positivity substitution),
km1 = 1 / max(kappa, 1e-30), km1 log km1 - pal_gammaln(km1) and
pal_gammaln(v + km1) for the distinct counts v of all four groups in the
header's order (``table_layout``).  Two full tables serve the kappa that
every group but ``second_kappa_group()`` reads, two short ones the second
kappa of model 6; a lookup compares keys by bits, and a miss fills the
table that does not hold the current state's kappa.  The model below
follows that design.  It computes every fill for all chains and stores it
for the chains that missed, as a warp fills for its lanes: torch's CPU
``log`` takes a vectorized path inside a tensor and a scalar one at its
tail, which may differ by an ulp, so a value must come from the same
position of a tensor of the same length as in ``family_cols``.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automix_tpu.kernels.fused import make_logpost_cols
from automix_tpu.models import rb9 as jrb9
from automix_tpu_torch.models import rb9
from automix_tpu_torch.ops.plmath import pal_gammaln
from _torch_threads import one_torch_thread  # noqa: F401

K, D, G = rb9.K, rb9.D, rb9.G
HEADER = rb9.header()
NV = int(re.search(r"#define AM_RB9_NV (\d+)", HEADER).group(1))
NV2 = int(re.search(r"#define AM_RB9_NV2 (\d+)", HEADER).group(1))
G2 = int(re.search(r"#define AM_RB9_G2 (\d+)", HEADER).group(1))
STEP = int(re.search(r"#define AM_RB9_FILL_STEP (\d+)", HEADER).group(1))
ORDER = [float(v) for v in re.search(
    r"am_rb9_tv\[\d+\] = \{([^}]*)\}", HEADER).group(1).split(",")]
READS = [(int(g), int(s), float(c)) for g, s, c in re.findall(
    r"X\((\d+), (\d+), ([\d.]+)f\)",
    re.search(r"#define AM_RB9_READS\(X\) (.*)", HEADER).group(1))]
TA, TB = 3 + NV, 3 + NV2
BASES = (0, TA, 2 * TA, 2 * TA + TB)       # A0, A1, B0, B1
KA = torch.tensor([rb9.kappa_map(m)[0] for m in range(K)])
KB = torch.tensor([rb9.kappa_map(m)[G2] for m in range(K)])
DIMS = torch.tensor(rb9.DIMS)
QL = torch.tensor(rb9.N_LAMBDA)
LMAP = torch.tensor([rb9.lambda_map(m) for m in range(K)])
NB = torch.tensor([rb9.pindic(m) for m in range(K)], dtype=torch.bool)
PRIOR = torch.tensor([rb9.prior_const(m) for m in range(K)],
                     dtype=torch.float32)
_ORACLE = os.path.join(os.path.dirname(__file__), "data",
                       "heavy_oracle.json")


def bits(x):
    return x.view(torch.int32)


def same_bits(a, b):
    return (bits(a) == bits(b)) | (torch.isnan(a) & torch.isnan(b))


def kappa_keys(k, rows):
    """The two kappas of each chain's model at ``rows``, after the
    positivity substitution (``am_rb9_keys``)."""
    th = torch.stack([torch.where(r > 0.0, r, torch.ones_like(r))
                      for r in rows])
    return th.gather(0, KA[k][None])[0], th.gather(0, KB[k][None])[0]


class KappaTables:
    """The kappa tables of S chains: the kernel's thread columns as the
    rows of a float32 [S, 2 TA + 2 TB] tensor, every key NaN at the start
    (a launch's start).  ``log`` keeps, per evaluation, the chains that
    evaluated in support and those that missed each kind of table."""

    def __init__(self, S):
        self.col = torch.zeros(S, 2 * TA + 2 * TB)
        for b in BASES:
            self.col[:, b] = float("nan")
        self.log = []

    def _pick(self, b0, b1, key, cur):
        k0, k1 = bits(self.col[:, b0]), bits(self.col[:, b1])
        key, cur = bits(key), bits(cur)
        miss = (k0 != key) & (k1 != key)
        base = torch.where(k0 == key, b0, torch.where(
            k1 == key, b1, torch.where(k0 == cur, b1, b0)))
        return base, miss

    def _fill(self, base, kap, n, miss):
        km1 = 1.0 / torch.clamp(kap, min=1e-30)
        vals = [kap, km1, km1 * torch.log(km1) - pal_gammaln(km1)]
        vals += [pal_gammaln(v + km1) for v in ORDER[:n]]
        rows = miss.nonzero()[:, 0]
        for j, v in enumerate(vals):
            self.col[rows, base[rows] + j] = v[rows]

    def density(self, k, rows, cur_k, cur_rows, active=None):
        """rb9's unsanitized log-posterior of each chain's model ``k`` at
        ``rows`` (D tensors [S]), a candidate of the current state
        (``cur_k``, ``cur_rows``), through the tables; ``active`` the
        chains that evaluate (all by default)."""
        S = k.shape[0]
        active = torch.ones(S, dtype=torch.bool) if active is None else active
        dim = DIMS[k]
        ok = torch.ones(S, dtype=torch.bool)
        ths, lth = [], []
        for i in range(D):
            inside = dim > i
            pos = rows[i] > 0.0
            ok = ok & (pos | ~inside)
            t = torch.where(pos & inside, rows[i], torch.ones_like(rows[i]))
            ths.append(t)
            lth.append(torch.log(t))
        lp = PRIOR[k]
        for i in range(D):
            inside = dim > i
            a = torch.where(QL[k] > i, rb9.ALPHA1, rb9.ALPHA2)
            b = torch.where(QL[k] > i, rb9._f32(rb9.BETA1), rb9.BETA2)
            lp = torch.where(inside, lp + (a - 1.0) * lth[i], lp)
            lp = torch.where(inside, lp - b * ths[i], lp)

        live = ok & active
        ka, kb = kappa_keys(k, rows)
        ca, cb = kappa_keys(cur_k, cur_rows)
        two = KB[k] != KA[k]
        base_a, ma = self._pick(BASES[0], BASES[1], ka, ca)
        base_b, mb = self._pick(BASES[2], BASES[3], kb, cb)
        ma, mb = ma & live, mb & live & two
        self._fill(base_a, ka, NV, ma)
        self._fill(base_b, kb, NV2, mb)
        self.log.append((live, ma, mb))

        ths_t, lth_t = torch.stack(ths), torch.stack(lth)
        for g, (n, sx, clg, _, _) in enumerate(rb9.group_stats()):
            base_t = torch.where(two, base_b, base_a) if g == G2 else base_a
            read = lambda j: self.col.gather(  # noqa: E731
                1, (base_t + j)[:, None])[:, 0]
            lam = ths_t.gather(0, LMAP[k, g][None])[0]
            llam = lth_t.gather(0, LMAP[k, g][None])[0]
            base = rb9._f32(sx) * llam - rb9._f32(clg)
            km1 = read(1)
            nb = base + n * read(2)
            nb = nb - (rb9._f32(sx) + n * km1) * torch.log(lam + km1)
            for gg, slot, cnt in READS:
                if gg == g:
                    nb = nb + cnt * read(3 + slot)
            lp = lp + torch.where(NB[k, g], nb, base - n * lam)
        return torch.where(ok, lp, torch.full_like(lp, -1e6))


def family(k, rows):
    return rb9.family_cols(k, rows)


def _points():
    """Per model a point near the posterior: each rate at the mean of the
    counts of the groups it serves, each dispersion 0.1."""
    means = [np.mean(rb9.X_DATA[rb9.GROUPS == g]) for g in range(G)]
    point = np.zeros((K, D), np.float32)
    for m in range(K):
        for d in range(rb9.N_LAMBDA[m]):
            point[m, d] = np.mean([means[g] for g in range(G)
                                   if rb9.lambda_map(m)[g] == d])
        for d in set(rb9.kappa_map(m)):
            point[m, d] = 0.1
    return point


def _edge_states(seed, per_model=96):
    """States of every model: around the point, and with a dispersion or a
    rate <= 0, a dispersion at and near the 1e-30 clamp, NaN."""
    rng = np.random.default_rng(seed)
    point = _points()
    k = np.repeat(np.arange(K), per_model)
    th = point[k] * rng.uniform(0.5, 1.5, (len(k), D)).astype(np.float32)
    th[:, 3:] = np.where(point[k, 3:] == 0.1, rng.uniform(
        0.01, 2.0, (len(k), 2)), th[:, 3:])
    for m in range(K):
        r = np.arange(m * per_model, (m + 1) * per_model)
        kd = rb9.kappa_map(m)[0]
        th[r[0:4], kd] = [0.0, -0.5, -1e-30, -3.0]
        th[r[4:8], 0] = [0.0, -2.0, -1e-20, -50.0]
        th[r[8:16], kd] = [1e-30, 1.5e-30, 1e-31, 1e-25, 1e-12, 1e-8,
                           1e-6, 1e-4]
        th[r[16], kd] = np.nan
        th[r[17], 1] = np.nan
        th[r[18], kd] = np.inf
        if m == 6:
            th[r[19:23], 4] = [0.0, -1.0, 1e-30, 1e-8]
    return torch.as_tensor(k), torch.as_tensor(th.astype(np.float32))


def test_header_counts_and_slots_match_group_stats():
    """The header's compile-time layout: the table holds every distinct
    count of the four groups once, the second-dispersion group's first and
    in ascending order (so a short table of AM_RB9_NV2 values, padded to a
    multiple of the fill's step and no further, keeps their slots); each
    group reads its own distinct counts in ascending order with their
    multiplicities; and only that group ever reads a dispersion other than
    group 0's."""
    stats = rb9.group_stats()
    assert sorted(ORDER) == sorted({v for s in stats for v in s[3]})
    assert len(ORDER) == NV == 28
    n2 = len(stats[G2][3])
    assert ORDER[:n2] == stats[G2][3] and n2 <= NV2 < n2 + STEP
    assert STEP == rb9.FILL_STEP and NV2 % STEP == 0 and NV % STEP == 0
    for g, s in enumerate(stats):
        reads = [(slot, c) for gg, slot, c in READS if gg == g]
        assert [ORDER[slot] for slot, _ in reads] == s[3]
        assert [c for _, c in reads] == s[4]
    assert [slot for gg, slot, _ in READS if gg == G2] == list(range(n2))
    assert len(READS) == sum(len(s[3]) for s in stats) == 39
    assert G2 == 3 and rb9.table_layout() == (ORDER, [
        [slot for gg, slot, _ in READS if gg == g] for g in range(G)])
    for m in range(K):
        kap = rb9.kappa_map(m)
        assert all(kap[g] == kap[0] for g in range(G) if g != G2)
    assert [m for m in range(K) if KA[m] != KB[m]] == [6]


@pytest.mark.parametrize("seed", [0, 1])
def test_tables_match_family_cols_on_every_model(seed):
    """Every model on random states, out of support (a rate or a
    dispersion <= 0), at and near the 1e-30 clamp, NaN and inf: from
    empty tables the state (misses), the same state again (hits), a rate
    move (hits) and a dispersion move (misses; for model 6 also its
    second dispersion) each equal ``family_cols`` bit for bit."""
    k, th = _edge_states(seed)
    rows = list(th.T)
    tabs = KappaTables(len(k))
    steps = [rows, rows,
             [rows[0] * 1.01] + rows[1:],
             [r * 1.25 if d in (3, 4) else r for d, r in enumerate(rows)]]
    cur = rows
    for i, x in enumerate(steps):
        got = tabs.density(k, x, k, cur)
        assert bool(same_bits(got, family(k, x)).all()), i
        cur = x
    live, ma, mb = zip(*tabs.log)
    assert bool(ma[0][live[0]].all())              # empty: every lane misses
    assert not bool(ma[1].any() | mb[1].any())     # the same key: hits
    assert not bool(ma[2].any() | mb[2].any())     # a rate: hits
    # a dispersion move misses wherever the key moved (not at inf)
    (ka0, kb0), (ka1, kb1) = kappa_keys(k, rows), kappa_keys(k, steps[3])
    moved_a = bits(ka0) != bits(ka1)
    moved_b = (bits(kb0) != bits(kb1)) & (k == 6)
    assert torch.equal(ma[3], live[3] & moved_a)
    assert torch.equal(mb[3], live[3] & moved_b)
    assert int((live[3] & moved_a).sum()) >= 80 * K
    assert int((live[3] & moved_b).sum()) >= 80
    assert int((~live[0]).sum()) >= 10 * K         # out of support: -1e6
    nan = torch.isnan(family(k, rows))
    assert nan.sum() >= 2 * K                      # the clamp's overflow


def test_one_ulp_blends_are_caught_by_the_key():
    """Dispersion moves accepted with the blend th + 1 (prop - th), which
    here differs from prop by one ulp: the candidate's table holds prop's
    key, so the next rate move of the blended state misses and fills
    instead of reading prop's values (which differ), and equals
    ``family_cols`` bit for bit.  A rejected move keeps the current
    state's table: the next rate move hits it."""
    rng = np.random.default_rng(3)
    S = 4096
    k = torch.as_tensor(rng.integers(0, K, S))
    point = _points()
    th = torch.as_tensor(point[k.numpy()] * rng.uniform(
        0.8, 1.2, (S, D)).astype(np.float32))
    kd = KA[k]
    old = th.gather(1, kd[:, None])[:, 0]
    prop_k = (old * torch.as_tensor(rng.uniform(2.5, 9.0, S),
                                    dtype=torch.float32))
    blend = old + 1.0 * (prop_k - old)
    off = (bits(blend) - bits(prop_k)).abs() == 1
    assert int(off.sum()) > 100, int(off.sum())
    rows = list(th.T)
    prop = [torch.where(kd == d, prop_k, r) for d, r in enumerate(rows)]
    acc = off | (torch.as_tensor(rng.uniform(size=S)) < 0.5)
    new = [torch.where(acc & (kd == d), old + 1.0 * (prop_k - old), r)
           for d, r in enumerate(rows)]
    tabs = KappaTables(S)
    assert bool(same_bits(tabs.density(k, rows, k, rows),
                          family(k, rows)).all())
    assert bool(same_bits(tabs.density(k, prop, k, rows),
                          family(k, prop)).all())
    lam = [new[0] * 1.001] + new[1:]
    skip = KappaTables(S)
    skip.col = tabs.col.clone()
    got = tabs.density(k, lam, k, new)
    assert bool(same_bits(got, family(k, lam)).all())
    _, ma, _ = tabs.log[-1]
    assert bool(ma[acc & off].all())               # the blend's key: a miss
    assert not bool(ma[~acc].any())                # rejected: a hit
    # taking the accepted candidate's table without comparing keys (its
    # key overwritten with the blend's) reads prop's values: another
    # density
    held = (bits(skip.col[:, BASES[1]]) == bits(prop_k)) & acc & off
    skip.col[held, BASES[1]] = blend[held]
    wrong = skip.density(k, lam, k, new)
    assert bool(held.any())
    assert bool((~same_bits(wrong, got))[held].any())


def _estimate(p):
    """The design estimate of the table's reads per sweep under p(M):
    per lane, coordinate moves (9 sweeps in 10) of a rate hit, of a
    dispersion miss, and a block move and the jump miss; per warp of 32
    lanes, coordinate 3 fills where any lane's model has its dispersion
    there (models 0-6), coordinate 4 where any lane has dimension 5
    (models 6-9, a dispersion there), the block move and the jump always.
    Returns (lane hit share, warp fill sites per sweep)."""
    hits = np.array([3, 3, 3, 3, 3, 3, 3, 4, 4, 4])
    dims = np.array(rb9.DIMS)
    lane = float(p @ (0.9 * hits)) / float(p @ (0.9 * dims + 1.1))
    any_ = lambda ms: 1.0 - (1.0 - p[ms].sum()) ** 32  # noqa: E731
    warp = 0.9 * (any_(list(range(7))) + any_([6, 7, 8, 9])) + 1.1
    return lane, warp


def test_hit_share_on_an_rb9_state_matches_the_estimate():
    """2048 chains, models drawn from the C oracle's p(M), 40 sweeps of
    componentwise moves (a block move every 10th sweep) accepted by the
    Metropolis rule and a jump to a model drawn from p(M) accepted with
    probability 0.64 (rb9's share of chain-sweeps that change model):
    every evaluation through the tables equals ``family_cols`` bit for
    bit, and the share of lane evaluations that hit is the estimate's
    within 0.02.  A warp of 32 chains fills at the estimate's evaluations
    and, beyond it, at the first rate move after a sweep in which one of
    its chains accepted a jump whose blend th + (thn - th) left a kappa
    other than the destination's (the jump's table then holds thn's key):
    within 0.1 of that count per sweep.  The pal_gammaln a warp runs per
    sweep fall more than 1.5 times against the group loops the kernel ran
    before the tables."""
    rng = np.random.default_rng(11)
    p = np.asarray(json.load(open(_ORACLE))["rb9"]["mean"])
    p = p / p.sum()
    S, W, n_sweeps = 2048, 32, 40
    point = _points()
    scale = np.where(point == 0.1, 0.02, 0.05 * point).astype(np.float32)

    def draw(m):
        return point[m] + scale[m] * rng.standard_normal(
            (len(m), D)).astype(np.float32)

    k = torch.as_tensor(rng.choice(K, S, p=p))
    rows = list(torch.as_tensor(draw(k.numpy())).T)
    lp = family(k, rows)
    tabs = KappaTables(S)
    old_gammaln = 0.0
    blend_sites = 0
    groups = rb9.group_stats()

    def evaluate(kn, x, active=None):
        nonlocal old_gammaln
        got = tabs.density(kn, x, k, rows, active)
        live = torch.ones_like(kn, dtype=torch.bool) if active is None \
            else active
        assert bool(same_bits(got, family(kn, x))[live].all())
        live = tabs.log[-1][0].reshape(-1, W)
        nbk = NB[kn].reshape(-1, W, G)
        for g, s in enumerate(groups):
            old_gammaln += float(((nbk[..., g] & live).any(1)).sum()) \
                * (len(s[3]) + 1)
        return got

    for t in range(n_sweeps):
        sig = torch.as_tensor(scale[k.numpy()])
        if t % 10 == 0:
            z = torch.as_tensor(rng.standard_normal((S, D)), dtype=torch.float32)
            prop = [torch.where(DIMS[k] > d, rows[d] + sig[:, d] * z[:, d],
                                rows[d]) for d in range(D)]
            lpn = evaluate(k, prop)
            acc = (torch.as_tensor(rng.uniform(size=S), dtype=torch.float32)
                   < torch.exp(torch.clamp(lpn - lp, max=0.0))).float()
            rows = [r + acc * (q - r) for r, q in zip(rows, prop)]
            lp = lp + acc * (lpn - lp)
        else:
            for j in range(D):
                active = DIMS[k] > j
                prop = list(rows)
                prop[j] = rows[j] + sig[:, j] * torch.as_tensor(
                    rng.standard_normal(S), dtype=torch.float32)
                lpn = evaluate(k, prop, active)
                acc = ((torch.as_tensor(rng.uniform(size=S),
                                        dtype=torch.float32)
                        < torch.exp(torch.clamp(lpn - lp, max=0.0)))
                       & active).float()
                rows[j] = rows[j] + acc * (prop[j] - rows[j])
                lp = lp + acc * (lpn - lp)
        kn = torch.as_tensor(rng.choice(K, S, p=p))
        thn = list(torch.as_tensor(draw(kn.numpy())).T)
        lpn = evaluate(kn, thn)
        acc = torch.as_tensor(rng.uniform(size=S) < 0.64)
        k = torch.where(acc, kn, k)
        rows = [r + acc.float() * (q - r) for r, q in zip(rows, thn)]
        lp = torch.where(acc, lpn, lp)
        inexact = acc & torch.stack([bits(a) != bits(b) for a, b in zip(
            kappa_keys(k, rows), kappa_keys(kn, thn))]).any(0)
        if t + 1 < n_sweeps and (t + 1) % 10:
            blend_sites += int(inexact.reshape(-1, W).any(1).sum())

    evals = sum(int(live.sum()) for live, _, _ in tabs.log)
    hits = evals - sum(int((ma | mb).sum()) for _, ma, mb in tabs.log)
    sites = new_gammaln = 0
    for live, ma, mb in tabs.log:
        a, b = ma.reshape(-1, W).any(1), mb.reshape(-1, W).any(1)
        both = (ma & mb).reshape(-1, W).any(1)
        sites += int((a | b).sum())
        new_gammaln += float((a * (NV + 1) + (~a & b) * (NV2 + 1)
                              + both * (NV2 + 1)).sum())
    warps = S // W
    lane_est, warp_est = _estimate(p)
    share, per_sweep = hits / evals, sites / (warps * n_sweeps)
    blends = blend_sites / (warps * n_sweeps)
    old, new = old_gammaln / (warps * n_sweeps), new_gammaln / (
        warps * n_sweeps)
    print(f"lane hit share {share:.4f} (estimate {lane_est:.4f}); warp "
          f"fill sites per sweep {per_sweep:.3f} (estimate {warp_est:.3f} "
          f"+ {blends:.3f} after inexact jump blends); pal_gammaln per "
          f"warp-sweep {old:.1f} -> {new:.1f}")
    assert abs(share - lane_est) < 0.02
    assert abs(per_sweep - (warp_est + blends)) < 0.1
    assert old / new > 1.5


@pytest.mark.parametrize("seed", [0, 1])
def test_family_cols_match_jax_at_the_edges(seed):
    """``family_cols`` (through ``logpost_cols``, sanitized) against the
    JAX package's rb9 column form on the edge states, with
    ``tests/test_torch_rb9.py``'s bound: 1e-5 relative to the largest of
    1, |lp| and the NB terms' scale 16 / kappa log(1 / kappa); out of
    support and at the clamp's overflow both give the same value."""
    k, th = _edge_states(seed)
    kn, thn = k.numpy(), th.numpy()
    mks = [jnp.asarray((kn == m).astype(np.float32)) for m in range(K)]
    want = np.asarray(make_logpost_cols(jrb9.rb9_set())(
        mks, [jnp.asarray(c) for c in thn.T]), np.float64)
    got = rb9.rb9_set().logpost_cols(k, list(th.T)).numpy().astype(
        np.float64)
    edge = (want == -1e6) | (np.abs(want) >= 1e30)
    assert edge.sum() >= 12 * K
    np.testing.assert_array_equal(got[edge], want[edge])
    kap = np.where(np.isfinite(thn[:, 3:]), thn[:, 3:], 1.0)
    km1 = 1.0 / np.clip(np.abs(kap).min(axis=1), 1e-30, None)
    scale = np.maximum.reduce([np.ones_like(want), np.abs(want),
                               16.0 * km1 * np.abs(np.log(km1))])
    assert (np.abs(got - want)[~edge] / scale[~edge]).max() < 1e-5


def _chip_smoke():
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("m", range(K))
def test_bound_counts_kappa_terms_only_where_kappa_can_change(m):
    """``chip_smoke.py``'s operations of rb9 evaluations, per model: with
    ``full`` every term of every evaluation (``model_ops``); otherwise the
    terms of each kappa alone apart, counted ``n_kappa`` times, with km1,
    the bracket and each distinct count's pal_gammaln once per kappa.
    Split, one evaluation with its kappa terms counts what the full count
    does less what groups reading one kappa share."""
    cs = _chip_smoke()
    ops = cs.OPS
    ms = rb9.rb9_set()
    p = [float(i == m) for i in range(K)]
    full = cs.model_ops(ms.models[m])
    assert cs.evals_ops(ms, p, 3.0, 2.0, full=True) == 3.0 * full
    each = cs.evals_ops(ms, p, 1.0, 0.0)
    kappa = cs.evals_ops(ms, p, 0.0, 1.0)
    assert cs.evals_ops(ms, p, 3.0, 2.0) == 3.0 * each + 2.0 * kappa
    stats = rb9.group_stats()
    nb = [g for g in range(G) if rb9.pindic(m)[g]]
    by_kappa = {}
    for g in nb:
        by_kappa.setdefault(rb9.kappa_map(m)[g], []).append(g)
    shared = sum(
        (len(gs) - 1) * (ops["div"] + ops["log"] + ops["gammaln"] + 2)
        + (sum(len(stats[g][3]) for g in gs)
           - len({v for g in gs for v in stats[g][3]}))
        * (ops["gammaln"] + 1) for gs in by_kappa.values())
    assert each + kappa == full - shared
    assert kappa > 0 and (shared > 0) == any(
        len(gs) > 1 for gs in by_kappa.values())


def test_bound_counts_other_densities_in_full():
    """Outside rb9 the split changes nothing: the tutorial's evaluations
    count the same with and without ``full``."""
    from automix_tpu_torch.models.tutorial import tutorial_set
    cs = _chip_smoke()
    ms = tutorial_set()
    p = [0.5, 0.2, 0.3]
    assert cs.evals_ops(ms, p, 2.5, 2.0) == cs.evals_ops(
        ms, p, 2.5, 2.0, full=True) == 2.5 * cs.density_ops(ms, p)
    assert cs.sweep_ops(ms, 8, p) == cs.sweep_ops(ms, 8, p, full=True)
