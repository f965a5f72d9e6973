"""Tumour-count model selection (thesis section 5.5.3, Haigis & Dove).

Counterpart of ``automix_tpu/models/rb9.py``: 66 tumour counts from 4
mouse groups; ten models choosing, per group, Poisson or Negative-Binomial
and shared or distinct rates lambda and over-dispersions kappa, encoded by
per-model index maps (userrb9.c:90-141), with Gamma priors on every
parameter and negative parameters rejected (userrb9.c:79-84).

The family is evaluated in one column form (:func:`family_cols`, the JAX
``_build_batched_cols``) in JAX's operation order: per-group sufficient
statistics (n_g, sum x, sum lgamma(x + 1)) and the distinct counts with
their multiplicities, so that sum_i lgamma(x_i + 1/kappa) is
sum_v c_v pal_gammaln(v + 1/kappa).  Model structure enters as one-hot
mask sums, which equal a select of the chain's own model bit for bit.
Out of support the density is -1e6 (not NEG_INF), as in JAX.  Constants
are folded in float64 on the host and rounded once to float32.

The CUDA kernels evaluate the same formula for the chain's own model only
(``am_density_rb9`` in ``csrc/common.cuh``).  Each model's
:class:`CudaDensity` holds its structure (:func:`model_consts`); the
family's data live in a header that the kernel build generates from
:func:`header` (``am_rb9.h``), so kernel and twin read one source.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from automix_tpu_torch.model import CudaDensity, Model, ModelSet
from automix_tpu_torch.ops.plmath import pal_gammaln

# Density kind of csrc/common.cuh.
KIND_RB9 = 9

# userrb9.c:72-77: counts for the 4 groups, concatenated
X_DATA = np.array([
    121, 169, 112, 199, 80, 121, 194, 140, 131, 199, 262,
    121, 140, 166, 150, 103, 5, 15, 13, 9, 15, 13,
    13, 9, 18, 12, 8, 7, 16, 11, 12, 8, 14,
    12, 20, 12, 8, 11, 10, 10, 10, 7, 8, 7,
    8, 10, 11, 7, 4, 6, 9, 7, 5, 7, 3,
    7, 4, 11, 15, 10, 6, 10, 6, 12, 6, 11], dtype=np.float64)
N_OBS = [16, 17, 15, 18]    # userrb9.c:85-88
GROUPS = np.repeat(np.arange(4), N_OBS)

# hyperparameters (userrb9.c:15)
ALPHA1, ALPHA2, BETA1, BETA2 = 2.0, 1.0, 0.1, 2.0

# per-model structure (userrb9.c:90-141)
N_LAMBDA = [3, 3, 3, 3, 3, 3, 3, 4, 4, 4]
N_KAPPA = [1, 1, 1, 1, 1, 1, 2, 1, 1, 1]

K, G, D = 10, 4, 5
DIMS = [N_LAMBDA[k] + N_KAPPA[k] for k in range(K)]


def pindic(k):
    """Which groups are Negative-Binomial (1) or Poisson (0)
    (userrb9.c:102-114)."""
    p = [1, 0, 0, 1]
    if k in (3, 9):
        p[1] = 1
    if k in (2, 9):
        p[2] = 1
    if k in (0, 4, 7):
        p[3] = 0
    return p


def lambda_map(k):
    """theta index of each group's rate (userrb9.c:116-127)."""
    lam_idx = [0, 1, None, None]
    lam_idx[2] = 1 if (k < 4 or k == 6) else 2
    lam_idx[3] = 2 if k < 7 else 3
    return lam_idx


def kappa_map(k):
    """theta index of each group's over-dispersion (userrb9.c:128-141)."""
    k0 = 3 if k < 7 else 4
    kap_idx = [k0, k0, k0, k0]
    if k == 6:
        kap_idx[3] = 4
    return kap_idx


def prior_const(k) -> float:
    """The Gamma priors' normalizing constants of model k (float64)."""
    ql, qk = N_LAMBDA[k], N_KAPPA[k]
    return (ql * (ALPHA1 * math.log(BETA1) - math.lgamma(ALPHA1))
            + qk * (ALPHA2 * math.log(BETA2) - math.lgamma(ALPHA2)))


@functools.cache
def group_stats():
    """Per group: (n_g, sum x, sum lgamma(x + 1), distinct counts in
    ascending order, their multiplicities), in float64."""
    out = []
    for g in range(G):
        xg = X_DATA[GROUPS == g]
        v, c = np.unique(xg, return_counts=True)
        out.append((float(len(xg)), float(xg.sum()),
                    float(sum(math.lgamma(x + 1.0) for x in xg)),
                    [float(x) for x in v], [float(x) for x in c]))
    return tuple(out)


def _f32(x) -> float:
    return float(np.float32(x))


def family_cols(k, rows):
    """Log-posterior of each chain under its own rb9 model: ``k`` [S]
    model indices, ``rows`` the D coordinate tensors [S].  Unsanitized;
    ``ModelSet.logpost_cols`` clamps it as for every density."""
    f32 = torch.float32
    mks = [(k == m).to(f32) for m in range(K)]

    def msum(kset):
        out = torch.zeros_like(rows[0])
        for m in sorted(kset):
            out = out + mks[m]
        return out

    in_dim = [msum({m for m in range(K) if DIMS[m] > d}) for d in range(D)]
    ok = None
    th = []
    for d in range(D):
        pos = rows[d] > 0.0
        okd = pos | (in_dim[d] == 0.0)
        ok = okd if ok is None else ok & okd
        th.append(torch.where(pos & (in_dim[d] > 0.0), rows[d],
                              torch.ones_like(rows[d])))
    logth = [torch.log(th[d]) for d in range(D)]

    # prior: a and b are 0 beyond each model's dim and th is 1 there
    lp = mks[0] * _f32(prior_const(0))
    for m in range(1, K):
        lp = lp + mks[m] * _f32(prior_const(m))
    for d in range(D):
        a_d = b_d = None
        for m in range(K):
            ql, qk = N_LAMBDA[m], N_KAPPA[m]
            if d < ql + qk:
                ta = mks[m] * (ALPHA1 if d < ql else ALPHA2)
                tb = mks[m] * _f32(BETA1 if d < ql else BETA2)
                a_d = ta if a_d is None else a_d + ta
                b_d = tb if b_d is None else b_d + tb
        lp = lp + (a_d - 1.0 * in_dim[d]) * logth[d] - b_d * th[d]

    for g, (n_g, sx_g, clg_g, vals, cnts) in enumerate(group_stats()):
        lam = llam = None
        for d in range(D):
            kset = {m for m in range(K) if lambda_map(m)[g] == d}
            if kset:
                sel = msum(kset)
                t1, t2 = sel * th[d], sel * logth[d]
                lam = t1 if lam is None else lam + t1
                llam = t2 if llam is None else llam + t2
        base = _f32(sx_g) * llam - _f32(clg_g)
        nb_models = {m for m in range(K) if pindic(m)[g]}
        if len(nb_models) < K:          # some model uses Poisson here
            pois = base - n_g * lam
        if nb_models:
            kap = None
            for d in range(D):
                kset = {m for m in range(K) if kappa_map(m)[g] == d}
                if kset:
                    t = msum(kset) * th[d]
                    kap = t if kap is None else kap + t
            km1 = 1.0 / torch.clamp(kap, min=1e-30)
            nb = (base + n_g * (km1 * torch.log(km1) - pal_gammaln(km1))
                  - (_f32(sx_g) + n_g * km1) * torch.log(lam + km1))
            for v, c in zip(vals, cnts):
                nb = nb + c * pal_gammaln(v + km1)
        if not nb_models:
            lp = lp + pois
        elif len(nb_models) == K:
            lp = lp + nb
        else:
            lp = lp + torch.where(msum(nb_models) > 0.5, nb, pois)
    return torch.where(ok, lp, torch.full_like(lp, -1e6))


def model_consts(k):
    """The CudaDensity constants of model k: ql, qk, the 4 groups' rate
    indices, their dispersion indices, their NB flags and the prior
    constant."""
    return (float(N_LAMBDA[k]), float(N_KAPPA[k]),
            *map(float, lambda_map(k)), *map(float, kappa_map(k)),
            *map(float, pindic(k)), prior_const(k))


def second_kappa_group() -> int:
    """The one group whose over-dispersion may differ from group 0's in a
    model (model 6's group 3, :func:`kappa_map`); in every other group
    each model reads group 0's."""
    groups = {g for k in range(K) for g in range(G)
              if kappa_map(k)[g] != kappa_map(k)[0]}
    if len(groups) != 1:
        raise ValueError(f"rb9: second dispersions in groups {groups}")
    return groups.pop()


# Values a fill of the sweep kernel's kappa table computes at once
# (AM_RB9_FILL_STEP; independent pal_gammaln chains): 2 was faster than 1
# and level with 4 on the H100.
FILL_STEP = 2


def _n_second() -> int:
    """Values of a second-dispersion table: the group's distinct counts,
    padded to a multiple of the fill's step (the padding holds values of
    the next slots, never read)."""
    n = len(group_stats()[second_kappa_group()][3])
    return -(-n // FILL_STEP) * FILL_STEP


def table_layout():
    """The sweep kernel's per-chain table of what depends on kappa alone
    (``am_density_rb9_tab`` in ``csrc/common.cuh``): (the distinct counts
    of all groups in the table's order, per group the table slot of each
    of its distinct counts in ascending order).  The second-dispersion
    group's counts come first, so that a table of its counts alone keeps
    their slots."""
    stats = group_stats()
    g2 = second_kappa_group()
    rest = sorted({v for s in stats for v in s[3]} - set(stats[g2][3]))
    order = list(stats[g2][3]) + rest
    return order, [[order.index(v) for v in s[3]] for s in stats]


def header() -> str:
    """``am_rb9.h``: the family's shape (K, D), which alone compiles the
    density in, and its data as float32 constants for ``am_density_rb9``
    (hyperparameters; per group n, sum x, sum lgamma(x + 1), the offset
    of its distinct counts; the distinct counts and their
    multiplicities), and for the sweep kernel's kappa table
    (:func:`table_layout`): the group that may read a second dispersion,
    the fill's step, the values of a full and of a second-dispersion
    table, the distinct counts in table order, and each group's reads as
    the compile-time X-macro ``AM_RB9_READS`` of (group, slot,
    multiplicity) in the group's ascending order of counts."""
    def arr(name, xs):
        body = ", ".join(repr(_f32(x)) for x in xs)
        return f"static __constant__ float {name}[{len(xs)}] = {{{body}}};\n"

    stats = group_stats()
    vals = [v for s in stats for v in s[3]]
    cnts = [c for s in stats for c in s[4]]
    off, offs = 0, []
    for s in stats:
        offs.append(off)
        off += len(s[3])
    text = ("// Generated by automix_tpu_torch/kernels/_build.py from "
            "automix_tpu_torch/models/rb9.py.\n#pragma once\n"
            f"#define AM_RB9_K {K}\n"
            f"#define AM_RB9_D {D}\n"
            f"#define AM_RB9_G {G}\n"
            f"#define AM_RB9_ALPHA1 {ALPHA1!r}f\n"
            f"#define AM_RB9_ALPHA2 {ALPHA2!r}f\n"
            f"#define AM_RB9_BETA1 {_f32(BETA1)!r}f\n"
            f"#define AM_RB9_BETA2 {_f32(BETA2)!r}f\n")
    text += arr("am_rb9_n", [s[0] for s in stats])
    text += arr("am_rb9_sx", [s[1] for s in stats])
    text += arr("am_rb9_clg", [s[2] for s in stats])
    text += ("static __constant__ int am_rb9_off[%d] = {%s};\n"
             % (G + 1, ", ".join(str(o) for o in offs + [off])))
    text += arr("am_rb9_val", vals)
    text += arr("am_rb9_cnt", cnts)
    order, slots = table_layout()
    reads = " ".join(f"X({g}, {j}, {_f32(c)!r}f)"
                     for g, (s, js) in enumerate(zip(stats, slots))
                     for j, c in zip(js, s[4]))
    text += (f"#define AM_RB9_G2 {second_kappa_group()}\n"
             f"#define AM_RB9_FILL_STEP {FILL_STEP}\n"
             f"#define AM_RB9_NV {len(order)}\n"
             f"#define AM_RB9_NV2 {_n_second()}\n")
    text += arr("am_rb9_tv", order)
    text += f"#define AM_RB9_READS(X) {reads}\n"
    return text


def _model(k: int) -> Model:
    dim = DIMS[k]

    def cols(rows):
        pad = list(rows) + [torch.zeros_like(rows[0])] * (D - len(rows))
        return family_cols(torch.full_like(rows[0], k, dtype=torch.int64),
                           pad)

    # log-normal random inits in the reference (userrb9.c:35-60);
    # deterministic prior-scale points serve the same purpose.
    init = np.empty(dim)
    init[:N_LAMBDA[k]] = 43.87879
    init[N_LAMBDA[k]:] = 2.152937
    return Model(f"rb9_k{k + 1}", dim, cols, init=init,
                 cuda=CudaDensity(KIND_RB9, model_consts(k)))


@functools.cache
def rb9_set() -> ModelSet:
    """The ten rb9 models with the family column form."""
    return ModelSet([_model(k) for k in range(K)],
                    batched_logpost_cols=family_cols)
