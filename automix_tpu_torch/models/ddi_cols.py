"""DDI column-form density with an incremental statistics cache.

Counterpart of ``automix_tpu/models/ddi_cols.py`` (``_ModelPart``,
``DDIFusedDensity``).  The per-class statistics (q0_c, H_c) of
``models/ddi_stats.py`` depend on the fixed effects alpha only, so a chain
carries them as a cache of 105 (model 0: 15 classes x (1 + 6)) plus 60
(model 1: 15 x (1 + 3)) float32 columns:

- ``full`` computes both models' statistics from scratch;
- ``coord`` updates them after a move of ONE coordinate j: only the
  quadratic features containing j and the linear feature j contribute,
  and columns that none of them touches come back as the SAME tensor
  objects (the sweep skips their accept-blends);
- ``lp`` is the log-posterior of one model from its statistics and the
  precision / variance coordinates (the Woodbury recombination per class,
  the priors of userddi.c:471-531).

Every column sums in JAX's order: ``const + 0 * rows[0]``, then the
nonzero quadratic features in feature order, then the nonzero linear
ones; ``coord`` adds the touched features in ``quad_pairs`` order, then
the linear row.  The arithmetic runs over all columns at once with a
zero-coefficient term masked to +0, which adds nothing.  Every constant
is a float32 value folded on the host in float64 exactly where the JAX
expression folds it, so these functions, the JAX ones and the CUDA
kernels (``csrc/ddi.cuh``, fed by :func:`header`) evaluate the same
float32 operations.

The protocol of the sweep (``model.make_density``): ``n_cache``,
``full(k, rows) -> (lp, cache)`` and ``coord(j, k, rows, old_j, cache)
-> (lp, cache)`` with ``k`` the chains' model indices (the JAX functions
take one-hot masks; with finite sanitized densities the mask sum equals
this select bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln as np_gammaln

from automix_tpu_torch.config import NEG_INF

# Hyperparameters (userddi.c:21-29, automix_tpu/models/ddi.py:44-54).
A_HYP, B_HYP, RHO = 3.0, 0.005, 24
REJECT = -1e7
_TINY = 1e-30


def _f32(x) -> float:
    return float(np.float32(x))


def wishart_const(d: int, r_diag) -> float:
    """Constant part of the Wishart log-density (userddi.c:493-498):
    -(rho/2) log(rho^-d det R^-1) - (rho d/2) log 2 - (d(d-1)/4) log pi
    - sum_j loggamma((rho - j)/2)."""
    det_rmin1 = float(np.prod(1.0 / np.asarray(r_diag)))
    c = -(RHO / 2.0) * np.log(RHO ** (-d) * det_rmin1)
    c -= (RHO * d / 2.0) * np.log(2.0)
    c -= (d * (d - 1) / 4.0) * np.log(np.pi)
    for j in range(d):
        c -= float(np_gammaln((RHO - j) / 2.0))
    return c


class ModelPart:
    """One DDI model's tables and column-form evaluation."""

    def __init__(self, tables, n_fix, d_re, var_row, prec_rows, c_prior,
                 dmin1, r_diag):
        self.n_fix = n_fix
        self.d_re = d_re
        self.ntri = tables["ntri"]
        self.n_cls = tables["n_cls"]
        self.n_cols = self.n_cls * (1 + self.ntri)
        self.var_row = var_row
        self.prec_rows = tuple(prec_rows)   # rows packing the UPPER tri
        self.quad_pairs = list(zip(np.asarray(tables["iu"][0]).tolist(),
                                   np.asarray(tables["iu"][1]).tolist()))
        n_quad = len(self.quad_pairs)
        tab = np.asarray(tables["table"], np.float32)
        self.tab_quad = tab[:n_quad]                       # [n_quad, cols]
        self.tab_lin = tab[n_quad:n_quad + n_fix]          # [n_fix, cols]
        self.tab_const = tab[n_quad + n_fix]               # [cols]
        self.G = np.asarray(tables["G"], np.float32)       # [n_cls, ntri]
        self.N = np.asarray(tables["N"], np.float32)
        self.tri_w = np.asarray(
            [1.0 if a == b else 2.0 for (a, b) in tables["tri"]], np.float32)
        # float32 constants, each folded where the JAX expression folds it
        self.alpha_hat = [_f32(a) for a in tables["alpha_hat"]]
        self.c_prior = [_f32(v) for v in c_prior]
        self.half_dmin1 = [_f32(0.5 * float(v)) for v in dmin1]
        self.r_diag = [_f32(v) for v in r_diag]
        n_tot = float(self.N.sum())
        sum_sd = float(np.sum(tables["N"] * (tables["s"] - d_re)))
        norm = (0.5 * float(np.sum(np.log(np.asarray(dmin1))))
                - (n_fix / 2.0) * np.log(2.0 * np.pi))
        ig = float(-A_HYP * np.log(B_HYP) - np_gammaln(A_HYP))
        self.scalars = {
            "norm": _f32(norm),
            "ldp": _f32((RHO - d_re - 1.0) / 2.0),
            "rdd": _f32(0.5 * RHO),
            "wish": _f32(wishart_const(d_re, r_diag)),
            "logv": _f32(-(A_HYP + 1.0)),
            "invv": _f32(1.0 / B_HYP),
            "ig": _f32(ig),
            "ntot": _f32(0.5 * n_tot),
            "sumsd": _f32(0.5 * sum_sd),
            "const": _f32(tables["const"]),
        }
        # per coordinate j < n_fix: the quadratic features containing j in
        # feature order, and the columns any of them or the linear row j
        # reaches (the rest are skipped)
        self.coord_feats = []
        self.touched = []
        for j in range(n_fix):
            feats = [f for f, (i1, i2) in enumerate(self.quad_pairs)
                     if i1 == j or i2 == j]
            nz = (self.tab_quad[feats] != 0).any(0) | (self.tab_lin[j] != 0)
            self.coord_feats.append(feats)
            self.touched.append(np.nonzero(nz)[0].tolist())
        self._dev = {}

    def _tabs(self, device):
        """The coefficient tables as float32 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._dev:
            def t(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(device)
            self._dev[device] = {
                "quad": t(self.tab_quad), "lin": t(self.tab_lin),
                "const": t(self.tab_const), "G": t(self.G), "N": t(self.N),
                "touched": [torch.tensor(c, dtype=torch.int64, device=device)
                            for c in self.touched],
            }
        return self._dev[device]

    # -- sufficient statistics (functions of alpha only) -----------------

    def stats_full(self, rows):
        """Tuple of n_cols per-chain statistic columns from scratch."""
        tabs = self._tabs(rows[0].device)
        delta = [rows[i] - self.alpha_hat[i] for i in range(self.n_fix)]
        acc = tabs["const"][:, None] + (0.0 * rows[0])[None, :]
        for f, (i1, i2) in enumerate(self.quad_pairs):
            phi = delta[i1] * delta[i2]
            acc = _add_masked(acc, phi, tabs["quad"][f])
        for i in range(self.n_fix):
            acc = _add_masked(acc, delta[i], tabs["lin"][i])
        return tuple(acc.unbind(0))

    def stats_coord(self, j, rows, old_j, stats):
        """Statistics after only alpha coordinate j changed from ``old_j``
        to ``rows[j]``; untouched columns are the same objects."""
        if j >= self.n_fix:
            return tuple(stats)
        tabs = self._tabs(rows[0].device)
        cols = self.touched[j]
        idx = tabs["touched"][j]
        dnew = rows[j] - self.alpha_hat[j]
        dold = old_j - self.alpha_hat[j]
        dd = dnew - dold
        acc = torch.stack([stats[c] for c in cols])
        for f in self.coord_feats[j]:
            i1, i2 = self.quad_pairs[f]
            if i1 == j and i2 == j:
                dphi = (dnew + dold) * dd
            else:
                other = i2 if i1 == j else i1
                dphi = (rows[other] - self.alpha_hat[other]) * dd
            acc = _add_masked(acc, dphi, tabs["quad"][f][idx])
        acc = _add_masked(acc, dd, tabs["lin"][j][idx])
        out = list(stats)
        for r, c in enumerate(cols):
            out[c] = acc[r]
        return tuple(out)

    # -- log-posterior from statistics -----------------------------------

    def lp(self, stats, rows):
        """Per-chain log-posterior from the statistics and the current
        precision / variance coordinates; out of support (var <= 0, a
        precision not positive definite) REJECT, then sanitized."""
        tabs = self._tabs(rows[0].device)
        sc = self.scalars
        prec = [rows[r] for r in self.prec_rows]
        var = rows[self.var_row]
        ok = var > 0.0
        vsafe = torch.where(ok, var, torch.ones_like(var))

        # leading principal minors (Sylvester) + log det of the precision
        r = self.r_diag
        if self.d_re == 2:
            a, b, c = prec
            det_p = a * c - b * b
            posdef = (a > 0.0) & (det_p > 0.0)
            r_dd = r[0] * a + r[1] * c
        else:
            # upper-tri order (0,0),(0,1),(0,2),(1,1),(1,2),(2,2)
            a, b, d_, c, e, f_ = prec
            m2 = a * c - b * b
            det_p = (a * (c * f_ - e * e) - b * (b * f_ - e * d_)
                     + d_ * (b * e - c * d_))
            posdef = (a > 0.0) & (m2 > 0.0) & (det_p > 0.0)
            r_dd = r[0] * a + r[1] * c + r[2] * f_
        log_det_prec = torch.log(torch.where(posdef, det_p,
                                             torch.ones_like(det_p)))
        log_v = torch.log(vsafe)
        inv_v = 1.0 / vsafe

        # prior (userddi.c:471-531)
        lp = sc["norm"] + 0.0 * var
        for i in range(self.n_fix):
            diff = rows[i] - self.c_prior[i]
            lp = lp - self.half_dmin1[i] * diff * diff
        lp = lp + sc["ldp"] * log_det_prec
        lp = lp - sc["rdd"] * r_dd
        lp = lp + sc["wish"]
        lp = lp + (sc["logv"] * log_v - sc["invv"] * inv_v + sc["ig"])

        # likelihood: the Woodbury recombination of every class at once,
        # then the class sums in class order
        st = torch.stack(stats).reshape(self.n_cls, 1 + self.ntri, -1)
        q0 = st[:, 0]
        G = tabs["G"]
        M = [vsafe[None, :] * prec[e][None, :] + G[:, e:e + 1]
             for e in range(self.ntri)]
        if self.d_re == 2:
            ma, mb, mc = M
            det = ma * mc - mb * mb
            adj = [mc, -mb, ma]
        else:
            ma, mb, mc_, me, mf, mi = M
            a00 = me * mi - mf * mf
            a01 = mc_ * mf - mb * mi
            a02 = mb * mf - mc_ * me
            det = ma * a00 + mb * a01 + mc_ * a02
            adj = [a00, a01, a02, ma * mi - mc_ * mc_, mb * mc_ - ma * mf,
                   ma * me - mb * mb]
        detsafe = torch.clamp(det, min=_TINY)
        sH = None
        for e in range(self.ntri):
            term = (float(self.tri_w[e]) * adj[e]) * st[:, 1 + e]
            sH = term if sH is None else sH + term
        quad_c = q0 - sH * (1.0 / detsafe)
        ld_c = tabs["N"][:, None] * torch.log(detsafe)
        quad, ld = quad_c[0], ld_c[0]
        for ci in range(1, self.n_cls):
            quad = quad + quad_c[ci]
            ld = ld + ld_c[ci]
        llh = (-0.5 * quad * inv_v
               - 0.5 * ld
               + sc["ntot"] * log_det_prec
               - sc["sumsd"] * log_v
               + sc["const"])

        out = torch.where(ok & posdef, lp + llh,
                          torch.full_like(lp, REJECT))
        out = torch.clamp(out, min=NEG_INF, max=-NEG_INF)
        return torch.where(out == out, out, torch.full_like(out, NEG_INF))

    def logp_cols(self, rows):
        """The stateless column density: statistics from scratch, then lp."""
        return self.lp(self.stats_full(rows), rows)


def _add_masked(acc, x, coef):
    """acc + x * coef on every column whose coefficient is nonzero, +0 on
    the others: ``acc`` [cols, S], ``x`` [S], ``coef`` [cols]."""
    nz = (coef != 0.0)[:, None]
    return acc + torch.where(nz, x[None, :] * coef[:, None],
                             torch.zeros((), dtype=acc.dtype,
                                         device=acc.device))


class DDIFusedDensity:
    """The incremental density of the 2-model DDI family (dims 16 / 10).

    The cache is the tuple of 105 model-0 then 60 model-1 per-chain
    statistic columns; every chain carries both models' statistics.
    ``cuda_cache`` names the kernels' implementation of this density
    (``csrc/ddi.cuh``, the cached form of ``csrc/fused_sweep.cu``)."""

    cuda_cache = "ddi"

    def __init__(self, parts):
        self.parts = tuple(parts)
        self._m0, self._m1 = self.parts
        self.n_cache = self._m0.n_cols + self._m1.n_cols
        self.dims = (16, 10)

    def full(self, k, rows):
        """(lp of each chain's own model, fresh cache) at ``rows``."""
        s0 = self._m0.stats_full(rows)
        s1 = self._m1.stats_full(rows)
        lp = torch.where(k == 0, self._m0.lp(s0, rows),
                         self._m1.lp(s1, rows))
        return lp, s0 + s1

    def coord(self, j, k, rows, old_j, cache):
        """(lp, cache') after only coordinate j changed from ``old_j`` to
        ``rows[j]``.  Model 0 (dim 16): alpha coordinates 0..8, precision
        9..14, variance 15; model 1 (dim 10): alpha 0..5, precision 6..8,
        variance 9.  Both models' statistics follow alpha moves whatever
        the chain's model.  For j >= 10 a model-1 chain's move is
        inactive: its lp is 0 and its statistics pass through."""
        n0 = self._m0.n_cols
        c0, c1 = cache[:n0], cache[n0:]
        s0 = self._m0.stats_coord(j, rows, old_j, c0)
        lp0 = self._m0.lp(s0, rows)
        if j < 10:
            s1 = self._m1.stats_coord(j, rows, old_j, c1)
            lp = torch.where(k == 0, lp0, self._m1.lp(s1, rows))
        else:
            s1 = tuple(c1)
            lp = torch.where(k == 0, lp0, torch.zeros_like(lp0))
        return lp, tuple(s0) + tuple(s1)

    def header(self) -> str:
        """``am_ddi.h``, the generated header of ``csrc/ddi.cuh``: per model
        its sizes, rows and float32 tables (the coefficients column by
        column, quadratic features then linear ones), read by the CUDA
        kernels as the twin reads them here."""
        def arr(name, xs, ctype="float"):
            xs = list(xs)
            if ctype == "float":
                body = ", ".join(f"{float(np.float32(x))!r}f" for x in xs)
            else:
                body = ", ".join(str(int(x)) for x in xs)
            return (f"static __constant__ {ctype} {name}[{len(xs)}] = "
                    f"{{{body}}};\n")

        text = ("// Generated by automix_tpu_torch/kernels/_build.py from "
                "automix_tpu_torch/models/ddi_cols.py.\n#pragma once\n"
                "#define AM_DDI_K 2\n#define AM_DDI_D 16\n"
                f"#define AM_DDI_NCACHE {self.n_cache}\n"
                f"#define AM_DDI_REJECT {REJECT!r}f\n")
        offsets = (0, self._m0.n_cols)
        for m, p in enumerate(self.parts):
            n_quad = len(p.quad_pairs)
            coef = np.concatenate([p.tab_quad, p.tab_lin], 0).T   # [cols, F]
            fidx = [[p.quad_pairs.index((min(i, j), max(i, j)))
                     for i in range(p.n_fix)] for j in range(p.n_fix)]
            # the features containing j in feature order (stats_coord's)
            assert all(row == p.coord_feats[j] for j, row in enumerate(fidx))
            sc = p.scalars
            text += (f"#define AM_DDI{m}_DIM {self.dims[m]}\n"
                     f"#define AM_DDI{m}_FIX {p.n_fix}\n"
                     f"#define AM_DDI{m}_RE {p.d_re}\n"
                     f"#define AM_DDI{m}_TRI {p.ntri}\n"
                     f"#define AM_DDI{m}_CLS {p.n_cls}\n"
                     f"#define AM_DDI{m}_COLS {p.n_cols}\n"
                     f"#define AM_DDI{m}_QUAD {n_quad}\n"
                     f"#define AM_DDI{m}_VAR {p.var_row}\n"
                     f"#define AM_DDI{m}_OFF {offsets[m]}\n")
            prec = " : ".join(f"(e) == {e} ? {r}"
                              for e, r in enumerate(p.prec_rows[:-1]))
            text += (f"#define AM_DDI{m}_PREC(e) ({prec} : "
                     f"{p.prec_rows[-1]})\n")
            text += arr(f"am_ddi{m}_ah", p.alpha_hat)
            text += arr(f"am_ddi{m}_cprior", p.c_prior)
            text += arr(f"am_ddi{m}_hdmin1", p.half_dmin1)
            text += arr(f"am_ddi{m}_rdiag", p.r_diag)
            text += arr(f"am_ddi{m}_scal", [sc[n] for n in (
                "norm", "ldp", "rdd", "wish", "logv", "invv", "ig", "ntot",
                "sumsd", "const")])
            text += arr(f"am_ddi{m}_const", p.tab_const)
            text += arr(f"am_ddi{m}_coef", coef.reshape(-1))
            text += arr(f"am_ddi{m}_fidx", np.asarray(fidx).reshape(-1),
                        "int")
            text += arr(f"am_ddi{m}_G", p.G.reshape(-1))
            text += arr(f"am_ddi{m}_N", p.N)
            text += arr(f"am_ddi{m}_triw", p.tri_w)
        return text

    def nonzeros(self):
        """Nonzero coefficients per model: (quadratic + linear of a full
        evaluation, of a coordinate update summed over the model's alpha
        coordinates).  The operation counts of the kernels' bound."""
        out = []
        for p in self.parts:
            full = int((p.tab_quad != 0).sum() + (p.tab_lin != 0).sum())
            coord = sum(int((p.tab_quad[p.coord_feats[j]] != 0).sum()
                            + (p.tab_lin[j] != 0).sum())
                        for j in range(p.n_fix))
            out.append((full, coord))
        return out
