"""Sufficient-statistic DDI likelihood: the 467 patients collapsed to 15
visit-pattern classes.

Counterpart of ``build_class_tables`` in ``automix_tpu/models/ddi_stats.py``
(numpy float64, the same arithmetic).  The patient covariance
C_n = W_n V W_n^T + sigma^2 I depends on the patient only through its
random-effects design W_n, and every W_n is one of 15 compacted visit
designs W_c.  By Sylvester and Woodbury against the d_re x d_re class
matrix M_c = sigma^2 Vinv + G_c (G_c = W_c^T W_c),

    log det C_n = (S_n - d) log sigma^2 + log det M_c - log det Vinv
    r^T C^{-1} r = sigma^{-2} (r^T r - h^T M_c^{-1} h),  h = W_c^T r,

and with r_n = y_n - X_n alpha the class statistics q0_c = sum_n r^T r and
H_c = sum_n h h^T are quadratic polynomials in alpha with constant
coefficient tables, centred on the global least-squares alpha_hat.  The
JAX package's batched matmul form of the likelihood (``build_llh``) is
not ported: the port evaluates the statistics column by column
(``models/ddi_cols.py``).

Reference: userddi.c:533-670 (the per-patient loop this replaces).
"""

from __future__ import annotations

import numpy as np


def build_class_tables(design, fixed, Y, vmask, S_counts):
    """Precompute the class sufficient-statistic tables (float64 numpy).

    Returns a dict with: ``alpha_hat`` [n_fix]; ``table`` [F, 15 * (1 +
    ntri)] mapping phi(delta) = [delta_i delta_j (i <= j), delta, 1] to
    per-class (q0, H upper-tri entries); ``G`` [15, ntri] class Gram
    entries; ``N`` / ``s`` [15] class sizes / visit counts; ``const`` the
    -0.5 * sum S_n log 2pi term; ``d_re``, ``n_fix``, ``ntri``, ``n_cls``,
    ``tri`` (the upper-tri (a, b) pairs) and ``iu`` (the quadratic
    features' index pairs).
    """
    W = np.asarray(design, np.float64)
    X = np.asarray(fixed, np.float64)
    Y = np.asarray(Y, np.float64)
    vm = np.asarray(vmask, np.float64)
    S = np.asarray(S_counts)
    n_pat, vmax, d_re = W.shape
    n_fix = X.shape[2]

    # classes = distinct compacted designs (observed visit subsets)
    patterns: dict = {}
    for i in range(n_pat):
        patterns.setdefault(tuple(np.round(W[i], 9).ravel()), []).append(i)
    for idxs in patterns.values():
        w0 = W[idxs[0]]
        for i in idxs[1:]:
            assert np.allclose(W[i], w0), "class design mismatch"

    # global least-squares centre: |delta| stays O(1) near the posterior,
    # which bounds the float32 cancellation error of the statistics
    P2g = np.einsum("nvi,nvj->ij", X, X)
    p1g = np.einsum("nvi,nv->i", X, Y * vm)
    alpha_hat = np.linalg.solve(P2g, p1g)

    tri = [(a, b) for a in range(d_re) for b in range(a, d_re)]
    ntri = len(tri)
    # symmetric quadratic features delta_i delta_j, i <= j, off-diagonal
    # coefficients folded as T[i, j] + T[j, i]
    iu = np.triu_indices(n_fix)
    n_quad = len(iu[0])
    F = n_quad + n_fix + 1
    n_cls = len(patterns)
    table = np.zeros((F, n_cls * (1 + ntri)))
    G = np.zeros((n_cls, ntri))
    N = np.zeros(n_cls)
    s_c = np.zeros(n_cls)

    for c, (key, idxs) in enumerate(sorted(patterns.items())):
        Wc = W[idxs[0]]
        N[c] = len(idxs)
        s_c[c] = S[idxs[0]]
        Gc = Wc.T @ Wc
        G[c] = [Gc[a, b] for (a, b) in tri]
        P2 = np.zeros((n_fix, n_fix))
        p1 = np.zeros(n_fix)
        p0 = 0.0
        T2 = np.zeros((ntri, n_fix, n_fix))
        t1 = np.zeros((ntri, n_fix))
        t0 = np.zeros(ntri)
        for i in idxs:
            Xi = X[i]
            rhat = (Y[i] - Xi @ alpha_hat) * vm[i]
            A = Wc.T @ Xi                     # [d_re, n_fix]
            g = Wc.T @ rhat                   # [d_re]
            P2 += Xi.T @ Xi
            p1 += Xi.T @ rhat
            p0 += rhat @ rhat
            for e, (a, b) in enumerate(tri):
                T2[e] += np.outer(A[a], A[b])
                t1[e] += g[a] * A[b] + g[b] * A[a]
                t0[e] += g[a] * g[b]

        def sym_rows(Q2):
            Qs = Q2 + Q2.T
            rows = Qs[iu]
            rows[iu[0] == iu[1]] /= 2.0       # diagonal counted once
            return rows

        col = c * (1 + ntri)
        table[:, col] = np.concatenate([sym_rows(P2), -2.0 * p1, [p0]])
        for e in range(ntri):
            table[:, col + 1 + e] = np.concatenate(
                [sym_rows(T2[e]), -t1[e], [t0[e]]])

    const = -0.5 * float(S.sum()) * np.log(2.0 * np.pi)
    return dict(alpha_hat=alpha_hat, table=table, G=G, N=N, s=s_c,
                const=const, d_re=d_re, n_fix=n_fix, ntri=ntri,
                n_cls=n_cls, tri=tri, iu=iu)
