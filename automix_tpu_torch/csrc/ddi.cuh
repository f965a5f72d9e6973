// The DDI family's density (automix_tpu_torch/models/ddi_cols.py) on the
// card: the per-class sufficient statistics of each model, from scratch or
// after a move of one coordinate, and the log-posterior from them.
//
// A statistic column sums in the twin's order: const + 0 * theta[0], then
// the nonzero quadratic features delta_i1 * delta_i2 (i1 <= i2) in feature
// order, then the nonzero linear features delta_i; after a move of
// coordinate j, the column adds the features containing j in feature order
// (am_ddi<M>_fidx) and then the linear feature j.  The coefficients, one
// row of quadratic and linear coefficients per column, live in __constant__
// memory (am_ddi.h, generated from ddi_cols.py header()); the column
// functions read them and the feature indices through a view of one model:
// AmDdiConst reads __constant__ memory (K2, K3, the stateless sweep forms
// and K1c), AmDdiShared the same arrays copied into shared memory once per
// block (K1e, whose sweeps read the 29 KB so often that they thrashed the
// constant cache; PERF.md section 6).  Every thread of a warp walks the
// same columns and features, so each coefficient load is a broadcast and
// the zero test a uniform branch; the nesting (columns outside, features
// inside) is free, the order within a column is not.
// The feature values live in registers: the feature loops are unrolled, so
// every index into them is a constant.
//
// Nothing here is stored per column: the log-posterior takes the columns
// from a functor that computes each one when the class loop needs it, so
// a candidate's statistics never need storage of their own.
#pragma once

#include "am_ddi.h"

// Sizes, rows and tables of DDI model M (am_ddi.h).
template <int M>
struct AmDdi;

#define AM_DDI_TRAITS(m)                                                     \
  template <>                                                                \
  struct AmDdi<m> {                                                          \
    enum {                                                                   \
      kFix = AM_DDI##m##_FIX,                                                \
      kRe = AM_DDI##m##_RE,                                                  \
      kTri = AM_DDI##m##_TRI,                                                \
      kCls = AM_DDI##m##_CLS,                                                \
      kCols = AM_DDI##m##_COLS,                                              \
      kQuad = AM_DDI##m##_QUAD,                                              \
      kVar = AM_DDI##m##_VAR,                                                \
      kOff = AM_DDI##m##_OFF,                                                \
      kF = AM_DDI##m##_QUAD + AM_DDI##m##_FIX                                \
    };                                                                       \
    __device__ static constexpr int prec(int e) {                           \
      return AM_DDI##m##_PREC(e);                                            \
    }                                                                        \
    __device__ static const float* ah() { return am_ddi##m##_ah; }          \
    __device__ static const float* cprior() { return am_ddi##m##_cprior; }  \
    __device__ static const float* hdmin1() { return am_ddi##m##_hdmin1; }  \
    __device__ static const float* rdiag() { return am_ddi##m##_rdiag; }    \
    __device__ static const float* scal() { return am_ddi##m##_scal; }      \
    __device__ static const float* cst() { return am_ddi##m##_const; }      \
    __device__ static const float* coef() { return am_ddi##m##_coef; }      \
    __device__ static const int* fidx() { return am_ddi##m##_fidx; }        \
    __device__ static const float* G() { return am_ddi##m##_G; }            \
    __device__ static const float* N() { return am_ddi##m##_N; }            \
    __device__ static const float* triw() { return am_ddi##m##_triw; }      \
  };
AM_DDI_TRAITS(0)
AM_DDI_TRAITS(1)
#undef AM_DDI_TRAITS

// delta_i = theta_i - alpha_hat_i and the quadratic features of model M.
template <int M>
__device__ __forceinline__ void am_ddi_features(const float* th, float* delta,
                                                float* phi) {
  using P = AmDdi<M>;
#pragma unroll
  for (int i = 0; i < P::kFix; ++i) delta[i] = th[i] - P::ah()[i];
  int f = 0;
#pragma unroll
  for (int i1 = 0; i1 < P::kFix; ++i1)
#pragma unroll
    for (int i2 = i1; i2 < P::kFix; ++i2) phi[f++] = delta[i1] * delta[i2];
}

// Model M's coefficient rows and feature indices in __constant__ memory.
template <int M>
struct AmDdiConst {
  __device__ const float* coef() const { return AmDdi<M>::coef(); }
  __device__ const int* fidx() const { return AmDdi<M>::fidx(); }
};

// The same arrays copied into shared memory (am_ddi_shared_load).
template <int M>
struct AmDdiShared {
  const float* c;
  const int* f;
  __device__ const float* coef() const { return c; }
  __device__ const int* fidx() const { return f; }
};

// Floats of shared memory holding both models' coefficients, then their
// feature indices (am_ddi_shared_load).
constexpr int kAmDdiCoef0 = AmDdi<0>::kCols * AmDdi<0>::kF;
constexpr int kAmDdiCoef1 = AmDdi<1>::kCols * AmDdi<1>::kF;
constexpr int kAmDdiFidx0 = AmDdi<0>::kFix * AmDdi<0>::kFix;
constexpr int kAmDdiShared =
    kAmDdiCoef0 + kAmDdiCoef1 + kAmDdiFidx0 + AmDdi<1>::kFix * AmDdi<1>::kFix;

// Copy both models' coefficients and feature indices from __constant__
// memory into ``s`` with the block's threads (the caller synchronizes).
__device__ __forceinline__ void am_ddi_shared_load(float* s, int tid,
                                                   int nthreads) {
  for (int x = tid; x < kAmDdiCoef0; x += nthreads) s[x] = AmDdi<0>::coef()[x];
  for (int x = tid; x < kAmDdiCoef1; x += nthreads)
    s[kAmDdiCoef0 + x] = AmDdi<1>::coef()[x];
  int* fi = reinterpret_cast<int*>(s + kAmDdiCoef0 + kAmDdiCoef1);
  for (int x = tid; x < kAmDdiFidx0; x += nthreads) fi[x] = AmDdi<0>::fidx()[x];
  for (int x = tid; x < kAmDdiShared - kAmDdiCoef0 - kAmDdiCoef1 - kAmDdiFidx0;
       x += nthreads)
    fi[kAmDdiFidx0 + x] = AmDdi<1>::fidx()[x];
}

// Model M's view of the tables: the copies at ``s`` (am_ddi_shared_load)
// with kShared, else __constant__ memory.
template <int M, bool kShared>
__device__ __forceinline__ auto am_ddi_tables(const float* s) {
  if constexpr (kShared) {
    const int* fi = reinterpret_cast<const int*>(s + kAmDdiCoef0 + kAmDdiCoef1);
    return M == 0 ? AmDdiShared<M>{s, fi}
                  : AmDdiShared<M>{s + kAmDdiCoef0, fi + kAmDdiFidx0};
  } else {
    return AmDdiConst<M>{};
  }
}

// Statistic column ``col`` of model M from scratch, from the tables ``tab``.
template <int M, class Tab>
__device__ __forceinline__ float am_ddi_col_full(const Tab& tab, int col,
                                                 const float* delta,
                                                 const float* phi, float th0) {
  using P = AmDdi<M>;
  const float* cf = tab.coef() + col * P::kF;
  float acc = P::cst()[col] + 0.0f * th0;
#pragma unroll
  for (int f = 0; f < P::kQuad; ++f) {
    const float t = cf[f];
    if (t != 0.0f) acc = acc + phi[f] * t;
  }
#pragma unroll
  for (int i = 0; i < P::kFix; ++i) {
    const float t = cf[P::kQuad + i];
    if (t != 0.0f) acc = acc + delta[i] * t;
  }
  return acc;
}

// Feature increments of a move of alpha coordinate j < kFix of model M from
// ``oldj`` to ``prop[j]``: dphi[i] for the feature pairing j with i, and
// dd = dnew - dold for the linear feature j.
template <int M>
__device__ __forceinline__ float am_ddi_increments(int j, const float* prop,
                                                   float oldj, float* dphi) {
  using P = AmDdi<M>;
  float pj = 0.0f, ahj = 0.0f;
#pragma unroll
  for (int i = 0; i < P::kFix; ++i)
    if (i == j) {
      pj = prop[i];
      ahj = P::ah()[i];
    }
  const float dnew = pj - ahj;
  const float dold = oldj - ahj;
  const float dd = dnew - dold;
#pragma unroll
  for (int i = 0; i < P::kFix; ++i)
    dphi[i] = (i == j) ? (dnew + dold) * dd : (prop[i] - P::ah()[i]) * dd;
  return dd;
}

// Statistic column ``col`` of model M after the move of coordinate j whose
// increments are dphi, dd, from its carried value ``c``.
template <int M, class Tab>
__device__ __forceinline__ float am_ddi_col_coord(const Tab& tab, int col,
                                                  int j, float c,
                                                  const float* dphi,
                                                  float dd) {
  using P = AmDdi<M>;
  const float* cf = tab.coef() + col * P::kF;
  const int* fi = tab.fidx() + j * P::kFix;
  float acc = c;
#pragma unroll
  for (int i = 0; i < P::kFix; ++i) {
    const float t = cf[fi[i]];
    if (t != 0.0f) acc = acc + dphi[i] * t;
  }
  const float t = cf[P::kQuad + j];
  if (t != 0.0f) acc = acc + dd * t;
  return acc;
}

// Log-posterior of model M at theta ``th`` from its statistics, column c of
// which is ``col(c)``; out of support -1e7, then sanitized (NaN -> NEG_INF,
// clamp to [NEG_INF, -NEG_INF]).
template <int M, class Col>
__device__ __forceinline__ float am_ddi_lp(const float* th, Col col) {
  using P = AmDdi<M>;
  float prec[P::kTri];
#pragma unroll
  for (int e = 0; e < P::kTri; ++e) prec[e] = th[P::prec(e)];
  const float var = th[P::kVar];
  const bool ok = var > 0.0f;
  const float vsafe = ok ? var : 1.0f;
  const float* rd = P::rdiag();
  float det_p, r_dd;
  bool posdef;
  if constexpr (P::kRe == 2) {
    const float a = prec[0], b = prec[1], c = prec[2];
    det_p = a * c - b * b;
    posdef = (a > 0.0f) && (det_p > 0.0f);
    r_dd = rd[0] * a + rd[1] * c;
  } else {
    // upper-tri order (0,0),(0,1),(0,2),(1,1),(1,2),(2,2)
    const float a = prec[0], b = prec[1], d_ = prec[2], c = prec[3],
                e = prec[4], f_ = prec[5];
    const float m2 = a * c - b * b;
    det_p = a * (c * f_ - e * e) - b * (b * f_ - e * d_) +
            d_ * (b * e - c * d_);
    posdef = (a > 0.0f) && (m2 > 0.0f) && (det_p > 0.0f);
    r_dd = rd[0] * a + rd[1] * c + rd[2] * f_;
  }
  const float ldp = logf(posdef ? det_p : 1.0f);
  const float log_v = logf(vsafe);
  const float inv_v = 1.0f / vsafe;
  const float* sc = P::scal();

  // prior (userddi.c:471-531)
  float lp = sc[0] + 0.0f * var;
#pragma unroll
  for (int i = 0; i < P::kFix; ++i) {
    const float diff = th[i] - P::cprior()[i];
    lp = lp - P::hdmin1()[i] * diff * diff;
  }
  lp = lp + sc[1] * ldp;
  lp = lp - sc[2] * r_dd;
  lp = lp + sc[3];
  lp = lp + (sc[4] * log_v - sc[5] * inv_v + sc[6]);

  // likelihood: the Woodbury recombination class by class
  float quad = 0.0f, ld = 0.0f;
  for (int ci = 0; ci < P::kCls; ++ci) {
    const int base = ci * (1 + P::kTri);
    const float* g = P::G() + ci * P::kTri;
    float Mx[P::kTri];
#pragma unroll
    for (int e = 0; e < P::kTri; ++e) Mx[e] = vsafe * prec[e] + g[e];
    float det, adj[P::kTri];
    if constexpr (P::kRe == 2) {
      det = Mx[0] * Mx[2] - Mx[1] * Mx[1];
      adj[0] = Mx[2];
      adj[1] = -Mx[1];
      adj[2] = Mx[0];
    } else {
      const float ma = Mx[0], mb = Mx[1], mc_ = Mx[2], me = Mx[3],
                  mf = Mx[4], mi = Mx[5];
      adj[0] = me * mi - mf * mf;
      adj[1] = mc_ * mf - mb * mi;
      adj[2] = mb * mf - mc_ * me;
      det = ma * adj[0] + mb * adj[1] + mc_ * adj[2];
      adj[3] = ma * mi - mc_ * mc_;
      adj[4] = mb * mc_ - ma * mf;
      adj[5] = ma * me - mb * mb;
    }
    // torch.clamp(min=1e-30): NaN stays NaN
    const float detsafe = (det != det) ? det : fmaxf(det, 1e-30f);
    float sH = 0.0f;
#pragma unroll
    for (int e = 0; e < P::kTri; ++e) {
      const float term = (P::triw()[e] * adj[e]) * col(base + 1 + e);
      sH = (e == 0) ? term : sH + term;
    }
    const float quad_c = col(base) - sH * (1.0f / detsafe);
    const float ld_c = P::N()[ci] * logf(detsafe);
    quad = (ci == 0) ? quad_c : quad + quad_c;
    ld = (ci == 0) ? ld_c : ld + ld_c;
  }
  const float llh = -0.5f * quad * inv_v - 0.5f * ld + sc[7] * ldp -
                    sc[8] * log_v + sc[9];
  const float out = (ok && posdef) ? lp + llh : AM_DDI_REJECT;
  return fminf(fmaxf(out, AM_NEG_INF), -AM_NEG_INF);
}

// The stateless density of model M: statistics from scratch, then lp.
template <int M, class Tab = AmDdiConst<M>>
__device__ __forceinline__ float am_ddi_logpost(const float* th,
                                                const Tab& tab = Tab{}) {
  float delta[AmDdi<M>::kFix], phi[AmDdi<M>::kQuad];
  am_ddi_features<M>(th, delta, phi);
  return am_ddi_lp<M>(th, [&](int c) {
    return am_ddi_col_full<M>(tab, c, delta, phi, th[0]);
  });
}

// A chain's cache of both models' statistics: column i at p[i * kStride]
// (shared memory as [column][thread], kStride the block's threads).
template <int kStride>
struct AmDdiCache {
  float* p;
  __device__ __forceinline__ float& operator[](int i) const {
    return p[i * kStride];
  }
};

// Model M's part of the cache from scratch at ``th``: stored, or blended
// into the carried columns as c + (cn - c) (an accepted move's blend).
template <int M, class Tab, class Cache>
__device__ __forceinline__ void am_ddi_cache_full(const Tab& tab,
                                                  const float* th, Cache c,
                                                  bool blend) {
  using P = AmDdi<M>;
  float delta[P::kFix], phi[P::kQuad];
  am_ddi_features<M>(th, delta, phi);
  for (int col = 0; col < P::kCols; ++col) {
    const float v = am_ddi_col_full<M>(tab, col, delta, phi, th[0]);
    float& x = c[P::kOff + col];
    x = blend ? x + (v - x) : v;
  }
}

// lp of model M at ``prop`` (theta with coordinate j moved from ``oldj``)
// from the carried cache updated for the move.
template <int M, class Tab, class Cache>
__device__ __forceinline__ float am_ddi_lp_coord(const Tab& tab, int j,
                                                 const float* prop,
                                                 float oldj, Cache c) {
  using P = AmDdi<M>;
  if (j >= P::kFix)
    return am_ddi_lp<M>(prop, [&](int col) { return c[P::kOff + col]; });
  float dphi[P::kFix];
  const float dd = am_ddi_increments<M>(j, prop, oldj, dphi);
  return am_ddi_lp<M>(prop, [&](int col) {
    return am_ddi_col_coord<M>(tab, col, j, c[P::kOff + col], dphi, dd);
  });
}

// An accepted move of coordinate j: model M's cache columns blended to
// their updated values as c + (cn - c) (untouched columns stay equal).
template <int M, class Tab, class Cache>
__device__ __forceinline__ void am_ddi_cache_coord(const Tab& tab, int j,
                                                   const float* prop,
                                                   float oldj, Cache c) {
  using P = AmDdi<M>;
  if (j >= P::kFix) return;
  float dphi[P::kFix];
  const float dd = am_ddi_increments<M>(j, prop, oldj, dphi);
  for (int col = 0; col < P::kCols; ++col) {
    float& x = c[P::kOff + col];
    const float v = am_ddi_col_coord<M>(tab, col, j, x, dphi, dd);
    x = x + (v - x);
  }
}
