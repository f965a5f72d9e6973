// The change-point family's density (automix_tpu_torch/models/changepoint.py
// family_cols) on the card, D5: the log-posterior of a chain's own model,
// in the twin's operation order.
//
// c = (ns, the prior constant of ns change points, the two order-statistics
// constants, alpha log beta - lgamma(alpha), alpha - 1, beta, T, the reject
// value); theta = the ns + 1 rates, then the ns change points.  The change
// points sit at run-time offsets ns + 1 + q of theta, so they are selected
// by compare into the boundary list (0, s_0, ..., s_{ns-1}, T): theta stays
// in registers.  An out-of-support state returns the reject value before
// the search, as JAX's where does.
//
// The segment counts: with the change points in order (the support
// guarantees it), an event x lies in segment q exactly when
// s_{q-1} < x <= s_q, so the count of segment q is G_q - G_{q-1}, G_q the
// number of events <= s_q: integers, equal to JAX's searchsorted histogram
// and to the twin's.  G_q comes from a fixed-step binary search of the
// sorted events, 8 steps for the 191 events, where a scan took 191
// compares per change point at every evaluation (one per coordinate move
// and one for the jump, every sweep).  The ns searches run in lockstep,
// so each step issues ns independent loads.
// The events live in global memory (am_cpt.h, generated from
// changepoint.py header()) and are read through L1 (__ldg): the threads
// of a warp search different addresses after the first step, which
// __constant__ memory would serve one address at a time.
#pragma once

#include "am_cpt.h"

// floor(log2 n) for n >= 1.
__host__ __device__ constexpr int am_log2_floor(int n) {
  return n < 2 ? 0 : 1 + am_log2_floor(n / 2);
}

template <int D>
__device__ __forceinline__ float am_density_cpt(int set, const float* c,
                                                const float* th) {
  constexpr int kS = AM_CPT_K;    // change points of the largest model
  const int ns = (int)c[0];
  const float t_end = c[7];
  float b[kS + 2];
  b[0] = 0.0f;
#pragma unroll
  for (int q = 0; q <= kS; ++q) {
    float v = t_end;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (q < ns && d == ns + 1 + q) v = th[d];
    b[q + 1] = v;
  }
  bool ok = true;
  float ds[kS + 1];
#pragma unroll
  for (int q = 0; q <= kS; ++q) {
    if (q > ns) break;
    ds[q] = b[q + 1] - b[q];
    ok = ok && (th[q] > 0.0f) && (ds[q] > 0.0f);
  }
  if (!ok) return c[8];

  // prior (usercpt.c:100-109)
  float lh[kS + 1];
  float prior = 0.0f;
#pragma unroll
  for (int q = 0; q <= kS; ++q) {
    if (q > ns) break;
    lh[q] = logf(th[q]);
    const float term = ((c[4] + c[5] * lh[q]) - c[6] * th[q]) + logf(ds[q]);
    prior = (q == 0) ? term : prior + term;
  }
  float lp = c[1] + prior;
  lp = lp + c[2];
  lp = lp - c[3];

  // likelihood: the events of each segment (usercpt.c:115-130).  G_q by
  // search: with P = 2^floor(log2 N) (so N < 2P), the first step asks
  // whether event N - P is <= s_q; if it is, so is every event before it
  // and G_q >= N - P + 1.  The steps P/2, ..., 1 then search the P - 1
  // events after that start (0 or N - P + 1), which lie within the N, so
  // G_q takes each value 0..N (tests/test_torch_changepoint.py models it).
  int g[kS];
  const float* ev = am_cpt_events + set * AM_CPT_N;
  constexpr int kB = am_log2_floor(AM_CPT_N), kP = 1 << kB;
  const float e0 = __ldg(ev + AM_CPT_N - kP);
#pragma unroll
  for (int q = 0; q < kS; ++q)
    g[q] = (e0 <= b[q + 1]) ? AM_CPT_N - kP + 1 : 0;
#pragma unroll
  for (int bit = kB - 1; bit >= 0; --bit) {
    const int step = 1 << bit;
#pragma unroll
    for (int q = 0; q < kS; ++q)
      if (q < ns)
        g[q] += (__ldg(ev + g[q] + step - 1) <= b[q + 1]) ? step : 0;
  }
  float llh = 0.0f;
#pragma unroll
  for (int q = 0; q <= kS; ++q) {
    if (q > ns) break;
    const int hi = (q < ns) ? g[q] : AM_CPT_N;
    const int lo = (q == 0) ? 0 : g[q > 0 ? q - 1 : 0];
    const float term = (float)(hi - lo) * lh[q] - th[q] * ds[q];
    llh = (q == 0) ? term : llh + term;
  }
  return lp + llh;
}
