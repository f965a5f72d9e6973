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
// the event loop, as JAX's where does.
//
// The segment counts: with the change points in order (the support
// guarantees it), an event x lies in segment q exactly when
// s_{q-1} < x <= s_q, so the count of segment q is G_q - G_{q-1}, G_q the
// number of events <= s_q: integers, equal to JAX's searchsorted histogram
// and to the twin's.  G is counted by comparing every event with the 6
// boundaries: the events live in __constant__ memory (am_cpt.h, generated
// from changepoint.py header()), and every thread of a warp reads the same
// event at the same step, so each load is a broadcast.  The event loop stays
// rolled, which bounds code size: the density is inlined at every
// evaluation site of the (6, 13) kernels.
#pragma once

#include "am_cpt.h"

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

  // likelihood: the events of each segment (usercpt.c:115-130)
  int g[kS + 1];
#pragma unroll
  for (int q = 0; q <= kS; ++q) g[q] = 0;
  const int off = set * AM_CPT_N;
#pragma unroll 1
  for (int e = 0; e < AM_CPT_N; ++e) {
    const float x = am_cpt_events[off + e];
#pragma unroll
    for (int q = 0; q < kS; ++q) g[q] += (x <= b[q + 1]) ? 1 : 0;
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
