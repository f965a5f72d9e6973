// Device functions shared by the stage-1 and stage-3 kernels.
//
// Counter hash, uniforms, Gumbel, Box-Muller and Bailey polar t draws, the
// latent log-densities, the shifted Stirling log-gamma and the column
// densities of the ported problems, each in the operation order of its twin
// in the JAX package (automix_tpu/kernels/fused.py
// _triple32/_lowbias32/_u01/_gumbel/lat_lpdf/t_draw, automix_tpu/ops/
// plmath.py pal_gammaln, automix_tpu/models/builtin.py and toy.py column
// forms) and in this package's torch versions (ops/randoms.py,
// ops/plmath.py, models/builtin.py, models/toy.py).
//
// Floating point: the kernels are built without --use_fast_math (logf,
// expf, log1pf, cosf, sinf are the accurate library versions) and with
// -fmad=false, so every a*b+c rounds twice, exactly as the JAX kernels and
// the plain torch versions round it.  Kernel and twin then differ only by
// the ulp-level differences of the transcendental functions between
// libraries.
#pragma once

#include <math.h>
#include <stdint.h>

#define AM_NEG_INF (-1e30f)
#define AM_N_CONSTS 20      // automix_tpu_torch/model.py N_DENSITY_CONSTS
#define AM_TWO_PI 6.283185307179586f
#define AM_HALF_LOG_2PI 0.9189385332046727f
#define AM_LOG_ACCEPT_CLAMP (-30.0f)

// Density kinds (automix_tpu_torch/models/builtin.py and toy.py KIND_*).
#define AM_KIND_NORMAL_PARAMS 1
#define AM_KIND_BETA_PARAMS 2
#define AM_KIND_GAMMA_PARAMS 3
#define AM_KIND_NORMAL_SAMPLER 4
#define AM_KIND_TRUNCNORMAL_SAMPLER 5
#define AM_KIND_BETA_SAMPLER 6
#define AM_KIND_MIXTURE 7
#define AM_KIND_TOY2 8

// AM_SHAPES(X): the (K, D) model-set shapes every kernel is instantiated
// for, generated at build time from automix_tpu_torch/kernels/_build.py
// SHAPES.
#include "am_shapes.h"

__device__ __forceinline__ uint32_t am_triple32(uint32_t x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

__device__ __forceinline__ uint32_t am_lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Per-(seed, sweep) salts of the word hash.
struct AmSalts {
  uint32_t s1, s2;
};

__device__ __forceinline__ AmSalts am_sweep_salts(uint32_t seed, uint32_t t) {
  AmSalts s;
  s.s1 = am_triple32(t ^ (seed * 0x9E3779B9u));
  s.s2 = am_lowbias32(t + 0x85EBCA6Bu + seed * 0xC2B2AE35u);
  return s;
}

// Word for counter c = chain * NW + slot (uint32 wrap-around intended).
__device__ __forceinline__ uint32_t am_word(AmSalts s, uint32_t c) {
  return am_triple32(c ^ s.s1) ^ am_lowbias32(c + s.s2);
}

// Top 24 bits plus half an ulp, clamped to the largest float below 1.
__device__ __forceinline__ float am_u01(uint32_t w) {
  float u = (float)(int)(w >> 8) * 5.9604644775390625e-08f
            + 2.98023223876953125e-08f;
  return fminf(u, 0.999999940395355224609375f);
}

__device__ __forceinline__ float am_gumbel(float u) {
  return -logf(-log1pf(-u) + 1e-38f);
}

// Student-t constants, float32 values folded on the host
// (ops/randoms.py StudentT): dof, -2/dof, (dof+1)/2, 1/dof, lt_const.
struct AmT {
  float dof, neg2_over_dof, half_dof1, inv_dof, lt_const;
};

// Bailey's polar t(dof) variate: sqrt(dof (u1^(-2/dof) - 1)) cos(2 pi u2).
__device__ __forceinline__ float am_bailey_t(float u1, float u2, AmT tc) {
  float r = sqrtf(tc.dof * (expf(tc.neg2_over_dof * logf(u1)) - 1.0f));
  return r * cosf(AM_TWO_PI * u2);
}

// Radius of the Box-Muller pair of u1 (the pair is r cos, r sin of 2 pi u2).
__device__ __forceinline__ float am_bm_radius(float u1) {
  return sqrtf(-2.0f * log1pf(-u1));
}

// Latent filler log-densities of the dimension-matching Jacobian.
__device__ __forceinline__ float am_normal_latent(float w) {
  return (-0.5f * w) * w - AM_HALF_LOG_2PI;
}

__device__ __forceinline__ float am_t_latent(float w, AmT tc) {
  return tc.lt_const - tc.half_dof1 * log1pf(w * w * tc.inv_dof);
}

__device__ __forceinline__ float am_logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float am_accept(float delta) {
  return expf(fminf(fmaxf(delta, AM_LOG_ACCEPT_CLAMP), 0.0f));
}

// Stage-1 batch-wide block coin: u < 0.1 as an integer compare.
__device__ __forceinline__ bool am_block_coin(uint32_t seed, uint32_t t) {
  uint32_t h = am_triple32((t * 2654435761u + seed) ^ 0xB5297A4Du);
  return (h >> 8) < 1677721u;  // int(0.1 * 2**24)
}

// gamma_t = (t + 1)^(-2/3), computed as exp(-2/3 * log(t + 1)).
__device__ __forceinline__ float am_gain(int t) {
  return expf((float)(-2.0 / 3.0) * logf((float)t + 1.0f));
}

__device__ __forceinline__ float am_pal_gammaln(float x) {
  float p = x * (x + 1.0f) * (x + 2.0f) * (x + 3.0f);
  float z = x + 4.0f;
  float r = 1.0f / z;
  float r2 = r * r;
  float series = r * ((float)(1.0 / 12.0)
                      + r2 * ((float)(-1.0 / 360.0)
                              + r2 * (float)(1.0 / 1260.0)));
  return (z - 0.5f) * logf(z) - z + AM_HALF_LOG_2PI + series - logf(p);
}

// Builtin column densities; c = (n, s1, s2, sl, sl1) of the data.
__device__ __forceinline__ float am_density_normal(const float* c, float sigma,
                                                   float x0) {
  const float n = c[0], s1 = c[1], s2 = c[2];
  bool ok = sigma > 0.0f;
  float ssafe = ok ? sigma : 1.0f;
  float ss = -(s2 - 2.0f * x0 * s1 + n * x0 * x0);
  float lp = -n * logf(ssafe) + ss / (2.0f * ssafe * ssafe);
  return ok ? lp : AM_NEG_INF;
}

__device__ __forceinline__ float am_density_beta(const float* c, float a,
                                                 float b) {
  const float n = c[0], sl = c[3], sl1 = c[4];
  bool ok = (a > 0.0f) && (b > 0.0f);
  float as = ok ? a : 1.0f;
  float bs = ok ? b : 1.0f;
  float lp = (as - 1.0f) * sl + (bs - 1.0f) * sl1
             + n * (am_pal_gammaln(as + bs) - am_pal_gammaln(as)
                    - am_pal_gammaln(bs));
  return ok ? lp : AM_NEG_INF;
}

__device__ __forceinline__ float am_density_gamma(const float* c, float a,
                                                  float b) {
  const float n = c[0], s1 = c[1], sl = c[3];
  bool ok = (a > 0.0f) && (b > 0.0f);
  float as = ok ? a : 1.0f;
  float bs = ok ? b : 1.0f;
  float lp = (as - 1.0f) * sl - bs * s1
             + n * (as * logf(bs) - am_pal_gammaln(as));
  return ok ? lp : AM_NEG_INF;
}

// 1-D direct samplers; c[0] of the Beta(2, 2) sampler is log 6.
__device__ __forceinline__ float am_density_normal_sampler(float x) {
  float d = x - 0.5f;
  return -0.5f * (d * d);
}

__device__ __forceinline__ float am_density_truncnormal_sampler(float x) {
  float d = x - 1.0f;
  float lp = -0.5f * (d * d);
  return (x > 0.0f && x < 10.0f) ? lp : AM_NEG_INF;
}

__device__ __forceinline__ float am_density_beta_sampler(const float* c,
                                                         float x) {
  bool inside = (x > 0.0f) && (x < 1.0f);
  float xs = inside ? x : 0.5f;
  float lp = logf(xs) + log1pf(-xs) + c[0];
  return inside ? lp : AM_NEG_INF;
}

// Normal mixture with lower-triangular factors (toy1, models/toy.py
// _mixture): c = [L, then per component: const, mu (d), each row i of the
// factor as B[i][0..i-1] followed by 1 / B[i][i]].  d <= 4 fits the slots.
// The row loops are unrolled to min(D, 4) (D the kernel's dmax), so that
// th[] and work[] are indexed by constants and stay in registers.
template <int D>
__device__ __forceinline__ float am_density_mixture(const float* c, int d,
                                                    const float* th) {
  constexpr int kRows = D < 4 ? D : 4;
  const int L = (int)c[0];
  const float* p = c + 1;
  float out = 0.0f;
  for (int li = 0; li < L; ++li) {
    const float cst = p[0];
    const float* mu = p + 1;
    const float* q = mu + d;
    float work[4];
    float quad = 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= d) break;
      float resid = th[i] - mu[i];
#pragma unroll
      for (int j = 0; j < i; ++j) resid = resid - q[j] * work[j];
      float wi = resid * q[i];
      work[i] = wi;
      quad = (i == 0) ? wi * wi : quad + wi * wi;
      q += i + 1;
    }
    float comp = cst - 0.5f * quad;
    out = (li == 0) ? comp : am_logaddexp(out, comp);
    p = q;
  }
  return out;
}

// toy2 model of dim d: c = (d log(2 pi) / 2, log 0.3, d log 2, log 0.7,
// log w_model).  Unrolled to D, as the mixture.
template <int D>
__device__ __forceinline__ float am_density_toy2(const float* c, int d,
                                                 const float* th) {
  float q1 = 0.0f, q2 = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i >= d) break;
    float a = th[i] - 5.0f;
    float b = th[i] + 5.0f;
    q1 = (i == 0) ? a * a : q1 + a * a;
    q2 = (i == 0) ? b * b : q2 + b * b;
  }
  float c1 = -0.5f * q1 - c[0] + c[1];
  float c2 = -0.125f * q2 - c[0] - c[2] + c[3];
  return am_logaddexp(c1, c2) + c[4];
}

// Sanitized log-posterior of a model of density ``kind`` and dimension
// ``dim`` <= D: NaN -> NEG_INF, clamp to [NEG_INF, -NEG_INF] (fmaxf also
// sends NaN to NEG_INF).
template <int D>
__device__ __forceinline__ float am_logpost(int kind, const float* c,
                                            int dim, const float* th) {
  float lp;
  switch (kind) {
    case AM_KIND_NORMAL_PARAMS: lp = am_density_normal(c, th[0], th[1]); break;
    case AM_KIND_BETA_PARAMS: lp = am_density_beta(c, th[0], th[1]); break;
    case AM_KIND_GAMMA_PARAMS: lp = am_density_gamma(c, th[0], th[1]); break;
    case AM_KIND_NORMAL_SAMPLER: lp = am_density_normal_sampler(th[0]); break;
    case AM_KIND_TRUNCNORMAL_SAMPLER:
      lp = am_density_truncnormal_sampler(th[0]);
      break;
    case AM_KIND_BETA_SAMPLER: lp = am_density_beta_sampler(c, th[0]); break;
    case AM_KIND_MIXTURE: lp = am_density_mixture<D>(c, dim, th); break;
    case AM_KIND_TOY2: lp = am_density_toy2<D>(c, dim, th); break;
    default: lp = AM_NEG_INF; break;
  }
  return fminf(fmaxf(lp, AM_NEG_INF), -AM_NEG_INF);
}
