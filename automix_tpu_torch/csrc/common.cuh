// Device functions shared by the stage-1 and stage-3 kernels.
//
// Counter hash, the stage-3 sweep's two word streams, uniforms, Gumbel,
// Box-Muller and Bailey polar t draws, the
// latent log-densities, the shifted Stirling log-gamma and the column
// densities of the ported problems, each in the operation order of its twin
// in the JAX package (automix_tpu/kernels/fused.py
// _triple32/_lowbias32/_u01/_gumbel/lat_lpdf/t_draw, automix_tpu/ops/
// plmath.py pal_gammaln, automix_tpu/models/builtin.py, toy.py and rb9.py
// column forms) and in this package's torch versions (ops/randoms.py,
// ops/plmath.py, models/builtin.py, models/toy.py, models/rb9.py,
// models/changepoint.py).
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

// Density kinds (automix_tpu_torch/models/builtin.py, toy.py, rb9.py,
// ddi.py and changepoint.py KIND_*).
#define AM_KIND_NORMAL_PARAMS 1
#define AM_KIND_BETA_PARAMS 2
#define AM_KIND_GAMMA_PARAMS 3
#define AM_KIND_NORMAL_SAMPLER 4
#define AM_KIND_TRUNCNORMAL_SAMPLER 5
#define AM_KIND_BETA_SAMPLER 6
#define AM_KIND_MIXTURE 7
#define AM_KIND_TOY2 8
#define AM_KIND_RB9 9
#define AM_KIND_DDI 10
#define AM_KIND_CPT 11
#define AM_KIND_CPTRS 12

// AM_SHAPES(X): the (K, D) model-set shapes every kernel is instantiated
// for, generated at build time from automix_tpu_torch/kernels/_build.py
// SHAPES.
#include "am_shapes.h"

// The rb9 family's data (per-group sufficient statistics, distinct counts
// and multiplicities, hyperparameters), generated at build time from
// automix_tpu_torch/models/rb9.py header().
#include "am_rb9.h"

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

// The stage-3 sweep's per-chain word streams, chosen by a run-time uniform
// ``rng`` (ops/randoms.py, whose hw_* functions are the twin):
//
// * AM_RNG_HASH: word = am_word(salts of (seed, sweep), chain * NW + slot),
//   a pure function of (seed, global sweep, chain, slot), bitwise the JAX
//   package's fused ``hash`` words.  ``st`` holds the chain's counter base.
// * AM_RNG_HW (K1f, in place of the TPU's hardware PRNG, which no GPU has):
//   ``st`` is a 64-bit PCG32 state, seeded at the launch's first sweep from
//   the hash words of (seed, sweep0) at counters 2 chain and 2 chain + 1 and
//   stepped once per sweep into a 32-bit key (XSH-RR of the old state); a
//   word is lowbias32(key ^ slot * 0x9E3779B9), ~10 operations against the
//   hash's ~23.  Like the TPU stream it is chunk-granular: a launch reseeds.
//
// A word stays a function of (its sweep's key or salts, slot), so the kernel
// computes each word where it uses it and reads a slot twice where it needs
// it twice, as it does with the hash, and keeps no sweep's words in
// registers.  The state keeps one 64-bit register pair per chain for both
// streams.
#define AM_RNG_HASH 0
#define AM_RNG_HW 1

__device__ __forceinline__ uint32_t am_hw_word(uint32_t key, uint32_t slot) {
  return am_lowbias32(key ^ (slot * 0x9E3779B9u));
}

// One sweep's words of one chain, by slot: hash (s1, s2 the sweep's salts,
// c the chain's counter base) or hw (s1 the sweep's key).
struct AmWords {
  uint32_t s1, s2, c;
  int rng;
  __device__ __forceinline__ uint32_t operator()(int slot) const {
    if (rng == AM_RNG_HW) return am_hw_word(s1, (uint32_t)slot);
    return am_word(AmSalts{s1, s2}, c + (uint32_t)slot);
  }
};

// The chain's stream state at the launch's first sweep ``sweep0``.
__device__ __forceinline__ uint64_t am_stream_init(int rng, uint32_t seed,
                                                   int sweep0, uint32_t chain,
                                                   uint32_t cbase) {
  if (rng != AM_RNG_HW) return cbase;
  const AmSalts s = am_sweep_salts(seed, (uint32_t)sweep0);
  return ((uint64_t)am_word(s, 2u * chain + 1u) << 32)
         | am_word(s, 2u * chain);
}

// The words of global sweep ``t``; advances a hw state by one sweep.
__device__ __forceinline__ AmWords am_stream_sweep(int rng, uint32_t seed,
                                                   int t, uint64_t& st) {
  if (rng == AM_RNG_HW) {
    const uint64_t old = st;
    st = old * 6364136223846793005ull + 1442695040888963407ull;
    const uint32_t x = (uint32_t)(((old >> 18) ^ old) >> 27);
    const uint32_t rot = (uint32_t)(old >> 59);
    return AmWords{(x >> rot) | (x << ((32u - rot) & 31u)), 0u, 0u, rng};
  }
  const AmSalts s = am_sweep_salts(seed, (uint32_t)t);
  return AmWords{s.s1, s.s2, (uint32_t)st, rng};
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

// The three densities above for a warp of the tutorial, which holds chains
// of all three kinds, without running each kind's code in turn: every lane
// takes one logf (Normal: of sigma; Gamma: of b) and one am_pal_gammaln (of
// a; Normal: of 1, unused), and the two that only Beta needs run where some
// lane of the warp holds a Beta chain (a vote).  Each kind then combines
// its values in the expression of its function above, so each density
// stays bit for bit what it was.
__device__ __forceinline__ float am_density_builtin(int kind, const float* c,
                                                    float t0, float t1) {
  const float n = c[0], s1 = c[1], s2 = c[2], sl = c[3], sl1 = c[4];
  const bool normal = kind == AM_KIND_NORMAL_PARAMS;
  const bool beta = kind == AM_KIND_BETA_PARAMS;
  const bool ok = (t0 > 0.0f) && (normal || t1 > 0.0f);
  const float as = ok ? t0 : 1.0f;     // Normal: sigma, sanitized
  const float bs = ok ? t1 : 1.0f;
  const float lx = logf(normal ? as : bs);
  const float ga = am_pal_gammaln(normal ? 1.0f : as);
  float gab = 0.0f, gb = 0.0f;
  if (__any_sync(__activemask(), beta)) {
    gab = am_pal_gammaln(as + bs);
    gb = am_pal_gammaln(bs);
  }
  float lp;
  if (normal) {
    const float x0 = t1;
    float ss = -(s2 - 2.0f * x0 * s1 + n * x0 * x0);
    lp = -n * lx + ss / (2.0f * as * as);
  } else if (beta) {
    lp = (as - 1.0f) * sl + (bs - 1.0f) * sl1 + n * (gab - ga - gb);
  } else {
    lp = (as - 1.0f) * sl - bs * s1 + n * (as * lx - ga);
  }
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

// The rb9 density's support substitution and prior (models/rb9.py
// family_cols): ths and lth hold theta's first d coordinates and their
// logs (1 and 0 past d and where a coordinate is not positive), lp the
// prior; false out of support.  c = (ql, qk, the 4 groups' rate indices,
// their dispersion indices, their NB flags, the prior constant).
template <int D>
__device__ __forceinline__ bool am_rb9_support_prior(const float* c, int d,
                                                     const float* th,
                                                     float* ths, float* lth,
                                                     float& lp) {
  const int ql = (int)c[0];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const bool in = i < d;
    const bool pos = th[i] > 0.0f;
    ok = ok && (pos || !in);
    ths[i] = (pos && in) ? th[i] : 1.0f;
    lth[i] = in ? logf(ths[i]) : 0.0f;
  }
  lp = c[14];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i >= d) break;
    const float a = i < ql ? AM_RB9_ALPHA1 : AM_RB9_ALPHA2;
    const float b = i < ql ? AM_RB9_BETA1 : AM_RB9_BETA2;
    lp = lp + (a - 1.0f) * lth[i];
    lp = lp - b * ths[i];
  }
  return ok;
}

// km1 = 1 / max(kappa, 1e-30) and the bracket km1 log km1 -
// pal_gammaln(km1) of an over-dispersion kappa.
__device__ __forceinline__ void am_rb9_kappa(float kap, float& km1,
                                             float& br) {
  km1 = 1.0f / fmaxf(kap, 1e-30f);
  br = km1 * logf(km1) - am_pal_gammaln(km1);
}

// lp plus group g's term at (ths, lth): Poisson in its rate, or where the
// model makes the group Negative-Binomial, the term of its rate and its
// over-dispersion kappa.  ``kappa(kap, km1, br)`` gives its km1 and
// bracket (am_rb9_kappa); ``counts(nb, km1)`` adds the group's
// pal_gammaln(v + km1) weighted by multiplicity, in its ascending order of
// distinct counts v.
template <int D, typename Kappa, typename Counts>
__device__ __forceinline__ float am_rb9_group(float lp, const float* c, int g,
                                              const float* ths,
                                              const float* lth, Kappa kappa,
                                              Counts counts) {
  const int li = (int)c[2 + g], ki = (int)c[6 + g];
  float lam = 1.0f, llam = 0.0f, kap = 1.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i == li) {
      lam = ths[i];
      llam = lth[i];
    }
    if (i == ki) kap = ths[i];
  }
  const float n = am_rb9_n[g], sx = am_rb9_sx[g];
  const float base = sx * llam - am_rb9_clg[g];
  if (c[10 + g] != 0.0f) {
    float km1, br;
    kappa(kap, km1, br);
    float nb = base + n * br;
    nb = nb - (sx + n * km1) * logf(lam + km1);
    return lp + counts(nb, km1);
  }
  return lp + (base - n * lam);
}

// rb9 model of dimension d (models/rb9.py family_cols), evaluated for the
// chain's own model only: the one-hot mask sums of the family form equal
// this select bit for bit, and every term of another model is an exact
// zero there.  Every thread of a warp walks the same group and
// distinct-count loops, so the am_rb9.h tables read as broadcasts.  Out of
// support: -1e6, as in the family form.
template <int D>
__device__ __forceinline__ float am_density_rb9(const float* c, int d,
                                                const float* th) {
  float ths[D], lth[D], lp;
  const bool ok = am_rb9_support_prior<D>(c, d, th, ths, lth, lp);
#pragma unroll
  for (int g = 0; g < AM_RB9_G; ++g) {
    lp = am_rb9_group<D>(
        lp, c, g, ths, lth,
        [](float kap, float& km1, float& br) { am_rb9_kappa(kap, km1, br); },
        [g](float nb, float km1) {
          for (int j = am_rb9_off[g]; j < am_rb9_off[g + 1]; ++j)
            nb = nb + am_rb9_cnt[j] * am_pal_gammaln(am_rb9_val[j] + km1);
          return nb;
        });
  }
  return ok ? lp : -1e6f;
}

// The rb9 density in the stage-3 sweep kernel at rb9's shape, with the
// chain's table of what depends on an over-dispersion kappa alone: for
// km1 = 1 / max(kappa, 1e-30), km1, km1 log km1 - pal_gammaln(km1) and
// pal_gammaln(v + km1) for the AM_RB9_NV distinct counts v of all groups
// (am_rb9_tv, models/rb9.py table_layout), keyed by kappa's bits.  A
// coordinate move of a rate leaves kappa as it was, so most evaluations
// read the table instead of running every Negative-Binomial group's
// pal_gammaln loop; a miss fills all of it once for every group, whatever
// groups the lane's model reads, so a warp of mixed models runs one fill.
//
// The table lives in the thread's column of shared memory ([slot][thread]
// with stride S: a warp's 32 accesses to one slot hit 32 banks), as two
// full tables A0, A1 for the kappa that group 0 reads (every group but
// AM_RB9_G2 reads it in every model) and two tables B0, B1 of the first
// AM_RB9_NV2 values (group AM_RB9_G2's counts come first) for the second
// kappa that group AM_RB9_G2 reads in one model (model 6).  A table is
// [key, km1, the bracket, values].  A lookup compares the key's bits with
// both tables'; on a miss it fills the table that does not hold the current
// state's kappa, so the current one survives a rejected candidate.  The key
// is compared at every evaluation: the accept blend th + acc (prop - th)
// need not equal prop bit for bit.  Every value is what am_density_rb9
// computes for the same kappa, and each group adds its terms in the same
// order, so the density is am_density_rb9's bit for bit.  Keys start as NaN
// bits, which match nothing.
#define AM_RB9_TAB_A (3 + AM_RB9_NV)
#define AM_RB9_TAB_B (3 + AM_RB9_NV2)
#define AM_RB9_TAB (2 * AM_RB9_TAB_A + 2 * AM_RB9_TAB_B)
// A fill computes AM_RB9_FILL_STEP values at once (models/rb9.py
// FILL_STEP, independent pal_gammaln chains), which divides both tables.
static_assert(AM_RB9_NV % AM_RB9_FILL_STEP == 0 &&
              AM_RB9_NV2 % AM_RB9_FILL_STEP == 0, "fill step");

// Empty tables: every key NaN.
template <int S>
__device__ __forceinline__ void am_rb9_tab_clear(float* col) {
  const float nan = __uint_as_float(0x7fffffffu);
  col[0] = nan;
  col[AM_RB9_TAB_A * S] = nan;
  col[2 * AM_RB9_TAB_A * S] = nan;
  col[(2 * AM_RB9_TAB_A + AM_RB9_TAB_B) * S] = nan;
}

// The bits of the two kappas of rb9 model consts ``c`` at theta ``th``,
// after the density's positivity substitution.
template <int D>
__device__ __forceinline__ void am_rb9_keys(const float* c, const float* th,
                                            uint32_t& ka, uint32_t& kb) {
  const int ia = (int)c[6], ib = (int)c[6 + AM_RB9_G2];
  float a = 1.0f, b = 1.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float v = th[i] > 0.0f ? th[i] : 1.0f;
    if (i == ia) a = v;
    if (i == ib) b = v;
  }
  ka = __float_as_uint(a);
  kb = __float_as_uint(b);
}

// The table of t0 and t1 that holds ``key``; on a miss (``miss``) the one
// to fill, which is not the one holding ``cur``.
__device__ __forceinline__ float* am_rb9_pick(float* t0, float* t1,
                                              uint32_t key, uint32_t cur,
                                              bool& miss) {
  const uint32_t k0 = __float_as_uint(t0[0]), k1 = __float_as_uint(t1[0]);
  miss = k0 != key && k1 != key;
  if (k0 == key) return t0;
  if (k1 == key) return t1;
  return k0 == cur ? t1 : t0;
}

// Fill table ``t`` for kappa ``kap``: its key, km1, the bracket and the
// first ``n`` values, AM_RB9_FILL_STEP at a time.
template <int S>
__device__ __forceinline__ void am_rb9_fill(float* t, float kap, int n) {
  float km1, br;
  am_rb9_kappa(kap, km1, br);
  t[0] = kap;
  t[S] = km1;
  t[2 * S] = br;
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += AM_RB9_FILL_STEP) {
    float g[AM_RB9_FILL_STEP];
#pragma unroll
    for (int p = 0; p < AM_RB9_FILL_STEP; ++p)
      g[p] = am_pal_gammaln(am_rb9_tv[j0 + p] + km1);
#pragma unroll
    for (int p = 0; p < AM_RB9_FILL_STEP; ++p) t[(3 + j0 + p) * S] = g[p];
  }
}

// nb plus group g's multiplicity-weighted values of table values ``v``, in
// the group's ascending order of counts (AM_RB9_READS).
template <int g, int S>
__device__ __forceinline__ float am_rb9_counts(float nb, const float* v) {
#define AM_RB9_READ(gg, slot, cnt) \
  if constexpr ((gg) == g) nb = nb + (cnt) * v[(slot) * S];
  AM_RB9_READS(AM_RB9_READ)
#undef AM_RB9_READ
  return nb;
}

// am_rb9_group with its kappa's km1, bracket and values read from table
// ``t``.
template <int g, int D, int S>
__device__ __forceinline__ float am_rb9_group_tab(float lp, const float* c,
                                                  const float* ths,
                                                  const float* lth,
                                                  const float* t) {
  return am_rb9_group<D>(
      lp, c, g, ths, lth,
      [t](float, float& km1, float& br) {
        km1 = t[S];
        br = t[2 * S];
      },
      [t](float nb, float) { return am_rb9_counts<g, S>(nb, t + 3 * S); });
}

// am_density_rb9 of the model with consts ``c`` and dimension d at ``th``
// through the chain's table (its column ``col``, stride S); ``cur_a`` and
// ``cur_b`` are the current state's kappa keys (am_rb9_keys).
template <int D, int S>
__device__ __forceinline__ float am_density_rb9_tab(const float* c, int d,
                                                    const float* th,
                                                    float* col,
                                                    uint32_t cur_a,
                                                    uint32_t cur_b) {
  static_assert(AM_RB9_G == 4, "am_density_rb9_tab adds four groups");
  float ths[D], lth[D], lp;
  if (!am_rb9_support_prior<D>(c, d, th, ths, lth, lp)) return -1e6f;
  uint32_t ka, kb;
  am_rb9_keys<D>(c, ths, ka, kb);
  const bool two = (int)c[6 + AM_RB9_G2] != (int)c[6];
  bool ma, mb;
  float* ta = am_rb9_pick(col, col + AM_RB9_TAB_A * S, ka, cur_a, ma);
  float* tb = ta;
  if (two) {
    tb = am_rb9_pick(col + 2 * AM_RB9_TAB_A * S,
                     col + (2 * AM_RB9_TAB_A + AM_RB9_TAB_B) * S, kb, cur_b,
                     mb);
  } else {
    mb = false;
  }
  // one fill for a lane with one miss, two for a lane with both: a warp
  // whose lanes miss different tables fills them together
#pragma unroll 1
  while (ma || mb) {
    const bool a = ma;
    am_rb9_fill<S>(a ? ta : tb, __uint_as_float(a ? ka : kb),
                   a ? AM_RB9_NV : AM_RB9_NV2);
    if (a) ma = false;
    else mb = false;
  }
  lp = am_rb9_group_tab<0, D, S>(lp, c, ths, lth, AM_RB9_G2 == 0 ? tb : ta);
  lp = am_rb9_group_tab<1, D, S>(lp, c, ths, lth, AM_RB9_G2 == 1 ? tb : ta);
  lp = am_rb9_group_tab<2, D, S>(lp, c, ths, lth, AM_RB9_G2 == 2 ? tb : ta);
  lp = am_rb9_group_tab<3, D, S>(lp, c, ths, lth, AM_RB9_G2 == 3 ? tb : ta);
  return lp;
}

// The DDI family's statistics and log-posterior (models/ddi_cols.py), fed
// by the generated am_ddi.h.
#include "ddi.cuh"

// The change-point family's log-posterior (models/changepoint.py), fed by
// the generated am_cpt.h.
#include "changepoint.cuh"

// Sanitized log-posterior of a model of density ``kind`` and dimension
// ``dim`` <= D in a (K, D) model set: NaN -> NEG_INF, clamp to
// [NEG_INF, -NEG_INF] (fmaxf also sends NaN to NEG_INF).  The rb9, DDI
// and change-point densities are compiled into their families' own shapes
// only: inlined into every instantiation, rb9's raised the tutorial's sweep
// kernel from 64 to 72 registers and slowed it by a quarter.  The DDI case
// evaluates the statistics from scratch (c[0] is the model's index;
// already sanitized), ahead of the switch so that the other shapes' switch
// stays as it was: as one more case of it, it made the tutorial's stage-1
// segment kernel 15% slower.  The stage-3 sweep carries the statistics instead
// (fused_sweep.cu, kCache), and the segment kernel reads a shared copy of
// the tables (fused_stage1.cu, which leaves this case out with kDdi false).
// With kBuiltin (the stage-3 sweep kernel at its small shapes) kinds 1-3
// take am_density_builtin: in the sweep kernel at the change-point shape
// its warp vote made cptrs' per-chain forms twice as slow (PERF.md section
// 6), and the stage-1 kernels at the tutorial's shape took 80 registers
// with it instead of 64.  Without kRb9 (the stage-3 sweep kernel at rb9's
// shape, which evaluates rb9 through its kappa tables, am_density_rb9_tab)
// the rb9 case is left out.
template <int K, int D, bool kDdi = true, bool kBuiltin = false,
          bool kRb9 = true>
__device__ __forceinline__ float am_logpost(int kind, const float* c,
                                            int dim, const float* th) {
  if constexpr (kDdi && K == AM_DDI_K && D == AM_DDI_D) {
    if (kind == AM_KIND_DDI)
      return (c[0] == 0.0f) ? am_ddi_logpost<0>(th) : am_ddi_logpost<1>(th);
  }
  float lp;
  if (kBuiltin && kind >= AM_KIND_NORMAL_PARAMS
      && kind <= AM_KIND_GAMMA_PARAMS) {
    lp = am_density_builtin(kind, c, th[0], th[1]);
  } else {
    switch (kind) {
      case AM_KIND_NORMAL_PARAMS:
        lp = am_density_normal(c, th[0], th[1]);
        break;
      case AM_KIND_BETA_PARAMS: lp = am_density_beta(c, th[0], th[1]); break;
      case AM_KIND_GAMMA_PARAMS:
        lp = am_density_gamma(c, th[0], th[1]);
        break;
      case AM_KIND_NORMAL_SAMPLER:
        lp = am_density_normal_sampler(th[0]);
        break;
      case AM_KIND_TRUNCNORMAL_SAMPLER:
        lp = am_density_truncnormal_sampler(th[0]);
        break;
      case AM_KIND_BETA_SAMPLER:
        lp = am_density_beta_sampler(c, th[0]);
        break;
      case AM_KIND_MIXTURE: lp = am_density_mixture<D>(c, dim, th); break;
      case AM_KIND_TOY2: lp = am_density_toy2<D>(c, dim, th); break;
      case AM_KIND_RB9:
        if constexpr (kRb9 && K == AM_RB9_K && D == AM_RB9_D)
          lp = am_density_rb9<D>(c, dim, th);
        else
          lp = AM_NEG_INF;
        break;
      case AM_KIND_CPT:
      case AM_KIND_CPTRS:
        if constexpr (K == AM_CPT_K && D == AM_CPT_D)
          lp = am_density_cpt<D>(kind - AM_KIND_CPT, c, th);
        else
          lp = AM_NEG_INF;
        break;
      default: lp = AM_NEG_INF; break;
    }
  }
  return fminf(fmaxf(lp, AM_NEG_INF), -AM_NEG_INF);
}
