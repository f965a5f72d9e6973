// Stage-3 reversible-jump sweep kernel: a whole chunk of sweeps per chain.
//
// Replaces the Pallas kernel of automix_tpu/kernels/fused.py
// (build_fused_chunk_runner._built -> kernel, pallas_call at line 859)
// with per-chain pk, stateless column densities and counter-hash
// randomness, in four variants: Normal or Student-t perturbations
// (AM_TDIST: Bailey polar draws and the t latent density) and with or
// without the latent permutation (AM_PERM: the stable bubble network over
// per-slot uniform keys).  Each variant is its own compilation unit and
// exports its launcher as AM_K1_SYMBOL.  The plain PyTorch twin is
// automix_tpu_torch/kernels/fused.py:sweep_chunk_ref.
//
// Layout: one thread per chain.  The chain's state (k, theta, logp, pk,
// pkllim, nreinit) and its chunk statistics stay in registers for the whole
// chunk; device memory sees one read and one write of the state per chunk.
// The proposal tables (K*L*(2D^2+D+3)+K*D floats, under 38 KB at K = D = 5
// and L = 32) are copied to shared memory once per block.
//
// What bounds it on the H100: arithmetic, not bytes.  A chain-sweep reads
// and writes nothing in device memory and costs ~NW hash words (NW = 3D+1+
// 2L+K, plus D with perm and 2D with Student-t), ~2L+K+4 logf/expf/log1pf,
// a few cosf/sinf and 2L small triangular matvecs.  Unlike the TPU kernel,
// which evaluates every model and every (model, component) residual on
// every lane and mask-selects because lanes cannot branch, a thread
// branches: it loops over its own model's L components for the forward
// allocation and the destination model's for the reverse one, recomputes
// the selected component's residual instead of keeping K*L*D of them,
// evaluates only its own model's density, and computes each random word
// when it is used.  Densities are sanitized to finite values, so the TPU
// kernel's 0*x + 1*y mask sums equal the directly selected y; its accept
// blends x + a*(y - x) are kept as blends, since they are not always equal
// to a select in floating point.  The variant switches are compile-time
// constants, so the main-path variant carries no Student-t or perm code.
//
// Floating point: see common.cuh (built with -fmad=false, no fast math).

#include <cuda_runtime.h>

#include "common.cuh"

#ifndef AM_PERM
#define AM_PERM 0
#endif
#ifndef AM_TDIST
#define AM_TDIST 0
#endif
#ifndef AM_K1_SYMBOL
#define AM_K1_SYMBOL am_fused_sweep_p0_t0
#endif

namespace {

constexpr int kLMax = 32;        // mixture components per model (runtime L)
constexpr int kThreads = 128;
constexpr bool kPerm = AM_PERM != 0;
constexpr bool kTdist = AM_TDIST != 0;

template <int K, int D>
__global__ void __launch_bounds__(kThreads) fused_sweep_kernel(
    int S, int L, uint32_t seed, int sweep0, int n_sweeps, int adapt, AmT tc,
    const float* __restrict__ tab, const int* __restrict__ kinds_g,
    const float* __restrict__ consts_g, const int* __restrict__ dims_g,
    const int* __restrict__ k_in, const float* __restrict__ th_in,
    const float* __restrict__ lp_in, const float* __restrict__ pk_in,
    const float* __restrict__ pkl_in, const int* __restrict__ nri_in,
    int* __restrict__ k_out, float* __restrict__ th_out,
    float* __restrict__ lp_out, float* __restrict__ pk_out,
    float* __restrict__ pkl_out, int* __restrict__ nri_out,
    int* __restrict__ ks_out, float* __restrict__ ts_out,
    float* __restrict__ tq_out, int* __restrict__ cnt_out) {
  // ---- tables -> shared memory ------------------------------------------
  // tab = [sig K*D | loglam K*L | abase K*L | logdet K*L | mu K*L*D |
  //        binv K*L*D*D | B K*L*D*D]
  extern __shared__ float smem[];
  __shared__ float consts_s[K * AM_N_CONSTS];
  __shared__ int kinds_s[K];
  __shared__ int dims_s[K];
  const int KL = K * L;
  const int n_tab = K * D + 3 * KL + KL * D + 2 * KL * D * D;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) smem[i] = tab[i];
  for (int i = threadIdx.x; i < K * AM_N_CONSTS; i += blockDim.x)
    consts_s[i] = consts_g[i];
  for (int m = threadIdx.x; m < K; m += blockDim.x) {
    kinds_s[m] = kinds_g[m];
    dims_s[m] = dims_g[m];
  }
  __syncthreads();
  const float* sig = smem;
  const float* loglam = sig + K * D;
  const float* abase = loglam + KL;
  const float* logdet = abase + KL;
  const float* mu = logdet + KL;
  const float* binv = mu + KL * D;
  const float* Bm = binv + KL * D * D;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;

  // ---- chain state into registers -----------------------------------------
  int kk = k_in[i];
  float th[D];
#pragma unroll
  for (int d = 0; d < D; ++d) th[d] = th_in[d * S + i];
  float lp = lp_in[i];
  float pk[K];
#pragma unroll
  for (int m = 0; m < K; ++m) pk[m] = pk_in[m * S + i];
  float pkl = pkl_in[i];
  int nri = nri_in[i];
  int ks[K];
  float ts[K * D], tq[K * D];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    ks[m] = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ts[m * D + d] = 0.0f;
      tq[m * D + d] = 0.0f;
    }
  }
  int cnt[6] = {0, 0, 0, 0, 0, 0};

  // Random word slots of one sweep (kernels/fused.py s_* offsets):
  // D accept words, the RJ accept, L + K + L Gumbel words, D permutation
  // keys with perm, then the perturbation words: D Box-Muller pairs (cos
  // for the RWM move, sin for the latent) or, with Student-t, one Bailey
  // pair each for the RWM move and the latent.
  const int s_uacc = D, s_gall = D + 1, s_gmod = D + 1 + L;
  const int s_gcmp = D + 1 + L + K, s_perm = D + 1 + 2 * L + K;
  const int s_bm = s_perm + (kPerm ? D : 0);
  const int NW = s_bm + (kTdist ? 4 * D : 2 * D);
  const uint32_t cbase = (uint32_t)i * (uint32_t)NW;
  // RWM perturbation and latent filler of coordinate d this sweep
  auto z_rwm = [&](const AmSalts& sa, int d) {
    float u1 = am_u01(am_word(sa, cbase + s_bm + d));
    float u2 = am_u01(am_word(sa, cbase + s_bm + D + d));
    if (kTdist) return am_bailey_t(u1, u2, tc);
    return am_bm_radius(u1) * cosf(AM_TWO_PI * u2);
  };
  auto z_lat = [&](const AmSalts& sa, int d) {
    if (kTdist)
      return am_bailey_t(am_u01(am_word(sa, cbase + s_bm + 2 * D + d)),
                         am_u01(am_word(sa, cbase + s_bm + 3 * D + d)), tc);
    float u1 = am_u01(am_word(sa, cbase + s_bm + d));
    float u2 = am_u01(am_word(sa, cbase + s_bm + D + d));
    return am_bm_radius(u1) * sinf(AM_TWO_PI * u2);
  };
  auto lat_lpdf = [&](float w) {
    return kTdist ? am_t_latent(w, tc) : am_normal_latent(w);
  };

  float logits[kLMax];

  for (int tr = 0; tr < n_sweeps; ++tr) {
    const int t = sweep0 + tr;
    const AmSalts sa = am_sweep_salts(seed, (uint32_t)t);
    const int dk = dims_s[kk];

    // ---- (a) within-model move: block every 10th sweep, else per coord --
    if (t % 10 == 0) {
      float prop[D];
#pragma unroll
      for (int d = 0; d < D; ++d)
        prop[d] = (d < dk) ? th[d] + sig[kk * D + d] * z_rwm(sa, d) : th[d];
      float lpn =
          am_logpost<D>(kinds_s[kk], consts_s + kk * AM_N_CONSTS, dk, prop);
      float acc = (am_u01(am_word(sa, cbase)) < am_accept(lpn - lp)) ? 1.0f
                                                                      : 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) th[d] = th[d] + acc * (prop[d] - th[d]);
      lp = lp + acc * (lpn - lp);
      cnt[0] += (int)acc;
      cnt[1] += 1;
    } else {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (j >= dk) continue;
        float prop[D];
#pragma unroll
        for (int d = 0; d < D; ++d) prop[d] = th[d];
        prop[j] = th[j] + sig[kk * D + j] * z_rwm(sa, j);
        float lpn =
            am_logpost<D>(kinds_s[kk], consts_s + kk * AM_N_CONSTS, dk, prop);
        float acc = (am_u01(am_word(sa, cbase + j)) < am_accept(lpn - lp))
                        ? 1.0f
                        : 0.0f;
        th[j] = th[j] + acc * (prop[j] - th[j]);
        lp = lp + acc * (lpn - lp);
        cnt[2] += (int)acc;
        cnt[3] += 1;
      }
    }

    // ---- (b) reversible jump ---------------------------------------------
    // forward allocation over the chain's own model's components
    for (int li = 0; li < L; ++li) {
      const int ml = kk * L + li;
      float quad = 0.0f;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r >= dk) break;
        float w = binv[ml * D * D + r * D] * (th[0] - mu[ml * D]);
#pragma unroll
        for (int c = 1; c <= r; ++c)
          w = w + binv[ml * D * D + r * D + c] * (th[c] - mu[ml * D + c]);
        quad = (r == 0) ? w * w : quad + w * w;
      }
      logits[li] = abase[ml] - 0.5f * quad;
    }
    int l_idx = 0;
    float best = logits[0] + am_gumbel(am_u01(am_word(sa, cbase + s_gall)));
    float mx = logits[0];
    for (int li = 1; li < L; ++li) {
      float v = logits[li]
                + am_gumbel(am_u01(am_word(sa, cbase + s_gall + li)));
      if (v > best) {
        best = v;
        l_idx = li;
      }
      mx = fmaxf(mx, logits[li]);
    }
    float se = expf(logits[0] - mx);
    for (int li = 1; li < L; ++li) se = se + expf(logits[li] - mx);
    const float log_palloc = logits[l_idx] - (mx + logf(se));

    // standardized residual of the selected component (recomputed)
    float work[D];
    {
      const int ml = kk * L + l_idx;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r < dk) {
          float w = binv[ml * D * D + r * D] * (th[0] - mu[ml * D]);
#pragma unroll
          for (int c = 1; c <= r; ++c)
            w = w + binv[ml * D * D + r * D + c] * (th[c] - mu[ml * D + c]);
          work[r] = w;
        } else {
          work[r] = 0.0f;
        }
      }
    }

    // destination model kn ~ pk (Gumbel argmax, strict > keeps the first)
    int kn = kk;
    float logratio = 0.0f;
    if (K > 1) {
      float logpk[K];
#pragma unroll
      for (int m = 0; m < K; ++m) logpk[m] = logf(fmaxf(pk[m], 1e-38f));
      float bk = logpk[0] + am_gumbel(am_u01(am_word(sa, cbase + s_gmod)));
      kn = 0;
#pragma unroll
      for (int m = 1; m < K; ++m) {
        float v = logpk[m]
                  + am_gumbel(am_u01(am_word(sa, cbase + s_gmod + m)));
        if (v > bk) {
          bk = v;
          kn = m;
        }
      }
      float lpk_k = 0.0f, lpk_kn = 0.0f;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (m == kk) lpk_k = logpk[m];
        if (m == kn) lpk_kn = logpk[m];
      }
      logratio = lpk_k - lpk_kn;
    }
    const int dkn = dims_s[kn];

    // destination component ln ~ lam[kn]
    int ln = 0;
    {
      float bl = loglam[kn * L] + am_gumbel(am_u01(am_word(sa, cbase + s_gcmp)));
      for (int li = 1; li < L; ++li) {
        float v = loglam[kn * L + li]
                  + am_gumbel(am_u01(am_word(sa, cbase + s_gcmp + li)));
        if (v > bl) {
          bl = v;
          ln = li;
        }
      }
    }

    // latent dimension matching: coordinates the chain's model lacks are
    // filled with latent draws; the "grow" density reads the latent before
    // the permutation, the "shrink" density after it
    float wf[D];
#pragma unroll
    for (int d = 0; d < D; ++d) wf[d] = (d < dk) ? work[d] : z_lat(sa, d);
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d >= dk && d < dkn) logratio = logratio - lat_lpdf(wf[d]);
    if (kPerm) {
      // random permutation of the first max(dk, dkn) latent slots: a
      // stable bubble network over per-slot uniform keys, inactive slots
      // keyed 1 + d (D passes of D - 1 compare-swaps, as in the TPU kernel)
      const int nact = dk > dkn ? dk : dkn;
      float keys[D];
#pragma unroll
      for (int d = 0; d < D; ++d)
        keys[d] = (d < nact) ? am_u01(am_word(sa, cbase + s_perm + d))
                             : 1.0f + (float)d;
#pragma unroll
      for (int pass = 0; pass < D; ++pass) {
#pragma unroll
        for (int j = 0; j < D - 1; ++j) {
          if (keys[j] > keys[j + 1]) {
            const float kt = keys[j];
            keys[j] = keys[j + 1];
            keys[j + 1] = kt;
            const float wt = wf[j];
            wf[j] = wf[j + 1];
            wf[j + 1] = wt;
          }
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < dk && d >= dkn) logratio = logratio + lat_lpdf(wf[d]);

    // de-standardize into the destination model
    float thn[D];
    {
      const int mln = kn * L + ln;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r < dkn) {
          float a = mu[mln * D + r];
#pragma unroll
          for (int c = 0; c <= r; ++c) a = a + Bm[mln * D * D + r * D + c] * wf[c];
          thn[r] = a;
        } else {
          thn[r] = 0.0f;
        }
      }
    }

    // reverse allocation over the destination model's components
    for (int li = 0; li < L; ++li) {
      const int ml = kn * L + li;
      float quad = 0.0f;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        if (r >= dkn) break;
        float w = binv[ml * D * D + r * D] * (thn[0] - mu[ml * D]);
#pragma unroll
        for (int c = 1; c <= r; ++c)
          w = w + binv[ml * D * D + r * D + c] * (thn[c] - mu[ml * D + c]);
        quad = (r == 0) ? w * w : quad + w * w;
      }
      logits[li] = abase[ml] - 0.5f * quad;
    }
    float mxn = logits[0];
    for (int li = 1; li < L; ++li) mxn = fmaxf(mxn, logits[li]);
    float sen = expf(logits[0] - mxn);
    for (int li = 1; li < L; ++li) sen = sen + expf(logits[li] - mxn);
    const float log_pallocn = logits[ln] - (mxn + logf(sen));

    // MH accept
    const float lpn =
        am_logpost<D>(kinds_s[kn], consts_s + kn * AM_N_CONSTS, dkn, thn);
    logratio = logratio + (lpn - lp);
    logratio = logratio + (log_pallocn - log_palloc);
    logratio = logratio + (loglam[kk * L + l_idx] - loglam[kn * L + ln]);
    logratio = logratio + (logdet[kn * L + ln] - logdet[kk * L + l_idx]);
    const float accf =
        (am_u01(am_word(sa, cbase + s_uacc)) < am_accept(logratio)) ? 1.0f
                                                                     : 0.0f;
    const int acci = (int)accf;
    kk = kk + acci * (kn - kk);
#pragma unroll
    for (int d = 0; d < D; ++d) th[d] = th[d] + accf * (thn[d] - th[d]);
    lp = lp + accf * (lpn - lp);

    // ---- (c) pk diminishing adaptation with the re-init safeguard --------
    if (adapt && K > 1) {
      const float gamma = am_gain(t);
      float newpk[K];
      bool reinit = false;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        float oh = (kk == m) ? 1.0f : 0.0f;
        newpk[m] = pk[m] + gamma * (oh - pk[m]);
        reinit = reinit || (newpk[m] < pkl);
      }
      nri += reinit ? 1 : 0;
      if (reinit) pkl = 1.0f / (10.0f * (float)nri);
      const float rf = reinit ? 1.0f : 0.0f;
#pragma unroll
      for (int m = 0; m < K; ++m)
        pk[m] = newpk[m] + rf * ((float)(1.0 / K) - newpk[m]);
    }

    // ---- chunk statistics -------------------------------------------------
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (m != kk) continue;
      ks[m] += 1;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        ts[m * D + d] = ts[m * D + d] + th[d];
        tq[m * D + d] = tq[m * D + d] + th[d] * th[d];
      }
    }
    cnt[4] += acci;
    cnt[5] += 1;
  }

  // ---- state and per-chain statistics out -----------------------------------
  k_out[i] = kk;
#pragma unroll
  for (int d = 0; d < D; ++d) th_out[d * S + i] = th[d];
  lp_out[i] = lp;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    pk_out[m * S + i] = pk[m];
    ks_out[m * S + i] = ks[m];
  }
  pkl_out[i] = pkl;
  nri_out[i] = nri;
#pragma unroll
  for (int j = 0; j < K * D; ++j) {
    ts_out[j * S + i] = ts[j];
    tq_out[j * S + i] = tq[j];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) cnt_out[c * S + i] = cnt[c];
}

template <int K, int D>
int launch_sweep(int S, int L, unsigned int seed, int sweep0, int n_sweeps,
                 int adapt, AmT tc, const void* tab, const void* kinds,
                 const void* consts, const void* dims, const void* k_in,
                 const void* th_in, const void* lp_in, const void* pk_in,
                 const void* pkl_in, const void* nri_in, void* k_out,
                 void* th_out, void* lp_out, void* pk_out, void* pkl_out,
                 void* nri_out, void* ks_out, void* ts_out, void* tq_out,
                 void* cnt_out, cudaStream_t st) {
  const int KL = K * L;
  const size_t smem =
      sizeof(float) * (size_t)(K * D + 3 * KL + KL * D + 2 * KL * D * D);
  cudaError_t e = cudaFuncSetAttribute(
      fused_sweep_kernel<K, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kThreads - 1) / kThreads);
  fused_sweep_kernel<K, D><<<grid, kThreads, smem, st>>>(
      S, L, seed, sweep0, n_sweeps, adapt, tc, (const float*)tab,
      (const int*)kinds, (const float*)consts, (const int*)dims,
      (const int*)k_in, (const float*)th_in, (const float*)lp_in,
      (const float*)pk_in, (const float*)pkl_in, (const int*)nri_in,
      (int*)k_out, (float*)th_out, (float*)lp_out, (float*)pk_out,
      (float*)pkl_out, (int*)nri_out, (int*)ks_out, (float*)ts_out,
      (float*)tq_out, (int*)cnt_out);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef __CUDACC__
// Launch on ``stream``; returns cudaGetLastError() after the launch, or -1
// for a (K, D) pair without an instantiation or an L above kLMax.
// ``tconsts`` is a host array of the five Student-t constants (AmT); the
// Normal variants ignore it.
extern "C" int AM_K1_SYMBOL(
    int K, int D, int S, int L, unsigned int seed, int sweep0, int n_sweeps,
    int adapt, const float* tconsts, const void* tab, const void* kinds,
    const void* consts, const void* dims, const void* k_in,
    const void* th_in, const void* lp_in, const void* pk_in,
    const void* pkl_in, const void* nri_in, void* k_out, void* th_out,
    void* lp_out, void* pk_out, void* pkl_out, void* nri_out, void* ks_out,
    void* ts_out, void* tq_out, void* cnt_out, void* stream) {
  if (L < 1 || L > kLMax || S < 1) return -1;
  if (kTdist && !tconsts) return -1;
  AmT tc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tconsts) tc = {tconsts[0], tconsts[1], tconsts[2], tconsts[3],
                     tconsts[4]};
  cudaStream_t st = (cudaStream_t)stream;
#define AM_CASE(k, d)                                                      \
  if (K == k && D == d)                                                    \
    return launch_sweep<k, d>(S, L, seed, sweep0, n_sweeps, adapt, tc, tab, \
                              kinds, consts, dims, k_in, th_in, lp_in,     \
                              pk_in, pkl_in, nri_in, k_out, th_out,        \
                              lp_out, pk_out, pkl_out, nri_out, ks_out,    \
                              ts_out, tq_out, cnt_out, st);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}
#endif
