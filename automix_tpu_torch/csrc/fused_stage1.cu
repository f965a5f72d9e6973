// Stage-1 segment kernel: pooled adaptive RWM for the whole model family.
//
// Replaces the Pallas kernel of automix_tpu/kernels/fused_stage1.py
// (_segment_call -> kernel, pallas_call at line 696).  The plain PyTorch
// twin is automix_tpu_torch/kernels/fused_stage1.py:segment_ref.
//
// One launch runs ``n_active`` sweeps of one segment for all N = K*C
// stage-1 chains (lane i belongs to model i / C).  Each sweep draws 3*D
// hash words per chain, makes either the batch-wide block move (a coin
// shared by all chains, after burn-in) or D componentwise moves, then
// applies one pooled AAP update per (model, coordinate):
//     sig = max(sig + 10 * gamma_t * (acc / C - 0.25), 0)
// from the sweep-start sig.  The TPU kernel's trailing surplus sweeps
// (t_rel >= n_active) are exact no-ops, so this kernel simply stops after
// n_active sweeps.  Perturbations are Box-Muller normals, or Bailey polar
// t(dof) variates from the same two words when ``tconsts`` is given.  The
// choice is a template parameter (kT), as K1's variants are compile-time
// units, so the Normal instantiation carries no Student-t code.
//
// Layout: ONE block holds the whole population, because the pooled update
// needs every chain's accept indicator every sweep.  Each of up to 1024
// threads owns chains tid, tid + blockDim, ...; chain state (theta, logp)
// lives in shared memory for the segment.  Accept counts are integers,
// reduced per warp with shuffles and across warps with shared-memory
// atomics: the sum is exact and independent of order, so the sig updates
// are deterministic and equal the twin's.
//
// What bounds it on the H100: latency.  At the main path's 3072 chains the
// segment runs on one SM (2-3 chains per thread, two barriers per sweep);
// the rest of the card is idle.  Stage 1 is ~2200 sweeps once per run, so
// the design keeps the pooled semantics exact rather than spreading the
// population over blocks.  A population whose (D + 1) * N floats and the
// kernel's static shared arrays do not fit the block's shared memory runs
// on the one-sweep kernel of fused_stage1_sweep.cu instead
// (kernels/fused_stage1.py fits_one_block routes it, and
// am_fused_stage1_smem reports the static size that rule bounds).
//
// Floating point: see common.cuh (built with -fmad=false, no fast math).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int K, int D, bool kT>
__global__ void __launch_bounds__(kMaxThreads) fused_stage1_kernel(
    int N, int C, int sweep0, uint32_t seed, int nburn, int n_active,
    AmT tc, const int* __restrict__ kinds_g,
    const float* __restrict__ consts_g, const int* __restrict__ dims_g, const float* __restrict__ th_in,
    const float* __restrict__ sig_in, const int* __restrict__ nacc_in,
    const int* __restrict__ ntry_in, float* __restrict__ th_out,
    float* __restrict__ sig_out, int* __restrict__ nacc_out,
    int* __restrict__ ntry_out, float* __restrict__ lp_out) {
  extern __shared__ float smem[];     // theta [D, N] then logp [N]
  float* th_s = smem;
  float* lp_s = smem + (size_t)D * N;
  __shared__ float sig_s[K * D];
  __shared__ int nacc_s[K * D], ntry_s[K * D], cnt_s[K * D];
  __shared__ float consts_s[K * AM_N_CONSTS];
  __shared__ int kinds_s[K], dims_s[K];

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  for (int j = tid; j < K * D; j += nth) {
    sig_s[j] = sig_in[j];
    nacc_s[j] = nacc_in[j];
    ntry_s[j] = ntry_in[j];
    cnt_s[j] = 0;
  }
  for (int j = tid; j < K * AM_N_CONSTS; j += nth) consts_s[j] = consts_g[j];
  for (int m = tid; m < K; m += nth) {
    kinds_s[m] = kinds_g[m];
    dims_s[m] = dims_g[m];
  }
  __syncthreads();

  // logp is a pure function of theta: recomputed at segment start.
  for (int i = tid; i < N; i += nth) {
    float th[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      th[d] = th_in[(size_t)d * N + i];
      th_s[(size_t)d * N + i] = th[d];
    }
    const int m = i / C;
    lp_s[i] = am_logpost<D>(kinds_s[m], consts_s + m * AM_N_CONSTS, dims_s[m],
                         th);
  }

  const int NW = 3 * D;
  const float inv_c = (float)(1.0 / (double)C);   // as the JAX constant
  for (int tr = 0; tr < n_active; ++tr) {
    const int t = sweep0 + tr + 1;                  // 1-based global sweep
    const AmSalts sa = am_sweep_salts(seed, (uint32_t)t);
    const bool do_block = (t > nburn) && am_block_coin(seed, (uint32_t)t);
    int my_cnt[K * D];
#pragma unroll
    for (int j = 0; j < K * D; ++j) my_cnt[j] = 0;

    for (int i = tid; i < N; i += nth) {
      const int m = i / C;
      const int dm = dims_s[m];
      const int kind = kinds_s[m];
      const float* cm = consts_s + m * AM_N_CONSTS;
      const uint32_t cb = (uint32_t)i * (uint32_t)NW;
      float th[D];
#pragma unroll
      for (int d = 0; d < D; ++d) th[d] = th_s[(size_t)d * N + i];
      float lp = lp_s[i];
      float z[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float u1 = am_u01(am_word(sa, cb + D + j));
        float u2 = am_u01(am_word(sa, cb + 2 * D + j));
        z[j] = kT ? am_bailey_t(u1, u2, tc)
                  : am_bm_radius(u1) * cosf(AM_TWO_PI * u2);
      }
      if (do_block) {
        // sig is 0 on coordinates the model lacks, which therefore stay put
        float prop[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
          prop[d] = (d < dm) ? th[d] + sig_s[m * D + d] * z[d] : th[d];
        float lpn = am_logpost<D>(kind, cm, dm, prop);
        float acc = (am_u01(am_word(sa, cb)) < am_accept(lpn - lp)) ? 1.0f
                                                                    : 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) th[d] = th[d] + acc * (prop[d] - th[d]);
        lp = lp + acc * (lpn - lp);
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          if (j >= dm) continue;
          float prop[D];
#pragma unroll
          for (int d = 0; d < D; ++d) prop[d] = th[d];
          prop[j] = th[j] + sig_s[m * D + j] * z[j];
          float lpn = am_logpost<D>(kind, cm, dm, prop);
          float acc = (am_u01(am_word(sa, cb + j)) < am_accept(lpn - lp))
                          ? 1.0f
                          : 0.0f;
          th[j] = th[j] + acc * (prop[j] - th[j]);
          lp = lp + acc * (lpn - lp);
#pragma unroll
          for (int mm = 0; mm < K; ++mm)
            if (mm == m) my_cnt[mm * D + j] += (int)acc;
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) th_s[(size_t)d * N + i] = th[d];
      lp_s[i] = lp;
    }

    if (!do_block) {
      // exact integer reduction: warp shuffles, then one atomic per warp
#pragma unroll
      for (int j = 0; j < K * D; ++j) {
        int v = my_cnt[j];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if ((tid & 31) == 0 && v != 0) atomicAdd(&cnt_s[j], v);
      }
      __syncthreads();
      for (int q = tid; q < K * D; q += nth) {
        const int m = q / D, j = q % D;
        if (j < dims_s[m]) {
          const float gamma = am_gain(t);
          const float err = (float)cnt_s[q] * inv_c - 0.25f;
          sig_s[q] = fmaxf(sig_s[q] + 10.0f * gamma * err, 0.0f);
          nacc_s[q] += cnt_s[q];
          ntry_s[q] += C;
        }
        cnt_s[q] = 0;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < N; i += nth) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      th_out[(size_t)d * N + i] = th_s[(size_t)d * N + i];
    lp_out[i] = lp_s[i];
  }
  for (int j = tid; j < K * D; j += nth) {
    sig_out[j] = sig_s[j];
    nacc_out[j] = nacc_s[j];
    ntry_out[j] = ntry_s[j];
  }
}

template <int K, int D, bool kT>
int launch_segment(int N, int C, int sweep0, unsigned int seed, int nburn,
                   int n_active, AmT tc, const void* kinds,
                   const void* consts, const void* dims, const void* th_in,
                   const void* sig_in, const void* nacc_in,
                   const void* ntry_in, void* th_out, void* sig_out,
                   void* nacc_out, void* ntry_out, void* lp_out,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)(D + 1) * (size_t)N;
  const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stage1_kernel<K, D, kT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_stage1_kernel<K, D, kT><<<1, threads, smem, st>>>(
      N, C, sweep0, seed, nburn, n_active, tc, (const int*)kinds,
      (const float*)consts, (const int*)dims, (const float*)th_in,
      (const float*)sig_in, (const int*)nacc_in, (const int*)ntry_in,
      (float*)th_out, (float*)sig_out, (int*)nacc_out, (int*)ntry_out,
      (float*)lp_out);
  return (int)cudaGetLastError();
}

template <int K, int D, bool kT>
int static_smem(int* bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fused_stage1_kernel<K, D, kT>);
  if (e != cudaSuccess) return (int)e;
  *bytes = (int)a.sharedSizeBytes;
  return 0;
}

}  // namespace

#ifdef __CUDACC__
// Launch one segment on ``stream``; returns cudaGetLastError() after the
// launch, or -1 for a (K, D) pair without an instantiation.  ``tconsts``
// is a host array of the five Student-t constants (AmT), or null for
// Box-Muller normals.
extern "C" int am_fused_stage1(
    int K, int D, int N, int C, int sweep0, unsigned int seed, int nburn,
    int n_active, const float* tconsts, const void* kinds,
    const void* consts, const void* dims, const void* th_in,
    const void* sig_in, const void* nacc_in, const void* ntry_in,
    void* th_out, void* sig_out, void* nacc_out, void* ntry_out,
    void* lp_out, void* stream) {
  if (N < 1 || C < 1 || N != K * C) return -1;
  AmT tc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tconsts) tc = {tconsts[0], tconsts[1], tconsts[2], tconsts[3],
                     tconsts[4]};
  cudaStream_t st = (cudaStream_t)stream;
#define AM_LAUNCH(k, d, t)                                                   \
  launch_segment<k, d, t>(N, C, sweep0, seed, nburn, n_active, tc, kinds,    \
                          consts, dims, th_in, sig_in, nacc_in, ntry_in,     \
                          th_out, sig_out, nacc_out, ntry_out, lp_out, st)
#define AM_CASE(k, d)                                                        \
  if (K == k && D == d)                                                      \
    return tconsts ? AM_LAUNCH(k, d, true) : AM_LAUNCH(k, d, false);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
#undef AM_LAUNCH
  return -1;
}

// The static shared memory of the (K, D) instantiation, Student-t when
// ``use_t``, into ``*static_bytes``, and the card's opt-in shared memory
// per block into ``*optin_bytes``: a block fits when static plus dynamic
// bytes are within the opt-in.  Returns 0, a CUDA error, or -1 for a pair
// without an instantiation.
extern "C" int am_fused_stage1_smem(int K, int D, int use_t,
                                    int* static_bytes, int* optin_bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin_bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
#define AM_CASE(k, d)                                                        \
  if (K == k && D == d)                                                      \
    return use_t ? static_smem<k, d, true>(static_bytes)                     \
                 : static_smem<k, d, false>(static_bytes);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}
#endif
