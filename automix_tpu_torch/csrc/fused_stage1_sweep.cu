// Stage-1 one-sweep kernel: moves only, for populations the segment kernel
// cannot hold resident.
//
// Replaces the Pallas kernel of automix_tpu/kernels/fused_stage1.py
// (_sweep_call -> kernel, pallas_call at line 416).  The plain PyTorch
// twin is automix_tpu_torch/kernels/fused_stage1.py:sweep_ref, and the
// runner that drives it is run_fused_stage1_sweeps there.
//
// One launch runs global sweep ``t`` for all N = K*C stage-1 chains (lane
// i belongs to model i / C), one thread per chain over as many blocks as
// N needs.  A chain draws 3*D hash words at counters i * 3D + slot, so its
// words equal the segment kernel's for the same sweep.  On the first sweep
// of a segment (``seg_start``) logp is recomputed from theta, as the
// segment kernel does at its start.  The kernel does not adapt sig: it
// reduces the per-(model, coordinate) accept counts of the componentwise
// moves into ``cnt_out`` [K*D] int32 (zeroed by the caller), and the
// runner applies the pooled AAP update between launches.  The counts are
// integers reduced with warp shuffles and shared/global atomics, so they
// are exact and independent of order: the role of the JAX runner's psum.
// Box-Muller or Bailey t perturbations are chosen at compile time (kT), as
// in the segment kernel, and each is a compilation unit of its own
// (AM_K3_T, exporting AM_K3_SYMBOL), which keeps either off the build's
// critical path.
//
// What bounds it on the H100: launch latency.  A sweep is a few hundred
// instructions per chain, so at the 10240 chains of toy2's default stage
// 1 a launch is a few microseconds of work, and the runner's per-sweep
// update adds a handful of small launches.  The design keeps everything a
// sweep needs in one kernel (moves, logp refresh and the count reduction)
// so that each sweep is one launch plus the [K, D] update.  Larger
// populations fill more SMs at the same launch count.
//
// Floating point: see common.cuh (built with -fmad=false, no fast math).

#include <cuda_runtime.h>

#include "common.cuh"

#ifndef AM_K3_T
#define AM_K3_T 0
#endif
#ifndef AM_K3_SYMBOL
#define AM_K3_SYMBOL am_fused_stage1_sweep_t0
#endif

namespace {

constexpr int kThreads = 256;

template <int K, int D, bool kT>
__global__ void __launch_bounds__(kThreads) fused_stage1_sweep_kernel(
    int N, int C, int t, uint32_t seed, int nburn, int seg_start, AmT tc, const int* __restrict__ kinds_g,
    const float* __restrict__ consts_g, const int* __restrict__ dims_g,
    const float* __restrict__ th_in, const float* __restrict__ lp_in,
    const float* __restrict__ sig_g, float* __restrict__ th_out,
    float* __restrict__ lp_out, int* __restrict__ cnt_out) {
  __shared__ float consts_s[K * AM_N_CONSTS];
  __shared__ float sig_s[K * D];
  __shared__ int kinds_s[K], dims_s[K], cnt_s[K * D];
  const int tid = threadIdx.x;
  for (int j = tid; j < K * AM_N_CONSTS; j += blockDim.x)
    consts_s[j] = consts_g[j];
  for (int j = tid; j < K * D; j += blockDim.x) {
    sig_s[j] = sig_g[j];
    cnt_s[j] = 0;
  }
  for (int m = tid; m < K; m += blockDim.x) {
    kinds_s[m] = kinds_g[m];
    dims_s[m] = dims_g[m];
  }
  __syncthreads();

  const bool do_block = (t > nburn) && am_block_coin(seed, (uint32_t)t);
  int my_cnt[K * D];
#pragma unroll
  for (int j = 0; j < K * D; ++j) my_cnt[j] = 0;

  const int i = blockIdx.x * blockDim.x + tid;
  if (i < N) {
    const int m = i / C;
    const int dm = dims_s[m];
    const int kind = kinds_s[m];
    const float* cm = consts_s + m * AM_N_CONSTS;
    const AmSalts sa = am_sweep_salts(seed, (uint32_t)t);
    const uint32_t cb = (uint32_t)i * (uint32_t)(3 * D);
    float th[D];
#pragma unroll
    for (int d = 0; d < D; ++d) th[d] = th_in[(size_t)d * N + i];
    float lp = seg_start ? am_logpost<K, D>(kind, cm, dm, th) : lp_in[i];
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
      float lpn = am_logpost<K, D>(kind, cm, dm, prop);
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
        float lpn = am_logpost<K, D>(kind, cm, dm, prop);
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
    for (int d = 0; d < D; ++d) th_out[(size_t)d * N + i] = th[d];
    lp_out[i] = lp;
  }

  if (!do_block) {
    // exact integer reduction: warp shuffles, one shared atomic per warp,
    // one global atomic per block and (model, coordinate)
#pragma unroll
    for (int j = 0; j < K * D; ++j) {
      int v = my_cnt[j];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if ((tid & 31) == 0 && v != 0) atomicAdd(&cnt_s[j], v);
    }
    __syncthreads();
    for (int j = tid; j < K * D; j += blockDim.x)
      if (cnt_s[j] != 0) atomicAdd(&cnt_out[j], cnt_s[j]);
  }
}

template <int K, int D, bool kT>
int launch_sweep(int N, int C, int t, unsigned int seed, int nburn,
                 int seg_start, AmT tc, const void* kinds,
                 const void* consts, const void* dims, const void* th_in,
                 const void* lp_in, const void* sig, void* th_out,
                 void* lp_out, void* cnt_out, cudaStream_t st) {
  const dim3 grid((N + kThreads - 1) / kThreads);
  fused_stage1_sweep_kernel<K, D, kT><<<grid, kThreads, 0, st>>>(
      N, C, t, seed, nburn, seg_start, tc, (const int*)kinds,
      (const float*)consts, (const int*)dims, (const float*)th_in,
      (const float*)lp_in, (const float*)sig, (float*)th_out,
      (float*)lp_out, (int*)cnt_out);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef __CUDACC__
// Launch sweep ``t`` on ``stream``; returns cudaGetLastError() after the
// launch, or -1 for a (K, D) pair without an instantiation.  ``tconsts``
// is a host array of the five Student-t constants (AmT) in the Student-t
// unit, null in the Normal one (else -1).
extern "C" int AM_K3_SYMBOL(
    int K, int D, int N, int C, int t, unsigned int seed, int nburn,
    int seg_start, const float* tconsts, const void* kinds,
    const void* consts, const void* dims, const void* th_in,
    const void* lp_in, const void* sig, void* th_out, void* lp_out,
    void* cnt_out, void* stream) {
  if (N < 1 || C < 1 || N != K * C) return -1;
  if ((tconsts != nullptr) != (AM_K3_T != 0)) return -1;
  AmT tc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tconsts) tc = {tconsts[0], tconsts[1], tconsts[2], tconsts[3],
                     tconsts[4]};
  cudaStream_t st = (cudaStream_t)stream;
#define AM_LAUNCH(k, d, tt)                                                 \
  launch_sweep<k, d, tt>(N, C, t, seed, nburn, seg_start, tc, kinds, consts, \
                         dims, th_in, lp_in, sig, th_out, lp_out, cnt_out,  \
                         st)
#define AM_CASE(k, d)                                                       \
  if (K == k && D == d) return AM_LAUNCH(k, d, AM_K3_T != 0);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
#undef AM_LAUNCH
  return -1;
}
#endif
