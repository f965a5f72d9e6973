// Stage-1 segment kernel: pooled adaptive RWM for the whole model family.
//
// Replaces the Pallas kernel of automix_tpu/kernels/fused_stage1.py
// (_segment_call -> kernel, pallas_call at line 696).  The plain PyTorch
// twin is automix_tpu_torch/kernels/fused_stage1.py:segment_ref.
//
// One launch runs ``n_active`` sweeps of one segment for all N = K*C
// stage-1 chains (chain i belongs to model i / C).  Each sweep draws 3*D
// hash words per chain, makes either the batch-wide block move (a coin
// shared by all chains, after burn-in) or D componentwise moves, then
// applies one pooled update per (model, coordinate) from the sweep-start
// sig, the AAP rule
//     sig = max(sig + 10 * gamma_t * (acc / C - 0.25), 0)
// or, when ``log_rule`` is set (the JAX stage1_adapt="log", the
// in-kernel update of fused_stage1.py:669-673),
//     sig = sig * exp(log_gain * gamma_t * (acc / C - 0.25)).
// The rule is a run-time argument, not a template parameter: one uniform
// branch per (model, coordinate) per sweep against a second instantiation
// of every shape.  The TPU kernel's trailing surplus sweeps (t_rel >=
// n_active) are exact no-ops, so this kernel simply stops after n_active
// sweeps.  Perturbations are Box-Muller normals, or Bailey polar t(dof)
// variates from the same two words.  The choice is a compile-time unit
// (AM_STAGE1_T, the template parameter kT), as K1's variants are, so the
// Normal unit carries no Student-t code and the two units build in
// parallel.
//
// Layout: one thread per chain, over blocks of one warp (kThreads), in a
// cooperative launch of every block at once, so that stage 1's 1024-10240
// chains spread over many SMs (32-320 blocks) instead of filling one.  A
// chain's theta and logp stay in registers for the whole segment; the
// launch bound lets the compiler use up to 255 registers a thread.
// The pooled update needs every chain's accept indicators every sweep:
// after a componentwise sweep each warp counts its accepts per (model,
// coordinate) with ballots (one model per warp when C is a multiple of 32,
// else one ballot per model the warp spans), adds them to the block's
// shared counts, and the block adds each nonzero count to this sweep's
// global buffer with one atomicAdd; after one grid barrier every block
// reads the totals and applies the update to its own shared copy of sig,
// nacc and ntry.  The counts are integers, so every block computes the same
// sig bit for bit, equal to the twin's; block 0 stores it.  The buffers
// rotate by adapting sweep over three (``gcnt``, zeroed by the caller): the
// buffer of sweep s is written before the barrier of s and read after it;
// block 0 zeroes it after the barrier of sweep s + 1, when every block has
// read it, and sweep s + 3 writes it again only after crossing the barrier
// of s + 2, which block 0 reaches after the zeroing.  Block-move sweeps do
// not adapt and cross no barrier.  Threads past N reach every barrier and
// ballot, count nothing and store nothing.  The launcher refuses a
// population above the chains the card holds resident (AM_STAGE1_CAP_SYMBOL;
// kernels/fused_stage1.py routes a larger one to the one-sweep kernel of
// fused_stage1_sweep.cu).
//
// At DDI's shape each componentwise move evaluates the chain's model's
// class statistics from scratch (up to 165 columns): the coefficient rows
// and feature indices are copied from __constant__ memory into each block's
// shared memory once (csrc/ddi.cuh am_ddi_shared_load, 28.9 KB), as K1e
// does, since a warp's walk over their 29 KB thrashes the constant cache.
// The componentwise moves run over the coordinates at run time, selecting
// theta's entries by compare (K1e's loop), so that the code holds one copy
// of the density instead of D: with 1024-3072 chains an SM runs one to
// three warps, which cannot hide the instruction fetches of D inlined
// copies; against the loop unrolled over D, the rolled loop made DDI's
// segment 3.1 times faster and cpt's 1.5 times (PERF.md section 6).
//
// What bounds it on the H100: latency.  A sweep is a few hundred to tens
// of thousands of dependent operations per chain, one warp per block and
// a few warps per SM, then one grid barrier; stage 1 is ~2200 sweeps once
// per run.
//
// Floating point: see common.cuh (built with -fmad=false, no fast math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

#ifndef AM_STAGE1_T
#define AM_STAGE1_T 0
#endif
#ifndef AM_STAGE1_SYMBOL
#define AM_STAGE1_SYMBOL am_fused_stage1_t0
#endif
#ifndef AM_STAGE1_CAP_SYMBOL
#define AM_STAGE1_CAP_SYMBOL am_fused_stage1_cap_t0
#endif

namespace {

constexpr int kThreads = 32;
constexpr bool kT = AM_STAGE1_T != 0;

// The DDI family's shape, whose statistics read the shared copy of its
// tables (``ddi``); the other shapes' densities as the sweep kernel's.
template <int K, int D>
__device__ __forceinline__ float logpost(int kind, const float* c, int dim,
                                         const float* th, const float* ddi) {
  if constexpr (K == AM_DDI_K && D == AM_DDI_D) {
    if (kind == AM_KIND_DDI)
      return (c[0] == 0.0f)
                 ? am_ddi_logpost<0>(th, am_ddi_tables<0, true>(ddi))
                 : am_ddi_logpost<1>(th, am_ddi_tables<1, true>(ddi));
  }
  return am_logpost<K, D, false>(kind, c, dim, th);
}

template <int K, int D>
__global__ void __launch_bounds__(kThreads) fused_stage1_kernel(
    int N, int C, int sweep0, uint32_t seed, int nburn, int n_active,
    AmT tc, int log_rule, float log_gain, int* __restrict__ gcnt,
    const int* __restrict__ kinds_g, const float* __restrict__ consts_g,
    const int* __restrict__ dims_g, const float* __restrict__ th_in,
    const float* __restrict__ sig_in, const int* __restrict__ nacc_in,
    const int* __restrict__ ntry_in, float* __restrict__ th_out,
    float* __restrict__ sig_out, int* __restrict__ nacc_out,
    int* __restrict__ ntry_out, float* __restrict__ lp_out) {
  constexpr bool kDdi = K == AM_DDI_K && D == AM_DDI_D;
  constexpr int KD = K * D;
  __shared__ float sig_s[KD];
  __shared__ int nacc_s[KD], ntry_s[KD], cnt_s[KD];
  __shared__ float consts_s[K * AM_N_CONSTS];
  __shared__ int kinds_s[K], dims_s[K];
  __shared__ float ddi_s[kDdi ? kAmDdiShared : 1];

  const int tid = threadIdx.x;
  for (int j = tid; j < KD; j += kThreads) {
    sig_s[j] = sig_in[j];
    nacc_s[j] = nacc_in[j];
    ntry_s[j] = ntry_in[j];
    cnt_s[j] = 0;
  }
  for (int j = tid; j < K * AM_N_CONSTS; j += kThreads)
    consts_s[j] = consts_g[j];
  for (int m = tid; m < K; m += kThreads) {
    kinds_s[m] = kinds_g[m];
    dims_s[m] = dims_g[m];
  }
  if constexpr (kDdi) am_ddi_shared_load(ddi_s, tid, kThreads);
  __syncthreads();

  const int i = blockIdx.x * kThreads + tid;
  const bool valid = i < N;
  const int m = valid ? i / C : 0;
  const int dm = dims_s[m];
  const int kind = kinds_s[m];
  const float* cm = consts_s + m * AM_N_CONSTS;
  // the models of this warp's chains, [m_lo, m_hi] (empty past N)
  const int wbase = i - (tid & 31);
  const int m_lo = wbase / C;
  const int m_hi = wbase < N ? (min(wbase + 32, N) - 1) / C : m_lo - 1;
  const int lane = tid & 31;

  // logp is a pure function of theta: recomputed at segment start.
  float th[D];
#pragma unroll
  for (int d = 0; d < D; ++d) th[d] = valid ? th_in[(size_t)d * N + i] : 0.0f;
  float lp = valid ? logpost<K, D>(kind, cm, dm, th, ddi_s) : 0.0f;

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int NW = 3 * D;
  const uint32_t cb = (uint32_t)i * (uint32_t)NW;
  const float inv_c = (float)(1.0 / (double)C);   // as the JAX constant
  int na = 0;                                     // adapting sweeps so far
  for (int tr = 0; tr < n_active; ++tr) {
    const int t = sweep0 + tr + 1;                  // 1-based global sweep
    const AmSalts sa = am_sweep_salts(seed, (uint32_t)t);
    const bool do_block = (t > nburn) && am_block_coin(seed, (uint32_t)t);
    uint32_t accbits = 0;                           // bit j: coordinate j

    if (valid) {
      // perturbation of coordinate j: a Box-Muller normal or a Bailey t
      auto z_of = [&](int j) {
        const float u1 = am_u01(am_word(sa, cb + D + j));
        const float u2 = am_u01(am_word(sa, cb + 2 * D + j));
        return kT ? am_bailey_t(u1, u2, tc)
                  : am_bm_radius(u1) * cosf(AM_TWO_PI * u2);
      };
      if (do_block) {
        // sig is 0 on coordinates the model lacks, which therefore stay put
        float prop[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
          prop[d] = (d < dm) ? th[d] + sig_s[m * D + d] * z_of(d) : th[d];
        float lpn = logpost<K, D>(kind, cm, dm, prop, ddi_s);
        float acc = (am_u01(am_word(sa, cb)) < am_accept(lpn - lp)) ? 1.0f
                                                                    : 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) th[d] = th[d] + acc * (prop[d] - th[d]);
        lp = lp + acc * (lpn - lp);
      } else {
        // coordinates at run time, theta's entries by compare (K1e's loop):
        // one copy of the density in the code instead of D
#pragma unroll 1
        for (int j = 0; j < dm; ++j) {
          float thj = 0.0f;
#pragma unroll
          for (int d = 0; d < D; ++d)
            if (d == j) thj = th[d];
          const float pj = thj + sig_s[m * D + j] * z_of(j);
          float prop[D];
#pragma unroll
          for (int d = 0; d < D; ++d) prop[d] = (d == j) ? pj : th[d];
          const float lpn = logpost<K, D>(kind, cm, dm, prop, ddi_s);
          const float acc =
              (am_u01(am_word(sa, cb + j)) < am_accept(lpn - lp)) ? 1.0f
                                                                  : 0.0f;
#pragma unroll
          for (int d = 0; d < D; ++d)
            if (d == j) th[d] = th[d] + acc * (pj - th[d]);
          lp = lp + acc * (lpn - lp);
          accbits |= (acc != 0.0f ? 1u : 0u) << j;
        }
      }
    }

    if (!do_block) {
      // exact integer counts: warp ballots, the block's shared counts, one
      // global atomic per nonzero (model, coordinate) and block
      for (int mm = m_lo; mm <= m_hi; ++mm) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const unsigned b = __ballot_sync(
              0xffffffffu, valid && m == mm && ((accbits >> j) & 1u));
          if (lane == 0 && b != 0u) atomicAdd(&cnt_s[mm * D + j], __popc(b));
        }
      }
      __syncthreads();
      int* buf = gcnt + (na % 3) * KD;
      for (int q = tid; q < KD; q += kThreads)
        if (cnt_s[q] != 0) atomicAdd(buf + q, cnt_s[q]);
      grid.sync();
      // the previous adapting sweep's buffer: read by every block before
      // this barrier, written again three adapting sweeps on
      if (blockIdx.x == 0 && na > 0)
        for (int q = tid; q < KD; q += kThreads)
          gcnt[((na + 2) % 3) * KD + q] = 0;
      for (int q = tid; q < KD; q += kThreads) {
        const int mq = q / D, j = q % D;
        const int cnt = __ldcg(buf + q);
        if (j < dims_s[mq]) {
          const float gamma = am_gain(t);
          const float err = (float)cnt * inv_c - 0.25f;
          sig_s[q] = log_rule ? sig_s[q] * expf(log_gain * gamma * err)
                              : fmaxf(sig_s[q] + 10.0f * gamma * err, 0.0f);
          nacc_s[q] += cnt;
          ntry_s[q] += C;
        }
        cnt_s[q] = 0;
      }
      __syncthreads();
      ++na;
    }
  }

  if (valid) {
#pragma unroll
    for (int d = 0; d < D; ++d) th_out[(size_t)d * N + i] = th[d];
    lp_out[i] = lp;
  }
  if (blockIdx.x == 0)
    for (int j = tid; j < KD; j += kThreads) {
      sig_out[j] = sig_s[j];
      nacc_out[j] = nacc_s[j];
      ntry_out[j] = ntry_s[j];
    }
}

// Chains the segment kernel holds resident at once on the current device:
// blocks per SM (occupancy at its registers and shared memory) times SMs
// times kThreads; 0 where the device has no cooperative launch.
template <int K, int D>
int capacity(int* chains) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_stage1_kernel<K, D>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *chains = coop ? per_sm * sms * kThreads : 0;
  return 0;
}

template <int K, int D>
int launch_segment(int N, int C, int sweep0, unsigned int seed, int nburn,
                   int n_active, AmT tc, int log_rule, float log_gain,
                   void* gcnt, const void* kinds, const void* consts,
                   const void* dims, const void* th_in, const void* sig_in,
                   const void* nacc_in, const void* ntry_in, void* th_out,
                   void* sig_out, void* nacc_out, void* ntry_out,
                   void* lp_out, cudaStream_t st) {
  // refuse a population the card cannot hold resident
  int cap = 0;
  const int rc = capacity<K, D>(&cap);
  if (rc != 0) return rc;
  if (N > cap) return -2;
  void* args[] = {&N, &C, &sweep0, &seed, &nburn, &n_active, &tc,
                  &log_rule, &log_gain, &gcnt, &kinds, &consts, &dims,
                  &th_in, &sig_in, &nacc_in, &ntry_in, &th_out, &sig_out,
                  &nacc_out, &ntry_out, &lp_out};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fused_stage1_kernel<K, D>,
      dim3((N + kThreads - 1) / kThreads), dim3(kThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef __CUDACC__
// Launch one segment on ``stream``; returns cudaGetLastError() after the
// launch, -1 for a (K, D) pair without an instantiation or ``tconsts``
// not matching the unit, or -2 when N exceeds the chains the card holds
// resident (AM_STAGE1_CAP_SYMBOL).  ``gcnt`` is a zeroed device int[3 * K
// * D].  ``tconsts`` is a host array of the five Student-t constants (AmT)
// for the Student-t unit, null for the Normal one; ``log_rule`` selects
// the log rule with gain ``log_gain`` over the AAP rule.
extern "C" int AM_STAGE1_SYMBOL(
    int K, int D, int N, int C, int sweep0, unsigned int seed, int nburn,
    int n_active, const float* tconsts, int log_rule, float log_gain,
    void* gcnt, const void* kinds, const void* consts, const void* dims,
    const void* th_in, const void* sig_in, const void* nacc_in,
    const void* ntry_in,
    void* th_out, void* sig_out, void* nacc_out, void* ntry_out,
    void* lp_out, void* stream) {
  if (N < 1 || C < 1 || N != K * C || (tconsts != nullptr) != kT) return -1;
  AmT tc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tconsts) tc = {tconsts[0], tconsts[1], tconsts[2], tconsts[3],
                     tconsts[4]};
  cudaStream_t st = (cudaStream_t)stream;
#define AM_CASE(k, d)                                                        \
  if (K == k && D == d)                                                      \
    return launch_segment<k, d>(N, C, sweep0, seed, nburn, n_active, tc,    \
                                log_rule, log_gain, gcnt, kinds, consts,     \
                                dims, th_in, sig_in, nacc_in, ntry_in,       \
                                th_out, sig_out, nacc_out, ntry_out, lp_out, \
                                st);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}

// Chains the segment kernel of (K, D) holds resident on the current
// device, in ``*chains``.  Returns 0, a CUDA error, or -1 for a pair
// without an instantiation.
extern "C" int AM_STAGE1_CAP_SYMBOL(int K, int D, int* chains) {
#define AM_CASE(k, d)                                                        \
  if (K == k && D == d) return capacity<k, d>(chains);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}
#endif
