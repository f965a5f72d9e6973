// Stage-1 one-sweep kernel (K3), for populations the segment kernel cannot
// hold resident: the moves of one sweep and the pooled update of sig.
//
// Replaces the Pallas kernel of automix_tpu/kernels/fused_stage1.py
// (_sweep_call -> kernel, pallas_call at line 416) together with the
// pooled rule that run_fused_stage1_sharded applies outside it
// (fused_stage1.py:208-243).  The plain PyTorch twin is
// automix_tpu_torch/kernels/fused_stage1.py:sweep_ref, and the runner that
// drives it is run_fused_stage1_sweeps there.
//
// One launch runs global sweep ``t`` for all N = K*C stage-1 chains (lane
// i belongs to model m = i / C, at position pos = i - m * C among its
// model's chains), one thread per chain.  The chain base: a chain draws
// 3*D hash words at counters (m * C_total + chain_off + pos) * 3D + slot,
// the words of global chain m * C_total + chain_off + pos, as JAX's
// gchain (fused_stage1.py:332-342).  A launch over the whole population
// (C_total = C, chain_off 0) draws at i * 3D + slot, the segment kernel's
// words for the same sweep; the launches of the ranks of a population
// split across devices (C chains of each model from position chain_off
// of C_total) draw what that one launch draws.  On the first sweep of a
// segment (``seg_start``) logp is recomputed from theta, as the segment
// kernel does at its start.
// The moves are the segment kernel's (fused_stage1.cu): the componentwise
// coordinates at run time, theta's entries by compare, so the code holds
// one copy of the density, and at DDI's shape the density reads a shared
// copy of DDI's tables (csrc/ddi.cuh am_ddi_shared_load), not __constant__
// memory with indices that differ by lane.
//
// The grid is the launcher's (AM_K3_GRID_SYMBOL, block_threads below):
// one-warp blocks, as the segment kernel's, while the population puts at
// most four of them on every SM (16896 chains on an H100's 132 SMs), so
// that a small population's warps spread over as many SMs as there are
// warps (DDI's 1024 stage-1 chains on 32 SMs, not 4); past that the block
// doubles to 2, 4 and at most 8 warps each time the population doubles
// (2 warps to 33792 chains, 4 to 67584, 8 above).  The width follows the
// population alone, not the route: just above the segment kernel's
// capacity toy2 runs on blocks of 8 warps, and DDI on blocks of 2, each
// loading its own copy of DDI's 29 KB tables.
//
// The per-(model, coordinate) accept counts of the componentwise moves
// are reduced exactly (warp ballots, the block's shared counts, one global
// atomicAdd per nonzero count and block) into ``work`` [K*D].  With
// ``rule`` < 0 (moves only) that is all: the caller reads the counts,
// reduces them across devices, and applies the rule (the JAX runner's psum
// and seg_fn).  With the AAP (0) or log (1) rule the launch applies it
// itself: every block, after its counts, fences and takes a ticket
// (work[K*D]); the block that takes the last ticket reads the totals and
// applies the runner's update to ``sig``, ``nacc`` and ``ntry`` in device
// memory, then zeroes the counts and the ticket for the next launch.  The
// update is the runner's expression for expression (err = (cnt * (1/C) -
// 0.25) * active, the rule grouped as in JAX, then sig + adapt * (new -
// sig)), so the in-kernel runner equals the moves-only runner bit for bit.
// Block-move sweeps (the batch-wide coin) count nothing and do not adapt;
// every block knows it, so they take no ticket.
//
// Box-Muller or Bailey t perturbations are chosen at compile time (kT), as
// in the segment kernel, and each is a compilation unit of its own
// (AM_K3_T, exporting AM_K3_SYMBOL and AM_K3_GRID_SYMBOL), which keeps
// either off the build's critical path.
//
// What bounds it on the H100: latency.  A sweep is a few hundred to tens of
// thousands of dependent operations per chain, one launch a sweep; at
// populations above the segment kernel's capacity that launch is all a
// sweep costs, with no torch operation between launches.
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
#ifndef AM_K3_GRID_SYMBOL
#define AM_K3_GRID_SYMBOL am_fused_stage1_sweep_grid_t0
#endif

namespace {

constexpr int kMaxThreads = 256;

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

template <int K, int D, bool kT>
__global__ void __launch_bounds__(kMaxThreads) fused_stage1_sweep_kernel(
    int N, int C, int C_total, int chain_off, int t, uint32_t seed,
    int nburn, int seg_start, AmT tc, int rule, float log_gain,
    const int* __restrict__ kinds_g,
    const float* __restrict__ consts_g, const int* __restrict__ dims_g,
    const float* __restrict__ th_in, const float* __restrict__ lp_in,
    float* sig_g, int* nacc_g, int* ntry_g, float* __restrict__ th_out,
    float* __restrict__ lp_out, int* work) {
  constexpr bool kDdi = K == AM_DDI_K && D == AM_DDI_D;
  constexpr int KD = K * D;
  __shared__ float sig_s[KD];
  __shared__ int cnt_s[KD];
  __shared__ float consts_s[K * AM_N_CONSTS];
  __shared__ int kinds_s[K], dims_s[K];
  __shared__ float ddi_s[kDdi ? kAmDdiShared : 1];
  __shared__ bool last_s;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int j = tid; j < KD; j += nt) {
    sig_s[j] = sig_g[j];
    cnt_s[j] = 0;
  }
  for (int j = tid; j < K * AM_N_CONSTS; j += nt) consts_s[j] = consts_g[j];
  for (int m = tid; m < K; m += nt) {
    kinds_s[m] = kinds_g[m];
    dims_s[m] = dims_g[m];
  }
  if constexpr (kDdi) am_ddi_shared_load(ddi_s, tid, nt);
  __syncthreads();

  const int i = blockIdx.x * nt + tid;
  const bool valid = i < N;
  const int m = valid ? i / C : 0;
  const int dm = dims_s[m];
  const int kind = kinds_s[m];
  const float* cm = consts_s + m * AM_N_CONSTS;
  // the models of this warp's chains, [m_lo, m_hi] (empty past N)
  const int lane = tid & 31;
  const int wbase = i - lane;
  const int m_lo = wbase / C;
  const int m_hi = wbase < N ? (min(wbase + 32, N) - 1) / C : m_lo - 1;

  const bool do_block = (t > nburn) && am_block_coin(seed, (uint32_t)t);
  uint32_t accbits = 0;                             // bit j: coordinate j
  if (valid) {
    const AmSalts sa = am_sweep_salts(seed, (uint32_t)t);
    const uint32_t gchain =
        (uint32_t)(m * C_total + chain_off + (i - m * C));
    const uint32_t cb = gchain * (uint32_t)(3 * D);
    float th[D];
#pragma unroll
    for (int d = 0; d < D; ++d) th[d] = th_in[(size_t)d * N + i];
    float lp = seg_start ? logpost<K, D>(kind, cm, dm, th, ddi_s) : lp_in[i];
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
      // coordinates at run time, theta's entries by compare: one copy of
      // the density in the code instead of D
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
#pragma unroll
    for (int d = 0; d < D; ++d) th_out[(size_t)d * N + i] = th[d];
    lp_out[i] = lp;
  }
  if (do_block) return;

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
  for (int q = tid; q < KD; q += nt)
    if (cnt_s[q] != 0) atomicAdd(work + q, cnt_s[q]);
  if (rule < 0) return;

  // the pooled update in the launch's last block (header note)
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(work + KD, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last_s) return;
  const float inv_c = (float)(1.0 / (double)C);   // as the runner's scalar
  const float gamma = am_gain(t);
  for (int q = tid; q < KD; q += nt) {
    const int cnt = __ldcg(work + q);
    const bool on = q % D < dims_s[q / D];
    const float err = ((float)cnt * inv_c - 0.25f) * (on ? 1.0f : 0.0f);
    const float s = sig_s[q];
    const float sn = rule == 1 ? s * expf((log_gain * gamma) * err)
                               : fmaxf(s + (10.0f * gamma) * err, 0.0f);
    sig_g[q] = s + 1.0f * (sn - s);
    nacc_g[q] += cnt;
    ntry_g[q] += on ? C : 0;
    work[q] = 0;
  }
  if (tid == 0) work[KD] = 0;
}

// Threads per block for N chains on a card of ``sms`` SMs: one warp while
// that puts at most kBlocksPerSm blocks on every SM, then 2, 4 or 8 warps,
// each doubling as the population doubles.
constexpr int kBlocksPerSm = 4;

int block_threads(int N, int sms) {
  int w = 1;
  while (w < kMaxThreads / 32 && N > kBlocksPerSm * 32 * w * sms) w *= 2;
  return 32 * w;
}

int grid_of(int N, int* threads, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *threads = block_threads(N, sms);
  *blocks = (N + *threads - 1) / *threads;
  return 0;
}

template <int K, int D, bool kT>
int launch_sweep(int N, int C, int C_total, int chain_off, int t,
                 unsigned int seed, int nburn, int seg_start, AmT tc,
                 int rule, float log_gain,
                 const void* kinds, const void* consts, const void* dims,
                 const void* th_in, const void* lp_in, void* sig, void* nacc,
                 void* ntry, void* th_out, void* lp_out, void* work,
                 cudaStream_t st) {
  int threads = 0, blocks = 0;
  const int rc = grid_of(N, &threads, &blocks);
  if (rc != 0) return rc;
  fused_stage1_sweep_kernel<K, D, kT><<<blocks, threads, 0, st>>>(
      N, C, C_total, chain_off, t, seed, nburn, seg_start, tc, rule,
      log_gain, (const int*)kinds,
      (const float*)consts, (const int*)dims, (const float*)th_in,
      (const float*)lp_in, (float*)sig, (int*)nacc, (int*)ntry,
      (float*)th_out, (float*)lp_out, (int*)work);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef __CUDACC__
// Launch sweep ``t`` on ``stream``; returns cudaGetLastError() after the
// launch, or -1 for a (K, D) pair without an instantiation or an unknown
// rule.  ``tconsts`` is a host array of the five Student-t constants (AmT)
// in the Student-t unit, null in the Normal one (else -1).  ``rule`` -1
// moves only: ``work`` is a zeroed device int[K*D] that receives the
// accept counts, and sig, nacc and ntry (may be null) are not written.
// ``rule`` 0 (AAP) or 1 (log, gain ``log_gain``): ``work`` is a device
// int[K*D + 1], zero before the launch and after it, and the launch
// updates ``sig``, ``nacc`` and ``ntry`` [K, D] in place; it needs the
// whole population (C_total = C, chain_off 0).  ``C_total`` and
// ``chain_off``: the chain base (header note), C_total >= chain_off + C.
extern "C" int AM_K3_SYMBOL(
    int K, int D, int N, int C, int C_total, int chain_off, int t,
    unsigned int seed, int nburn,
    int seg_start, const float* tconsts, int rule, float log_gain,
    const void* kinds, const void* consts, const void* dims,
    const void* th_in, const void* lp_in, void* sig, void* nacc, void* ntry,
    void* th_out, void* lp_out, void* work, void* stream) {
  if (N < 1 || C < 1 || N != K * C || rule < -1 || rule > 1) return -1;
  if (chain_off < 0 || C_total < chain_off + C) return -1;
  if (rule >= 0 && !(nacc && ntry && C_total == C && chain_off == 0))
    return -1;
  if ((tconsts != nullptr) != (AM_K3_T != 0)) return -1;
  AmT tc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tconsts) tc = {tconsts[0], tconsts[1], tconsts[2], tconsts[3],
                     tconsts[4]};
  cudaStream_t st = (cudaStream_t)stream;
#define AM_CASE(k, d)                                                        \
  if (K == k && D == d)                                                      \
    return launch_sweep<k, d, AM_K3_T != 0>(                                 \
        N, C, C_total, chain_off, t, seed, nburn, seg_start, tc, rule,       \
        log_gain, kinds, consts, dims, th_in, lp_in, sig, nacc, ntry,        \
        th_out, lp_out, work, st);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}

// The launcher's grid for N chains on the current device: ``threads`` a
// block and ``blocks`` blocks.
extern "C" int AM_K3_GRID_SYMBOL(int N, int* threads, int* blocks) {
  if (N < 1) return -1;
  return grid_of(N, threads, blocks);
}
#endif
