// Stage-3 reversible-jump sweep kernel: a whole chunk of sweeps per chain.
//
// Replaces the Pallas kernel of automix_tpu/kernels/fused.py
// (build_fused_chunk_runner._built -> kernel, pallas_call at line 859) with
// either of its word streams, a run-time uniform argument ``rng``: the counter
// hash (``hash``) or K1f, the port's counterpart of its TPU hardware PRNG
// (``hw``, fused.py:421-445; common.cuh AmWords); for stateless column
// densities and, in a cached form (kCache, K1e), for the DDI family's
// incremental density; in four variants: Normal or Student-t perturbations
// (AM_TDIST: Bailey polar draws and the t latent density) and with or without
// the latent permutation (AM_PERM: the stable bubble network over per-slot
// uniform keys).  Each variant is its own compilation unit and exports the
// per-chain-pk launcher AM_K1_SYMBOL (K1; with n_sweeps = 1 and adapt = 0
// it is the JAX _built(1, L, S, False), and the one-sweep pooled route
// kernels/fused.py:pooled_sweeps, the reference K1d is held to), the
// pooled-pk launcher AM_K1C_SYMBOL (K1c, the JAX in-kernel pooled branch,
// fused.py:773-779), AM_K1C_CAP_SYMBOL, the number of chains K1c can hold
// resident, AM_K1_MAXL_SYMBOL, the largest L, and AM_K1_OCC_SYMBOL, the
// per-chain kernel's resident warps per SM; a second unit of each variant
// (AM_SCAN) exports K1d's launcher AM_K1D_SYMBOL and its grid query
// AM_K1D_GRID_SYMBOL (below).  The plain PyTorch twin is
// automix_tpu_torch/kernels/fused.py:sweep_chunk_ref.
//
// The chain base: the per-chain launcher takes ``chain0``, the global index
// of its chain 0, and thread i keys its hash counters and its hw stream by
// chain0 + i (the JAX _shard_index() * S_local, fused.py:900-905), so the
// launches over the blocks of a population split across devices draw the
// words one launch over the whole population draws.  K1c and K1d take a
// whole population and keep the base 0.
//
// Layout: one thread per chain.  The chain's state (k, theta, logp, pk,
// pkllim, nreinit) stays in registers for the whole chunk; device memory sees
// one read and one write of the state per chunk.  The proposal tables
// (K*L*(2D^2+D+3)+K*D floats: 38 KB at K = D = 5, 74 KB at K = 10, D = 5, L =
// 32) are copied to shared memory once per block; at the change-point shape
// (6, 13) they take 312 + 8496 L bytes, so L stops at 27 on the H100: the
// wrappers ask AM_K1_MAXL_SYMBOL and refuse a larger L before any launch
// (kernels/fused.py check_tables).  The chunk sums (K visit counts, 2*K*D
// theta sums) stay in registers too, and a sweep adds to its own model's
// entries only (the twin's 0 * theta additions are exact).  At rb9's K*D = 50
// that takes K1 to 201-210 registers with no spills, 2 blocks per SM; keeping
// the sums in shared memory instead (56 KB a block, 3 blocks per SM) made a
// 100-sweep launch on rb9 5 times slower.  Keeping only the current model's
// sums in registers and the others in a per-thread local slot, swapped when
// a jump changes the model, took (6, 13) to 113-115 registers and (10, 5) to
// 72-80, with 2-3 times the resident warps, and was slower at both shapes
// (PERF.md section 6): 1.8-3.2 times at 131072 chains, and twice as slow on
// cptrs, whose chains change model on 22% of chain-sweeps (rb9's 64%).
//
// At rb9's shape the work, not the registers, was what to cut: every
// evaluation ran each Negative-Binomial group's pal_gammaln loop, though a
// rate's coordinate move leaves the over-dispersions as they were.  There
// the rb9 density reads the chain's kappa tables (common.cuh
// am_density_rb9_tab): per kappa its key, km1, the bracket and the 28
// distinct counts' pal_gammaln values, in the thread's column of shared
// memory after the proposal tables (47 KB a block), filled on a miss by
// the lane, two values at a time, and read by every group.  On rb9's
// state a warp fills at 3.8 of its 5.6 evaluations a sweep, and 100 sweeps
// of 131072 chains take 16.2 ms instead of 26.0 (PERF.md section 6).  Not
// shipped, each slower at 131072 chains: the warp filling its lanes'
// tables together (lanes that hit compute values of lanes that missed;
// 17.0 ms), the coordinate loop rolled (one copy of the density: 20.9 ms,
// though 3.6 against 4.1 at 16384 chains), one or four values at a time
// (16.6-19.5), and 3 blocks per SM (168 registers, 152 bytes of spills;
// 28.5).
//
// At the small shapes (K * D <= 6, the main path's (3, 2)) the kernel is
// latency-bound, and what pays is the tutorial's three densities without
// divergence (common.cuh am_density_builtin) at 32 resident warps: the
// kernel is built for 8 blocks per SM, so within 64 registers, which it
// reaches with the chunk sums and the allocation logits in the thread's
// column of shared memory and without carrying the counters that follow
// from the launch (block tries, sweeps, the last model's visits).  That
// leaves no local memory but libdevice's trig reduction (a 32-byte stack
// frame; a 128-byte local array of logits before).  Keeping the first 4 or
// 8 logits in registers instead, unrolled so that the components' chains
// interleave, took 72-79 registers (24 warps) and was slower, and spilled
// within 64; 10 or 12 blocks per SM spilled and were slower (PERF.md
// section 6).
//
// Shapes of up to 25 (model, coordinate) pairs take the small shapes'
// layout at 4 blocks per SM.  At toy2's (5, 5) the 25 pairs of chunk sums
// and the logits in the thread's shared column (42 KB a block at L = 10)
// took 95-128 registers and no local array, where
// the sums in registers and the logits in local memory took 124-127 and a
// 160-byte stack frame at the same 4 blocks.  The perm forms ran 1.2 times
// faster, the others 0-3% (PERF.md section 6).  5 blocks per SM (at most
// 102 registers) ran 16-31% slower; drawing the latent fillers only below
// the destination's dimension, at (5, 5) and at toy1's (2, 2), was level.
//
// K1c: the JAX kernel keeps the population in one lane block, so its visit
// histogram is a cross-lane sum.  Here the population spans many blocks, so
// K1c is a cooperative launch over blocks that the card holds resident at once
// (the launcher refuses a population above that bound; nothing falls back).
// Each sweep, after the RJ accept, every warp counts its chains per model with
// ballots, every block adds its counts to a shared histogram and then, with
// one atomicAdd per model, to this sweep's global histogram (three buffers in
// turn: the one read in the previous sweep is zeroed after this sweep's grid
// barrier, when nobody reads it any more and before anybody writes it again);
// after the grid barrier every thread reads the counts and applies the update
// of fused.py:768-792 with oh = count * (1/S).  Integer counts make the update
// exact and independent of order, so K1c equals the twin bit for bit, and with
// the hash K1d too: the hw stream reseeds at every sweep in K1d, so it draws
// other words than K1c's chunk, as JAX's _compiled_pooled does against its
// in-kernel pooled chunk; the gain is am_gain(t), the float32 expression the
// twin and the one-sweep route compute in torch (kernels/fused.py _gains).
// Threads past S run a copy of chain 0, count nothing and store nothing: they
// must reach every barrier.
//
// What bounds it on the H100: arithmetic, not bytes.  A chain-sweep reads and
// writes nothing in device memory and costs ~NW random words (NW = 3D+1+2L+K,
// plus D with perm and 2D with Student-t; ~23 operations a hash word, ~10 a hw
// word and ~16 for the hw state's step of the sweep), ~2L+K+4
// logf/expf/log1pf, a few cosf/sinf and 2L small triangular matvecs.  Unlike
// the TPU kernel, which evaluates every model and every (model, component)
// residual on every lane and mask-selects because lanes cannot branch, a
// thread branches: it loops over its own model's L components for the forward
// allocation and the destination model's for the reverse one, recomputes the
// selected component's residual instead of keeping K*L*D of them, evaluates
// only its own model's density (the tutorial's three kinds without running
// each kind's code in turn: common.cuh am_density_builtin), and computes
// each random word when it is used
// (the stream's per-chain state is one 64-bit register pair: the hash's
// counter base, or the hw stream's PCG state, so the stream is a run-time
// argument and not a template one, which would double the instantiations and
// the build).  Densities are sanitized to finite values, so the TPU kernel's
// 0*x + 1*y mask sums equal the directly selected y; its accept blends x +
// a*(y - x) are kept as blends, since they are not always equal to a select in
// floating point.  The variant switches are compile-time constants, so the
// main-path variant carries no Student-t or perm code.
//
// K1e, the cached form (the JAX kernel with a FusedColsDensity,
// fused.py:460-466, 527-569, 729-765), is compiled at the DDI family's shape
// (2, 16) only, where it is the only form.  A chain carries both models' class
// statistics (AM_DDI_NCACHE = 165 floats, csrc/ddi.cuh) as JAX does: fresh at
// the chunk's start (logp kept), updated by the accepted moves, and recomputed
// with logp from the state after the RJ move of every sweep t with t % 16 ==
// 15.  A candidate's statistics are never stored: its lp takes each column as
// the class loop needs it (from scratch, or the carried column plus the
// coordinate move's features), and an accepted move recomputes the columns it
// blends, c + (cn - c).  A rejected move leaves the cache as it is, which
// equals JAX's blend with acc = 0 whenever the candidate statistics are
// finite.  Both models' statistics follow every accepted alpha move, whatever
// the chain's model, so a jump's blend starts from the same carried values as
// in JAX.  The componentwise loop runs over coordinates at run time (it is
// unrolled in the stateless form), selecting theta's entries by compare so
// that theta stays in registers.  The cache lives in shared memory as
// [column][thread] (a warp's 32 accesses to one column hit 32 banks), which
// was faster than each thread's local memory at the same registers (PERF.md
// section 6). The proposal tables are read from device memory through L1
// instead of being copied to shared memory, which leaves shared memory to the
// cache at any L.  Both cached forms, K1e and K1c, also copy DDI's
// coefficient rows and feature indices into shared memory ahead of the cache
// (csrc/ddi.cuh am_ddi_shared_load, 28.9 KB): read through the __constant__
// cache, their 29 KB working set thrashed it, 1.64 times K1e's time on DDI's
// state (PERF.md section 6).  The block takes 111.4 KB, so 2 blocks fit an
// SM's 228 KB at up to 256 registers, which keeps K1c's capacity at DDI's L
// at 2 blocks per SM.  K1d, the per-chain launcher with n_sweeps = 1, runs
// K1e's form.
//
// K1d, the pooled route above K1c's bound (the JAX _compiled_pooled: one
// sweep of every chain with pk frozen, then the shared update from the
// sweep's histogram), is one cooperative launch a chunk of its own kernel,
// fused_scan_kernel, compiled in units of its own (AM_SCAN) so that the
// other forms' units stay as they were.  Its grid is what the card holds
// resident, trimmed so that every thread carries ceil(S / capacity) chains
// or one fewer: thread i sweeps chains i, i + G, ... (G the grid's
// threads) at every sweep with the per-chain body above, each chain's k,
// theta and logp loaded from and stored back to device memory (in place:
// a chain belongs to one thread), its stream seeded at that sweep
// (am_stream_init at t, as a one-sweep launch seeds it), and with a cache
// its cache built fresh from theta, logp kept, as a one-sweep K1e launch
// builds it.  rb9's kappa tables are kept across the thread's chains: they
// are keyed by kappa's bits, so whatever another chain filled reads right.
// After its chains, a thread's counts per model are summed by its warp and
// added to K1c's histogram; one grid barrier; then every thread applies
// K1c's update.  So K1d equals the one-sweep route bit for bit in every
// chain field and counter.  Its chunk statistics are partial sums per
// thread over its chains and sweeps ([K | 2KD | 6, G]), which the wrapper
// reduces; threads without a chain join every barrier and count nothing.
//
// Floating point: see common.cuh (built with -fmad=false, no fast math).

#include <cooperative_groups.h>
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
#ifndef AM_K1C_SYMBOL
#define AM_K1C_SYMBOL am_fused_sweep_pooled_p0_t0
#endif
#ifndef AM_K1C_CAP_SYMBOL
#define AM_K1C_CAP_SYMBOL am_fused_sweep_pooled_cap_p0_t0
#endif
#ifndef AM_K1_MAXL_SYMBOL
#define AM_K1_MAXL_SYMBOL am_fused_sweep_max_l_p0_t0
#endif
#ifndef AM_K1_OCC_SYMBOL
#define AM_K1_OCC_SYMBOL am_fused_sweep_occupancy_p0_t0
#endif
// AM_SCAN: a unit of K1d alone (its launcher and grid query).
#ifndef AM_SCAN
#define AM_SCAN 0
#endif
#ifndef AM_K1D_SYMBOL
#define AM_K1D_SYMBOL am_fused_sweep_scan_p0_t0
#endif
#ifndef AM_K1D_GRID_SYMBOL
#define AM_K1D_GRID_SYMBOL am_fused_sweep_scan_grid_p0_t0
#endif

namespace {

constexpr int kLMax = 32;        // mixture components per model (runtime L)
constexpr int kThreads = 128;
constexpr bool kPerm = AM_PERM != 0;
constexpr bool kTdist = AM_TDIST != 0;
// Sweeps between full refreshes of the cache (the JAX _REFRESH).
constexpr int kRefresh = 16;
// The small shapes (K * D <= 6: the tutorial's (3, 2) and below; header
// note): a chain's allocation logits and chunk sums in the thread's column
// of shared memory ([slot][thread]: a warp's 32 accesses to a slot hit 32
// banks), 8 blocks of kThreads per SM.  The shapes of more than 25
// (model, coordinate) pairs, whose kernels hold 206-255 registers, keep
// the sums in registers and the logits in a local array.
template <int K, int D>
__host__ __device__ constexpr bool small_shape() {
  return K * D <= 6;
}

// The shapes that keep a chain's chunk sums and logits in the thread's
// column of shared memory: the small shapes and those of up to 25 (model,
// coordinate) pairs (toy2's (5, 5); header note), the latter at 4 blocks
// per SM.
template <int K, int D>
__host__ __device__ constexpr bool shared_cols() {
  return K * D <= 25;
}

template <int K, int D>
__host__ __device__ constexpr int min_blocks() {
  return small_shape<K, D>() ? 8 : shared_cols<K, D>() ? 4 : 1;
}

// The shape whose model set carries a cache: only its cached form exists.
template <int K, int D>
__host__ __device__ constexpr bool cached_shape() {
  return K == AM_DDI_K && D == AM_DDI_D;
}

// rb9's shape: the rb9 density reads the chain's kappa tables (common.cuh
// am_density_rb9_tab) in the thread's column of shared memory.
template <int K, int D>
__host__ __device__ constexpr bool rb9_shape() {
  return K == AM_RB9_K && D == AM_RB9_D;
}

// Dynamic shared memory of one block: the tables (and at the small shapes
// the threads' chunk sums and logits, at rb9's shape the threads' kappa
// tables), or in the cached form the cache (the tables are then read from
// device memory), after the copy of DDI's coefficient tables.
template <int K, int D, bool kPooled>
size_t sweep_smem(int L) {
  if constexpr (cached_shape<K, D>())
    return sizeof(float) * ((size_t)kAmDdiShared +
                            (size_t)AM_DDI_NCACHE * kThreads);
  const int KL = K * L;
  return sizeof(float) * ((size_t)(K * D + 3 * KL + KL * D + 2 * KL * D * D)
                          + (shared_cols<K, D>() ? (2 * K * D + L) * kThreads
                                                 : 0)
                          + (rb9_shape<K, D>() ? AM_RB9_TAB * kThreads : 0));
}

// Allocation logit of component li of model m at x (dm active rows):
// abase - quad / 2, with quad summed over the rows in row order.
template <int K, int D>
__device__ __forceinline__ float am_logit(int m, int li, const float (&x)[D],
                                          int dm, int L,
                                          const float* abase,
                                          const float* mu,
                                          const float* binv) {
  const int ml = m * L + li;
  float quad = 0.0f;
#pragma unroll
  for (int r = 0; r < D; ++r) {
    if (r >= dm) break;
    float w = binv[ml * D * D + r * D] * (x[0] - mu[ml * D]);
#pragma unroll
    for (int c = 1; c <= r; ++c)
      w = w + binv[ml * D * D + r * D + c] * (x[c] - mu[ml * D + c]);
    quad = (r == 0) ? w * w : quad + w * w;
  }
  return abase[ml] - 0.5f * quad;
}

// Log-probability of component ``idx`` in the allocation of model m at x;
// with ``draw`` (the forward move) idx is first set to the Gumbel argmax
// over the words from slot ``s_g``.  The logits are kept in ``lg`` (the
// thread's shared column at the small shapes, else a local array), then
// folded in component order, as the twin's torch.argmax, _lse and gather:
// the argmax with strict > (the first maximum), mx left to right, then the
// exp-sum left to right.  Folding the Gumbel draws into the pass that
// computes the logits was up to 4% slower at (3, 2) (PERF.md section 6).
template <int K, int D>
__device__ __forceinline__ float am_alloc(int m, const float (&x)[D], int dm,
                                          int L, const float* abase,
                                          const float* mu, const float* binv,
                                          const AmWords& wd, int s_g,
                                          bool draw, int& idx, float* lg) {
  constexpr int kStride = shared_cols<K, D>() ? kThreads : 1;
  for (int li = 0; li < L; ++li)
    lg[li * kStride] = am_logit<K, D>(m, li, x, dm, L, abase, mu, binv);
  float mx = lg[0];
  if (draw) {
    idx = 0;
    float best = lg[0] + am_gumbel(am_u01(wd(s_g)));
    for (int li = 1; li < L; ++li) {
      const float v = lg[li * kStride] + am_gumbel(am_u01(wd(s_g + li)));
      if (v > best) {
        best = v;
        idx = li;
      }
      mx = fmaxf(mx, lg[li * kStride]);
    }
  } else {
    for (int li = 1; li < L; ++li) mx = fmaxf(mx, lg[li * kStride]);
  }
  float se = expf(lg[0] - mx);
  for (int li = 1; li < L; ++li) se = se + expf(lg[li * kStride] - mx);
  return lg[idx * kStride] - (mx + logf(se));
}

// The kernels' parameters, in the order of SweepArgs and coop_launch.
#define AM_SWEEP_PARAMS                                                       \
    int S, int L, uint32_t seed, int sweep0, int n_sweeps, int adapt,         \
    int rng, int chain0, AmT tc,                                              \
    int* __restrict__ ghist, float inv_S,                                     \
    const float* __restrict__ tab, const int* __restrict__ kinds_g,           \
    const float* __restrict__ consts_g, const int* __restrict__ dims_g,       \
    const int* __restrict__ k_in, const float* __restrict__ th_in,            \
    const float* __restrict__ lp_in, const float* __restrict__ pk_in,         \
    const float* __restrict__ pkl_in, const int* __restrict__ nri_in,         \
    int* __restrict__ k_out, float* __restrict__ th_out,                      \
    float* __restrict__ lp_out, float* __restrict__ pk_out,                   \
    float* __restrict__ pkl_out, int* __restrict__ nri_out,                   \
    int* __restrict__ ks_out, float* __restrict__ ts_out,                     \
    float* __restrict__ tq_out, int* __restrict__ cnt_out

// The sweep kernel's forms, their body in fused_sweep_body.cuh: K1 and K1e
// (per-chain pk), K1c (kPooled), and K1d (header note).
template <int K, int D, bool kPooled>
__global__ void __launch_bounds__(kThreads, min_blocks<K, D>())
fused_sweep_kernel(AM_SWEEP_PARAMS) {
#define AM_SCAN_FORM 0
#include "fused_sweep_body.cuh"
#undef AM_SCAN_FORM
}

template <int K, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<K, D>())
fused_scan_kernel(AM_SWEEP_PARAMS) {
  constexpr bool kPooled = false;
#define AM_SCAN_FORM 1
#include "fused_sweep_body.cuh"
#undef AM_SCAN_FORM
}

// Kernel arguments after the launch configuration, in the kernel's order.
struct SweepArgs {
  int S, L;
  unsigned int seed;
  int sweep0, n_sweeps, adapt, rng, chain0;
  AmT tc;
  int* ghist;
  float inv_S;
  const float* tab;
  const int *kinds, *dims;
  const float* consts;
  const int* k_in;
  const float *th_in, *lp_in, *pk_in, *pkl_in;
  const int* nri_in;
  int* k_out;
  float *th_out, *lp_out, *pk_out, *pkl_out;
  int *nri_out, *ks_out;
  float *ts_out, *tq_out;
  int* cnt_out;
};

template <int K, int D, bool kPooled>
cudaError_t set_smem(int L) {
  return cudaFuncSetAttribute(fused_sweep_kernel<K, D, kPooled>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sweep_smem<K, D, kPooled>(L));
}

// Blocks of the cooperative form ``fn`` (K1c or K1d) the current device
// holds resident at once at this L: blocks per SM (occupancy at the
// kernel's registers and shared memory) times SMs; 0 where the device has
// no cooperative launch.
template <int K, int D>
int resident_blocks(const void* fn, int L, int* blocks) {
  const size_t smem = sweep_smem<K, D, true>(L);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = coop ? per_sm * sms : 0;
  return 0;
}

// Chains K1c can hold resident at once on the current device at this L.
template <int K, int D>
int pooled_capacity(int L, int* chains) {
  int blocks = 0;
  const int rc = resident_blocks<K, D>(
      (const void*)fused_sweep_kernel<K, D, true>, L, &blocks);
  *chains = blocks * kThreads;
  return rc;
}

// K1d's grid on the current device, in threads: the blocks it holds
// resident, trimmed so that every thread carries ceil(S / capacity) chains
// or one fewer.
template <int K, int D>
int scan_grid(int S, int L, int* threads) {
  int blocks = 0;
  const int rc = resident_blocks<K, D>(
      (const void*)fused_scan_kernel<K, D>, L, &blocks);
  if (rc != 0) return rc;
  if (blocks == 0) return (int)cudaErrorNotSupported;
  const int cap = blocks * kThreads;
  const int nc = (S + cap - 1) / cap;           // chains a thread carries
  *threads = ((S + nc - 1) / nc + kThreads - 1) / kThreads * kThreads;
  return 0;
}

// Warps of the per-chain kernel (K1, K1e) resident on one SM of the current
// device at this L.
template <int K, int D>
int occupancy(int L, int* warps) {
  cudaError_t e = set_smem<K, D, false>(L);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_sweep_kernel<K, D, false>, kThreads,
      sweep_smem<K, D, false>(L));
  if (e != cudaSuccess) return (int)e;
  *warps = per_sm * kThreads / 32;
  return 0;
}

// The largest L a launch of the kernel takes on the current device: its
// dynamic tables (sweep_smem) and static arrays within one block's opt-in
// shared memory, up to kLMax.
template <int K, int D, bool kPooled>
int max_l(int* L) {
  cudaFuncAttributes fa;
  cudaError_t e =
      cudaFuncGetAttributes(&fa, fused_sweep_kernel<K, D, kPooled>);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, optin = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  int l = kLMax;
  while (l > 0 &&
         fa.sharedSizeBytes + sweep_smem<K, D, kPooled>(l) > (size_t)optin)
    --l;
  *L = l;
  return 0;
}

// A cooperative launch of ``fn`` (K1c or K1d) on ``blocks`` blocks.
int coop_launch(const void* fn, SweepArgs a, int blocks, size_t smem,
                cudaStream_t st) {
  void* args[] = {&a.S, &a.L, &a.seed, &a.sweep0, &a.n_sweeps, &a.adapt,
                  &a.rng, &a.chain0, &a.tc, &a.ghist, &a.inv_S, &a.tab,
                  &a.kinds, &a.consts, &a.dims, &a.k_in, &a.th_in, &a.lp_in,
                  &a.pk_in, &a.pkl_in, &a.nri_in, &a.k_out, &a.th_out,
                  &a.lp_out, &a.pk_out, &a.pkl_out, &a.nri_out, &a.ks_out,
                  &a.ts_out, &a.tq_out, &a.cnt_out};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int K, int D, bool kPooled>
int launch_sweep(SweepArgs a, cudaStream_t st) {
  cudaError_t e = set_smem<K, D, kPooled>(a.L);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (a.S + kThreads - 1) / kThreads;
  const size_t smem = sweep_smem<K, D, kPooled>(a.L);
  if constexpr (kPooled) {
    // refuse a population the card cannot hold resident
    int cap = 0;
    const int rc = pooled_capacity<K, D>(a.L, &cap);
    if (rc != 0) return rc;
    if (a.S > cap) return -2;
    return coop_launch((const void*)fused_sweep_kernel<K, D, true>, a,
                       blocks, smem, st);
  }
  fused_sweep_kernel<K, D, false><<<blocks, kThreads, smem, st>>>(
      a.S, a.L, a.seed, a.sweep0, a.n_sweeps, a.adapt, a.rng, a.chain0, a.tc,
      a.ghist, a.inv_S, a.tab, a.kinds, a.consts, a.dims, a.k_in, a.th_in,
      a.lp_in, a.pk_in, a.pkl_in, a.nri_in, a.k_out, a.th_out, a.lp_out,
      a.pk_out, a.pkl_out, a.nri_out, a.ks_out, a.ts_out, a.tq_out,
      a.cnt_out);
  return (int)cudaGetLastError();
}

// K1d on a grid of G threads (scan_grid; the statistics are sized for it).
// Pooled pk needs K > 1, so no K = 1 form is compiled.
template <int K, int D>
int launch_scan(SweepArgs a, int G, cudaStream_t st) {
  if constexpr (K > 1) {
    int g = 0;
    const int rc = scan_grid<K, D>(a.S, a.L, &g);
    if (rc != 0) return rc;
    if (g != G) return -1;
    return coop_launch((const void*)fused_scan_kernel<K, D>, a,
                       G / kThreads, sweep_smem<K, D, true>(a.L), st);
  }
  return -1;
}

template <int K, int D>
int scan_grid_of(int S, int L, int* threads) {
  if constexpr (K > 1) return scan_grid<K, D>(S, L, threads);
  return -1;
}

AmT t_consts(const float* tconsts) {
  AmT tc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (tconsts) tc = {tconsts[0], tconsts[1], tconsts[2], tconsts[3],
                     tconsts[4]};
  return tc;
}

template <bool kPooled>
int dispatch(int K, int D, SweepArgs a, cudaStream_t st) {
#define AM_CASE(k, d) \
  if (K == k && D == d) return launch_sweep<k, d, kPooled>(a, st);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}

}  // namespace

#ifdef __CUDACC__
#if !AM_SCAN
// Launch on ``stream``; returns cudaGetLastError() after the launch, or -1
// for a (K, D) pair without an instantiation or an L above kLMax.  The form
// follows from (K, D): at the cached shape (AM_DDI_K, AM_DDI_D) the kernel
// evaluates the DDI density with its cache, elsewhere the stateless
// densities of common.cuh.  ``rng`` is the stream, AM_RNG_HASH or AM_RNG_HW
// (K1f).  ``chain0`` is the global index of chain 0 of this launch (the
// chain base): chain i draws the words of global chain chain0 + i, so a
// rank holding chains chain0 ... chain0 + S - 1 of a population split
// across devices draws what one launch over the whole population would
// (0 for a whole population).  ``tconsts`` is a host array of the five
// Student-t constants (AmT); the Normal variants ignore it.
extern "C" int AM_K1_SYMBOL(
    int K, int D, int S, int L, unsigned int seed, int sweep0, int n_sweeps,
    int adapt, int rng, int chain0, const float* tconsts, const void* tab,
    const void* kinds, const void* consts, const void* dims,
    const void* k_in, const void* th_in, const void* lp_in,
    const void* pk_in, const void* pkl_in, const void* nri_in, void* k_out,
    void* th_out, void* lp_out, void* pk_out, void* pkl_out, void* nri_out,
    void* ks_out, void* ts_out, void* tq_out, void* cnt_out, void* stream) {
  if (L < 1 || L > kLMax || S < 1 || chain0 < 0) return -1;
  if (rng != AM_RNG_HASH && rng != AM_RNG_HW) return -1;
  if (kTdist && !tconsts) return -1;
  SweepArgs a = {S, L, seed, sweep0, n_sweeps, adapt, rng, chain0,
                 t_consts(tconsts),
                 nullptr, 0.0f,
                 (const float*)tab, (const int*)kinds, (const int*)dims,
                 (const float*)consts, (const int*)k_in,
                 (const float*)th_in, (const float*)lp_in,
                 (const float*)pk_in, (const float*)pkl_in,
                 (const int*)nri_in, (int*)k_out, (float*)th_out,
                 (float*)lp_out, (float*)pk_out, (float*)pkl_out,
                 (int*)nri_out, (int*)ks_out, (float*)ts_out,
                 (float*)tq_out, (int*)cnt_out};
  return dispatch<false>(K, D, a, (cudaStream_t)stream);
}

// K1c: the same sweeps with pooled pk adaptation (adapt must be 1), over
// a whole population (chain base 0): its update needs every chain.
// ``ghist`` is a zeroed device int[3 * K], ``inv_S`` float32(1 / S).
// Returns -2 when S exceeds the chains the card holds resident
// (AM_K1C_CAP_SYMBOL).
extern "C" int AM_K1C_SYMBOL(
    int K, int D, int S, int L, unsigned int seed, int sweep0, int n_sweeps,
    int rng, const float* tconsts, void* ghist, float inv_S,
    const void* tab, const void* kinds, const void* consts, const void* dims,
    const void* k_in, const void* th_in, const void* lp_in,
    const void* pk_in, const void* pkl_in, const void* nri_in, void* k_out,
    void* th_out, void* lp_out, void* pk_out, void* pkl_out, void* nri_out,
    void* ks_out, void* ts_out, void* tq_out, void* cnt_out, void* stream) {
  if (L < 1 || L > kLMax || S < 1 || K < 2) return -1;
  if (rng != AM_RNG_HASH && rng != AM_RNG_HW) return -1;
  if (kTdist && !tconsts) return -1;
  SweepArgs a = {S, L, seed, sweep0, n_sweeps, 1, rng, 0, t_consts(tconsts),
                 (int*)ghist, inv_S,
                 (const float*)tab, (const int*)kinds, (const int*)dims,
                 (const float*)consts, (const int*)k_in,
                 (const float*)th_in, (const float*)lp_in,
                 (const float*)pk_in, (const float*)pkl_in,
                 (const int*)nri_in, (int*)k_out, (float*)th_out,
                 (float*)lp_out, (float*)pk_out, (float*)pkl_out,
                 (int*)nri_out, (int*)ks_out, (float*)ts_out,
                 (float*)tq_out, (int*)cnt_out};
  return dispatch<true>(K, D, a, (cudaStream_t)stream);
}

// The largest L the per-chain (pooled = 0) or the pooled kernel takes at
// (K, D) on the current device, in ``L``; -1 without an instantiation.
extern "C" int AM_K1_MAXL_SYMBOL(int K, int D, int pooled, int* L) {
#define AM_CASE(k, d) \
  if (K == k && D == d) \
    return pooled ? max_l<k, d, true>(L) : max_l<k, d, false>(L);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}

// Warps of the per-chain kernel resident per SM at (K, D, L) on the current
// device, in ``warps``; -1 without an instantiation.
extern "C" int AM_K1_OCC_SYMBOL(int K, int D, int L, int* warps) {
  if (L < 1 || L > kLMax) return -1;
#define AM_CASE(k, d) \
  if (K == k && D == d) return occupancy<k, d>(L, warps);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}

// Chains K1c can hold resident at (K, D, L) on the current device.
extern "C" int AM_K1C_CAP_SYMBOL(int K, int D, int L, int* chains) {
  if (L < 1 || L > kLMax) return -1;
#define AM_CASE(k, d) \
  if (K == k && D == d) return pooled_capacity<k, d>(L, chains);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}
#else
// K1d: ``n_sweeps`` sweeps of pooled pk adaptation for S chains on a grid
// of ``G`` threads (AM_K1D_GRID_SYMBOL).  ``k_io``, ``th_io`` [D, S] and
// ``lp_io`` hold the chains' state and are updated in place; ``pk_in`` [K],
// ``pkl_in`` and ``nri_in`` [1] are the shared pk, pkllim and nreinit, and
// ``pk_out``, ``pkl_out``, ``nri_out`` receive them; ``ks_out`` [K, G],
// ``ts_out`` and ``tq_out`` [K*D, G] and ``cnt_out`` [6, G] the threads'
// partial chunk statistics.  ``ghist`` is a zeroed device int[3 * K],
// ``inv_S`` float32(1 / S).  Returns -1 for a (K, D) pair without an
// instantiation, K < 2, an L above kLMax, or a G other than the grid's.
extern "C" int AM_K1D_SYMBOL(
    int K, int D, int S, int L, unsigned int seed, int sweep0, int n_sweeps,
    int rng, const float* tconsts, int G, void* ghist, float inv_S,
    const void* tab, const void* kinds, const void* consts, const void* dims,
    void* k_io, void* th_io, void* lp_io, const void* pk_in,
    const void* pkl_in, const void* nri_in, void* pk_out, void* pkl_out,
    void* nri_out,
    void* ks_out, void* ts_out, void* tq_out, void* cnt_out, void* stream) {
  if (L < 1 || L > kLMax || S < 1 || K < 2) return -1;
  if (rng != AM_RNG_HASH && rng != AM_RNG_HW) return -1;
  if (kTdist && !tconsts) return -1;
  SweepArgs a = {S, L, seed, sweep0, n_sweeps, 1, rng, 0, t_consts(tconsts),
                 (int*)ghist, inv_S,
                 (const float*)tab, (const int*)kinds, (const int*)dims,
                 (const float*)consts, nullptr, nullptr, nullptr,
                 (const float*)pk_in, (const float*)pkl_in,
                 (const int*)nri_in, (int*)k_io, (float*)th_io,
                 (float*)lp_io, (float*)pk_out, (float*)pkl_out, (int*)nri_out,
                 (int*)ks_out, (float*)ts_out, (float*)tq_out,
                 (int*)cnt_out};
#define AM_CASE(k, d) \
  if (K == k && D == d) return launch_scan<k, d>(a, G, (cudaStream_t)stream);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}

// K1d's grid for S chains at (K, D, L) on the current device, in threads,
// in ``G``; -1 without an instantiation.
extern "C" int AM_K1D_GRID_SYMBOL(int K, int D, int S, int L, int* G) {
  if (L < 1 || L > kLMax || S < 1) return -1;
#define AM_CASE(k, d) \
  if (K == k && D == d) return scan_grid_of<k, d>(S, L, G);
  AM_SHAPES(AM_CASE)
#undef AM_CASE
  return -1;
}
#endif
#endif
