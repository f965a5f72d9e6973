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
// uniform keys).  Each variant is its own compilation unit and exports three
// functions: the per-chain-pk launcher AM_K1_SYMBOL (K1; with n_sweeps = 1 and
// adapt = 0 it is also the per-sweep kernel of the pooled runner, K1d, the JAX
// _built(1, L, S, False)), the pooled-pk launcher AM_K1C_SYMBOL (K1c, the JAX
// in-kernel pooled branch, fused.py:773-779), AM_K1C_CAP_SYMBOL, the number
// of chains K1c can hold resident, AM_K1_MAXL_SYMBOL, the largest L, and
// AM_K1_OCC_SYMBOL, the per-chain kernel's resident warps per SM.  The plain
// PyTorch twin is automix_tpu_torch/kernels/fused.py:sweep_chunk_ref.
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
// the hash the per-sweep runner (K1d) too: the hw stream reseeds at every
// launch, so K1d's one-sweep launches draw other words than K1c's chunk, as
// JAX's _compiled_pooled does against its in-kernel pooled chunk; the gain is
// am_gain(t), the float32 expression the twin and the K1d runner compute in
// torch (kernels/fused.py _gains). Threads past S run a copy of chain 0, count
// nothing and store nothing: they must reach every barrier.
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
// banks), 8 blocks of kThreads per SM.  The larger shapes, whose kernels
// hold 206-255 registers, keep the sums in registers and the logits in a
// local array.
template <int K, int D>
__host__ __device__ constexpr bool small_shape() {
  return K * D <= 6;
}

template <int K, int D>
__host__ __device__ constexpr int min_blocks() {
  return small_shape<K, D>() ? 8 : 1;
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
                          + (small_shape<K, D>() ? (2 * K * D + L) * kThreads
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
  constexpr int kStride = small_shape<K, D>() ? kThreads : 1;
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

template <int K, int D, bool kPooled>
__global__ void __launch_bounds__(kThreads, min_blocks<K, D>())
fused_sweep_kernel(
    int S, int L, uint32_t seed, int sweep0, int n_sweeps, int adapt,
    int rng, AmT tc,
    int* __restrict__ ghist, float inv_S,
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
  // ---- tables -> shared memory (stateless form) -------------------------
  // tab = [sig K*D | loglam K*L | abase K*L | logdet K*L | mu K*L*D |
  //        binv K*L*D*D | B K*L*D*D]
  constexpr bool kCache = cached_shape<K, D>();
  extern __shared__ float smem[];
  __shared__ float consts_s[K * AM_N_CONSTS];
  __shared__ int kinds_s[K];
  __shared__ int dims_s[K];
  __shared__ int hist_s[K];
  const int KL = K * L;
  const int n_tab = K * D + 3 * KL + KL * D + 2 * KL * D * D;
  if constexpr (!kCache)
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) smem[i] = tab[i];
  else
    am_ddi_shared_load(smem, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < K * AM_N_CONSTS; i += blockDim.x)
    consts_s[i] = consts_g[i];
  for (int m = threadIdx.x; m < K; m += blockDim.x) {
    kinds_s[m] = kinds_g[m];
    dims_s[m] = dims_g[m];
    hist_s[m] = 0;
  }
  __syncthreads();
  const float* sig = kCache ? tab : smem;
  const float* loglam = sig + K * D;
  const float* abase = loglam + KL;
  const float* logdet = abase + KL;
  const float* mu = logdet + KL;
  const float* binv = mu + KL * D;
  const float* Bm = binv + KL * D * D;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < S;
  if (!kPooled && !valid) return;
  const int ci = valid ? i : 0;    // K1c: threads past S copy chain 0

  // ---- chain state into registers -----------------------------------------
  int kk = k_in[ci];
  float th[D];
#pragma unroll
  for (int d = 0; d < D; ++d) th[d] = th_in[d * S + ci];
  float lp = lp_in[ci];
  float pk[K];
#pragma unroll
  for (int m = 0; m < K; ++m) pk[m] = pk_in[m * S + ci];
  float pkl = pkl_in[ci];
  int nri = nri_in[ci];
  // visit counts of every model but the last (the last's is n_sweeps less
  // the others'), theta sums of every model: in registers, or at the small
  // shapes in this thread's column of shared memory
  int ks[K];
  constexpr bool kSS = small_shape<K, D>();
  float ts[kSS ? 1 : K * D], tq[kSS ? 1 : K * D];
  float* sums_s = smem + n_tab + threadIdx.x;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    ks[m] = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if constexpr (kSS) {
        sums_s[(m * D + d) * kThreads] = 0.0f;
        sums_s[(K * D + m * D + d) * kThreads] = 0.0f;
      } else {
        ts[m * D + d] = 0.0f;
        tq[m * D + d] = 0.0f;
      }
    }
  }
  // accepts and tries: block accepts, componentwise accepts and tries, RJ
  // accepts (block tries and sweeps follow from sweep0 and n_sweeps)
  int acc_blk = 0, acc_cw = 0, try_cw = 0, acc_rj = 0;

  // The cached forms: the chain's cache of both models' statistics, fresh at
  // the chunk's start state (a chunk boundary refreshes the cache, not
  // logp), after DDI's coefficient tables in shared memory
  [[maybe_unused]] const auto tab0 = am_ddi_tables<0, true>(smem);
  [[maybe_unused]] const auto tab1 = am_ddi_tables<1, true>(smem);
  [[maybe_unused]] const AmDdiCache<kThreads> cache{
      smem + kAmDdiShared + threadIdx.x};
  if constexpr (kCache) {
    am_ddi_cache_full<0>(tab0, th, cache, false);
    am_ddi_cache_full<1>(tab1, th, cache, false);
  }

  // Random word slots of one sweep (kernels/fused.py s_* offsets):
  // D accept words, the RJ accept, L + K + L Gumbel words, D permutation
  // keys with perm, then the perturbation words: D Box-Muller pairs (cos
  // for the RWM move, sin for the latent) or, with Student-t, one Bailey
  // pair each for the RWM move and the latent.
  const int s_uacc = D, s_gall = D + 1, s_gmod = D + 1 + L;
  const int s_gcmp = D + 1 + L + K, s_perm = D + 1 + 2 * L + K;
  const int s_bm = s_perm + (kPerm ? D : 0);
  const int NW = s_bm + (kTdist ? 4 * D : 2 * D);
  // the chain's stream: the hash's counter base, or K1f's state seeded at
  // this launch's first sweep (common.cuh)
  uint64_t st = am_stream_init(rng, seed, sweep0, (uint32_t)i,
                               (uint32_t)i * (uint32_t)NW);
  // RWM perturbation and latent filler of coordinate d this sweep
  auto z_rwm = [&](const AmWords& wd, int d) {
    float u1 = am_u01(wd(s_bm + d));
    float u2 = am_u01(wd(s_bm + D + d));
    if (kTdist) return am_bailey_t(u1, u2, tc);
    return am_bm_radius(u1) * cosf(AM_TWO_PI * u2);
  };
  auto z_lat = [&](const AmWords& wd, int d) {
    if (kTdist)
      return am_bailey_t(am_u01(wd(s_bm + 2 * D + d)),
                         am_u01(wd(s_bm + 3 * D + d)), tc);
    float u1 = am_u01(wd(s_bm + d));
    float u2 = am_u01(wd(s_bm + D + d));
    return am_bm_radius(u1) * sinf(AM_TWO_PI * u2);
  };
  auto lat_lpdf = [&](float w) {
    return kTdist ? am_t_latent(w, tc) : am_normal_latent(w);
  };

  // the allocation logits (am_alloc): after the chunk sums in the thread's
  // shared column at the small shapes, else a local array
  float lg_local[kSS ? 1 : kLMax];
  float* lg = kSS ? sums_s + 2 * K * D * kThreads : lg_local;

  // Log-posterior of model m (dimension dm) at x, a candidate of the
  // current state (kk, th).  At rb9's shape the rb9 density goes through
  // the chain's kappa tables, empty at the launch's start, which follow the
  // current state's kappas; sanitized as am_logpost.
  constexpr bool kRb9 = rb9_shape<K, D>();
  [[maybe_unused]] float* rb9_col = smem + n_tab + threadIdx.x;
  if constexpr (kRb9) am_rb9_tab_clear<kThreads>(rb9_col);
  auto logpost = [&](int m, int dm, const float (&x)[D]) {
    if constexpr (kRb9) {
      if (kinds_s[m] == AM_KIND_RB9) {
        uint32_t ca = 0xffffffffu, cb = 0xffffffffu;
        if (kinds_s[kk] == AM_KIND_RB9)
          am_rb9_keys<D>(consts_s + kk * AM_N_CONSTS, th, ca, cb);
        const float v = am_density_rb9_tab<D, kThreads>(
            consts_s + m * AM_N_CONSTS, dm, x, rb9_col, ca, cb);
        return fminf(fmaxf(v, AM_NEG_INF), -AM_NEG_INF);
      }
    }
    return am_logpost<K, D, true, small_shape<K, D>(), !kRb9>(
        kinds_s[m], consts_s + m * AM_N_CONSTS, dm, x);
  };

  for (int tr = 0; tr < n_sweeps; ++tr) {
    const int t = sweep0 + tr;
    const AmWords wd = am_stream_sweep(rng, seed, t, st);
    const int dk = dims_s[kk];

    // ---- (a) within-model move: block every 10th sweep, else per coord --
    if (t % 10 == 0) {
      float prop[D];
#pragma unroll
      for (int d = 0; d < D; ++d)
        prop[d] = (d < dk) ? th[d] + sig[kk * D + d] * z_rwm(wd, d) : th[d];
      float lpn;
      if constexpr (kCache)
        lpn = (kk == 0) ? am_ddi_logpost<0>(prop, tab0)
                        : am_ddi_logpost<1>(prop, tab1);
      else
        lpn = logpost(kk, dk, prop);
      float acc = (am_u01(wd(0)) < am_accept(lpn - lp)) ? 1.0f : 0.0f;
      if constexpr (kCache) {
        if (acc != 0.0f) {
          am_ddi_cache_full<0>(tab0, prop, cache, true);
          am_ddi_cache_full<1>(tab1, prop, cache, true);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) th[d] = th[d] + acc * (prop[d] - th[d]);
      lp = lp + acc * (lpn - lp);
      acc_blk += (int)acc;
    } else if constexpr (kCache) {
      // K1e: coordinates at run time; theta's entries by compare
#pragma unroll 1
      for (int j = 0; j < dk; ++j) {
        float oldj = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d)
          if (d == j) oldj = th[d];
        const float pj = oldj + sig[kk * D + j] * z_rwm(wd, j);
        float prop[D];
#pragma unroll
        for (int d = 0; d < D; ++d) prop[d] = (d == j) ? pj : th[d];
        const float lpn = (kk == 0)
                              ? am_ddi_lp_coord<0>(tab0, j, prop, oldj, cache)
                              : am_ddi_lp_coord<1>(tab1, j, prop, oldj, cache);
        const float acc =
            (am_u01(wd(j)) < am_accept(lpn - lp)) ? 1.0f : 0.0f;
        if (acc != 0.0f) {
          am_ddi_cache_coord<0>(tab0, j, prop, oldj, cache);
          am_ddi_cache_coord<1>(tab1, j, prop, oldj, cache);
        }
#pragma unroll
        for (int d = 0; d < D; ++d)
          if (d == j) th[d] = th[d] + acc * (pj - th[d]);
        lp = lp + acc * (lpn - lp);
        acc_cw += (int)acc;
        try_cw += 1;
      }
    } else {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (j >= dk) continue;
        float prop[D];
#pragma unroll
        for (int d = 0; d < D; ++d) prop[d] = th[d];
        prop[j] = th[j] + sig[kk * D + j] * z_rwm(wd, j);
        float lpn = logpost(kk, dk, prop);
        float acc = (am_u01(wd(j)) < am_accept(lpn - lp)) ? 1.0f : 0.0f;
        th[j] = th[j] + acc * (prop[j] - th[j]);
        lp = lp + acc * (lpn - lp);
        acc_cw += (int)acc;
        try_cw += 1;
      }
    }

    // ---- (b) reversible jump ---------------------------------------------
    // forward allocation over the chain's own model's components
    int l_idx = 0;
    const float log_palloc = am_alloc<K, D>(kk, th, dk, L, abase, mu, binv,
                                            wd, s_gall, true, l_idx, lg);

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
      float bk = logpk[0] + am_gumbel(am_u01(wd(s_gmod)));
      kn = 0;
#pragma unroll
      for (int m = 1; m < K; ++m) {
        float v = logpk[m] + am_gumbel(am_u01(wd(s_gmod + m)));
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
      float bl = loglam[kn * L] + am_gumbel(am_u01(wd(s_gcmp)));
      for (int li = 1; li < L; ++li) {
        float v = loglam[kn * L + li]
                  + am_gumbel(am_u01(wd(s_gcmp + li)));
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
    for (int d = 0; d < D; ++d) wf[d] = (d < dk) ? work[d] : z_lat(wd, d);
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
        keys[d] = (d < nact) ? am_u01(wd(s_perm + d)) : 1.0f + (float)d;
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
    const float log_pallocn = am_alloc<K, D>(kn, thn, dkn, L, abase, mu,
                                             binv, wd, 0, false, ln, lg);

    // MH accept
    float lpn;
    if constexpr (kCache)
      lpn = (kn == 0) ? am_ddi_logpost<0>(thn, tab0)
                      : am_ddi_logpost<1>(thn, tab1);
    else
      lpn = logpost(kn, dkn, thn);
    logratio = logratio + (lpn - lp);
    logratio = logratio + (log_pallocn - log_palloc);
    logratio = logratio + (loglam[kk * L + l_idx] - loglam[kn * L + ln]);
    logratio = logratio + (logdet[kn * L + ln] - logdet[kk * L + l_idx]);
    const float accf =
        (am_u01(wd(s_uacc)) < am_accept(logratio)) ? 1.0f : 0.0f;
    const int acci = (int)accf;
    if constexpr (kCache) {
      if (acci) {
        am_ddi_cache_full<0>(tab0, thn, cache, true);
        am_ddi_cache_full<1>(tab1, thn, cache, true);
      }
    }
    kk = kk + acci * (kn - kk);
#pragma unroll
    for (int d = 0; d < D; ++d) th[d] = th[d] + accf * (thn[d] - th[d]);
    lp = lp + accf * (lpn - lp);
    if constexpr (kCache) {
      // periodic refresh of the cache and logp from the state (keyed on
      // the global sweep, so a resume at a chunk boundary replays it)
      if (t % kRefresh == kRefresh - 1) {
        am_ddi_cache_full<0>(tab0, th, cache, false);
        am_ddi_cache_full<1>(tab1, th, cache, false);
        const auto col0 = [&](int c) { return cache[AmDdi<0>::kOff + c]; };
        const auto col1 = [&](int c) { return cache[AmDdi<1>::kOff + c]; };
        lp = (kk == 0) ? am_ddi_lp<0>(th, col0) : am_ddi_lp<1>(th, col1);
      }
    }

    // ---- (c) pk diminishing adaptation with the re-init safeguard --------
    if (adapt && K > 1) {
      // K1c: this sweep's population histogram (header note)
      const int* gh = nullptr;
      if constexpr (kPooled) {
        gh = ghist + (tr % 3) * K;
        const int lane = threadIdx.x & 31;
#pragma unroll
        for (int m = 0; m < K; ++m) {
          const unsigned b = __ballot_sync(0xffffffffu, valid && kk == m);
          if (lane == 0 && b != 0u) atomicAdd(&hist_s[m], __popc(b));
        }
        __syncthreads();
        if (threadIdx.x < K) {
          const int c = hist_s[threadIdx.x];
          hist_s[threadIdx.x] = 0;
          if (c != 0) atomicAdd(ghist + (tr % 3) * K + threadIdx.x, c);
        }
        cooperative_groups::this_grid().sync();
        if (blockIdx.x == 0 && threadIdx.x < K)
          ghist[((tr + 2) % 3) * K + threadIdx.x] = 0;
      }
      const float gamma = am_gain(t);
      float newpk[K];
      bool reinit = false;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        float oh;
        if constexpr (kPooled)
          oh = (float)__ldcg(gh + m) * inv_S;
        else
          oh = (kk == m) ? 1.0f : 0.0f;
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
    for (int m = 0; m < K - 1; ++m) ks[m] += (m == kk) ? 1 : 0;
    if constexpr (kSS) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float* s1 = sums_s + (kk * D + d) * kThreads;
        float* s2 = sums_s + (K * D + kk * D + d) * kThreads;
        *s1 = *s1 + th[d];
        *s2 = *s2 + th[d] * th[d];
      }
    } else {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (m != kk) continue;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          ts[m * D + d] = ts[m * D + d] + th[d];
          tq[m * D + d] = tq[m * D + d] + th[d] * th[d];
        }
      }
    }
    acc_rj += acci;
  }

  // ---- state and per-chain statistics out -----------------------------------
  if (!valid) return;
  k_out[i] = kk;
#pragma unroll
  for (int d = 0; d < D; ++d) th_out[d * S + i] = th[d];
  lp_out[i] = lp;
#pragma unroll
  for (int m = 0; m < K; ++m) pk_out[m * S + i] = pk[m];
  pkl_out[i] = pkl;
  nri_out[i] = nri;
  int ks_last = n_sweeps;
#pragma unroll
  for (int m = 0; m < K - 1; ++m) {
    ks_out[m * S + i] = ks[m];
    ks_last -= ks[m];
  }
  ks_out[(K - 1) * S + i] = ks_last;
#pragma unroll
  for (int j = 0; j < K * D; ++j) {
    if constexpr (kSS) {
      ts_out[j * S + i] = sums_s[j * kThreads];
      tq_out[j * S + i] = sums_s[(K * D + j) * kThreads];
    } else {
      ts_out[j * S + i] = ts[j];
      tq_out[j * S + i] = tq[j];
    }
  }
  // sweeps t in [sweep0, sweep0 + n_sweeps) with t % 10 == 0 (block moves)
  const int n_blk = (sweep0 + n_sweeps + 9) / 10 - (sweep0 + 9) / 10;
  const int cnt[6] = {acc_blk, n_blk, acc_cw, try_cw, acc_rj, n_sweeps};
#pragma unroll
  for (int c = 0; c < 6; ++c) cnt_out[c * S + i] = cnt[c];
}

// Kernel arguments after the launch configuration, in the kernel's order.
struct SweepArgs {
  int S, L;
  unsigned int seed;
  int sweep0, n_sweeps, adapt, rng;
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

// Chains K1c can hold resident at once on the current device at this L:
// blocks per SM (occupancy at the kernel's registers and shared memory)
// times SMs times kThreads; 0 where the device has no cooperative launch.
template <int K, int D>
int pooled_capacity(int L, int* chains) {
  cudaError_t e = set_smem<K, D, true>(L);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_sweep_kernel<K, D, true>, kThreads,
      sweep_smem<K, D, true>(L));
  if (e != cudaSuccess) return (int)e;
  *chains = coop ? per_sm * sms * kThreads : 0;
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

template <int K, int D, bool kPooled>
int launch_sweep(SweepArgs a, cudaStream_t st) {
  cudaError_t e = set_smem<K, D, kPooled>(a.L);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + kThreads - 1) / kThreads);
  const size_t smem = sweep_smem<K, D, kPooled>(a.L);
  if constexpr (kPooled) {
    // refuse a population the card cannot hold resident
    int cap = 0;
    const int rc = pooled_capacity<K, D>(a.L, &cap);
    if (rc != 0) return rc;
    if (a.S > cap) return -2;
    void* args[] = {&a.S, &a.L, &a.seed, &a.sweep0, &a.n_sweeps, &a.adapt,
                    &a.rng, &a.tc, &a.ghist, &a.inv_S, &a.tab, &a.kinds,
                    &a.consts, &a.dims, &a.k_in, &a.th_in, &a.lp_in,
                    &a.pk_in, &a.pkl_in, &a.nri_in, &a.k_out, &a.th_out,
                    &a.lp_out, &a.pk_out, &a.pkl_out, &a.nri_out, &a.ks_out,
                    &a.ts_out, &a.tq_out, &a.cnt_out};
    e = cudaLaunchCooperativeKernel(
        (const void*)fused_sweep_kernel<K, D, true>, grid,
        dim3(kThreads), args, smem, st);
    if (e != cudaSuccess) return (int)e;
  } else {
    fused_sweep_kernel<K, D, false><<<grid, kThreads, smem, st>>>(
        a.S, a.L, a.seed, a.sweep0, a.n_sweeps, a.adapt, a.rng, a.tc,
        a.ghist, a.inv_S, a.tab, a.kinds, a.consts, a.dims, a.k_in, a.th_in,
        a.lp_in, a.pk_in, a.pkl_in, a.nri_in, a.k_out, a.th_out, a.lp_out,
        a.pk_out, a.pkl_out, a.nri_out, a.ks_out, a.ts_out, a.tq_out,
        a.cnt_out);
  }
  return (int)cudaGetLastError();
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
// Launch on ``stream``; returns cudaGetLastError() after the launch, or -1
// for a (K, D) pair without an instantiation or an L above kLMax.  The form
// follows from (K, D): at the cached shape (AM_DDI_K, AM_DDI_D) the kernel
// evaluates the DDI density with its cache, elsewhere the stateless
// densities of common.cuh.  ``rng`` is the stream, AM_RNG_HASH or AM_RNG_HW
// (K1f).  ``tconsts`` is a host array of the five Student-t constants (AmT);
// the Normal variants ignore it.
extern "C" int AM_K1_SYMBOL(
    int K, int D, int S, int L, unsigned int seed, int sweep0, int n_sweeps,
    int adapt, int rng, const float* tconsts, const void* tab,
    const void* kinds, const void* consts, const void* dims,
    const void* k_in, const void* th_in, const void* lp_in,
    const void* pk_in, const void* pkl_in, const void* nri_in, void* k_out,
    void* th_out, void* lp_out, void* pk_out, void* pkl_out, void* nri_out,
    void* ks_out, void* ts_out, void* tq_out, void* cnt_out, void* stream) {
  if (L < 1 || L > kLMax || S < 1) return -1;
  if (rng != AM_RNG_HASH && rng != AM_RNG_HW) return -1;
  if (kTdist && !tconsts) return -1;
  SweepArgs a = {S, L, seed, sweep0, n_sweeps, adapt, rng, t_consts(tconsts),
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

// K1c: the same sweeps with pooled pk adaptation (adapt must be 1).
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
  SweepArgs a = {S, L, seed, sweep0, n_sweeps, 1, rng, t_consts(tconsts),
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
#endif
