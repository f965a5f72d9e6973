// K4: one stage-3 sweep's uniforms and normals for the general engine.
//
// Replaces the Pallas kernel of automix_tpu/kernels/sweep_rng.py (draw ->
// _kernel, pallas_call at line 139).  The plain PyTorch twin is
// automix_tpu_torch/kernels/sweep_rng.py:draw_ref, and the engine that
// calls it is kernels/rjmcmc.py with rng="pallas".
//
// The TPU kernel seeds the core's hardware PRNG per (seed, sweep, global
// chain block); no GPU has that generator, so each chain row here runs
// Philox-4x32-10 (Salmon et al., SC'11) with
//   key     = (seed + block * 0x9E3779B9 mod 2^32, sweep),
//   counter = (row in block, word group, 0, 0),
// block = block0 + row / cb.  A row's W = MU + 2 * ceil(MZ / 2) words come
// four per Philox call; the words depend only on (seed, sweep, global
// block, row in block), so a shard that passes its first global block as
// block0 draws the rows of the unsharded draw.  Every word becomes a
// uniform u = (w >> 8) * 2^-24 + 2^-25, clamped to 1 - 2^-24 (strictly
// inside (0, 1), the contract of the TPU kernel's _uniform01).  Words
// [0, MU) are the uniforms; words MU + p and MU + ceil(MZ/2) + p are the
// Box-Muller pair p: r = sqrt(-2 log1p(-u1)), z[p] = r cos(2 pi u2) and
// z[ceil(MZ/2) + p] = r sin(2 pi u2) while that column is < MZ (the cos
// half first, then the sin half, as the TPU kernel's concatenation).
//
// What bounds it on the H100: bytes.  A row writes (MU + MZ) * 4 bytes and
// runs ~25 integer operations per word plus ~80 per normal pair, so at the
// tutorial's 131072 x (25 + 4) the 15.2 MB of output take ~4.5 us at
// 3.35 TB/s against ~2 us of operations.  So a block takes a tile of up to
// kRows consecutive rows and works in three passes over shared memory:
// (1) every (row, Philox group) of the tile once, rows fastest, its four
// uniforms into the tile's uniform rows [R][MU] or its pair rows [R][2 np];
// (2) Box-Muller per (row, pair) into the normal rows [R][MZ]; (3) the u
// tile (R * MU floats) and the z tile (R * MZ floats), which are contiguous
// in the row-major outputs, stored by consecutive threads as consecutive
// 16-byte vectors where the tile starts on 16 bytes (from shared memory
// laid out as the output), else as consecutive floats.  A tile too wide for
// 48 KB of shared memory takes fewer rows, or raises the block's limit; a
// row too wide for one block's shared memory (W + MZ > ~58000 floats) is
// drawn by kernel sweep_rng_rows, one thread per row storing each word
// where it lands.
//
// Floating point: built with -fmad=false and no fast math (see
// common.cuh), so log1pf, sqrtf, cosf and sinf are the accurate library
// versions that torch's CUDA kernels also call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;       // rows per tile (a power of two)
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t lane(uint4 c, int j) {
  return j == 0 ? c.x : (j == 1 ? c.y : (j == 2 ? c.z : c.w));
}

__device__ __forceinline__ float u01(uint32_t w) {
  const float u = (float)(int)(w >> 8) * 5.9604644775390625e-08f
                  + 2.98023223876953125e-08f;
  return fminf(u, 0.999999940395355224609375f);
}

// Philox group g of global row ``row``.
__device__ __forceinline__ uint4 row_group(int row, int g, int cb,
                                           uint32_t seed, uint32_t sweep,
                                           int block0) {
  const uint32_t k0 = seed + (uint32_t)(block0 + row / cb) * kW0;
  return philox(make_uint4((uint32_t)(row % cb), (uint32_t)g, 0u, 0u), k0,
                sweep);
}

// The normals of Box-Muller pair (u1, u2): r cos(2 pi u2), r sin(2 pi u2).
__device__ __forceinline__ float2 box_muller(float u1, float u2) {
  const float r = sqrtf(-2.0f * log1pf(-u1));
  const float ang = 6.283185307179586f * u2;
  return make_float2(r * cosf(ang), r * sinf(ang));
}

// Floats of a tile of ``rows`` rows in shared memory: uniform rows, pair
// rows, then normal rows from a 16-byte boundary.
__host__ __device__ inline size_t tile_floats(int rows, int MU, int MZ) {
  const int np = (MZ + 1) / 2;
  const size_t head = (size_t)rows * (MU + 2 * np);
  return (head + 3) / 4 * 4 + (size_t)rows * MZ;
}

// Store ``n`` floats of shared ``src`` to ``dst``: 16-byte vectors by
// consecutive threads where ``dst`` starts on 16 bytes (``src`` always
// does), then the tail; else floats by consecutive threads.
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float* src, int n) {
  int start = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int v = threadIdx.x; v < n4; v += blockDim.x) d4[v] = s4[v];
    start = 4 * n4;
  }
  for (int x = start + threadIdx.x; x < n; x += blockDim.x) dst[x] = src[x];
}

// One tile of ``rows`` rows (a power of two, 1 << lg_rows) per block.
__global__ void __launch_bounds__(kThreads) sweep_rng_tile(
    int S, int MU, int MZ, int cb, uint32_t seed, uint32_t sweep,
    int block0, int lg_rows, float* __restrict__ u, float* __restrict__ z) {
  extern __shared__ __align__(16) float tile[];
  const int rows = 1 << lg_rows;
  const int np = (MZ + 1) / 2;
  const int ng = (MU + 2 * np + 3) / 4;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, S - r0);
  float* const us = tile;                        // [rows][MU]
  float* const ps = tile + (size_t)rows * MU;    // [rows][2 np]
  float* const zs = tile + (tile_floats(rows, MU, MZ) - (size_t)rows * MZ);
  // (1) every (row, group) of the tile once, rows fastest
  for (int q = threadIdx.x; q < rows * ng; q += blockDim.x) {
    const int r = q & (rows - 1), g = q >> lg_rows;
    if (r >= nr) continue;
    const uint4 c = row_group(r0 + r, g, cb, seed, sweep, block0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = 4 * g + j;
      if (w < MU)
        us[r * MU + w] = u01(lane(c, j));
      else if (w < MU + 2 * np)
        ps[r * 2 * np + (w - MU)] = u01(lane(c, j));
    }
  }
  __syncthreads();
  // (2) Box-Muller per (row, pair), rows fastest
  for (int q = threadIdx.x; q < rows * np; q += blockDim.x) {
    const int r = q & (rows - 1), p = q >> lg_rows;
    if (r >= nr) continue;
    const float2 zz = box_muller(ps[r * 2 * np + p], ps[r * 2 * np + np + p]);
    zs[r * MZ + p] = zz.x;
    if (np + p < MZ) zs[r * MZ + np + p] = zz.y;
  }
  __syncthreads();
  // (3) the u and z tiles, contiguous in the outputs
  store_tile(u + (size_t)r0 * MU, us, nr * MU);
  store_tile(z + (size_t)r0 * MZ, zs, nr * MZ);
}

// The words of one row by index, the row's last Philox group kept in
// (g, c) so that consecutive words cost one call per four.
struct WordStream {
  int row, cb;
  uint32_t seed, sweep;
  int block0;
  int g = -1;
  uint4 c;
  __device__ float operator()(int w) {
    if (w / 4 != g) {
      g = w / 4;
      c = row_group(row, g, cb, seed, sweep, block0);
    }
    return u01(lane(c, w & 3));
  }
};

// One thread per row, each word stored where it lands: rows too wide for
// a tile in shared memory.
__global__ void __launch_bounds__(kThreads) sweep_rng_rows(
    int S, int MU, int MZ, int cb, uint32_t seed, uint32_t sweep,
    int block0, float* __restrict__ u, float* __restrict__ z) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= S) return;
  const int np = (MZ + 1) / 2;
  WordStream uw{row, cb, seed, sweep, block0};
  float* urow = u + (size_t)row * MU;
  for (int w = 0; w < MU; ++w) urow[w] = uw(w);
  WordStream s1 = uw, s2 = uw;
  float* zrow = z + (size_t)row * MZ;
  for (int p = 0; p < np; ++p) {
    const float2 zz = box_muller(s1(MU + p), s2(MU + np + p));
    zrow[p] = zz.x;
    if (np + p < MZ) zrow[np + p] = zz.y;
  }
}

}  // namespace

// Draw one sweep's u [S, MU] and z [S, MZ] (row-major float32) on
// ``stream``; ``cb`` is the chain block (rows per Philox key), ``block0``
// the first global block.  Returns cudaGetLastError() after the launch, or
// -1 for arguments the kernel does not take.
extern "C" int am_sweep_rng(int S, int MU, int MZ, int cb, unsigned int seed,
                            unsigned int sweep, int block0, void* u, void* z,
                            void* stream) {
  if (S < 1 || MU < 0 || MZ < 0 || cb < 1 || S % cb != 0 || block0 < 0)
    return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  // the widest tile within 48 KB, else within the block's opt-in limit
  int lg = 0;
  while ((1 << lg) < kRows) ++lg;
  size_t bytes = sizeof(float) * tile_floats(1 << lg, MU, MZ);
  if (bytes > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    while (lg > 0 && sizeof(float) * tile_floats(1 << lg, MU, MZ) >
                         (size_t)(48 * 1024))
      --lg;
    bytes = sizeof(float) * tile_floats(1 << lg, MU, MZ);
    if (bytes > 48 * 1024 && bytes <= (size_t)optin) {
      e = cudaFuncSetAttribute(sweep_rng_tile,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
      if (e != cudaSuccess) return (int)e;
    } else if (bytes > (size_t)optin) {
      sweep_rng_rows<<<(S + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          S, MU, MZ, cb, seed, sweep, block0, (float*)u, (float*)z);
      return (int)cudaGetLastError();
    }
  }
  const int rows = 1 << lg;
  sweep_rng_tile<<<(S + rows - 1) / rows, kThreads, bytes, st>>>(
      S, MU, MZ, cb, seed, sweep, block0, lg, (float*)u, (float*)z);
  return (int)cudaGetLastError();
}
