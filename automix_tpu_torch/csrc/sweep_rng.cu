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
// 3.35 TB/s against ~2 us of operations.  This first version runs one
// thread per row and writes each row's words with a stride of MU (or MZ)
// floats, so its stores are not coalesced; a later version would stage a
// block's rows in shared memory and store them as wide contiguous lines.
//
// Floating point: built with -fmad=false and no fast math (see
// common.cuh), so log1pf, sqrtf, cosf and sinf are the accurate library
// versions that torch's CUDA kernels also call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// The word of index ``w`` of a row, with the row's last Philox group kept
// in (g, c) so that consecutive words cost one call per four.
struct WordStream {
  uint32_t rib, k0, k1;
  int g = -1;
  uint4 c;
  __device__ uint32_t operator()(int w) {
    if (w / 4 != g) {
      g = w / 4;
      c = philox(make_uint4(rib, (uint32_t)g, 0u, 0u), k0, k1);
    }
    return lane(c, w & 3);
  }
};

__global__ void __launch_bounds__(kThreads) sweep_rng_kernel(
    int S, int MU, int MZ, int cb, uint32_t seed, uint32_t sweep,
    int block0, float* __restrict__ u, float* __restrict__ z) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= S) return;
  const uint32_t k0 = seed + (uint32_t)(block0 + row / cb) * kW0;
  const uint32_t rib = (uint32_t)(row % cb);
  WordStream uw{rib, k0, sweep};
  float* urow = u + (size_t)row * MU;
  for (int w = 0; w < MU; ++w) urow[w] = u01(uw(w));
  const int np = (MZ + 1) / 2;
  WordStream s1{rib, k0, sweep}, s2{rib, k0, sweep};
  float* zrow = z + (size_t)row * MZ;
  for (int p = 0; p < np; ++p) {
    const float u1 = u01(s1(MU + p));
    const float u2 = u01(s2(MU + np + p));
    const float r = sqrtf(-2.0f * log1pf(-u1));
    const float ang = 6.283185307179586f * u2;
    zrow[p] = r * cosf(ang);
    if (np + p < MZ) zrow[np + p] = r * sinf(ang);
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
  const dim3 grid((S + kThreads - 1) / kThreads);
  sweep_rng_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      S, MU, MZ, cb, seed, sweep, block0, (float*)u, (float*)z);
  return (int)cudaGetLastError();
}
