// Scalar and warp helpers shared by the port's kernels (K1, K4, K5).
//
// Every kernel is built with -fmad=false (kernels/build.py), so these round
// as their plain PyTorch counterparts do.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mansy {

constexpr int kTiles = 64;     // 8x8 tiling
constexpr int kMaxScale = 4;   // max(8 // 2, 8 // 2) dilation rings
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Python/JAX integer modulo and floor division (the divisor is positive).
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}
__device__ __forceinline__ int floor_div(int a, int b) {
  return (a - floor_mod(a, b)) / b;
}

// max(x, 0) that keeps NaN, as jnp.maximum and torch.clamp do.
__device__ __forceinline__ float max0(float x) { return x < 0.f ? 0.f : x; }

// One ring of 3x3 dilation on the 8x8 torus; bit (row * 8 + col).
__device__ __forceinline__ uint64_t dilate(uint64_t c) {
  const uint64_t col0 = 0x0101010101010101ull, col7 = 0x8080808080808080ull;
  const uint64_t right = ((c << 1) & ~col0) | ((c >> 7) & col0);  // col x -> x+1
  const uint64_t left = ((c >> 1) & ~col7) | ((c << 7) & col7);   // col x -> x-1
  const uint64_t d = c | right | left;
  return d | (d << 8) | (d >> 56) | (d >> 8) | (d << 56);         // rows +-1
}

// The 64-bit occupancy mask of a viewport row (tile t is set iff row[t] > 0),
// read by one warp: thread t reads tiles t and t + 32.
__device__ __forceinline__ uint64_t viewport_mask(const float* row, int t) {
  const uint32_t lo = __ballot_sync(kFull, row[t] > 0.f);
  const uint32_t hi = __ballot_sync(kFull, row[t + 32] > 0.f);
  return ((uint64_t)hi << 32) | lo;
}

// BFS ring distance ("scale") of tiles t and t + 32 from the viewport mask
// (ops/allocation.py:viewport_scales); an empty viewport leaves both at 0.
__device__ __forceinline__ void viewport_scales(uint64_t mask, int t, int& s0, int& s1) {
  s0 = 0;
  s1 = 0;
  if (mask == 0ull) return;
  uint64_t cov = mask;
  for (int r = 0; r < kMaxScale; ++r) {
    s0 += ((cov >> t) & 1ull) ? 0 : 1;
    s1 += ((cov >> (t + 32)) & 1ull) ? 0 : 1;
    cov = dilate(cov);
  }
}

}  // namespace mansy
