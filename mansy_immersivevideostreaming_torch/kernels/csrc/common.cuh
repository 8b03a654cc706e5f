// Scalar and warp helpers shared by the port's kernels (K1, K4, K5, K8), and
// the cp.async helpers of K3, K9 and K10 and the 3xTF32 tensor-core helpers
// of K3 and K10 (mansy::tc).
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

// ---- K3 and K10: cp.async copies and 3xTF32 products on mma.sync ----
namespace tc {

// ---- cp.async: 4 or 16 bytes, zero-filled when !valid (src is then not read) ----
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the newest n has landed
template <int n>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(n)); }

// ---- 3xTF32 on mma.sync.m16n8k8 ----
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo exactly up to lo's rounding: hi is x in TF32, lo the remainder in TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// d += a * b on the tensor cores (not volatile: independent products may interleave)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// acc[i][j] += a[i] * b[j] in 3xTF32, term by term (the two small cross terms,
// then hi * hi), so the MT x NT products of a term issue back to back
template <int MT, int NT, int NA>
__device__ __forceinline__ void products(float (&acc)[MT][NA][4], const uint32_t (&ahi)[MT][4],
                                         const uint32_t (&alo)[MT][4],
                                         const uint32_t (&bhi)[NT][2],
                                         const uint32_t (&blo)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], alo[i], bhi[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], ahi[i], blo[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], ahi[i], bhi[j]);
}
// The A fragment of rows r0 + g (+8), columns k + t (+4) of a row-major tile
// (lane = 4g + t), split into hi and lo.
__device__ __forceinline__ void load_a(const float* p, int stride, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * stride], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * stride + 4], hi[3], lo[3]);
}
// The B fragment of rows k + t (+4), column n + g of a row-major [k][n] tile.
__device__ __forceinline__ void load_b(const float* p, int stride, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split(p[0], hi[0], lo[0]);
  split(p[4 * stride], hi[1], lo[1]);
}

// The A fragment of rows m + g (+8), columns k + t (+4) of a tile stored
// k-major ([k][m]: A read transposed), split into hi and lo.
__device__ __forceinline__ void load_a_t(const float* p, int stride, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * stride], hi[2], lo[2]);
  split(p[4 * stride + 8], hi[3], lo[3]);
}
// The B fragment of rows k + t (+4), column n + g of a tile stored [n][k]
// (B read transposed).
__device__ __forceinline__ void load_b_t(const float* p, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

}  // namespace tc

}  // namespace mansy
