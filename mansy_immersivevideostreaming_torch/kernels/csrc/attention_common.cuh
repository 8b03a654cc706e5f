// K8's shared pieces: the score reduction that the forward's tile kernels
// (csrc/attention.cu, reduce_scatter_placed) and the backward
// (csrc/attention_backward.cu, reduce_scatter) take their scores by, the
// wide kernels' chunks of a head, the staging of head rows into shared
// memory and the opt-in to more than 48 KB of it.
//
// A score is a dot product over Dh dims, split across a warp as the row
// kernel of the forward takes it: lane l's fmaf chain over dims l, l + 32,
// ... (chain), then the xor butterfly of mansy::warp_sum (offsets 16, 8, 4,
// 2, 1).  reduce_scatter takes M such sums at once and leaves lane s with sum
// s; each value it adds is the butterfly's sum over the same lanes, so every
// score has the butterfly's bits, with one shuffle a score instead of five.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "elem.cuh"

namespace mansy {
namespace attn {

// Heads wider than 256 dims (K8's wide kernels) are taken in chunks of
// kChunkDims, 8 dims a lane a chunk: lane l's dims of chunk c are
// 256 c + l + 32 i (i < 8).  A score's partial is carried from chunk to
// chunk (chain_on) and only then summed over the warp, so it is the fmaf
// chain over dims l, l + 32, ... of the whole head, then the butterfly: the
// one definition every wide kernel, forward and backward, computes.
constexpr int kChunkDims = 256;

// chain, carried on: lane l's share continued from `part` over a chunk's
// dims (Dh counted from the chunk's first dim).
template <int P>
__device__ __forceinline__ float chain_on(float part, const float (&a)[P], const float (&b)[P],
                                          int lane, int Dh) {
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (lane + 32 * i < Dh) part = fmaf(a[i], b[i], part);
  return part;
}

// Lane l's share of a dot product as the forward chains it: fmaf over dims
// l, l + 32, ... below Dh, from 0.
template <int P>
__device__ __forceinline__ float chain(const float (&a)[P], const float (&b)[P], int lane,
                                       int Dh) {
  return chain_on<P>(0.f, a, b, lane, Dh);
}

// Lane l's 8 values of chunk c of a row (0 past Dh), as f32.
template <typename T>
__device__ __forceinline__ void load_chunk(float (&x)[8], const T* row, int c, int lane, int Dh) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = c * kChunkDims + lane + 32 * i;
    x[i] = d < Dh ? to_f32(row[d]) : 0.f;
  }
}

// The warp sums of x[0 .. M-1] (each lane's partials of M dot products), in
// the order of mansy::warp_sum's butterfly: at offsets 16 .. M every lane
// adds its partner's values of all M; at offsets M/2 .. 1 each lane keeps
// the half whose index bit matches its own and adds its partner's values of
// that half.  Lane l returns the sum of product l & (M - 1).
template <int M>
__device__ __forceinline__ float reduce_scatter(float (&x)[M], int lane) {
  constexpr int kLog = M == 32 ? 5 : M == 16 ? 4 : M == 8 ? 3 : 2;  // M = 2^kLog
  static_assert(M == 1 << kLog, "M is 4, 8, 16 or 32");
#pragma unroll
  for (int k = 0; k < 5 - kLog; ++k) {  // offsets 16 .. M
    const int o = 16 >> k;
#pragma unroll
    for (int s = 0; s < M; ++s) x[s] += __shfl_xor_sync(kFull, x[s], o);
  }
#pragma unroll
  for (int k = 0; k < kLog; ++k) {  // offsets M/2 .. 1
    const int o = (M / 2) >> k;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int s = 0; s < M / 2; ++s) {
      if (s >= o) break;
      const float send = up ? x[s] : x[s + o];
      const float keep = up ? x[s + o] : x[s];
      x[s] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return x[0];
}

// reduce_scatter without its selects, for partials the caller places by
// lane: x[p] must hold lane l's partial of product p ^ (l & (M - 1)).  Then
// at every offset below M each lane keeps x[s] and sends x[s + o], and the
// sums are reduce_scatter's (and the butterfly's), item by item.  Lane l
// returns the sum of product l & (M - 1).
template <int M>
__device__ __forceinline__ float reduce_scatter_placed(float (&x)[M]) {
  constexpr int kLog = M == 32 ? 5 : M == 16 ? 4 : M == 8 ? 3 : 2;  // M = 2^kLog
  static_assert(M == 1 << kLog, "M is 4, 8, 16 or 32");
#pragma unroll
  for (int k = 0; k < 5 - kLog; ++k) {  // offsets 16 .. M
    const int o = 16 >> k;
#pragma unroll
    for (int s = 0; s < M; ++s) x[s] += __shfl_xor_sync(kFull, x[s], o);
  }
#pragma unroll
  for (int k = 0; k < kLog; ++k) {  // offsets M/2 .. 1
    const int o = (M / 2) >> k;
#pragma unroll
    for (int s = 0; s < M / 2; ++s) {
      if (s >= o) break;
      x[s] += __shfl_xor_sync(kFull, x[s + o], o);
    }
  }
  return x[0];
}

// Rows [0, rows) of a [*, stride] tensor from src into dst [rows][kD] with
// cp.async (the caller commits and waits), zero past Dh and past `valid`
// rows: 16-byte copies when the rows allow (vec), else 4-byte ones; the CTA's
// `threads` threads share the copies.
template <int kD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t stride, int rows,
                                           int valid, int Dh, bool vec, int tid, int threads) {
  if (vec) {
    for (int e = tid; e < rows * (kD / 4); e += threads) {
      const int r = e / (kD / 4), d = 4 * (e % (kD / 4));
      const bool in = r < valid && d < Dh;
      tc::cp_async16(dst + r * kD + d, in ? src + r * stride + d : src, in);
    }
  } else {
    for (int e = tid; e < rows * kD; e += threads) {
      const int r = e / kD, d = e % kD;
      const bool in = r < valid && d < Dh;
      tc::cp_async4(dst + r * kD + d, in ? src + r * stride + d : src, in);
    }
  }
}

// stage_rows for bf16 rows: plain loads, converted to f32.
template <int kD>
__device__ __forceinline__ void stage_rows(float* dst, const bf16* src, size_t stride, int rows,
                                           int valid, int Dh, bool, int tid, int threads) {
  for (int e = tid; e < rows * kD; e += threads) {
    const int r = e / kD, d = e % kD;
    dst[e] = r < valid && d < Dh ? to_f32(src[r * stride + d]) : 0.f;
  }
}

// Rows as stage_rows copies them, but kept in their element type: f32 rows
// as stage_rows stages them, bf16 rows unconverted (a kernel reads them
// with to_f32), with 16-byte cp.async copies of 8 values when the rows
// allow (vec: Dh a multiple of 8, 16-byte aligned bases), else plain loads.
template <int kD>
__device__ __forceinline__ void stage_rows_as_is(float* dst, const float* src, size_t stride,
                                                 int rows, int valid, int Dh, bool vec, int tid,
                                                 int threads) {
  stage_rows<kD>(dst, src, stride, rows, valid, Dh, vec, tid, threads);
}

template <int kD>
__device__ __forceinline__ void stage_rows_as_is(bf16* dst, const bf16* src, size_t stride,
                                                 int rows, int valid, int Dh, bool vec, int tid,
                                                 int threads) {
  if (vec) {
    for (int e = tid; e < rows * (kD / 8); e += threads) {
      const int r = e / (kD / 8), d = 8 * (e % (kD / 8));
      const bool in = r < valid && d < Dh;
      tc::cp_async16(reinterpret_cast<float*>(dst + r * kD + d),
                     reinterpret_cast<const float*>(in ? src + r * stride + d : src), in);
    }
  } else {
    for (int e = tid; e < rows * kD; e += threads) {
      const int r = e / kD, d = e % kD;
      dst[e] = r < valid && d < Dh ? src[r * stride + d] : from_f32<bf16>(0.f);
    }
  }
}

// A launch of more than 48 KB of dynamic shared memory needs the kernel's
// opt-in first.
template <typename Kernel>
inline cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// len bytes from src to dst (16-byte aligned) with cp.async: 16-byte copies
// where src is 16-byte aligned, else 4-byte ones where it is 4-byte
// aligned; the bytes past the last whole copy (and all of them from a src
// aligned to neither) by plain loads.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int len, int tid,
                                            int threads) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  const int w = at % 16 == 0 ? 16 : at % 4 == 0 ? 4 : 1;
  const int whole = w == 1 ? 0 : len / w;
  for (int e = tid; e < whole; e += threads) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + e * w);
    if (w == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + e * w));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + e * w));
  }
  for (int e = whole * w + tid; e < len; e += threads) dst[e] = src[e];
}

}  // namespace attn
}  // namespace mansy
