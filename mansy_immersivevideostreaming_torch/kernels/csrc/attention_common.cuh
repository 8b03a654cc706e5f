// K8's shared pieces: the score reduction that the forward's tile kernels
// (csrc/attention.cu, reduce_scatter_placed) and the backward
// (csrc/attention_backward.cu, reduce_scatter) take their scores by, the
// wide kernels' chunks of a head, the score tile and P . v on the tensor
// cores (the streamed forward: score_tile, pv_tile; past 128 dims the wide
// score tile that the streamed forward and the wide backward share:
// wide_score_chunk, wide_score_put, wide_score_sum), the softmax's exp2,
// the staging of head rows into shared memory and the opt-in to more than
// 48 KB of it.
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

// 2^x on the SFU, results below f32's normal range flushed to 0 (an exp of
// the softmax that small adds nothing to a sum of terms up to 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- the score tile on the tensor cores (the streamed forward) ----
//
// A warp takes 16 query rows (one m16 fragment of mma.sync) against a key
// tile of kN keys.  Its scores sit in the mma's accumulator layout: lane
// 4 g + t holds s[n][0], s[n][1] (row g, keys 8 n + 2 t and 8 n + 2 t + 1)
// and s[n][2], s[n][3] (row g + 8, the same keys).  q and k are rows in
// shared memory of LD elements, zero past the valid dims and keys.
//
// f32: 3xTF32 on m16n8k8 (mansy::tc: x = hi + lo, lo.hi + hi.lo + hi.hi a
// k-step, in that order), as K3 and K10 take their products; plain TF32
// would keep some 11 bits of each product.  bf16: m16n8k16 with f32
// accumulators, whose bf16 products are exact: JAX's f32 sum of exact
// products (preferred_element_type=f32) in the tensor cores' order.

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 values rounded to bf16 (to nearest even) as the bf16 pair of an
// mma operand (the first in the low half)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d += a * b, bf16 m16n8k16 with f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s += q . k^T over kDims dims of a chunk: the warp's 16 rows q [16][LD]
// against the tile's rows k [kN][LD]; only the key groups of 8 below
// `keys` and the k-steps below `dims` (both the same for the whole warp).
template <int kN, int kDims, int LD>
__device__ __forceinline__ void score_tile(float (&s)[kN / 8][4], const float* q, const float* k,
                                           int keys, int dims, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kDims / 8; ++kk) {
    if (kk * 8 < dims) {
      uint32_t ahi[4], alo[4];
      tc::load_a(q + g * LD + kk * 8 + t, LD, ahi, alo);
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
        if (n * 8 < keys) {
          uint32_t bhi[2], blo[2];
          tc::load_b_t(k + (n * 8 + g) * LD + kk * 8 + t, bhi, blo);
          tc::mma(s[n], alo, bhi);
          tc::mma(s[n], ahi, blo);
          tc::mma(s[n], ahi, bhi);
        }
      }
    }
  }
}

template <int kN, int kDims, int LD>
__device__ __forceinline__ void score_tile(float (&s)[kN / 8][4], const bf16* q, const bf16* k,
                                           int keys, int dims, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kDims / 16; ++kk) {
    if (kk * 16 < dims) {
      const bf16* qa = q + g * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LD), ld_pair(qa + 8),
                             ld_pair(qa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
        if (n * 8 < keys) {
          const bf16* kb = k + (n * 8 + g) * LD + kk * 16 + 2 * t;
          const uint32_t b[2] = {ld_pair(kb), ld_pair(kb + 8)};
          mma_bf16(s[n], a, b);
        }
      }
    }
  }
}

// o += p . v over a key tile: p the warp's 16 x kN probabilities in
// score_tile's layout (f32; bf16's rounded as they are packed), v the tile's rows [kN][LD]
// of kDims output dims (zero past the valid keys and dims); only the key
// steps below `keys` and the output groups of 8 below `dims`.  f32: a key
// step of 8 takes p's group n as the mma's A with its keys in the order
// 2 t, 2 t + 1 of each lane's pair (a0 = s0, a2 = s1, a1 = s2, a3 = s3), and
// v's rows in that order, so no lane trades its values; 3xTF32.
template <int kN, int kDims, int LD>
__device__ __forceinline__ void pv_tile(float (&o)[kDims / 8][4], const float (&p)[kN / 8][4],
                                        const float* v, int keys, int dims, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    if (n * 8 < keys) {
      uint32_t ahi[4], alo[4];
      tc::split(p[n][0], ahi[0], alo[0]);
      tc::split(p[n][2], ahi[1], alo[1]);
      tc::split(p[n][1], ahi[2], alo[2]);
      tc::split(p[n][3], ahi[3], alo[3]);
      const float* vb = v + (n * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int d = 0; d < kDims / 8; ++d) {
        if (d * 8 < dims) {
          uint32_t bhi[2], blo[2];
          tc::split(vb[d * 8], bhi[0], blo[0]);
          tc::split(vb[LD + d * 8], bhi[1], blo[1]);
          tc::mma(o[d], alo, bhi);
          tc::mma(o[d], ahi, blo);
          tc::mma(o[d], ahi, bhi);
        }
      }
    }
  }
}

// bf16: a key step of 16 takes p's groups 2 n and 2 n + 1 as the A operand,
// each p rounded to bf16 (to nearest even) as it is packed: P's one rounding;
// v's B operands by ldmatrix .trans, two output groups of 8 a load.
template <int kN, int kDims, int LD>
__device__ __forceinline__ void pv_tile(float (&o)[kDims / 8][4], const float (&p)[kN / 8][4],
                                        const bf16* v, int keys, int dims, int lane) {
  static_assert(kDims % 16 == 0, "output dims in pairs of groups of 8");
#pragma unroll
  for (int n = 0; n < kN / 16; ++n) {
    if (n * 16 < keys) {
      const uint32_t a[4] = {bf16_pair(p[2 * n][0], p[2 * n][1]),
                             bf16_pair(p[2 * n][2], p[2 * n][3]),
                             bf16_pair(p[2 * n + 1][0], p[2 * n + 1][1]),
                             bf16_pair(p[2 * n + 1][2], p[2 * n + 1][3])};
      // lane i addresses row (key) 16 n + (i & 15) of output group 2 d + (i >> 4)
      const bf16* vb = v + (n * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int d = 0; d < kDims / 16; ++d) {
        if (d * 16 < dims) {
          uint32_t b0[2], b1[2];
          const unsigned at = (unsigned)__cvta_generic_to_shared(vb + d * 16);
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
                       : "r"(at));
          mma_bf16(o[2 * d], a, b0);
          mma_bf16(o[2 * d + 1], a, b1);
        }
      }
    }
  }
}

// ---- the wide score tile (heads past 128 dims) ----
//
// 16 rows against a key tile of kN keys over a head taken in chunks of
// kChunkDims dims, each chunk split into kWideSplit parts of kWideDims dims:
// part p's products of a chunk (score_tile over dims [64 p, 64 p + 64))
// start from a zero accumulator and are added to the part's partial in f32
// (the tensor cores round their f32 sums toward zero, so a long chain
// drifts); the parts' partials are then summed in part order through shared
// memory (wide_score_put, a __syncthreads, wide_score_sum).  A score is the
// same sum of the same terms whatever warp takes a part, so the streamed
// forward's kWide instances (a warp a part) and the wide backward
// (csrc/attention_backward_wide.cu: a warp a part of the scores, another of
// dO . v^T) take one definition of it, bit for bit.
constexpr int kWideSplit = 4;
constexpr int kWideDims = kChunkDims / kWideSplit;

// sc += part `part`'s share of q . k^T over a chunk: q [16][LS] and k [kN][LS]
// the chunk's rows (zero past the valid rows and dims), `dims` the head's dims
// from the chunk's first, only the key groups of 8 below `keys`.
template <int kN, int LS, typename T>
__device__ __forceinline__ void wide_score_chunk(float (&sc)[kN / 8][4], const T* q, const T* k,
                                                 int keys, int dims, int part, int lane) {
  float x[kN / 8][4];
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
  if (keys > 0)
    score_tile<kN, kWideDims, LS>(x, q + part * kWideDims, k + part * kWideDims, keys,
                                  dims - part * kWideDims, lane);
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] += x[n][e];
}

// A part's partial scores into red [kWideSplit][32][kN / 2] (its lane's row).
template <int kN>
__device__ __forceinline__ void wide_score_put(const float (&sc)[kN / 8][4], float* red, int part,
                                               int lane) {
  float4* mine = reinterpret_cast<float4*>(red + (part * 32 + lane) * (kN / 2));
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) mine[n] = make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
}

// The scores: the kWideSplit partials of red summed in part order.
template <int kN>
__device__ __forceinline__ void wide_score_sum(float (&sc)[kN / 8][4], const float* red,
                                               int lane) {
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    float4 x = reinterpret_cast<const float4*>(red + lane * (kN / 2))[n];
    sc[n][0] = x.x, sc[n][1] = x.y, sc[n][2] = x.z, sc[n][3] = x.w;
#pragma unroll
    for (int w = 1; w < kWideSplit; ++w) {
      x = reinterpret_cast<const float4*>(red + (w * 32 + lane) * (kN / 2))[n];
      sc[n][0] += x.x, sc[n][1] += x.y, sc[n][2] += x.z, sc[n][3] += x.w;
    }
  }
}

// Rows [0, rows) of a [*, stride] tensor, up to kW elements each, into dst
// [rows][LD] in shared memory: the elements below `dims` (zero past `valid`
// rows), zeros from there up to the next multiple of 16 (the mma k-steps and
// output groups that read past `dims` read zeros), nothing beyond (never
// read).  Where vec (dims a multiple of 16 bytes, 16-byte aligned rows) by
// 16-byte cp.async copies (the caller commits and waits); else by plain
// loads, 8 in flight a thread (4-byte copies of every value cost more).
template <int kW, int LD, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, size_t stride, int rows,
                                           int valid, int dims, bool vec, int tid, int threads) {
  constexpr int kV = 16 / sizeof(T);  // values a 16-byte copy
  const int width = min(kW, (dims + 15) / 16 * 16);
  if (vec) {
    for (int e = tid; e < rows * (kW / kV); e += threads) {
      const int r = e / (kW / kV), d = kV * (e % (kW / kV));
      const bool in = r < valid && d < dims;
      if (d < width)
        tc::cp_async16(reinterpret_cast<float*>(dst + r * LD + d),
                       reinterpret_cast<const float*>(in ? src + r * stride + d : src), in);
    }
  } else {
    constexpr int kBatch = 8;
    for (int e0 = tid; e0 < rows * kW; e0 += kBatch * threads) {
      T x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * threads, r = e / kW, d = e % kW;
        x[u] = e < rows * kW && r < valid && d < dims ? src[r * stride + d] : from_f32<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * threads, r = e / kW, d = e % kW;
        if (e < rows * kW && d < width) dst[r * LD + d] = x[u];
      }
    }
  }
}

// The keep bytes of a key tile, rows [0, rows) of a [*, Lk] u8 mask from
// src (row r at src + r Lk), keys [0, keys) (zero past `valid` rows), into
// dst [rows][kLD]: 4-byte cp.async copies where `aligned` (Lk and the base a
// multiple of 4), else plain loads.
template <int kN, int kLD>
__device__ __forceinline__ void stage_keep(uint8_t* dst, const uint8_t* src, int Lk, int rows,
                                           int valid, int keys, bool aligned, int tid,
                                           int threads) {
  if (aligned) {
    for (int e = tid; e < rows * (kN / 4); e += threads) {
      const int r = e / (kN / 4), d = 4 * (e % (kN / 4));
      const bool in = r < valid && d < keys;
      const unsigned at = (unsigned)__cvta_generic_to_shared(dst + r * kLD + d);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(at),
                   "l"(in ? src + (size_t)r * Lk + d : src), "r"(in ? 4 : 0));
    }
  } else {
    for (int e = tid; e < rows * kN; e += threads) {
      const int r = e / kN, d = e % kN;
      dst[r * kLD + d] = r < valid && d < keys ? src[(size_t)r * Lk + d] : 0;
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
