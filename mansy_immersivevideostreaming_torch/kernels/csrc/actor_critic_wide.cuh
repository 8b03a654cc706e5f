// The wide variant of K3 and K10 (hidden widths past 256): one 64 x 128
// output tile of a product C = A B over depth K, in 3xTF32 on mma.sync, for
// the kernels of csrc/actor_critic.cu (the branch and fc products) and
// csrc/actor_critic_backward.cu (dPre_b).  Each kernel adds its own
// epilogue to the tile the accumulators hold.
//
// Past 256 the fused kernels' rings do not fit: K3's five 16-row W_fc stages
// are [16][2H + 8] floats each (330 KB at H = 512) and K10's launch A holds
// dPre_fc's hi and lo [32][2H + 4] each (263 KB).  Here a CTA takes one
// output tile whatever H is, so the shared memory a CTA takes (a ring of
// four 16-deep stages, 54 or 60 KB) does not grow with the width; the
// activations between the products go through device memory instead of
// staying on chip.
//
// As in the fused kernels, each 16-deep stage's products go into zeroed
// accumulators, which are added to the running sums with rounded f32 adds
// (the tensor cores' f32 accumulation does not round to nearest), and every
// sum has a fixed order: two launches give the same bits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace mansy {
namespace wide {

using namespace mansy::tc;

constexpr int kThreads = 256;  // 8 warps, 2 x 4 over the tile, 32 x 32 each
constexpr int kBM = 64, kBN = 128, kBK = 16;
constexpr int kStages = 4;     // three stages in flight while one is multiplied
constexpr int kAS = kBK + 4;   // A stage [kBM m][kAS] (padded so fragment reads hit 32 banks)
constexpr int kBS = kBN + 8;   // B stage [kBK k][kBS]
constexpr int kBTS = kBK + 4;  // B stage read transposed [kBN n][kBTS]
constexpr int kYS = kBN + 4;   // an epilogue's output tile [kBM][kYS], over the ring
constexpr int kMaxGemms = 11;  // one a branch

// The layout with B read as [k][n], or transposed ([n][k], kBT): a stage's
// floats, and the dynamic shared memory of a CTA.
template <bool kBT>
struct Layout {
  static constexpr int kSlot = kBM * kAS + (kBT ? kBN * kBTS : kBK * kBS);
  static constexpr int kSmemBytes =
      (kStages * kSlot > kBM * kYS ? kStages * kSlot : kBM * kYS) * (int)sizeof(float);
};
static_assert(2 * Layout<true>::kSmemBytes + 2048 <= 228 * 1024, "two CTAs an SM");

// C = A B: A(m, k) = a[m lda + k], B(k, n) = b[k ldb + n], or b[n ldb + k]
// when B is read transposed (the kernel's kBT).
struct Gemm {
  const float* a;
  const float* b;
  int32_t M, N, K, lda, ldb;
  int32_t vec_a, vec_b;   // 16-byte copies: address, ld and the copied extent multiples of 4 floats
  int32_t first_tile;     // output tiles of the products before this one
  int32_t n_tiles;        // its tiles across N
  int32_t tag;            // the caller's: a branch
};

struct Gemms {
  Gemm g[kMaxGemms];
  int32_t count;
};

// The product and the tile (m0, n0) of block `tile`.
__device__ __forceinline__ const Gemm& locate(const Gemms& gs, int tile, int& m0, int& n0) {
  int j = 0;
  while (j + 1 < gs.count && tile >= gs.g[j + 1].first_tile) ++j;
  const Gemm& p = gs.g[j];
  m0 = (tile - p.first_tile) / p.n_tiles * kBM;
  n0 = (tile - p.first_tile) % p.n_tiles * kBN;
  return p;
}

// acc = the tile (m0, n0) of A B, fragment (i, j, e) at row 32 wm + 16 i + g
// + 8 (e / 2), column 32 wn + 8 j + 2 t + e % 2 of the tile.  On return
// every copy has landed and every thread is past the last product: the
// ring is free for the epilogue.
template <bool kBT>
__device__ __forceinline__ void gemm_tile(const Gemm& p, int m0, int n0, float* smem,
                                          float (&acc)[2][4][4]) {
  constexpr int kSlot = Layout<kBT>::kSlot;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int total = (p.K + kBK - 1) / kBK;

  // stage c: depth k0 + [0, 16) of A's rows m0 + [0, 64) and B's columns n0
  // + [0, 128), zero past the edges
  auto load = [&](int c) {
    float* As = smem + (c % kStages) * kSlot;
    float* Bs = As + kBM * kAS;
    const int k0 = c * kBK;
    if (p.vec_a) {
      for (int e = tid; e < kBM * kBK / 4; e += kThreads) {
        const int m = e / (kBK / 4), k = 4 * (e % (kBK / 4));
        const bool ok = m0 + m < p.M && k0 + k < p.K;
        cp_async16(As + m * kAS + k, ok ? p.a + (size_t)(m0 + m) * p.lda + k0 + k : p.a, ok);
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int m = e / kBK, k = e % kBK;
        const bool ok = m0 + m < p.M && k0 + k < p.K;
        cp_async4(As + m * kAS + k, ok ? p.a + (size_t)(m0 + m) * p.lda + k0 + k : p.a, ok);
      }
    }
    if constexpr (kBT) {  // Bs[n][k] = B(k0 + k, n0 + n) = b[(n0 + n) ldb + k0 + k]
      if (p.vec_b) {
        for (int e = tid; e < kBN * kBK / 4; e += kThreads) {
          const int n = e / (kBK / 4), k = 4 * (e % (kBK / 4));
          const bool ok = n0 + n < p.N && k0 + k < p.K;
          cp_async16(Bs + n * kBTS + k, ok ? p.b + (size_t)(n0 + n) * p.ldb + k0 + k : p.b, ok);
        }
      } else {
        for (int e = tid; e < kBN * kBK; e += kThreads) {
          const int n = e / kBK, k = e % kBK;
          const bool ok = n0 + n < p.N && k0 + k < p.K;
          cp_async4(Bs + n * kBTS + k, ok ? p.b + (size_t)(n0 + n) * p.ldb + k0 + k : p.b, ok);
        }
      }
    } else {  // Bs[k][n] = b[(k0 + k) ldb + n0 + n]
      if (p.vec_b) {
        for (int e = tid; e < kBK * kBN / 4; e += kThreads) {
          const int k = e / (kBN / 4), n = 4 * (e % (kBN / 4));
          const bool ok = k0 + k < p.K && n0 + n < p.N;
          cp_async16(Bs + k * kBS + n, ok ? p.b + (size_t)(k0 + k) * p.ldb + n0 + n : p.b, ok);
        }
      } else {
        for (int e = tid; e < kBK * kBN; e += kThreads) {
          const int k = e / kBN, n = e % kBN;
          const bool ok = k0 + k < p.K && n0 + n < p.N;
          cp_async4(Bs + k * kBS + n, ok ? p.b + (size_t)(k0 + k) * p.ldb + n0 + n : p.b, ok);
        }
      }
    }
  };

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < total) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStages - 2>();  // stage c has landed
    __syncthreads();               // for every thread, and every thread is done with c - 1
    const float* As = smem + (c % kStages) * kSlot;
    const float* Bs = As + kBM * kAS;
    float part[2][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a(As + (32 * wm + 16 * i + g) * kAS + ks + t, kAS, ahi[i], alo[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kBT)
          load_b_t(Bs + (32 * wn + 8 * j + g) * kBTS + ks + t, bhi[j], blo[j]);
        else
          load_b(Bs + (ks + t) * kBS + 32 * wn + 8 * j + g, kBS, bhi[j], blo[j]);
      }
      products<2, 4, 4>(part, ahi, alo, bhi, blo);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    if (c + kStages - 1 < total) load(c + kStages - 1);  // into the slot of stage c - 1
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// fn(m, n, v) for every entry of the tile's accumulators, (m, n) in the tile.
template <typename Fn>
__device__ __forceinline__ void for_each(const float (&acc)[2][4][4], Fn&& fn) {
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(32 * wm + 16 * i + g + 8 * (e >> 1), 32 * wn + 8 * j + 2 * t + (e & 1), acc[i][j][e]);
}

inline bool aligned16(const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Appends C = A B (M x N over depth K; B read transposed when bt); returns
// the tile count so far.
inline int add(Gemms& gs, int tiles, const float* a, int lda, const float* b, int ldb, int M,
               int N, int K, bool bt, int tag) {
  Gemm& p = gs.g[gs.count++];
  p.a = a;
  p.b = b;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  p.vec_a = aligned16(a) && lda % 4 == 0 && K % 4 == 0;
  p.vec_b = aligned16(b) && ldb % 4 == 0 && (bt ? K : N) % 4 == 0;
  p.first_tile = tiles;
  p.n_tiles = (N + kBN - 1) / kBN;
  p.tag = tag;
  return tiles + (M + kBM - 1) / kBM * p.n_tiles;
}

}  // namespace wide
}  // namespace mansy
