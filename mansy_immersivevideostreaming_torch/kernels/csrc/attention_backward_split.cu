// K8's backward split over key tiles and row tiles: the gradients of the
// softmax-attention core with respect to q, k and v, as
// csrc/attention_backward.cu's tile kernel computes them (its design, its
// roundings and its bits), for more than one query row at up to 256 dims.
//
// Replaces, as the tile kernel does, the XLA backward that
// jax.value_and_grad derives for models/transformer.py:MHA.attend (:61-75)
// under models/vp_train.py:_train_step (:57-65).  The plain PyTorch version
// is kernels/attention.py:attention_backward_plain.
//
// Why: the tile kernel runs one CTA a (b, head).  Past 2048 keys at few
// (b, head) pairs that leaves the card idle: the --his-window 5000
// encoder's 5000 x 5000 at B 2 is 16 CTAs on 132 SMs, each walking 313 key
// tiles of 157 row tiles (569 ms on the H100).  Here its two sums go to two
// kernels over grids of tiles: backward_dq_kernel, a CTA a (b, head, row
// tile), walks the key tiles with each row's dQ chain in registers (no
// round trip through dq or dq_acc), then backward_dkv_kernel, a CTA a (b,
// head, key tile), walks the row tiles for dK and dV (5000 x 5000 at B 2:
// 2,512 + 5,008 CTAs).  Both take the scores and dP' against a staged key
// tile as the tile kernel does, each in one reduce_scatter (pair_sums), so
// P', dS and D are its bits; dQ runs over the keys and dK and dV over the
// rows in ascending order, so the outputs are its bits too, whatever the
// tiles' sizes (a row that does not see a key adds fmaf(0, x, acc) = acc to
// that key's sums, and no dQ step).  The price is the score and dP' work
// twice; in bf16 the dQ kernel walks the keys once more first for each
// row's D = sum_k g_k P_k, in delta_kernel's order, and writes it for the
// dK and dV kernel (so no delta_kernel launch: its warp a row walks the keys
// one dependent load at a time).  A warp takes two rows at once, rows rr
// and rr + 8 of the row tile: lane l the row l / 16 and key l % 16 of a
// 16-key tile, so every lane's grad_of is used and each staged k and v
// value feeds both rows' chains.  bf16 rows are staged by 16-byte loads of
// 8 values.  Shared memory: the tile kernel's layout at 16 keys (38 KB at
// 64 dims and 32 rows: 4 CTAs an SM).  With one row tile the dQ grid is
// the tile kernel's own B H CTAs, and where B H CTAs fill the card the
// second pass of score work costs more than the idle SMs it fills: both
// make this slower than the tile kernel in f32 (15 x 2500 at B 64: 3.016
// ms against 2.000), so the plan (kernels/attention.py:
// attention_backward_plan) takes it only for more than one row tile below
// SPLIT_MAX_HEADS (b, head) pairs.
//
// Bound: the instructions of the SIMT score chains and reduce-scatters
// (about 300 warp instructions a row of a 16-key tile, twice), not the bytes.
// No atomics: every sum has a fixed order, and two launches give the same
// bits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_backward.cuh"
#include "attention_common.cuh"
#include "common.cuh"
#include "elem.cuh"

using mansy::kFull;
using mansy::attn::chain;
using mansy::attn::opt_in;
using mansy::attn::reduce_scatter;
using mansy::attn::stage_rows;
using mansy::from_f32;
using mansy::kIsBf16;
using mansy::round_as;
using mansy::warp_sum;
using mansy::tc::cp_async4;
using mansy::tc::cp_async_commit;
using mansy::tc::cp_async_wait;

namespace {

constexpr int kSplitKeys = 16;  // keys a tile: two rows' 16 keys fill a warp's lanes
constexpr int kSplitWarps = 8;  // warps a CTA

// Rows as stage_rows stages them, but bf16 rows of a multiple of 8 values
// from 16-byte aligned bases (vec) by 16-byte loads of 8 values, converted
// (one round trip a tile, where stage_rows takes a 2-byte load a value).
template <int kD, typename T>
__device__ __forceinline__ void stage_split(float* dst, const T* src, size_t stride, int rows,
                                            int valid, int Dh, bool vec, int tid, int threads) {
  if constexpr (kIsBf16<T>) {
    if (vec) {
      for (int e = tid; e < rows * (kD / 8); e += threads) {
        const int r = e / (kD / 8), d = 8 * (e % (kD / 8));
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid && d < Dh) w = *reinterpret_cast<const uint4*>(src + r * stride + d);
        float4* out = reinterpret_cast<float4*>(dst + r * kD + d);  // a bf16's f32: its bits << 16
        out[0] = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                             __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
        out[1] = make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
                             __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u));
      }
      return;
    }
  }
  stage_rows<kD>(dst, src, stride, rows, valid, Dh, vec, tid, threads);
}

// Two staged rows against the staged key tile (sK; its v rows at sV = sK +
// 16 32 P): row a's 16 scores and row b's in one reduce_scatter of 32 items
// (item 16 row + key), then their dP' in another; lane l returns item l of
// each (score sums not yet divided by the scale).  Each item is lane l's
// fmaf chain, then the butterfly's sum: backward_tile_kernel's bits.
// n_a, n_b: the keys each row sees (0 for an absent row).
template <int P>
__device__ __forceinline__ float2 pair_sums(const float* sK, const float (&qa)[P],
                                            const float (&qb)[P], const float (&da)[P],
                                            const float (&db)[P], int j0, int n_a, int n_b,
                                            int Dh, int lane) {
  constexpr int M = kSplitKeys, kD = 32 * P;
  const float* sV = sK + M * kD;
  float x[2 * M];
#pragma unroll
  for (int s = 0; s < M; ++s) {
    float kr[P];
#pragma unroll
    for (int i = 0; i < P; ++i) kr[i] = sK[s * kD + lane + 32 * i];
    x[s] = j0 + s < n_a ? chain<P>(qa, kr, lane, Dh) : 0.f;
    x[M + s] = j0 + s < n_b ? chain<P>(qb, kr, lane, Dh) : 0.f;
  }
  const float score = reduce_scatter<2 * M>(x, lane);
#pragma unroll
  for (int s = 0; s < M; ++s) {
    float vr[P];
#pragma unroll
    for (int i = 0; i < P; ++i) vr[i] = sV[s * kD + lane + 32 * i];
    x[s] = j0 + s < n_a ? chain<P>(da, vr, lane, Dh) : 0.f;
    x[M + s] = j0 + s < n_b ? chain<P>(db, vr, lane, Dh) : 0.f;
  }
  return make_float2(score, reduce_scatter<2 * M>(x, lane));
}

// A warp's pair of staged rows: rr and rr + kSplitWarps of the row tile (b
// absent past rn: it sees no key, and its reads take row a's), the keys
// each sees, and the lane's own row and key.
struct RowPair {
  int a, b, n_a, n_b, mine, key;
  bool has_b;
};

__device__ __forceinline__ RowPair row_pair(const AttentionBackwardArgs& a, int rr, int r0,
                                            int rn, int lane) {
  RowPair p;
  p.a = rr;
  p.has_b = rr + kSplitWarps < rn;
  p.b = p.has_b ? rr + kSplitWarps : rr;
  p.n_a = min(a.Lk, a.kv_len0 + r0 + rr);
  p.n_b = p.has_b ? min(a.Lk, a.kv_len0 + r0 + rr + kSplitWarps) : 0;
  p.mine = lane < kSplitKeys ? p.a : p.b;
  p.key = lane & (kSplitKeys - 1);
  return p;
}

// The staged q and dO of a pair (f32 values of rows a and b).
template <int P>
__device__ __forceinline__ void pair_rows(const float* sQ, const float* sdO, const RowPair& p,
                                          int lane, float (&qa)[P], float (&qb)[P],
                                          float (&da)[P], float (&db)[P]) {
  constexpr int kD = 32 * P;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    qa[i] = sQ[p.a * kD + lane + 32 * i];
    qb[i] = sQ[p.b * kD + lane + 32 * i];
    da[i] = sdO[p.a * kD + lane + 32 * i];
    db[i] = sdO[p.b * kD + lane + 32 * i];
  }
}

// f32's D of a staged row: rowsum(dO * O), one chain, then warp_sum.
template <int P>
__device__ __forceinline__ float staged_delta(const float* so, const float (&dov)[P], int Dh,
                                              int lane) {
  float ov[P];
#pragma unroll
  for (int i = 0; i < P; ++i) ov[i] = so[lane + 32 * i];
  return warp_sum(chain<P>(dov, ov, lane, Dh));
}

// dQ of one row tile: its q, dO and o rows, row max and sum staged once;
// then (bf16) a walk over the key tiles for each row's D, then a walk for
// dQ, each from key 0 to the last key a row of the tile sees, the rows'
// dQ chains kept in registers across the key tiles (dS of a pair's key s
// from lanes s and 16 + s); dq written once.
template <typename T, int P>
__global__ void __launch_bounds__(kSplitWarps * 32, P <= 2 ? 4 : 2)
backward_dq_kernel(const AttentionBackwardArgs a) {
  constexpr int M = kSplitKeys, kD = 32 * P, W = kSplitWarps, kThreads = W * 32;
  constexpr int kPairs = kMaxRows / W / 2;  // row pairs a warp at most
  extern __shared__ __align__(16) float smem[];
  const int RT = a.rows;
  float* sK = smem;              // [M][kD] (the tile kernel's layout; its P' region holds D)
  float* sV = sK + M * kD;       // [M][kD]
  float* sQ = sV + M * kD;       // [RT][kD]
  float* sdO = sQ + RT * kD;     // [RT][kD]
  float* sO = sdO + RT * kD;     // [RT][kD]
  float* sD = sO + RT * kD;      // [RT] each row's D
  float* sMax = sD + 2 * RT * M; // [RT]
  float* sSum = sMax + RT;       // [RT]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sSum + RT);  // [RT][M]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Dh = a.Dh, Lq = a.Lq, Lk = a.Lk, H = a.H;
  const int row_tiles = (Lq + RT - 1) / RT;
  const long long bh = blockIdx.x / row_tiles;  // b H + h
  const int r0 = (int)(blockIdx.x % row_tiles) * RT, rn = min(RT, Lq - r0);
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const size_t stride = (size_t)H * Dh;
  const size_t rows = ((size_t)b * Lq * H + h) * Dh + (size_t)r0 * stride;
  const size_t k0 = ((size_t)b * Lk * H + h) * Dh;
  const int n_cta = min(Lk, a.kv_len0 + r0 + rn - 1);  // keys some row of the tile sees
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
                          reinterpret_cast<uintptr_t>(a.dout);
  const bool vec = Dh % (kIsBf16<T> ? 8 : 4) == 0 && bases % 16 == 0;
  stage_split<kD>(sQ, static_cast<const T*>(a.q) + rows, stride, rn, rn, Dh, vec, tid, kThreads);
  stage_split<kD>(sdO, static_cast<const T*>(a.dout) + rows, stride, rn, rn, Dh, vec, tid,
                  kThreads);
  if constexpr (!kIsBf16<T>)
    stage_rows<kD>(sO, static_cast<const float*>(a.o) + rows, stride, rn, rn, Dh, vec, tid,
                   kThreads);
  for (int e = tid; e < rn; e += kThreads) {
    cp_async4(sMax + e, a.row_max + bh * Lq + r0 + e, true);
    cp_async4(sSum + e, a.row_sum + bh * Lq + r0 + e, true);
  }
  cp_async_commit();

  // a walk over the key tiles up to n_cta: body(j0) once each tile is staged
  auto walk = [&](auto&& body) {
    for (int j0 = 0; j0 < n_cta; j0 += M) {
      const int kn = min(M, Lk - j0);
      __syncthreads();  // every warp is done with the last key tile
      stage_split<kD>(sK, static_cast<const T*>(a.k) + k0 + (size_t)j0 * stride, stride, M, kn,
                      Dh, vec, tid, kThreads);
      stage_split<kD>(sV, static_cast<const T*>(a.v) + k0 + (size_t)j0 * stride, stride, M, kn,
                      Dh, vec, tid, kThreads);
      cp_async_commit();
      if (a.keep != nullptr)
        for (int e = tid; e < rn * M; e += kThreads) {
          const int rr = e / M, s = e % M;
          sKeep[e] = s < kn ? a.keep[(bh * Lq + r0 + rr) * Lk + j0 + s] : 0;
        }
      cp_async_wait<0>();
      __syncthreads();
      body(j0);
    }
  };

  if constexpr (kIsBf16<T>) {  // D = sum_k g_k P_k of each row, key by key in order
    float dsum[2 * kPairs] = {};
    walk([&](int j0) {
#pragma unroll
      for (int t = 0; t < kPairs; ++t) {
        const int rr = warp + 2 * t * W;
        if (rr >= rn) continue;  // the same for every lane
        const RowPair p = row_pair(a, rr, r0, rn, lane);
        if (j0 >= max(p.n_a, p.n_b)) continue;
        float qa[P], qb[P], da[P], db[P];
        pair_rows<P>(sQ, sdO, p, lane, qa, qb, da, db);
        const float2 sums = pair_sums<P>(sK, qa, qb, da, db, j0, p.n_a, p.n_b, Dh, lane);
        const float prob = expf(sums.x / a.scale - sMax[p.mine]) / sSum[p.mine];
        float g = round_as<T>(sums.y);
        if (a.keep != nullptr) g = sKeep[p.mine * M + p.key] ? g / a.keep_prob : 0.f;
        const float gp = g * prob;
#pragma unroll
        for (int s = 0; s < M; ++s) {
          const float ga = __shfl_sync(kFull, gp, s), gb = __shfl_sync(kFull, gp, M + s);
          if (j0 + s < p.n_a) dsum[2 * t] += ga;
          if (j0 + s < p.n_b) dsum[2 * t + 1] += gb;
        }
      }
    });
#pragma unroll
    for (int t = 0; t < 2 * kPairs; ++t) {
      const int rr = warp + t * W;
      if (rr < rn && lane == 0) {
        sD[rr] = dsum[t];
        a.delta[bh * Lq + r0 + rr] = dsum[t];  // the dK and dV kernel's, after this one
      }
    }
  } else {  // rowsum(dO * O)
    cp_async_wait<0>();
    __syncthreads();
    for (int rr = warp; rr < rn; rr += W) {
      float dov[P];
#pragma unroll
      for (int i = 0; i < P; ++i) dov[i] = sdO[rr * kD + lane + 32 * i];
      const float D = staged_delta<P>(sO + rr * kD, dov, Dh, lane);
      if (lane == 0) sD[rr] = D;
    }
  }

  float acc[2 * kPairs][P] = {};  // the rows' dQ chains: row warp + t W in acc[t]
  walk([&](int j0) {
#pragma unroll
    for (int t = 0; t < kPairs; ++t) {
      const int rr = warp + 2 * t * W;
      if (rr >= rn) continue;  // the same for every lane
      const RowPair p = row_pair(a, rr, r0, rn, lane);
      if (j0 >= max(p.n_a, p.n_b)) continue;
      float qa[P], qb[P], da[P], db[P];
      pair_rows<P>(sQ, sdO, p, lane, qa, qb, da, db);
      const float2 sums = pair_sums<P>(sK, qa, qb, da, db, j0, p.n_a, p.n_b, Dh, lane);
      const Grad g = grad_of<T>(a, j0 + p.key < (lane < M ? p.n_a : p.n_b), sums.x / a.scale,
                                sums.y, sMax[p.mine], sSum[p.mine], sD[p.mine],
                                a.keep != nullptr, sKeep[p.mine * M + p.key] != 0);
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const float ds_a = __shfl_sync(kFull, g.ds, s), ds_b = __shfl_sync(kFull, g.ds, M + s);
        float kr[P];
#pragma unroll
        for (int i = 0; i < P; ++i) kr[i] = sK[s * kD + lane + 32 * i];
        if (j0 + s < p.n_a) {  // the same for every lane
#pragma unroll
          for (int i = 0; i < P; ++i) acc[2 * t][i] = fmaf(ds_a, kr[i], acc[2 * t][i]);
        }
        if (j0 + s < p.n_b) {
#pragma unroll
          for (int i = 0; i < P; ++i) acc[2 * t + 1][i] = fmaf(ds_b, kr[i], acc[2 * t + 1][i]);
        }
      }
    }
  });
#pragma unroll
  for (int t = 0; t < 2 * kPairs; ++t) {
    const int rr = warp + t * W;
    if (rr < rn) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) static_cast<T*>(a.dq)[rows + (size_t)rr * stride + d] = from_f32<T>(acc[t][i]);
      }
    }
  }
}

// dK and dV of one key tile: its k and v rows staged once, then the row
// tiles from the first row that sees the tile, in order; per row tile a
// warp a pair of rows writes their P' and dS to shared memory, then each
// thread sums its (key, 4 dims) chunks of dK and dV over the tile's rows
// in order.  bf16 reads each row's D from the dQ kernel.
template <typename T, int P>
__global__ void __launch_bounds__(kSplitWarps * 32, P <= 2 ? 4 : 2)
backward_dkv_kernel(const AttentionBackwardArgs a) {
  constexpr int M = kSplitKeys, kD = 32 * P, W = kSplitWarps, kThreads = W * 32;
  constexpr int kChunks = M * kD / 4;
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  const int RT = a.rows;
  float* sK = smem;              // [M][kD]
  float* sV = sK + M * kD;       // [M][kD]
  float* sQ = sV + M * kD;       // [RT][kD]
  float* sdO = sQ + RT * kD;     // [RT][kD]
  float* sO = sdO + RT * kD;     // [RT][kD]
  float* sP = sO + RT * kD;      // [RT][M] P'
  float* sS = sP + RT * M;       // [RT][M] dS / scale
  float* sMax = sS + RT * M;     // [RT]
  float* sSum = sMax + RT;       // [RT]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sSum + RT);  // [RT][M]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Dh = a.Dh, Lq = a.Lq, Lk = a.Lk, H = a.H;
  const int tiles = (Lk + M - 1) / M;
  const long long bh = blockIdx.x / tiles;  // b H + h
  const int j0 = (int)(blockIdx.x % tiles) * M;
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const size_t stride = (size_t)H * Dh;
  const size_t q0 = ((size_t)b * Lq * H + h) * Dh;
  const size_t k0 = ((size_t)b * Lk * H + h) * Dh;
  const int n_max = min(Lk, a.kv_len0 + Lq - 1);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
                          reinterpret_cast<uintptr_t>(a.dout);
  const bool vec = Dh % (kIsBf16<T> ? 8 : 4) == 0 && bases % 16 == 0;
  const int kn = min(M, Lk - j0);
  float dk[kPer][4] = {}, dv[kPer][4] = {};
  if (j0 < n_max) {
    stage_split<kD>(sK, static_cast<const T*>(a.k) + k0 + (size_t)j0 * stride, stride, M, kn, Dh,
                    vec, tid, kThreads);
    stage_split<kD>(sV, static_cast<const T*>(a.v) + k0 + (size_t)j0 * stride, stride, M, kn, Dh,
                    vec, tid, kThreads);
    const int r_first = max(0, j0 - a.kv_len0 + 1);  // rows before it see none of the tile
    for (int r0 = r_first; r0 < Lq; r0 += RT) {
      const int rn = min(RT, Lq - r0);
      if (r0 > r_first) __syncthreads();  // the previous row tile is done with sQ .. sKeep
      const size_t rows = q0 + (size_t)r0 * stride;
      stage_split<kD>(sQ, static_cast<const T*>(a.q) + rows, stride, rn, rn, Dh, vec, tid,
                      kThreads);
      stage_split<kD>(sdO, static_cast<const T*>(a.dout) + rows, stride, rn, rn, Dh, vec, tid,
                      kThreads);
      if constexpr (!kIsBf16<T>)
        stage_rows<kD>(sO, static_cast<const float*>(a.o) + rows, stride, rn, rn, Dh, vec, tid,
                       kThreads);
      for (int e = tid; e < rn; e += kThreads) {
        cp_async4(sMax + e, a.row_max + bh * Lq + r0 + e, true);
        cp_async4(sSum + e, a.row_sum + bh * Lq + r0 + e, true);
      }
      cp_async_commit();
      if (a.keep != nullptr)
        for (int e = tid; e < rn * M; e += kThreads) {
          const int rr = e / M, s = e % M;
          sKeep[e] = s < kn ? a.keep[(bh * Lq + r0 + rr) * Lk + j0 + s] : 0;
        }
      cp_async_wait<0>();
      __syncthreads();
      for (int rr = warp; rr < rn; rr += 2 * W) {
        const RowPair p = row_pair(a, rr, r0, rn, lane);
        float qa[P], qb[P], da[P], db[P];
        pair_rows<P>(sQ, sdO, p, lane, qa, qb, da, db);
        float D;
        if constexpr (kIsBf16<T>) {
          D = a.delta[bh * Lq + r0 + p.mine];
        } else {
          const float D_a = staged_delta<P>(sO + p.a * kD, da, Dh, lane);
          const float D_b = staged_delta<P>(sO + p.b * kD, db, Dh, lane);
          D = lane < M ? D_a : D_b;
        }
        const float2 sums = pair_sums<P>(sK, qa, qb, da, db, j0, p.n_a, p.n_b, Dh, lane);
        const Grad g = grad_of<T>(a, j0 + p.key < (lane < M ? p.n_a : p.n_b), sums.x / a.scale,
                                  sums.y, sMax[p.mine], sSum[p.mine], D, a.keep != nullptr,
                                  sKeep[p.mine * M + p.key] != 0);
        if (lane < M || p.has_b) {
          sP[p.mine * M + p.key] = g.pd;
          sS[p.mine * M + p.key] = g.ds;
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int e = tid + c * kThreads;
        if (e < kChunks) {
          const int s = e / (kD / 4), d4 = 4 * (e % (kD / 4));
          for (int rr = 0; rr < rn; ++rr) {
            const float pd = sP[rr * M + s], ds = sS[rr * M + s];
            const float4 o4 = *reinterpret_cast<const float4*>(sdO + rr * kD + d4);
            const float4 q4 = *reinterpret_cast<const float4*>(sQ + rr * kD + d4);
            dv[c][0] = fmaf(pd, o4.x, dv[c][0]);
            dv[c][1] = fmaf(pd, o4.y, dv[c][1]);
            dv[c][2] = fmaf(pd, o4.z, dv[c][2]);
            dv[c][3] = fmaf(pd, o4.w, dv[c][3]);
            dk[c][0] = fmaf(ds, q4.x, dk[c][0]);
            dk[c][1] = fmaf(ds, q4.y, dk[c][1]);
            dk[c][2] = fmaf(ds, q4.z, dk[c][2]);
            dk[c][3] = fmaf(ds, q4.w, dk[c][3]);
          }
        }
      }
    }
  }
  // the tile's dK and dV rows (0 for a tile no row sees)
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int e = tid + c * kThreads;
    const int s = e / (kD / 4), d4 = 4 * (e % (kD / 4));
    if (e < kChunks && s < kn) {
      const size_t at = k0 + (size_t)(j0 + s) * stride;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (d4 + t < Dh) {
          static_cast<T*>(a.dk)[at + d4 + t] = from_f32<T>(dk[c][t]);
          static_cast<T*>(a.dv)[at + d4 + t] = from_f32<T>(dv[c][t]);
        }
    }
  }
}

// backward_dq_kernel over (b, head, row tile), then backward_dkv_kernel over
// (b, head, key tile) (in bf16 it reads the D the first writes), each with
// the tile kernel's shared memory at 16 keys.
template <typename T, int P>
int launch_split(const AttentionBackwardArgs& a, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(P, kSplitKeys, a.rows);
  cudaError_t e = opt_in(backward_dq_kernel<T, P>, smem);
  if (e == cudaSuccess) e = opt_in(backward_dkv_kernel<T, P>, smem);
  if (e != cudaSuccess) return (int)e;
  const long long pairs = (long long)a.B * a.H;
  backward_dq_kernel<T, P><<<(unsigned)(pairs * ((a.Lq + a.rows - 1) / a.rows)),
                             kSplitWarps * 32, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  backward_dkv_kernel<T, P><<<(unsigned)(pairs * ((a.Lk + kSplitKeys - 1) / kSplitKeys)),
                              kSplitWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The plan's dims a lane.
template <typename T>
int launch_plan(const AttentionBackwardArgs& a, cudaStream_t s) {
  switch (a.per_lane) {
    case 1: return launch_split<T, 1>(a, s);
    case 2: return launch_split<T, 2>(a, s);
    case 4: return launch_split<T, 4>(a, s);
    case 8: return launch_split<T, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// elem = 0: f32 tensors; 1: bf16.  Only more than one query row of at most
// 256 dims, at the plan's 16 keys a tile and 8 warps a CTA.
extern "C" int attention_backward_split_launch(const AttentionBackwardArgs* args, int elem,
                                               void* stream) {
  const AttentionBackwardArgs& a = *args;
  if ((long long)a.B * a.H <= 0) return 0;
  if (a.Lq < 2 || a.Lk < 1 || a.Dh < 1 || a.Dh > 32 * a.per_lane || a.kv_len0 < 1 ||
      a.keys != kSplitKeys || a.warps != kSplitWarps || a.rows < 1 || a.rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem == 0) return launch_plan<float>(a, s);
  if (elem != 1 || a.delta == nullptr) return (int)cudaErrorInvalidValue;
  return launch_plan<mansy::bf16>(a, s);
}
