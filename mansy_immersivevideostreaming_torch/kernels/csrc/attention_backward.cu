// K8's backward: the gradients of the softmax-attention core with respect to
// q, k and v, in f32, from the training mode's row statistics, at any number
// of query rows and keys.
//
// Replaces the XLA backward that jax.value_and_grad derives for
// models/transformer.py:MHA.attend (:61-75) under models/vp_train.py
// :_train_step (:57-65); the deleted Pallas kernel mha_pallas had no
// backward.  The plain PyTorch version is
// kernels/attention.py:attention_backward_plain.
//
// Per (b, head), with P the softmax of the masked scores, M the dropout keep
// mask, kp its keep probability, P' = P * M / kp the dropped probabilities
// and O = P' V the forward's output:
//   dV  = P'^T dO
//   dP' = dO V^T
//   D   = rowsum(dO * O)
//   dS  = P * (dP' * M / kp - D)
//   dQ  = (dS / sqrt(Dh)) K,   dK = (dS / sqrt(Dh))^T Q.
// Keys past a row's prefix (min(Lk, kv_len0 + r)) have P = 0; keys no row
// sees get exactly 0 in dK and dV.
//
// P, bit for bit: P is recomputed from q, k and the forward's row max and
// exp sum, not stored by the forward (which would cost Lq Lk 4 bytes a
// (b, head) of writes and reads).  The forward (csrc/attention.cu) takes
// its scores as this kernel does: in its tile kernel (Lq > 1) by
// reduce_scatter_placed (csrc/attention_common.cuh: reduce_scatter's sums,
// its partials placed by lane), in its row kernel (Lq = 1) by warp_sum,
// whose butterfly reduce_scatter follows sum by sum: lane l's fmaf
// chain over dims l, l + 32, ..., then the xor offsets 16, 8, 4, 2, 1.  So
// the score, expf(s - max) and the division by the sum are the forward's
// bits on either of its paths.
//
// Layouts are the JAX package's: q, o, dO, dQ [B, Lq, H, Dh]; k, v, dK, dV
// [B, Lk, H, Dh]; the statistics [B, H, Lq]; the mask [B, H, Lq, Lk].
//
// Bound: bytes.  At run_models' training shapes (B 512, 8 heads of 64, at
// most 15 rows a side) the k and v rows read and the dk and dv rows written
// are nearly all of the traffic, at about 10 Dh flops a (row, key).  Two
// designs, each picked by the wrapper's plan (kernels/attention.py:
// attention_backward_plan); P (kPer) is the dims a lane holds, Dh <= 32 P:
//   row kernel (Lq = 1, 60 of a default training step's 62 launches): a warp
//     a (b, head), eight of them a CTA (a b's 8 heads: its key rows are 2 KB
//     apart from the next b's, a head's 256 B in a row).  dK_j = dS_j q and
//     dV_j = P'_j dO need no second pass.  The warp loads M keys' k and v
//     rows from device memory straight into registers (no shared-memory
//     copy: each is read once), all of them in flight at once, takes their
//     scores and dP' by reduce_scatter, and stores dK_j and dV_j; k stays in
//     registers for dQ, summed over the keys in order.
//   tile kernel (Lq > 1): a CTA of W warps a (b, head) (8, or 4 when a row
//     tile has at most 128 scores).  It walks the key tiles of M keys, and for
//     each the row tiles of up to 32 rows that see it; cp.async stages a
//     tile's k and v rows and a row tile's q, dO and o rows, row max, exp
//     sum and keep bytes in shared memory, all in flight at once.  A warp
//     takes a row's M scores and M dP' in one reduce_scatter of 2M items,
//     writes P' and dS to shared memory and continues the row's dQ chain
//     over the tile's keys (kept in dq itself between key tiles: one fmaf
//     chain over the keys in order); then each thread sums its (key, 4
//     dims) of dK and dV over the tile's rows in row order, in registers
//     across the row tiles.  Shared memory is bounded by the tiles (at most
//     115 KB, at Dh 256), not by Lq x Lk.  On the H100 it is bound by the
//     issue of the score phase (about 450 warp instructions a row of a
//     16-key tile, most of them the per-lane chains, the reduce-scatter and
//     the dQ chain), not by the bytes.
//   split (more than one query row past 2048 keys at few (b, head) pairs,
//     where this kernel's B H CTAs leave the card idle):
//     csrc/attention_backward_split.cu, this kernel's sums, bit for bit,
//     over a grid of row tiles for dQ and one of key tiles for dK and dV.
//   past 256 dims (backward_row_wide_kernel; in f32 where the plan keeps
//     it, backward_tile_wide_kernel): the row and tile layouts over the
//     head's chunks of 256 dims, 8 a lane, key tiles of 8 keys: the per-lane
//     partials of a score and of a dP' carried over the chunks before the
//     reduction (the wide row forward's scores, bit for bit), then dQ, dK
//     and dV chunk by chunk; the row kernel reads k and v from device memory
//     a chunk at a time, the tile kernel (a warp a row, row tiles of 8)
//     stages a chunk of k, v, q, dO and o at a time in 40 KB of shared
//     memory whatever Dh, and keeps its dQ, dK and dV sums over the tiles in
//     dq, dk and dv.  More than one row in bf16, and in f32 where it
//     measured faster, takes csrc/attention_backward_wide.cu: every product
//     on the tensor cores (mma.sync) over a dQ grid and a dK/dV grid, its P
//     the streamed forward's bit for bit (the forward's own wide score
//     tile, csrc/attention_common.cuh).
// Keys: no kernel holds a row of scores, so any Lk runs.
// No atomics: every sum has a fixed order, and two launches give the same
// bits.
//
// bf16 (run_models --bf16): every tensor but the statistics and the mask is
// bf16 (the element type T; csrc/elem.cuh), staged as f32, and the kernels
// follow the rounding points of jax.grad of MHA.attend at dtype=bfloat16
// (its jaxpr's convert_element_type list, tests/test_torch_bf16.py):
//   P'_b = bf16(P')                          (the forward's p.astype, :74)
//   dV   = bf16(P'_b^T dO)                   (an f32 sum, rounded once)
//   dP'  = bf16(dO V^T)                      (the transpose of the bf16 P.V)
//   g    = dP' * M / kp,  D = sum_k g_k P_k  (the softmax's gradient in f32;
//                                            o is not read)
//   dS   = P * (g - D)
//   dQ   = bf16((dS / sqrt(Dh)) K),  dK = bf16((dS / sqrt(Dh))^T Q).
// D needs a row's every key before its first dS, so a first launch
// (delta_kernel, a warp a (b, row, head), the forward's walk; past 256 dims
// at one row delta_wide_kernel, over the chunks) writes it; the
// tile kernel keeps its dQ chains in an f32 scratch between key tiles.  The
// f32 instantiations compile as before (D = rowsum(dO * O), every rounding an
// identity).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_backward.cuh"
#include "attention_common.cuh"
#include "common.cuh"
#include "elem.cuh"

using mansy::kFull;
using mansy::attn::chain;
using mansy::attn::chain_on;
using mansy::attn::kChunkDims;
using mansy::attn::load_chunk;
using mansy::attn::opt_in;
using mansy::attn::reduce_scatter;
using mansy::attn::stage_rows;
using mansy::from_f32;
using mansy::kIsBf16;
using mansy::round_as;
using mansy::to_f32;
using mansy::warp_sum;
using mansy::tc::cp_async4;
using mansy::tc::cp_async_commit;
using mansy::tc::cp_async_wait;

namespace {

constexpr int kRowWarps = 8;    // row kernel: warps (b, heads) a CTA
constexpr int kDeltaWarps = 4;  // delta_kernel: warps (rows) a CTA
constexpr int kWideKeys = 8;    // the wide kernels (Dh > 256): keys a tile
constexpr int kWideRows = 8;    // the wide tile kernel: rows a row tile, a warp a row

}  // namespace

namespace {

// ---- bf16: D = sum_k g_k P_k of each row, a warp a (b, row, head) ----
// The scores and dP' as the forward and the row and tile kernels take them
// (each lane's fmaf chain, then the butterfly), so P and g are their bits.
template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32) delta_kernel(const AttentionBackwardArgs a) {
  constexpr int kP = 8;  // Dh <= 256 (wider: delta_wide_kernel); dims past Dh skipped as chain skips
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;  // (b Lq + r) H + h
  if (row >= (long long)a.B * a.Lq * a.H) return;
  const int Dh = a.Dh, Lk = a.Lk;
  const int h = (int)(row % a.H), r = (int)((row / a.H) % a.Lq);
  const long long b = row / ((long long)a.H * a.Lq);
  const long long stat = (b * a.H + h) * a.Lq + r;
  const size_t stride = (size_t)a.H * Dh;
  const size_t k0 = ((size_t)b * Lk * a.H + h) * Dh;
  const int n = min(Lk, a.kv_len0 + r);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  float qv[kP], dov[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < Dh ? to_f32(static_cast<const T*>(a.q)[row * Dh + d]) : 0.f;
    dov[i] = d < Dh ? to_f32(static_cast<const T*>(a.dout)[row * Dh + d]) : 0.f;
  }
  const float mx = a.row_max[stat], sum = a.row_sum[stat];
  const uint8_t* keep = a.keep != nullptr ? a.keep + stat * Lk : nullptr;
  float D = 0.f;
  for (int j = 0; j < n; ++j) {
    float kr[kP], vr[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < Dh ? to_f32(K[k0 + (size_t)j * stride + d]) : 0.f;
      vr[i] = d < Dh ? to_f32(V[k0 + (size_t)j * stride + d]) : 0.f;
    }
    const float score = warp_sum(chain<kP>(qv, kr, lane, Dh)) / a.scale;
    float g = round_as<T>(warp_sum(chain<kP>(dov, vr, lane, Dh)));
    if (keep != nullptr) g = keep[j] ? g / a.keep_prob : 0.f;
    D += g * (expf(score - mx) / sum);
  }
  if (lane == 0) a.delta[stat] = D;
}

// ---- Lq = 1: a warp a (b, head) ----
template <typename T, int P, int M>
__global__ void __launch_bounds__(kRowWarps * 32)
backward_row_kernel(const AttentionBackwardArgs a) {
  const int lane = threadIdx.x % 32;
  const long long bh = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;  // b H + h
  if (bh >= (long long)a.B * a.H) return;
  const int Dh = a.Dh, Lk = a.Lk;
  const long long b = bh / a.H;
  const int h = (int)(bh % a.H);
  const size_t stride = (size_t)a.H * Dh;                 // from a key row to the next
  const size_t k0 = ((size_t)b * Lk * a.H + h) * Dh;     // key 0 of this (b, head)
  const T* qrow = static_cast<const T*>(a.q) + bh * Dh;  // Lq = 1: row (b, 0, h)
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  T* dK = static_cast<T*>(a.dk);
  T* dV = static_cast<T*>(a.dv);
  const int n = min(Lk, a.kv_len0);
  const float mx = a.row_max[bh], sum = a.row_sum[bh];
  const uint8_t* keep = a.keep != nullptr ? a.keep + bh * Lk : nullptr;

  float qv[P], dov[P], acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < Dh ? to_f32(qrow[d]) : 0.f;
    dov[i] = d < Dh ? to_f32(static_cast<const T*>(a.dout)[bh * Dh + d]) : 0.f;
    acc[i] = 0.f;
  }
  float D;
  if constexpr (kIsBf16<T>) {
    D = a.delta[bh];  // bf16 reads no o
  } else {
    float ov[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int d = lane + 32 * i;
      ov[i] = d < Dh ? static_cast<const float*>(a.o)[bh * Dh + d] : 0.f;
    }
    D = warp_sum(chain<P>(dov, ov, lane, Dh));
  }

  for (int j0 = 0; j0 < n; j0 += M) {
    float kr[M][P], x[M], y[M];
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const bool in = j0 + s < n;
      float vr[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int d = lane + 32 * i;
        const size_t at = k0 + (size_t)(j0 + s) * stride + d;
        kr[s][i] = in && d < Dh ? to_f32(K[at]) : 0.f;
        vr[i] = in && d < Dh ? to_f32(V[at]) : 0.f;
      }
      x[s] = chain<P>(qv, kr[s], lane, Dh);
      y[s] = chain<P>(dov, vr, lane, Dh);
    }
    const float score = reduce_scatter<M>(x, lane) / a.scale;
    const float dpd = reduce_scatter<M>(y, lane);
    const int j = j0 + (lane & (M - 1));
    const Grad g = grad_of<T>(a, j < n, score, dpd, mx, sum, D, keep != nullptr,
                              keep != nullptr && j < n && keep[j] != 0);
#pragma unroll
    for (int s = 0; s < M; ++s) {
      if (j0 + s < n) {  // the same for every lane
        const float ds = __shfl_sync(kFull, g.ds, s), pd = __shfl_sync(kFull, g.pd, s);
        const size_t at = k0 + (size_t)(j0 + s) * stride;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int d = lane + 32 * i;
          acc[i] = fmaf(ds, kr[s][i], acc[i]);
          if (d < Dh) {
            dK[at + d] = from_f32<T>(ds * qv[i]);
            dV[at + d] = from_f32<T>(pd * dov[i]);
          }
        }
      }
    }
  }
  for (int j = n; j < Lk; ++j) {  // keys the row does not see
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) {
        dK[k0 + (size_t)j * stride + d] = from_f32<T>(0.f);
        dV[k0 + (size_t)j * stride + d] = from_f32<T>(0.f);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int d = lane + 32 * i;
    if (d < Dh) static_cast<T*>(a.dq)[bh * Dh + d] = from_f32<T>(acc[i]);
  }
}

// ---- Lq > 1: a CTA a (b, head), key tiles of M keys, row tiles of a.rows rows ----
template <typename T, int P, int M, int W>
__global__ void __launch_bounds__(W * 32, (P <= 2 ? 4 : 2) * 8 / W)
backward_tile_kernel(const AttentionBackwardArgs a) {
  constexpr int kD = 32 * P;           // a staged row's floats (zeros past Dh)
  constexpr int kThreads = W * 32;
  constexpr int kChunks = M * kD / 4;  // (key, 4 dims) chunks of a key tile's dK and dV
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;  // chunks a thread
  extern __shared__ __align__(16) float smem[];
  const int RT = a.rows;
  float* sK = smem;              // [M][kD]
  float* sV = sK + M * kD;       // [M][kD]
  float* sQ = sV + M * kD;       // [RT][kD]
  float* sdO = sQ + RT * kD;     // [RT][kD]
  float* sO = sdO + RT * kD;     // [RT][kD]
  float* sP = sO + RT * kD;      // [RT][M] P'
  float* sS = sP + RT * M;       // [RT][M] dS / scale
  float* sMax = sS + RT * M;     // [RT] the forward's row max
  float* sSum = sMax + RT;       // [RT] and exp sum
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sSum + RT);  // [RT][M] the keep mask

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Dh = a.Dh, Lq = a.Lq, Lk = a.Lk, H = a.H;
  const long long bh = blockIdx.x;  // b H + h
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const size_t stride = (size_t)H * Dh;
  const size_t q0 = ((size_t)b * Lq * H + h) * Dh;  // row 0 of this (b, head)
  const size_t k0 = ((size_t)b * Lk * H + h) * Dh;  // key 0
  const int n_max = min(Lk, a.kv_len0 + Lq - 1);     // keys some row sees
  // 16-byte copies: rows of a multiple of 4 floats from 16-byte aligned bases
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
                          reinterpret_cast<uintptr_t>(a.dout);
  const bool vec = Dh % 4 == 0 && bases % 16 == 0;
  const T* Q = static_cast<const T*>(a.q);
  const T* dO = static_cast<const T*>(a.dout);
  const T* O = static_cast<const T*>(a.o);
  // the dQ chains between key tiles: dq itself in f32, an f32 scratch in bf16
  float* chains = kIsBf16<T> ? a.dq_acc : static_cast<float*>(a.dq);

  for (int j0 = 0; j0 < Lk; j0 += M) {
    const int kn = min(M, Lk - j0);
    float dk[kPer][4] = {}, dv[kPer][4] = {};
    if (j0 < n_max) {
      __syncthreads();  // the previous tile is done with sK and sV
      stage_rows<kD>(sK, static_cast<const T*>(a.k) + k0 + (size_t)j0 * stride, stride,
                     M, kn, Dh, vec, tid, kThreads);
      stage_rows<kD>(sV, static_cast<const T*>(a.v) + k0 + (size_t)j0 * stride, stride,
                     M, kn, Dh, vec, tid, kThreads);
      // rows before r_first see none of this tile's keys (nor any later one)
      const int r_first = max(0, j0 - a.kv_len0 + 1);
      for (int r0 = r_first; r0 < Lq; r0 += RT) {
        const int rn = min(RT, Lq - r0);
        if (r0 > r_first) __syncthreads();  // the previous row tile is done with sQ .. sKeep
        const size_t rows = q0 + (size_t)r0 * stride;
        stage_rows<kD>(sQ, Q + rows, stride, rn, rn, Dh, vec, tid, kThreads);
        stage_rows<kD>(sdO, dO + rows, stride, rn, rn, Dh, vec, tid, kThreads);
        if constexpr (!kIsBf16<T>)  // bf16 reads no o
          stage_rows<kD>(sO, O + rows, stride, rn, rn, Dh, vec, tid, kThreads);
        for (int e = tid; e < rn; e += kThreads) {
          cp_async4(sMax + e, a.row_max + bh * Lq + r0 + e, true);
          cp_async4(sSum + e, a.row_sum + bh * Lq + r0 + e, true);
        }
        cp_async_commit();
        if (a.keep != nullptr)  // bytes: plain loads, while the copies are in flight
          for (int e = tid; e < rn * M; e += kThreads) {
            const int rr = e / M, s = e % M;
            sKeep[e] = s < kn ? a.keep[(bh * Lq + r0 + rr) * Lk + j0 + s] : 0;
          }
        cp_async_wait<0>();
        __syncthreads();
        // a warp a row: its M scores, then its M dP', P' and dS out, its dQ chain on
        for (int rr = warp; rr < rn; rr += W) {
          const int r = r0 + rr, n = min(Lk, a.kv_len0 + r);
          const size_t row = q0 + (size_t)r * stride;
          float qv[P], dov[P], acc[P];
#pragma unroll
          for (int i = 0; i < P; ++i) {
            const int d = lane + 32 * i;
            acc[i] = j0 > 0 && d < Dh ? chains[row + d] : 0.f;  // the chain so far
            qv[i] = sQ[rr * kD + d];
            dov[i] = sdO[rr * kD + d];
          }
          float D;
          if constexpr (kIsBf16<T>) {
            D = a.delta[bh * Lq + r];
          } else {
            float ov[P];
#pragma unroll
            for (int i = 0; i < P; ++i) ov[i] = sO[rr * kD + lane + 32 * i];
            D = warp_sum(chain<P>(dov, ov, lane, Dh));
          }
          // the M scores' partials, then the M dP' partials, in one reduce_scatter
          float x[2 * M];
#pragma unroll
          for (int s = 0; s < M; ++s) {
            float kr[P], vr[P];
#pragma unroll
            for (int i = 0; i < P; ++i) {
              kr[i] = sK[s * kD + lane + 32 * i];
              vr[i] = sV[s * kD + lane + 32 * i];
            }
            x[s] = j0 + s < n ? chain<P>(qv, kr, lane, Dh) : 0.f;
            x[M + s] = j0 + s < n ? chain<P>(dov, vr, lane, Dh) : 0.f;
          }
          const float sum2 = reduce_scatter<2 * M>(x, lane);  // lane l: item l & (2M - 1)
          const float dpd = __shfl_sync(kFull, sum2, (lane & (M - 1)) + M);
          const int s_own = lane & (M - 1);
          const Grad g = grad_of<T>(a, j0 + s_own < n, sum2 / a.scale, dpd, sMax[rr], sSum[rr],
                                    D, a.keep != nullptr, sKeep[rr * M + s_own] != 0);
          if (lane < M) {
            sP[rr * M + s_own] = g.pd;
            sS[rr * M + s_own] = g.ds;
          }
          __syncwarp();
#pragma unroll
          for (int s = 0; s < M; ++s) {
            if (j0 + s < n) {  // the same for every lane
              const float ds = sS[rr * M + s];
#pragma unroll
              for (int i = 0; i < P; ++i) acc[i] = fmaf(ds, sK[s * kD + lane + 32 * i], acc[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < P; ++i) {
            const int d = lane + 32 * i;
            if (d < Dh) {
              chains[row + d] = acc[i];
              if (kIsBf16<T>) static_cast<T*>(a.dq)[row + d] = from_f32<T>(acc[i]);
            }
          }
        }
        __syncthreads();
        // dK and dV of this thread's (key, 4 dims) chunks over the tile's rows, in order
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
    // this tile's dK and dV rows (0 for a tile no row sees)
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
}

// ---- Dh > 256: the head in chunks of 256 dims (attention_common.cuh) ----
// Every score and dP' is lane l's chain over dims l, l + 32, ... of all the
// chunks (chain_on), then the butterfly's sums: the wide row forward's
// scores, bit for bit.  dQ, dK and dV are summed chunk by chunk, each chain
// in the order of the narrow kernels (dQ over the keys, dK and dV over the
// rows), its partial kept in device memory between tiles.

// bf16's D of each row, a warp a (b, row, head), as delta_kernel.
template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
delta_wide_kernel(const AttentionBackwardArgs a) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  if (row >= (long long)a.B * a.Lq * a.H) return;
  const int Dh = a.Dh, Lk = a.Lk, chunks = (Dh + kChunkDims - 1) / kChunkDims;
  const int h = (int)(row % a.H), r = (int)((row / a.H) % a.Lq);
  const long long b = row / ((long long)a.H * a.Lq);
  const long long stat = (b * a.H + h) * a.Lq + r;
  const size_t stride = (size_t)a.H * Dh;
  const size_t k0 = ((size_t)b * Lk * a.H + h) * Dh;
  const int n = min(Lk, a.kv_len0 + r);
  const T* qrow = static_cast<const T*>(a.q) + row * Dh;
  const T* dorow = static_cast<const T*>(a.dout) + row * Dh;
  const float mx = a.row_max[stat], sum = a.row_sum[stat];
  const uint8_t* keep = a.keep != nullptr ? a.keep + stat * Lk : nullptr;
  float D = 0.f;
  for (int j = 0; j < n; ++j) {
    const T* krow = static_cast<const T*>(a.k) + k0 + (size_t)j * stride;
    const T* vrow = static_cast<const T*>(a.v) + k0 + (size_t)j * stride;
    float x = 0.f, y = 0.f;
    for (int c = 0; c < chunks; ++c) {
      float qv[8], dov[8], kr[8], vr[8];
      load_chunk(qv, qrow, c, lane, Dh);
      load_chunk(dov, dorow, c, lane, Dh);
      load_chunk(kr, krow, c, lane, Dh);
      load_chunk(vr, vrow, c, lane, Dh);
      x = chain_on<8>(x, qv, kr, lane, Dh - c * kChunkDims);
      y = chain_on<8>(y, dov, vr, lane, Dh - c * kChunkDims);
    }
    const float score = warp_sum(x) / a.scale;
    float g = round_as<T>(warp_sum(y));
    if (keep != nullptr) g = keep[j] ? g / a.keep_prob : 0.f;
    D += g * (expf(score - mx) / sum);
  }
  if (lane == 0) a.delta[stat] = D;
}

// D of a row in f32 (rowsum(dO * O): one chain over the chunks, then
// warp_sum), or bf16's from delta_kernel.
template <typename T>
__device__ __forceinline__ float wide_delta(const AttentionBackwardArgs& a, size_t row,
                                            long long stat, int lane) {
  if constexpr (kIsBf16<T>) {
    return a.delta[stat];
  } else {
    float part = 0.f;
    const float* dorow = static_cast<const float*>(a.dout) + row;
    const float* orow = static_cast<const float*>(a.o) + row;
    for (int c = 0; c * kChunkDims < a.Dh; ++c) {
      float dov[8], ov[8];
      load_chunk(dov, dorow, c, lane, a.Dh);
      load_chunk(ov, orow, c, lane, a.Dh);
      part = chain_on<8>(part, dov, ov, lane, a.Dh - c * kChunkDims);
    }
    return warp_sum(part);
  }
}

// Lq = 1: a warp a (b, head), 8 a CTA; key tiles of kWideKeys keys read
// straight from device memory, once for the scores and dP' and once for
// dQ, dK and dV; the dQ chain kept in dq (f32) or dq_acc (bf16) between tiles.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
backward_row_wide_kernel(const AttentionBackwardArgs a) {
  constexpr int M = kWideKeys;
  const int lane = threadIdx.x % 32;
  const long long bh = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;  // b H + h
  if (bh >= (long long)a.B * a.H) return;
  const int Dh = a.Dh, Lk = a.Lk, chunks = (Dh + kChunkDims - 1) / kChunkDims;
  const long long b = bh / a.H;
  const int h = (int)(bh % a.H);
  const size_t stride = (size_t)a.H * Dh;
  const size_t k0 = ((size_t)b * Lk * a.H + h) * Dh;
  const T* qrow = static_cast<const T*>(a.q) + bh * Dh;  // Lq = 1: row (b, 0, h)
  const T* dorow = static_cast<const T*>(a.dout) + bh * Dh;
  const T* K = static_cast<const T*>(a.k) + k0;
  const T* V = static_cast<const T*>(a.v) + k0;
  T* dK = static_cast<T*>(a.dk) + k0;
  T* dV = static_cast<T*>(a.dv) + k0;
  float* chains = kIsBf16<T> ? a.dq_acc + bh * Dh : static_cast<float*>(a.dq) + bh * Dh;
  const int n = min(Lk, a.kv_len0);
  const float mx = a.row_max[bh], sum = a.row_sum[bh];
  const uint8_t* keep = a.keep != nullptr ? a.keep + bh * Lk : nullptr;
  const float D = wide_delta<T>(a, bh * Dh, bh, lane);

  for (int j0 = 0; j0 < n; j0 += M) {
    float x[M], y[M];
#pragma unroll
    for (int s = 0; s < M; ++s) x[s] = y[s] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int rest = Dh - c * kChunkDims;
      float qv[8], dov[8];
      load_chunk(qv, qrow, c, lane, Dh);
      load_chunk(dov, dorow, c, lane, Dh);
#pragma unroll
      for (int s = 0; s < M; ++s) {
        if (j0 + s < n) {  // the same for every lane
          float kr[8], vr[8];
          load_chunk(kr, K + (size_t)(j0 + s) * stride, c, lane, Dh);
          load_chunk(vr, V + (size_t)(j0 + s) * stride, c, lane, Dh);
          x[s] = chain_on<8>(x[s], qv, kr, lane, rest);
          y[s] = chain_on<8>(y[s], dov, vr, lane, rest);
        }
      }
    }
    const float score = mansy::attn::reduce_scatter<M>(x, lane) / a.scale;
    const float dpd = mansy::attn::reduce_scatter<M>(y, lane);
    const int j = j0 + (lane & (M - 1));
    const Grad g = grad_of<T>(a, j < n, score, dpd, mx, sum, D, keep != nullptr,
                              keep != nullptr && j < n && keep[j] != 0);
    for (int c = 0; c < chunks; ++c) {
      float qv[8], dov[8], acc[8];
      load_chunk(qv, qrow, c, lane, Dh);
      load_chunk(dov, dorow, c, lane, Dh);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = c * kChunkDims + lane + 32 * i;
        acc[i] = j0 > 0 && d < Dh ? chains[d] : 0.f;  // the chain so far
      }
#pragma unroll
      for (int s = 0; s < M; ++s) {
        if (j0 + s < n) {  // the same for every lane
          const float ds = __shfl_sync(kFull, g.ds, s), pd = __shfl_sync(kFull, g.pd, s);
          const size_t at = (size_t)(j0 + s) * stride;
          float kr[8];
          load_chunk(kr, K + at, c, lane, Dh);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int d = c * kChunkDims + lane + 32 * i;
            acc[i] = fmaf(ds, kr[i], acc[i]);
            if (d < Dh) {
              dK[at + d] = from_f32<T>(ds * qv[i]);
              dV[at + d] = from_f32<T>(pd * dov[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = c * kChunkDims + lane + 32 * i;
        if (d < Dh) {
          chains[d] = acc[i];
          if (kIsBf16<T>) static_cast<T*>(a.dq)[bh * Dh + d] = from_f32<T>(acc[i]);
        }
      }
    }
  }
  for (int j = n; j < Lk; ++j)  // keys the row does not see
    for (int d = lane; d < Dh; d += 32) {
      dK[(size_t)j * stride + d] = from_f32<T>(0.f);
      dV[(size_t)j * stride + d] = from_f32<T>(0.f);
    }
}

// Lq > 1 in f32 where the plan keeps it (kernels/attention.py:
// attention_backward_plan; csrc/attention_backward_wide.cu takes bf16 and
// the other shapes): a CTA a (b, head) of 8 warps, key tiles of kWideKeys
// keys, row tiles of a.rows (<= 8) rows, a warp a row.  For each (key tile,
// row tile): the chunks of k, v, q, dO and o staged one after another while
// each warp carries its row's 2M partials and D's; one reduce_scatter of
// the 2M items; P' and dS to shared memory; then chunk by chunk (k, q and dO
// staged again) the warps' dQ chains over the tile's keys and the threads'
// (key, 4 dims) dK and dV chains over the tile's rows, each kept between
// tiles in dq, dk and dv.
__global__ void __launch_bounds__(kWideRows * 32, 2)
backward_tile_wide_kernel(const AttentionBackwardArgs a) {
  using T = float;
  constexpr int M = kWideKeys, kD = kChunkDims, W = kWideRows, kThreads = W * 32;
  constexpr int kChunks = M * kD / 4;                        // (key, 4 dims) of a tile's chunk
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;  // of them a thread
  extern __shared__ __align__(16) float smem[];
  const int RT = a.rows;
  float* sK = smem;              // [M][kD]: a chunk of a key tile's k rows
  float* sV = sK + M * kD;       // [M][kD]: and of its v rows
  float* sQ = sV + M * kD;       // [RT][kD]: a chunk of the row tile's q rows
  float* sdO = sQ + RT * kD;     // [RT][kD]: dO
  float* sO = sdO + RT * kD;     // [RT][kD]: o (f32)
  float* sP = sO + RT * kD;      // [RT][M] P'
  float* sS = sP + RT * M;       // [RT][M] dS / scale
  float* sMax = sS + RT * M;     // [RT]
  float* sSum = sMax + RT;       // [RT]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sSum + RT);  // [RT][M]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Dh = a.Dh, Lq = a.Lq, Lk = a.Lk, H = a.H;
  const int chunks = (Dh + kD - 1) / kD;
  const long long bh = blockIdx.x;  // b H + h
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const size_t stride = (size_t)H * Dh;
  const size_t q0 = ((size_t)b * Lq * H + h) * Dh;
  const size_t k0 = ((size_t)b * Lk * H + h) * Dh;
  const int n_max = min(Lk, a.kv_len0 + Lq - 1);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
                          reinterpret_cast<uintptr_t>(a.dout);
  const bool vec = Dh % 4 == 0 && bases % 16 == 0;
  const T* Q = static_cast<const T*>(a.q);
  const T* dO = static_cast<const T*>(a.dout);
  const T* O = static_cast<const T*>(a.o);
  const T* K = static_cast<const T*>(a.k) + k0;
  const T* V = static_cast<const T*>(a.v) + k0;
  T* dK = static_cast<T*>(a.dk) + k0;
  T* dV = static_cast<T*>(a.dv) + k0;
  float* chains = static_cast<float*>(a.dq);
  float* dk_sum = static_cast<float*>(a.dk) + k0;
  float* dv_sum = static_cast<float*>(a.dv) + k0;

  for (int j0 = 0; j0 < Lk; j0 += M) {
    const int kn = min(M, Lk - j0);
    if (j0 >= n_max) {  // a tile no row sees: zeros
      for (int e = tid; e < kn * Dh; e += kThreads) {
        const size_t at = (size_t)(e / Dh) * stride + j0 * stride + e % Dh;
        dK[at] = from_f32<T>(0.f);
        dV[at] = from_f32<T>(0.f);
      }
      continue;
    }
    const int r_first = max(0, j0 - a.kv_len0 + 1);  // rows before it see none of the tile
    for (int r0 = r_first; r0 < Lq; r0 += RT) {
      const int rn = min(RT, Lq - r0);
      const size_t rows = q0 + (size_t)r0 * stride;
      const int r = r0 + warp, n = min(Lk, a.kv_len0 + r);
      const bool mine = warp < rn;
      // the scores' and dP's partials (and f32 D's), chunk by chunk
      float x[2 * M], dpart = 0.f;
#pragma unroll
      for (int s = 0; s < 2 * M; ++s) x[s] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        const int rest = Dh - c * kD;
        __syncthreads();  // every warp is done with the last chunk (and the last row tile)
        stage_rows<kD>(sK, K + (size_t)j0 * stride + c * kD, stride, M, kn, rest, vec, tid,
                       kThreads);
        stage_rows<kD>(sV, V + (size_t)j0 * stride + c * kD, stride, M, kn, rest, vec, tid,
                       kThreads);
        stage_rows<kD>(sQ, Q + rows + c * kD, stride, rn, rn, rest, vec, tid, kThreads);
        stage_rows<kD>(sdO, dO + rows + c * kD, stride, rn, rn, rest, vec, tid, kThreads);
        stage_rows<kD>(sO, O + rows + c * kD, stride, rn, rn, rest, vec, tid, kThreads);
        if (c == 0) {
          for (int e = tid; e < rn; e += kThreads) {
            cp_async4(sMax + e, a.row_max + bh * Lq + r0 + e, true);
            cp_async4(sSum + e, a.row_sum + bh * Lq + r0 + e, true);
          }
          if (a.keep != nullptr)
            for (int e = tid; e < rn * M; e += kThreads) {
              const int rr = e / M, s = e % M;
              sKeep[e] = s < kn ? a.keep[(bh * Lq + r0 + rr) * Lk + j0 + s] : 0;
            }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (mine) {
          float qv[8], dov[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            qv[i] = sQ[warp * kD + lane + 32 * i];
            dov[i] = sdO[warp * kD + lane + 32 * i];
          }
#pragma unroll
          for (int s = 0; s < M; ++s) {
            if (j0 + s < n) {
              float kr[8], vr[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                kr[i] = sK[s * kD + lane + 32 * i];
                vr[i] = sV[s * kD + lane + 32 * i];
              }
              x[s] = chain_on<8>(x[s], qv, kr, lane, rest);
              x[M + s] = chain_on<8>(x[M + s], dov, vr, lane, rest);
            }
          }
          float ov[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) ov[i] = sO[warp * kD + lane + 32 * i];
          dpart = chain_on<8>(dpart, dov, ov, lane, rest);
        }
      }
      if (mine) {  // a warp's row: P' and dS of the tile's keys
        const float D = warp_sum(dpart);
        const float sum2 = mansy::attn::reduce_scatter<2 * M>(x, lane);
        const float dpd = __shfl_sync(kFull, sum2, (lane & (M - 1)) + M);
        const int s_own = lane & (M - 1);
        const Grad g = grad_of<T>(a, j0 + s_own < n, sum2 / a.scale, dpd, sMax[warp],
                                  sSum[warp], D, a.keep != nullptr,
                                  sKeep[warp * M + s_own] != 0);
        if (lane < M) {
          sP[warp * M + s_own] = g.pd;
          sS[warp * M + s_own] = g.ds;
        }
      }
      // dQ, dK and dV, chunk by chunk
      for (int c = 0; c < chunks; ++c) {
        const int rest = Dh - c * kD;
        __syncthreads();  // P' and dS written; every warp is done with the last chunk
        stage_rows<kD>(sK, K + (size_t)j0 * stride + c * kD, stride, M, kn, rest, vec, tid,
                       kThreads);
        stage_rows<kD>(sQ, Q + rows + c * kD, stride, rn, rn, rest, vec, tid, kThreads);
        stage_rows<kD>(sdO, dO + rows + c * kD, stride, rn, rn, rest, vec, tid, kThreads);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (mine) {  // the row's dQ chain over the tile's keys
          const size_t row = q0 + (size_t)r * stride + c * kD;
          float acc[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[i] = j0 > 0 && lane + 32 * i < rest ? chains[row + lane + 32 * i] : 0.f;
#pragma unroll
          for (int s = 0; s < M; ++s) {
            if (j0 + s < n) {  // the same for every lane
              const float ds = sS[warp * M + s];
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[i] = fmaf(ds, sK[s * kD + lane + 32 * i], acc[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int d = lane + 32 * i;
            if (d < rest) chains[row + d] = acc[i];
          }
        }
        // this thread's (key, 4 dims) of dK and dV over the row tile's rows, in order
#pragma unroll
        for (int cc = 0; cc < kPer; ++cc) {
          const int e = tid + cc * kThreads;
          const int s = e / (kD / 4), d4 = 4 * (e % (kD / 4));
          if (e < kChunks && s < kn && d4 < rest) {
            const size_t at = (size_t)(j0 + s) * stride + c * kD + d4;
            float dk[4], dv[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const bool in = r0 > r_first && d4 + t < rest;
              dk[t] = in ? dk_sum[at + t] : 0.f;
              dv[t] = in ? dv_sum[at + t] : 0.f;
            }
            for (int rr = 0; rr < rn; ++rr) {
              const float pd = sP[rr * M + s], ds = sS[rr * M + s];
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                dv[t] = fmaf(pd, sdO[rr * kD + d4 + t], dv[t]);
                dk[t] = fmaf(ds, sQ[rr * kD + d4 + t], dk[t]);
              }
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (d4 + t < rest) {
                dk_sum[at + t] = dk[t];
                dv_sum[at + t] = dv[t];
              }
            }
          }
        }
      }
    }
  }
}

// The wide tile kernel's shared memory (its layout above).
inline size_t tile_wide_smem_bytes(int rows) {
  return sizeof(float) * (2 * (size_t)kWideKeys * kChunkDims + 3 * (size_t)rows * kChunkDims +
                          2 * (size_t)rows * kWideKeys + 2 * (size_t)rows) +
         (size_t)rows * kWideKeys;
}

template <typename T, int P, int M>
cudaError_t launch_row(const AttentionBackwardArgs& a, cudaStream_t stream) {
  const long long pairs = (long long)a.B * a.H;
  backward_row_kernel<T, P, M><<<(unsigned)((pairs + kRowWarps - 1) / kRowWarps), kRowWarps * 32,
                              0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int P, int M>
cudaError_t launch_tile(const AttentionBackwardArgs& a, cudaStream_t stream) {
  if (a.rows < 1 || a.rows > kMaxRows || (a.warps != 4 && a.warps != 8))
    return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(P, M, a.rows);
  auto kernel = a.warps == 4 ? backward_tile_kernel<T, P, M, 4> : backward_tile_kernel<T, P, M, 8>;
  const cudaError_t e = opt_in(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)((long long)a.B * a.H), a.warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The plan's (P, M) instantiation of the row (Lq = 1) or the tile kernel.
template <typename T>
int launch_plan(const AttentionBackwardArgs& a, cudaStream_t s) {
  const int plan = a.per_lane * 100 + a.keys;  // the plan's (P, M)
  if (a.Lq == 1) {  // M P <= 32: a warp's k rows of a tile in registers
    switch (plan) {
      case 104: return (int)launch_row<T, 1, 4>(a, s);
      case 108: return (int)launch_row<T, 1, 8>(a, s);
      case 116: return (int)launch_row<T, 1, 16>(a, s);
      case 132: return (int)launch_row<T, 1, 32>(a, s);
      case 204: return (int)launch_row<T, 2, 4>(a, s);
      case 208: return (int)launch_row<T, 2, 8>(a, s);
      case 216: return (int)launch_row<T, 2, 16>(a, s);
      case 404: return (int)launch_row<T, 4, 4>(a, s);
      case 408: return (int)launch_row<T, 4, 8>(a, s);
      case 804: return (int)launch_row<T, 8, 4>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (plan) {  // M 4 to 16 keys a tile, staged in shared memory
    case 104: return (int)launch_tile<T, 1, 4>(a, s);
    case 108: return (int)launch_tile<T, 1, 8>(a, s);
    case 116: return (int)launch_tile<T, 1, 16>(a, s);
    case 204: return (int)launch_tile<T, 2, 4>(a, s);
    case 208: return (int)launch_tile<T, 2, 8>(a, s);
    case 216: return (int)launch_tile<T, 2, 16>(a, s);
    case 404: return (int)launch_tile<T, 4, 4>(a, s);
    case 408: return (int)launch_tile<T, 4, 8>(a, s);
    case 416: return (int)launch_tile<T, 4, 16>(a, s);
    case 804: return (int)launch_tile<T, 8, 4>(a, s);
    case 808: return (int)launch_tile<T, 8, 8>(a, s);
    case 816: return (int)launch_tile<T, 8, 16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dh > 256: the wide row kernel (a.keys = kWideKeys), or in f32 the wide
// tile kernel (its rows at most kWideRows).
template <typename T>
int launch_wide(const AttentionBackwardArgs& a, cudaStream_t s) {
  if (a.keys != kWideKeys) return (int)cudaErrorInvalidValue;
  if (a.Lq == 1) {
    const long long pairs = (long long)a.B * a.H;
    backward_row_wide_kernel<T><<<(unsigned)((pairs + kRowWarps - 1) / kRowWarps),
                                  kRowWarps * 32, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (kIsBf16<T> || a.rows < 1 || a.rows > kWideRows || a.warps != kWideRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_wide_smem_bytes(a.rows);
  const cudaError_t e = opt_in(backward_tile_wide_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  backward_tile_wide_kernel<<<(unsigned)((long long)a.B * a.H), kWideRows * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// elem = 0: f32 tensors; 1: bf16 (delta_kernel first, then the plan's kernel).
// Dh > 256 takes the wide row kernel for one query row (delta_wide_kernel for
// bf16's D) and, in f32 where the plan keeps it, the wide tile kernel for
// more; csrc/attention_backward_wide.cu takes the other multi-row backwards
// past 256 dims.
extern "C" int attention_backward_launch(const AttentionBackwardArgs* args, int elem,
                                         void* stream) {
  const AttentionBackwardArgs& a = *args;
  if ((long long)a.B * a.H <= 0) return 0;
  const bool wide = a.Dh > kChunkDims;
  if (a.Lq < 1 || a.Lk < 1 || a.Dh < 1 || (!wide && a.Dh > 32 * a.per_lane) || a.kv_len0 < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem == 0) return wide ? launch_wide<float>(a, s) : launch_plan<float>(a, s);
  if (elem != 1 || a.delta == nullptr || (wide && a.Lq > 1) ||
      ((a.Lq > 1 || wide) && a.dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.B * a.Lq * a.H;
  const unsigned blocks = (unsigned)((rows + kDeltaWarps - 1) / kDeltaWarps);
  if (wide)
    delta_wide_kernel<mansy::bf16><<<blocks, kDeltaWarps * 32, 0, s>>>(a);
  else
    delta_kernel<mansy::bf16><<<blocks, kDeltaWarps * 32, 0, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return wide ? launch_wide<mansy::bf16>(a, s) : launch_plan<mansy::bf16>(a, s);
}
