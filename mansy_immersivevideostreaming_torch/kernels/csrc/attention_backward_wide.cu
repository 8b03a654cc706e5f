// K8's backward past 256 dims for more than one query row, its products on
// the tensor cores: the gradients of the softmax-attention core with respect
// to q, k and v, f32 or bf16, from the training mode's row exp sums.
//
// Replaces, with csrc/attention_backward.cu, the XLA backward that
// jax.value_and_grad derives for models/transformer.py:MHA.attend (:61-75)
// under models/vp_train.py:_train_step at --hidden-dim past 2048 (heads past
// 256 dims); the deleted Pallas kernel mha_pallas had no backward.  The plain
// PyTorch version is kernels/attention.py:attention_backward_plain, whose
// header gives the function (P' = P M / kp, dV = P'^T dO, dP' = dO V^T,
// dS = P (dP' M / kp - D), dQ = dS K / sqrt(Dh), dK = dS^T Q / sqrt(Dh)).
// Layouts are the JAX package's (csrc/attention_backward.cuh).
//
// Bound: at the --hidden-dim 4096 path's 96 x 96 encoder (B 512, 8 heads of
// 512) the five products are some 190 GFLOP against 3.2 GB (bf16) or 6.4 GB
// (f32) that the function must move: operations in 3xTF32, near the meeting
// point in bf16.  So every product runs on mma.sync (bf16 m16n8k16 with f32
// accumulators; f32 in 3xTF32 on m16n8k8, csrc/common.cuh), and no sum goes
// through device memory between tiles.
//
// Design: a pair is a tile of kR = 16 query rows (one m16 fragment) against
// a tile of kK = 16 keys.  A CTA of 8 warps takes a pair's scores and its
// dP' = dO V^T at once: warps 0-3 the scores, warps 4-7 dP', each warp a
// part (64 dims) of every chunk of 256 dims, by the wide score tile that the
// streamed forward takes its scores by (csrc/attention_common.cuh:
// wide_score_chunk, wide_score_put, wide_score_sum): every score is the
// forward's sum of the same terms.  Every warp then holds the pair's scores
// and dP' and takes P, P' and dS of the 16 x 16 in registers (the scale and
// the dropout's 1 / keep_prob as reciprocal multiplies).  Two grids, both
// in one call (attention_backward_wide_launch), no atomics:
//   dQ grid: a CTA a (b, head, row tile), walking the key tiles its rows
//     see.  A first pass takes each row's max of q . k (see P below): in
//     bf16 with D = sum_k g_k P_k (g = dP' M / kp, dP' rounded to bf16
//     first; the exponentials rescaled online as the max grows, then one
//     multiply by 1 / sum), in f32 (D = rowsum(dO * o), two rows a warp from
//     device memory, no dP' needed) over two key tiles a stage, the scores
//     of one a warp group.  It writes both for the dK/dV grid (row_max_acc,
//     delta).  Then dQ += dS K a key tile at a time, each tile's product
//     from a zero accumulator added to the rows' sums in f32 (the tensor
//     cores round their f32 sums toward zero: over 5000 keys the drift
//     would pass K8's f32 limit), dS the A operand straight from the score
//     registers.
//   dK/dV grid: a CTA a (b, head, key tile), walking the row tiles that see
//     it, the tile's dK and dV kept in registers across them (each row
//     tile's products from zero, added in f32); P' and dS go through 2.5 KB
//     of shared memory once a pair to be read transposed (keys as the mma's
//     rows).  A key tile no row sees is written as zeros.
//   Lk <= kK (one key tile: the --hidden-dim 4096 path's 5 x 5, 15 x 15 and
//     15 x 3): one grid of the dK/dV layout that also takes each row's max
//     and D = sum_k g_k P_k from its own pair (it holds the row's every key)
//     and writes dQ (no sum across key tiles), so every input is read once.
// Output chunks: a warp's share of dQ (16 rows) or of dK and dV (16 keys) is
// 64 dims of an output chunk of kOut = 512 dims (32 accumulator registers a
// lane an output); past 512 dims the pairs are walked again for each output
// chunk, their scores and dP' recomputed (the streamed forward's pass B
// layout), since 16 x 2048 f32 sums a tile would take 128 KB of shared
// memory a grid where the stages need some 133 KB.
// Stages stream through two shared-memory slots by 16-byte cp.async
// (stage_tile: bf16 rows as they are), the next stage in flight while the
// warps take the current one, one __syncthreads a stage, the stage cursor
// advanced by counters (no divisions).  Up to 512 dims (resident) the CTA's
// own 16 rows of two tensors stay in shared memory and a stage is a pair's
// 16 partner rows of the other two over the whole head with its keep bytes:
// each input row is staged once a pair and read by the pair's scores, dP'
// and products alike (205 KB in f32, one CTA an SM; 109 KB in bf16, whose
// two grids take two CTAs an SM at 128 registers a thread).  Past 512 dims
// (streamed) a sweep stage is one chunk of the pair's q, k, dO and v rows
// (with the last chunk its keep bytes) and a product stage the two chunks of
// the output chunk's k rows (dQ) or q and dO rows (dK, dV) (141 KB in f32;
// 77 KB in bf16).
// On the H100 (PERF.md §6) builds with the mma compiled out showed that the
// staging, the barriers and the scalar work, not the tensor cores, bound
// these 16 x 16 pairs: hence the resident layout (a first one staged all
// four tensors a chunk at a time at every width: some 75 GB through L2 at
// 96 x 96, Dh 512, B 512 in f32, against some 32 GB resident), the counters
// and reciprocals, f32's first pass on two key tiles and bf16's two CTAs an
// SM.  At one key tile, and past 512 dims at many (b, head) pairs, f32 still
// loses to the SIMT kernel (csrc/attention_backward.cu:
// backward_tile_wide_kernel), which the plan keeps there
// (kernels/attention.py:attention_backward_plan).
//
// P, bit for bit the streamed forward's: p = 2^(acc c - max_acc c) / sum,
// with acc the score's sum of products before the division by sqrt(Dh),
// c = log2(e) / sqrt(Dh), "/ sum" a multiply by 1 / sum and the dropout's
// "/ keep_prob" one by 1 / keep_prob, exp2_ftz the forward's: the same
// operations on the same acc bits.  row_max holds max_acc / sqrt(Dh), from
// which max_acc cannot be multiplied back exactly, so the dQ grid (or the
// one grid) takes each row's max_acc from its own scores, the
// forward's max bit for bit; row_sum is the forward's sum as it is.
//
// bf16 follows jax.grad's rounding points as csrc/attention_backward.cu's
// header gives them: P' rounded to bf16 as it is packed into the dV product,
// dP' rounded to bf16 before g, dQ, dK and dV f32 sums rounded once.  dS is
// f32 there, and bf16's product of dS and k or q takes it as two bf16 terms
// (hi = bf16(dS), lo = bf16(dS - hi): 16 of its bits, the products exact, a
// relative error under 2^-16, far inside a bf16 ulp of the output).  f32's
// D is rowsum(dO * o) in the dQ grid (o read once a row tile) and sum_k g_k
// P_k in the one grid, equal up to rounding.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_backward.cuh"
#include "attention_common.cuh"
#include "common.cuh"
#include "elem.cuh"

using mansy::from_f32;
using mansy::kFull;
using mansy::kIsBf16;
using mansy::round_as;
using mansy::attn::exp2_ftz;
using mansy::attn::kChunkDims;
using mansy::attn::kWideDims;
using mansy::attn::kWideSplit;
using mansy::attn::opt_in;
using mansy::attn::pv_tile;
using mansy::attn::stage_keep;
using mansy::attn::stage_tile;
using mansy::attn::wide_score_chunk;
using mansy::attn::wide_score_put;
using mansy::attn::wide_score_sum;
using mansy::tc::cp_async_commit;
using mansy::tc::cp_async_wait;

namespace {

constexpr int kR = 16;                    // rows a row tile
constexpr int kK = 16;                    // keys a key tile
constexpr int kWarps = 2 * kWideSplit;    // the scores' parts, then dP''s
constexpr int kThreads = 32 * kWarps;
constexpr int kOut = 2 * kChunkDims;      // dims an output chunk, kWideDims a warp
constexpr int kKeepLD = kK + 4;           // a row's keep bytes in a slot
constexpr int kTLD = kK + 4;              // a row of P' or dS in shared memory (floats)
constexpr int kRedFloats = kWarps * 32 * (kK / 2);  // the warps' partial scores

enum Mode { kDQ = 0, kDKV = 1, kOneGrid = 2 };

// The two layouts.  Resident (Dh <= kOut): the CTA's own rows (dQ: its q and
// dO rows; dK/dV: its k and v rows) stay in shared memory for the whole
// launch, and a stage is a pair's partner rows over the whole head (16 k
// and 16 v rows, or 16 q and 16 dO rows, kOut dims each), which the pair's
// scores, dP' and products all read.  Streamed (Dh > kOut): a stage is a
// chunk of 256 dims of all four (a sweep stage) or the output chunk's
// operand rows (a product stage).
template <typename T, bool kRes>
struct Layout {
  static constexpr int kW = kRes ? kOut : kChunkDims;  // dims of a staged row
  static constexpr int LD = kW + 16 / (int)sizeof(T);   // its elements: 16 bytes more
  static constexpr int kOwnRows = kRes ? 2 * kR : 0;
  static constexpr int kSlotRows = kRes ? 2 * kR : 4 * kR;
  static constexpr int kSlot = kSlotRows * LD + kR * kKeepLD / (int)sizeof(T);  // + keep bytes
};

// the kernel's shared memory (kernels/attention.py:wide_backward_smem_bytes)
inline size_t smem_bytes(bool res, size_t elem) {
  const size_t ld = (res ? kOut : kChunkDims) + 16 / elem;
  const size_t own = res ? 2 * kR : 0, slot = res ? 2 * kR : 4 * kR;
  return sizeof(float) * (kRedFloats + 2 * kR * kTLD + kR) + elem * own * ld +
         2 * (elem * slot * ld + kR * kKeepLD);
}

// bf16's dQ and dK/dV grids: two CTAs an SM (128 registers a thread; f32's
// shared memory leaves room for one)
template <typename T, int kMode>
constexpr int min_blocks() { return kIsBf16<T> && kMode != kOneGrid ? 2 : 1; }

template <typename T, int kMode, bool kRes>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, kMode>()))
    backward_wide_kernel(const AttentionBackwardArgs a) {
  using L = Layout<T, kRes>;
  constexpr bool kBf16 = kIsBf16<T>;
  constexpr int LD = L::LD, kSlot = L::kSlot;
  extern __shared__ __align__(16) float smem[];
  float* sRed = smem;                  // [kWarps][32][kK / 2]: the parts' partial scores, dP'
  float* sT = sRed + kRedFloats;       // [2][kR][kTLD]: a pair's P' and dS, a row a row
  float* sD = sT + 2 * kR * kTLD;      // [kR]: f32's D of a row tile (rowsum(dO * o))
  T* own_rows = reinterpret_cast<T*>(sD + kR);  // resident: [2][16][LD]
  T* slots = own_rows + L::kOwnRows * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / kWideSplit;  // 0: q . k^T, 1: dO . v^T; in the products a chunk
  const int part = warp % kWideSplit;   // the warp's 64 dims of a chunk
  const int Dh = a.Dh, Lq = a.Lq, Lk = a.Lk, H = a.H, kv0 = a.kv_len0;
  const size_t stride = (size_t)H * Dh;
  const int chunks = (Dh + kChunkDims - 1) / kChunkDims;
  const int outs = (Dh + kOut - 1) / kOut;  // resident: 1
  const int tiles = kMode == kDQ ? (Lq + kR - 1) / kR : (Lk + kK - 1) / kK;
  const long long bh = blockIdx.x / tiles;  // b H + h
  const int own = (int)(blockIdx.x % tiles) * (kMode == kDQ ? kR : kK);
  const size_t rows_at = ((size_t)(bh / H) * Lq * H + bh % H) * Dh;  // row 0 of q, dO, o, dq
  const size_t keys_at = ((size_t)(bh / H) * Lk * H + bh % H) * Dh;  // key 0 of k, v, dk, dv
  const T* Q = static_cast<const T*>(a.q) + rows_at;
  const T* dO = static_cast<const T*>(a.dout) + rows_at;
  const T* K = static_cast<const T*>(a.k) + keys_at;
  const T* V = static_cast<const T*>(a.v) + keys_at;
  const size_t stat0 = (size_t)bh * Lq;  // (b, h, row 0) of the statistics and the mask
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  const bool vec = Dh % (16 / (int)sizeof(T)) == 0 && bases % 16 == 0;
  const uint8_t* keep = a.keep;
  const bool keep4 = Lk % 4 == 0 && reinterpret_cast<uintptr_t>(keep) % 4 == 0;
  const float cc = 1.f / a.scale * 1.44269504088896341f;  // the forward's c
  const float inv_keep = 1.f / a.keep_prob, inv_scale = 1.f / a.scale;

  // The walk: the CTA's own tile against its partner tiles.  dQ: own rows
  // [own, own + rn), key tiles from 0 up to the last key a row sees.  dK/dV:
  // own keys [own, own + kn), row tiles of 16 from the first row that sees
  // the tile (none if no row does).
  const int r_first = max(0, own - kv0 + 1);
  const int n_max = min(Lk, kv0 + Lq - 1);  // keys some row sees
  const int own_n = kMode == kDQ ? min(kR, Lq - own) : min(kK, Lk - own);
  const int pairs = kMode == kDQ ? (min(Lk, kv0 + own + own_n - 1) + kK - 1) / kK
                                 : (own < n_max ? (Lq - r_first + kR - 1) / kR : 0);
  auto row0 = [&](int p) { return kMode == kDQ ? own : r_first + p * kR; };
  auto key0 = [&](int p) { return kMode == kDQ ? p * kK : own; };

  // Stages.  The dQ grid's first pass: in bf16 a stage a key tile's k and v
  // rows (its scores and dP', for the max and D); in f32 (D = rowsum(dO o),
  // no dP' needed) a stage two key tiles' k rows, each warp group the
  // scores of one.  Resident, the pass's stages and the pairs' are one a
  // pair; streamed, a chunk a stage, then the product stages.
  constexpr bool kPreF32 = kMode == kDQ && !kBf16;
  constexpr int kExtra = kRes ? 0 : (kMode == kOneGrid ? 2 : 1);
  const int sweep_stages = kRes ? 1 : chunks;
  const int per_pair = sweep_stages + kExtra;
  const int pre_pairs = kMode != kDQ ? 0 : kPreF32 ? (pairs + 1) / 2 : pairs;
  const int stages = pre_pairs * sweep_stages + outs * pairs * per_pair;
  // the next stage to issue: (pre-pass or not, pair, stage of the pair, output chunk)
  int issued = 0, i_p = 0, i_sub = 0, i_co = 0;
  bool i_pre = pre_pairs > 0;

  auto issue = [&]() {  // the next stage's copies into slot `issued` % 2
    if (issued >= stages) return;
    T* dst = slots + (issued & 1) * kSlot;
    const int p = i_p, sub = i_sub, co = i_co;
    const bool pre = i_pre;
    if (++i_sub == (pre ? sweep_stages : per_pair)) {  // advance the cursor
      i_sub = 0;
      if (++i_p == (pre ? pre_pairs : pairs)) {
        i_p = 0;
        if (pre) i_pre = false;
        else ++i_co;
      }
    }
    ++issued;
    // f32's first pass: key tiles 2 p and 2 p + 1 (k rows only), else the pair's tiles
    const bool two = kPreF32 && pre;
    const int r0 = row0(p), j0 = key0(two ? 2 * p : p), j1 = j0 + kK;
    const int rn = min(kR, Lq - r0), kn = min(kK, Lk - j0), kn1 = max(0, min(kK, Lk - j1));
    uint8_t* keep_at = reinterpret_cast<uint8_t*>(dst + L::kSlotRows * LD);
    const bool with_keep = keep != nullptr && !two;
    if constexpr (kRes) {  // the partner rows over the whole head, and the pair's keep bytes
      if (kMode == kDQ) {
        stage_tile<kOut, LD>(dst, K + j0 * stride, stride, kK, kn, Dh, vec, tid, kThreads);
        if (two)
          stage_tile<kOut, LD>(dst + kK * LD, K + j1 * stride, stride, kK, kn1, Dh, vec, tid,
                               kThreads);
        else
          stage_tile<kOut, LD>(dst + kK * LD, V + j0 * stride, stride, kK, kn, Dh, vec, tid,
                               kThreads);
      } else {
        stage_tile<kOut, LD>(dst, Q + r0 * stride, stride, kR, rn, Dh, vec, tid, kThreads);
        stage_tile<kOut, LD>(dst + kR * LD, dO + r0 * stride, stride, kR, rn, Dh, vec, tid,
                             kThreads);
      }
      if (with_keep)
        stage_keep<kK, kKeepLD>(keep_at, keep + (stat0 + r0) * Lk + j0, Lk, kR, rn, kn, keep4,
                                tid, kThreads);
    } else if (sub < chunks) {  // a sweep stage: chunk `sub` of the pair's q, k, dO and v rows
      const int c = sub, dims = Dh - c * kChunkDims;
      stage_tile<kChunkDims, LD>(dst, Q + r0 * stride + c * kChunkDims, stride, kR, rn, dims,
                                 vec, tid, kThreads);
      stage_tile<kChunkDims, LD>(dst + kR * LD, K + j0 * stride + c * kChunkDims, stride, kK, kn,
                                 dims, vec, tid, kThreads);
      if (two) {  // the second key tile's k rows where v's would be
        stage_tile<kChunkDims, LD>(dst + 3 * kR * LD, K + j1 * stride + c * kChunkDims, stride,
                                   kK, kn1, dims, vec, tid, kThreads);
      } else {
        stage_tile<kChunkDims, LD>(dst + 2 * kR * LD, dO + r0 * stride + c * kChunkDims, stride,
                                   kR, rn, dims, vec, tid, kThreads);
        stage_tile<kChunkDims, LD>(dst + 3 * kR * LD, V + j0 * stride + c * kChunkDims, stride,
                                   kK, kn, dims, vec, tid, kThreads);
      }
      if (with_keep && c == chunks - 1)  // P' reads them after the pair's last chunk
        stage_keep<kK, kKeepLD>(keep_at, keep + (stat0 + r0) * Lk + j0, Lk, kR, rn, kn, keep4,
                                tid, kThreads);
    } else if (kMode == kDQ || sub == chunks + 1) {  // dQ's: the output chunk's k rows
      for (int i = 0; i < 2; ++i) {
        const int c = 2 * co + i;
        stage_tile<kChunkDims, LD>(dst + i * kK * LD, K + j0 * stride + c * kChunkDims, stride,
                                   kK, kn, Dh - c * kChunkDims, vec, tid, kThreads);
      }
    } else {  // dK's and dV's: the output chunk's q rows, then its dO rows
      for (int i = 0; i < 2; ++i) {
        const int c = 2 * co + i;
        stage_tile<kChunkDims, LD>(dst + i * kR * LD, Q + r0 * stride + c * kChunkDims, stride,
                                   kR, rn, Dh - c * kChunkDims, vec, tid, kThreads);
        stage_tile<kChunkDims, LD>(dst + (2 + i) * kR * LD, dO + r0 * stride + c * kChunkDims,
                                   stride, kR, rn, Dh - c * kChunkDims, vec, tid, kThreads);
      }
    }
  };
  int s = 0;
  auto next = [&]() -> const T* {  // waits for stage s, starts s + 1; stage s's slot
    cp_async_wait<0>();
    __syncthreads();  // stage s landed for every thread, stage s - 1's slot is free
    issue();
    cp_async_commit();
    return slots + (s++ & 1) * kSlot;
  };

  // A pair's scores (acc: before the division by sqrt(Dh)) and dP', the
  // 16 x 16 in the mma's accumulator layout in every warp (lane 4 g + t:
  // rows g and g + 8, keys 8 n + 2 t and 8 n + 2 t + 1); in f32's first pass
  // (`two`) the scores of two key tiles instead, the second in dp.  `jn`:
  // the keys of each tile some row of the pair sees.  Returns the slot of its
  // last stage (resident: its rows; its keep bytes).
  auto sweep = [&](float (&sc)[kK / 8][4], float (&dp)[kK / 8][4], int jn0, int jn1,
                   bool two) -> const T* {
    float x[kK / 8][4];
#pragma unroll
    for (int n = 0; n < kK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
    const int jn = group ? jn1 : jn0;
    const T* st = nullptr;
    if constexpr (kRes) {
      st = next();
      // q (or dO) and k (or v, or the second tile's k) rows of the warp's group
      const T *rq, *rk;
      if (kMode == kDQ) {
        rq = own_rows + (group && !two ? kR * LD : 0);
        rk = st + group * kK * LD;
      } else {
        rq = st + group * kR * LD;
        rk = own_rows + group * kK * LD;
      }
      for (int c = 0; c < chunks; ++c)
        wide_score_chunk<kK, LD>(x, rq + c * kChunkDims, rk + c * kChunkDims, jn,
                                 Dh - c * kChunkDims, part, lane);
    } else {
      for (int c = 0; c < chunks; ++c) {
        st = next();
        wide_score_chunk<kK, LD>(x, st + (group && !two ? 2 : 0) * kR * LD,
                                 st + (2 * group + 1) * kR * LD, jn, Dh - c * kChunkDims, part,
                                 lane);
      }
    }
    wide_score_put<kK>(x, sRed + group * kWideSplit * 32 * (kK / 2), part, lane);
    __syncthreads();
    wide_score_sum<kK>(sc, sRed, lane);
    wide_score_sum<kK>(dp, sRed + kWideSplit * 32 * (kK / 2), lane);
    return st;
  };

  // the pair's rows' seen keys (0 past the row tile)
  auto seen_keys = [&](int r0, int rn, int (&n_row)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      n_row[hh] = r < rn ? min(Lk, kv0 + r0 + r) : 0;
    }
  };
  // g = dP' (bf16: rounded) times the keep mask's M / kp
  auto grad_p = [&](float dpv, const uint8_t* sk, int hh, int kk) {
    float gv = round_as<T>(dpv);
    if (keep != nullptr) gv = sk[(g + 8 * hh) * kKeepLD + kk] ? gv * inv_keep : 0.f;
    return gv;
  };
  // f32: D = rowsum(dO * o) of rows [r0, r0 + rn) into sD, two rows a warp
  // (read after the next __syncthreads)
  auto rowsum_do_o = [&](int r0, int rn) {
    if constexpr (!kBf16) {
      const float* O = static_cast<const float*>(a.o) + rows_at;
      const float* dOf = static_cast<const float*>(a.dout) + rows_at;
      for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
        float part_d = 0.f;
        if (r < rn)
          for (int d = lane; d < Dh; d += 32)
            part_d = fmaf(dOf[(size_t)(r0 + r) * stride + d], O[(size_t)(r0 + r) * stride + d],
                          part_d);
        part_d = mansy::warp_sum(part_d);
        if (lane == 0) sD[r] = part_d;
      }
    }
  };

  // resident: the own rows, with stage 0 (none for a key tile no row sees)
  if constexpr (kRes) {
    if (pairs > 0) {
      const T* A = kMode == kDQ ? Q : K;
      const T* B2 = kMode == kDQ ? dO : V;
      stage_tile<kOut, LD>(own_rows, A + own * stride, stride, 16, own_n, Dh, vec, tid, kThreads);
      stage_tile<kOut, LD>(own_rows + 16 * LD, B2 + own * stride, stride, 16, own_n, Dh, vec, tid,
                           kThreads);
    }
  }
  issue();
  cp_async_commit();

  // the dQ grid's first pass: each row's max_acc, and bf16's D
  float mx[2] = {-INFINITY, -INFINITY}, D[2] = {0.f, 0.f}, inv_sum[2] = {0.f, 0.f};
  if constexpr (kMode == kDQ) {
    const int r0 = own, rn = own_n;
    int n_row[2];
    seen_keys(r0, rn, n_row);
    const int n_pair = min(Lk, kv0 + r0 + rn - 1);
    rowsum_do_o(r0, rn);        // f32's D
    float run[2] = {0.f, 0.f};  // bf16: sum_k g_k 2^(acc_k c - mx c), rescaled as mx grows
    for (int p = 0; p < pre_pairs; ++p) {
      const int j0 = (kPreF32 ? 2 * p : p) * kK;
      float sc[kK / 8][4], dp[kK / 8][4];
      const int jn0 = min(kK, n_pair - j0);  // f32: and the second tile's, in dp
      const uint8_t* sk = reinterpret_cast<const uint8_t*>(
          sweep(sc, dp, jn0, kPreF32 ? min(kK, n_pair - j0 - kK) : jn0, kPreF32) +
          L::kSlotRows * LD);
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * n + 2 * t + (e & 1);
          if (j0 + kk < n_row[e >> 1]) tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[n][e]);
          if (kPreF32 && j0 + kK + kk < n_row[e >> 1])  // the second tile's scores
            tmax[e >> 1] = fmaxf(tmax[e >> 1], dp[n][e]);
        }
      float m_new[2], mc[2], part_d[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(kFull, tmax[hh], 1));
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(kFull, tmax[hh], 2));
        m_new[hh] = fmaxf(mx[hh], tmax[hh]);
        mc[hh] = m_new[hh] * cc;
      }
      if constexpr (kBf16) {
#pragma unroll
        for (int n = 0; n < kK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1, kk = 8 * n + 2 * t + (e & 1);
            if (j0 + kk < n_row[hh])
              part_d[hh] += grad_p(dp[n][e], sk, hh, kk) * exp2_ftz(fmaf(sc[n][e], cc, -mc[hh]));
          }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (kBf16) {
          part_d[hh] += __shfl_xor_sync(kFull, part_d[hh], 1);
          part_d[hh] += __shfl_xor_sync(kFull, part_d[hh], 2);
        }
        if (m_new[hh] != -INFINITY) {  // the row sees a key of this tile or an earlier one
          if (kBf16) run[hh] = run[hh] * exp2_ftz(mx[hh] * cc - mc[hh]) + part_d[hh];
          mx[hh] = m_new[hh];
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      if (r < rn) {
        inv_sum[hh] = 1.f / a.row_sum[stat0 + r0 + r];
        D[hh] = kBf16 ? run[hh] * inv_sum[hh] : sD[r];
        if (warp == 0 && t == 0) {  // for the dK/dV grid
          a.row_max_acc[stat0 + r0 + r] = mx[hh];
          a.delta[stat0 + r0 + r] = D[hh];
        }
      }
    }
  }

  T* dQ = static_cast<T*>(a.dq) + rows_at;
  T* dK = static_cast<T*>(a.dk) + keys_at;
  T* dV = static_cast<T*>(a.dv) + keys_at;
  for (int co = 0; co < outs; ++co) {
    const int c_mine = 2 * co + group;                                 // the warp's chunk
    const int dims = Dh - c_mine * kChunkDims - part * kWideDims;      // and its dims there
    const int d_first = c_mine * kChunkDims + part * kWideDims;        // its first dim
    float acc0[kWideDims / 8][4], acc1[kWideDims / 8][4];  // dQ; or dK and dV
#pragma unroll
    for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.f;
    for (int p = 0; p < pairs; ++p) {
      const int r0 = row0(p), j0 = key0(p);
      const int rn = min(kR, Lq - r0);
      int n_row[2];
      seen_keys(r0, rn, n_row);
      const int jn = min(kK, min(Lk, kv0 + r0 + rn - 1) - j0);  // keys some row of the pair sees
      if constexpr (kMode != kDQ) {  // the rows' exp sums; dK/dV: max_acc and D (dQ grid's)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = g + 8 * hh;
          inv_sum[hh] = r < rn ? 1.f / a.row_sum[stat0 + r0 + r] : 0.f;
          if (kMode == kDKV) {
            mx[hh] = r < rn ? a.row_max_acc[stat0 + r0 + r] : 0.f;
            D[hh] = r < rn ? a.delta[stat0 + r0 + r] : 0.f;
          }
        }
      }
      float sc[kK / 8][4], dp[kK / 8][4];
      const T* pst = sweep(sc, dp, jn, jn, false);
      const uint8_t* sk = reinterpret_cast<const uint8_t*>(pst + L::kSlotRows * LD);
      float mc[2];
      if constexpr (kMode == kOneGrid) {  // one key tile: the rows' max_acc and D from this pair
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * n + 2 * t + (e & 1) < n_row[e >> 1])
              tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[n][e]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(kFull, tmax[hh], 1));
          tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(kFull, tmax[hh], 2));
          const int r = g + 8 * hh;
          mc[hh] = r < rn ? tmax[hh] * cc : 0.f;
        }
        // D = sum_k g_k P_k (the pair holds each row's every key)
        float part_d[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1, kk = 8 * n + 2 * t + (e & 1);
            if (j0 + kk < n_row[hh])
              part_d[hh] += grad_p(dp[n][e], sk, hh, kk) *
                            (exp2_ftz(fmaf(sc[n][e], cc, -mc[hh])) * inv_sum[hh]);
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          part_d[hh] += __shfl_xor_sync(kFull, part_d[hh], 1);
          part_d[hh] += __shfl_xor_sync(kFull, part_d[hh], 2);
          D[hh] = part_d[hh];
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) mc[hh] = mx[hh] * cc;
      }
      // P' and dS / sqrt(Dh) of the pair (0 where the row does not see the key)
      float pd[kK / 8][4], dsv[kK / 8][4];
#pragma unroll
      for (int n = 0; n < kK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, kk = 8 * n + 2 * t + (e & 1);
          pd[n][e] = dsv[n][e] = 0.f;
          if (j0 + kk < n_row[hh]) {
            // the forward's P, and P'
            const float pv = exp2_ftz(fmaf(sc[n][e], cc, -mc[hh])) * inv_sum[hh];
            pd[n][e] = pv;
            if (keep != nullptr)
              pd[n][e] = sk[(g + 8 * hh) * kKeepLD + kk] ? pv * inv_keep : 0.f;
            dsv[n][e] = pv * (grad_p(dp[n][e], sk, hh, kk) - D[hh]) * inv_scale;
          }
        }

      if constexpr (kMode != kDQ) {  // dV += P'^T dO, dK += dS^T q
        if (warp == 0)
#pragma unroll
          for (int n = 0; n < kK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int at = (g + 8 * (e >> 1)) * kTLD + 8 * n + 2 * t + (e & 1);
              sT[at] = pd[n][e];
              sT[kR * kTLD + at] = dsv[n][e];
            }
        const T *qb, *ob;  // the warp's dims of the pair's q and dO rows
        if constexpr (kRes) {
          __syncthreads();  // P' and dS in sT
          qb = pst + group * kChunkDims + part * kWideDims;
          ob = pst + kR * LD + group * kChunkDims + part * kWideDims;
        } else {
          const T* st = next();  // the output chunk's q rows [2][kR][LD], then its dO rows
          qb = st + group * kR * LD + part * kWideDims;
          ob = st + (2 + group) * kR * LD + part * kWideDims;
        }
        // the transposed operands: A's rows the keys, its k-steps the rows
        float pT[kR / 8][4], dT[kR / 8][4], dTlo[kR / 8][4];
#pragma unroll
        for (int n = 0; n < kR / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int at = (8 * n + 2 * t + (e & 1)) * kTLD + g + 8 * (e >> 1);
            pT[n][e] = sT[at];
            dT[n][e] = sT[kR * kTLD + at];
            // bf16: dS as two bf16 terms, hi + lo (pv_tile rounds each as it packs it)
            dTlo[n][e] = kBf16 ? dT[n][e] - round_as<T>(dT[n][e]) : 0.f;
          }
        if (dims > 0) {
          float x[kWideDims / 8][4];
#pragma unroll
          for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
          pv_tile<kR, kWideDims, LD>(x, pT, ob, rn, dims, lane);
#pragma unroll
          for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc1[n][e] += x[n][e];
              x[n][e] = 0.f;
            }
          pv_tile<kR, kWideDims, LD>(x, dT, qb, rn, dims, lane);
          if constexpr (kBf16) pv_tile<kR, kWideDims, LD>(x, dTlo, qb, rn, dims, lane);
#pragma unroll
          for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc0[n][e] += x[n][e];
        }
      }
      if constexpr (kMode != kDKV) {  // dQ += dS k
        const T* kb;  // the warp's dims of the pair's k rows
        if constexpr (kRes) {
          kb = (kMode == kDQ ? pst : own_rows) + group * kChunkDims + part * kWideDims;
        } else {
          const T* st = next();  // the output chunk's k rows [2][kK][LD]
          kb = st + group * kK * LD + part * kWideDims;
        }
        float x[kWideDims / 8][4], dlo[kK / 8][4];
#pragma unroll
        for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
        for (int n = 0; n < kK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)  // bf16: dS as two bf16 terms, hi + lo
            dlo[n][e] = kBf16 ? dsv[n][e] - round_as<T>(dsv[n][e]) : 0.f;
        if (dims > 0) {
          pv_tile<kK, kWideDims, LD>(x, dsv, kb, jn, dims, lane);
          if constexpr (kBf16) pv_tile<kK, kWideDims, LD>(x, dlo, kb, jn, dims, lane);
        }
        if constexpr (kMode == kDQ) {
#pragma unroll
          for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc0[n][e] += x[n][e];
        } else {  // one key tile: the pair's dQ is the rows' whole sum
#pragma unroll
          for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
              if (rr < rn && d < dims)
                dQ[(size_t)(r0 + rr) * stride + d_first + d] = from_f32<T>(x[n][e]);
            }
        }
      }
    }
    // the output chunk's sums: dQ of the row tile, or dK and dV of the key tile
#pragma unroll
    for (int n = 0; n < kWideDims / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
        if (rr < own_n && d < dims) {
          const size_t at = (size_t)(own + rr) * stride + d_first + d;
          if constexpr (kMode == kDQ) {
            dQ[at] = from_f32<T>(acc0[n][e]);
          } else {
            dK[at] = from_f32<T>(acc0[n][e]);
            dV[at] = from_f32<T>(acc1[n][e]);
          }
        }
      }
  }
}

template <typename T, int kMode, bool kRes>
cudaError_t launch(const AttentionBackwardArgs& a, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(kRes, sizeof(T));
  auto kernel = backward_wide_kernel<T, kMode, kRes>;
  const cudaError_t e = opt_in(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One key tile: the one grid, a CTA a (b, head); else the dQ grid, then the
// dK/dV grid; resident up to kOut dims, streamed past them.
template <typename T>
cudaError_t launch_plan(const AttentionBackwardArgs& a, cudaStream_t s) {
  const long long pairs = (long long)a.B * a.H;
  if (a.Lk <= kK)
    return a.Dh <= kOut ? launch<T, kOneGrid, true>(a, pairs, s)
                        : launch<T, kOneGrid, false>(a, pairs, s);
  if (a.delta == nullptr || a.row_max_acc == nullptr) return cudaErrorInvalidValue;
  const long long dq_blocks = pairs * ((a.Lq + kR - 1) / kR);
  const long long dkv_blocks = pairs * ((a.Lk + kK - 1) / kK);
  if (a.Dh <= kOut) {
    const cudaError_t e = launch<T, kDQ, true>(a, dq_blocks, s);
    return e != cudaSuccess ? e : launch<T, kDKV, true>(a, dkv_blocks, s);
  }
  const cudaError_t e = launch<T, kDQ, false>(a, dq_blocks, s);
  return e != cudaSuccess ? e : launch<T, kDKV, false>(a, dkv_blocks, s);
}

}  // namespace

// elem = 0: f32 tensors; 1: bf16.  More than one query row past 256 dims,
// the plan's tiles (kernels/attention.py:attention_backward_plan,
// "tile_wide_tc"): kK keys and kR rows a tile, 8 warps.
extern "C" int attention_backward_wide_launch(const AttentionBackwardArgs* args, int elem,
                                              void* stream) {
  const AttentionBackwardArgs& a = *args;
  if ((long long)a.B * a.H <= 0) return 0;
  if (a.Lq < 2 || a.Lk < 1 || a.Dh <= kChunkDims || a.kv_len0 < 1 || a.keys != kK ||
      a.rows != kR || a.warps != kWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem == 0) return (int)launch_plan<float>(a, s);
  if (elem == 1) return (int)launch_plan<mansy::bf16>(a, s);
  return (int)cudaErrorInvalidValue;
}
