// K8: the softmax-attention core of the MTIO transformer, in f32:
// per (b, query row, head), softmax(q . k^T / sqrt(Dh)) . v over a prefix of
// the keys.
//
// Replaces the deleted Pallas kernel mha_pallas and the XLA path the JAX
// package keeps: models/transformer.py:MHA.attend (:61-75), under
// EncoderLayer (:106), DecoderLayer.__call__ (:134, :136) and
// DecoderLayer.step (:159, :161).  The plain PyTorch version is
// kernels/attention.py:attention_plain.
//
// Every mask on those paths is a prefix of the keys: the KV-cached decode
// step t masks slots > t, the full decode is causal, and the encoder and
// cross-attention mask nothing.  So the kernel takes no mask tensor: query
// row r sees keys [0, min(Lk, kv_len0 + r)).  JAX fills the masked scores
// with -1e30, whose exp after the max subtraction is exactly 0; skipping
// those keys gives the same sums.
//
// Layouts are the JAX package's: q [B, Lq, H, Dh], k and v [B, Lk, H, Dh],
// o [B, Lq, H, Dh], all contiguous, all f32 or all bf16 (the element type T,
// a template parameter; csrc/elem.cuh).
//
// bf16 (run_models --bf16, MHA.attend at dtype=bfloat16): q, k and v are
// read as bf16 and every sum runs in f32, as JAX's rounding points are:
// the scores are f32 sums of the exact products (preferred_element_type=
// f32, transformer.py:68-69), the softmax and the dropout act on the f32 P
// (:70-73), P is rounded to bf16 (p.astype(v.dtype), :74), P . v is summed
// in f32 and o rounded to bf16 once.  The f32 instantiations compile as
// before: every rounding is an identity there.
//
// Training mode (kTrain): the same pass, and also a row's max and exp sum
// written out as f32 [B, H, Lq] (the backward, csrc/attention_backward.cu,
// recomputes each p from them: see Bits below), and an optional keep mask u8
// [B, H, Lq, Lk] of the attention-probability dropout: a kept p becomes
// p / keep_prob, a dropped one 0, as flax's Dropout does
// (MHA.attend, transformer.py:72-73).  The serving instantiation has
// neither and compiles as before.
//
// Bound: bytes at the main path's shapes.  A launch reads q, the k and v
// rows its rows see once and writes o (and in training the statistics, and
// reads the keep mask); per (row, key) it does 4 Dh flops (q . k and p . v)
// and a few scalar ones.  At B 512, 8 heads of 64 the bytes bound every
// shape; at 96 x 96 in f32 the bytes bound (0.1465 ms on the H100) and the
// f32 FMA bound (9.66 GFLOP at 67 TFLOP/s, 0.144 ms) meet.  Two kernels
// and their variants past 2048 keys and 256 dims, picked by the wrapper's
// plan (kernels/attention.py:attention_forward_plan):
//
//   row kernel (Lq = 1: every decode step and the decode's cross-attention,
//     60 of a viewport batch's 62 launches): one warp a (b, row, head); lane
//     l holds dims l, l + 32, ... of q and of the output; a key's score is
//     a warp sum (every lane gets it), the row's scores sit in shared
//     memory, and the softmax normalises them as jax.nn.softmax does
//     (exp(s - max) / sum) before the p . v sum, key by key.  Neighbouring
//     warps are neighbouring heads, so a block's k and v loads are
//     contiguous.  Each row reads its keys once: nothing to share.
//
//   tile kernel (Lq > 1: the encoder, the teacher-forced causal pass and its
//     cross-attention, any --his-window).  Run as the row kernel, every
//     query row would re-read all k and v rows of its (b, head) and spend
//     some 50 warp instructions a (row, key) behind dependent shuffle
//     chains (2% of the bound at 96 x 96 on the H100).  Here a CTA takes
//     a (b, head, row tile) and stages a key tile's k rows in shared memory
//     once, with the tile's rows of the keep mask, then its v rows in the
//     same buffer while the warps take their softmax (cp.async; bf16 kept
//     as bf16 and converted as it is read).  Each warp takes R = 4 rows:
//     one staged k value feeds R per-lane fmaf chains, and
//     reduce_scatter_placed (csrc/attention_common.cuh) turns R rows x 32 /
//     R keys of partials into 32 scores, one a lane, with one shuffle and
//     one add a score: each lane places its partials by its lane index (its
//     q rows and key order permuted once), so the reduction needs no
//     selects.  The scores go to a per-row buffer in shared memory (rows x
//     Lk floats, which is why the row tile shrinks as Lk grows); the warp
//     takes its rows' max, exp(s - max), each row's sum serially in key
//     order (a lane a row), p = e / sum, the keep mask and the rounding to
//     T once a (row, key), its R rows in each pass.  Then a lane holds dims
//     l, l + 32, ... of its R rows and walks the keys in order: one staged
//     v value feeds R fmafs.  About 9 warp instructions a (row, key) at Dh
//     64 (2 of them the reduction's): on the H100 the kernel is bound by
//     their issue and latency, not by the bytes.
//
//   past the tile kernel's reach (attention_stream_kernel): where the score
//     rows would leave a row tile of fewer than 16 rows (past about 2490
//     keys; --his-window up to JAX's 5000 and beyond) and past 256 dims,
//     the streamed kernel keeps no row's scores and takes its products on
//     the tensor cores (mma.sync; csrc/attention_common.cuh: score_tile,
//     pv_tile).  A CTA a (b, head, row tile of up to 64 rows), a warp 16
//     rows (one m16 fragment), key tiles of 64 keys (32 past 64 dims);
//     bf16 products on m16n8k16 with f32 accumulators (exact products
//     summed in f32, as JAX's preferred_element_type=f32), f32 ones in
//     3xTF32 on m16n8k8.  Two passes over the key tiles keep JAX's
//     rounding points: pass A takes each row's max and exp(s - max) sum,
//     the sum rescaled online as the max grows; pass B takes the scores
//     again, p = exp(s - max) / sum, the keep mask, the rounding of p to T,
//     then P . v, o rounded to T once.  (One pass with unnormalised
//     exponentials rounded to bf16 would round P where JAX does not.)
//     Stages (a key tile's k rows, its v rows) stream through two
//     shared-memory slots by cp.async, the next in flight while the warps
//     take the current one; the row tile's q rows stay resident; in
//     training the tile's rows of the keep mask come with its k rows (read
//     from device memory a byte a score, they cost more than the rest of
//     the training mode's extra work).  The softmax takes an FFMA and an
//     exp2 a score and pass (the scale folded into the exponent), one
//     multiply by the row's reciprocal sum, the keep mask and the
//     rounding: with expf and IEEE divisions in their place, this scalar
//     work, not the products, took most of the kernel's time on the H100.
//     The tensor cores round their f32 sums toward zero; over 5000 keys
//     (1875 3xTF32 mma into one f32 output) that drift passed K8's f32
//     limit, so each key tile's P . v (and each chunk's scores) starts
//     from zero and is added to the row's sums in f32.
//
//   heads past 256 dims (attention_row_wide_kernel for one query row, the
//     streamed kernel's kWide instances for more, which also take the
//     heads of 129 to 256 dims; --hidden-dim past 2048): the row kernel
//     takes the head in chunks of 256 dims, 8 a lane (attention_common.cuh:
//     kChunkDims, chain_on), a score's per-lane partial carried from chunk
//     to chunk and only then reduced.  The streamed kernel's kWide
//     instances take 16 rows a CTA on 4 warps, each warp a quarter (64
//     dims) of every chunk of 256 dims: a key tile's scores sum over the
//     chunks (the q chunk staged with the key tile's k rows), the 4 warps'
//     partial scores are summed through shared memory in warp order, and
//     P . v runs over output chunks of 512 dims (two v chunks of 256, 64
//     dims of each a warp: 64 accumulator registers a lane), the scores
//     recomputed for each: pass B runs once an output chunk.  At Dh 512: 1
//     output chunk and 2 q and k chunks a key tile, the scores taken twice,
//     as at up to 256 dims; at Dh 2048: 4 output chunks, 8 q and k chunks a
//     key tile, the scores taken 5 times (output chunks of 256 dims took
//     them 3 and 9 times, and lost to the SIMT kernel before this one at
//     15 x 15 in f32 at Dh 257 and 320).  Of the two layouts that keep a
//     row tile's output out of registers, this one (P . v over output
//     chunks, the scores recomputed a chunk) was taken over staging P in
//     shared memory a key tile at a time: that one still keeps the row
//     tile's whole output across the key tiles (16 x 2048 f32 = 128 KB at
//     Dh 2048, read and written a key tile), while this one is the narrow
//     kernel with one loop more (the narrow case: one output chunk and one
//     q and k chunk) and shared memory that does not grow with Dh (about
//     106 KB in f32).  Four warps a row fragment, not one: with one warp's
//     3xTF32 chain over a whole chunk, a CTA of one warp and stages of 64
//     dims, the few rows and keys of the teacher-forced 15 x 15 at Dh 512
//     took longer than the SIMT kernel before this one.
//
// Bits: the tile kernel does each score, max, sum, p and output element
// with the operations of the row kernel in the same order (the same
// per-lane chains and butterfly, the same serial sum, the same IEEE
// divisions, P . v an fmaf chain over the keys in order), so its outputs
// (o; in training row_max and row_sum) are the row kernel's bits, in f32
// and in bf16.  The streamed kernel sums its scores and P . v in the
// tensor cores' order and its exp sums online, so it gives other bits,
// within f32 ulps of the tile kernel's (and of the plain version's): two
// of its launches are bit-equal (no atomics, fixed orders).  The backward
// (csrc/attention_backward.cu, _split.cu) recomputes each p from row_max
// and row_sum by its SIMT scores: bit for bit the forward's p after the
// row and tile kernels, within ulps of it after the streamed one up to 256
// dims; the wide row kernels forward and backward share one definition of
// a score, and past 256 dims the backward of more than one row
// (csrc/attention_backward_wide.cu) takes its scores by the streamed
// kernel's own wide score tile (attention_common.cuh: wide_score_chunk,
// wide_score_put, wide_score_sum) and its p by the same exp2, so the
// backward's P is the wide forward's on either path.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "common.cuh"
#include "elem.cuh"

using mansy::from_f32;
using mansy::kFull;
using mansy::round_as;
using mansy::to_f32;
using mansy::warp_sum;
using mansy::attn::chain;
using mansy::attn::chain_on;
using mansy::attn::exp2_ftz;
using mansy::attn::kChunkDims;
using mansy::attn::load_chunk;
using mansy::attn::opt_in;
using mansy::attn::pv_tile;
using mansy::attn::reduce_scatter_placed;
using mansy::attn::score_tile;
using mansy::attn::stage_bytes;
using mansy::attn::stage_rows_as_is;
using mansy::attn::stage_keep;
using mansy::attn::stage_tile;
using mansy::attn::wide_score_chunk;
using mansy::attn::wide_score_put;
using mansy::attn::wide_score_sum;
using mansy::tc::cp_async_commit;
using mansy::tc::cp_async_wait;

constexpr int kWarps = 4;        // row kernel: warps (query rows) a block
constexpr int kMaxPerLane = 8;   // Dh <= 256 (wider heads: the wide variants' chunks)
constexpr int kGroup = 4;        // tile kernel: rows a warp takes at once (R)
constexpr int kGroupKeys = 32 / kGroup;  // keys of a reduction, for each of them
constexpr int kMaxTileRows = 32;  // tile kernel: rows a row tile (8 warps)
constexpr int kMaxTileThreads = kMaxTileRows / kGroup * 32;
constexpr int kMaxSmem = 232448;  // the H100's shared memory a block (227 KB)
constexpr int kStreamGroup = 16;      // streamed kernel: rows a warp (one m16 fragment)
constexpr int kStreamThreads = 128;   // and at most 4 warps a CTA: row tiles of up to 64 rows
// the streamed kernel's keys a tile: 64 up to 64 dims, else 32 (a warp's
// output takes 2 x 4 P registers a lane, and the scores 2 keys / 8)
__host__ __device__ constexpr int stream_keys(int P) { return P >= 4 ? 32 : 64; }

// Field order must match kernels/attention.py:_AttentionArgs.
struct AttentionArgs {
  const void* q;    // T [B, Lq, H, Dh]
  const void* k;    // T [B, Lk, H, Dh]
  const void* v;    // T [B, Lk, H, Dh]
  void* o;          // T [B, Lq, H, Dh]
  int32_t B, Lq, Lk, H, Dh;
  int32_t kv_len0;  // keys seen by query row 0; row r sees min(Lk, kv_len0 + r)
  float scale;      // sqrt(Dh): scores are (q . k) / scale, as MHA.attend divides
  // training mode only
  const uint8_t* keep;  // [B, H, Lq, Lk] dropout keep mask, or null
  float keep_prob;      // 1 - dropout rate: a kept p is divided by it
  float* row_max;       // [B, H, Lq]
  float* row_sum;       // [B, H, Lq]
  // the tile kernel's plan (kernels/attention.py:attention_forward_plan)
  int32_t per_lane;     // P: dims a lane holds (1, 2, 4 or 8)
  int32_t keys;         // M: keys a staged tile (a multiple of 8)
  int32_t rows;         // rows a row tile (at most 32)
  int32_t group;        // R: rows a warp takes at once (4)
  int32_t stream;       // Lq > 1: 1 takes the streamed tile kernel, 0 the resident one
};

template <typename T, bool kTrain>
__global__ void attention_kernel(const AttentionArgs a) {
  extern __shared__ float scores[];  // [kWarps, Lk]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= (long long)a.B * a.Lq * a.H) return;
  const int h = (int)(row % a.H);
  const int r = (int)((row / a.H) % a.Lq);
  const long long b = row / ((long long)a.H * a.Lq);
  float* s = scores + warp * a.Lk;
  const int n = min(a.Lk, a.kv_len0 + r);

  float q[kMaxPerLane];
  const T* qrow = static_cast<const T*>(a.q) + row * a.Dh;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    q[i] = d < a.Dh ? to_f32(qrow[d]) : 0.f;
  }

  const size_t key_stride = (size_t)a.H * a.Dh;
  const size_t kv0 = ((size_t)b * a.Lk * a.H + h) * a.Dh;
  float mx = -INFINITY;
  for (int j = 0; j < n; ++j) {
    const T* krow = static_cast<const T*>(a.k) + kv0 + j * key_stride;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < a.Dh) part = fmaf(q[i], to_f32(krow[d]), part);
    }
    const float sc = warp_sum(part) / a.scale;
    if (lane == 0) s[j] = sc;
    mx = fmaxf(mx, sc);
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) s[j] = expf(s[j] - mx);
  __syncwarp();
  float sum = 0.f;
  for (int j = 0; j < n; ++j) sum += s[j];

  // the (b, h, r) row of the training mode's statistics and mask
  const long long stat = (b * a.H + h) * a.Lq + r;
  const uint8_t* keep = kTrain && a.keep != nullptr ? a.keep + stat * a.Lk : nullptr;
  if (kTrain && lane == 0) {
    a.row_max[stat] = mx;
    a.row_sum[stat] = sum;
  }

  float acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) acc[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    float p = s[j] / sum;
    if (kTrain && keep != nullptr) p = keep[j] ? p / a.keep_prob : 0.f;
    p = round_as<T>(p);  // bf16: p.astype(v.dtype)
    const T* vrow = static_cast<const T*>(a.v) + kv0 + j * key_stride;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < a.Dh) acc[i] = fmaf(p, to_f32(vrow[d]), acc[i]);
    }
  }
  T* orow = static_cast<T*>(a.o) + row * a.Dh;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < a.Dh) orow[d] = from_f32<T>(acc[i]);
  }
}

// ---- Lq = 1, Dh > 256: the row kernel, its head in chunks of 256 dims ----
// A key's score is lane l's chain over dims l, l + 32, ... of every chunk
// (q and k read a chunk at a time), then warp_sum; the softmax is the row
// kernel's; P . v runs chunk by chunk, each chunk's 8 values a lane over the
// keys in order.
template <typename T, bool kTrain>
__global__ void attention_row_wide_kernel(const AttentionArgs a) {
  extern __shared__ float scores[];  // [kWarps, Lk]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= (long long)a.B * a.Lq * a.H) return;
  const int h = (int)(row % a.H);
  const int r = (int)((row / a.H) % a.Lq);
  const long long b = row / ((long long)a.H * a.Lq);
  float* s = scores + (size_t)warp * a.Lk;
  const int n = min(a.Lk, a.kv_len0 + r), Dh = a.Dh;
  const int chunks = (Dh + kChunkDims - 1) / kChunkDims;
  const T* qrow = static_cast<const T*>(a.q) + row * Dh;
  const size_t key_stride = (size_t)a.H * Dh;
  const size_t kv0 = ((size_t)b * a.Lk * a.H + h) * Dh;

  float mx = -INFINITY;
  for (int j = 0; j < n; ++j) {
    const T* krow = static_cast<const T*>(a.k) + kv0 + j * key_stride;
    float part = 0.f;
    for (int c = 0; c < chunks; ++c) {
      float q[8], kr[8];
      load_chunk(q, qrow, c, lane, Dh);
      load_chunk(kr, krow, c, lane, Dh);
      part = chain_on<8>(part, q, kr, lane, Dh - c * kChunkDims);
    }
    const float sc = warp_sum(part) / a.scale;
    if (lane == 0) s[j] = sc;
    mx = fmaxf(mx, sc);
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) s[j] = expf(s[j] - mx);
  __syncwarp();
  float sum = 0.f;
  for (int j = 0; j < n; ++j) sum += s[j];

  const long long stat = (b * a.H + h) * a.Lq + r;
  const uint8_t* keep = kTrain && a.keep != nullptr ? a.keep + stat * a.Lk : nullptr;
  if (kTrain && lane == 0) {
    a.row_max[stat] = mx;
    a.row_sum[stat] = sum;
  }
  T* orow = static_cast<T*>(a.o) + row * Dh;
  for (int c = 0; c < chunks; ++c) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      float p = s[j] / sum;
      if (kTrain && keep != nullptr) p = keep[j] ? p / a.keep_prob : 0.f;
      p = round_as<T>(p);
      const T* vrow = static_cast<const T*>(a.v) + kv0 + j * key_stride;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = c * kChunkDims + lane + 32 * i;
        if (d < Dh) acc[i] = fmaf(p, to_f32(vrow[d]), acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = c * kChunkDims + lane + 32 * i;
      if (d < Dh) orow[d] = from_f32<T>(acc[i]);
    }
  }
}

// A row of the tile kernel's score buffer: Lk rounded up to 32 floats, plus
// 8, so that a warp's four rows start 8 banks apart.
inline __host__ __device__ int score_stride(int Lk) { return (Lk + 31) / 32 * 32 + 8; }

// ---- Lq > 1: a CTA a (b, head, row tile), a warp R rows ----
template <typename T, bool kTrain, int P>
__global__ void __launch_bounds__(kMaxTileThreads, 65536 / kMaxTileThreads / (P <= 2 ? 64 : 128))
attention_tile_kernel(const AttentionArgs a) {
  constexpr int kD = 32 * P;  // a staged row's values (zeros past Dh)
  constexpr int R = kGroup, KB = kGroupKeys;
  extern __shared__ __align__(16) float smem[];
  const int M = a.keys, RT = a.rows, LS = score_stride(a.Lk);
  T* sK = reinterpret_cast<T*>(smem);  // [M][kD]: a key tile's k rows, as T,
  T* sV = sK;                          // then its v rows once the scores are taken
  float* sS = smem + M * kD;  // [RT][LS]: a row's scores, then exp(s - max), then p
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sS + RT * LS);  // [rn][Lk]: the rows' keep masks
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid % 32;
  const int Dh = a.Dh, Lk = a.Lk;
  const int tiles = (a.Lq + RT - 1) / RT;
  const int bh = (int)blockIdx.x / tiles;  // b H + h
  const int r0 = ((int)blockIdx.x - bh * tiles) * RT, rn = min(RT, a.Lq - r0);
  const int b = bh / a.H, h = bh - b * a.H;
  const size_t stride = (size_t)a.H * Dh;                        // from a row to the next
  const size_t q0 = (((size_t)b * a.Lq + r0) * a.H + h) * Dh;   // row r0 of this (b, head)
  const size_t k0 = ((size_t)b * Lk * a.H + h) * Dh;            // key 0
  const int n_cta = min(Lk, a.kv_len0 + r0 + rn - 1);           // keys the tile's rows see
  const int g0 = (tid / 32) * R;                                // the warp's first row
  const int gn = max(0, min(R, rn - g0));                       // and its rows
  const int n_warp = gn > 0 ? min(Lk, a.kv_len0 + r0 + g0 + gn - 1) : 0;  // keys they see
  // a reduction leaves lane l the score of row l / KB and key l % KB
  const int mine = lane / KB;
  const int n_mine = mine < gn ? min(Lk, a.kv_len0 + r0 + g0 + mine) : 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v);
  const bool vec = Dh % (16 / sizeof(T)) == 0 && bases % 16 == 0;
  const T* K = static_cast<const T*>(a.k) + k0;
  const T* V = static_cast<const T*>(a.v) + k0;

  // the first key tile's k rows and the tile's keep bytes, in flight while q loads
  stage_rows_as_is<kD>(sK, K, stride, min(M, (min(M, n_cta) + KB - 1) / KB * KB), min(M, n_cta),
                       Dh, vec, tid, threads);
  const uint8_t* keep = kTrain ? a.keep : nullptr;
  if (keep != nullptr)  // the tile's rows of the keep mask, contiguous
    stage_bytes(sKeep, keep + ((size_t)bh * a.Lq + r0) * Lk, rn * Lk, tid, threads);
  cp_async_commit();
  int n[R];  // keys each of the warp's rows sees (0 past the tile)
  float q[R][P];  // placed for reduce_scatter_placed: q[g] is row g ^ mine's
#pragma unroll
  for (int g = 0; g < R; ++g) {
    n[g] = g < gn ? min(Lk, a.kv_len0 + r0 + g0 + g) : 0;
    const int row = g ^ mine;
    const T* qrow = static_cast<const T*>(a.q) + q0 + (size_t)(g0 + row) * stride;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int d = lane + 32 * i;
      q[g][i] = row < gn && d < Dh ? to_f32(qrow[d]) : 0.f;
    }
  }

  // scores: key tile by key tile, KB keys of the warp's R rows a reduction
  float mx = -INFINITY;  // lane l: the max of row l / KB over the keys it took
  for (int j0 = 0; j0 < n_cta; j0 += M) {
    const int kn = min(M, n_cta - j0);
    if (j0 == 0) {
      cp_async_wait<0>();  // the k rows and the keep bytes
    } else {
      __syncthreads();  // every warp is done with the last tile
      stage_rows_as_is<kD>(sK, K + (size_t)j0 * stride, stride, min(M, (kn + KB - 1) / KB * KB),
                           kn, Dh, vec, tid, threads);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int jn = min(kn, n_warp - j0);  // keys of this tile the warp's rows see
    for (int jb = 0; jb < jn; jb += KB) {
      float x[R * KB];
#pragma unroll
      for (int s = 0; s < KB; ++s) {  // x[g KB + s]: row g ^ mine, key s ^ (lane % KB)
        float kr[P];
        const T* krow = sK + (jb + (s ^ (lane % KB))) * kD;
#pragma unroll
        for (int i = 0; i < P; ++i) kr[i] = to_f32(krow[lane + 32 * i]);
#pragma unroll
        for (int g = 0; g < R; ++g) x[g * KB + s] = chain<P>(q[g], kr, lane, Dh);
      }
      const float sc = reduce_scatter_placed<R * KB>(x) / a.scale;
      const int j = j0 + jb + lane % KB;
      if (j < n_mine) {
        sS[(g0 + mine) * LS + j] = sc;
        mx = fmaxf(mx, sc);
      }
    }
  }
#pragma unroll
  for (int o = KB / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  __syncthreads();  // every warp is done with the k rows
  // the first v tile streams in while each warp takes its rows' softmax
  stage_rows_as_is<kD>(sV, V, stride, min(M, n_cta), min(M, n_cta), Dh, vec, tid, threads);
  cp_async_commit();

  // softmax of the warp's rows: exp(s - max), each row's sum serially in key
  // order (lane g sums row g), then p = e / sum, the keep mask, the rounding;
  // the passes over the keys take the warp's R rows together
  const float my_max = __shfl_sync(kFull, mx, min(lane, R - 1) * KB);  // lane g: row g's
  float rmax[R];
#pragma unroll
  for (int g = 0; g < R; ++g) rmax[g] = __shfl_sync(kFull, mx, g * KB);
  __syncwarp();  // every lane's scores written
  for (int j = lane; j < n_warp; j += 32) {
#pragma unroll
    for (int g = 0; g < R; ++g)
      if (j < n[g]) sS[(g0 + g) * LS + j] = expf(sS[(g0 + g) * LS + j] - rmax[g]);
  }
  __syncwarp();
  float sum = 0.f;
  if (lane < gn) {
    const float* s = sS + (g0 + lane) * LS;
    const int nl = min(Lk, a.kv_len0 + r0 + g0 + lane);
    int j = 0;
    for (; j + 4 <= nl; j += 4) {
      const float4 e = *reinterpret_cast<const float4*>(s + j);
      sum += e.x;
      sum += e.y;
      sum += e.z;
      sum += e.w;
    }
    for (; j < nl; ++j) sum += s[j];
    if (kTrain) {
      const size_t stat = (size_t)bh * a.Lq + r0 + g0 + lane;  // (b, h, r)
      a.row_max[stat] = my_max;
      a.row_sum[stat] = sum;
    }
  }
  float total[R];
#pragma unroll
  for (int g = 0; g < R; ++g) total[g] = __shfl_sync(kFull, sum, g);
  __syncwarp();
  for (int j = lane; j < n_warp; j += 32) {
#pragma unroll
    for (int g = 0; g < R; ++g) {
      if (j < n[g]) {
        float p = sS[(g0 + g) * LS + j] / total[g];
        if (keep != nullptr) p = sKeep[(g0 + g) * Lk + j] ? p / a.keep_prob : 0.f;
        sS[(g0 + g) * LS + j] = round_as<T>(p);  // bf16: p.astype(v.dtype)
      }
    }
  }
  __syncwarp();

  // P . v: lane l holds dims l, l + 32, ... of the warp's R rows; keys in
  // order, every row's fmaf up to the keys its first row sees, then each
  // row's where it sees the key
  float acc[R][P];
#pragma unroll
  for (int g = 0; g < R; ++g)
#pragma unroll
    for (int i = 0; i < P; ++i) acc[g][i] = 0.f;
  for (int j0 = 0; j0 < n_cta; j0 += M) {
    const int kn = min(M, n_cta - j0);
    if (j0 > 0) {
      __syncthreads();  // every warp is done with the last tile
      stage_rows_as_is<kD>(sV, V + (size_t)j0 * stride, stride, kn, kn, Dh, vec, tid, threads);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const int jn = min(kn, n_warp - j0);
    const int j_all = min(jn, n[0] - j0);  // keys of the tile all the warp's rows see
    for (int j = 0; j < jn; j += 4) {
      float p[R][4];
#pragma unroll
      for (int g = 0; g < R; ++g) {
        float4 p4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < gn) p4 = *reinterpret_cast<const float4*>(sS + (g0 + g) * LS + j0 + j);
        p[g][0] = p4.x;
        p[g][1] = p4.y;
        p[g][2] = p4.z;
        p[g][3] = p4.w;
      }
      if (j + 4 <= j_all) {  // the same for every lane
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vr[P];
#pragma unroll
          for (int i = 0; i < P; ++i) vr[i] = to_f32(sV[(j + u) * kD + lane + 32 * i]);
#pragma unroll
          for (int g = 0; g < R; ++g)
#pragma unroll
            for (int i = 0; i < P; ++i) acc[g][i] = fmaf(p[g][u], vr[i], acc[g][i]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u < jn) {  // the same for every lane
            float vr[P];
#pragma unroll
            for (int i = 0; i < P; ++i) vr[i] = to_f32(sV[(j + u) * kD + lane + 32 * i]);
#pragma unroll
            for (int g = 0; g < R; ++g)
              if (j0 + j + u < n[g])
#pragma unroll
                for (int i = 0; i < P; ++i) acc[g][i] = fmaf(p[g][u], vr[i], acc[g][i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < R; ++g) {
    T* orow = static_cast<T*>(a.o) + q0 + (size_t)(g0 + g) * stride;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int d = lane + 32 * i;
      if (g < gn && d < Dh) orow[d] = from_f32<T>(acc[g][i]);
    }
  }
}

// ---- Lq > 1, streamed: the score tile on the tensor cores ----
// A CTA a (b, head, row tile), a warp 16 rows (one m16 fragment of
// mma.sync), key tiles of kN keys; see the header for the design.  Up to
// 128 dims a CTA takes up to 64 rows on as many warps, each warp the whole
// head.  Past 128 dims (kWide, 8 dims a lane) a CTA takes 16 rows on 4
// warps, each warp a quarter of every chunk of 256 dims: its partial
// scores are summed through shared memory in warp order (the same sums in
// every warp), and P . v gives each warp 64 dims of each of an output
// chunk's two v chunks of 256.  The CTA walks its stages (a key tile's k
// rows, with the row tile's q chunk past 128 dims; or its v rows) through
// two shared-memory slots: stage s + 1's cp.async copies are in flight
// while the warps work on stage s, one __syncthreads a stage.  Pass A:
// each row's max and exp sum, rescaled online a key tile at a time.  Pass B, once an output chunk: the scores
// again (the same operations, so the same bits), p = exp(s - max) / sum,
// the keep mask, the rounding to T, then P . v on the tensor cores; o
// rounded to T once.  The tensor cores round their f32 sums toward zero, a
// drift that grows with the chain: each chunk's scores and each key tile's
// P . v start from zero and are then added in f32 (round to nearest).
// exp(s - max) is 2^(acc c - max_acc c) with c = log2(e) / sqrt(Dh) (one
// FFMA and ex2.approx, as flash kernels take it; within ulps of
// expf((acc / sqrt(Dh)) - max)), and "/ sum" and the dropout's
// "/ keep_prob" multiply by the reciprocal (within an ulp).
template <typename T, bool kTrain, int P>
__global__ void __launch_bounds__(kStreamThreads) attention_stream_kernel(const AttentionArgs a) {
  constexpr bool kWide = P == 8;       // past 128 dims: 4 warps split a row fragment's dims
  constexpr int kD = 32 * P;           // dims of a staged chunk (the head's, narrow)
  constexpr int kSplit = kWide ? 4 : 1;  // warps that split a row fragment's dims
  constexpr int kWD = kD / kSplit;     // dims a warp takes of a staged chunk
  constexpr int kVS = kWide ? 2 : 1;   // v chunks an output chunk (of kVS kD dims)
  constexpr int kN = stream_keys(P);  // keys a tile
  constexpr int kPad = 16 / sizeof(T);  // a row's 16 bytes of padding: no bank conflicts
  constexpr int LS = kD + kPad;         // row stride of q, k and v in shared memory
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int RW = 16 * (threads / 32) / kSplit;  // rows of the CTA's warps (at least the tile's)
  const int ds = warp % kSplit;                 // the warp's share of the dims
  const int w0 = 16 * (warp / kSplit);          // and its first row
  float* sRed = smem;  // kWide: [kSplit][32][kN / 2] the warps' partial scores
  T* sQ = reinterpret_cast<T*>(smem + (kWide ? kSplit * 32 * (kN / 2) : 0));
  T* slots = sQ + (kWide ? 0 : RW * LS);  // narrow: sQ [RW][LS] the row tile's q, resident
  // a slot: [kN][LS] a key tile's k or v rows; kWide: [RW][LS] the q chunk, then the k
  // rows; then (training, pass B) the tile's keep bytes, [RW][kKeep]
  constexpr int kKeep = kN + 4;  // a row's keep bytes (4 more: no bank conflicts)
  const int rows_slot = ((kWide ? RW : 0) + kN) * LS;
  const int slot = rows_slot + (kTrain ? (RW * kKeep + 15) / 16 * 16 / (int)sizeof(T) : 0);
  const int Dh = a.Dh, Lk = a.Lk, RT = a.rows;
  const int tiles = (a.Lq + RT - 1) / RT;
  const int bh = (int)blockIdx.x / tiles;  // b H + h
  const int r0 = ((int)blockIdx.x - bh * tiles) * RT, rn = min(RT, a.Lq - r0);
  const int b = bh / a.H, h = bh - b * a.H;
  const size_t stride = (size_t)a.H * Dh;
  const T* Q = static_cast<const T*>(a.q) + (((size_t)b * a.Lq + r0) * a.H + h) * Dh;
  const T* K = static_cast<const T*>(a.k) + ((size_t)b * Lk * a.H + h) * Dh;
  const T* V = static_cast<const T*>(a.v) + ((size_t)b * Lk * a.H + h) * Dh;
  const int n_cta = min(Lk, a.kv_len0 + r0 + rn - 1);  // keys the tile's rows see
  const int n_warp = w0 < rn ? min(Lk, a.kv_len0 + r0 + min(rn, w0 + 16) - 1) : 0;
  const int n_first = min(Lk, a.kv_len0 + r0 + w0);    // keys the warp's first row sees
  int n_row[2];  // keys rows g and g + 8 see (a row past the tile: key 0, of its zero q)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = w0 + g + 8 * hh;
    n_row[hh] = r < rn ? min(Lk, a.kv_len0 + r0 + r) : 1;
  }
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v);
  const bool vec = Dh % (16 / sizeof(T)) == 0 && bases % 16 == 0;
  // a score is s = acc / sqrt(Dh); exp(s - max) = exp2(acc c - max_acc c)
  const float c = 1.f / a.scale * 1.44269504088896341f;
  const uint8_t* keep = kTrain ? a.keep : nullptr;
  const bool keep4 = Lk % 4 == 0 && reinterpret_cast<uintptr_t>(keep) % 4 == 0;

  const int key_tiles = (n_cta + kN - 1) / kN;
  const int chunks = kWide ? (Dh + kD - 1) / kD : 1;  // q and k chunks a key tile
  const int out_chunks = (chunks + kVS - 1) / kVS;   // output chunks, kVS v chunks each
  const int stages_a = key_tiles * chunks;            // pass A: the k (and q) chunks
  const int per_tile = chunks + kVS;                  // pass B: then the v chunks
  const int stages = stages_a + out_chunks * key_tiles * per_tile;
  const int rows_q = (rn + 15) / 16 * 16;  // q rows a warp reads (zero past the tile)
  auto issue = [&](int s) {  // stage s's copies into slot s % 2
    if (s >= stages) return;
    T* dst = slots + (s & 1) * slot;
    int j, ch, cv = -1;  // key tile, q and k chunk, or (cv >= 0) v rows of chunk cv
    if (s < stages_a) {
      j = s / chunks;
      ch = s % chunks;
    } else {
      const int u = (s - stages_a) % (key_tiles * per_tile);
      j = u / per_tile;
      ch = u % per_tile;
      if (ch >= chunks) cv = (s - stages_a) / (key_tiles * per_tile) * kVS + ch - chunks;
    }
    // the rows a warp reads: the key groups below the tile's last key (16 for bf16's key steps)
    const int j0 = j * kN, kn = min(kN, n_cta - j0), rows_k = min(kN, (kn + 15) / 16 * 16);
    if (cv >= 0) {  // past the head's last chunk: none (a warp reads no dims there)
      if (cv < chunks)
        stage_tile<kD, LS>(dst, V + (size_t)j0 * stride + cv * kD, stride, rows_k, kn,
                           Dh - cv * kD, vec, tid, threads);
    } else {
      if (kWide)
        stage_tile<kD, LS>(dst, Q + ch * kD, stride, rows_q, rn, Dh - ch * kD, vec, tid, threads);
      stage_tile<kD, LS>(dst + (kWide ? RW * LS : 0), K + (size_t)j0 * stride + ch * kD, stride,
                         rows_k, kn, Dh - ch * kD, vec, tid, threads);
      if (keep != nullptr && s >= stages_a && ch == chunks - 1)  // p reads them after this stage
        stage_keep<kN, kKeep>(reinterpret_cast<uint8_t*>(dst + rows_slot),
                              keep + ((size_t)bh * a.Lq + r0) * Lk + j0, Lk, rows_q, rn,
                              min(kN, Lk - j0), keep4, tid, threads);
    }
  };
  int s = 0;
  const T* last = nullptr;  // the slot of the last stage the scores took
  auto next = [&]() -> const T* {  // waits for stage s, starts s + 1; stage s's slot
    cp_async_wait<0>();
    __syncthreads();  // stage s landed for every thread, stage s - 1's slot is free
    issue(s + 1);
    cp_async_commit();
    return slots + (s++ & 1) * slot;
  };
  // the warp's rows' q . k against key tile j (jn keys of it seen) into sc
  auto scores = [&](float (&sc)[kN / 8][4], int jn) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const T* st = last = next();
      if constexpr (kWide) {  // the wide score tile (attention_common.cuh), a warp a part
        wide_score_chunk<kN, LS>(sc, st, st + RW * LS, jn, Dh - ch * kD, ds, lane);
      } else {
        // the products from a zero accumulator, then added to the scores in f32
        // (the tensor cores round their f32 sums toward zero, so long chains drift)
        float part[kN / 8][4];
#pragma unroll
        for (int n = 0; n < kN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
        if (jn > 0) score_tile<kN, kWD, LS>(part, sQ + w0 * LS, st, jn, Dh, lane);
#pragma unroll
        for (int n = 0; n < kN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] += part[n][e];
      }
    }
    if constexpr (kWide) {  // the warps' partial scores, summed in warp order
      wide_score_put<kN>(sc, sRed, ds, lane);
      __syncthreads();
      wide_score_sum<kN>(sc, sRed, lane);
    }
  };

  if (!kWide) stage_tile<kD, LS>(sQ, Q, stride, rows_q, rn, Dh, vec, tid, threads);
  issue(0);
  cp_async_commit();

  // pass A: each row's max (of acc: s's order) and its exp sum, rescaled as the max grows
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int j = 0; j < key_tiles; ++j) {
    const int j0 = j * kN, jn = min(kN, n_warp - j0);  // keys of the tile the warp's rows see
    float sc[kN / 8][4];
    scores(sc, jn);
    if (jn <= 0) continue;
    const bool full = j0 + kN <= n_first;  // every row of the warp sees the whole tile
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (full || j0 + 8 * n + 2 * t + (e & 1) < n_row[e >> 1])
          tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[n][e]);
    float part[2] = {0.f, 0.f}, m_new[2], mc[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // the four lanes of a row
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(kFull, tmax[hh], 1));
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(kFull, tmax[hh], 2));
      m_new[hh] = fmaxf(mx[hh], tmax[hh]);
      mc[hh] = m_new[hh] * c;
    }
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (full || j0 + 8 * n + 2 * t + (e & 1) < n_row[e >> 1])
          part[e >> 1] += exp2_ftz(fmaf(sc[n][e], c, -mc[e >> 1]));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      part[hh] += __shfl_xor_sync(kFull, part[hh], 1);
      part[hh] += __shfl_xor_sync(kFull, part[hh], 2);
      sum[hh] = sum[hh] * exp2_ftz(mx[hh] * c - mc[hh]) + part[hh];
      mx[hh] = m_new[hh];
    }
  }
  bool kept[2];  // the row is in the tile and a keep mask is given
  float mc[2], inv_sum[2];
  const float inv_keep = 1.f / a.keep_prob;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = w0 + g + 8 * hh;
    const size_t stat = (size_t)bh * a.Lq + r0 + r;  // (b, h, r)
    kept[hh] = keep != nullptr && r < rn;
    mc[hh] = mx[hh] * c;
    inv_sum[hh] = 1.f / sum[hh];
    if (kTrain && ds == 0 && t == 0 && r < rn) {  // the max of s = acc / sqrt(Dh), and the sum
      a.row_max[stat] = mx[hh] / a.scale;
      a.row_sum[stat] = sum[hh];
    }
  }

  // pass B, an output chunk at a time: p, the keep mask, the rounding, P . v
  T* O = static_cast<T*>(a.o) + (((size_t)b * a.Lq + r0) * a.H + h) * Dh;
  for (int co = 0; co < out_chunks; ++co) {
    float o[kVS][kWD / 8][4];  // the warp's dims of each v chunk of the output chunk
#pragma unroll
    for (int v = 0; v < kVS; ++v)
#pragma unroll
      for (int n = 0; n < kWD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[v][n][e] = 0.f;
    for (int j = 0; j < key_tiles; ++j) {
      const int j0 = j * kN, jn = min(kN, n_warp - j0);
      float sc[kN / 8][4];
      scores(sc, jn);
      if (jn > 0) {
        const bool full = j0 + kN <= n_first;
        // the rows' keep bytes of the tile, staged with its (last) k chunk
        const uint8_t* sk = reinterpret_cast<const uint8_t*>(last + rows_slot) + (w0 + g) * kKeep;
#pragma unroll
        for (int n = 0; n < kN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1, key = j0 + 8 * n + 2 * t + (e & 1);
            float p = 0.f;
            if (full || key < n_row[hh]) {
              p = exp2_ftz(fmaf(sc[n][e], c, -mc[hh])) * inv_sum[hh];
              if (kTrain && kept[hh])
                p = sk[8 * hh * kKeep + 8 * n + 2 * t + (e & 1)] ? p * inv_keep : 0.f;
            }
            sc[n][e] = p;  // bf16: rounded once where pv_tile packs it (p.astype(v.dtype))
          }
      }
#pragma unroll
      for (int v = 0; v < kVS; ++v) {
        const T* sv = next();
        const int rest = Dh - (co * kVS + v) * kD - ds * kWD;  // the warp's dims of v chunk
        float ot[kWD / 8][4];  // the key tile's P . v from zero, then added in f32
#pragma unroll
        for (int n = 0; n < kWD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ot[n][e] = 0.f;
        if (jn > 0) pv_tile<kN, kWD, LS>(ot, sc, sv + ds * kWD, jn, rest, lane);
#pragma unroll
        for (int n = 0; n < kWD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[v][n][e] += ot[n][e];
      }
    }
#pragma unroll
    for (int v = 0; v < kVS; ++v)
#pragma unroll
      for (int n = 0; n < kWD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w0 + g + 8 * (e >> 1);
          const int d = (co * kVS + v) * kD + ds * kWD + 8 * n + 2 * t + (e & 1);
          if (r < rn && d < Dh) O[(size_t)r * stride + d] = from_f32<T>(o[v][n][e]);
        }
  }
}

// The tile kernel's shared memory: a key tile's k rows, later its v rows
// (room for f32 values, bf16 ones use half), the row tile's score buffer and
// its rows of the keep mask.
inline size_t tile_smem_bytes(int P, int keys, int rows, int Lk) {
  return sizeof(float) * ((size_t)keys * 32 * P + (size_t)rows * score_stride(Lk)) +
         ((size_t)rows * Lk + 15) / 16 * 16;
}

template <typename T, bool kTrain, int P>
cudaError_t launch_tile(const AttentionArgs& a, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(P, a.keys, a.rows, a.Lk);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attention_tile_kernel<T, kTrain, P>;
  const cudaError_t e = opt_in(kernel, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)a.B * a.H * ((a.Lq + a.rows - 1) / a.rows);
  const int threads = (a.rows + kGroup - 1) / kGroup * 32;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kTrain>
cudaError_t launch_tile_plan(const AttentionArgs& a, cudaStream_t s) {
  switch (a.per_lane) {
    case 1: return launch_tile<T, kTrain, 1>(a, s);
    case 2: return launch_tile<T, kTrain, 2>(a, s);
    case 4: return launch_tile<T, kTrain, 4>(a, s);
    case 8: return launch_tile<T, kTrain, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The streamed kernel's shared memory for `warps` warps: up to 128 dims the
// row tile's q rows (16 a warp) and two slots of a key tile's k or v rows;
// past them the 4 warps' partial scores (f32) and two slots of the 16 rows'
// q chunk of 256 dims and the key tile's k rows, or its v rows; each row 16
// bytes longer than its values; in training, in each slot the rows' keep
// bytes of a key tile, 4 more a row (kernels/attention.py:stream_smem_bytes:
// f32's).
inline size_t stream_smem_bytes(int P, int warps, size_t elem, bool train) {
  const bool wide = P == 8;
  const int kN = stream_keys(P), LS = 32 * P + (int)(16 / elem);
  const int RW = wide ? 16 : 16 * warps;
  const size_t slot = (size_t)((wide ? RW : 0) + kN) * LS +
                      (train ? (RW * (kN + 4) + 15) / 16 * 16 / elem : 0);
  return elem * ((wide ? 0 : (size_t)RW * LS) + 2 * slot) +
         (wide ? sizeof(float) * 4 * 32 * (kN / 2) : 0);
}

template <typename T, bool kTrain, int P>
cudaError_t launch_stream(const AttentionArgs& a, cudaStream_t stream) {
  const int warps = P == 8 ? 4 : (a.rows + 15) / 16;
  if (a.keys != stream_keys(P) || (P == 8 && a.rows > 16)) return cudaErrorInvalidValue;
  const size_t smem = stream_smem_bytes(P, warps, sizeof(T), kTrain);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attention_stream_kernel<T, kTrain, P>;
  const cudaError_t e = opt_in(kernel, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)a.B * a.H * ((a.Lq + a.rows - 1) / a.rows);
  kernel<<<(unsigned)blocks, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kTrain>
cudaError_t launch_stream_plan(const AttentionArgs& a, cudaStream_t s) {
  if (a.group != kStreamGroup || a.rows < 1 || a.rows > kStreamThreads / 32 * kStreamGroup)
    return cudaErrorInvalidValue;
  if (a.Dh > 32 * a.per_lane && a.per_lane != 8) return cudaErrorInvalidValue;
  switch (a.per_lane) {  // 8: chunks of 256 dims (as many as the head takes), 4 warps a fragment
    case 1: return launch_stream<T, kTrain, 1>(a, s);
    case 2: return launch_stream<T, kTrain, 2>(a, s);
    case 4: return launch_stream<T, kTrain, 4>(a, s);
    case 8: return launch_stream<T, kTrain, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const AttentionArgs& a, int train, cudaStream_t stream) {
  if ((long long)a.B * a.H * a.Lq <= 0) return cudaSuccess;
  if (a.Lq == 1) {  // the row kernel, as it has been since it was written
    const long long rows = (long long)a.B * a.Lq * a.H;
    const int blocks = (int)((rows + kWarps - 1) / kWarps);
    const size_t smem = (size_t)kWarps * a.Lk * sizeof(float);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    auto kernel = a.Dh > kChunkDims
                      ? (train ? attention_row_wide_kernel<T, true> : attention_row_wide_kernel<T, false>)
                      : (train ? attention_kernel<T, true> : attention_kernel<T, false>);
    const cudaError_t e = opt_in(kernel, smem);  // past 3072 keys
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kWarps * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
  if (a.Dh < 1 || a.kv_len0 < 1) return cudaErrorInvalidValue;
  if (a.stream)
    return train ? launch_stream_plan<T, true>(a, stream) : launch_stream_plan<T, false>(a, stream);
  if (a.group != kGroup || a.rows < 1 || a.rows > kMaxTileRows || a.keys < 8 ||
      a.keys % 8 != 0 || a.Dh > 32 * a.per_lane)
    return cudaErrorInvalidValue;
  return train ? launch_tile_plan<T, true>(a, stream) : launch_tile_plan<T, false>(a, stream);
}

// train = 0: the serving mode; 1: the training mode (row_max and row_sum
// written, keep applied where given).  elem = 0: f32 tensors; 1: bf16.
// Lq = 1 takes the row kernel (its wide variant past 256 dims), Lq > 1 the
// tile kernel of the args' plan: the resident one, or with `stream` the
// streamed one.
extern "C" int attention_launch(const AttentionArgs* args, int train, int elem, void* stream) {
  if (elem == 0) return (int)launch<float>(*args, train, (cudaStream_t)stream);
  if (elem == 1) return (int)launch<mansy::bf16>(*args, train, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
