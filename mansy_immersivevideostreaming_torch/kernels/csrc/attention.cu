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
// recomputes each p bit for bit from them), and an optional keep mask u8
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
//     keys; --his-window up to JAX's 5000 and beyond), the streamed kernel
//     keeps the tile kernel's CTA, warp and lane layout but no row's
//     scores: it walks the key tiles once a pass and recomputes each tile's
//     scores by the same chains and reduction into a tile-sized buffer:
//     pass 0 the rows' max, pass 1 exp(s - max) and each row's sum serially
//     in key order, pass 2 p, the keep mask (read from device memory), the
//     rounding and P . v, keys in order.  Shared memory holds a key tile's
//     k and v rows and the tile's scores, whatever Lk.
//
//   heads past 256 dims (attention_row_wide_kernel for one query row, the
//     streamed kernel's kWide instances for more; --hidden-dim past 2048):
//     the head runs in chunks of 256 dims, 8 a lane (attention_common.cuh:
//     kChunkDims, chain_on).  A score's per-lane partial is carried from
//     chunk to chunk and only then reduced, so it is lane l's fmaf chain
//     over dims l, l + 32, ... of the whole head and then the butterfly, as
//     at up to 256 dims; k is staged (the streamed kernel: key tiles of 8
//     keys) and q read a chunk at a time; P . v takes one output chunk a
//     pass (2 + chunks passes).
//
// Bits: the tile kernel does each score, max, sum, p and output element
// with the operations of the row kernel in the same order (the same
// per-lane chains and butterfly, the same serial sum, the same IEEE
// divisions, P . v an fmaf chain over the keys in order), so its outputs
// (o; in training row_max and row_sum) are the row kernel's bits, in f32
// and in bf16, and the backward's recomputed P stays the forward's.  The
// streamed kernel does the same operations in the same order, so its
// outputs are the tile kernel's bits (tests/test_torch_cuda.py forces it
// where the tile kernel runs); the wide kernels and the wide backward share
// one definition of a score, so the backward's P is theirs.

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
using mansy::attn::kChunkDims;
using mansy::attn::load_chunk;
using mansy::attn::opt_in;
using mansy::attn::reduce_scatter_placed;
using mansy::attn::stage_bytes;
using mansy::attn::stage_rows_as_is;
using mansy::tc::cp_async_commit;
using mansy::tc::cp_async_wait;

constexpr int kWarps = 4;        // row kernel: warps (query rows) a block
constexpr int kMaxPerLane = 8;   // Dh <= 256 (wider heads: the wide variants' chunks)
constexpr int kGroup = 4;        // tile kernel: rows a warp takes at once (R)
constexpr int kGroupKeys = 32 / kGroup;  // keys of a reduction, for each of them
constexpr int kMaxTileRows = 32;  // tile kernel: rows a row tile (8 warps)
constexpr int kMaxTileThreads = kMaxTileRows / kGroup * 32;
constexpr int kMaxSmem = 232448;  // the H100's shared memory a block (227 KB)

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

// ---- Lq > 1, streamed: the tile kernel without a resident score row ----
// The CTA, warp and lane layout of the tile kernel, but no row's scores are
// kept: the CTA walks its key tiles once a pass and recomputes the tile's
// scores each time, by the tile kernel's per-lane chains and
// reduce_scatter_placed, into a buffer of the tile's keys.  Pass 0 takes
// each row's max; pass 1 exp(s - max) and each row's sum serially in key
// order (lane g, row g); pass 2 + c p = e / sum, the keep mask (read from
// device memory), the rounding to T and P . v over output chunk c, keys in
// order.  So every score, max, sum, p and output element is the tile
// kernel's (and the row kernel's), with shared memory that does not grow
// with Lk.  kWide (Dh > 256, P = 8, key tiles of KB keys): a score's
// partials are carried over the head's chunks of 256 dims (k staged a chunk
// at a time, q read from device memory a chunk at a time) before the
// reduction, and P . v takes one chunk of the output a pass.
template <typename T, bool kTrain, int P, bool kWide>
__global__ void __launch_bounds__(kMaxTileThreads, 65536 / kMaxTileThreads / (P <= 2 ? 64 : 128))
attention_stream_kernel(const AttentionArgs a) {
  constexpr int kD = 32 * P;  // a staged chunk's values (zeros past Dh)
  constexpr int R = kGroup, KB = kGroupKeys;
  extern __shared__ __align__(16) float smem[];
  const int M = a.keys, RT = a.rows;
  T* sK = reinterpret_cast<T*>(smem);           // [M][kD]: a key tile's k rows (a chunk)
  T* sV = reinterpret_cast<T*>(smem + M * kD);  // [M][kD]: its v rows (the output chunk's)
  float* sS = smem + 2 * M * kD;                // [RT][M]: the tile's scores, then e or p
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid % 32;
  const int Dh = a.Dh, Lk = a.Lk;
  const int chunks = kWide ? (Dh + kD - 1) / kD : 1;
  const int tiles = (a.Lq + RT - 1) / RT;
  const int bh = (int)blockIdx.x / tiles;  // b H + h
  const int r0 = ((int)blockIdx.x - bh * tiles) * RT, rn = min(RT, a.Lq - r0);
  const int b = bh / a.H, h = bh - b * a.H;
  const size_t stride = (size_t)a.H * Dh;
  const size_t q0 = (((size_t)b * a.Lq + r0) * a.H + h) * Dh;
  const size_t k0 = ((size_t)b * Lk * a.H + h) * Dh;
  const int n_cta = min(Lk, a.kv_len0 + r0 + rn - 1);
  const int g0 = (tid / 32) * R;
  const int gn = max(0, min(R, rn - g0));
  const int n_warp = gn > 0 ? min(Lk, a.kv_len0 + r0 + g0 + gn - 1) : 0;
  const int mine = lane / KB;  // a reduction leaves lane l row l / KB's score of key l % KB
  const int n_mine = mine < gn ? min(Lk, a.kv_len0 + r0 + g0 + mine) : 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v);
  const bool vec = Dh % (16 / sizeof(T)) == 0 && bases % 16 == 0;
  const T* K = static_cast<const T*>(a.k) + k0;
  const T* V = static_cast<const T*>(a.v) + k0;
  const T* Q = static_cast<const T*>(a.q) + q0;
  const uint8_t* keep = kTrain ? a.keep : nullptr;

  int n[R];       // keys each of the warp's rows sees (0 past the tile)
  float q[R][P];  // not kWide: the rows' q, placed (q[g] is row g ^ mine's)
#pragma unroll
  for (int g = 0; g < R; ++g) {
    n[g] = g < gn ? min(Lk, a.kv_len0 + r0 + g0 + g) : 0;
    const int row = g ^ mine;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int d = lane + 32 * i;
      q[g][i] = !kWide && row < gn && d < Dh ? to_f32(Q[(size_t)(g0 + row) * stride + d]) : 0.f;
    }
  }

  float mx = -INFINITY;      // pass 0, lane l: row l / KB's max over the keys it took
  float my_max = 0.f, sum = 0.f;  // lane g: row g's max and exp sum
  float rmax[R], total[R];
#pragma unroll
  for (int g = 0; g < R; ++g) rmax[g] = total[g] = 0.f;
  for (int pass = 0; pass < 2 + chunks; ++pass) {
    const int co = pass - 2;  // the output chunk of a P . v pass
    if (pass == 1) {
#pragma unroll
      for (int o = KB / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      my_max = __shfl_sync(kFull, mx, min(lane, R - 1) * KB);
#pragma unroll
      for (int g = 0; g < R; ++g) rmax[g] = __shfl_sync(kFull, mx, g * KB);
    } else if (pass == 2) {
#pragma unroll
      for (int g = 0; g < R; ++g) total[g] = __shfl_sync(kFull, sum, g);
      if (kTrain && lane < gn) {
        const size_t stat = (size_t)bh * a.Lq + r0 + g0 + lane;  // (b, h, r)
        a.row_max[stat] = my_max;
        a.row_sum[stat] = sum;
      }
    }
    float acc[R][P];
#pragma unroll
    for (int g = 0; g < R; ++g)
#pragma unroll
      for (int i = 0; i < P; ++i) acc[g][i] = 0.f;
    for (int j0 = 0; j0 < n_cta; j0 += M) {
      const int kn = min(M, n_cta - j0);
      const int jn = min(kn, n_warp - j0);  // keys of this tile the warp's rows see
      // the tile's scores into sS: KB keys of the warp's R rows a reduction
      if constexpr (!kWide) {
        __syncthreads();  // every warp is done with the last tile
        stage_rows_as_is<kD>(sK, K + (size_t)j0 * stride, stride,
                             min(M, (kn + KB - 1) / KB * KB), kn, Dh, vec, tid, threads);
        if (pass >= 2) stage_rows_as_is<kD>(sV, V + (size_t)j0 * stride, stride, kn, kn, Dh, vec,
                                            tid, threads);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
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
          const int j = jb + lane % KB;
          if (j0 + j < n_mine) {
            sS[(g0 + mine) * M + j] = sc;
            if (pass == 0) mx = fmaxf(mx, sc);
          }
        }
      } else {  // M = KB: one reduction, its partials carried over the chunks
        float x[R * KB];
#pragma unroll
        for (int e = 0; e < R * KB; ++e) x[e] = 0.f;
        for (int c = 0; c < chunks; ++c) {
          const int rest = Dh - c * kD;  // dims from the chunk's first
          __syncthreads();  // every warp is done with the last chunk
          stage_rows_as_is<kD>(sK, K + (size_t)j0 * stride + c * kD, stride, KB, kn, rest, vec,
                               tid, threads);
          if (pass >= 2 && c == 0)
            stage_rows_as_is<kD>(sV, V + (size_t)j0 * stride + co * kD, stride, kn, kn,
                                 Dh - co * kD, vec, tid, threads);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          if (jn > 0) {
            float qc[R][P];
#pragma unroll
            for (int g = 0; g < R; ++g) {
              const int row = g ^ mine;
#pragma unroll
              for (int i = 0; i < P; ++i) {
                const int d = lane + 32 * i;
                qc[g][i] = row < gn && d < rest
                               ? to_f32(Q[(size_t)(g0 + row) * stride + c * kD + d]) : 0.f;
              }
            }
#pragma unroll
            for (int s = 0; s < KB; ++s) {
              float kr[P];
              const T* krow = sK + (s ^ (lane % KB)) * kD;
#pragma unroll
              for (int i = 0; i < P; ++i) kr[i] = to_f32(krow[lane + 32 * i]);
#pragma unroll
              for (int g = 0; g < R; ++g)
                x[g * KB + s] = chain_on<P>(x[g * KB + s], qc[g], kr, lane, rest);
            }
          }
        }
        if (jn > 0) {
          const float sc = reduce_scatter_placed<R * KB>(x) / a.scale;
          const int j = lane % KB;
          if (j0 + j < n_mine) {
            sS[(g0 + mine) * M + j] = sc;
            if (pass == 0) mx = fmaxf(mx, sc);
          }
        }
      }
      __syncwarp();  // every lane's scores written
      if (pass == 1) {  // exp(s - max), then each row's sum over the tile's keys in order
        for (int j = lane; j < jn; j += 32) {
#pragma unroll
          for (int g = 0; g < R; ++g)
            if (j0 + j < n[g]) sS[(g0 + g) * M + j] = expf(sS[(g0 + g) * M + j] - rmax[g]);
        }
        __syncwarp();
        if (lane < gn) {
          const float* srow = sS + (g0 + lane) * M;
          const int nl = min(jn, min(Lk, a.kv_len0 + r0 + g0 + lane) - j0);
          for (int j = 0; j < nl; ++j) sum += srow[j];
        }
      } else if (pass >= 2) {  // p, the keep mask, the rounding; then P . v over the tile
        for (int j = lane; j < jn; j += 32) {
#pragma unroll
          for (int g = 0; g < R; ++g) {
            if (j0 + j < n[g]) {
              float p = expf(sS[(g0 + g) * M + j] - rmax[g]) / total[g];
              if (keep != nullptr)
                p = keep[((size_t)bh * a.Lq + r0 + g0 + g) * Lk + j0 + j] ? p / a.keep_prob
                                                                            : 0.f;
              sS[(g0 + g) * M + j] = round_as<T>(p);  // bf16: p.astype(v.dtype)
            }
          }
        }
        __syncwarp();
        const int j_all = min(jn, n[0] - j0);  // keys of the tile all the warp's rows see
        for (int j = 0; j < jn; j += 4) {
          float p[R][4];
#pragma unroll
          for (int g = 0; g < R; ++g) {
            float4 p4 = make_float4(0.f, 0.f, 0.f, 0.f);
            if (g < gn) p4 = *reinterpret_cast<const float4*>(sS + (g0 + g) * M + j);
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
    }
    if (pass >= 2) {
#pragma unroll
      for (int g = 0; g < R; ++g) {
        T* orow = static_cast<T*>(a.o) + q0 + (size_t)(g0 + g) * stride;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int d = co * kD + lane + 32 * i;
          if (g < gn && d < Dh) orow[d] = from_f32<T>(acc[g][i]);
        }
      }
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

// The streamed kernel's shared memory: a key tile's k rows and its v rows
// (room for f32 values) and the tile's scores of the row tile's rows.
inline size_t stream_smem_bytes(int P, int keys, int rows) {
  return sizeof(float) * (2 * (size_t)keys * 32 * P + (size_t)rows * keys);
}

template <typename T, bool kTrain, int P, bool kWide>
cudaError_t launch_stream(const AttentionArgs& a, cudaStream_t stream) {
  const size_t smem = stream_smem_bytes(P, a.keys, a.rows);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attention_stream_kernel<T, kTrain, P, kWide>;
  const cudaError_t e = opt_in(kernel, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)a.B * a.H * ((a.Lq + a.rows - 1) / a.rows);
  const int threads = (a.rows + kGroup - 1) / kGroup * 32;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kTrain>
cudaError_t launch_stream_plan(const AttentionArgs& a, cudaStream_t s) {
  if (a.Dh > kChunkDims)  // chunks of 256 dims, key tiles of one reduction
    return a.per_lane == 8 && a.keys == kGroupKeys ? launch_stream<T, kTrain, 8, true>(a, s)
                                                   : cudaErrorInvalidValue;
  if (a.Dh > 32 * a.per_lane) return cudaErrorInvalidValue;
  switch (a.per_lane) {
    case 1: return launch_stream<T, kTrain, 1, false>(a, s);
    case 2: return launch_stream<T, kTrain, 2, false>(a, s);
    case 4: return launch_stream<T, kTrain, 4, false>(a, s);
    case 8: return launch_stream<T, kTrain, 8, false>(a, s);
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
  if (a.group != kGroup || a.rows < 1 || a.rows > kMaxTileRows || a.keys < 8 ||
      a.keys % 8 != 0 || a.Dh < 1 || a.kv_len0 < 1)
    return cudaErrorInvalidValue;
  if (a.stream)
    return train ? launch_stream_plan<T, true>(a, stream) : launch_stream_plan<T, false>(a, stream);
  if (a.Dh > 32 * a.per_lane) return cudaErrorInvalidValue;
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
