// K2: MANSY observation gather into one contiguous [N, F] f32 buffer, its
// simple mode, the simple_rl observation, and its derived mode, the MANSY
// row with the derived action values.
//
// Replaces the JAX package's XLA-fused sim/env.py:observe_mansy (:262-286)
// and, when the tables carry action values, exact_action_values (:220-259);
// in simple mode (`mode` 1) observe_simple (:289-300); in derived mode
// (`mode` 2, a policy that reads action values on tables without them)
// observe_mansy followed by models/abr_nets.py:causal_action_values
// (:29-92), which the policy's net computes from the observation.  The row
// mode (derive_launch) computes the same values for rows already packed.
// The plain PyTorch versions are kernels/observe.py:observe_mansy_pack_plain,
// observe_simple_pack_plain and derive_action_values_plain.
//
// Row layout (the feature net's inputs first, in its concat order, then the
// fields it does not read): throughput K | next_chunk_size R*T |
// next_chunk_quality R*T | pred_viewport T | viewport_acc K | past_vq K |
// past_var K | past_rebuf K | buffer 1 | qoe_weight 3 | [action_values A+1] |
// rates_inside K | rates_outside K | action_one_hot A.  The bracketed field
// is there only with action-value tables (av_quality not null).  Simple
// mode's row, in SimpleActorCritic's concat order: throughput K |
// chunk_sizes R*T | rebuffer 1 | last_bitrates 2 (rates_inside[0],
// rates_outside[0]) | pred_viewport T (395 floats at K 8, R 5, T 64).
//
// Bound: device-memory bytes.  A gather plus elementwise scaling: each lane
// reads ~3 KB of tables and state and writes its F floats; the action values
// add a few hundred flops.  At collect's 8192 lanes the output alone (25.5
// MB) takes about as long to write as torch's fill_ of it.
//
// Design.  A group of G threads builds a lane's row in shared memory, a
// block of `lanes` groups (kernels/observe.py:observe_plan: 4 lanes, whose
// tile of 4 F floats is a multiple of 16 bytes for any F) its lanes' rows,
// and the block stores them together.  G is 32 where the blocks fill the
// card (one warp a lane) and 128 at up to 1024 lanes, where one warp a
// lane leaves too few warps to hide its chain of loads; the group's first
// warp then takes the lane's scalars while the other three take its slab
// and viewport row.  A group takes its lane in two levels of loads, each
// issued whole before the first use of any of its values:
//   1. the lane's indices (one broadcast load a warp), and on the first
//      warp its buffer, previous quality, history entry k on thread k < K
//      (seven fields, one load each) and one-hot;
//   2. what the indices select: the chunk's size and quality slab as float4
//      (its offset (v C + c) R T is a multiple of 4 floats), the predicted
//      viewport row, and on the first warp the preference weights and, with
//      action values, thread o's entries of the five action-value tables.
// Then each lane's shared values once, on the first warp: the weights over
// their sum and, with action values, bw_hat and the accuracy estimate
// (their sums over the history run over k in order, by shuffles, as the
// plain version's loop).  One barrier, then the block's [lanes, F] tile
// goes out with 16-byte stores.  Where the rows are not contiguous
// (out_stride != F) or the tile's base is not 16-byte aligned, both checked
// here at run time, the group writes its row straight to the output.
// Every column is a copy, one IEEE division or the action-value arithmetic
// in the plain version's order; built with -fmad=false, like the other
// kernels, so the action values round as their plain version does.
// Simple mode is the same design on its own row builder (a template
// instantiation of the kernel): the first warp takes the history, the
// rebuffer time and the last rates, the others the size slab (float4) and
// the viewport row, and the block stores its tile the same way.
//
// Derived mode (a third instantiation) builds the 795-column row as the
// exact mode lays it out, leaving the 16 action-value columns to
// derive_values, which reads the finished row in shared memory after a
// barrier: causal_action_values is a function of the observation alone
// (the normalized slabs, the predicted viewport, the throughput history,
// the buffer, the previous quality, the one-hot and the weights).  Each
// warp of the lane's group derives the lane's shared values itself (the
// viewport mask by ballot and its BFS scales as K1 computes them, bw_hat,
// the viewport's sum, has_prev); the scales do not depend on the action.
// Then the group's warps split the 15 actions (one warp: all of them; four
// warps: every fourth).  A warp's actions share their reductions over the
// 64 tiles (thread t holds tiles t and t + 32): one reduce-scatter of every
// action's size and sum vp q (30 values on one warp: 31 shuffles, five
// stages deep, where a warp sum a value took 150 in 30 chains), the quals
// divided once on the lanes that hold their sums and passed round by
// shuffles, then one reduce-scatter of every sum vp |q - qual|.  Each value
// follows warp_sum's tree, so the derived values keep the bits they had
// when each value took a warp_sum of its own.  The tile's version
// is one lookup in a [A, 5] table in shared memory indexed by (action,
// scale), scale 0 being the inside rate (ops/allocation.py:
// allocate_tile_rates with the JAX function's default rates and tiling).
// Added work: ~15 x 64 x 8 flops a lane, well under the row's bytes at the
// card's rates, so the mode stays bound by bytes.  The row mode copies a
// block's contiguous tile of rows into shared memory with 16-byte cp.async
// copies (strided rows: each group its row's inputs), then runs the same
// derive_values and writes the 16 columns.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using mansy::kFull;

// Field order must match kernels/observe.py:_ObserveArgs.
struct ObserveArgs {
  const float* sizes;        // [V, C, R, T]
  const float* qualities;    // [V, C, R, T]
  const float* pred;         // [V, U, C, T]
  const float* qoe_weights;  // [Q, 3]
  const float* av_quality;   // [V, U, C, A] or null (no action values)
  const float* av_intra;
  const float* av_size;
  const float* av_out_quality;  // or null (no accuracy correction)
  const float* av_out_intra;
  const int32_t* video;      // [N]
  const int32_t* user;
  const int32_t* next_chunk;
  const int32_t* qoe_id;
  const float* buf;          // [N]
  const float* prev_quality; // [N]
  const bool* has_prev;      // [N]
  const float* past_throughput;  // [N, K]
  const float* past_acc;
  const float* past_vq;
  const float* past_var;
  const float* past_rebuf;
  const float* past_rate_in;
  const float* past_rate_out;
  const float* last_action_one_hot;  // [N, A]
  float* out;                // [N, F] (rows may be strided by out_stride)
  int32_t n_lanes, U, C, RT, T, K, A, F, startup_download;
  int32_t lanes, group;      // lanes a block, threads a lane (observe_plan)
  int64_t out_stride;
  float max_size, max_rate, max_throughput;
  const float* last_rebuffer;  // [N] (simple mode)
  int32_t mode;                // 0: MANSY, 1: simple_rl, 2: MANSY with derived values
  const int32_t* av_versions;  // [A, kMaxScale + 1] (derived mode): version of (action, scale)
};

// Field order must match kernels/observe.py:_DeriveArgs (the row mode).
struct DeriveArgs {
  float* rows;                 // [N, F] packed rows (strided by stride)
  const int32_t* av_versions;  // [A, kMaxScale + 1]
  int64_t stride;
  int32_t n_rows, K, RT, A, F, lanes, group;
};

namespace {

// What a group's first pass covers: 96 float4 of the slab (the paths' R T
// is 320 floats; more takes a second pass) and the viewport's T <= 64
// entries; A <= 32 and K <= 32 take one thread of the first warp each
// (kernels/observe.py checks the three).
constexpr int kSlabCover = 96;
constexpr int kPredCover = 64;
constexpr int kMaxLanes = 4;  // lanes a block at most (the launch bounds)
constexpr int kSimple = 1, kDerived = 2;  // ObserveArgs::mode
constexpr int kScales = mansy::kMaxScale + 1;  // columns of the version table
constexpr float kSizeOverThroughput = 0.1f;    // abr_nets.py:29-31's constants
constexpr float kBufferScale = 5.0f;
// the derived values' actions and rates (ACTION_TO_RATES, the allocation's
// defaults; kernels/observe.py and the launchers check A and R T)
constexpr int kActions = 15, kRates = 5;

// The exact one-step value of an action from its table entries (sim/env.py:
// exact_action_values, in its operation order).
__device__ __forceinline__ float action_value(const ObserveArgs& a, float quality, float intra,
                                              float size, float oq, float oi, float acc,
                                              float bw_hat, float buf, bool has_prev,
                                              float prev_quality, const float (&wn)[3]) {
  if (a.av_out_quality) {  // corrected_scores at viewport_acc_estimate
    const float q = acc * quality + (1.f - acc) * oq;
    intra = (acc * intra + (1.f - acc) * oi) + 2.f * acc * (1.f - acc) * fabsf(quality - oq);
    quality = q;
  }
  const float q_n = quality / a.max_rate, intra_n = intra / a.max_rate;
  const float dt = size / (bw_hat * a.max_throughput);
  const float d = dt - buf;
  const float rebuf = d < 0.f ? 0.f : d;  // push_chunk's rebuffer time
  const float inter = has_prev ? fabsf(q_n - prev_quality) : 0.f;
  return wn[0] * q_n - wn[1] * rebuf - wn[2] * (intra_n + inter);
}

// Lane n's row into `row` (the block's tile in shared memory, or the
// output row), by a group of G threads (a multiple of 32); g is the
// thread's index in the group.  The group's first warp takes the history,
// the one-hot, the scalars and the action values; the slab and the
// viewport row go to the group's other warps (to the first too when G is
// 32), so that its chain of scalar work and the slab's divisions overlap.
template <int G, bool kDerivedRow>
__device__ __forceinline__ void build_row(const ObserveArgs& a, int n, float* row, int g) {
  constexpr int GS = G > 32 ? G - 32 : G;            // threads on the slab and viewport
  constexpr int kSlab = (kSlabCover + GS - 1) / GS;  // float4 of the slab a thread, first pass
  constexpr int kPred = (kPredCover + GS - 1) / GS;  // viewport entries a thread, first pass
  const int K = a.K, A = a.A, T = a.T, RT = a.RT;
  // derived mode lays the action-value columns out but leaves them to derive_values
  const int n_av = kDerivedRow ? 0 : a.av_quality ? A + 1 : 0;
  const int av_cols = kDerivedRow ? A + 1 : n_av;
  const int c_size = K, c_qual = c_size + RT, c_pred = c_qual + RT, c_acc = c_pred + T;
  const int c_buf = c_acc + 4 * K, c_w = c_buf + 1, c_av = c_w + 3, c_rin = c_av + av_cols;
  const int c_hot = c_rin + 2 * K;
  const bool lead = g < 32;  // warp-uniform
  const int k = g;           // on the first warp: the thread's index in it
  const int gs = G > 32 ? g - 32 : g;  // on the slab and viewport: the thread's index there

  // 1. indices and state
  const int v = __ldg(a.video + n), u = __ldg(a.user + n), c = __ldg(a.next_chunk + n);
  int qoe_id = 0;
  float buf = 0.f, hot = 0.f, prev_quality = 0.f;
  bool has_prev = false;
  float hist[7] = {};  // throughput, acc, vq, var, rebuf, rate_in, rate_out
  if (lead) {
    qoe_id = __ldg(a.qoe_id + n);
    buf = __ldg(a.buf + n);
    if (k < K) {
      const size_t h = (size_t)n * K + k;
      hist[0] = __ldg(a.past_throughput + h);
      hist[1] = __ldg(a.past_acc + h);
      hist[2] = __ldg(a.past_vq + h);
      hist[3] = __ldg(a.past_var + h);
      hist[4] = __ldg(a.past_rebuf + h);
      hist[5] = __ldg(a.past_rate_in + h);
      hist[6] = __ldg(a.past_rate_out + h);
    }
    if (k < A) hot = __ldg(a.last_action_one_hot + (size_t)n * A + k);
    if (n_av) {
      prev_quality = __ldg(a.prev_quality + n);
      has_prev = a.has_prev[n];
    }
  }

  // 2. what the indices select
  const size_t slab = ((size_t)v * a.C + c) * RT;
  const size_t vuc = ((size_t)v * a.U + u) * a.C + c;
  const bool vec = RT % 4 == 0 && (((uintptr_t)a.sizes | (uintptr_t)a.qualities) & 15) == 0;
  const int rt4 = vec ? RT / 4 : 0;
  float4 s4[kSlab], r4[kSlab];
#pragma unroll
  for (int j = 0; j < kSlab; ++j) {
    const int i = gs + GS * j;
    if (gs >= 0 && i < rt4) {
      s4[j] = __ldg(reinterpret_cast<const float4*>(a.sizes + slab) + i);
      r4[j] = __ldg(reinterpret_cast<const float4*>(a.qualities + slab) + i);
    }
  }
  float pv[kPred];
#pragma unroll
  for (int j = 0; j < kPred; ++j) {
    const int t = gs + GS * j;
    if (gs >= 0 && t < T) pv[j] = __ldg(a.pred + vuc * T + t);
  }
  float w0 = 0.f, w1 = 0.f, w2 = 0.f;
  float av_q = 0.f, av_i = 0.f, av_s = 0.f, av_oq = 0.f, av_oi = 0.f;
  if (lead) {
    const float* w = a.qoe_weights + 3 * qoe_id;
    w0 = __ldg(w);
    w1 = __ldg(w + 1);
    w2 = __ldg(w + 2);
    if (n_av && k < A) {
      const size_t i = vuc * A + k;
      av_q = __ldg(a.av_quality + i);
      av_i = __ldg(a.av_intra + i);
      av_s = __ldg(a.av_size + i);
      if (a.av_out_quality) {
        av_oq = __ldg(a.av_out_quality + i);
        av_oi = __ldg(a.av_out_intra + i);
      }
    }
  }

  // the slab and the viewport row
#pragma unroll
  for (int j = 0; j < kSlab; ++j) {
    const int i = gs + GS * j;
    if (gs >= 0 && i < rt4) {
      float* sz = row + c_size + 4 * i;
      float* ql = row + c_qual + 4 * i;
      sz[0] = s4[j].x / a.max_size;
      sz[1] = s4[j].y / a.max_size;
      sz[2] = s4[j].z / a.max_size;
      sz[3] = s4[j].w / a.max_size;
      ql[0] = r4[j].x / a.max_rate;
      ql[1] = r4[j].y / a.max_rate;
      ql[2] = r4[j].z / a.max_rate;
      ql[3] = r4[j].w / a.max_rate;
    }
  }
#pragma unroll
  for (int j = 0; j < kPred; ++j) {
    const int t = gs + GS * j;
    if (gs >= 0 && t < T) row[c_pred + t] = pv[j];
  }
  // what the first pass leaves: slab float4 past GS kSlab (R > 6), or the
  // slab's floats when it is not read as float4
  if (gs >= 0) {
    for (int i = 4 * min(rt4, GS * kSlab) + gs; i < RT; i += GS) {
      row[c_size + i] = __ldg(a.sizes + slab + i) / a.max_size;
      row[c_qual + i] = __ldg(a.qualities + slab + i) / a.max_rate;
    }
  }
  if (!lead) return;

  // the lane's shared values, once
  const float wsum = (w0 + w1) + w2;
  const float wn[3] = {w0 / wsum, w1 / wsum, w2 / wsum};
  float bw_hat = 0.f, acc = 0.f;
  if (n_av) {  // harmonic_bw_estimate and viewport_acc_estimate
    const float tp = hist[0], pa = hist[1];
    const float nz = tp > 0.f ? 1.f : 0.f, inv = tp > 0.f ? 1.f / fmaxf(tp, 1e-12f) : 0.f;
    const float acc_nz = pa > 0.f ? 1.f : 0.f, acc_k = pa > 0.f ? pa : 0.f;
    float cnt = 0.f, inv_sum = 0.f, m = 0.f, s = 0.f;
    for (int j = 0; j < K; ++j) {
      cnt += __shfl_sync(kFull, nz, j);
      inv_sum += __shfl_sync(kFull, inv, j);
      m += __shfl_sync(kFull, acc_nz, j);
      s += __shfl_sync(kFull, acc_k, j);
    }
    bw_hat = cnt > 0.f ? cnt / fmaxf(inv_sum, 1e-12f) : 0.5f;
    const float iou = m > 0.f ? s / fmaxf(m, 1.f) : 0.8f;
    acc = 2.f * iou / (1.f + iou);
  }
  if (k < K) {
    row[k] = hist[0];
#pragma unroll
    for (int f = 1; f < 5; ++f) row[c_acc + (f - 1) * K + k] = hist[f];
    row[c_rin + k] = hist[5];
    row[c_rin + K + k] = hist[6];
  }
  if (k < A) row[c_hot + k] = hot;
  if (k == 0) {
    row[c_buf] = buf / (float)a.startup_download;
    row[c_w] = wn[0];
    row[c_w + 1] = wn[1];
    row[c_w + 2] = wn[2];
    if (n_av) row[c_av + A] = bw_hat;
  }
  if (n_av && k < A) {
    row[c_av + k] = action_value(a, av_q, av_i, av_s, av_oq, av_oi, acc, bw_hat, buf, has_prev,
                                 prev_quality, wn);
  }
}

// Lane n's simple_rl row (simple mode) into `row`, by a group of G threads
// as build_row: the first warp takes the throughput history (thread k < K),
// the rebuffer time and the last rates (thread 0), the group's other warps
// (the first too when G is 32) the size slab as float4 and the viewport row.
template <int G>
__device__ __forceinline__ void build_simple_row(const ObserveArgs& a, int n, float* row, int g) {
  constexpr int GS = G > 32 ? G - 32 : G;
  constexpr int kSlab = (kSlabCover + GS - 1) / GS;
  constexpr int kPred = (kPredCover + GS - 1) / GS;
  const int K = a.K, T = a.T, RT = a.RT;
  const int c_size = K, c_reb = c_size + RT, c_rates = c_reb + 1, c_pred = c_rates + 2;
  const bool lead = g < 32;
  const int k = g;
  const int gs = G > 32 ? g - 32 : g;

  // 1. indices and state
  const int v = __ldg(a.video + n), u = __ldg(a.user + n), c = __ldg(a.next_chunk + n);
  float tp = 0.f, reb = 0.f, rin = 0.f, rout = 0.f;
  if (lead) {
    if (k < K) tp = __ldg(a.past_throughput + (size_t)n * K + k);
    if (k == 0) {
      reb = __ldg(a.last_rebuffer + n);
      rin = __ldg(a.past_rate_in + (size_t)n * K);
      rout = __ldg(a.past_rate_out + (size_t)n * K);
    }
  }

  // 2. what the indices select
  const size_t slab = ((size_t)v * a.C + c) * RT;
  const size_t vuc = ((size_t)v * a.U + u) * a.C + c;
  const bool vec = RT % 4 == 0 && ((uintptr_t)a.sizes & 15) == 0;
  const int rt4 = vec ? RT / 4 : 0;
  float4 s4[kSlab];
#pragma unroll
  for (int j = 0; j < kSlab; ++j) {
    const int i = gs + GS * j;
    if (gs >= 0 && i < rt4) s4[j] = __ldg(reinterpret_cast<const float4*>(a.sizes + slab) + i);
  }
  float pv[kPred];
#pragma unroll
  for (int j = 0; j < kPred; ++j) {
    const int t = gs + GS * j;
    if (gs >= 0 && t < T) pv[j] = __ldg(a.pred + vuc * T + t);
  }
#pragma unroll
  for (int j = 0; j < kSlab; ++j) {
    const int i = gs + GS * j;
    if (gs >= 0 && i < rt4) {
      float* sz = row + c_size + 4 * i;
      sz[0] = s4[j].x / a.max_size;
      sz[1] = s4[j].y / a.max_size;
      sz[2] = s4[j].z / a.max_size;
      sz[3] = s4[j].w / a.max_size;
    }
  }
#pragma unroll
  for (int j = 0; j < kPred; ++j) {
    const int t = gs + GS * j;
    if (gs >= 0 && t < T) row[c_pred + t] = pv[j];
  }
  if (gs >= 0) {  // what the first pass leaves
    for (int i = 4 * min(rt4, GS * kSlab) + gs; i < RT; i += GS)
      row[c_size + i] = __ldg(a.sizes + slab + i) / a.max_size;
  }
  if (!lead) return;
  if (k < K) row[k] = tp;
  if (k == 0) {
    row[c_reb] = reb;
    row[c_rates] = rin;
    row[c_rates + 1] = rout;
  }
}

// The sums over a warp of N values a lane (N a power of two, at most 32),
// each in mansy::warp_sum's tree: a recursive-halving reduce-scatter over its
// xor offsets 16, 8, 4, 2, 1.  While a lane holds more than one value, offset
// o halves them: the lane keeps the upper half if its bit o is set, else the
// lower, and adds to each kept value its partner's (lane ^ o) matching one,
// which is the pair warp_sum adds at o (IEEE addition commutes bit for bit);
// once it holds one, the remaining offsets add as warp_sum does.  Value i
// ends in the lanes t with t >> (5 - log2 N) == i, which return it with
// warp_sum's bits.  v is overwritten.
template <int N, int L = N, int O = 16>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  static_assert(N <= 32 && (N & (N - 1)) == 0, "N: a power of two up to 32");
  if constexpr (O == 0) {
    return v[0];
  } else if constexpr (L > 1) {
    constexpr int H = L / 2;
    const bool upper = lane & O;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float keep = upper ? v[H + k] : v[k];
      const float send = upper ? v[k] : v[H + k];
      v[k] = keep + __shfl_xor_sync(kFull, send, O);
    }
    return reduce_scatter<N, H, O / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
    return reduce_scatter<N, 1, O / 2>(v, lane);
  }
}

__host__ __device__ constexpr int log2_floor(int x) { return x > 1 ? 1 + log2_floor(x / 2) : 0; }
__host__ __device__ constexpr int pow2_ceil(int x) { return x > 1 ? 2 * pow2_ceil((x + 1) / 2) : 1; }

// The derived action values of one lane (models/abr_nets.py:
// causal_action_values) from its finished row, by the G threads of its
// group (g: the thread's index there): out[a] for each action a < kActions,
// then out[kActions] = bw_hat.  `row` is the lane's row in the exact mode's
// layout (kernels/observe.py:obs_layout(.., av=True)) at R = 5, T = 64 and
// A = 15; only its input columns are read.  `versions` is the [kActions,
// kScales] version table in shared memory.  Every warp takes the lane's
// shared values, then the warp's actions (every (G / 32)-th from its own
// index; kPer of them, in kSlots slots); thread t holds tiles t and t + 32.
// Each action's tile sums, the size and sum vp q, go through one
// reduce_scatter of all the warp's actions (value 2k the k-th action's size,
// 2k + 1 its sum vp q); the lanes of value 2k + 1 divide it into qual, every
// thread takes each qual by a shuffle and forms its sum vp |q - qual|
// partials, and a second reduce_scatter sums them (value k).  The lane
// (2k + 1) << kShift then holds the k-th action's qual and its sum of
// deviations, takes its size from its partner and writes the value.  The
// operations are those of one warp_sum a value, and each sum is warp_sum's
// tree, so the values keep the bits one warp_sum a value gave; the plain
// version's sums over tiles associate otherwise.
template <int G>
__device__ __forceinline__ void derive_values(const float* row, float* out,
                                              const int32_t* versions, int K, int g) {
  constexpr int W = G / 32;                        // warps a lane
  constexpr int kPer = (kActions + W - 1) / W;     // actions a warp: 15 or 4
  constexpr int kSlots = pow2_ceil(kPer);          // 16 or 4
  constexpr int kShift = 4 - log2_floor(kSlots);   // a first-pass value on 1 << kShift lanes
  using mansy::kTiles;
  constexpr int RT = kRates * kTiles;
  const int w = g / 32, j = g % 32;
  const int c_qual = K + RT, c_pred = K + 2 * RT;
  const int c_vq = c_pred + kTiles + K, c_buf = c_pred + kTiles + 4 * K, c_w = c_buf + 1;
  const int c_hot = c_w + 3 + (kActions + 1) + 2 * K;

  // bw_hat: the harmonic mean of the non-zero throughput history, 0.5 while empty
  const float tp = j < K ? row[j] : 0.f;
  const float nz = tp > 0.f ? 1.f : 0.f, inv = tp > 0.f ? 1.f / fmaxf(tp, 1e-12f) : 0.f;
  float cnt = 0.f, inv_sum = 0.f;
  for (int k = 0; k < K; ++k) {
    cnt += __shfl_sync(kFull, nz, k);
    inv_sum += __shfl_sync(kFull, inv, k);
  }
  const float bw_hat = cnt > 0.f ? cnt / fmaxf(inv_sum, 1e-12f) : 0.5f;
  // the predicted viewport: its tiles' weights, mask, scales and sum
  const float vp0 = row[c_pred + j], vp1 = row[c_pred + j + 32];
  int s0, s1;
  mansy::viewport_scales(mansy::viewport_mask(row + c_pred, j), j, s0, s1);
  const float vp_sum = fmaxf(mansy::warp_sum(vp0 + vp1), 1e-6f);
  const bool has_prev = mansy::warp_sum(j < kActions ? row[c_hot + j] : 0.f) > 0.f;
  const float buf = row[c_buf] * kBufferScale;  // the row's buf / startup_download, then x 5
  const float prev_q = row[c_vq];
  const float w0 = row[c_w], w1 = row[c_w + 1], w2 = row[c_w + 2];
  const float bw = fmaxf(bw_hat, 1e-6f);

  // 1. each action's size and sum vp q
  float q0[kSlots], q1[kSlots], part[2 * kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int act = w + k * W;
    q0[k] = q1[k] = part[2 * k] = part[2 * k + 1] = 0.f;
    if (act < kActions) {  // warp-uniform
      const int v0 = versions[act * kScales + s0], v1 = versions[act * kScales + s1];
      q0[k] = row[c_qual + v0 * kTiles + j];
      q1[k] = row[c_qual + v1 * kTiles + j + 32];
      part[2 * k] = row[K + v0 * kTiles + j] + row[K + v1 * kTiles + j + 32];
      part[2 * k + 1] = vp0 * q0[k] + vp1 * q1[k];
    }
  }
  const float sum1 = reduce_scatter(part, j);  // value j >> kShift
  const float qual = sum1 / vp_sum;            // on value 2k + 1's lanes: action k's
  // 2. each action's sum vp |q - qual|
  float dev[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    dev[k] = 0.f;
    if (w + k * W < kActions) {  // warp-uniform
      const float qk = __shfl_sync(kFull, qual, (2 * k + 1) << kShift);
      dev[k] = vp0 * fabsf(q0[k] - qk) + vp1 * fabsf(q1[k] - qk);
    }
  }
  const float sum2 = reduce_scatter(dev, j);                      // value j >> (kShift + 1)
  const float size = __shfl_xor_sync(kFull, sum1, 1 << kShift);  // value 2k's: action k's
  const int act = w + (j >> (kShift + 1)) * W;
  if ((j & ((2 << kShift) - 1)) == (1 << kShift) && act < kActions) {
    const float intra = sum2 / vp_sum;
    const float dt = kSizeOverThroughput * size / bw;
    const float rebuf = mansy::max0(dt - buf);
    const float inter = has_prev ? fabsf(qual - prev_q) : 0.f;
    out[act] = w0 * qual - w1 * rebuf - w2 * (intra + inter);
  }
  if (g == 0) out[kActions] = bw_hat;
}

// The version table into shared memory, by the block's threads (a barrier
// follows before any read).
__device__ __forceinline__ void stage_versions(int32_t* dst, const int32_t* src) {
  for (int i = threadIdx.x; i < kActions * kScales; i += blockDim.x) dst[i] = __ldg(src + i);
}

}  // namespace

template <int G, int kMode>
__global__ void __launch_bounds__(kMaxLanes * G) observe_kernel(const ObserveArgs a) {
  extern __shared__ __align__(16) float tile[];  // [lanes, F]
  const int n0 = blockIdx.x * a.lanes;
  const int nl = min(a.lanes, a.n_lanes - n0);
  const int l = threadIdx.x / G, g = threadIdx.x % G;
  const int F = a.F;
  float* dst = a.out + (size_t)n0 * a.out_stride;
  const auto build = [&](float* row) {
    if constexpr (kMode == kSimple)
      build_simple_row<G>(a, n0 + l, row, g);
    else
      build_row<G, kMode == kDerived>(a, n0 + l, row, g);
  };
  const bool direct = a.out_stride != F || ((uintptr_t)dst & 15) != 0;
  if constexpr (kMode == kDerived) {  // the row in shared memory, then its values
    __shared__ int32_t versions[kActions * kScales];
    stage_versions(versions, a.av_versions);
    if (l < nl) build(tile + l * F);
    __syncthreads();
    if (l < nl) {
      const int c_av = a.K + 2 * a.RT + a.T + 4 * a.K + 4;
      derive_values<G>(tile + l * F, tile + l * F + c_av, versions, a.K, g);
    }
    if (direct) {  // rows strided or unaligned: each float to its place
      __syncthreads();
      for (int i = threadIdx.x; i < nl * F; i += blockDim.x)
        dst[(size_t)(i / F) * a.out_stride + i % F] = tile[i];
      return;
    }
  } else {
    if (direct) {  // row by row, straight out
      if (l < nl) build(dst + (size_t)l * a.out_stride);
      return;
    }
    if (l < nl) build(tile + l * F);
  }
  __syncthreads();
  const int count = nl * F, n4 = count / 4;
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = t4[i];
  for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x) dst[i] = tile[i];
}

// The row mode: the derived action values of packed rows [N, F] (the
// exact mode's layout), written into their 16 columns.  A group of G
// threads a row, `lanes` rows a block.  Where the rows are contiguous
// (stride == F) and the block's tile of them 16-byte aligned (a tile of 4
// rows is 4 F floats, a multiple of 16 bytes), the block copies its whole
// tile into shared memory with 16-byte cp.async copies, every one issued
// before the first wait; else each group copies its row's input columns
// (all before the action values, and the one-hot) a float at a time.  Then
// derive_values reads the rows there and writes each value to the row in
// device memory.
template <int G>
__global__ void __launch_bounds__(kMaxLanes * G) derive_kernel(const DeriveArgs a) {
  extern __shared__ __align__(16) float rows[];  // [lanes, F]
  __shared__ int32_t versions[kActions * kScales];
  const int n0 = blockIdx.x * a.lanes, nl = min(a.lanes, a.n_rows - n0);
  const int l = threadIdx.x / G, g = threadIdx.x % G;
  const int K = a.K, F = a.F;
  const int c_av = K + 2 * a.RT + mansy::kTiles + 4 * K + 4, c_hot = c_av + kActions + 1 + 2 * K;
  const float* src = a.rows + (size_t)n0 * a.stride;
  stage_versions(versions, a.av_versions);
  if (a.stride == F && ((uintptr_t)src & 15) == 0) {  // the block's tile, contiguous
    const int count = nl * F, n4 = count / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      mansy::tc::cp_async16(rows + 4 * i, src + 4 * i, true);
    mansy::tc::cp_async_commit();
    for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x) rows[i] = __ldg(src + i);
    mansy::tc::cp_async_wait<0>();
  } else if (l < nl) {  // strided or unaligned rows: each group its row's inputs
    const float* r = src + (size_t)l * a.stride;
    float* row = rows + l * F;
    for (int i = g; i < c_av; i += G) row[i] = __ldg(r + i);
    if (g < kActions) row[c_hot + g] = __ldg(r + c_hot + g);
  }
  __syncthreads();
  if (l < nl) derive_values<G>(rows + l * F, a.rows + (size_t)(n0 + l) * a.stride + c_av, versions,
                               K, g);
}

template <int G, int kMode>
int launch(const ObserveArgs& args, cudaStream_t stream) {
  const int lanes = args.lanes;
  if (lanes < 1 || lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  if (kMode == kDerived && (args.A != kActions || args.RT != kRates * mansy::kTiles ||
                            args.T != mansy::kTiles))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)lanes * args.F * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        observe_kernel<G, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (args.n_lanes + lanes - 1) / lanes;
  if (blocks > 0) observe_kernel<G, kMode><<<blocks, lanes * G, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int G>
int launch_derive(const DeriveArgs& args, cudaStream_t stream) {
  const int lanes = args.lanes;
  if (lanes < 1 || lanes > kMaxLanes || args.A != kActions ||
      args.RT != kRates * mansy::kTiles)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)lanes * args.F * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        derive_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (args.n_rows + lanes - 1) / lanes;
  if (blocks > 0) derive_kernel<G><<<blocks, lanes * G, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

extern "C" int observe_launch(const ObserveArgs* args, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (args->group * 4 + args->mode) {  // observe_plan's two groups, the three modes
    case 32 * 4: return launch<32, 0>(*args, s);
    case 32 * 4 + kSimple: return launch<32, kSimple>(*args, s);
    case 32 * 4 + kDerived: return launch<32, kDerived>(*args, s);
    case 128 * 4: return launch<128, 0>(*args, s);
    case 128 * 4 + kSimple: return launch<128, kSimple>(*args, s);
    case 128 * 4 + kDerived: return launch<128, kDerived>(*args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int derive_launch(const DeriveArgs* args, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (args->group) {  // observe_plan's two groups
    case 32: return launch_derive<32>(*args, s);
    case 128: return launch_derive<128>(*args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
