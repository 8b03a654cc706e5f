// K1: fused ABR environment step, one launch per step for all N lanes.
//
// Replaces the JAX package's XLA-fused sim/env.py:step_env with its callees:
// ops/allocation.py:viewport_scales + allocate_tile_rates, the one-hot
// size/quality select, sim/simulator.py:simulate_download_prefix +
// push_chunk, ops/qoe.py:qoe_step, the _roll history updates and the
// auto-reset (sim/env.py:reset_env).  The plain PyTorch version is
// kernels/env_step.py:env_step_plain.
//
// Bound: device-memory bytes.  A lane reads its state (~0.4 KB), two 64-tile
// viewport rows, one selected version of its chunk's size and quality slabs
// (it never reads the other four versions) and its trace's prefix row, and
// writes its state back; the arithmetic is a few hundred flops a lane, but
// run as scalar code its instructions, not its bytes, set the time.
//
// Design.  On the H100 the step is not bound by its bytes or its chain of
// loads but by the instructions it issues: the scalar download and QoE math
// of a lane (IEEE divisions, integer floor_mod, the dilation rings) runs on
// every thread that takes the lane.  So a group of G = 8 threads takes a
// lane, each thread 8 of its 64 tiles (j, j + 8, ... with j its index in
// the group), and a warp runs four lanes' scalar math in one instruction
// stream; G = 32 (two tiles a thread) only where a lane has more than 8
// history entries, one a thread (kernels/env_step.py:env_step_plan).  A
// block has 128 threads.  Three levels of loads:
//   1. the lane's scalar state (with G = 8 a warp's four lanes share each
//      field's sector), its history entry j < K, and the codec tables
//      (action -> rates, the scale -> version table, the bitrates) into
//      shared memory;
//   2. everything that depends only on the lane's state, issued together:
//      the predicted and true viewport rows, end_chunk, the QoE weights, the
//      trace length, the trace's bandwidth and prefix rows (held in
//      registers, 64 / G entries a thread, when L + 1 <= 64), the accuracy
//      entry of the next chunk and the reset sample's row;
//   3. the selected version's size and quality of the thread's tiles (they
//      depend on the predicted mask), the trace's total (its length came in
//      level 2) and the reset sample's accuracy entry.
// The predicted viewport becomes a 64-bit occupancy mask with one ballot a
// tile slot, so the 3x3 torus dilation rings are shifts and masks on one
// register.  Tile sums run in one fixed order for every G (tile_sum).  The
// prefix count #{prefix <= rem} and the prefix and bandwidth entries at the
// download's last second come from the registers by shuffles; a trace
// longer than 63 seconds takes them from device memory (a group-strided
// count), so any length stays exact.  Thread k < K of the group rolls history entry k with
// one shuffle; thread 0 writes the lane's scalar state.
//
// The state is updated IN PLACE: a block reads its lanes' state before it
// overwrites it, and no other block touches those lanes.
//
// Built with -fmad=false: every product and quotient rounds exactly as in
// the plain version, because the download's floor/compare steps move the
// cursor a whole second on a 1-ulp difference.  Every scalar step keeps the
// plain version's order; the 64-tile sums differ from torch.sum's by a few
// ulp at most.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace mansy;

namespace {

constexpr int kThreads = 128;      // threads a block
constexpr int kMaxActions = 32;    // the wrapper's limits
constexpr int kMaxRates = 16;
constexpr int kRowRegs = 64;       // prefix rows up to this length live in registers

// The sum of a lane's 64 tile values x[k] (tile j + G k on the group's
// thread j), in the order of a butterfly over 32 threads that each first
// add tiles t and t + 32: each thread holds 32 / G of those virtual
// threads, whose first butterfly steps it takes in registers, then the
// group's shuffles take the rest.  So every group size gives the same bits.
template <int G, int kT>
__device__ __forceinline__ float tile_sum(const float (&x)[kT]) {
  constexpr int V = kT / 2;  // virtual threads a thread
  float v[V];
#pragma unroll
  for (int m = 0; m < V; ++m) v[m] = x[m] + x[m + V];
#pragma unroll
  for (int o = V / 2; o > 0; o >>= 1) {
    float w[V];
#pragma unroll
    for (int m = 0; m < V; ++m) w[m] = v[m] + v[m ^ o];
#pragma unroll
    for (int m = 0; m < V; ++m) v[m] = w[m];
  }
  float sum = v[0];
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  return sum;
}

// c ? x : y as one selp: the compiler would turn a chain of selects over an
// array's constant indices into one indexed load, which puts the array in
// local memory.
__device__ __forceinline__ float select(bool c, float x, float y) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.s32 p, %3, 0;\n selp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(x), "f"(y), "r"((int)c));
  return r;
}

// Entry i < 64 of a row held kT = 64 / G entries a thread (x[k] = row[j + k G]
// on the group's thread j); i is the same on every thread of the group.
template <int G, int kT>
__device__ __forceinline__ float row_at(const float (&x)[kT], int i) {
  float v = x[0];
#pragma unroll
  for (int k = 1; k < kT; ++k) v = select(i / G == k, x[k], v);
  return __shfl_sync(kFull, v, i & (G - 1), G);
}

}  // namespace

// Field order must match kernels/env_step.py:_EnvStepArgs.
struct EnvStepArgs {
  // tables
  const float* sizes;        // [V, C, R, 64]
  const float* qualities;    // [V, C, R, 64]
  const float* gt;           // [V, U, C, 64]
  const float* pred;         // [V, U, C, 64]
  const float* vp_acc;       // [V, U, C]
  const int32_t* end_chunk;  // [V, U]
  const float* bw;           // [NT, L]
  const int32_t* bw_len;     // [NT]
  const float* bw_prefix;    // [NT, L + 1]
  const float* qoe_weights;  // [Q, 3]
  const int32_t* video_rates;   // [R]
  const int32_t* scale_table;   // [R, kMaxScale + 1]
  const int32_t* action_rates;  // [A, 2] action -> (rate_in, rate_out)
  const int32_t* samples;       // [S, 4]
  const int32_t* action;        // [N]
  // lane state, read and overwritten in place
  int32_t* video;
  int32_t* user;
  int32_t* trace;
  int32_t* qoe_id;
  int32_t* next_sample;
  int32_t* next_chunk;
  float* buf;
  int32_t* net_idx;
  int32_t* net_sec;
  float* net_frac;
  float* prev_quality;
  bool* has_prev;
  float* past_throughput;  // [N, K]
  float* past_acc;
  float* past_rate_in;
  float* past_rate_out;
  float* past_vq;
  float* past_var;
  float* past_rebuf;
  float* last_rebuffer;
  float* last_acc;
  float* last_action_one_hot;  // [N, A]
  float* ep_qoe;
  float* ep_qoe1;
  float* ep_qoe2;
  float* ep_qoe3;
  int32_t* ep_steps;
  // outputs [N]
  float* reward;
  bool* done;
  int32_t* log_video;
  int32_t* log_user;
  int32_t* log_trace;
  int32_t* log_qoe_id;
  float* log_qoe;
  float* log_qoe1;
  float* log_qoe2;
  float* log_qoe3;
  float* log_ret;
  int32_t* log_steps;
  // shapes and constants
  int32_t n_lanes, U, C, R, L, S, A, K;
  int32_t stride, train, startup_download;
  int32_t group;  // threads a lane: 8 (K <= 8) or 32 (kernels/env_step.py:env_step_plan)
  float chunk_length, init_buffer, max_rate, max_throughput;
};

// G threads take a lane, each its tiles j, j + G, ... (j its index in the
// group); a block takes kThreads / G lanes.  Needs K <= G.
template <int G>
__global__ void __launch_bounds__(kThreads) env_step_kernel(const EnvStepArgs a) {
  constexpr int kT = kTiles / G;  // tiles a thread
  __shared__ int s_rates[2 * kMaxActions];              // action -> (rate_in, rate_out)
  __shared__ int s_scale[kMaxRates * (kMaxScale + 1)];  // [R, kMaxScale + 1]
  __shared__ int s_vrates[kMaxRates];                   // the versions' bitrates
  const int tid = threadIdx.x, j = tid & (G - 1);
  const int lane = blockIdx.x * (kThreads / G) + tid / G;
  const bool live = lane < a.n_lanes;
  const int n = live ? lane : 0;  // a group past the last lane computes lane 0's step
  const int L = a.L, K = a.K;

  // ---- level 1: the lane's state and history; the codec tables ---------
  const int v = a.video[n], u = a.user[n], tr = a.trace[n], qid = a.qoe_id[n];
  const int c = a.next_chunk[n], act = a.action[n];
  const float buf = a.buf[n];
  const int idx = a.net_idx[n], sec = a.net_sec[n];
  const float frac = a.net_frac[n];
  const float prev_q = a.prev_quality[n];
  const bool has_prev = a.has_prev[n];
  const float last_acc = a.last_acc[n];
  const float ep_qoe = a.ep_qoe[n], ep_qoe1 = a.ep_qoe1[n];
  const float ep_qoe2 = a.ep_qoe2[n], ep_qoe3 = a.ep_qoe3[n];
  const int ep_steps = a.ep_steps[n];
  const int next_sample = a.next_sample[n];
  const bool has_k = j < K;
  const size_t hk = (size_t)n * K + j;
  float h_tp = 0.f, h_acc = 0.f, h_ri = 0.f, h_ro = 0.f, h_vq = 0.f, h_var = 0.f, h_rb = 0.f;
  if (has_k) {
    h_tp = a.past_throughput[hk]; h_acc = a.past_acc[hk];
    h_ri = a.past_rate_in[hk]; h_ro = a.past_rate_out[hk];
    h_vq = a.past_vq[hk]; h_var = a.past_var[hk]; h_rb = a.past_rebuf[hk];
  }
  for (int i = tid; i < 2 * a.A; i += kThreads) s_rates[i] = a.action_rates[i];
  for (int i = tid; i < a.R * (kMaxScale + 1); i += kThreads) s_scale[i] = a.scale_table[i];
  if (tid < a.R) s_vrates[tid] = a.video_rates[tid];

  // ---- level 2: every load that depends only on the lane's state --------
  const size_t vuc = ((size_t)v * a.U + u) * a.C + c;
  const float* pred = a.pred + vuc * kTiles;
  const float* gt = a.gt + vuc * kTiles;
  float pr[kT], g[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    pr[k] = pred[j + k * G];
    g[k] = gt[j + k * G];
  }
  const int end_chunk = a.end_chunk[v * a.U + u];
  const float* wq = a.qoe_weights + 3 * qid;
  const float w0 = wq[0], w1 = wq[1], w2 = wq[2];
  const int Ln = a.bw_len[tr];
  const float* bw = a.bw + (size_t)tr * L;
  const float* pre = a.bw_prefix + (size_t)tr * (L + 1);
  const int j0 = idx + 1;
  const bool in_regs = L + 1 <= kRowRegs;  // the same for every lane
  float p[kT], b[kT];  // the prefix and bandwidth rows: entry j + k G
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    const int e = j + k * G;
    p[k] = in_regs && e <= L ? pre[e] : 0.f;
    b[k] = in_regs && e < L ? bw[e] : 0.f;
  }
  const float rate0 = bw[idx], pre_j0 = pre[j0];
  const float acc_next = a.vp_acc[vuc - c + min(c + 1, a.C - 1)];
  const int srow = floor_mod(next_sample, a.S);
  const int nv = a.samples[4 * srow], nu = a.samples[4 * srow + 1];
  const int ntr = a.samples[4 * srow + 2], nqid = a.samples[4 * srow + 3];
  const int first = a.startup_download + 1;
  // level 3, issued early: the reset sample's accuracy entry
  const float acc_reset = a.vp_acc[((size_t)nv * a.U + nu) * a.C + min(first, a.C - 1)];
  __syncthreads();  // the codec tables are in shared memory

  // ---- pyramid allocation on the predicted viewport ----------------------
  // the 64-bit occupancy mask (bit = tile), one ballot a tile slot k
  const int base = (tid & 31) & ~(G - 1);
  const uint32_t gbits = G == 32 ? kFull : (1u << G) - 1u;
  uint64_t mask = 0ull;
#pragma unroll
  for (int k = 0; k < kT; ++k)
    mask |= (uint64_t)((__ballot_sync(kFull, pr[k] > 0.f) >> base) & gbits) << (k * G);
  int sc[kT];  // BFS ring distance of the thread's tiles (0 on an empty viewport)
#pragma unroll
  for (int k = 0; k < kT; ++k) sc[k] = 0;
  if (mask != 0ull) {
    uint64_t cov = mask;
    for (int r = 0; r < kMaxScale; ++r) {
      const uint64_t mine = cov >> j;  // the thread's tiles at bits k G
#pragma unroll
      for (int k = 0; k < kT; ++k) sc[k] += ((mine >> (k * G)) & 1ull) ? 0 : 1;
      cov = dilate(cov);
    }
  }
  const int rate_in = s_rates[2 * act], rate_out = s_rates[2 * act + 1];
  const int* srates = s_scale + rate_out * (kMaxScale + 1);

  // ---- level 3: the selected version of each tile, and the trace's total --
  const float total = pre[Ln];
  const size_t slab = ((size_t)v * a.C + c) * a.R * kTiles;
  float sz[kT], q[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    const int ver = sc[k] == 0 ? rate_in : srates[sc[k]];
    const size_t at = slab + ver * kTiles + j + k * G;
    sz[k] = a.sizes[at];
    q[k] = a.qualities[at];
  }
  const float chunk_size = tile_sum<G>(sz);

  // ---- closed-form cyclic download (simulate_download_prefix) ------------
  const float avail0 = (1.0f - frac) * rate0;
  const bool full0 = chunk_size >= avail0;
  const float fracA = frac + chunk_size / rate0;
  const float sp = chunk_size - avail0;
  const float target = sp + pre_j0;
  float qt = floorf(target / total);
  float rem = target - qt * total;
  if (rem >= total) { qt = qt + 1.0f; rem = rem - total; }
  if (rem < 0.f) { qt = qt - 1.0f; rem = rem + total; }
  int cnt = 0;
  if (in_regs) {
#pragma unroll
    for (int k = 0; k < kT; ++k) cnt += j + k * G <= L && p[k] <= rem ? 1 : 0;
  } else {
    for (int i = j; i <= L; i += G) cnt += pre[i] <= rem ? 1 : 0;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  const int r = min(max(cnt, 1), Ln);
  const int nn = max((int)qt * Ln + r, j0);  // rounding guard
  int idxB = floor_mod(nn - 1, Ln);
  const float pre_b = in_regs ? row_at<G>(p, idxB) : pre[idxB];
  const float bw_b = in_regs ? row_at<G>(b, idxB) : bw[idxB];
  const float g_nm1 = total * (float)floor_div(nn - 1, Ln) + pre_b;
  const float remainder = max0(target - g_nm1);
  float fracB = remainder > 0.f ? remainder / bw_b : 0.f;
  int m_adv = nn - 1 - idx;
  if (sp == 0.f) {  // ends exactly at the first second boundary
    idxB = floor_mod(j0, Ln);
    m_adv = 1;
    fracB = 0.f;
  }
  const int new_idx = full0 ? idxB : idx;
  const int new_sec = full0 ? sec + m_adv : sec;
  const float new_frac = full0 ? fracB : fracA;
  const float dt = (float)(new_sec - sec) + (new_frac - frac);

  // ---- playback buffer (push_chunk) --------------------------------------
  const float rebuf = max0(dt - buf);
  const float new_buf = dt > buf ? a.chunk_length : buf - dt + a.chunk_length;

  // ---- QoE on the ground-truth viewport (qoe_step) -----------------------
  float gq[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) gq[k] = g[k] * q[k];
  const float vp_sum = tile_sum<G>(g);
  const float quality_raw = tile_sum<G>(gq) / vp_sum;
#pragma unroll
  for (int k = 0; k < kT; ++k) gq[k] = g[k] * fabsf(q[k] - quality_raw);
  const float intra_raw = tile_sum<G>(gq) / vp_sum;
  const float intra = intra_raw / a.max_rate;
  const float quality = quality_raw / a.max_rate;
  const float inter = has_prev ? fabsf(quality - prev_q) : 0.f;
  const float qoe1 = quality, qoe2 = rebuf, qoe3 = intra + inter;
  const float qoe = w0 * qoe1 - w1 * qoe2 - w2 * qoe3;
  const float wsum = (w0 + w1) + w2;
  const float reward = a.train ? qoe / wsum : qoe;

  const bool over = (c + 1) > end_chunk;
  const float n_qoe = ep_qoe + qoe, n_qoe1 = ep_qoe1 + qoe1;
  const float n_qoe2 = ep_qoe2 + qoe2, n_qoe3 = ep_qoe3 + qoe3;
  const int n_steps = ep_steps + 1;
  const float nf = (float)n_steps;

  // history entries k - 1 (shuffled up to thread k of the group)
  const float u_tp = __shfl_up_sync(kFull, h_tp, 1, G), u_acc = __shfl_up_sync(kFull, h_acc, 1, G);
  const float u_ri = __shfl_up_sync(kFull, h_ri, 1, G), u_ro = __shfl_up_sync(kFull, h_ro, 1, G);
  const float u_vq = __shfl_up_sync(kFull, h_vq, 1, G), u_var = __shfl_up_sync(kFull, h_var, 1, G);
  const float u_rb = __shfl_up_sync(kFull, h_rb, 1, G);
  __syncwarp();  // every thread of the group has read the lane's state: overwrite it
  if (!live) return;

  if (j == 0) {
    a.reward[n] = reward;
    a.done[n] = over;
    a.log_video[n] = v; a.log_user[n] = u; a.log_trace[n] = tr; a.log_qoe_id[n] = qid;
    a.log_qoe[n] = n_qoe / nf / wsum;
    a.log_qoe1[n] = n_qoe1 / nf;
    a.log_qoe2[n] = n_qoe2 / nf;
    a.log_qoe3[n] = n_qoe3 / nf;
    a.log_ret[n] = n_qoe;
    a.log_steps[n] = n_steps;
  }
  if (over) {  // auto-reset from samples[next_sample % S] (reset_env)
    if (j == 0) {
      a.video[n] = nv; a.user[n] = nu; a.trace[n] = ntr; a.qoe_id[n] = nqid;
      a.next_sample[n] = floor_mod(next_sample + a.stride, a.S);
      a.next_chunk[n] = first;
      a.buf[n] = a.init_buffer;
      a.net_idx[n] = 0; a.net_sec[n] = 0; a.net_frac[n] = 0.f;
      a.prev_quality[n] = 0.f; a.has_prev[n] = false;
      a.last_rebuffer[n] = 0.f;
      a.last_acc[n] = acc_reset;
      a.ep_qoe[n] = 0.f; a.ep_qoe1[n] = 0.f; a.ep_qoe2[n] = 0.f; a.ep_qoe3[n] = 0.f;
      a.ep_steps[n] = 0;
    }
    if (has_k) {
      a.past_throughput[hk] = 0.f; a.past_acc[hk] = 0.f;
      a.past_rate_in[hk] = 0.f; a.past_rate_out[hk] = 0.f;
      a.past_vq[hk] = 0.f; a.past_var[hk] = 0.f; a.past_rebuf[hk] = 0.f;
    }
    for (int col = j; col < a.A; col += G) a.last_action_one_hot[(size_t)n * a.A + col] = 0.f;
    return;
  }

  if (j == 0) {
    a.next_chunk[n] = c + 1;
    a.buf[n] = new_buf;
    a.net_idx[n] = new_idx; a.net_sec[n] = new_sec; a.net_frac[n] = new_frac;
    a.prev_quality[n] = quality; a.has_prev[n] = true;
    a.last_rebuffer[n] = qoe2;
    a.last_acc[n] = acc_next;
    a.ep_qoe[n] = n_qoe; a.ep_qoe1[n] = n_qoe1; a.ep_qoe2[n] = n_qoe2; a.ep_qoe3[n] = n_qoe3;
    a.ep_steps[n] = n_steps;
  }
  if (has_k) {
    const bool first_k = j == 0;
    a.past_throughput[hk] = first_k ? chunk_size / dt / a.max_throughput : u_tp;
    a.past_acc[hk] = first_k ? last_acc : u_acc;
    a.past_rate_in[hk] = first_k ? (float)s_vrates[rate_in] / a.max_rate : u_ri;
    a.past_rate_out[hk] = first_k ? (float)s_vrates[rate_out] / a.max_rate : u_ro;
    a.past_vq[hk] = first_k ? qoe1 : u_vq;
    a.past_var[hk] = first_k ? qoe3 : u_var;
    a.past_rebuf[hk] = first_k ? qoe2 / (float)a.startup_download : u_rb;
  }
  for (int col = j; col < a.A; col += G)
    a.last_action_one_hot[(size_t)n * a.A + col] = col == act ? 1.f : 0.f;
}

extern "C" int env_step_launch(const EnvStepArgs* args, void* stream) {
  const EnvStepArgs& a = *args;
  if (a.A > kMaxActions || a.R > kMaxRates || (a.group != 8 && a.group != 32) ||
      a.K > a.group)
    return (int)cudaErrorInvalidValue;
  const int lanes = kThreads / a.group;  // lanes a block
  const int blocks = (a.n_lanes + lanes - 1) / lanes;
  if (blocks > 0) {
    if (a.group == 8)
      env_step_kernel<8><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    else
      env_step_kernel<32><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
