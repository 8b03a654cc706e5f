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
// writes its state back; the arithmetic is a few hundred flops.
//
// Design: one warp per lane, two tiles per thread.  The predicted viewport
// becomes a 64-bit occupancy mask with two ballots, so the 3x3 torus
// dilation rings are shifts and masks on one register.  Tile sums are
// butterfly shuffles (every thread ends with the same sum), the prefix count
// #{prefix <= rem} is a warp-strided count plus __reduce_add_sync, and
// thread k < K rolls entry k of the histories with one shuffle.
//
// The state is updated IN PLACE: each warp reads its lane's state, then
// (after __syncwarp) overwrites it with the stepped or reset state.
//
// Built with -fmad=false: every product and quotient rounds exactly as in
// the plain version, because the download's floor/compare steps move the
// cursor a whole second on a 1-ulp difference.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace mansy;

namespace {

constexpr int kWarpsPerBlock = 4;

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
  float chunk_length, init_buffer, max_rate, max_throughput;
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
env_step_kernel(const EnvStepArgs a) {
  const int t = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= a.n_lanes) return;  // whole warp leaves together

  // ---- read the lane's state -------------------------------------------
  const int v = a.video[n], u = a.user[n], tr = a.trace[n], qid = a.qoe_id[n];
  const int c = a.next_chunk[n];
  const int act = a.action[n];
  const int rate_in = a.action_rates[2 * act], rate_out = a.action_rates[2 * act + 1];
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
  const bool has_k = t < a.K;
  const size_t hk = (size_t)n * a.K + t;
  float h_tp = 0.f, h_acc = 0.f, h_ri = 0.f, h_ro = 0.f, h_vq = 0.f, h_var = 0.f, h_rb = 0.f;
  if (has_k) {
    h_tp = a.past_throughput[hk]; h_acc = a.past_acc[hk];
    h_ri = a.past_rate_in[hk]; h_ro = a.past_rate_out[hk];
    h_vq = a.past_vq[hk]; h_var = a.past_var[hk]; h_rb = a.past_rebuf[hk];
  }

  // ---- pyramid allocation on the predicted viewport ----------------------
  const size_t vuc = ((size_t)v * a.U + u) * a.C + c;
  int s0, s1;  // BFS ring distance of tiles t and t + 32
  viewport_scales(viewport_mask(a.pred + vuc * kTiles, t), t, s0, s1);
  const int* srow = a.scale_table + rate_out * (kMaxScale + 1);
  const int ver0 = s0 == 0 ? rate_in : srow[s0];
  const int ver1 = s1 == 0 ? rate_in : srow[s1];

  // ---- the selected version of each tile --------------------------------
  const size_t slab = ((size_t)v * a.C + c) * a.R * kTiles;
  const float size0 = a.sizes[slab + ver0 * kTiles + t];
  const float size1 = a.sizes[slab + ver1 * kTiles + t + 32];
  const float q0 = a.qualities[slab + ver0 * kTiles + t];
  const float q1 = a.qualities[slab + ver1 * kTiles + t + 32];
  const float chunk_size = warp_sum(size0 + size1);

  // ---- closed-form cyclic download (simulate_download_prefix) ------------
  const int Ln = a.bw_len[tr];
  const float* bw = a.bw + (size_t)tr * a.L;
  const float* pre = a.bw_prefix + (size_t)tr * (a.L + 1);
  const float total = pre[Ln];
  const float rate0 = bw[idx];
  const float avail0 = (1.0f - frac) * rate0;
  const bool full0 = chunk_size >= avail0;
  const float fracA = frac + chunk_size / rate0;
  const float sp = chunk_size - avail0;
  const int j0 = idx + 1;
  const float target = sp + pre[j0];
  float q = floorf(target / total);
  float rem = target - q * total;
  if (rem >= total) { q = q + 1.0f; rem = rem - total; }
  if (rem < 0.f) { q = q - 1.0f; rem = rem + total; }
  int cnt = 0;
  for (int i = t; i <= a.L; i += 32) cnt += pre[i] <= rem ? 1 : 0;
  cnt = __reduce_add_sync(kFull, cnt);
  const int r = min(max(cnt, 1), Ln);
  const int nn = max((int)q * Ln + r, j0);  // rounding guard
  int idxB = floor_mod(nn - 1, Ln);
  const float g_nm1 = total * (float)floor_div(nn - 1, Ln) + pre[idxB];
  const float remainder = max0(target - g_nm1);
  float fracB = remainder > 0.f ? remainder / bw[idxB] : 0.f;
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
  const float* gt = a.gt + vuc * kTiles;
  const float g0 = gt[t], g1 = gt[t + 32];
  const float vp_sum = warp_sum(g0 + g1);
  const float quality_raw = warp_sum(g0 * q0 + g1 * q1) / vp_sum;
  const float intra_raw =
      warp_sum(g0 * fabsf(q0 - quality_raw) + g1 * fabsf(q1 - quality_raw)) / vp_sum;
  const float intra = intra_raw / a.max_rate;
  const float quality = quality_raw / a.max_rate;
  const float inter = has_prev ? fabsf(quality - prev_q) : 0.f;
  const float qoe1 = quality, qoe2 = rebuf, qoe3 = intra + inter;
  const float* w = a.qoe_weights + 3 * qid;
  const float qoe = w[0] * qoe1 - w[1] * qoe2 - w[2] * qoe3;
  const float wsum = (w[0] + w[1]) + w[2];
  const float reward = a.train ? qoe / wsum : qoe;

  const bool over = (c + 1) > a.end_chunk[v * a.U + u];
  const float n_qoe = ep_qoe + qoe, n_qoe1 = ep_qoe1 + qoe1;
  const float n_qoe2 = ep_qoe2 + qoe2, n_qoe3 = ep_qoe3 + qoe3;
  const int n_steps = ep_steps + 1;
  const float nf = (float)n_steps;

  // history entries k - 1 (shuffled up to thread k)
  const float u_tp = __shfl_up_sync(kFull, h_tp, 1), u_acc = __shfl_up_sync(kFull, h_acc, 1);
  const float u_ri = __shfl_up_sync(kFull, h_ri, 1), u_ro = __shfl_up_sync(kFull, h_ro, 1);
  const float u_vq = __shfl_up_sync(kFull, h_vq, 1), u_var = __shfl_up_sync(kFull, h_var, 1);
  const float u_rb = __shfl_up_sync(kFull, h_rb, 1);
  __syncwarp();  // every thread has read the state: overwrite it

  if (t == 0) {
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
    const int s = floor_mod(next_sample, a.S);
    const int nv = a.samples[4 * s], nu = a.samples[4 * s + 1];
    const int first = a.startup_download + 1;
    if (t == 0) {
      a.video[n] = nv; a.user[n] = nu;
      a.trace[n] = a.samples[4 * s + 2]; a.qoe_id[n] = a.samples[4 * s + 3];
      a.next_sample[n] = floor_mod(next_sample + a.stride, a.S);
      a.next_chunk[n] = first;
      a.buf[n] = a.init_buffer;
      a.net_idx[n] = 0; a.net_sec[n] = 0; a.net_frac[n] = 0.f;
      a.prev_quality[n] = 0.f; a.has_prev[n] = false;
      a.last_rebuffer[n] = 0.f;
      a.last_acc[n] = a.vp_acc[((size_t)nv * a.U + nu) * a.C + min(first, a.C - 1)];
      a.ep_qoe[n] = 0.f; a.ep_qoe1[n] = 0.f; a.ep_qoe2[n] = 0.f; a.ep_qoe3[n] = 0.f;
      a.ep_steps[n] = 0;
    }
    if (has_k) {
      a.past_throughput[hk] = 0.f; a.past_acc[hk] = 0.f;
      a.past_rate_in[hk] = 0.f; a.past_rate_out[hk] = 0.f;
      a.past_vq[hk] = 0.f; a.past_var[hk] = 0.f; a.past_rebuf[hk] = 0.f;
    }
    if (t < a.A) a.last_action_one_hot[(size_t)n * a.A + t] = 0.f;
    return;
  }

  if (t == 0) {
    a.next_chunk[n] = c + 1;
    a.buf[n] = new_buf;
    a.net_idx[n] = new_idx; a.net_sec[n] = new_sec; a.net_frac[n] = new_frac;
    a.prev_quality[n] = quality; a.has_prev[n] = true;
    a.last_rebuffer[n] = qoe2;
    a.last_acc[n] = a.vp_acc[vuc - c + min(c + 1, a.C - 1)];
    a.ep_qoe[n] = n_qoe; a.ep_qoe1[n] = n_qoe1; a.ep_qoe2[n] = n_qoe2; a.ep_qoe3[n] = n_qoe3;
    a.ep_steps[n] = n_steps;
  }
  if (has_k) {
    const bool first = t == 0;
    a.past_throughput[hk] = first ? chunk_size / dt / a.max_throughput : u_tp;
    a.past_acc[hk] = first ? last_acc : u_acc;
    a.past_rate_in[hk] = first ? (float)a.video_rates[rate_in] / a.max_rate : u_ri;
    a.past_rate_out[hk] = first ? (float)a.video_rates[rate_out] / a.max_rate : u_ro;
    a.past_vq[hk] = first ? qoe1 : u_vq;
    a.past_var[hk] = first ? qoe3 : u_var;
    a.past_rebuf[hk] = first ? qoe2 / (float)a.startup_download : u_rb;
  }
  if (t < a.A) a.last_action_one_hot[(size_t)n * a.A + t] = t == act ? 1.f : 0.f;
}

extern "C" int env_step_launch(const EnvStepArgs* args, void* stream) {
  const int blocks = (args->n_lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    env_step_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
