// K4: the MPC expert's sequence search, one cluster of 15 CTAs a lane.
//
// Replaces the JAX package's XLA-fused sim/expert.py:choose_action
// (:184-294): every one of the 15^h action sequences (sequence i takes
// action (i / 15^j) % 15 at step j) rolls h virtual steps forward from the
// lane's real network, buffer and QoE state.  A step gathers the chunk's
// size and its quality and intra variance (the pred_* tables, or
// corrected_scores of dep_*/out_* at the lane's acc_hat, switched per lane
// by use_corr), downloads along the lane's trace (simulate_download_prefix)
// or takes size / bw_hat, runs push_chunk and adds the weighted QoE; a step
// past end_chunk leaves the carry as it is and adds 0.  The action is the
// first action of the FIRST sequence with the largest total; the optional
// margin is (top1 - top2) / sum(w) over the best total of each first action
// (exact ties give exactly 0).  The plain PyTorch version is
// sim/expert.py:choose_action_plain.
//
// Bound: f32 operations.  Counted as a tree, the search is
// sum_{k=1..h} 15^k = 54,240 virtual steps a lane at h = 4, each a few
// dozen operations plus a binary search over the trace's prefix row; the
// inputs (a few tables rows and the trace) are a few KB a lane.  At the
// expert's 64-lane chunks the work is small and every step is a chain of
// dependent operations (a division, the binary search, a floor), so what
// bounds a launch in practice is latency: the card needs many independent
// walkers in flight.
//
// Design: a (lane, first action a0) grid, 15 CTAs of 256 threads a lane
// (960 CTAs at 64 lanes), each lane's 15 CTAs one thread-block cluster.
// Each CTA stages the lane's h x 15 table entries (normalized, and the
// bw_hat download times) and its trace row and prefix row in shared memory
// (the trace only where it fits), rolls step 0 with a0 once, and its threads
// take the 15^(h-2) prefixes p of steps 1..h-2 (p = tid, tid + 256, ...):
// each rolls its prefix once and then the 15 last actions from the
// prefix's carry, so the shared prefixes are not recomputed.  Sequence i
// takes action (i / 15^j) % 15 at step j, so the first action is the lowest
// digit and a CTA's sequences are i = a0 + 15 p + 15^(h-1) last.  Totals
// are summed step by step in the plain version's order, so sequences that
// differ only in masked steps tie exactly.  Each CTA reduces its
// (total, full index) pairs, keeping the larger total and on an exact tie
// the smaller FULL index (not the smaller a0: a tie between two CTAs can
// have its smaller index in the CTA of the larger a0); its best total is
// also its first-action maximum.  After a cluster barrier CTA 0 reads the
// 15 results from the cluster's shared memory and reduces them in a0 order
// by the same rule, then the margin (top1 - top2) / sum(w) over the 15
// maxima.  No atomics: every run gives the same result.  A walker's step
// is issue-bound, so the download takes its cursor's floor division and
// modulo without an integer division, and 48 registers let five CTAs share
// an SM.
//
// Built with -fmad=false, as K1: the download floors target / total and
// compares prefix sums, so a product rounded differently moves the cursor a
// whole second and can flip a near-tie.

#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace mansy;
namespace cg = cooperative_groups;

namespace {

constexpr int kA = 15;           // actions: also the CTAs of a lane's cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

}  // namespace

// Field order must match kernels/choose_action.py:_ChooseActionArgs.
struct ChooseActionArgs {
  const float* pred_size;     // [V, U, C, 15]
  const float* pred_quality;
  const float* pred_intra;
  const float* dep_quality;   // these four: null unless acc_hat is given
  const float* dep_intra;
  const float* out_quality;
  const float* out_intra;
  const int32_t* end_chunk;   // [V, U]
  const float* bw;            // [NT, L]
  const int32_t* bw_len;      // [NT]
  const float* bw_prefix;     // [NT, L + 1]
  const float* qoe_weights;   // [Q, 3]
  const int32_t* video;       // lane state [N]
  const int32_t* user;
  const int32_t* trace;
  const int32_t* qoe_id;
  const int32_t* next_chunk;
  const float* buf;
  const int32_t* net_idx;
  const int32_t* net_sec;
  const float* net_frac;
  const float* prev_quality;
  const bool* has_prev;
  const float* bw_hat;        // [N] or null: download along the trace
  const float* acc_hat;       // [N] or null: score with the pred_* tables
  const bool* use_corr;       // [N] or null: every lane takes acc_hat's scores
  int32_t* action;            // [N]
  float* margin;              // [N] or null
  int32_t n_lanes, U, C, L, horizon, trace_in_smem;
  float chunk_length, max_rate;
};

struct Carry {
  int idx, sec;
  float frac, buf, prev_q, total;
  bool has_prev;
};

struct Lane {
  const float* size;  // [h][15] shared
  const float* q;     // normalized quality
  const float* in;    // normalized intra variance
  const float* dt;    // size / bw_hat, or null: download along the trace
  const float* bw;    // the trace's rows (shared or global)
  const float* pre;
  int Ln, L;
  float w0, w1, w2, chunk_length;
};

// #{i < n : row[i] <= x} of a nondecreasing row: the count K1 takes with a
// warp, here as a binary search.
__device__ __forceinline__ int count_le(const float* row, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// sim/simulator.py:simulate_download_prefix on the carry's cursor; returns
// the download time.
__device__ float download(const Lane& l, Carry& c, float size) {
  const int idx = c.idx, sec = c.sec;
  const float frac = c.frac;
  const float total = l.pre[l.Ln];
  const float rate0 = l.bw[idx];
  const float avail0 = (1.0f - frac) * rate0;
  const bool full0 = size >= avail0;
  const float fracA = frac + size / rate0;
  const float sp = size - avail0;
  const int j0 = idx + 1;
  const float target = sp + l.pre[j0];
  float q = floorf(target / total);
  float rem = target - q * total;
  if (rem >= total) { q = q + 1.0f; rem = rem - total; }
  if (rem < 0.f) { q = q - 1.0f; rem = rem + total; }
  const int r = min(max(count_le(l.pre, l.L + 1, rem), 1), l.Ln);
  // nn = max(q Ln + r, j0) (a rounding guard), and floor_div / floor_mod of
  // nn - 1 by Ln without an integer division: 1 <= r <= Ln, and the cursor
  // idx = j0 - 1 lies in [0, Ln)
  const bool guard = (int)q * l.Ln + r < j0;
  const int nn = guard ? j0 : (int)q * l.Ln + r;
  int idxB = guard ? idx : r - 1;
  const float g_nm1 = total * (float)(guard ? 0 : (int)q) + l.pre[idxB];
  const float remainder = max0(target - g_nm1);
  float fracB = remainder > 0.f ? remainder / l.bw[idxB] : 0.f;
  int m_adv = nn - 1 - idx;
  if (sp == 0.f) {  // ends exactly at the first second boundary
    idxB = j0 == l.Ln ? 0 : j0;
    m_adv = 1;
    fracB = 0.f;
  }
  c.idx = full0 ? idxB : idx;
  c.sec = full0 ? sec + m_adv : sec;
  c.frac = full0 ? fracB : fracA;
  return (float)(c.sec - sec) + (c.frac - frac);
}

// One virtual step j with action act (a valid step).
__device__ __forceinline__ void step(const Lane& l, Carry& c, int j, int act) {
  const int e = j * kA + act;
  const float dt = l.dt ? l.dt[e] : download(l, c, l.size[e]);
  const float rebuf = max0(dt - c.buf);
  const float nbuf = dt > c.buf ? l.chunk_length : c.buf - dt + l.chunk_length;
  const float q = l.q[e];
  const float inter = c.has_prev ? fabsf(q - c.prev_q) : 0.f;
  const float qoe = l.w0 * q - l.w1 * rebuf - l.w2 * (l.in[e] + inter);
  c.buf = nbuf;
  c.prev_q = q;
  c.has_prev = true;
  c.total = c.total + qoe;
}

// Keep the larger total, and the smaller index on a tie.
__device__ __forceinline__ void consider(float tot, int i, float& best, int& best_i) {
  if (tot > best || (tot == best && i < best_i)) {
    best = tot;
    best_i = i;
  }
}

__global__ void __launch_bounds__(kThreads, 5)
choose_action_kernel(const __grid_constant__ ChooseActionArgs a) {
  extern __shared__ float smem[];
  __shared__ float s_best[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_cta_best;  // this CTA's best total (its first-action maximum)
  __shared__ int s_cta_idx;     // and the full index of its first sequence with it
  __shared__ Carry s_c1;        // the carry after step 0 with a0
  cg::cluster_group cluster = cg::this_cluster();
  const int a0 = (int)cluster.block_rank();  // the first action of this CTA's sequences
  const int n = (int)(blockIdx.x / kA), tid = threadIdx.x, h = a.horizon;
  const int v = a.video[n], u = a.user[n], tr = a.trace[n], nc = a.next_chunk[n];
  const int end = a.end_chunk[v * a.U + u];
  const int hv = max(0, min(h, end - nc + 1));  // steps before end_chunk
  float* s_size = smem;
  float* s_q = s_size + h * kA;
  float* s_in = s_q + h * kA;
  float* s_dt = s_in + h * kA;

  // ---- stage the lane's step x action entries and its trace ----
  const float acc = a.acc_hat ? a.acc_hat[n] : 0.f;
  const bool corr = a.acc_hat && (!a.use_corr || a.use_corr[n]);
  for (int e = tid; e < hv * kA; e += kThreads) {
    const int j = e / kA, act = e % kA;
    const size_t i = (((size_t)v * a.U + u) * a.C + nc + j) * kA + act;
    const float size = a.pred_size[i];
    float quality = a.pred_quality[i], intra = a.pred_intra[i];
    if (corr) {  // corrected_scores
      const float dq = a.dep_quality[i], di = a.dep_intra[i];
      const float oq = a.out_quality[i], oi = a.out_intra[i];
      quality = acc * dq + (1.f - acc) * oq;
      intra = (acc * di + (1.f - acc) * oi) + 2.f * acc * (1.f - acc) * fabsf(dq - oq);
    }
    s_size[e] = size;
    s_q[e] = quality / a.max_rate;
    s_in[e] = intra / a.max_rate;
    s_dt[e] = a.bw_hat ? size / a.bw_hat[n] : 0.f;
  }
  const float* g_bw = a.bw + (size_t)tr * a.L;
  const float* g_pre = a.bw_prefix + (size_t)tr * (a.L + 1);
  Lane l;
  l.bw = g_bw;
  l.pre = g_pre;
  if (!a.bw_hat && a.trace_in_smem) {
    float* s_bw = s_dt + h * kA;
    float* s_pre = s_bw + a.L;
    for (int i = tid; i < a.L; i += kThreads) s_bw[i] = g_bw[i];
    for (int i = tid; i <= a.L; i += kThreads) s_pre[i] = g_pre[i];
    l.bw = s_bw;
    l.pre = s_pre;
  }
  __syncthreads();
  l.size = s_size;
  l.q = s_q;
  l.in = s_in;
  l.dt = a.bw_hat ? s_dt : nullptr;
  l.Ln = a.bw_len[tr];
  l.L = a.L;
  const float* w = a.qoe_weights + 3 * a.qoe_id[n];
  l.w0 = w[0];
  l.w1 = w[1];
  l.w2 = w[2];
  l.chunk_length = a.chunk_length;
  Carry c0;
  c0.idx = a.net_idx[n];
  c0.sec = a.net_sec[n];
  c0.frac = a.net_frac[n];
  c0.buf = a.buf[n];
  c0.prev_q = a.prev_quality[n];
  c0.has_prev = a.has_prev[n];
  c0.total = 0.f;
  if (tid == 0) {  // step 0 with a0, once
    if (hv > 0) step(l, c0, 0, a0);
    s_c1 = c0;
  }
  __syncthreads();
  const Carry c1 = s_c1;

  // ---- the prefixes of steps 1..h-2, then the last action ----
  float best = -INFINITY;
  int best_i = INT_MAX;
  if (h == 1) {
    if (tid == 0) consider(c1.total, a0, best, best_i);
  } else {
    int P = 1;  // prefixes of steps 1..h-2
    for (int j = 2; j < h; ++j) P *= kA;
    const int last = P * kA;  // 15^(h-1): the weight of the last step's digit
    for (int p = tid; p < P; p += kThreads) {
      Carry c = c1;
      int rest = p;
      for (int j = 1; j < h - 1; ++j) {
        const int act = rest % kA;
        rest /= kA;
        if (j < hv) step(l, c, j, act);
      }
      const int i0 = a0 + kA * p;
      if (h - 1 < hv) {
        for (int act = 0; act < kA; ++act) {
          Carry d = c;
          step(l, d, h - 1, act);
          consider(d.total, i0 + last * act, best, best_i);
        }
      } else {  // a masked last step: every leaf ties with leaf 0
        consider(c.total, i0, best, best_i);
      }
    }
  }

  // ---- (value, index) reduction over the CTA ----
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, best_i, o);
    consider(ov, oi, best, best_i);
  }
  if ((tid & 31) == 0) {
    s_best[tid >> 5] = best;
    s_idx[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kWarps; ++k) consider(s_best[k], s_idx[k], best, best_i);
    s_cta_best = best;
    s_cta_idx = best_i;
  }
  cluster.sync();  // the 15 CTAs' results are in place

  // ---- CTA 0: the lane's answer over a0 = 0..14 in order, and the margin ----
  if (a0 == 0 && tid == 0) {
    float m1 = -INFINITY, m2 = -INFINITY;
    best = -INFINITY;
    best_i = INT_MAX;
    for (int r = 0; r < kA; ++r) {
      const float x = *cluster.map_shared_rank(&s_cta_best, r);
      consider(x, *cluster.map_shared_rank(&s_cta_idx, r), best, best_i);
      if (x > m1) { m2 = m1; m1 = x; }
      else if (x > m2) { m2 = x; }
    }
    a.action[n] = best_i == INT_MAX ? 0 : best_i % kA;
    if (a.margin) a.margin[n] = (m1 - m2) / ((w[0] + w[1]) + w[2]);
  }
  cluster.sync();  // no CTA leaves while CTA 0 reads its shared memory
}

extern "C" int choose_action_launch(const ChooseActionArgs* args, int smem_bytes, void* stream) {
  // above 48 KB of dynamic shared memory needs the opt-in (for the current
  // device), and a cluster of 15 CTAs the non-portable size (max 16)
  cudaError_t e = cudaFuncSetAttribute(choose_action_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem_bytes > 48 * 1024)
    e = cudaFuncSetAttribute(choose_action_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (args->n_lanes > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(args->n_lanes * kA);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = kA;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, choose_action_kernel, *args);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
