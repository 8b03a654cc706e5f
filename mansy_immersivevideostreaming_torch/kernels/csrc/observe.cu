// K2: MANSY observation gather into one contiguous [N, F] f32 buffer.
//
// Replaces the JAX package's XLA-fused sim/env.py:observe_mansy (:262-286)
// and, when the tables carry action values, exact_action_values (:220-259).
// The plain PyTorch version is kernels/observe.py:observe_mansy_pack_plain.
//
// Row layout (the feature net's inputs first, in its concat order, then the
// fields it does not read): throughput K | next_chunk_size R*T |
// next_chunk_quality R*T | pred_viewport T | viewport_acc K | past_vq K |
// past_var K | past_rebuf K | buffer 1 | qoe_weight 3 | [action_values A+1] |
// rates_inside K | rates_outside K | action_one_hot A.  The bracketed field
// is there only with action-value tables (av_quality not null).
//
// Bound: device-memory bytes.  A gather plus elementwise scaling: each lane
// reads ~3 KB of tables and state and writes its F floats; the action values
// add a few hundred flops.  Design: one block per lane; consecutive threads
// write consecutive columns, so the row store and the slab reads coalesce.
// Built with -fmad=false, like the other kernels, so the action values
// round as their plain version does.

#include <cstdint>
#include <cuda_runtime.h>

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
  int64_t out_stride;
  float max_size, max_rate, max_throughput;
};

// Column o < A: the exact one-step value of action o; column A: bw_hat
// (sim/env.py:exact_action_values, in its operation order).
__device__ float action_value(const ObserveArgs& a, int n, int o, size_t vuc, const float* w,
                              float wsum) {
  const float* tp = a.past_throughput + (size_t)n * a.K;
  float cnt = 0.f, inv = 0.f;  // harmonic_bw_estimate
  for (int k = 0; k < a.K; ++k) {
    const bool nz = tp[k] > 0.f;
    cnt += nz ? 1.f : 0.f;
    inv += nz ? 1.f / fmaxf(tp[k], 1e-12f) : 0.f;
  }
  const float bw_hat = cnt > 0.f ? cnt / fmaxf(inv, 1e-12f) : 0.5f;
  if (o == a.A) return bw_hat;
  const size_t i = vuc * a.A + o;
  float quality = a.av_quality[i], intra = a.av_intra[i];
  if (a.av_out_quality) {  // corrected_scores at viewport_acc_estimate
    const float* pa = a.past_acc + (size_t)n * a.K;
    float m = 0.f, s = 0.f;
    for (int k = 0; k < a.K; ++k) {
      const bool nz = pa[k] > 0.f;
      m += nz ? 1.f : 0.f;
      s += nz ? pa[k] : 0.f;
    }
    const float iou = m > 0.f ? s / fmaxf(m, 1.f) : 0.8f;
    const float acc = 2.f * iou / (1.f + iou);
    const float oq = a.av_out_quality[i], oi = a.av_out_intra[i];
    const float q = acc * quality + (1.f - acc) * oq;
    intra = (acc * intra + (1.f - acc) * oi) + 2.f * acc * (1.f - acc) * fabsf(quality - oq);
    quality = q;
  }
  const float q_n = quality / a.max_rate, intra_n = intra / a.max_rate;
  const float dt = a.av_size[i] / (bw_hat * a.max_throughput);
  const float d = dt - a.buf[n];
  const float rebuf = d < 0.f ? 0.f : d;  // push_chunk's rebuffer time
  const float inter = a.has_prev[n] ? fabsf(q_n - a.prev_quality[n]) : 0.f;
  return (w[0] / wsum) * q_n - (w[1] / wsum) * rebuf - (w[2] / wsum) * (intra_n + inter);
}

__global__ void observe_kernel(const ObserveArgs a) {
  const int n = blockIdx.x;
  const int v = a.video[n], u = a.user[n], c = a.next_chunk[n];
  const size_t slab = ((size_t)v * a.C + c) * a.RT;
  const size_t vuc = ((size_t)v * a.U + u) * a.C + c;
  const size_t hk = (size_t)n * a.K;
  const float* w = a.qoe_weights + 3 * a.qoe_id[n];
  const float wsum = (w[0] + w[1]) + w[2];
  const int n_av = a.av_quality ? a.A + 1 : 0;
  float* row = a.out + (size_t)n * a.out_stride;
  for (int j = threadIdx.x; j < a.F; j += blockDim.x) {
    int o = j;
    float x;
    if (o < a.K) { x = a.past_throughput[hk + o]; }
    else if ((o -= a.K) < a.RT) { x = a.sizes[slab + o] / a.max_size; }
    else if ((o -= a.RT) < a.RT) { x = a.qualities[slab + o] / a.max_rate; }
    else if ((o -= a.RT) < a.T) { x = a.pred[vuc * a.T + o]; }
    else if ((o -= a.T) < a.K) { x = a.past_acc[hk + o]; }
    else if ((o -= a.K) < a.K) { x = a.past_vq[hk + o]; }
    else if ((o -= a.K) < a.K) { x = a.past_var[hk + o]; }
    else if ((o -= a.K) < a.K) { x = a.past_rebuf[hk + o]; }
    else if ((o -= a.K) < 1) { x = a.buf[n] / (float)a.startup_download; }
    else if ((o -= 1) < 3) { x = w[o] / wsum; }
    else if ((o -= 3) < n_av) { x = action_value(a, n, o, vuc, w, wsum); }
    else if ((o -= n_av) < a.K) { x = a.past_rate_in[hk + o]; }
    else if ((o -= a.K) < a.K) { x = a.past_rate_out[hk + o]; }
    else { o -= a.K; x = a.last_action_one_hot[(size_t)n * a.A + o]; }
    row[j] = x;
  }
}

extern "C" int observe_launch(const ObserveArgs* args, void* stream) {
  if (args->n_lanes > 0) {
    observe_kernel<<<args->n_lanes, 256, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
