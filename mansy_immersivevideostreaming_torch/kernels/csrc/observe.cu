// K2: MANSY observation gather into one contiguous [N, F] f32 buffer.
//
// Replaces the JAX package's XLA-fused sim/env.py:observe_mansy (:262-286).
// The plain PyTorch version is kernels/observe.py:observe_mansy_pack_plain.
//
// Row layout (the first 748 columns in MansyFeatureNet's concat order, then
// the fields it does not read): throughput K | next_chunk_size R*T |
// next_chunk_quality R*T | pred_viewport T | viewport_acc K | past_vq K |
// past_var K | past_rebuf K | buffer 1 | qoe_weight 3 | rates_inside K |
// rates_outside K | action_one_hot A.
//
// Bound: device-memory bytes.  A pure gather plus elementwise scaling (one
// 3-wide sum, no products): each lane reads ~3 KB of tables and state and
// writes its F floats.  Design: one block per lane; consecutive threads
// write consecutive columns, so the row store and the slab reads coalesce.

#include <cstdint>
#include <cuda_runtime.h>

// Field order must match kernels/observe.py:_ObserveArgs.
struct ObserveArgs {
  const float* sizes;        // [V, C, R, T]
  const float* qualities;    // [V, C, R, T]
  const float* pred;         // [V, U, C, T]
  const float* qoe_weights;  // [Q, 3]
  const int32_t* video;      // [N]
  const int32_t* user;
  const int32_t* next_chunk;
  const int32_t* qoe_id;
  const float* buf;          // [N]
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
  float max_size, max_rate;
};

__global__ void observe_kernel(const ObserveArgs a) {
  const int n = blockIdx.x;
  const int v = a.video[n], u = a.user[n], c = a.next_chunk[n];
  const size_t slab = ((size_t)v * a.C + c) * a.RT;
  const size_t vuc = (((size_t)v * a.U + u) * a.C + c) * a.T;
  const size_t hk = (size_t)n * a.K;
  const float* w = a.qoe_weights + 3 * a.qoe_id[n];
  const float wsum = (w[0] + w[1]) + w[2];
  float* row = a.out + (size_t)n * a.out_stride;
  for (int j = threadIdx.x; j < a.F; j += blockDim.x) {
    int o = j;
    float x;
    if (o < a.K) { x = a.past_throughput[hk + o]; }
    else if ((o -= a.K) < a.RT) { x = a.sizes[slab + o] / a.max_size; }
    else if ((o -= a.RT) < a.RT) { x = a.qualities[slab + o] / a.max_rate; }
    else if ((o -= a.RT) < a.T) { x = a.pred[vuc + o]; }
    else if ((o -= a.T) < a.K) { x = a.past_acc[hk + o]; }
    else if ((o -= a.K) < a.K) { x = a.past_vq[hk + o]; }
    else if ((o -= a.K) < a.K) { x = a.past_var[hk + o]; }
    else if ((o -= a.K) < a.K) { x = a.past_rebuf[hk + o]; }
    else if ((o -= a.K) < 1) { x = a.buf[n] / (float)a.startup_download; }
    else if ((o -= 1) < 3) { x = w[o] / wsum; }
    else if ((o -= 3) < a.K) { x = a.past_rate_in[hk + o]; }
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
