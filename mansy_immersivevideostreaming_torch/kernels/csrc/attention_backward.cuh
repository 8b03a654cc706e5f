// K8's backward: the launch arguments and the gradient of one (row, key)
// that the one-CTA kernels (csrc/attention_backward.cu) and the split
// kernels (csrc/attention_backward_split.cu) share; the wide kernels
// (csrc/attention_backward_wide.cu) take the arguments.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "elem.cuh"

// Field order must match kernels/attention.py:_AttentionBackwardArgs.
struct AttentionBackwardArgs {
  const void* dout;      // T [B, Lq, H, Dh]
  const void* q;         // T [B, Lq, H, Dh]
  const void* k;         // T [B, Lk, H, Dh]
  const void* v;         // T [B, Lk, H, Dh]
  const void* o;         // T [B, Lq, H, Dh] (f32 only: null in bf16, which reads no o)
  const float* row_max;  // [B, H, Lq]
  const float* row_sum;  // [B, H, Lq]
  const uint8_t* keep;   // [B, H, Lq, Lk], or null without dropout
  void* dq;              // T [B, Lq, H, Dh]
  void* dk;              // T [B, Lk, H, Dh]
  void* dv;              // T [B, Lk, H, Dh]
  int32_t B, Lq, Lk, H, Dh, kv_len0;
  float scale;           // sqrt(Dh)
  float keep_prob;       // 1 - dropout rate
  // the plan (kernels/attention.py:attention_backward_plan)
  int32_t per_lane;      // P: dims a lane holds (1, 2, 4 or 8)
  int32_t keys;          // M: keys a tile (4, 8, 16 or 32; M P <= 32)
  int32_t rows;          // rows a row tile (tile kernel; 1 for the row kernel)
  int32_t warps;         // warps a CTA (tile kernel: 4 or 8; the row kernel: 8)
  // bf16 only
  float* delta;          // [B, H, Lq]: D of each row (bf16: delta_kernel writes it)
  float* dq_acc;         // [B, Lq, H, Dh]: the tile kernel's dQ chains (Lq > 1 up to 256
                         // dims; the wide row kernel's at Lq = 1)
  // past 256 dims for more than one row and key tile (csrc/attention_backward_wide.cu), f32 and
  // bf16: each row's max of q . k (before the division by sqrt(Dh)) and its D, written by the
  // dQ grid for the dK/dV grid (delta above)
  float* row_max_acc;    // [B, H, Lq]
};

namespace {

constexpr int kMaxRows = 32;  // the tile and split kernels: rows a row tile

// One (row, key) of the backward from its score and dP': (P', dS / scale),
// both 0 for a key the row does not see.
struct Grad {
  float pd, ds;
};

template <typename T>
__device__ __forceinline__ Grad grad_of(const AttentionBackwardArgs& a, bool seen, float score,
                                        float dpd, float mx, float sum, float D, bool masked,
                                        bool kept) {
  if (!seen) return {0.f, 0.f};
  const float p = expf(score - mx) / sum;     // the forward's P
  const float dpr = mansy::round_as<T>(dpd);  // bf16: dP' is a bf16 product
  float pd = p, dp = dpr;                     // P' and dP' * M / kp
  if (masked) {
    pd = kept ? p / a.keep_prob : 0.f;
    dp = kept ? dpr / a.keep_prob : 0.f;
  }
  return {mansy::round_as<T>(pd), p * (dp - D) / a.scale};
}

// The tile kernel's shared memory: the k and v tiles, the q, dO and o rows of
// a row tile, its P' and dS, its row max and sum, and its keep bytes.
inline size_t tile_smem_bytes(int P, int M, int rows) {
  return sizeof(float) * (2 * (size_t)M * 32 * P + 3 * (size_t)rows * 32 * P +
                          2 * (size_t)rows * M + 2 * (size_t)rows) +
         (size_t)rows * M;
}

}  // namespace
