// K8's backward: the gradients of the softmax-attention core with respect to
// q, k and v, in f32, from the training mode's row statistics.
//
// Replaces the XLA backward that jax.value_and_grad derives for
// models/transformer.py:MHA.attend (:61-75) under models/vp_train.py
// :_train_step (:57-65); the deleted Pallas kernel mha_pallas had no
// backward.  The plain PyTorch version is
// kernels/attention.py:attention_backward_plain.
//
// Per (b, head), with P the softmax of the masked scores, M the dropout keep
// mask, kp its keep probability, P' = P * M / kp the dropped probabilities
// and O = P' V the forward's output:
//   dV  = P'^T dO
//   dP' = dO V^T
//   D   = rowsum(dO * O)
//   dS  = P * (dP' * M / kp - D)
//   dQ  = (dS / sqrt(Dh)) K,   dK = (dS / sqrt(Dh))^T Q.
// P is recomputed from q, k and the forward's row max and exp sum with the
// forward's operations in the forward's order (the same lane layout, fmaf
// chain and warp sum a score, expf(s - max), a division by the sum), so it
// is the forward's P bit for bit.  Keys past a row's prefix
// (min(Lk, kv_len0 + r)) have P = 0 and get exactly 0 in dK and dV.
//
// Layouts are the JAX package's: q, o, dO, dQ [B, Lq, H, Dh]; k, v, dK, dV
// [B, Lk, H, Dh]; the statistics [B, H, Lq]; the mask [B, H, Lq, Lk].
//
// Bound: bytes.  At run_models' training shapes (B 512, 8 heads of 64, at
// most 16 rows a side) a (b, head) reads a few KB and does about 8 Dh flops
// a (row, key).  Design: one CTA of four warps a (b, head).  The head's q,
// dO, k and v rows go to shared memory (<= 16 x 64 f32 each at those
// shapes).  Pass 1: a warp a query row computes D, then key by key P, dP',
// dS (kept in shared memory with P') and the dQ row in registers (lane l
// holds dims l, l + 32, ...).  Pass 2: a warp a key sums its dK and dV rows
// over the query rows in a fixed order.  No atomics: two launches give the
// same bits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using mansy::warp_sum;

constexpr int kWarps = 4;
constexpr int kMaxPerLane = 8;   // Dh <= 256

// Field order must match kernels/attention.py:_AttentionBackwardArgs.
struct AttentionBackwardArgs {
  const float* dout;     // [B, Lq, H, Dh]
  const float* q;        // [B, Lq, H, Dh]
  const float* k;        // [B, Lk, H, Dh]
  const float* v;        // [B, Lk, H, Dh]
  const float* o;        // [B, Lq, H, Dh]
  const float* row_max;  // [B, H, Lq]
  const float* row_sum;  // [B, H, Lq]
  const uint8_t* keep;   // [B, H, Lq, Lk], or null without dropout
  float* dq;             // [B, Lq, H, Dh]
  float* dk;             // [B, Lk, H, Dh]
  float* dv;             // [B, Lk, H, Dh]
  int32_t B, Lq, Lk, H, Dh, kv_len0;
  float scale;           // sqrt(Dh)
  float keep_prob;       // 1 - dropout rate
};

__host__ __device__ inline size_t backward_smem_bytes(int Lq, int Lk, int Dh) {
  return sizeof(float) * ((size_t)2 * Lq * Dh + (size_t)2 * Lk * Dh + (size_t)2 * Lq * Lk);
}

__global__ void attention_backward_kernel(const AttentionBackwardArgs a) {
  extern __shared__ float smem[];
  const int Lq = a.Lq, Lk = a.Lk, Dh = a.Dh, H = a.H;
  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sq = smem;              // [Lq, Dh]
  float* sdo = sq + Lq * Dh;     // [Lq, Dh]
  float* sk = sdo + Lq * Dh;     // [Lk, Dh]
  float* sv = sk + Lk * Dh;      // [Lk, Dh]
  float* sp = sv + Lk * Dh;      // [Lq, Lk]: P'
  float* sds = sp + Lq * Lk;     // [Lq, Lk]: dS / scale

  const size_t qrow0 = ((size_t)b * Lq * H + h) * Dh;   // row r at qrow0 + r * H * Dh
  const size_t krow0 = ((size_t)b * Lk * H + h) * Dh;
  const size_t stride = (size_t)H * Dh;
  for (int i = threadIdx.x; i < Lq * Dh; i += blockDim.x) {
    const size_t g = qrow0 + (i / Dh) * stride + i % Dh;
    sq[i] = a.q[g];
    sdo[i] = a.dout[g];
  }
  for (int i = threadIdx.x; i < Lk * Dh; i += blockDim.x) {
    const size_t g = krow0 + (i / Dh) * stride + i % Dh;
    sk[i] = a.k[g];
    sv[i] = a.v[g];
  }
  __syncthreads();

  // pass 1: a warp a query row
  for (int r = warp; r < Lq; r += kWarps) {
    const int n = min(Lk, a.kv_len0 + r);
    const long long stat = (b * H + h) * Lq + r;
    const float mx = a.row_max[stat], sum = a.row_sum[stat];
    const uint8_t* keep = a.keep != nullptr ? a.keep + stat * Lk : nullptr;
    const float* orow = a.o + qrow0 + r * stride;
    float qv[kMaxPerLane], dov[kMaxPerLane], acc[kMaxPerLane];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      qv[i] = d < Dh ? sq[r * Dh + d] : 0.f;
      dov[i] = d < Dh ? sdo[r * Dh + d] : 0.f;
      acc[i] = 0.f;
      if (d < Dh) part = fmaf(dov[i], orow[d], part);
    }
    const float D = warp_sum(part);
    for (int j = 0; j < n; ++j) {
      const float* krow = sk + j * Dh;
      const float* vrow = sv + j * Dh;
      float qk = 0.f, dov_v = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) {
          qk = fmaf(qv[i], krow[d], qk);   // the forward's chain for this score
          dov_v = fmaf(dov[i], vrow[d], dov_v);
        }
      }
      const float sc = warp_sum(qk) / a.scale;
      const float dpd = warp_sum(dov_v);     // dP'
      const float p = expf(sc - mx) / sum;
      float pd = p, dp = dpd;                 // P' and dP' * M / kp
      if (keep != nullptr) {
        pd = keep[j] ? p / a.keep_prob : 0.f;
        dp = keep[j] ? dpd / a.keep_prob : 0.f;
      }
      const float ds = p * (dp - D) / a.scale;
      if (lane == 0) {
        sp[r * Lk + j] = pd;
        sds[r * Lk + j] = ds;
      }
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) acc[i] = fmaf(ds, krow[d], acc[i]);
      }
    }
    for (int j = n + lane; j < Lk; j += 32) {
      sp[r * Lk + j] = 0.f;
      sds[r * Lk + j] = 0.f;
    }
    float* dqrow = a.dq + qrow0 + r * stride;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) dqrow[d] = acc[i];
    }
  }
  __syncthreads();

  // pass 2: a warp a key, its sums over the query rows in row order
  for (int j = warp; j < Lk; j += kWarps) {
    float ak[kMaxPerLane], av[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) ak[i] = av[i] = 0.f;
    // rows before r0 do not see key j (their prefix ends at or before it)
    const int r0 = max(0, j - a.kv_len0 + 1);
    for (int r = r0; r < Lq; ++r) {
      const float pd = sp[r * Lk + j], ds = sds[r * Lk + j];
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) {
          av[i] = fmaf(pd, sdo[r * Dh + d], av[i]);
          ak[i] = fmaf(ds, sq[r * Dh + d], ak[i]);
        }
      }
    }
    float* dkrow = a.dk + krow0 + j * stride;
    float* dvrow = a.dv + krow0 + j * stride;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) {
        dkrow[d] = ak[i];
        dvrow[d] = av[i];
      }
    }
  }
}

extern "C" int attention_backward_launch(const AttentionBackwardArgs* args, void* stream) {
  const long long blocks = (long long)args->B * args->H;
  const size_t smem = backward_smem_bytes(args->Lq, args->Lk, args->Dh);
  if (blocks <= 0) return 0;
  if (smem > 48 * 1024) {  // above 48 KB needs the opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        attention_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_backward_kernel<<<(unsigned)blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
