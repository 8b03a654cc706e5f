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
// Bound: bytes.  At the serving shapes (B = 512, H = 8, Dh = 64, Lq = 1,
// Lk <= 15) each row reads its q, the valid k and v rows once and writes
// one o row, about 2 flops a byte.  Design: one warp a (b, row, head); lane
// l holds dims l, l + 32, ... of q and of the output; a key's score is a
// warp sum (every lane gets it), the scores of a row sit in shared memory,
// and the softmax normalises them as jax.nn.softmax does (exp(s - max) /
// sum) before the p . v sum, key by key.  Neighbouring warps are
// neighbouring heads, so a block's k and v loads are contiguous.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "elem.cuh"

using mansy::from_f32;
using mansy::round_as;
using mansy::to_f32;
using mansy::warp_sum;

constexpr int kWarps = 4;        // warps (query rows) a block
constexpr int kMaxPerLane = 8;   // Dh <= 256

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

template <typename T>
void launch(const AttentionArgs& a, int train, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Lq * a.H;
  const int blocks = (int)((rows + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * a.Lk * sizeof(float);
  if (blocks > 0) {
    if (train)
      attention_kernel<T, true><<<blocks, kWarps * 32, smem, stream>>>(a);
    else
      attention_kernel<T, false><<<blocks, kWarps * 32, smem, stream>>>(a);
  }
}

// train = 0: the serving mode; 1: the training mode (row_max and row_sum
// written, keep applied where given).  elem = 0: f32 tensors; 1: bf16.
extern "C" int attention_launch(const AttentionArgs* args, int train, int elem, void* stream) {
  if (elem == 0)
    launch<float>(*args, train, (cudaStream_t)stream);
  else if (elem == 1)
    launch<mansy::bf16>(*args, train, (cudaStream_t)stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
