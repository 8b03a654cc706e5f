// K3: MANSY actor-critic forward with its action head, in f32.
//
// Replaces the JAX package's XLA-fused models/abr_nets.py:_branch,
// MansyFeatureNet and MansyActorCritic.__call__ (:105-186) plus the action
// head of rl/rollout.py:52-54 and rl/runner.py:123-126 (log_softmax and the
// first-index argmax of logits + Gumbel noise).  The plain PyTorch version
// is kernels/actor_critic.py:actor_critic_forward_plain.
//
// Per lane: 10 branch dense layers (748 -> 10 x 128, block-diagonal), or 11
// with the action-value branch (764 -> 11 x 128), with LeakyReLU(0.01);
// actor_fc and critic_fc (10 or 11 x 128 -> 2 x 128) with LeakyReLU; the
// "+ cond" residual (branch 9); actor_out (128 -> A) and critic_out
// (128 -> 1); the optional action-value logit prior
// beta * (av - mean) / (std + 1e-6) (population std, abr_nets.py:176-180);
// log_softmax and argmax.  About 0.85 MFLOP a lane (0.94 with 11 branches).
//
// Training mode (feats and hidden given, kernels/actor_critic.py:
// actor_critic_train_forward): no noise and no action head; it also writes
// what the backward (csrc/actor_critic_backward.cu, K10) reads, the branch
// features after LeakyReLU [N, nb x 128] and the fc outputs after LeakyReLU,
// before the residual [N, 256] (2.6 MB at 512 lanes, under a microsecond at
// the H100's 3.35 TB/s).  K10 takes each LeakyReLU's derivative from the
// sign of its output, so nothing is recomputed.
//
// Bound: f32 operations.  At 8192 lanes the forward is ~7 GFLOP against
// ~26 MB of inputs, so the card's non-tensor f32 rate bounds it.  No TF32:
// the sums stay in full f32, as the JAX reference's "highest" precision.
//
// Design: one block of 256 threads per 64 lanes.  Branch by branch, a
// register-tiled product (8 lanes x 4 columns a thread) computes the
// branch's 128 features into shared memory, and a second one (8 x 8 a
// thread) folds them at once into the 64 x 256 fc accumulators, so the
// [N, 1280] feature matrix never reaches device memory.  Weight tiles are
// staged in shared memory, 32 rows at a time; every block rereads the 1.7 MB
// of weights from L2.  The heads and the epilogue run from shared memory.
// Simple and right first: no wgmma, no TMA, no pipelining yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kH = 128;        // hidden width
constexpr int kMaxNB = 11;     // feature-net branches: 10, or 11 with action values
constexpr int kCond = 9;       // the cond branch, whose features are the residual
constexpr int kBM = 64;        // lanes per block
constexpr int kBK = 32;        // k rows staged per tile
constexpr int kThreads = 256;
constexpr int kPad = kBM + 4;  // transposed tiles [k][m]; keeps float4 alignment
constexpr int kHS = 2 * kH + 1;  // row stride of the fc output tile
constexpr int kOut = 16;       // logits (A <= 15) and the value

constexpr int kAsFloats = kBK * kPad;
constexpr int kBsFloats = kBK * 2 * kH;
constexpr int kFsFloats = kH * kPad;
constexpr int kCsFloats = kBM * kH;
constexpr int kLsFloats = kBM * kOut;
constexpr int kSmemBytes =
    (kAsFloats + kBsFloats + kFsFloats + kCsFloats + kLsFloats) * (int)sizeof(float);
static_assert(kBsFloats + kFsFloats >= kBM * kHS, "fc output tile must fit over Bs + Fs");

}  // namespace

// Field order must match kernels/actor_critic.py:_ActorCriticArgs.
struct ActorCriticArgs {
  const float* x;         // [N, ldx] packed observations; columns [0, branch_off[nb]) read
  const float* w_branch;  // [branch_off[nb], 128] the branch kernels stacked by input rows
  const float* b_branch;  // [nb, 128]
  const float* w_fc;      // [nb * 128, 256] actor_fc | critic_fc
  const float* b_fc;      // [256]
  const float* w_aout;    // [128, A]
  const float* b_aout;    // [A]
  const float* w_cout;    // [128]
  const float* b_cout;    // [1]
  const float* noise;     // [N, A] Gumbel noise, or null for the plain argmax
  float* logits;          // [N, A]
  float* value;           // [N]
  int32_t* action;        // [N], or null in training mode
  float* log_prob;        // [N], or null in training mode
  float* feats;           // [N, nb * 128] branch features, or null (training mode)
  float* hidden;          // [N, 256] fc outputs before the residual, or null
  int32_t n_lanes, ldx, A;
  int32_t num_branches;        // nb: 10 or 11
  int32_t branch_off[kMaxNB + 1];
  int32_t av_off;              // column of the action values (the prior's input)
  float av_prior;              // beta; 0 for no prior
};

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

__global__ void __launch_bounds__(kThreads, 1)
actor_critic_kernel(const ActorCriticArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;              // [kBK][kPad]   observation tile, transposed
  float* Bs = As + kAsFloats;    // [kBK][256]    weight tile
  float* Fs = Bs + kBsFloats;    // [kH][kPad]    branch features, transposed
  float* Cs = Fs + kFsFloats;    // [kBM][kH]     cond features (residual)
  float* Ls = Cs + kCsFloats;    // [kBM][kOut]   logits and value
  float* Hs = Bs;                // [kBM][kHS]    fc outputs, over Bs + Fs at the end

  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int row0 = blockIdx.x * kBM;

  float acc2[8][8];  // fc pre-activations: lanes ty*8+i, columns tx+32j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[i][j] = 0.f;

  for (int b = 0; b < a.num_branches; ++b) {
    const int off = a.branch_off[b], in_b = a.branch_off[b + 1] - off;

    // ---- branch layer: feats_b[64, 128] = x[:, off:off+in_b] @ W_b ----
    float acc1[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc1[i][j] = 0.f;
    for (int k0 = 0; k0 < in_b; k0 += kBK) {
#pragma unroll
      for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
        const int e = tid + kThreads * i, m = e >> 5, k = e & 31;
        const int row = row0 + m, kk = k0 + k;
        As[k * kPad + m] = (row < a.n_lanes && kk < in_b)
                               ? a.x[(size_t)row * a.ldx + off + kk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < (kBK * kH) / (4 * kThreads); ++i) {
        const int e = 4 * (tid + kThreads * i), k = e >> 7, n = e & (kH - 1);
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + k < in_b)
          w = *reinterpret_cast<const float4*>(a.w_branch + (size_t)(off + k0 + k) * kH + n);
        *reinterpret_cast<float4*>(Bs + k * (2 * kH) + n) = w;
      }
      __syncthreads();
      const int kmax = min(kBK, in_b - k0);
      for (int k = 0; k < kmax; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(As + k * kPad + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(As + k * kPad + ty * 8 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k * (2 * kH) + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(av[i], bv[j], acc1[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 32 * j;
        const float f = leaky(acc1[i][j] + a.b_branch[b * kH + n]);
        Fs[n * kPad + m] = f;
        if (b == kCond) Cs[m * kH + n] = f;
        if (a.feats && row0 + m < a.n_lanes)
          a.feats[(size_t)(row0 + m) * (a.num_branches * kH) + b * kH + n] = f;
      }
    }
    __syncthreads();

    // ---- fold into the fc layers: acc2 += feats_b @ W_fc[128b : 128b+128] ----
    for (int k0 = 0; k0 < kH; k0 += kBK) {
#pragma unroll
      for (int i = 0; i < (kBK * 2 * kH) / (4 * kThreads); ++i) {
        const int e = 4 * (tid + kThreads * i), k = e >> 8, n = e & (2 * kH - 1);
        *reinterpret_cast<float4*>(Bs + k * (2 * kH) + n) = *reinterpret_cast<const float4*>(
            a.w_fc + (size_t)(b * kH + k0 + k) * (2 * kH) + n);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        const float* fk = Fs + (k0 + k) * kPad + ty * 8;
        const float4 a0 = *reinterpret_cast<const float4*>(fk);
        const float4 a1 = *reinterpret_cast<const float4*>(fk + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[k * (2 * kH) + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(av[i], bv[j], acc2[i][j]);
      }
      __syncthreads();
    }
  }

  // ---- fc activations plus the cond residual ----
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 32 * j;
      const float h = leaky(acc2[i][j] + a.b_fc[n]);
      Hs[m * kHS + n] = h + Cs[m * kH + (n & (kH - 1))];
      if (a.hidden && row0 + m < a.n_lanes) a.hidden[(size_t)(row0 + m) * (2 * kH) + n] = h;
    }
  }
  __syncthreads();

  // ---- heads: logits [64, A] from the actor half, value from the critic half ----
  {
    const int m = tid >> 2;
    for (int o = tid & 3; o <= a.A; o += 4) {
      float s = 0.f;
      if (o < a.A) {
        for (int k = 0; k < kH; ++k) s = fmaf(Hs[m * kHS + k], a.w_aout[k * a.A + o], s);
        s += a.b_aout[o];
      } else {
        for (int k = 0; k < kH; ++k) s = fmaf(Hs[m * kHS + kH + k], a.w_cout[k], s);
        s += a.b_cout[0];
      }
      Ls[m * kOut + o] = s;
    }
  }
  __syncthreads();

  // ---- epilogue: the prior, log_softmax and the first-index argmax of logits + noise ----
  if (tid < kBM) {
    const int row = row0 + tid;
    if (row < a.n_lanes) {
      float* l = Ls + tid * kOut;
      if (a.av_prior != 0.f) {
        const float* av = a.x + (size_t)row * a.ldx + a.av_off;
        float mean = 0.f;
        for (int o = 0; o < a.A; ++o) mean += av[o];
        mean = mean / (float)a.A;
        float var = 0.f;
        for (int o = 0; o < a.A; ++o) var += (av[o] - mean) * (av[o] - mean);
        const float sd = sqrtf(var / (float)a.A) + 1e-6f;
        for (int o = 0; o < a.A; ++o) l[o] = l[o] + a.av_prior * ((av[o] - mean) / sd);
      }
      float mx = l[0];
      for (int o = 1; o < a.A; ++o) mx = fmaxf(mx, l[o]);
      float se = 0.f;
      for (int o = 0; o < a.A; ++o) se += expf(l[o] - mx);
      const float lse = logf(se);
      int best = 0;
      float best_s = a.noise ? l[0] + a.noise[(size_t)row * a.A] : l[0];
      for (int o = 1; o < a.A; ++o) {
        const float s = a.noise ? l[o] + a.noise[(size_t)row * a.A + o] : l[o];
        if (s > best_s) { best_s = s; best = o; }
      }
      for (int o = 0; o < a.A; ++o) a.logits[(size_t)row * a.A + o] = l[o];
      a.value[row] = l[a.A];
      if (a.action) {
        a.action[row] = best;
        a.log_prob[row] = (l[best] - mx) - lse;
      }
    }
  }
}

extern "C" int actor_critic_launch(const ActorCriticArgs* args, void* stream) {
  // above 48 KB of dynamic shared memory needs the opt-in (for the current device)
  const cudaError_t e = cudaFuncSetAttribute(
      actor_critic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (args->n_lanes + kBM - 1) / kBM;
  if (blocks > 0) {
    actor_critic_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
