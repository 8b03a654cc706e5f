// K10: the MANSY actor-critic backward, every parameter gradient in f32.
//
// Replaces what jax.grad derives from the JAX package's
// models/abr_nets.py:_branch, MansyFeatureNet and MansyActorCritic.__call__
// (:105-186) in the PPO, BC and DAgger updates (rl/ppo.py:163,
// rl/bc.py:39, rl/dagger.py:133), and from SimpleActorCritic.__call__
// (:206-231) in the A2C update (rl/a2c.py:88).  The plain PyTorch version is
// kernels/actor_critic.py:actor_critic_backward_plain.  It reads the
// activations K3's training mode saved (the branch features F [B, nb x H]
// and the fc outputs Hf [B, 2H], both after LeakyReLU; H is the hidden
// width, any H >= 1) and takes each
// LeakyReLU's derivative from the sign of its output (1 where it is >= 0,
// as jax.nn.leaky_relu's where(x >= 0, ...) gives it, else 0.01).
//
// With y = Hf + [cond, cond] (the heads' inputs; cond is branch `cond`, 9 in
// the MANSY net; the simple_rl net has none, cond = -1, and then y = Hf and
// no block gets the residual's gradient):
//   dW_aout = y_a^T dlogits, dW_cout = y_c^T dvalue, their biases the sums;
//   dPre_fc = [dlogits W_aout^T, dvalue W_cout^T] * leaky'(Hf);
//   dW_fc = F^T dPre_fc [nb x H, 2H], db_fc its column sums;
//   dPre_b = (dPre_fc W_fc^T + the residual's dy_a + dy_c on branch 9's
//   columns) * leaky'(F);
//   dW_branch[off_b : off_b+1] = x[:, off_b : off_b+1]^T dPre_b[:, Hb : Hb+H]
//   (K3's compact block-diagonal layout), db_branch the column sums.
// The logit prior has no parameters and the action values are data, so it
// adds nothing here.
//
// Bound: operations.  Nearly all of the work is two dense products of
// 2 B (nb H) 2H operations each, dPre_b (depth 2H) and dW_fc (depth B),
// plus the branch weights (2 B 748 H); 6.8 GFLOP at B = 4096 with 11
// branches and H = 128, four times that at H = 256.  Every product runs on the tensor cores in 3xTF32 (the hi/lo
// split and mma.sync.m16n8k8 of common.cuh, as K3): three TF32 products
// (495 TFLOP/s) keep f32 accuracy, where f32 outside the tensor cores has
// 67 TFLOP/s.  The tensor cores' f32 accumulation does not round to
// nearest, so each stage's products (16 or 32 deep) go into zeroed
// accumulators, which are added to the running sums with rounded f32 adds.
// Two launches:
//   A. dpre_kernel, one CTA a 32-row tile and a run of its H-column
//      blocks (a branch each; the wrapper splits the blocks into `groups`
//      so that the CTAs fill the card): the head while the first W_fc
//      stages land (dPre_fc for its rows from W_aout^T and the dlogits rows
//      staged in shared memory, split into TF32 hi and lo once for every
//      stage and warp), then dPre_b block by block, W_fc read transposed
//      from [n][k] stages; the residual's gradient (recomputed as the head
//      computes it) and leaky' in the epilogue.  The CTAs of group 0 also
//      write y and dPre_fc.  At H = 256 its shared memory (dPre_fc's
//      hi and lo [32][516] each, the head, three W_fc stages [256][20]) is
//      212 KB, one CTA an SM.
//   B. grad_kernel, every product whose depth is the batch (dW_fc, the
//      branch weights, the two head weights) as 64 x 128 output tiles; the
//      left operand (F, x, y) is read transposed from [k][m] stages.  A ones
//      row below each product's last row of A gives its bias gradient, the
//      column sums, in the same products.  Its tiles do not depend on H;
//      at H = 256 there are more of them.  The depth is cut into `slices`
//      CTAs of one thread-block cluster; after a cluster barrier each CTA
//      sums a share of the tile's rows over the slices' partial tiles in
//      rank order, from the cluster's shared memory.
// Widths: launch A is a template on a capacity kH (64, 128, 192 or 256) and
// H runs in the smallest instance that holds it, as K3's kernel does
// (csrc/actor_critic.cu:instance_of): W_fc's rows past H and columns past 2H
// load as zeros, dPre_fc's columns past 2H are 0, and no gradient column
// past H is written; a width equal to its instance's capacity runs the exact
// instance (kExact: H constant, no masks), the code before the widths were
// made runtime (the same bits and times).  Launch B's products take their
// sizes at run time.  Past 256 launch A's dPre_fc tile does not fit (hi and
// lo [32][2H + 4] each, 263 KB at H = 512), so the wide variant splits it in
// two: a thread an entry of the head (y and dPre_fc), then dPre_b = dPre_fc
// W_fc^T in 64 x 128 tiles (csrc/actor_critic_wide.cuh, W_fc read
// transposed) with the residual's gradient and leaky' in the epilogue;
// launch B as at any width.
// No atomics: every sum has a fixed order and a run repeats bit for bit.
// Operands stream in with cp.async through rings of stages (16-byte copies
// where the rows allow, else 4-byte: x's rows are 779 or 795 floats).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "actor_critic_wide.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;
namespace wide = mansy::wide;
using namespace mansy::tc;

namespace {

constexpr int kMaxNB = 11;     // branches: 10, or 11 with action values (5: simple)
constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // k rows a pipeline stage
// launch A: 32-row tiles, one H-column block at a time
constexpr int kRowsA = 32;
constexpr int kBKA = 16;       // k rows a launch-A stage
constexpr int kStagesA = 3;    // two stages in flight while one is multiplied
constexpr int kMaxA = 16;      // actions the head stages (A <= 15)
constexpr int kWS = kBKA + 4;  // W_fc stage               [kH n][kWS]

// Launch A's layout in the instance of capacity kH (64, 128, 192 or 256).
template <int kH>
struct DimsA {
  static constexpr int kF = 2 * kH;          // fc width: actor_fc | critic_fc
  static constexpr int kPS = kF + 4;         // dPre_fc, TF32 hi and lo  [kRowsA][kPS] each
  static constexpr int kJ = kH / 64;         // 8-column tiles a warp owns of a block
  // W_aout^T [16][H] and the dlogits rows [32][16]
  static constexpr int kHeadFloats = kMaxA * kH + kRowsA * kMaxA;
  static constexpr int kSmem =
      (2 * kRowsA * kPS + kHeadFloats + kStagesA * kH * kWS) * (int)sizeof(float);
  static constexpr int kMinBlocks = 2 * kSmem + 2048 <= 228 * 1024 ? 2 : 1;  // CTAs an SM
};
static_assert(DimsA<64>::kMinBlocks == 2 && DimsA<128>::kMinBlocks == 2, "two CTAs an SM");
static_assert(DimsA<192>::kSmem + 1024 <= 227 * 1024 && DimsA<256>::kSmem + 1024 <= 227 * 1024,
              "the H100's shared memory a block");
// launch B: 64 x 128 output tiles
constexpr int kBM = 64, kBN = 128;
constexpr int kStagesB = 4;    // three stages in flight while one is multiplied
constexpr int kAS = kBM + 8;   // A stage      [kBK k][kAS]
constexpr int kBS = kBN + 8;   // B stage      [kBK k][kBS]
constexpr int kSlotB = kBK * kAS + kBK * kBS;
constexpr int kOS = kBN + 4;   // partial tile [kBM][kOS], over the ring
constexpr int kSmemB = kStagesB * kSlotB * (int)sizeof(float);
constexpr int kMaxSlices = 8;  // the portable cluster size
constexpr int kMaxProducts = kMaxNB + 3;  // dW_fc, the branches, the two heads
static_assert(kBM * kOS <= kStagesB * kSlotB, "the partial tile fits over the ring");
static_assert(2 * kSmemB + 2048 <= 228 * 1024, "two CTAs an SM");

}  // namespace

// Field order must match kernels/actor_critic.py:_ActorCriticBackwardArgs.
struct ActorCriticBackwardArgs {
  const float* x;        // [B, ldx] packed observations
  const float* feats;    // [B, nb * H] branch features (K3 training mode)
  const float* hidden;   // [B, 2H] fc outputs before the residual
  const float* w_fc;     // [nb * H, 2H]
  const float* w_aout;   // [H, A]
  const float* w_cout;   // [H]
  const float* dlogits;  // [B, A]
  const float* dvalue;   // [B]
  float* y;              // scratch [B, 2H]: the heads' inputs
  float* dpre_fc;        // scratch [B, 2H]
  float* dpre_b;         // scratch [B, nb * H]
  float* dw_branch;      // [branch_off[nb], H]
  float* db_branch;      // [nb, H]
  float* dw_fc;          // [nb * H, 2H]
  float* db_fc;          // [2H]
  float* dw_aout;        // [H, A]
  float* db_aout;        // [A]
  float* dw_cout;        // [H]
  float* db_cout;        // [1]
  int32_t B, ldx, A, num_branches;
  int32_t hidden_dim;    // H >= 1
  int32_t groups;        // launch A: CTAs a row tile, each a run of its column blocks
  int32_t slices;        // launch B: depth slices of an output tile (its cluster's CTAs)
  int32_t branch_off[kMaxNB + 1];
  int32_t cond;          // the cond branch (the residual); -1: none
};

// C[m, n] = sum over the batch k of A(m, k) B(k, n), with A(m, k) = a[k lda + m]
// (columns of a row-major [B, *] tensor, read transposed) and B(k, n) =
// b[k ldb + n]; C[m, n] at c[m ldc + n].  With `bias`, A's row M is ones, so
// row M of the product, sum_k B(k, n), goes to bias[n].
struct Product {
  const float* a;
  const float* b;
  float* c;
  float* bias;
  int32_t M, N, lda, ldb, ldc;
  int32_t vec_a, vec_b;  // 16-byte copies: address, ld and width multiples of 4 floats
  int32_t first_tile;    // output tiles of the products before this one
  int32_t n_tiles;       // its tiles across N
};

struct Products {
  Product p[kMaxProducts];
  int32_t count, B, slices;
};

__device__ __forceinline__ float leaky_grad(float out, float g) { return out >= 0.f ? g : 0.01f * g; }

// dy_a[m, n] = sum_o dlogits[m, o] W_aout[n, o], o in order, from the staged
// dlogits rows ds [32][16] and W_aout^T ws [16][H]
template <int kH>
__device__ __forceinline__ float head_dya(const float* ds, const float* ws, int m, int n, int A) {
  float dya = 0.f;
#pragma unroll
  for (int o = 0; o < kMaxA; ++o)
    if (o < A) dya = fmaf(ds[m * kMaxA + o], ws[o * kH + n], dya);
  return dya;
}

// The A fragment of rows g (+8), columns t (+4) at p of a row-major tile
// already split into TF32 hi and lo (lane = 4g + t).
__device__ __forceinline__ void load_a_split(const uint32_t* hp, const uint32_t* lp, int stride,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int at[4] = {0, 8 * stride, 4, 8 * stride + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = hp[at[i]];
    lo[i] = lp[at[i]];
  }
}

template <int kH, bool kExact>
__global__ void __launch_bounds__(kThreads, DimsA<kH>::kMinBlocks)
dpre_kernel(const __grid_constant__ ActorCriticBackwardArgs a, int vec_wfc) {
  constexpr int kPS = DimsA<kH>::kPS, kJ = DimsA<kH>::kJ;
  extern __shared__ __align__(16) float smem[];
  uint32_t* Ph = reinterpret_cast<uint32_t*>(smem);  // [kRowsA][kPS] dPre_fc, TF32 hi
  uint32_t* Pl = Ph + kRowsA * kPS;                  // [kRowsA][kPS] and lo
  float* Ws = smem + 2 * kRowsA * kPS;               // [16][kH] W_aout^T, 0 past A
  float* Dl = Ws + kMaxA * kH;                       // [kRowsA][16] dlogits, 0 past A and B
  float* ring = Dl + kRowsA * kMaxA;                 // [kStagesA][kH][kWS] W_fc stages
  const int nb = a.num_branches, H = kExact ? kH : a.hidden_dim;
  const int F = nb * H, F2 = 2 * H, A = a.A;
  const int kKStages = kExact ? 2 * kH / kBKA : (F2 + kBKA - 1) / kBKA;  // stages of one block
  const int per = (nb + a.groups - 1) / a.groups;
  const int group = blockIdx.x % a.groups, row0 = (int)(blockIdx.x / a.groups) * kRowsA;
  const int blk0 = group * per, nblk = min(nb, blk0 + per) - blk0;
  if (nblk <= 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int total = nblk * kKStages;

  // stage c: W_fc rows H (blk0 + c / kKStages) + [0, kH), columns 16 (c %
  // kKStages) + [0, 16); zeros past H rows and 2H columns
  auto load = [&](int c) {
    float* slot = ring + (c % kStagesA) * (kH * kWS);
    const int k0 = (c % kKStages) * kBKA;
    const float* src = a.w_fc + (size_t)((blk0 + c / kKStages) * H) * F2 + k0;
    if (kExact || vec_wfc) {
      for (int e = tid; e < kH * kBKA / 4; e += kThreads) {
        const int n = e / (kBKA / 4), k = 4 * (e % (kBKA / 4));
        const bool ok = kExact || (n < H && k0 + k < F2);
        cp_async16(slot + n * kWS + k, ok ? src + (size_t)n * F2 + k : a.w_fc, ok);
      }
    } else {
      for (int e = tid; e < kH * kBKA; e += kThreads) {
        const int n = e / kBKA, k = e % kBKA;
        const bool ok = n < H && k0 + k < F2;
        cp_async4(slot + n * kWS + k, ok ? src + (size_t)n * F2 + k : a.w_fc, ok);
      }
    }
  };
  for (int c = 0; c < kStagesA - 1; ++c) {
    if (c < total) load(c);
    cp_async_commit();
  }

  // the head while the first stages land: dPre_fc = leaky'(Hf) [dlogits
  // W_aout^T, dvalue W_cout^T], split into TF32 hi and lo once for every
  // stage and warp; rows past B and columns past 2H are 0
  for (int e = tid; e < kMaxA * kH; e += kThreads) {
    const int o = e / kH, n = e % kH;
    Ws[e] = o < A && (kExact || n < H) ? a.w_aout[n * A + o] : 0.f;
  }
  for (int e = tid; e < kRowsA * kMaxA; e += kThreads) {
    const int m = e / kMaxA, o = e % kMaxA;
    Dl[e] = o < A && row0 + m < a.B ? a.dlogits[(size_t)(row0 + m) * A + o] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < kRowsA * H; e += kThreads) {
    const int m = e / H, n = e % H, row = row0 + m;
    float pa = 0.f, pc = 0.f;
    if (row < a.B) {
      const float dya = head_dya<kH>(Dl, Ws, m, n, A);
      const float dyc = a.dvalue[row] * a.w_cout[n];
      const float ha = a.hidden[(size_t)row * F2 + n], hc = a.hidden[(size_t)row * F2 + H + n];
      pa = leaky_grad(ha, dya);
      pc = leaky_grad(hc, dyc);
      if (group == 0) {  // what launch B reads, written once
        const float cond = a.cond >= 0 ? a.feats[(size_t)row * F + a.cond * H + n] : 0.f;
        a.y[(size_t)row * F2 + n] = ha + cond;
        a.y[(size_t)row * F2 + H + n] = hc + cond;
        a.dpre_fc[(size_t)row * F2 + n] = pa;
        a.dpre_fc[(size_t)row * F2 + H + n] = pc;
      }
    }
    split(pa, Ph[m * kPS + n], Pl[m * kPS + n]);
    split(pc, Ph[m * kPS + H + n], Pl[m * kPS + H + n]);
  }
  const int pad = kExact ? 0 : kKStages * kBKA - F2;  // the last stage's columns past 2H
  for (int e = tid; e < kRowsA * pad; e += kThreads) {
    const int m = e / pad, k = F2 + e % pad;
    Ph[m * kPS + k] = Pl[m * kPS + k] = 0u;
  }

  // dPre_b[:, block] = (dPre_fc W_fc[block]^T + dcond on the cond block) *
  // leaky'(F): warp w owns the block's columns (H/8)w .. (H/8)w + H/8 - 1, all 32 rows
  float acc[2][kJ][4] = {};
  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStagesA - 2>();  // stage c has landed
    __syncthreads();                // for every thread, and every thread is done with c - 1
    const float* slot = ring + (c % kStagesA) * (kH * kWS);
    const int s = c % kKStages;
    float part[2][kJ][4] = {};
#pragma unroll
    for (int ks = 0; ks < kBKA; ks += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[kJ][2], blo[kJ][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (16 * i + g) * kPS + s * kBKA + ks + t;
        load_a_split(Ph + at, Pl + at, kPS, ahi[i], alo[i]);
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        load_b_t(slot + (8 * kJ * warp + 8 * j + g) * kWS + ks + t, bhi[j], blo[j]);
      products<2, kJ, kJ>(part, ahi, alo, bhi, blo);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    if (c + kStagesA - 1 < total) load(c + kStagesA - 1);  // into the slot of stage c - 1
    cp_async_commit();
    if (s < kKStages - 1) continue;
    const int b = blk0 + c / kKStages;  // the block is done: its epilogue
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int n = 8 * kJ * warp + 8 * j + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = 16 * i + g + 8 * r, row = row0 + m;
          float v0 = acc[i][j][2 * r], v1 = acc[i][j][2 * r + 1];
          acc[i][j][2 * r] = acc[i][j][2 * r + 1] = 0.f;
          if (row >= a.B) continue;
          if (b == a.cond) {  // the residual's gradient dcond = dy_a + dy_c, as in the head
            const float dv = a.dvalue[row];
            if (kExact || n < H) v0 += head_dya<kH>(Dl, Ws, m, n, A) + dv * a.w_cout[n];
            if (kExact || n + 1 < H) v1 += head_dya<kH>(Dl, Ws, m, n + 1, A) + dv * a.w_cout[n + 1];
          }
          const size_t at = (size_t)row * F + b * H + n;
          if (kExact || (H & 1) == 0) {  // the pair in one 8-byte access
            if (!kExact && n >= H) continue;
            const float2 f = *reinterpret_cast<const float2*>(a.feats + at);
            *reinterpret_cast<float2*>(a.dpre_b + at) = make_float2(leaky_grad(f.x, v0),
                                                                     leaky_grad(f.y, v1));
          } else {
            if (n < H) a.dpre_b[at] = leaky_grad(a.feats[at], v0);
            if (n + 1 < H) a.dpre_b[at + 1] = leaky_grad(a.feats[at + 1], v1);
          }
        }
      }
  }
}

__global__ void __launch_bounds__(kThreads, 2) grad_kernel(const __grid_constant__ Products ps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = ps.slices, rank = (int)cluster.block_rank();
  const int tile = (int)(blockIdx.x / S);
  int j = 0;
  while (j + 1 < ps.count && tile >= ps.p[j + 1].first_tile) ++j;
  const Product& p = ps.p[j];
  const int m0 = (tile - p.first_tile) / p.n_tiles * kBM;
  const int n0 = (tile - p.first_tile) % p.n_tiles * kBN;
  // this slice's depth, in whole stages; an empty one adds zeros
  const int span = ((ps.B + S - 1) / S + kBK - 1) / kBK * kBK;
  const int kbeg = rank * span, kend = min(ps.B, kbeg + span);
  const int total = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  const int ones = p.bias ? p.M - m0 : -1;  // the ones row in this tile, if in [0, kBM)
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's 32 x 32 of the tile
  const bool busy = m0 + 32 * wm < p.M + (p.bias ? 1 : 0) && n0 + 32 * wn < p.N;

  // stage c: depth rows kbeg + 32c + [0, 32) of A's columns m0 + [0, 64) and
  // B's columns n0 + [0, 128), zero past the batch and the product's edges
  auto load = [&](int c) {
    float* As = smem + (c % kStagesB) * kSlotB;
    float* Bs = As + kBK * kAS;
    const int k0 = kbeg + c * kBK;
    if (p.vec_a) {
      for (int e = tid; e < kBK * kBM / 4; e += kThreads) {
        const int k = e / (kBM / 4), m = 4 * (e % (kBM / 4));
        if (m == ones) {
          *reinterpret_cast<float4*>(As + k * kAS + m) = make_float4(1.f, 0.f, 0.f, 0.f);
          continue;
        }
        const bool ok = k0 + k < kend && m0 + m < p.M;
        cp_async16(As + k * kAS + m, ok ? p.a + (size_t)(k0 + k) * p.lda + m0 + m : p.a, ok);
      }
    } else {
      for (int e = tid; e < kBK * kBM; e += kThreads) {
        const int k = e / kBM, m = e % kBM;
        if (m == ones) {
          As[k * kAS + m] = 1.f;
          continue;
        }
        const bool ok = k0 + k < kend && m0 + m < p.M;
        cp_async4(As + k * kAS + m, ok ? p.a + (size_t)(k0 + k) * p.lda + m0 + m : p.a, ok);
      }
    }
    if (p.vec_b) {
      for (int e = tid; e < kBK * kBN / 4; e += kThreads) {
        const int k = e / (kBN / 4), n = 4 * (e % (kBN / 4));
        const bool ok = k0 + k < kend && n0 + n < p.N;
        cp_async16(Bs + k * kBS + n, ok ? p.b + (size_t)(k0 + k) * p.ldb + n0 + n : p.b, ok);
      }
    } else {
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int k = e / kBN, n = e % kBN;
        const bool ok = k0 + k < kend && n0 + n < p.N;
        cp_async4(Bs + k * kBS + n, ok ? p.b + (size_t)(k0 + k) * p.ldb + n0 + n : p.b, ok);
      }
    }
  };

  float acc[2][4][4] = {};
  for (int c = 0; c < kStagesB - 1; ++c) {
    if (c < total) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStagesB - 2>();  // stage c has landed
    __syncthreads();                // for every thread, and every thread is done with c - 1
    if (busy) {
      const float* As = smem + (c % kStagesB) * kSlotB;
      const float* Bs = As + kBK * kAS;
      float part[2][4][4] = {};
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a_t(As + (ks + t) * kAS + 32 * wm + 16 * i + g, kAS, ahi[i], alo[i]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          load_b(Bs + (ks + t) * kBS + 32 * wn + 8 * jj + g, kBS, bhi[jj], blo[jj]);
        products<2, 4, 4>(part, ahi, alo, bhi, blo);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj][e] += part[i][jj][e];
    }
    if (c + kStagesB - 1 < total) load(c + kStagesB - 1);  // into the slot of stage c - 1
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile goes over it
  float* Os = smem;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(Os + (32 * wm + 16 * i + g + 8 * r) * kOS + 32 * wn + 8 * jj +
                                   2 * t) = make_float2(acc[i][jj][2 * r], acc[i][jj][2 * r + 1]);
  cluster.sync();  // every slice's partial tile is in place

  // CTA `rank` sums its share of the rows over the slices, in rank order
  const int rows = kBM / S, r0 = rank * rows;
  for (int e = tid; e < rows * kBN; e += kThreads) {
    const int m = r0 + e / kBN, n = e % kBN, gm = m0 + m, gn = n0 + n;
    if (gn >= p.N || gm > p.M || (gm == p.M && !p.bias)) continue;
    float sum = 0.f;
    for (int q = 0; q < S; ++q) sum += cluster.map_shared_rank(Os, q)[m * kOS + n];
    if (gm < p.M)
      p.c[(size_t)gm * p.ldc + gn] = sum;
    else
      p.bias[gn] = sum;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ---- the wide variant's launch A (H > 256) ----

// A thread an entry (row, n) of the head: y and dPre_fc, as launch A's head
// computes them.
__global__ void wide_head_kernel(const __grid_constant__ ActorCriticBackwardArgs a) {
  const int H = a.hidden_dim, F2 = 2 * H, A = a.A;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)a.B * H) return;
  const int row = (int)(e / H), n = (int)(e % H);
  float dya = 0.f;
  for (int o = 0; o < A; ++o) dya = fmaf(a.dlogits[(size_t)row * A + o], a.w_aout[n * A + o], dya);
  const float dyc = a.dvalue[row] * a.w_cout[n];
  const float ha = a.hidden[(size_t)row * F2 + n], hc = a.hidden[(size_t)row * F2 + H + n];
  const float cond = a.cond >= 0 ? a.feats[(size_t)row * a.num_branches * H + a.cond * H + n] : 0.f;
  a.y[(size_t)row * F2 + n] = ha + cond;
  a.y[(size_t)row * F2 + H + n] = hc + cond;
  a.dpre_fc[(size_t)row * F2 + n] = leaky_grad(ha, dya);
  a.dpre_fc[(size_t)row * F2 + H + n] = leaky_grad(hc, dyc);
}

// dPre_b's tile (m0, n0) = dPre_fc W_fc^T, plus the residual's gradient on
// the cond branch's columns (dy_a + dy_c, recomputed as the head computes
// them), times leaky'(F).
__global__ void __launch_bounds__(wide::kThreads)
wide_dpre_kernel(const __grid_constant__ ActorCriticBackwardArgs a,
                 const __grid_constant__ wide::Gemms gs) {
  extern __shared__ __align__(16) float smem[];
  int m0, n0;
  const wide::Gemm& p = wide::locate(gs, (int)blockIdx.x, m0, n0);
  float acc[2][4][4];
  wide::gemm_tile<true>(p, m0, n0, smem, acc);
  const int H = a.hidden_dim, F = a.num_branches * H, A = a.A;
  wide::for_each(acc, [&](int m, int n, float v) {
    const int row = m0 + m, col = n0 + n;
    if (row >= a.B || col >= F) return;
    if (col / H == a.cond) {
      const int c = col - a.cond * H;
      float dya = 0.f;
      for (int o = 0; o < A; ++o)
        dya = fmaf(a.dlogits[(size_t)row * A + o], a.w_aout[c * A + o], dya);
      v += dya + a.dvalue[row] * a.w_cout[c];
    }
    const size_t at = (size_t)row * F + col;
    a.dpre_b[at] = leaky_grad(a.feats[at], v);
  });
}

namespace {

bool vectorizable(const float* p, int ld, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 && width % 4 == 0;
}

// Appends a product (its tiles after the tiles so far); returns the new tile count.
int add_product(Products& ps, int tiles, const float* a, int lda, int M, const float* b, int ldb,
                int N, float* c, int ldc, float* bias) {
  Product& p = ps.p[ps.count++];
  p = Product{a, b, c, bias, M, N, lda, ldb, ldc, vectorizable(a, lda, M), vectorizable(b, ldb, N),
              tiles, (N + kBN - 1) / kBN};
  return tiles + (M + (bias ? 1 : 0) + kBM - 1) / kBM * p.n_tiles;
}

}  // namespace

namespace {

// Launch A in the instance kH (exact: H = kH).
template <int kH, bool kExact>
cudaError_t launch_dpre_as(const ActorCriticBackwardArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(dpre_kernel<kH, kExact>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       DimsA<kH>::kSmem);
  if (e != cudaSuccess) return e;
  const int vec_wfc = wide::aligned16(a.w_fc) && a.hidden_dim % 2 == 0;
  dpre_kernel<kH, kExact>
      <<<(a.B + kRowsA - 1) / kRowsA * a.groups, kThreads, DimsA<kH>::kSmem, s>>>(a, vec_wfc);
  return cudaGetLastError();
}

template <int kH>
cudaError_t launch_dpre(const ActorCriticBackwardArgs& a, cudaStream_t s) {
  return a.hidden_dim == kH ? launch_dpre_as<kH, true>(a, s) : launch_dpre_as<kH, false>(a, s);
}

constexpr int kWideSmem = wide::Layout<true>::kSmemBytes;

// The wide variant's launch A: the head, then dPre_b's tiles.
cudaError_t launch_dpre_wide(const ActorCriticBackwardArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(wide_dpre_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (e != cudaSuccess) return e;
  const int H = a.hidden_dim, F = a.num_branches * H;
  const size_t entries = (size_t)a.B * H;
  wide_head_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wide::Gemms gs{};
  const int tiles = wide::add(gs, 0, a.dpre_fc, 2 * H, a.w_fc, 2 * H, a.B, F, 2 * H, true, 0);
  wide_dpre_kernel<<<tiles, wide::kThreads, kWideSmem, s>>>(a, gs);
  return cudaGetLastError();
}

// The smallest launch-A instance that holds hidden width H: 64, 128, 192
// or 256; 0 for the wide variant past 256 (csrc/actor_critic.cu's).
int instance_of(int H) {
  return H <= 64 ? 64 : H <= 128 ? 128 : H <= 192 ? 192 : H <= 256 ? 256 : 0;
}

}  // namespace

// The instance that runs hidden width `hidden` (0: the wide variant).
extern "C" int actor_critic_backward_instance(int hidden) { return instance_of(hidden); }

// Launch A's dynamic shared memory a CTA at hidden width `hidden` (its
// instance's, or the wide variant's tile kernel's), and launch B's.
extern "C" int actor_critic_backward_smem_bytes(int hidden, int* launch_b) {
  *launch_b = kSmemB;
  switch (instance_of(hidden)) {
    case 64: return DimsA<64>::kSmem;
    case 128: return DimsA<128>::kSmem;
    case 192: return DimsA<192>::kSmem;
    case 256: return DimsA<256>::kSmem;
    default: return kWideSmem;
  }
}

extern "C" int actor_critic_backward_launch(const ActorCriticBackwardArgs* args, void* stream) {
  const ActorCriticBackwardArgs& a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int B = a.B, A = a.A, nb = a.num_branches, S = a.slices;
  const int H = a.hidden_dim, F = nb * H, F2 = 2 * H;
  if (nb > kMaxNB || nb < 1 || a.cond < -1 || a.cond >= nb || A > kMaxA || a.groups < 1 ||
      a.groups > nb || S < 1 || S > kMaxSlices || (S & (S - 1)) != 0 || H < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemB);
  if (e != cudaSuccess) return (int)e;
  switch (instance_of(H)) {
    case 64: e = launch_dpre<64>(a, s); break;
    case 128: e = launch_dpre<128>(a, s); break;
    case 192: e = launch_dpre<192>(a, s); break;
    case 256: e = launch_dpre<256>(a, s); break;
    default: e = launch_dpre_wide(a, s);
  }
  if (e != cudaSuccess) return (int)e;

  // depth B: dW_fc = F^T dPre_fc, dW_branch[off_b : off_b+1] =
  // x[:, off_b : off_b+1]^T dPre_b[:, Hb : Hb+H], dW_aout = y_a^T dlogits,
  // dW_cout = y_c^T dvalue, each with its bias as the ones row
  Products ps{};
  int tiles = add_product(ps, 0, a.feats, F, F, a.dpre_fc, F2, F2, a.dw_fc, F2, a.db_fc);
  for (int b = 0; b < nb; ++b) {
    const int off = a.branch_off[b];
    tiles = add_product(ps, tiles, a.x + off, a.ldx, a.branch_off[b + 1] - off, a.dpre_b + b * H,
                        F, H, a.dw_branch + (size_t)off * H, H, a.db_branch + b * H);
  }
  tiles = add_product(ps, tiles, a.y, F2, H, a.dlogits, A, A, a.dw_aout, A, a.db_aout);
  tiles = add_product(ps, tiles, a.y + H, F2, H, a.dvalue, 1, 1, a.dw_cout, 1, a.db_cout);
  ps.B = B;
  ps.slices = S;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemB;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, grad_kernel, ps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
