// K3: MANSY actor-critic forward with its action head, in f32.
//
// Replaces the JAX package's XLA-fused models/abr_nets.py:_branch,
// MansyFeatureNet and MansyActorCritic.__call__ (:105-186), and
// SimpleActorCritic.__call__ (:206-231), plus the action head of
// rl/rollout.py:52-54 and rl/runner.py:123-126 (log_softmax and the
// first-index argmax of logits + Gumbel noise).  The plain PyTorch version
// is kernels/actor_critic.py:actor_critic_forward_plain.
//
// Per lane, at hidden width H (any H >= 1): 10 branch dense layers (748 -> 10 x H,
// block-diagonal), or 11 with the action-value branch (764 -> 11 x H), with
// LeakyReLU(0.01); actor_fc and critic_fc (10 or 11 x H -> 2 x H) with
// LeakyReLU; the "+ cond" residual (branch `cond`, 9); actor_out (H -> A) and
// critic_out (H -> 1); the optional action-value logit prior
// beta * (av - mean) / (std + 1e-6) (population std, abr_nets.py:176-180);
// log_softmax and argmax.  About 0.85 MFLOP a lane at H = 128 (0.94 with 11
// branches), 3.0 at H = 256.  The simple_rl net (cond = -1) is the same
// network without the residual: 5 branches (395 -> 5 x 128), fc and heads,
// about 0.42 MFLOP a lane.
//
// Widths: the fused kernel below is a template on a capacity kH (64, 128,
// 192 or 256: the warps own 8-column tiles of the kH / 8 columns each, so
// kH is a multiple of 64), and H, a runtime argument, runs in the smallest
// instance that holds it (instance_of; H = 32 pads up to 64).  Inside, the
// columns past H are zero: the W_b and W_fc columns and W_fc rows past H
// load as zeros (cp.async with a zero source size; 4-byte copies where a
// row of H or 2H floats is not 16-byte aligned), the bias past H is 0, so
// the padded features are leaky(0) = 0 and add +0 terms to the fc sums,
// which leaves the real columns' f32 sums as an unpadded kernel's; stores
// stop at H.  A unit's fc stages cover only its real feature rows.  A
// width equal to its instance's capacity runs the exact instance (kExact:
// H is the constant kH, no masks), the code of the width-128 and width-256
// kernels before the widths were made runtime (the same bits and times).  Past 256 the fused
// kernel's ring does not fit (five 16-row W_fc stages are 330 KB at H =
// 512), so a wide variant runs in three launches, each sum in a fixed
// order (csrc/actor_critic_wide.cuh): the branch products, tiles of 64 rows
// x 128 columns, into feats [N, nb H]; the fc product in the same tiles,
// with the bias, LeakyReLU, residual and each tile's partial logits and
// value into a scratch [2H / 128][N][16]; then a thread a row sums the
// partials in column-tile order and runs the action head.
//
// Training mode (feats and hidden given, kernels/actor_critic.py:
// actor_critic_train_forward): no noise and no action head; it also writes
// what the backward (csrc/actor_critic_backward.cu, K10) reads, the branch
// features after LeakyReLU [N, nb x H] and the fc outputs after LeakyReLU,
// before the residual [N, 2H].  K10 takes each LeakyReLU's derivative from
// the sign of its output, so nothing is recomputed.
//
// Bound: operations.  At 8192 lanes the forward is ~7 GFLOP against ~26 MB
// of inputs.  The products run on the tensor cores in 3xTF32: each operand
// is split into a TF32 high part and a TF32 remainder, and hi*lo + lo*hi +
// hi*hi is summed into f32 accumulators (mma.sync.m16n8k8), which keeps
// f32 accuracy (the JAX reference's "highest" precision); plain TF32 would
// keep ~3 digits.  So the work is three TF32 products (495 TFLOP/s) or, in
// f32 outside the tensor cores, one product (67 TFLOP/s).
//
// Design: the work of a 32-row tile is split across a thread-block cluster
// of G CTAs, and G follows from N (make_plan) so that the paths' widths fill
// the card: each candidate's time is estimated as its waves (from the
// clusters the card holds at once, by its own occupancy query) times the
// longest walk of a CTA in pipeline stages, plus a share for each CTA's
// barriers and reduction.  At the serve and PPO widths (512 rows) every CTA
// is one "unit": a branch, or one half of the inputs of a branch with more
// than 128 of them (next_chunk_size and next_chunk_quality, 320 each), so
// no CTA walks more than 14 stages, in clusters of 12 (13 with the
// action-value branch, which take two waves at 512 rows, so there 6 CTAs of
// whole branches win).  At wider N the CTAs take whole branches, several
// each, placed longest first onto the least-loaded CTA, down to 2 CTAs a
// tile at 4096 rows and one CTA a tile that walks every branch at
// collect's 8192 lanes, where the card is full anyway and a cluster's
// barriers and exchange would only add work.
//
// A unit multiplies its x columns by its W_b rows into the branch's H
// pre-activations; a whole branch adds its bias and LeakyReLU at once
// (feats_b), while the two halves of a split branch put theirs in shared
// memory, meet at the first half of a cluster barrier, and each sums both
// for half of the feature columns (part 0's first), then the bias and
// LeakyReLU.  A unit then multiplies its feature columns [n0, n0 + nw) by
// W_fc's rows Hb + n0 .. and adds them into its CTA's partial fc product
// P_r [32, 2H], unit after unit in a fixed order (the cond branch last, so
// its features stay in shared memory).  The tensor cores' f32 accumulation
// does not round to nearest, so a long chain of products drifts (4e-5 over
// the 1280 rows of W_fc): each 16-row stage's products go into zeroed
// accumulators, which are added to the running sums (the pre-activations in
// shared memory, P_r in registers) with rounded f32 adds.  At kH = 256 the
// same ring (five stages of 16 W_fc rows of 512 columns, 166 KB) and the
// feature tile (33 KB) leave one CTA an SM (at 192 too), and each warp owns
// twice the columns of every product.  The x and weight
// tiles stream in with cp.async through one ring of five 16-row stages that
// every product of the CTA shares (four in flight while one is multiplied),
// located by a schedule of the CTA's units in shared memory, and each warp
// issues its products term by term over its independent accumulator tiles,
// so the tensor cores' latency overlaps.  After a cluster barrier, each CTA
// owns a slice of the 256 fc columns and sums P_0 .. P_{G-1} for it from
// the cluster's shared memory in rank order (no atomics: every run gives
// the same bits), adds the bias, the LeakyReLU and the cond residual
// (the cond branch's features, read from its CTA; none in the simple_rl
// net), and multiplies its slice by
// the heads' rows into partial logits and value, which it stores into CTA
// 0's shared memory.  After a second barrier CTA 0 sums those partials in
// rank order and runs the epilogue: the prior, log_softmax and the
// first-index argmax of logits + noise.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "actor_critic_wide.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;
namespace wide = mansy::wide;
using namespace mansy::tc;

namespace {

constexpr int kMaxNB = 11;     // feature-net branches: 10, or 11 with action values (5: simple)
constexpr int kMaxUnits = 16;  // CTAs a cluster may have (the non-portable maximum)
constexpr int kMaxDevices = 16;
constexpr int kBM = 32;        // rows a tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 16;        // k rows a pipeline stage
constexpr int kStages = 5;     // ring slots: four stages in flight while one is multiplied
constexpr int kOut = 16;       // logits (A <= 15) and the value
constexpr int kXS = kBK + 4;   // x stage [kBM][kXS] (floats; padded so fragment reads hit 32 banks)
constexpr int kXsFloats = kBM * kXS;  // a branch stage: the x tile, then the W_b rows

// The layout of the instance of capacity kH (64, 128, 192 or 256).
template <int kH>
struct Dims {
  static constexpr int kF = 2 * kH;     // fc width: actor_fc | critic_fc
  static constexpr int kSplitIn = kH;   // a branch with more inputs may be two units (input halves)
  // row strides (floats), padded so the warps' fragment reads hit 32 banks
  static constexpr int kWBS = kH + 8;   // W_b stage      [kBK][kWBS]
  static constexpr int kWFS = kF + 8;   // W_fc stage     [kBK][kWFS]
  static constexpr int kFS = kH + 4;    // features       [kBM][kFS]
  static constexpr int kPS = kF + 4;    // partial fc     [kBM][kPS]
  static constexpr int kJB = kH / 64;   // 8-column tiles a warp owns of a branch product
  static constexpr int kJF = kF / 64;   // and of the fc product
  static constexpr int kSlotFloats = kXsFloats + kBK * kWBS > kBK * kWFS ? kXsFloats + kBK * kWBS
                                                                         : kBK * kWFS;
  // over the ring once the products are done: P_r, CTA 0's partial heads
  // [G][kBM][kOut], and this CTA's fc outputs + residual [kBM][ceil(kF / G) +
  // 1], which CTA 0's logits tile [kBM][kOut] then takes
  static constexpr int over_ring(int g) {
    return kBM * kPS + g * kBM * kOut + kBM * ((kF + g - 1) / g + 1 > kOut ? (kF + g - 1) / g + 1
                                                                           : kOut);
  }
  static constexpr int most_over_ring() {
    int most = 0;
    for (int g = 1; g <= kMaxUnits; ++g) most = over_ring(g) > most ? over_ring(g) : most;
    return most;
  }
  // the ring, or what goes over it where that is more (at kH = 64)
  static constexpr int kRingFloats =
      kStages * kSlotFloats > most_over_ring() ? kStages * kSlotFloats : most_over_ring();
  static constexpr int kFsFloats = kBM * kFS;
  static constexpr int kSmemBytes = (kRingFloats + kFsFloats) * (int)sizeof(float);
  static constexpr int kMinBlocks = 2 * kSmemBytes + 2048 <= 228 * 1024 ? 2 : 1;  // CTAs an SM
};

static_assert(Dims<64>::kSmemBytes + 1024 <= 227 * 1024 &&
              Dims<192>::kSmemBytes + 1024 <= 227 * 1024 &&
              Dims<256>::kSmemBytes + 1024 <= 227 * 1024, "a CTA in the H100's 227 KB");
static_assert(Dims<128>::kRingFloats == kStages * Dims<128>::kSlotFloats &&
              Dims<256>::kRingFloats == kStages * Dims<256>::kSlotFloats,
              "at 128 and 256 everything over the ring fits in it (their layouts as before)");
static_assert(Dims<64>::kMinBlocks == 2 && Dims<128>::kMinBlocks == 2, "two CTAs an SM");

}  // namespace

// Field order must match kernels/actor_critic.py:_ActorCriticArgs.
struct ActorCriticArgs {
  const float* x;         // [N, ldx] packed observations; columns [0, branch_off[nb]) read
  const float* w_branch;  // [branch_off[nb], H] the branch kernels stacked by input rows
  const float* b_branch;  // [nb, H]
  const float* w_fc;      // [nb * H, 2H] actor_fc | critic_fc
  const float* b_fc;      // [2H]
  const float* w_aout;    // [H, A]
  const float* b_aout;    // [A]
  const float* w_cout;    // [H]
  const float* b_cout;    // [1]
  const float* noise;     // [N, A] Gumbel noise, or null for the plain argmax
  float* logits;          // [N, A]
  float* value;           // [N]
  int32_t* action;        // [N], or null in training mode
  float* log_prob;        // [N], or null in training mode
  float* feats;           // [N, nb * H] branch features, or null (training mode; the
                          // wide variant's scratch otherwise)
  float* hidden;          // [N, 2H] fc outputs before the residual, or null
  float* heads;           // the wide variant's scratch [ceil(2H / 128)][N][16], else null
  int32_t n_lanes, ldx, A;
  int32_t num_branches;        // nb: 10 or 11 (5: the simple_rl net)
  int32_t hidden_dim;          // H >= 1
  int32_t branch_off[kMaxNB + 1];
  int32_t av_off;              // column of the action values (the prior's input)
  float av_prior;              // beta; 0 for no prior
  int32_t cond;                // the cond branch, whose features are the residual; -1: none
};

// How a tile's work is split across its cluster (make_plan).
struct Plan {
  int32_t ctas;                  // G: CTAs a tile
  int32_t split;                 // 1: one unit a CTA, the wide branches in input halves
  int32_t cond_cta;              // the CTA whose last unit is the cond branch; -1: none
  int32_t vec_wb, vec_wfc;       // 16-byte copies of W_b's rows (H floats), W_fc's (2H)
  int32_t first[kMaxUnits + 1];  // CTA r runs units unit[first[r]] .. unit[first[r + 1] - 1]
  int32_t unit[kMaxUnits];       // 2 * branch + part
};

// Part `part` of the `parts` of branch b: the x columns off + [k_lo, k_lo +
// k_n), the feature columns [n0, n0 + nw), of which [n0, n_end) are real (<
// H; nw rounds that up to whole stages), n1 stages of the branch product and
// `stages` of both products.
struct Unit {
  int b, parts, part, off, k_lo, k_n, n0, nw, n_end, n1, stages;
};

template <int kH>
__host__ __device__ __forceinline__ int branch_parts(const ActorCriticArgs& a, int b,
                                                     bool split) {
  return split && a.branch_off[b + 1] - a.branch_off[b] > Dims<kH>::kSplitIn ? 2 : 1;
}

template <int kH>
__host__ __device__ __forceinline__ Unit unit_of(const ActorCriticArgs& a, bool split,
                                                 int code) {
  Unit u;
  u.b = code >> 1;
  u.part = code & 1;
  u.parts = branch_parts<kH>(a, u.b, split);
  u.off = a.branch_off[u.b];
  const int in_b = a.branch_off[u.b + 1] - u.off;
  const int k_half = ((in_b + 1) / 2 + kBK - 1) / kBK * kBK;
  u.k_lo = u.part * k_half;
  u.k_n = u.parts == 1 ? in_b : u.part == 0 ? k_half : in_b - k_half;
  // two parts: part 0 the first ceil(H / 2) columns in whole stages, part 1
  // the rest (kH / 2 each at H = kH)
  const int H = a.hidden_dim, h = ((H + 1) / 2 + kBK - 1) / kBK * kBK;
  u.n0 = u.part * h;
  u.n_end = u.parts == 2 && u.part == 0 ? (H < h ? H : h) : H;
  u.nw = u.n_end > u.n0 ? (u.n_end - u.n0 + kBK - 1) / kBK * kBK : 0;
  u.n1 = (u.k_n + kBK - 1) / kBK;
  u.stages = u.n1 + u.nw / kBK;
  return u;
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

// f.x and f.y to entries n and n + 1 (n even) of a row of `width` floats:
// one 8-byte store where the width is even (the row then starts 8-byte
// aligned), else each entry the row holds.
__device__ __forceinline__ void store_pair(float* row, int n, int width, float2 f) {
  if ((width & 1) == 0) {
    if (n < width) *reinterpret_cast<float2*>(row + n) = f;
  } else {
    if (n < width) row[n] = f.x;
    if (n + 1 < width) row[n + 1] = f.y;
  }
}

// The action head of one row from its logits and value l[0 .. A] (the
// biases added): the prior, log_softmax, the first-index argmax of logits +
// noise, and the stores.
__device__ __forceinline__ void finish_row(const ActorCriticArgs& a, int row, float* l) {
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
    const float sc = a.noise ? l[o] + a.noise[(size_t)row * a.A + o] : l[o];
    if (sc > best_s) { best_s = sc; best = o; }
  }
  for (int o = 0; o < a.A; ++o) a.logits[(size_t)row * a.A + o] = l[o];
  a.value[row] = l[a.A];
  if (a.action) {
    a.action[row] = best;
    a.log_prob[row] = (l[best] - mx) - lse;
  }
}

// The two halves of a cluster barrier (cluster.sync() is both): the CTA's
// shared-memory writes before arrive are seen by the cluster after wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int kH, bool kExact>
__global__ void __launch_bounds__(kThreads, Dims<kH>::kMinBlocks)
actor_critic_kernel(const __grid_constant__ ActorCriticArgs a, const __grid_constant__ Plan p) {
  using D = Dims<kH>;
  constexpr int kF = D::kF, kWBS = D::kWBS, kWFS = D::kWFS, kFS = D::kFS, kPS = D::kPS;
  constexpr int kJB = D::kJB, kJF = D::kJF, kSlotFloats = D::kSlotFloats;
  constexpr int kRingFloats = D::kRingFloats;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;              // [kStages][kSlotFloats] the stages of every product
  float* Ps = smem;                // [kBM][kPS] P_r, over the ring once it is done
  float* Fs = smem + kRingFloats;  // [kBM][kFS] the current unit's features

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = p.ctas, rank = (int)cluster.block_rank();
  const bool split_mode = p.split != 0;
  const int u_lo = p.first[rank], u_hi = p.first[rank + 1];
  const int nb = a.num_branches, H = kExact ? kH : a.hidden_dim, F = 2 * H;
  const int row0 = (int)(blockIdx.x / nc) * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  // this CTA's units in turn, and the stage after each one's last
  __shared__ Unit sched[kMaxNB];
  __shared__ int sched_end[kMaxNB];
  const int n_u = u_hi - u_lo;
  if (tid == 0) {
    int end = 0;
    for (int k = 0; k < n_u; ++k) {
      sched[k] = unit_of<kH>(a, split_mode, p.unit[u_lo + k]);
      sched_end[k] = end += sched[k].stages;
    }
  }
  __syncthreads();
  const int total = sched_end[n_u - 1];  // stages of this CTA's units

  // stage c of the CTA (c = 0, 1, 2, ... in turn), stage s of its unit u:
  // s < n1: x columns and W_b rows k_lo + [16s, 16s + 16); else W_fc rows
  // Hb + n0 + [16(s - n1), + 16).  Zeros past H (W_b's and W_fc's columns,
  // W_fc's rows past the unit's real features)
  int k_load = 0;
  auto load = [&](int c) {
    float* slot = ring + (c % kStages) * kSlotFloats;
    while (c >= sched_end[k_load]) ++k_load;
    const Unit& u = sched[k_load];
    const int s = c - (k_load ? sched_end[k_load - 1] : 0);
    if (s < u.n1) {
      const int k0 = u.k_lo + s * kBK, k_end = u.k_lo + u.k_n;
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int m = e / kBK, k = e % kBK;
        const bool ok = row0 + m < a.n_lanes && k0 + k < k_end;
        cp_async4(slot + m * kXS + k,
                  ok ? a.x + (size_t)(row0 + m) * a.ldx + u.off + k0 + k : a.x, ok);
      }
      float* ws = slot + kXsFloats;
      const float* wb = a.w_branch + (size_t)(u.off + k0) * H;
      if (kExact || p.vec_wb) {
        for (int e = tid; e < kBK * kH / 4; e += kThreads) {
          const int k = e / (kH / 4), n = 4 * (e % (kH / 4));
          const bool ok = k0 + k < k_end && (kExact || n < H);
          cp_async16(ws + k * kWBS + n, ok ? wb + (size_t)k * H + n : a.w_branch, ok);
        }
      } else {
        for (int e = tid; e < kBK * kH; e += kThreads) {
          const int k = e / kH, n = e % kH;
          const bool ok = k0 + k < k_end && n < H;
          cp_async4(ws + k * kWBS + n, ok ? wb + (size_t)k * H + n : a.w_branch, ok);
        }
      }
    } else {
      const int r0 = u.n0 + (s - u.n1) * kBK;  // the unit's feature rows of W_fc
      const float* src = a.w_fc + (size_t)(u.b * H + r0) * F;
      if (kExact || p.vec_wfc) {
        for (int e = tid; e < kBK * kF / 4; e += kThreads) {
          const int k = e / (kF / 4), n = 4 * (e % (kF / 4));
          const bool ok = kExact || (r0 + k < u.n_end && n < F);
          cp_async16(slot + k * kWFS + n, ok ? src + (size_t)k * F + n : a.w_fc, ok);
        }
      } else {
        for (int e = tid; e < kBK * kF; e += kThreads) {
          const int k = e / kF, n = e % kF;
          const bool ok = r0 + k < u.n_end && n < F;
          cp_async4(slot + k * kWFS + n, ok ? src + (size_t)k * F + n : a.w_fc, ok);
        }
      }
    }
  };

  // the branch product over a unit's inputs: warp w owns feature columns
  // (H/8)w .. (H/8)w + H/8 - 1 and all 32 rows; P_r += feats[:, n0 : n0 + nw] @
  // W_fc[Hb + n0 : + nw]: warp w owns fc columns (2H/8)w .. + 2H/8 - 1.  A stage's
  // products go into zeroed accumulators, then into the running sums with
  // rounded f32 adds
  float acc2[2][kJF][4] = {};
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < total) load(c);
    cp_async_commit();
  }
  int k_u = 0;  // the current unit
  for (int c = 0; c < total; ++c) {
    if (c == sched_end[k_u]) ++k_u;
    const Unit& u = sched[k_u];
    const int s = c - (k_u ? sched_end[k_u - 1] : 0);
    cp_async_wait<kStages - 2>();  // stage c has landed
    __syncthreads();               // for every thread, and every thread is done with c - 1
    const float* slot = ring + (c % kStages) * kSlotFloats;
    if (s < u.n1) {
      const float* ws = slot + kXsFloats;
      float acc1[2][kJB][4] = {};
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        uint32_t ahi[2][4], alo[2][4], bhi[kJB][2], blo[kJB][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a(slot + (16 * i + g) * kXS + ks + t, kXS, ahi[i], alo[i]);
#pragma unroll
        for (int jj = 0; jj < kJB; ++jj)
          load_b(ws + (ks + t) * kWBS + 8 * kJB * warp + 8 * jj + g, kWBS, bhi[jj], blo[jj]);
        products<2, kJB, kJB>(acc1, ahi, alo, bhi, blo);
      }
      // the unit's pre-activations so far, in Fs (each thread its own
      // entries).  At the last stage, one part: bias and LeakyReLU, feats_b.
      // Two parts: each part's pre-activations stay in its Fs; after the
      // arrive and wait, each part adds both for its feature columns, part
      // 0's first, then the bias and LeakyReLU (the partner reads the other
      // columns meanwhile)
      const int b = u.b;
      const bool last = s == u.n1 - 1;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < kJB; ++jj) {
          const int n = 8 * kJB * warp + 8 * jj + 2 * t;
          const bool bias = last && u.parts == 1;
          const float bias0 = bias && (kExact || n < H) ? a.b_branch[b * H + n] : 0.f;
          const float bias1 = bias && (kExact || n + 1 < H) ? a.b_branch[b * H + n + 1] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int m = 16 * i + g + 8 * r;
            float2* fs = reinterpret_cast<float2*>(Fs + m * kFS + n);
            float2 f = make_float2(acc1[i][jj][2 * r], acc1[i][jj][2 * r + 1]);
            if (s > 0) {
              const float2 sum = *fs;
              f = make_float2(sum.x + f.x, sum.y + f.y);
            }
            if (bias) {
              f = make_float2(leaky(f.x + bias0), leaky(f.y + bias1));
              if (a.feats && row0 + m < a.n_lanes) {
                float* row = a.feats + (size_t)(row0 + m) * (nb * H) + b * H;
                if (kExact)
                  *reinterpret_cast<float2*>(row + n) = f;
                else
                  store_pair(row, n, H, f);
              }
            }
            *fs = f;
          }
        }
      if (last) {
        if (split_mode) cluster_arrive();
        if (u.parts == 2) {
          cluster_wait();
          const float* q0 = cluster.map_shared_rank(Fs, rank - u.part);
          const float* q1 = cluster.map_shared_rank(Fs, rank - u.part + 1);
          for (int e = tid; e < kBM * u.nw; e += kThreads) {
            const int m = e / u.nw, n = u.n0 + e % u.nw;
            const float f = kExact || n < H
                                ? leaky((q0[m * kFS + n] + q1[m * kFS + n]) + a.b_branch[b * H + n])
                                : 0.f;
            Fs[m * kFS + n] = f;
            if ((kExact || n < H) && a.feats && row0 + m < a.n_lanes)
              a.feats[(size_t)(row0 + m) * (nb * H) + b * H + n] = f;
          }
        }
      }
    } else {
      const int k0 = u.n0 + (s - u.n1) * kBK;
      float part[2][kJF][4] = {};
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        uint32_t ahi[2][4], alo[2][4], bhi[kJF][2], blo[kJF][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_a(Fs + (16 * i + g) * kFS + k0 + ks + t, kFS, ahi[i], alo[i]);
#pragma unroll
        for (int jj = 0; jj < kJF; ++jj)
          load_b(slot + (ks + t) * kWFS + 8 * kJF * warp + 8 * jj + g, kWFS, bhi[jj], blo[jj]);
        products<2, kJF, kJF>(part, ahi, alo, bhi, blo);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < kJF; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[i][jj][e] += part[i][jj][e];
    }
    if (c + kStages - 1 < total) load(c + kStages - 1);  // into the slot of stage c - 1
    cp_async_commit();
  }
  if (split_mode && sched[0].parts == 1) cluster_wait();  // the split branches' exchange is done
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: P_r goes over it
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < kJF; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(Ps + (16 * i + g + 8 * r) * kPS + 8 * kJF * warp + 8 * jj +
                                   2 * t) =
            make_float2(acc2[i][jj][2 * r], acc2[i][jj][2 * r + 1]);
  cluster.sync();  // every P_r and the cond features are in place

  // ---- this CTA's fc columns: sum the partials in rank order, bias, LeakyReLU, residual ----
  const int per = (F + nc - 1) / nc, ys = per + 1;
  const int c_lo = rank * per, ncols = max(0, min(per, F - c_lo));
  float* Lp = Ps + kBM * kPS;        // [nc][kBM][kOut] CTA 0: the partial heads
  float* Ys = Lp + nc * kBM * kOut;  // [kBM][ys] this CTA's fc outputs + residual
  const float* cond = p.cond_cta >= 0 ? cluster.map_shared_rank(Fs, p.cond_cta) : nullptr;
  for (int e = tid; e < kBM * ncols; e += kThreads) {
    const int m = e / ncols, jc = e % ncols, col = c_lo + jc;
    float q[kMaxUnits];
#pragma unroll
    for (int r = 0; r < kMaxUnits; ++r)
      q[r] = r < nc ? cluster.map_shared_rank(Ps, r)[m * kPS + col] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxUnits; ++r)
      if (r < nc) sum += q[r];
    const float h = leaky(sum + a.b_fc[col]);
    if (a.hidden && row0 + m < a.n_lanes) a.hidden[(size_t)(row0 + m) * F + col] = h;
    const int fc = kExact ? col & (kH - 1) : col < H ? col : col - H;  // its feature column
    Ys[m * ys + jc] = cond ? h + cond[m * kFS + fc] : h;
  }
  __syncthreads();

  // ---- partial heads over this slice: actor columns -> logits, critic columns -> value ----
  float* lp = cluster.map_shared_rank(Lp, 0) + rank * kBM * kOut;
  const int actor_end = max(0, min(ncols, H - c_lo));  // slice columns [0, actor_end): actor_fc's
  for (int e = tid; e < kBM * kOut; e += kThreads) {
    const int m = e / kOut, o = e % kOut;
    // the head's rows of slice columns [j0, j1): w[(base + jc) * stride]
    const bool actor = o < a.A;
    const int j0 = actor ? 0 : o == a.A ? actor_end : 0;
    const int j1 = actor ? actor_end : o == a.A ? ncols : 0;
    const float* w = actor ? a.w_aout + o : a.w_cout;
    const int stride = actor ? a.A : 1, base = actor ? c_lo : c_lo - H;
    const float* y = Ys + m * ys;
    float s0 = 0.f, s1 = 0.f;  // two chains: even and odd columns
    int jc = j0;
    for (; jc + 1 < j1; jc += 2) {
      s0 = fmaf(y[jc], __ldg(w + (base + jc) * stride), s0);
      s1 = fmaf(y[jc + 1], __ldg(w + (base + jc + 1) * stride), s1);
    }
    if (jc < j1) s0 = fmaf(y[jc], __ldg(w + (base + jc) * stride), s0);
    lp[e] = s0 + s1;
  }
  cluster.sync();  // the partial heads are in CTA 0, and no CTA reads another's memory after
  if (rank != 0) return;

  // ---- CTA 0: the heads in rank order, then the epilogue ----
  float* Ls = Ys;  // [kBM][kOut]
  for (int e = tid; e < kBM * kOut; e += kThreads) {
    const int o = e % kOut;
    float sum = 0.f;
    for (int r = 0; r < nc; ++r) sum += Lp[r * kBM * kOut + e];
    Ls[e] = sum + (o < a.A ? a.b_aout[o] : o == a.A ? a.b_cout[0] : 0.f);
  }
  __syncthreads();
  if (tid < kBM && row0 + tid < a.n_lanes) finish_row(a, row0 + tid, Ls + tid * kOut);
}

// ---- the wide variant (H > 256): three launches ----

// The branch products: tile (m0, n0) of branch b = tag's x columns times its
// W_b rows, then the bias and LeakyReLU into feats.
__global__ void __launch_bounds__(wide::kThreads)
wide_branch_kernel(const __grid_constant__ ActorCriticArgs a,
                   const __grid_constant__ wide::Gemms gs) {
  extern __shared__ __align__(16) float smem[];
  int m0, n0;
  const wide::Gemm& p = wide::locate(gs, (int)blockIdx.x, m0, n0);
  float acc[2][4][4];
  wide::gemm_tile<false>(p, m0, n0, smem, acc);
  const int H = a.hidden_dim, b = p.tag;
  float* feats = a.feats + b * H;
  const size_t ld = (size_t)a.num_branches * H;
  wide::for_each(acc, [&](int m, int n, float v) {
    const int row = m0 + m, col = n0 + n;
    if (row < p.M && col < p.N) feats[row * ld + col] = leaky(v + a.b_branch[b * H + col]);
  });
}

// The fc product: tile (m0, n0) of feats W_fc, then the bias, LeakyReLU
// (hidden), the residual, and the tile's partial logits and value (its
// actor columns times W_aout's rows, its critic columns times W_cout's) into
// heads[n0 / 128][row].
__global__ void __launch_bounds__(wide::kThreads)
wide_fc_kernel(const __grid_constant__ ActorCriticArgs a, const __grid_constant__ wide::Gemms gs) {
  extern __shared__ __align__(16) float smem[];
  int m0, n0;
  const wide::Gemm& p = wide::locate(gs, (int)blockIdx.x, m0, n0);
  float acc[2][4][4];
  wide::gemm_tile<false>(p, m0, n0, smem, acc);
  const int H = a.hidden_dim, F = 2 * H;
  const size_t ldf = (size_t)a.num_branches * H;
  const float* cond = a.cond >= 0 ? a.feats + a.cond * H : nullptr;
  float* Ys = smem;  // [kBM][kYS] the heads' inputs, over the ring
  wide::for_each(acc, [&](int m, int n, float v) {
    const int row = m0 + m, col = n0 + n;
    float y = 0.f;
    if (row < a.n_lanes && col < F) {
      const float h = leaky(v + a.b_fc[col]);
      if (a.hidden) a.hidden[(size_t)row * F + col] = h;
      y = cond ? h + cond[row * ldf + (col < H ? col : col - H)] : h;
    }
    Ys[m * wide::kYS + n] = y;
  });
  __syncthreads();
  const int a_end = max(0, min(wide::kBN, H - n0)), c_end = max(0, min(wide::kBN, F - n0));
  for (int e = threadIdx.x; e < wide::kBM * kOut; e += wide::kThreads) {
    const int m = e / kOut, o = e % kOut, row = m0 + m;
    if (row >= a.n_lanes) continue;
    // the tile's columns [j0, j1) that feed output o: w[(n0 + j - base) * stride]
    const bool actor = o < a.A;
    const int j0 = actor ? 0 : o == a.A ? a_end : 0;
    const int j1 = actor ? a_end : o == a.A ? c_end : 0;
    const float* w = actor ? a.w_aout + o : a.w_cout;
    const int stride = actor ? a.A : 1, base = actor ? 0 : H;
    const float* y = Ys + m * wide::kYS;
    float s0 = 0.f, s1 = 0.f;  // two chains: even and odd columns
    int j = j0;
    for (; j + 1 < j1; j += 2) {
      s0 = fmaf(y[j], __ldg(w + (n0 + j - base) * stride), s0);
      s1 = fmaf(y[j + 1], __ldg(w + (n0 + j + 1 - base) * stride), s1);
    }
    if (j < j1) s0 = fmaf(y[j], __ldg(w + (n0 + j - base) * stride), s0);
    a.heads[((size_t)(n0 / wide::kBN) * a.n_lanes + row) * kOut + o] = s0 + s1;
  }
}

// A thread a row: the partial logits and value summed in column-tile order,
// the biases, then the action head.
__global__ void wide_finish_kernel(const __grid_constant__ ActorCriticArgs a, int col_tiles) {
  const int row = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (row >= a.n_lanes) return;
  float l[kOut];
  for (int o = 0; o <= a.A; ++o) {
    float sum = 0.f;
    for (int r = 0; r < col_tiles; ++r) sum += a.heads[((size_t)r * a.n_lanes + row) * kOut + o];
    l[o] = sum + (o < a.A ? a.b_aout[o] : a.b_cout[0]);
  }
  finish_row(a, row, l);
}

namespace {

template <int kH>
cudaLaunchConfig_t launch_config(int ctas, int clusters, void* stream,
                                 cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Dims<kH>::kSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = ctas;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// Above 48 KB of dynamic shared memory needs the opt-in (for the current
// device), and a cluster of more than 8 CTAs the non-portable size (max 16).
template <int kH, bool kExact>
cudaError_t set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(actor_critic_kernel<kH, kExact>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Dims<kH>::kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(actor_critic_kernel<kH, kExact>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Clusters of g CTAs that device dev holds at once (asked once a device and instance).
template <int kH, bool kExact>
cudaError_t resident_clusters(int dev, int g, int* n) {
  static int cache[kMaxDevices][kMaxUnits + 1];
  int* slot = dev < kMaxDevices ? &cache[dev][g] : nullptr;
  if (slot && *slot) {
    *n = *slot - 1;
    return cudaSuccess;
  }
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = launch_config<kH>(g, 1, nullptr, &cluster);
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      n, (const void*)actor_critic_kernel<kH, kExact>, &cfg);
  if (e == cudaSuccess && slot) *slot = *n + 1;
  return e;
}

// The stages of the longest-walking CTA when the nb whole branches, of
// stages[b] stages each and taken in `order` (longest first), go each onto
// the least-loaded of g CTAs (the first of equals); owner[b] is branch b's CTA.
int place_branches(const int* stages, const int* order, int nb, int g, int* owner) {
  int load[kMaxUnits] = {};
  for (int k = 0; k < nb; ++k) {
    const int b = order[k];
    int r = 0;
    for (int q = 1; q < g; ++q)
      if (load[q] < load[r]) r = q;
    owner[b] = r;
    load[r] += stages[b];
  }
  int longest = 0;
  for (int r = 0; r < g; ++r) longest = load[r] > longest ? load[r] : longest;
  return longest;
}

// The split of `tiles` row tiles of least estimated time.  The candidates:
// one CTA a unit with the wide branches in two input halves (the shortest
// walk, 14 stages at H = 128), or g = nb .. 1 CTAs of whole branches.  A
// plan takes waves x (the longest walk + 1.5 stages a CTA of the cluster,
// for its barriers and fixed-order reduction), the waves counted from the
// clusters the card holds at once; on a tie the larger cluster.  On the
// H100 at H = 128 that gives split units at 512 rows (v9; 6 CTAs for v16,
// whose 13-CTA clusters take two waves), 2 CTAs a tile at 4096 and one at
// 8192.
template <int kH, bool kExact>
cudaError_t make_plan(const ActorCriticArgs& a, int tiles, Plan& p) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int nb = a.num_branches;
  int stages[kMaxNB], order[kMaxNB];  // whole branches' stages; branches longest first
  for (int b = 0; b < nb; ++b) {
    stages[b] = unit_of<kH>(a, false, 2 * b).stages;
    int k = b;  // insertion in order, after the equals (a stable sort)
    for (; k > 0 && stages[order[k - 1]] < stages[b]; --k) order[k] = order[k - 1];
    order[k] = b;
  }
  int units = 0, unit_walk = 0;
  for (int b = 0; b < nb; ++b)
    for (int part = 0; part < branch_parts<kH>(a, b, true); ++part) {
      ++units;
      const int st = unit_of<kH>(a, true, 2 * b + part).stages;
      unit_walk = st > unit_walk ? st : unit_walk;
    }
  const bool can_split = units > nb && units <= kMaxUnits &&
                         (a.cond < 0 || branch_parts<kH>(a, a.cond, true) == 1);
  int owner[kMaxNB];
  long best_cost = -1;
  int best_g = 1;
  bool best_split = false;
  for (int cand = can_split ? 0 : 1; cand <= nb; ++cand) {
    const bool split = cand == 0;
    const int g = split ? units : nb + 1 - cand;
    int fit = 0;
    e = resident_clusters<kH, kExact>(dev, g, &fit);
    if (e != cudaSuccess) return e;
    if (fit <= 0) continue;
    const long waves = (tiles + fit - 1) / fit;
    const long walk = split ? unit_walk : place_branches(stages, order, nb, g, owner);
    const long cost = waves * (2 * walk + 3 * g);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_g = g;
      best_split = split;
    }
  }
  p.ctas = best_g;
  p.split = best_split;
  p.cond_cta = -1;
  int n = 0;
  if (best_split) {
    for (int b = 0; b < nb; ++b)
      for (int part = 0; part < branch_parts<kH>(a, b, true); ++part) {
        if (b == a.cond) p.cond_cta = n;
        p.first[n] = n;
        p.unit[n++] = 2 * b + part;
      }
    p.first[n] = n;
    return cudaSuccess;
  }
  place_branches(stages, order, nb, best_g, owner);
  for (int r = 0; r < best_g; ++r) {  // each CTA's branches in order, the cond branch last
    p.first[r] = n;
    for (int b = 0; b < nb; ++b)
      if (owner[b] == r && b != a.cond) p.unit[n++] = 2 * b;
    if (a.cond >= 0 && owner[a.cond] == r) {
      p.cond_cta = r;
      p.unit[n++] = 2 * a.cond;
    }
  }
  p.first[best_g] = n;
  return cudaSuccess;
}

template <int kH, bool kExact>
cudaError_t plan_of(const ActorCriticArgs& a, Plan& p) {
  if (a.num_branches < 1 || a.num_branches > kMaxNB || a.cond < -1 || a.cond >= a.num_branches ||
      a.hidden_dim < 1 || a.hidden_dim > kH || kExact != (a.hidden_dim == kH))
    return cudaErrorInvalidValue;
  const cudaError_t e = set_attributes<kH, kExact>();
  p.vec_wb = wide::aligned16(a.w_branch) && a.hidden_dim % 4 == 0;
  p.vec_wfc = wide::aligned16(a.w_fc) && a.hidden_dim % 2 == 0;
  return e == cudaSuccess ? make_plan<kH, kExact>(a, (a.n_lanes + kBM - 1) / kBM, p) : e;
}

template <int kH, bool kExact>
cudaError_t launch(const ActorCriticArgs& a, void* stream) {
  const int tiles = (a.n_lanes + kBM - 1) / kBM;
  if (tiles <= 0) return set_attributes<kH, kExact>();
  Plan p = {};
  cudaError_t e = plan_of<kH, kExact>(a, p);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = launch_config<kH>(p.ctas, tiles, stream, &cluster);
  e = cudaLaunchKernelEx(&cfg, actor_critic_kernel<kH, kExact>, a, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

constexpr int kWideSmem = wide::Layout<false>::kSmemBytes;

cudaError_t set_wide_attributes() {
  cudaError_t e = cudaFuncSetAttribute(wide_branch_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wide_fc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWideSmem);
  return e;
}

// The wide variant: the branch products into feats, the fc product with the
// partial heads, the action head.
cudaError_t launch_wide(const ActorCriticArgs& a, void* stream) {
  if (a.num_branches < 1 || a.num_branches > kMaxNB || a.cond < -1 ||
      a.cond >= a.num_branches || !a.feats || !a.heads)
    return cudaErrorInvalidValue;
  cudaError_t e = set_wide_attributes();
  if (e != cudaSuccess || a.n_lanes <= 0) return e;
  cudaStream_t s = (cudaStream_t)stream;
  const int N = a.n_lanes, H = a.hidden_dim, nb = a.num_branches;
  wide::Gemms branches{};
  int tiles = 0;
  for (int b = 0; b < nb; ++b) {
    const int off = a.branch_off[b];
    tiles = wide::add(branches, tiles, a.x + off, a.ldx, a.w_branch + (size_t)off * H, H, N, H,
                      a.branch_off[b + 1] - off, false, b);
  }
  wide_branch_kernel<<<tiles, wide::kThreads, kWideSmem, s>>>(a, branches);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wide::Gemms fc{};
  tiles = wide::add(fc, 0, a.feats, nb * H, a.w_fc, 2 * H, N, 2 * H, nb * H, false, 0);
  wide_fc_kernel<<<tiles, wide::kThreads, kWideSmem, s>>>(a, fc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wide_finish_kernel<<<(N + 127) / 128, 128, 0, s>>>(a, fc.g[0].n_tiles);
  return cudaGetLastError();
}

// The smallest instance that holds hidden width H: 64, 128, 192 or 256; 0
// for the wide variant past 256 (kernels/actor_critic.py:kernel_instance).
int instance_of(int H) {
  return H <= 64 ? 64 : H <= 128 ? 128 : H <= 192 ? 192 : H <= 256 ? 256 : 0;
}

// fn(kH, kExact) as std::integral_constant's for H's instance, kExact for H
// = kH; wide_fn() past 256.
template <typename Fn, typename Wide>
cudaError_t with_instance(int H, Fn&& fn, Wide&& wide_fn) {
  using std::integral_constant;
  using Yes = std::true_type;
  using No = std::false_type;
  switch (H < 1 ? -1 : instance_of(H)) {
    case -1: return cudaErrorInvalidValue;
    case 64: return H == 64 ? fn(integral_constant<int, 64>{}, Yes{})
                            : fn(integral_constant<int, 64>{}, No{});
    case 128: return H == 128 ? fn(integral_constant<int, 128>{}, Yes{})
                              : fn(integral_constant<int, 128>{}, No{});
    case 192: return H == 192 ? fn(integral_constant<int, 192>{}, Yes{})
                              : fn(integral_constant<int, 192>{}, No{});
    case 256: return H == 256 ? fn(integral_constant<int, 256>{}, Yes{})
                              : fn(integral_constant<int, 256>{}, No{});
    default: return wide_fn();
  }
}

}  // namespace

// The instance that runs hidden width `hidden` (0: the wide variant).
extern "C" int actor_critic_instance(int hidden) { return instance_of(hidden); }

// The dynamic shared memory a CTA takes at hidden width `hidden`: its
// instance's, or the wide variant's tile kernels'.
extern "C" int actor_critic_smem_bytes(int hidden) {
  switch (instance_of(hidden)) {
    case 64: return Dims<64>::kSmemBytes;
    case 128: return Dims<128>::kSmemBytes;
    case 192: return Dims<192>::kSmemBytes;
    case 256: return Dims<256>::kSmemBytes;
    default: return kWideSmem;
  }
}

// The cluster the launch of `args` takes: CTAs a tile, and 1 if the wide
// branches are split (the wide variant: 1 and 0, no clusters).
extern "C" int actor_critic_plan(const ActorCriticArgs* args, int* ctas, int* split) {
  Plan p = {};
  p.ctas = 1;
  const cudaError_t e = with_instance(
      args->hidden_dim,
      [&](auto k, auto exact) {
        return plan_of<decltype(k)::value, decltype(exact)::value>(*args, p);
      },
      [] { return cudaSuccess; });
  *ctas = p.ctas;
  *split = p.split;
  return (int)e;
}

extern "C" int actor_critic_launch(const ActorCriticArgs* args, void* stream) {
  return (int)with_instance(
      args->hidden_dim,
      [&](auto k, auto exact) {
        return launch<decltype(k)::value, decltype(exact)::value>(*args, stream);
      },
      [&] { return launch_wide(*args, stream); });
}
