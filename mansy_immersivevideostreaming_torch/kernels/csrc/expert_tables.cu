// K5: the MPC expert's per-action profiling tables, all (v, u, c, a) at once.
//
// Replaces the JAX package's XLA-fused sim/expert.py:build_expert_tables
// (:67-110) with its callees ops/allocation.py:viewport_scales and
// allocate_tile_rates.  The plain PyTorch version is
// sim/expert.py:build_expert_tables_plain.
//
// For each (v, u, c) and each action a = (rate_in, rate_out): the pyramid
// allocation on the ground-truth viewport and on the predicted one; each
// tile's size and quality at its version; then quality = sum(vp q) /
// max(sum(vp), 1e-6) and intra = sum(vp |q - quality|) / max(sum(vp), 1e-6)
// over four (allocation, evaluation) pairs: gt/gt, pred/gt, pred/pred and
// pred/complement, where the complement is max(1 - pred, 0).  Ten [V,U,C,A]
// tables: gt (quality, intra, size), pred (quality, intra, size), dep
// (quality, intra), out (quality, intra).
//
// Bound: device-memory bytes by a little (the two viewport rows read and 10
// x A floats written a (v, u, c), the (v, c) slabs once), then f32
// operations: per action two 64-tile size sums and four evaluations.
//
// Design.  A block takes one (v, c) and a group of users
// (kernels/expert_tables.py:expert_tables_plan) and stages in shared memory
// the chunk's [R, 64] slab as (quality, size) pairs, 256 bytes from one
// tile's pairs to the next, so that a tile's entry address is one byte away
// from the tile's base; the codec tables; and, once a row, a warp's
// action-independent work: the two viewport rows, their ring distances
// (ballots and 64-bit dilation, as K1), packed a nibble a tile, and the
// three viewport sums (gt, pred, the complement) with their 1e-6 guard.
// Then one thread takes one (row, action) and both allocations over the 64
// tiles, 8 at a time.  The action's versions, times the entry's 8-byte
// stride, sit in a 5-byte table in two registers: one byte permute (prmt)
// looks up four tiles' rings in it, and one more a tile puts the byte under
// the tile's base, so each allocation's entry address costs one instruction
// a tile and no load chain repeats per action.  Threads reading one tile at
// different versions read one 40-byte span, free of bank conflicts; the
// tile's gt and pred weights are read once for both allocations.  Every sum
// is the thread's own, four partial sums (tile t into t % 4) added as
// ((p0 + p1) + (p2 + p3)), a fixed order, so two launches give the same
// bits.  The intra pass looks the tiles up again, and each quotient is a
// division, as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace mansy;

namespace {

constexpr int kRates = 5;                    // R: a tile's versions (the codec's rates)
constexpr int kMaxUsers = 8;                 // users a block at most
constexpr int kMaxWarps = 4;                 // warps of (user, action) threads at most
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxActions = 32;
constexpr int kRowStride = kTiles + 4;       // a weight row: 68 floats, rows 4 banks apart
constexpr int kEntry = 256;                  // bytes from a tile's (quality, size) pairs to the next
constexpr int kEntries = kEntry / 8;         // float2 a tile; the first kRates used
constexpr uint32_t kSelHigh = 0x7650u;       // prmt: result bytes 1-3 from bytes 5-7 (y's 1-3)
constexpr float kGuard = 1e-6f;

static_assert(kMaxScale == 4, "the version table holds one byte for each ring 0-4");

}  // namespace

// Field order must match kernels/expert_tables.py:_ExpertTablesArgs.
struct ExpertTablesArgs {
  const float* sizes;           // [V, C, R, 64]
  const float* qualities;       // [V, C, R, 64]
  const float* gt;              // [V, U, C, 64]
  const float* pred;            // [V, U, C, 64]
  const int32_t* scale_table;   // [R, kMaxScale + 1]
  const int32_t* action_rates;  // [A, 2] action -> (rate_in, rate_out)
  float* out;                   // [10, V, U, C, A]
  int32_t V, U, C, R, A;
  int32_t users, warps, groups, blocks;  // the plan
};

namespace {

struct Sum4 {  // tile t into p[t % 4]; total ((p0 + p1) + (p2 + p3))
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ float total() const { return (p[0] + p[1]) + (p[2] + p[3]); }
};

struct Staged {
  __align__(256) float2 slab[kTiles * kEntries];        // (quality, size) of tile t at version r
  __align__(16) float w[2][kMaxUsers][kRowStride];      // gt and pred weights
  uint32_t rings[2][kMaxUsers][kTiles / 8];             // gt and pred rings, a nibble a tile
  float vp[3][kMaxUsers];                               // max(sum, 1e-6) of gt, pred, complement
  int32_t scale[kRates * (kMaxScale + 1)];
  int32_t rates[2 * kMaxActions];
};

__device__ __forceinline__ float guard(float s) { return s < kGuard ? kGuard : s; }

// The slab's (quality, size), or quality, at a shared-memory address.
__device__ __forceinline__ float2 entry(uint32_t at) {
  float2 e;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(e.x), "=f"(e.y) : "r"(at));
  return e;
}
__device__ __forceinline__ float quality_at(uint32_t at) {
  float q;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(q) : "r"(at));
  return q;
}

__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x), "r"(y), "r"(sel));
  return d;
}

// The entry offsets of tiles 8k .. 8k + 7 under the action's table (lo,
// hi), four to a word (byte n: 8 x the version of tile 8k + n, or 8k + 4 +
// n), from the tiles' rings, a nibble a tile.
__device__ __forceinline__ void version_bytes(uint32_t rings, uint32_t lo, uint32_t hi,
                                              uint32_t& first, uint32_t& second) {
  first = prmt(lo, hi, rings);
  second = prmt(lo, hi, rings >> 16);
}

// The shared-memory address of tile 8k + j's entry (j compile-time after
// unrolling): byte j % 4 of its four tiles' offsets as the low byte, the
// upper bytes those of `base`, the 256-byte aligned entry of tile 8k.
__device__ __forceinline__ uint32_t version_entry(uint32_t first, uint32_t second, int j,
                                                  uint32_t base) {
  return prmt(j < 4 ? first : second, base, kSelHigh | (uint32_t)(j & 3)) + j * kEntry;
}

// Element j (compile-time after unrolling) of two float4.
__device__ __forceinline__ float pick(const float4& a, const float4& b, int j) {
  const float4& x = j < 4 ? a : b;
  return (j & 3) == 0 ? x.x : (j & 3) == 1 ? x.y : (j & 3) == 2 ? x.z : x.w;
}

__global__ void __launch_bounds__(kMaxThreads, 4)
expert_tables_kernel(const ExpertTablesArgs a) {
  __shared__ Staged s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int group = blockIdx.x % a.groups;
  const int vc = blockIdx.x / a.groups;  // v * C + c
  const int v = vc / a.C, c = vc - v * a.C;
  const int u0 = group * a.users;
  const int users = min(a.users, a.U - u0);

  // the chunk's slab, tile-major, and the codec tables
  const float* qsrc = a.qualities + (size_t)vc * kRates * kTiles;
  const float* ssrc = a.sizes + (size_t)vc * kRates * kTiles;
  for (int i = tid; i < kRates * kTiles; i += blockDim.x) {
    const int r = i / kTiles, t = i - r * kTiles;
    s.slab[t * kEntries + r] = make_float2(qsrc[i], ssrc[i]);
  }
  for (int i = tid; i < kRates * (kMaxScale + 1); i += blockDim.x) s.scale[i] = a.scale_table[i];
  for (int i = tid; i < 2 * a.A; i += blockDim.x) s.rates[i] = a.action_rates[i];

  // each row's action-independent work, a warp a row; lane t holds tiles t and t + 32
  for (int r = warp; r < users; r += n_warps) {
    const size_t row = ((size_t)v * a.U + u0 + r) * a.C + c;
    const float* gt = a.gt + row * kTiles;
    const float* pred = a.pred + row * kTiles;
    const float w[2][2] = {{gt[lane], gt[lane + 32]}, {pred[lane], pred[lane + 32]}};
    int rings[2][2];
    viewport_scales(viewport_mask(gt, lane), lane, rings[0][0], rings[0][1]);
    viewport_scales(viewport_mask(pred, lane), lane, rings[1][0], rings[1][1]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      s.w[k][r][lane] = w[k][0];
      s.w[k][r][lane + 32] = w[k][1];
      const float sum = warp_sum(w[k][0] + w[k][1]);
      if (lane == 0) s.vp[k][r] = guard(sum);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // word m: tiles 8m .. 8m + 7, a nibble each
        uint32_t word = (uint32_t)rings[k][h] << (4 * (lane & 7));
        word |= __shfl_xor_sync(kFull, word, 1);
        word |= __shfl_xor_sync(kFull, word, 2);
        word |= __shfl_xor_sync(kFull, word, 4);
        if ((lane & 7) == 0) s.rings[k][r][4 * h + (lane >> 3)] = word;
      }
    }
    const float sum = warp_sum(max0(1.f - w[1][0]) + max0(1.f - w[1][1]));  // the complement
    if (lane == 0) s.vp[2][r] = guard(sum);
  }
  __syncthreads();

  // one thread a (row, action), both allocations
  const int r = tid / a.A, act = tid - r * a.A;
  if (r >= users) return;
  // byte ring of (lo, hi): 8 x the version of a tile at that ring under this action
  const int rate_in = s.rates[2 * act], rate_out = s.rates[2 * act + 1];
  const int32_t* srow = s.scale + rate_out * (kMaxScale + 1);
  const uint32_t lo = (uint32_t)(8 * rate_in) | (uint32_t)(8 * srow[1]) << 8 |
                      (uint32_t)(8 * srow[2]) << 16 | (uint32_t)(8 * srow[3]) << 24;
  const uint32_t hi = (uint32_t)(8 * srow[4]);
  const uint32_t slab = (uint32_t)__cvta_generic_to_shared(s.slab);  // 256-byte aligned
  const uint32_t* rings_g = s.rings[0][r];
  const uint32_t* rings_p = s.rings[1][r];
  const float4* w_g = reinterpret_cast<const float4*>(s.w[0][r]);
  const float4* w_p = reinterpret_cast<const float4*>(s.w[1][r]);
  const float vp_g = s.vp[0][r], vp_p = s.vp[1][r], vp_c = s.vp[2][r];

  // quality pass: both allocations' sizes and the four (allocation, evaluation) sums
  Sum4 size_g, size_p, q_gg, q_pg, q_pp, q_pc;
#pragma unroll 1
  for (int k = 0; k < kTiles / 8; ++k) {  // rolled: unrolled, the loads hoisted and spilled
    uint32_t g_first, g_second, p_first, p_second;
    version_bytes(rings_g[k], lo, hi, g_first, g_second);
    version_bytes(rings_p[k], lo, hi, p_first, p_second);
    const float4 g0 = w_g[2 * k], g1 = w_g[2 * k + 1], p0 = w_p[2 * k], p1 = w_p[2 * k + 1];
    const uint32_t base = slab + k * 8 * kEntry;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 eg = entry(version_entry(g_first, g_second, j, base));
      const float2 ep = entry(version_entry(p_first, p_second, j, base));
      const float wg = pick(g0, g1, j), wp = pick(p0, p1, j), wc = max0(1.f - wp);
      size_g.p[j & 3] += eg.y;
      q_gg.p[j & 3] += wg * eg.x;
      size_p.p[j & 3] += ep.y;
      q_pg.p[j & 3] += wg * ep.x;
      q_pp.p[j & 3] += wp * ep.x;
      q_pc.p[j & 3] += wc * ep.x;
    }
  }
  const float Q_gg = q_gg.total() / vp_g, Q_pg = q_pg.total() / vp_g;
  const float Q_pp = q_pp.total() / vp_p, Q_pc = q_pc.total() / vp_c;

  // intra pass
  Sum4 i_gg, i_pg, i_pp, i_pc;
#pragma unroll 1
  for (int k = 0; k < kTiles / 8; ++k) {
    uint32_t g_first, g_second, p_first, p_second;
    version_bytes(rings_g[k], lo, hi, g_first, g_second);
    version_bytes(rings_p[k], lo, hi, p_first, p_second);
    const float4 g0 = w_g[2 * k], g1 = w_g[2 * k + 1], p0 = w_p[2 * k], p1 = w_p[2 * k + 1];
    const uint32_t base = slab + k * 8 * kEntry;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float qg = quality_at(version_entry(g_first, g_second, j, base));
      const float qp = quality_at(version_entry(p_first, p_second, j, base));
      const float wg = pick(g0, g1, j), wp = pick(p0, p1, j), wc = max0(1.f - wp);
      i_gg.p[j & 3] += wg * fabsf(qg - Q_gg);
      i_pg.p[j & 3] += wg * fabsf(qp - Q_pg);
      i_pp.p[j & 3] += wp * fabsf(qp - Q_pp);
      i_pc.p[j & 3] += wc * fabsf(qp - Q_pc);
    }
  }

  const size_t row = ((size_t)v * a.U + u0 + r) * a.C + c;
  const size_t plane = (size_t)a.V * a.U * a.C * a.A;
  float* out = a.out + row * a.A + act;
  out[0] = Q_gg;
  out[plane] = i_gg.total() / vp_g;
  out[2 * plane] = size_g.total();
  out[3 * plane] = Q_pg;
  out[4 * plane] = i_pg.total() / vp_g;
  out[5 * plane] = size_p.total();
  out[6 * plane] = Q_pp;
  out[7 * plane] = i_pp.total() / vp_p;
  out[8 * plane] = Q_pc;
  out[9 * plane] = i_pc.total() / vp_c;
}

}  // namespace

extern "C" int expert_tables_launch(const ExpertTablesArgs* args, void* stream) {
  const ExpertTablesArgs& a = *args;
  if (a.R != kRates || a.A < 1 || a.A > kMaxActions || a.users < 1 || a.users > kMaxUsers ||
      a.warps < 1 || a.warps > kMaxWarps || a.warps * 32 < a.users * a.A ||
      a.groups * a.users < a.U || (a.groups - 1) * a.users >= a.U ||
      a.blocks != a.V * a.C * a.groups) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.blocks > 0) {
    expert_tables_kernel<<<a.blocks, 32 * a.warps, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
