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
// Bound: device-memory bytes.  Each (v, u, c) reads its two viewport rows
// and, over the actions, its chunk's size and quality slabs (from L2 after
// the first of the U users), and writes 10 x A floats; a few thousand flops.
//
// Design: one warp per (v, u, c), two tiles a thread, as K1.  The two
// viewports become 64-bit masks with ballots and their ring distances are
// computed once; the warp then loops over the A actions, and the butterfly
// sums leave every result in every thread, so thread a keeps action a's ten
// values and the warp writes each table's A entries with one store each.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace mansy;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kTables = 10;

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
};

// (quality, intra) of the tile qualities q0, q1 over the viewport weights
// e0, e1 (sim/expert.py:_evaluate).
__device__ __forceinline__ void evaluate(float e0, float e1, float q0, float q1, float& quality,
                                         float& intra) {
  const float s = warp_sum(e0 + e1);
  const float vp_sum = s < 1e-6f ? 1e-6f : s;
  quality = warp_sum(e0 * q0 + e1 * q1) / vp_sum;
  intra = warp_sum(e0 * fabsf(q0 - quality) + e1 * fabsf(q1 - quality)) / vp_sum;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
expert_tables_kernel(const ExpertTablesArgs a) {
  const int t = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);  // (v, u, c)
  const int n_rows = a.V * a.U * a.C;
  if (row >= n_rows) return;  // whole warp leaves together
  const int c = row % a.C, v = row / (a.U * a.C);

  const float* gt = a.gt + (size_t)row * kTiles;
  const float* pred = a.pred + (size_t)row * kTiles;
  int g0s, g1s, p0s, p1s;
  viewport_scales(viewport_mask(gt, t), t, g0s, g1s);
  viewport_scales(viewport_mask(pred, t), t, p0s, p1s);
  const float g0 = gt[t], g1 = gt[t + 32];
  const float p0 = pred[t], p1 = pred[t + 32];
  const float c0 = max0(1.f - p0), c1 = max0(1.f - p1);  // complement of the prediction
  const size_t slab = ((size_t)v * a.C + c) * a.R * kTiles;

  float keep[kTables];
#pragma unroll
  for (int k = 0; k < kTables; ++k) keep[k] = 0.f;
  for (int act = 0; act < a.A; ++act) {
    const int rate_in = a.action_rates[2 * act], rate_out = a.action_rates[2 * act + 1];
    const int* srow = a.scale_table + rate_out * (kMaxScale + 1);
    float res[kTables];
    // gt allocation, evaluated on gt
    {
      const int ver0 = g0s == 0 ? rate_in : srow[g0s];
      const int ver1 = g1s == 0 ? rate_in : srow[g1s];
      const float q0 = a.qualities[slab + ver0 * kTiles + t];
      const float q1 = a.qualities[slab + ver1 * kTiles + t + 32];
      evaluate(g0, g1, q0, q1, res[0], res[1]);
      res[2] = warp_sum(a.sizes[slab + ver0 * kTiles + t] + a.sizes[slab + ver1 * kTiles + t + 32]);
    }
    // pred allocation, evaluated on gt, on pred and on the complement
    {
      const int ver0 = p0s == 0 ? rate_in : srow[p0s];
      const int ver1 = p1s == 0 ? rate_in : srow[p1s];
      const float q0 = a.qualities[slab + ver0 * kTiles + t];
      const float q1 = a.qualities[slab + ver1 * kTiles + t + 32];
      evaluate(g0, g1, q0, q1, res[3], res[4]);
      res[5] = warp_sum(a.sizes[slab + ver0 * kTiles + t] + a.sizes[slab + ver1 * kTiles + t + 32]);
      evaluate(p0, p1, q0, q1, res[6], res[7]);
      evaluate(c0, c1, q0, q1, res[8], res[9]);
    }
    if (t == act) {
#pragma unroll
      for (int k = 0; k < kTables; ++k) keep[k] = res[k];
    }
  }
  if (t < a.A) {
    const size_t plane = (size_t)n_rows * a.A;
#pragma unroll
    for (int k = 0; k < kTables; ++k) a.out[k * plane + (size_t)row * a.A + t] = keep[k];
  }
}

extern "C" int expert_tables_launch(const ExpertTablesArgs* args, void* stream) {
  const int rows = args->V * args->U * args->C;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    expert_tables_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
