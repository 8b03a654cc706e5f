// K7: viewport tile occupancy, fused with the chunk OR and IoU (chunk mode)
// or with the per-step periodic MSE and tile metrics (metrics mode), in f32.
//
// Replaces the deleted Pallas kernel tile_occupancy_pallas and the XLA path
// the JAX package keeps: ops/geometry.py:tile_occupancy_from_normalized
// (:108), tile_occupancy (:87), iou_accuracy (:130) and tile_metrics (:140),
// as cli/predict.py:chunk_maps (:42-56) and utils/results.py:_metrics_kernel
// (:31-40) run them.  The plain PyTorch versions are
// kernels/tile_occupancy.py:chunk_maps_plain and trajectory_metrics_plain.
//
// A normalized (x, y) becomes the pixel (int(x * W), int(y * H)), truncated
// toward zero in f32 (__float2int_rz; the build's -fmad=false keeps every
// product and quotient rounded as in the plain version).  The FoV box
// [x - fw/2, x + fw/2] x [y - fh/2, y + fh/2] wraps on the torus into at
// most two intervals an axis; a pixel p lies in tile max(0, ceil(p/ts) - 1)
// (a boundary belongs to the lower tile).  Each axis gives a coverage bit
// vector, one span mask ((2 << b) - (1 << a)) an interval, and the 8x8 map
// is their outer product, one 64-bit mask (bit row * 8 + col): the column
// bits times the row bits spread one a byte.  Counts are popcounts, so IoU,
// accuracy, recall and precision are quotients of exact integers, as in the
// plain version.
//
// Bound: bytes (8 bytes a point read, 128 + 4 bytes written per chunk, 20
// per metrics step), a few hundred integer operations a point; at the
// paths' 512 trajectories the launch and one chain of dependent loads set
// the time, not either bound.
//
// Design, chunk mode.  A group of 16 threads takes a trajectory
// (kernels/tile_occupancy.py:chunk_plan): thread j of the group maps step
// j % 8 (then j % 8 + 8, ... below `frequency`) of gt (j < 8) or pred
// (j >= 8), so a step's map is one thread's work and the group's loads of
// a trajectory's first 8 steps are contiguous.  Three xor shuffles OR the
// maps of each half, a fourth swaps the halves' results, and thread j
// stores word j of the trajectory's 64-byte g row and of its p row (four
// tiles, one a byte), so a warp stores two whole rows of each with one
// instruction; thread 0 writes the IoU.  Blocks of 4 trajectories (64
// threads) give 128 blocks at the paths' 512 trajectories.
//
// Metrics mode keeps one thread a (trajectory, step) in 128-thread blocks:
// each step is an independent map and five values.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using mansy::floor_div;

namespace {

constexpr int kGrid = 8;                // tiles a side; the map has kGrid * kGrid bits
constexpr int kGroup = 16;              // chunk mode: threads a trajectory
constexpr int kSlots = kGroup / 2;      // steps each half of a group maps in one pass
constexpr int kMetricsThreads = 128;

}  // namespace

// Field order must match kernels/tile_occupancy.py:_Geometry.
struct Geometry {
  int32_t width, height;          // frame in pixels, cut into kGrid x kGrid tiles
  int32_t fov_w, fov_h;           // FoV in pixels
};

// Field order must match kernels/tile_occupancy.py:_ChunkArgs.
struct ChunkArgs {
  const float* gt;     // [B, F, 2] normalized (x, y)
  const float* pred;   // [B, F, 2]
  uint8_t* g;          // [B, 64] OR of the first `frequency` steps' maps
  uint8_t* p;          // [B, 64]
  float* iou;          // [B]
  int32_t B, F, frequency;
  int32_t trajectories;  // a block (chunk_plan)
  Geometry geo;
};

// Field order must match kernels/tile_occupancy.py:_MetricsArgs.
struct MetricsArgs {
  const float* gt;     // [B, F, 2]
  const float* pred;   // [B, F, 2]
  float* mse;          // [B, F] periodic MSE of pred against gt
  float* acc;          // [B, F] tile IoU
  float* rec;          // [B, F]
  float* prec;         // [B, F]
  float* f1;           // [B, F]
  int32_t B, F;
  Geometry geo;
};

__device__ __forceinline__ int tile_of(int p, int ts) {
  const int t = floor_div(p + ts - 1, ts) - 1;
  return t < 0 ? 0 : t;
}

// Bits a..b (0 <= a, b < 32); none when a > b.
__device__ __forceinline__ uint32_t span(int a, int b) {
  return a > b ? 0u : (2u << b) - (1u << a);
}

// Coverage bits of the wrapped pixel interval [lo, hi] on a circle of
// `size`: [lo, hi], or [0, b] U [a, size] when it wraps (geometry.py:63-84);
// tiles past the last are cut.
__device__ __forceinline__ uint32_t axis_coverage(int lo, int hi, int size, int ts) {
  const bool wraps = lo < 0 || hi > size;
  const int a1 = tile_of(wraps ? 0 : lo, ts);
  const int b1 = min(tile_of(hi > size ? hi - size : hi, ts), kGrid - 1);
  const int a2 = tile_of(lo < 0 ? lo + size : lo, ts);
  const int b2 = min(tile_of(size, ts), kGrid - 1);
  return span(a1, b1) | (wraps ? span(a2, b2) : 0u);
}

// Bit r of the 8 low bits to bit 8 r.
__device__ __forceinline__ uint64_t spread_rows(uint32_t rows) {
  uint64_t e = rows & 0xffu;
  e = (e | (e << 28)) & 0x0000000f0000000full;
  e = (e | (e << 14)) & 0x0003000300030003ull;
  return (e | (e << 7)) & 0x0101010101010101ull;
}

__device__ __forceinline__ uint64_t occupancy(float vx, float vy, const Geometry& g) {
  const int x = __float2int_rz(vx * (float)g.width);
  const int y = __float2int_rz(vy * (float)g.height);
  const uint32_t cx = axis_coverage(x - g.fov_w / 2, x + g.fov_w / 2, g.width,
                                    g.width / kGrid);
  const uint32_t cy = axis_coverage(y - g.fov_h / 2, y + g.fov_h / 2, g.height,
                                    g.height / kGrid);
  return (uint64_t)cx * spread_rows(cy);  // the rows' copies of cx never overlap
}

// Bits 0-3 of m as the bytes of a word (tile 4 j + k to byte k).
__device__ __forceinline__ uint32_t tile_bytes(uint64_t m) {
  const uint32_t n = (uint32_t)m & 0xfu;
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

// min(|a-b|, |a+1-b|, |a-1-b|) (geometry.py:29-39)
__device__ __forceinline__ float periodic_err(float a, float b) {
  float e = fabsf(a - b);
  e = fminf(e, fabsf(a + 1.f - b));
  return fminf(e, fabsf(a - 1.f - b));
}

__global__ void chunk_kernel(const ChunkArgs a) {
  const int j = threadIdx.x % kGroup;
  const int b = blockIdx.x * a.trajectories + threadIdx.x / kGroup;
  if (b >= a.B) return;  // the whole group leaves
  const unsigned group = 0xffffu << (threadIdx.x & 16);  // the group's lanes of the warp
  const bool is_pred = j >= kSlots;
  const float* pts = (is_pred ? a.pred : a.gt) + (size_t)b * a.F * 2;
  uint64_t m = 0;
  for (int s = j % kSlots; s < a.frequency; s += kSlots) {
    m |= occupancy(pts[2 * s], pts[2 * s + 1], a.geo);
  }
#pragma unroll
  for (int o = 1; o < kSlots; o <<= 1) m |= __shfl_xor_sync(group, m, o, kGroup);
  const uint64_t other = __shfl_xor_sync(group, m, kSlots, kGroup);
  const uint64_t gm = is_pred ? other : m, pm = is_pred ? m : other;
  reinterpret_cast<uint32_t*>(a.g)[(size_t)b * kGroup + j] = tile_bytes(gm >> (4 * j));
  reinterpret_cast<uint32_t*>(a.p)[(size_t)b * kGroup + j] = tile_bytes(pm >> (4 * j));
  if (j == 0) a.iou[b] = (float)__popcll(gm & pm) / (float)__popcll(gm | pm);
}

__global__ void metrics_kernel(const MetricsArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B * a.F) return;
  const float gx = a.gt[2 * (size_t)i], gy = a.gt[2 * (size_t)i + 1];
  const float px = a.pred[2 * (size_t)i], py = a.pred[2 * (size_t)i + 1];
  const float ex = periodic_err(px, gx), ey = periodic_err(py, gy);
  a.mse[i] = (ex * ex + ey * ey) / 2.f;
  const uint64_t gm = occupancy(gx, gy, a.geo), pm = occupancy(px, py, a.geo);
  const float tp = (float)__popcll(gm & pm);
  const float recall = tp / (float)__popcll(gm);
  const float precision = tp / (float)__popcll(pm);
  const float denom = recall + precision;
  a.acc[i] = tp / (float)__popcll(gm | pm);
  a.rec[i] = recall;
  a.prec[i] = precision;
  a.f1[i] = denom == 0.f ? 0.f : 2.f * recall * precision / denom;
}

extern "C" int chunk_maps_launch(const ChunkArgs* args, void* stream) {
  const int per = args->trajectories;
  const int blocks = (args->B + per - 1) / per;
  if (blocks > 0) chunk_kernel<<<blocks, per * kGroup, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int trajectory_metrics_launch(const MetricsArgs* args, void* stream) {
  const int blocks = (args->B * args->F + kMetricsThreads - 1) / kMetricsThreads;
  if (blocks > 0) {
    metrics_kernel<<<blocks, kMetricsThreads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
