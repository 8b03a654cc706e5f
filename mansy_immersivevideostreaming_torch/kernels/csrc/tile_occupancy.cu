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
// vector, and the map is their outer product, one 64-bit mask (bit
// row * tnw + col).  Counts are popcounts, so IoU, accuracy, recall and
// precision are quotients of exact integers, as in the plain version.
//
// Bound: bytes (8 bytes a point read per trajectory, 128 + 4 bytes written
// per chunk, 20 per metrics step), a few hundred integer operations a
// point.  Design: one thread a trajectory (chunk mode) or a (trajectory,
// step) (metrics mode); the map never leaves registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using mansy::floor_div;

// Field order must match kernels/tile_occupancy.py:_Geometry.
struct Geometry {
  int32_t width, height;          // frame in pixels
  int32_t tiles_w, tiles_h;       // tile grid (tiles_w * tiles_h <= 64)
  int32_t fov_w, fov_h;           // FoV in pixels
};

// Field order must match kernels/tile_occupancy.py:_ChunkArgs.
struct ChunkArgs {
  const float* gt;     // [B, F, 2] normalized (x, y)
  const float* pred;   // [B, F, 2]
  uint8_t* g;          // [B, tiles] OR of the first `frequency` steps' maps
  uint8_t* p;          // [B, tiles]
  float* iou;          // [B]
  int32_t B, F, frequency;
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

// Coverage bits of the wrapped pixel interval [lo, hi] on a circle of
// `size`: [lo, hi], or [0, b] U [a, size] when it wraps (geometry.py:63-84).
__device__ __forceinline__ uint32_t axis_coverage(int lo, int hi, int size, int ts, int n) {
  const bool wraps = lo < 0 || hi > size;
  const int a1 = tile_of(wraps ? 0 : lo, ts);
  const int b1 = tile_of(hi > size ? hi - size : hi, ts);
  const int a2 = tile_of(lo < 0 ? lo + size : lo, ts);
  const int b2 = tile_of(size, ts);
  uint32_t cov = 0;
  for (int t = 0; t < n; ++t) {
    const bool on = (t >= a1 && t <= b1) || (wraps && t >= a2 && t <= b2);
    cov |= (uint32_t)on << t;
  }
  return cov;
}

__device__ __forceinline__ uint64_t occupancy(float vx, float vy, const Geometry& g) {
  const int x = __float2int_rz(vx * (float)g.width);
  const int y = __float2int_rz(vy * (float)g.height);
  const uint32_t cx = axis_coverage(x - g.fov_w / 2, x + g.fov_w / 2, g.width,
                                    g.width / g.tiles_w, g.tiles_w);
  const uint32_t cy = axis_coverage(y - g.fov_h / 2, y + g.fov_h / 2, g.height,
                                    g.height / g.tiles_h, g.tiles_h);
  uint64_t m = 0;
  for (int r = 0; r < g.tiles_h; ++r)
    if ((cy >> r) & 1u) m |= (uint64_t)cx << (r * g.tiles_w);
  return m;
}

// min(|a-b|, |a+1-b|, |a-1-b|) (geometry.py:29-39)
__device__ __forceinline__ float periodic_err(float a, float b) {
  float e = fabsf(a - b);
  e = fminf(e, fabsf(a + 1.f - b));
  return fminf(e, fabsf(a - 1.f - b));
}

__global__ void chunk_kernel(const ChunkArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  uint64_t gm = 0, pm = 0;
  for (int s = 0; s < a.frequency; ++s) {
    const size_t i = ((size_t)b * a.F + s) * 2;
    gm |= occupancy(a.gt[i], a.gt[i + 1], a.geo);
    pm |= occupancy(a.pred[i], a.pred[i + 1], a.geo);
  }
  const int tiles = a.geo.tiles_w * a.geo.tiles_h;
  uint8_t* g = a.g + (size_t)b * tiles;
  uint8_t* p = a.p + (size_t)b * tiles;
  for (int t = 0; t < tiles; ++t) {
    g[t] = (uint8_t)((gm >> t) & 1ull);
    p[t] = (uint8_t)((pm >> t) & 1ull);
  }
  a.iou[b] = (float)__popcll(gm & pm) / (float)__popcll(gm | pm);
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

constexpr int kThreads = 128;

extern "C" int chunk_maps_launch(const ChunkArgs* args, void* stream) {
  const int blocks = (args->B + kThreads - 1) / kThreads;
  if (blocks > 0) chunk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int trajectory_metrics_launch(const MetricsArgs* args, void* stream) {
  const int blocks = (args->B * args->F + kThreads - 1) / kThreads;
  if (blocks > 0) metrics_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
