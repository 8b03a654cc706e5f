// K6: done-masked reverse GAE recurrence, lanes in parallel, in f32.
//
// Replaces the JAX package's rl/gae.py:compute_gae (:17-36), the
// lax.scan(reverse=True) that rl/ppo.py:125 runs once a collect.  The plain
// PyTorch version is kernels/gae.py:compute_gae_plain.
//
// Per lane n, for t = T-1 ... 0:
//   delta = r[t] + gamma * v[t+1] * (1 - done[t]) - v[t]       (v[T] = last_values)
//   adv[t] = delta + (gamma * lam) * (1 - done[t]) * adv[t+1]  (adv[T] = 0)
//   ret[t] = adv[t] + v[t]
// in gae.py:29-30's operation order, one serial chain a lane; built with
// -fmad=false, so every product and sum rounds as in the plain version and
// the JAX scan, and the result is bit-equal to the plain version.
//
// Bound: bytes.  It reads rewards, dones and values and writes adv and ret,
// 17 bytes an element (about 18 MB at [128, 8192]); 6 operations an element.
//
// Design.  A block owns a tile of 32 lanes (kernels/gae.py:gae_plan): 256
// blocks at 8192 lanes.  Only adv[t] = delta + c * adv[t+1] is serial, so
// one warp walks it and three helper warps do the rest around it, a chunk
// of 32 steps at a time through a ring of four chunks in shared memory:
//   - before the walk the helpers issue every load of the first four chunks
//     (16-byte cp.async: each 128-byte row of rewards and values in eight
//     copies, each 32-byte row of dones in two), latest steps first, so the
//     walk waits for one memory round trip, not one a step;
//   - for each chunk they compute delta and c = (gamma * lam) * (1 - done)
//     for every (step, lane) in place, in parallel over the steps;
//   - the walker warp, one thread a lane, runs the chain over the chunk
//     (a product and a sum a step) and leaves adv in place;
//   - meanwhile the helpers stage the next chunk and store the previous one:
//     ret = adv + v, and both as 16-byte stores of whole rows; then they
//     refill its buffer with the chunk four further down.
// Named barriers pass each chunk between the helpers and the walker.  Where
// N is not a multiple of 16 or a pointer is not 16-byte aligned, the chunks
// are read and written with ordinary loads and stores instead.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace mansy::tc;

namespace {

constexpr int kLanes = 32;                // lanes a block
constexpr int kChunk = 32;                // steps a chunk
constexpr int kBufs = 4;                  // chunks in the ring (and in flight)
constexpr int kHelpers = 96;              // warps 1-3
constexpr int kThreads = 32 + kHelpers;   // warp 0 walks

struct Chunk {                 // one chunk of the block's tile of lanes
  float x[kChunk][kLanes];     // rewards, then delta, then adv
  float v[kChunk][kLanes];     // values
  float c[kChunk][kLanes];     // (gamma * lam) * (1 - done)
  uint8_t d[kChunk][kLanes];   // dones
};
constexpr int kSmem = kBufs * (int)sizeof(Chunk);  // 53,248 bytes

// Named barriers (0 is __syncthreads): chunk k staged (helpers arrive, the
// walker waits), chunk k walked (the walker arrives, the helpers wait),
// each alternating between two ids; and one among the helpers alone.
constexpr int kStaged = 1, kWalked = 3, kHelperBar = 5;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace

// Field order must match kernels/gae.py:_GaeArgs.
struct GaeArgs {
  const float* __restrict__ rewards;      // [T, N]
  const uint8_t* __restrict__ dones;      // [T, N] bool
  const float* __restrict__ values;       // [T, N]
  const float* __restrict__ last_values;  // [N] V(s_T)
  float* __restrict__ adv;                // [T, N]
  float* __restrict__ ret;                // [T, N]
  int32_t T, N;
  float gamma;
  float gamma_lam;           // gamma * lam, rounded once to f32 as the JAX scalar product is
  int32_t lanes, chunk, blocks;  // the plan
  int32_t vec;               // 16-byte copies: N % 16 == 0 and every array 16-byte aligned
};

namespace {

// Chunk k holds steps [lo, lo + len): the latest kChunk steps not in an
// earlier chunk.
__device__ __forceinline__ void chunk_steps(int T, int k, int& lo, int& len) {
  const int hi = T - k * kChunk;
  lo = hi > kChunk ? hi - kChunk : 0;
  len = hi - lo;
}

// Helper thread h issues its share of chunk k's loads into s.
template <bool kVec>
__device__ __forceinline__ void load_chunk(Chunk& s, const GaeArgs& a, int n0, int k, int h) {
  int lo, len;
  chunk_steps(a.T, k, lo, len);
  if (kVec) {
#pragma unroll
    for (int i = h; i < kChunk * kLanes / 4; i += kHelpers) {  // 16 bytes: 4 lanes of f32
      const int row = i / (kLanes / 4), col = 4 * (i % (kLanes / 4));
      const bool ok = row < len && n0 + col < a.N;
      const size_t g = ok ? (size_t)(lo + row) * a.N + n0 + col : 0;
      cp_async16(&s.x[row][col], a.rewards + g, ok);
      cp_async16(&s.v[row][col], a.values + g, ok);
    }
    for (int i = h; i < kChunk * kLanes / 16; i += kHelpers) {  // 16 bytes: 16 lanes of dones
      const int row = i / (kLanes / 16), col = 16 * (i % (kLanes / 16));
      const bool ok = row < len && n0 + col < a.N;
      const size_t g = ok ? (size_t)(lo + row) * a.N + n0 + col : 0;
      cp_async16(reinterpret_cast<float*>(&s.d[row][col]),
                 reinterpret_cast<const float*>(a.dones + g), ok);
    }
  } else {
    const int lane = h % kLanes;
    if (n0 + lane < a.N) {
#pragma unroll 4
      for (int row = h / kLanes; row < len; row += kHelpers / kLanes) {
        const size_t g = (size_t)(lo + row) * a.N + n0 + lane;
        s.x[row][lane] = a.rewards[g];
        s.v[row][lane] = a.values[g];
        s.d[row][lane] = a.dones[g];
      }
    }
  }
}

// Helper thread h (lane h % 32) turns its rows of chunk k into delta and
// c; v_top is V(s_{lo + len}): the bootstrap for k = 0, else row 0 of the
// chunk before.
__device__ __forceinline__ void stage_chunk(Chunk& s, const GaeArgs& a, int len, int h,
                                            float v_top) {
  const int lane = h % kLanes;
#pragma unroll 4
  for (int row = h / kLanes; row < len; row += kHelpers / kLanes) {
    const float v_next = row + 1 < len ? s.v[row + 1][lane] : v_top;
    const float r = s.x[row][lane], v = s.v[row][lane];
    const float nd = 1.f - (s.d[row][lane] ? 1.f : 0.f);
    s.x[row][lane] = r + a.gamma * v_next * nd - v;
    s.c[row][lane] = a.gamma_lam * nd;
  }
}

// Helper thread h stores its share of chunk k's adv and ret = adv + v.
template <bool kVec>
__device__ __forceinline__ void store_chunk(const Chunk& s, const GaeArgs& a, int n0, int k,
                                            int h) {
  int lo, len;
  chunk_steps(a.T, k, lo, len);
  if (kVec) {
    for (int i = h; i < len * (kLanes / 4); i += kHelpers) {
      const int row = i / (kLanes / 4), q = i % (kLanes / 4), col = 4 * q;
      if (n0 + col < a.N) {
        const float4 adv = reinterpret_cast<const float4*>(s.x[row])[q];
        const float4 v = reinterpret_cast<const float4*>(s.v[row])[q];
        const size_t g = (size_t)(lo + row) * a.N + n0 + col;
        *reinterpret_cast<float4*>(a.adv + g) = adv;
        *reinterpret_cast<float4*>(a.ret + g) =
            make_float4(adv.x + v.x, adv.y + v.y, adv.z + v.z, adv.w + v.w);
      }
    }
  } else {
    const int lane = h % kLanes;
    if (n0 + lane < a.N) {
      for (int row = h / kLanes; row < len; row += kHelpers / kLanes) {
        const size_t g = (size_t)(lo + row) * a.N + n0 + lane;
        a.adv[g] = s.x[row][lane];
        a.ret[g] = s.x[row][lane] + s.v[row][lane];
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) gae_kernel(const GaeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Chunk* ring = reinterpret_cast<Chunk*>(smem);
  const int n0 = blockIdx.x * kLanes;
  const int chunks = (a.T + kChunk - 1) / kChunk;

  if (threadIdx.x < 32) {  // the walker: one thread a lane, adv[t] = delta + c * adv[t+1]
    const int lane = threadIdx.x;
    float adv = 0.f;
    for (int k = 0; k < chunks; ++k) {
      bar_sync(kStaged + (k & 1), kThreads);
      Chunk& s = ring[k % kBufs];
      int lo, len;
      chunk_steps(a.T, k, lo, len);
      if (len == kChunk) {
#pragma unroll
        for (int j = kChunk - 1; j >= 0; --j) {
          adv = s.x[j][lane] + s.c[j][lane] * adv;
          s.x[j][lane] = adv;
        }
      } else {
        for (int j = len - 1; j >= 0; --j) {
          adv = s.x[j][lane] + s.c[j][lane] * adv;
          s.x[j][lane] = adv;
        }
      }
      bar_arrive(kWalked + (k & 1), kThreads);
    }
    return;
  }

  const int h = threadIdx.x - 32;
  const int n = n0 + h % kLanes;
  const float last = n < a.N ? a.last_values[n] : 0.f;
#pragma unroll
  for (int k = 0; k < kBufs; ++k) {  // every chunk that fits is in flight before the walk
    if (k < chunks) load_chunk<kVec>(ring[k], a, n0, k, h);
    cp_async_commit();
  }
  // chunk m lies in copy group m: the first kBufs in the prologue, the rest
  // one a round from round 1 on
  for (int k = 0; k < chunks; ++k) {
    if (k == 0) {
      cp_async_wait<kBufs - 1>();
    } else {
      cp_async_wait<kBufs - 2>();
    }
    bar_sync(kHelperBar, kHelpers);  // chunk k has landed for every helper
    int lo, len;
    chunk_steps(a.T, k, lo, len);
    stage_chunk(ring[k % kBufs], a, len, h,
                k == 0 ? last : ring[(k - 1) % kBufs].v[0][h % kLanes]);
    bar_arrive(kStaged + (k & 1), kThreads);
    if (k > 0) {  // chunk k - 1 is walked: store it and refill its buffer
      bar_sync(kWalked + ((k - 1) & 1), kThreads);
      store_chunk<kVec>(ring[(k - 1) % kBufs], a, n0, k - 1, h);
      bar_sync(kHelperBar, kHelpers);  // every helper is done with the buffer
      if (k - 1 + kBufs < chunks) load_chunk<kVec>(ring[(k - 1) % kBufs], a, n0, k - 1 + kBufs, h);
      cp_async_commit();
    }
  }
  bar_sync(kWalked + ((chunks - 1) & 1), kThreads);
  store_chunk<kVec>(ring[(chunks - 1) % kBufs], a, n0, chunks - 1, h);
}

template <bool kVec>
int launch(const GaeArgs& a, cudaStream_t stream) {
  // the ring is above the 48 KB a block gets without asking (on the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      gae_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  gae_kernel<kVec><<<a.blocks, kThreads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gae_launch(const GaeArgs* args, void* stream) {
  const GaeArgs& a = *args;
  if (a.lanes != kLanes || a.chunk != kChunk || a.blocks != (a.N + kLanes - 1) / kLanes) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.blocks == 0 || a.T == 0) return (int)cudaSuccess;
  return a.vec ? launch<true>(a, (cudaStream_t)stream) : launch<false>(a, (cudaStream_t)stream);
}
