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
// in gae.py:29-30's operation order; built with -fmad=false, so every
// product and sum rounds as in the plain version and the JAX scan.
//
// Bound: bytes.  It reads rewards, dones and values and writes adv and ret,
// 17 bytes an element (about 18 MB at [128, 8192]); there are 6 operations
// an element.  Design: one thread a lane walks t downwards.  [T, N] is
// row-major with N contiguous, so at every t a warp's loads and stores are
// coalesced; T iterations of a serial chain a thread, which the loads of
// other warps hide at N in the thousands.

#include <cstdint>
#include <cuda_runtime.h>

// Field order must match kernels/gae.py:_GaeArgs.
struct GaeArgs {
  const float* rewards;      // [T, N]
  const uint8_t* dones;      // [T, N] bool
  const float* values;       // [T, N]
  const float* last_values;  // [N] V(s_T)
  float* adv;                // [T, N]
  float* ret;                // [T, N]
  int32_t T, N;
  float gamma;
  float gamma_lam;           // gamma * lam, rounded once to f32 as the JAX scalar product is
};

__global__ void gae_kernel(const GaeArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  float v_next = a.last_values[n];
  float adv_next = 0.f;
  for (int t = a.T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * a.N + n;
    const float r = a.rewards[i], v = a.values[i];
    const float nd = 1.f - (a.dones[i] ? 1.f : 0.f);
    const float delta = r + a.gamma * v_next * nd - v;
    adv_next = delta + a.gamma_lam * nd * adv_next;
    a.adv[i] = adv_next;
    a.ret[i] = adv_next + v;
    v_next = v;
  }
}

extern "C" int gae_launch(const GaeArgs* args, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (args->N + kThreads - 1) / kThreads;
  if (blocks > 0) gae_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
