// K9: the policy-loss head with its gradient, in f32, one launch a minibatch.
//
// Replaces the loss heads that jax.value_and_grad differentiates in the JAX
// package: rl/ppo.py:_ppo_loss (:55-99, PPO mode) and the cross-entropy
// heads of rl/bc.py:bc_step (:31-37) and rl/dagger.py:_bc_batch_step
// (:123-131, CE mode), and the A2C loss of rl/a2c.py:a2c_update (:71-80,
// A2C mode).  The plain PyTorch version is
// kernels/policy_loss.py:policy_loss_plain.
//
// PPO mode: log_softmax and the action's log-prob, ratio = exp(logp - old),
// the advantage normalised over the minibatch (population std) or within
// each preference group, the clipped surrogate, the clipped value loss,
// entropy and the optional KL(anchor || pi) with a scalar or per-preference
// coefficient.  It writes the loss, its three terms (clip, vf, entropy) and
// d loss / d logits [B, A] and d loss / d value [B].  CE mode: ce - ent_coef
// * entropy, terms (ce, 0, entropy), and d loss / d logits.  A2C mode:
// -mean(logp[a] adv) + vf_coef mean((ret - v)^2) - ent_coef mean(entropy)
// with the raw advantages (no ratio, clip or normalisation), terms (actor,
// vf, entropy), d loss / d logits and d loss / d value.  Where JAX's
// min/max/clip meet a tie, the gradient is split in halves as lax.min and
// lax.max split it.
//
// Bound: bytes, and in practice the launch and its barriers: at B = 4096
// (CE) it reads ~262 KB and writes ~246 KB (about 17 operations a logit),
// 0.00015 ms at 3.35 TB/s.  What sets the time is latency: the row loads,
// one exp a logit on a dependent chain, and the reductions over the batch.
//
// Design: one thread-block cluster of `ctas` CTAs (at most 16, non-portable
// sizes), `rows` threads a CTA (128, 256 or 512), one row a thread; the plan
// comes from kernels/policy_loss.py:policy_loss_plan.  CTA r takes the row
// tiles r, r + ctas, ... of `rows` rows.  Each tile's [rows, A] slab of
// logits (and of anchor logits) is staged into shared memory with coalesced
// 16-byte cp.async copies (odd row stride, so a thread's row reads are free
// of bank conflicts), the first tile's issued before the advantage
// statistics so that its loads overlap them.  A thread keeps its row in
// registers (A fixed at 15 at compile time, loops unrolled to 16 with
// predication, the action's entry picked in the unrolled loop, each exp
// taken once), writes its gradient row back into the slab, and the slab
// goes out with coalesced 16-byte stores.
//
// Every reduction over the batch runs in a fixed order, so two launches on
// the same inputs give the same bits.  The advantage statistics (count,
// mean and centred sum of squares merged pairwise in one pass, or three sums
// a preference group, each group's by one warp) each CTA takes over all B
// rows itself, with four loads in flight a thread, so every CTA holds the
// same numbers without a round trip to the others.  The four loss sums go
// over the cluster: a CTA's warps in order, then after a cluster barrier
// rank 0 takes the CTAs' partials in rank order from distributed shared
// memory.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace mansy::tc;

namespace {

constexpr int kMaxA = 16;
constexpr int kMaxCtas = 16;                  // the largest (non-portable) cluster
constexpr int kMaxRows = 512;                 // threads (rows) a CTA
constexpr int kMaxWarps = kMaxRows / 32;
constexpr int kMaxPrefs = 16;
constexpr int kMaxDevices = 16;
constexpr int kCE = 0, kPPO = 1, kA2C = 2;    // the modes (kernels/policy_loss.py:MODES)
constexpr size_t kMaxSmem = 2 * kMaxRows * (kMaxA | 1) * sizeof(float);  // logits + anchor slabs
using mansy::kFull;

}  // namespace

// Field order must match kernels/policy_loss.py:_PolicyLossArgs.
struct PolicyLossArgs {
  const float* logits;         // [B, A]
  const float* value;          // [B] (PPO)
  const int32_t* action;       // [B]
  const float* old_log_prob;   // [B] (PPO)
  const float* old_value;      // [B] (PPO)
  const float* adv;            // [B] raw advantages (PPO)
  const float* ret;            // [B] value targets (PPO)
  const int32_t* pref_id;      // [B] or null
  const float* anchor_logits;  // [B, A] or null: no KL term
  const float* kl_coef;        // [n_kl]
  float* loss;                 // [1]
  float* terms;                // [3]
  float* dlogits;              // [B, A]
  float* dvalue;               // [B] (PPO)
  int32_t B, A;
  int32_t mode;                // kCE, kPPO or kA2C
  int32_t value_clip, norm_adv, norm_adv_per_pref, n_prefs, n_kl, kl_per_pref;
  int32_t rows, ctas;          // the plan: threads (rows of a tile) a CTA, CTAs of the cluster
  float clip_lo, clip_hi;      // 1 - eps_clip, 1 + eps_clip
  float eps_clip, vf_coef, ent_coef;
};

namespace {

// The warp's sum at lane 0, in a fixed order.
__device__ __forceinline__ float warp_total(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// Sums j < m of the cluster, into rank 0's tot[j]: red[j * warps + w] holds
// warp w's sum of value j.  A CTA adds its warps in order into part[j]; after
// a cluster barrier rank 0 adds the CTAs' parts in rank order.
__device__ void cluster_reduce(const float* red, int m, float* part, float* tot,
                               cg::cluster_group& cluster, int rank, int ranks) {
  __syncthreads();  // red is complete
  const int warps = blockDim.x >> 5;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[j * warps + w];
    part[j] = s;
  }
  cluster.sync();  // every CTA's partials are in place
  if (rank == 0) {
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < ranks; ++r) s += cluster.map_shared_rank(part, r)[j];
      tot[j] = s;
    }
  }
  __syncthreads();
}

// Loads a row of up to kBatch entries of a [B] array a thread, i = i0 +
// k * stride, at once (0 past B), so their latencies overlap.
constexpr int kBatch = 4;

template <typename T>
__device__ __forceinline__ void load_batch(T (&x)[kBatch], const T* p, int i0, int stride, int B) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int i = i0 + k * stride;
    x[k] = i < B ? p[i] : T(0);
  }
}

// Count, mean and centred sum of squares of a set of advantages; two sets
// merge by Chan, Golub and LeVeque's pairwise update (one row at a time it
// is Welford's), so the minibatch's mean and population std come from one
// pass and one reduction and round as torch's Welford std does.
struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float d = b.mean - a.mean, fb = b.n / n;
  return {n, a.mean + d * fb, (a.m2 + b.m2) + d * d * a.n * fb};
}

// The CTA's moments, merged in a fixed order (warps by shuffles, then the
// warps in order); every thread gets them.  red holds 3 floats a warp.
__device__ Moments block_moments(Moments m, float* red, float* tot) {
  for (int o = 16; o > 0; o >>= 1) {
    const Moments other = {__shfl_down_sync(kFull, m.n, o), __shfl_down_sync(kFull, m.mean, o),
                           __shfl_down_sync(kFull, m.m2, o)};
    m = merge(m, other);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if (lane == 0) {
    red[3 * warp] = m.n;
    red[3 * warp + 1] = m.mean;
    red[3 * warp + 2] = m.m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments c = {red[0], red[1], red[2]};
    for (int w = 1; w < warps; ++w) c = merge(c, {red[3 * w], red[3 * w + 1], red[3 * w + 2]});
    tot[0] = c.n;
    tot[1] = c.mean;
    tot[2] = c.m2;
  }
  __syncthreads();
  return {tot[0], tot[1], tot[2]};
}

// n floats from global src to shared dst, row stride A there and S here, by
// cp.async (16 bytes a copy where both sides allow it); the caller commits.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int A, int S) {
  if (S == A && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = threadIdx.x; e < n4; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e, true);
    for (int e = (n4 << 2) + threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e, true);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      cp_async4(dst + (e / A) * S + e % A, src + e, true);
  }
}

// n floats from shared src (row stride S) to global dst (row stride A).
__device__ __forceinline__ void unstage(float* dst, const float* src, int n, int A, int S) {
  if (S == A && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = threadIdx.x; e < n4; e += blockDim.x)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
    for (int e = (n4 << 2) + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[(e / A) * S + e % A];
  }
}

// d clip(x, lo, hi) / dx as jnp.clip (maximum, then minimum) gives it.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  const float m = fmaxf(x, lo);
  const float a = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  const float b = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return a * b;
}

// kA > 0: A is kA at compile time; 0: A = a.A (at most kMaxA).
template <int kA>
__global__ void __launch_bounds__(kMaxRows) policy_loss_kernel(const PolicyLossArgs a) {
  __shared__ float red[4 * kMaxWarps];  // per warp: 4 loss sums, or 3 moments
  __shared__ float part[4];            // the CTA's loss sums, read by rank 0
  __shared__ float tot[4];
  __shared__ float group[2 * kMaxPrefs];  // mean, std of each preference group
  extern __shared__ float4 dyn[];         // [rows, S] logits, then [rows, S] anchor logits
  float* slab = reinterpret_cast<float*>(dyn);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = a.ctas, R = a.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int B = a.B, A = kA > 0 ? kA : a.A, S = A | 1;
  const int tiles = (B + R - 1) / R;
  const float inv_b = 1.f / (float)B;
  float* aslab = slab + R * S;
  const bool ppo = a.mode == kPPO;
  const bool has_kl = ppo && a.anchor_logits;

  // ---- the first tile's slabs start loading under the statistics ----
  {
    const int r0 = rank * R, nr = min(R, B - r0);  // every CTA has a tile (ctas <= tiles)
    stage(slab, a.logits + (size_t)r0 * A, nr * A, A, S);
    if (has_kl) stage(aslab, a.anchor_logits + (size_t)r0 * A, nr * A, A, S);
    cp_async_commit();
  }

  // ---- advantage statistics over the whole minibatch ----
  // Every CTA takes them over all B rows itself, in one order, so they need
  // no round trip to the other CTAs (a minibatch's advantages are a few KB).
  float adv_mean = 0.f, adv_std = 0.f;
  if (ppo && a.norm_adv_per_pref) {
    for (int k = warp; k < a.n_prefs; k += warps) {  // warp w: groups w, w + warps, ...
      float s = 0.f, q = 0.f, c = 0.f;
      for (int i0 = lane; i0 < B; i0 += 32 * kBatch) {
        int id[kBatch];
        float x[kBatch];
        load_batch(id, a.pref_id, i0, 32, B);
        load_batch(x, a.adv, i0, 32, B);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (i0 + j * 32 < B && id[j] == k) {
            s += x[j];
            q += x[j] * x[j];
            c += 1.f;
          }
        }
      }
      s = warp_total(s);
      q = warp_total(q);
      c = fmaxf(warp_total(c), 1.f);
      if (lane == 0) {
        const float mean = s / c;
        const float var = q / c - mean * mean;
        group[2 * k] = mean;
        group[2 * k + 1] = sqrtf(fmaxf(var, 0.f));
      }
    }
    __syncthreads();
  } else if (ppo && a.norm_adv) {
    Moments m = {0.f, 0.f, 0.f};
    for (int i0 = tid; i0 < B; i0 += blockDim.x * kBatch) {
      float x[kBatch];
      load_batch(x, a.adv, i0, blockDim.x, B);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (i0 + j * (int)blockDim.x < B) m = merge(m, {1.f, x[j], 0.f});
    }
    m = block_moments(m, red, tot);
    adv_mean = m.mean;
    adv_std = sqrtf(m.m2 / (float)B);
  }

  // ---- per row: the loss terms and the gradient ----
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;  // clip|logp, vf, entropy, kl
  for (int t = rank; t < tiles; t += ranks) {
    const int r0 = t * R, nr = min(R, B - r0);
    if (t != rank) {
      __syncthreads();  // the previous tile's gradient has left the slab
      stage(slab, a.logits + (size_t)r0 * A, nr * A, A, S);
      if (has_kl) stage(aslab, a.anchor_logits + (size_t)r0 * A, nr * A, A, S);
      cp_async_commit();
    }
    const int i = r0 + tid, act = tid < nr ? a.action[i] : 0;
    cp_async_wait<0>();
    __syncthreads();
    if (tid < nr) {
      float* row = slab + tid * S;
      float lp[kMaxA], p[kMaxA];  // the logits, then log-probs; exps, then probs
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxA; ++j) {
        if (j < A) {
          lp[j] = row[j];
          mx = fmaxf(mx, lp[j]);
        }
      }
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxA; ++j) {
        if (j < A) {
          p[j] = expf(lp[j] - mx);
          se += p[j];
        }
      }
      const float lse = logf(se);
      float plp = 0.f, lpa = 0.f;  // sum p log p; the action's log-prob
#pragma unroll
      for (int j = 0; j < kMaxA; ++j) {
        if (j < A) {
          lp[j] = (lp[j] - mx) - lse;
          p[j] = p[j] / se;
          plp += p[j] * lp[j];
          if (j == act) lpa = lp[j];
        }
      }
      const float H = -plp;
      acc2 += H;
      const float ent_g = a.ent_coef * inv_b;  // d loss / d H_i = -ent_coef / B
      float g_logp;                            // d loss / d lp[act]
      float kl_scale = 0.f, Sa = 0.f;
      float ap[kMaxA];
#pragma unroll
      for (int j = 0; j < kMaxA; ++j) ap[j] = 0.f;
      if (ppo) {
        const float ratio = expf(lpa - a.old_log_prob[i]);
        float an = a.adv[i];
        if (a.norm_adv_per_pref) {
          const int k = a.pref_id[i];
          const bool in = k >= 0 && k < a.n_prefs;
          an = (an - (in ? group[2 * k] : 0.f)) / ((in ? group[2 * k + 1] : 0.f) + 1e-8f);
        } else if (a.norm_adv) {
          an = (an - adv_mean) / (adv_std + 1e-8f);
        }
        const float c = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
        const float t1 = ratio * an, t2 = c * an;
        acc0 += fminf(t1, t2);
        const float dc = clip_grad(ratio, a.clip_lo, a.clip_hi);
        const float gr = t1 < t2 ? an : (t2 < t1 ? an * dc : 0.5f * an + 0.5f * (an * dc));
        g_logp = -inv_b * gr * ratio;

        const float v = a.value[i], ov = a.old_value[i], Rt = a.ret[i];
        const float r1 = Rt - v, vf1 = r1 * r1, dvf1 = -2.f * r1;
        float gv;
        if (a.value_clip) {
          const float d = v - ov;
          const float vc = ov + fminf(fmaxf(d, -a.eps_clip), a.eps_clip);
          const float r2 = Rt - vc, vf2 = r2 * r2;
          const float dvf2 = -2.f * r2 * clip_grad(d, -a.eps_clip, a.eps_clip);
          acc1 += fmaxf(vf1, vf2);
          gv = vf1 > vf2 ? dvf1 : (vf2 > vf1 ? dvf2 : 0.5f * dvf1 + 0.5f * dvf2);
        } else {
          acc1 += vf1;
          gv = dvf1;
        }
        a.dvalue[i] = a.vf_coef * inv_b * gv;

        if (a.anchor_logits) {
          const float* arow = aslab + tid * S;
          float al[kMaxA];
          float amx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kMaxA; ++j) {
            if (j < A) {
              al[j] = arow[j];
              amx = fmaxf(amx, al[j]);
            }
          }
          float ase = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxA; ++j)
            if (j < A) ase += expf(al[j] - amx);
          const float alse = logf(ase);
          float kl = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxA; ++j) {
            if (j < A) {
              const float alp = (al[j] - amx) - alse;
              ap[j] = expf(alp);
              Sa += ap[j];
              kl += ap[j] * (alp - lp[j]);
            }
          }
          float coef = a.kl_coef[0];
          if (a.kl_per_pref) {
            const int k = min(max(a.pref_id[i], 0), a.n_kl - 1);  // JAX gathers clamp
            coef = a.kl_coef[k];
            acc3 += coef * kl;
          } else {
            acc3 += kl;
          }
          kl_scale = coef * inv_b;
        }
      } else if (a.mode == kA2C) {
        const float an = a.adv[i], r1 = a.ret[i] - a.value[i];
        acc0 += lpa * an;
        g_logp = -inv_b * an;
        acc1 += r1 * r1;
        a.dvalue[i] = a.vf_coef * inv_b * (-2.f * r1);
      } else {
        acc0 += lpa;
        g_logp = -inv_b;
      }
#pragma unroll
      for (int j = 0; j < kMaxA; ++j) {
        if (j < A) {
          float g = g_logp * ((j == act ? 1.f : 0.f) - p[j]) + ent_g * (p[j] * (lp[j] + H));
          if (kl_scale != 0.f) g += kl_scale * (p[j] * Sa - ap[j]);
          row[j] = g;  // the thread's own row: its logits are in registers
        }
      }
    }
    __syncthreads();
    unstage(a.dlogits + (size_t)r0 * A, slab, nr * A, A, S);
  }

  // ---- the loss sums over the cluster; rank 0 writes the loss ----
  acc0 = warp_total(acc0);
  acc1 = warp_total(acc1);
  acc2 = warp_total(acc2);
  acc3 = warp_total(acc3);
  if (lane == 0) {
    red[warp] = acc0;
    red[warps + warp] = acc1;
    red[2 * warps + warp] = acc2;
    red[3 * warps + warp] = acc3;
  }
  cluster_reduce(red, 4, part, tot, cluster, rank, ranks);
  if (rank == 0 && tid == 0) {
    const float ent = tot[2] / (float)B;
    if (a.mode != kCE) {  // PPO's clip term, or A2C's actor term (no anchor in A2C mode)
      const float clip_loss = -(tot[0] / (float)B);
      const float vf_loss = tot[1] / (float)B;
      float loss = clip_loss + a.vf_coef * vf_loss - a.ent_coef * ent;
      if (a.anchor_logits) {
        loss = a.kl_per_pref ? loss + tot[3] / (float)B : loss + a.kl_coef[0] * (tot[3] / (float)B);
      }
      a.loss[0] = loss;
      a.terms[0] = clip_loss;
      a.terms[1] = vf_loss;
    } else {
      const float ce = -(tot[0] / (float)B);
      a.loss[0] = ce - a.ent_coef * ent;
      a.terms[0] = ce;
      a.terms[1] = 0.f;
    }
    a.terms[2] = ent;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <int kA>
cudaError_t launch(const PolicyLossArgs& a, cudaStream_t stream) {
  // Once a device: the largest slabs' shared memory (above the 48 KB a launch
  // gets without asking) and clusters of more than 8 CTAs.
  static bool prepared[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= kMaxDevices || !prepared[dev])) {
    e = cudaFuncSetAttribute(policy_loss_kernel<kA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(policy_loss_kernel<kA>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess && dev < kMaxDevices) prepared[dev] = true;
  }
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)(a.mode == kPPO && a.anchor_logits ? 2 : 1) * a.rows * (a.A | 1) *
                      sizeof(float);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas);
  cfg.blockDim = dim3(a.rows);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.ctas;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, policy_loss_kernel<kA>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" int policy_loss_launch(const PolicyLossArgs* args, void* stream) {
  const PolicyLossArgs& a = *args;
  if (a.A < 1 || a.A > kMaxA || a.ctas < 1 || a.ctas > kMaxCtas || a.rows < 32 ||
      a.rows > kMaxRows || a.rows % 32 != 0 || a.mode < kCE || a.mode > kA2C ||
      (a.mode == kA2C && a.anchor_logits) ||
      (a.mode == kPPO && a.norm_adv_per_pref && (a.n_prefs < 1 || a.n_prefs > kMaxPrefs)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(a.A == 15 ? launch<15>(a, s) : launch<0>(a, s));
}
