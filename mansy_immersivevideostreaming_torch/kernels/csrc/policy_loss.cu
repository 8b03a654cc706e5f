// K9: the policy-loss head with its gradient, in f32, one launch a minibatch.
//
// Replaces the loss heads that jax.value_and_grad differentiates in the JAX
// package: rl/ppo.py:_ppo_loss (:55-99, PPO mode) and the cross-entropy
// heads of rl/bc.py:bc_step (:31-37) and rl/dagger.py:_bc_batch_step
// (:123-131, CE mode).  The plain PyTorch version is
// kernels/policy_loss.py:policy_loss_plain.
//
// PPO mode: log_softmax and the action's log-prob, ratio = exp(logp - old),
// the advantage normalised over the minibatch (population std) or within
// each preference group, the clipped surrogate, the clipped value loss,
// entropy and the optional KL(anchor || pi) with a scalar or per-preference
// coefficient.  It writes the loss, its three terms (clip, vf, entropy) and
// d loss / d logits [B, A] and d loss / d value [B].  CE mode: ce - ent_coef
// * entropy, terms (ce, 0, entropy), and d loss / d logits.  Where JAX's
// min/max/clip meet a tie, the gradient is split in halves as lax.min and
// lax.max split it.
//
// Bound: bytes, and in practice the launch: at B = 512 it reads ~45 KB and
// writes ~32 KB (about 60 operations a logit).  Design: one block of 1024
// threads.  The advantage statistics are block-wide reductions taken before
// the per-row pass (one mean and one centred sum of squares, or three sums a
// preference group); the per-row pass keeps a row's 15 logits in registers
// and writes its gradient; the four loss sums are a last block reduction.
// Every reduction has a fixed order, so a run repeats bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxA = 16;

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
  int32_t ppo;                 // 1: PPO mode, 0: CE mode
  int32_t value_clip, norm_adv, norm_adv_per_pref, n_prefs, n_kl, kl_per_pref;
  float clip_lo, clip_hi;      // 1 - eps_clip, 1 + eps_clip
  float eps_clip, vf_coef, ent_coef;
};

// Fixed-order sum over the block; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// d clip(x, lo, hi) / dx as jnp.clip (maximum, then minimum) gives it.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  const float m = fmaxf(x, lo);
  const float a = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  const float b = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return a * b;
}

__global__ void __launch_bounds__(kThreads, 1) policy_loss_kernel(const PolicyLossArgs a) {
  __shared__ float red[33];
  extern __shared__ float group[];  // [2 * n_prefs]: mean, std of each preference group
  const int tid = threadIdx.x, B = a.B, A = a.A;
  const float inv_b = 1.f / (float)B;

  // ---- advantage statistics over the minibatch ----
  float adv_mean = 0.f, adv_std = 0.f;
  if (a.ppo && a.norm_adv_per_pref) {
    for (int k = 0; k < a.n_prefs; ++k) {
      float s = 0.f, q = 0.f, c = 0.f;
      for (int i = tid; i < B; i += blockDim.x) {
        if (a.pref_id[i] == k) {
          const float x = a.adv[i];
          s += x;
          q += x * x;
          c += 1.f;
        }
      }
      s = block_sum(s, red);
      q = block_sum(q, red);
      c = fmaxf(block_sum(c, red), 1.f);
      if (tid == 0) {
        const float mean = s / c;
        const float var = q / c - mean * mean;
        group[2 * k] = mean;
        group[2 * k + 1] = sqrtf(fmaxf(var, 0.f));
      }
    }
    __syncthreads();
  } else if (a.ppo && a.norm_adv) {
    float s = 0.f;
    for (int i = tid; i < B; i += blockDim.x) s += a.adv[i];
    adv_mean = block_sum(s, red) / (float)B;
    float q = 0.f;
    for (int i = tid; i < B; i += blockDim.x) {
      const float d = a.adv[i] - adv_mean;
      q += d * d;
    }
    adv_std = sqrtf(block_sum(q, red) / (float)B);
  }

  // ---- per row: the loss terms and the gradient ----
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;  // clip|logp, vf, entropy, kl
  for (int i = tid; i < B; i += blockDim.x) {
    float l[kMaxA], lp[kMaxA], p[kMaxA];
    float mx = -INFINITY;
    for (int j = 0; j < A; ++j) {
      l[j] = a.logits[(size_t)i * A + j];
      mx = fmaxf(mx, l[j]);
    }
    float se = 0.f;
    for (int j = 0; j < A; ++j) se += expf(l[j] - mx);
    const float lse = logf(se);
    float plp = 0.f;
    for (int j = 0; j < A; ++j) {
      lp[j] = (l[j] - mx) - lse;
      p[j] = expf(l[j] - mx) / se;
      plp += p[j] * lp[j];
    }
    const float H = -plp;
    acc2 += H;
    const int act = a.action[i];
    const float ent_g = a.ent_coef * inv_b;  // d loss / d H_i = -ent_coef / B
    float g_logp;                            // d loss / d lp[act]
    float kl_scale = 0.f, S = 0.f;
    float ap[kMaxA];
    if (a.ppo) {
      const float ratio = expf(lp[act] - a.old_log_prob[i]);
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

      const float v = a.value[i], ov = a.old_value[i], R = a.ret[i];
      const float r1 = R - v, vf1 = r1 * r1, dvf1 = -2.f * r1;
      float gv;
      if (a.value_clip) {
        const float d = v - ov;
        const float vc = ov + fminf(fmaxf(d, -a.eps_clip), a.eps_clip);
        const float r2 = R - vc, vf2 = r2 * r2;
        const float dvf2 = -2.f * r2 * clip_grad(d, -a.eps_clip, a.eps_clip);
        acc1 += fmaxf(vf1, vf2);
        gv = vf1 > vf2 ? dvf1 : (vf2 > vf1 ? dvf2 : 0.5f * dvf1 + 0.5f * dvf2);
      } else {
        acc1 += vf1;
        gv = dvf1;
      }
      a.dvalue[i] = a.vf_coef * inv_b * gv;

      if (a.anchor_logits) {
        float amx = -INFINITY, al[kMaxA];
        for (int j = 0; j < A; ++j) {
          al[j] = a.anchor_logits[(size_t)i * A + j];
          amx = fmaxf(amx, al[j]);
        }
        float ase = 0.f;
        for (int j = 0; j < A; ++j) ase += expf(al[j] - amx);
        const float alse = logf(ase);
        float kl = 0.f;
        for (int j = 0; j < A; ++j) {
          const float alp = (al[j] - amx) - alse;
          ap[j] = expf(alp);
          S += ap[j];
          kl += ap[j] * (alp - lp[j]);
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
    } else {
      acc0 += lp[act];
      g_logp = -inv_b;
    }
    for (int j = 0; j < A; ++j) {
      float g = g_logp * ((j == act ? 1.f : 0.f) - p[j]) + ent_g * (p[j] * (lp[j] + H));
      if (kl_scale != 0.f) g += kl_scale * (p[j] * S - ap[j]);
      a.dlogits[(size_t)i * A + j] = g;
    }
  }

  acc0 = block_sum(acc0, red);
  acc1 = block_sum(acc1, red);
  acc2 = block_sum(acc2, red);
  acc3 = block_sum(acc3, red);
  if (tid == 0) {
    const float ent = acc2 / (float)B;
    if (a.ppo) {
      const float clip_loss = -(acc0 / (float)B);
      const float vf_loss = acc1 / (float)B;
      float loss = clip_loss + a.vf_coef * vf_loss - a.ent_coef * ent;
      if (a.anchor_logits) {
        loss = a.kl_per_pref ? loss + acc3 / (float)B : loss + a.kl_coef[0] * (acc3 / (float)B);
      }
      a.loss[0] = loss;
      a.terms[0] = clip_loss;
      a.terms[1] = vf_loss;
    } else {
      const float ce = -(acc0 / (float)B);
      a.loss[0] = ce - a.ent_coef * ent;
      a.terms[0] = ce;
      a.terms[1] = 0.f;
    }
    a.terms[2] = ent;
  }
}

extern "C" int policy_loss_launch(const PolicyLossArgs* args, void* stream) {
  const size_t smem = 2 * (size_t)(args->n_prefs > 0 ? args->n_prefs : 1) * sizeof(float);
  policy_loss_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
