// K10: the MANSY actor-critic backward, every parameter gradient in f32.
//
// Replaces what jax.grad derives from the JAX package's
// models/abr_nets.py:_branch, MansyFeatureNet and MansyActorCritic.__call__
// (:105-186) in the PPO, BC and DAgger updates (rl/ppo.py:163,
// rl/bc.py:39, rl/dagger.py:133).  The plain PyTorch version is
// kernels/actor_critic.py:actor_critic_backward_plain.  It reads the
// activations K3's training mode saved (the branch features F [B, nb x 128]
// and the fc outputs Hf [B, 256], both after LeakyReLU) and takes each
// LeakyReLU's derivative from the sign of its output (1 where it is >= 0,
// as jax.nn.leaky_relu's where(x >= 0, ...) gives it, else 0.01).
//
// With y = Hf + [cond, cond] (the heads' inputs; cond is branch 9):
//   dW_aout = y_a^T dlogits, dW_cout = y_c^T dvalue, their biases the sums;
//   dPre_fc = [dlogits W_aout^T, dvalue W_cout^T] * leaky'(Hf);
//   dW_fc = F^T dPre_fc [nb x 128, 256], db_fc its column sums;
//   dPre_b = (dPre_fc W_fc^T + the residual's dy_a + dy_c on branch 9's
//   columns) * leaky'(F);
//   dW_branch[off_b : off_b+1] = x[:, off_b : off_b+1]^T dPre_b[:, 128b : 128b+128]
//   (K3's compact block-diagonal layout), db_branch the column sums.
// The logit prior has no parameters and the action values are data, so it
// adds nothing here.
//
// Bound: f32 operations.  About 2 (1280 x 256 x 2 + 748 x 128) = 1.5 MFLOP a
// row for 10 branches (0.77 GFLOP at B = 512, ~0.012 ms at 67 TFLOP/s outside
// the tensor cores).  Design: five launches on the stream, no atomics, so
// every sum has a fixed order and a run repeats bit for bit:
//   1. head: one thread a (row, hidden unit): y, dPre_fc and the residual's
//      gradient dcond [B, 128];
//   2. dPre_b (depth 256, the residual and leaky' in the epilogue) with a
//      register-tiled f32 product kernel (64 x 64 tiles, 16-deep k-steps
//      staged in shared memory, 4 x 4 a thread, fmaf; no TF32);
//   3. the products whose depth is the batch (the two head weights, dW_fc
//      and the branch weights, one grid layer each) with the same kernel,
//      the depth cut in `splits` slices (the wrapper takes one a 256 rows,
//      at most 16) so that a few hundred tiles cover the card at any batch;
//      each slice writes a partial tile;
//   4. the partial tiles summed slice by slice into the gradients;
//   5. the bias column sums: 32 row-walkers a column and a tree in shared
//      memory, all four biases in one launch.
// A first version (one thread a bias column, no slices) took 3.1 ms at
// B = 4096 on an H100, most of it in the serial column sums and the 80-tile
// dW_fc; this one 0.41 ms.
// Simple and right first: no wgmma, no TMA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kH = 128;       // hidden width
constexpr int kMaxNB = 11;    // branches: 10, or 11 with action values
constexpr int kCond = 9;      // the cond branch
constexpr int kTile = 64;     // product tile (rows and columns)
constexpr int kStep = 16;     // product k-step
constexpr int kThreads = 256;
constexpr int kMaxProducts = kMaxNB + 3;  // the two heads, dW_fc, the branches
constexpr int kMaxSplits = 16;

}  // namespace

// Field order must match kernels/actor_critic.py:_ActorCriticBackwardArgs.
struct ActorCriticBackwardArgs {
  const float* x;        // [B, ldx] packed observations
  const float* feats;    // [B, nb * 128] branch features (K3 training mode)
  const float* hidden;   // [B, 256] fc outputs before the residual
  const float* w_fc;     // [nb * 128, 256]
  const float* w_aout;   // [128, A]
  const float* w_cout;   // [128]
  const float* dlogits;  // [B, A]
  const float* dvalue;   // [B]
  float* y;              // scratch [B, 256]: the heads' inputs
  float* dpre_fc;        // scratch [B, 256]
  float* dcond;          // scratch [B, 128]
  float* dpre_b;         // scratch [B, nb * 128]
  float* partial;        // scratch [splits, 128 A + 128 + nb 128 x 256 + branch_off[nb] x 128]
  float* dw_branch;      // [branch_off[nb], 128]
  float* db_branch;      // [nb, 128]
  float* dw_fc;          // [nb * 128, 256]
  float* db_fc;          // [256]
  float* dw_aout;        // [128, A]
  float* db_aout;        // [A]
  float* dw_cout;        // [128]
  float* db_cout;        // [1]
  int32_t B, ldx, A, num_branches, splits;
  int32_t branch_off[kMaxNB + 1];
};

// C[m, n] = sum_k A(m, k) B(k, n) with A(m, k) = a[m sam + k sak] and
// B(k, n) = b[k sbk + n sbn]; C[m, n] at c[m ldc + n].  With depth slices,
// slice s sums its k-range into c + s M N (ldc = N).
struct Product {
  const float* a;
  const float* b;
  float* c;
  int32_t M, N, K;
  int64_t sam, sak, sbk, sbn, ldc;
};

struct Products {
  Product p[kMaxProducts];
  int32_t splits;  // blockIdx.z = product * splits + slice
  // epilogue of the dPre_b product (null: plain store): + dcond on the cond
  // branch's columns, then times leaky'(feats)
  const float* feats;
  const float* dcond;
};

// The slices of one product summed in order into its gradient.
struct Reduce {
  const float* partial;  // [splits, M, N]
  float* c;              // [M, N] at ldc
  int32_t M, N;
  int64_t ldc, first;    // first: the product's offset in the flat output index
};

struct Reduces {
  Reduce r[kMaxProducts];
  int32_t count, splits;
  int64_t total;
};

// dst[n] = sum over the rows of src[row * ld + n].
struct ColumnSum {
  const float* src;
  float* dst;
  int32_t rows, cols, ld;
};

struct ColumnSums {
  ColumnSum s[4];
};

__device__ __forceinline__ float leaky_grad(float out, float g) { return out >= 0.f ? g : 0.01f * g; }

__global__ void head_kernel(const ActorCriticBackwardArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx / kH, n = idx % kH;
  if (row >= a.B) return;
  const int ldf = a.num_branches * kH;
  const float cond = a.feats[(size_t)row * ldf + kCond * kH + n];
  float dya = 0.f;
  for (int o = 0; o < a.A; ++o)
    dya = fmaf(a.dlogits[(size_t)row * a.A + o], a.w_aout[n * a.A + o], dya);
  const float dyc = a.dvalue[row] * a.w_cout[n];
  const float ha = a.hidden[(size_t)row * 2 * kH + n];
  const float hc = a.hidden[(size_t)row * 2 * kH + kH + n];
  a.y[(size_t)row * 2 * kH + n] = ha + cond;
  a.y[(size_t)row * 2 * kH + kH + n] = hc + cond;
  a.dpre_fc[(size_t)row * 2 * kH + n] = leaky_grad(ha, dya);
  a.dpre_fc[(size_t)row * 2 * kH + kH + n] = leaky_grad(hc, dyc);
  a.dcond[(size_t)row * kH + n] = dya + dyc;
}

__global__ void __launch_bounds__(kThreads) product_kernel(const Products ps) {
  const Product& g = ps.p[blockIdx.z / ps.splits];
  const int slice = blockIdx.z % ps.splits;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  if (m0 >= g.M || n0 >= g.N) return;
  // the slice's k-range, in whole k-steps; an empty range writes zeros
  const int span = ((g.K + ps.splits - 1) / ps.splits + kStep - 1) / kStep * kStep;
  const int kbeg = slice * span, kend = min(g.K, kbeg + span);
  float* c = g.c + (size_t)slice * g.M * g.N;
  __shared__ float As[kStep][kTile + 4];
  __shared__ float Bs[kStep][kTile + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kStep) {
    // stage the tiles, neighbouring threads on whichever index is contiguous
#pragma unroll
    for (int r = 0; r < (kTile * kStep) / kThreads; ++r) {
      const int e = tid + kThreads * r;
      int m, k;
      if (g.sam == 1) { m = e % kTile; k = e / kTile; } else { k = e % kStep; m = e / kStep; }
      As[k][m] = (m0 + m < g.M && k0 + k < kend) ? g.a[(m0 + m) * g.sam + (k0 + k) * g.sak] : 0.f;
      int n;
      if (g.sbn == 1) { n = e % kTile; k = e / kTile; } else { k = e % kStep; n = e / kStep; }
      Bs[k][n] = (n0 + n < g.N && k0 + k < kend) ? g.b[(k0 + k) * g.sbk + (n0 + n) * g.sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= g.N) continue;
      float v = acc[i][j];
      if (ps.feats) {
        if (n >= kCond * kH && n < (kCond + 1) * kH) v += ps.dcond[(size_t)m * kH + n - kCond * kH];
        v = leaky_grad(ps.feats[(size_t)m * g.ldc + n], v);
      }
      c[(size_t)m * g.ldc + n] = v;
    }
  }
}

__global__ void reduce_kernel(const Reduces rs) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rs.total) return;
  int j = 0;
  while (j + 1 < rs.count && idx >= rs.r[j + 1].first) ++j;
  const Reduce& r = rs.r[j];
  const int64_t e = idx - r.first, size = (int64_t)r.M * r.N;
  float s = 0.f;
  for (int slice = 0; slice < rs.splits; ++slice) s += r.partial[slice * size + e];
  r.c[(e / r.N) * r.ldc + e % r.N] = s;
}

// blockIdx.y picks the sum; 32 x 32 threads: a column each along x, the rows
// split over y, then a fixed-order tree over y.
__global__ void column_sum_kernel(const ColumnSums cs) {
  const ColumnSum& c = cs.s[blockIdx.y];
  if (blockIdx.x * 32 >= c.cols) return;
  __shared__ float part[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y, n = blockIdx.x * 32 + tx;
  float v = 0.f;
  if (n < c.cols)
    for (int r = ty; r < c.rows; r += 32) v += c.src[(size_t)r * c.ld + n];
  part[ty][tx] = v;
  __syncthreads();
  for (int h = 16; h > 0; h >>= 1) {
    if (ty < h) part[ty][tx] += part[ty + h][tx];
    __syncthreads();
  }
  if (ty == 0 && n < c.cols) c.dst[n] = part[0][tx];
}

namespace {

Product product(const float* a, const float* b, float* c, int M, int N, int K, int64_t sam,
                int64_t sak, int64_t sbk, int64_t sbn, int64_t ldc) {
  return Product{a, b, c, M, N, K, sam, sak, sbk, sbn, ldc};
}

int run_products(const Products& ps, int count, cudaStream_t stream) {
  int max_m = 0, max_n = 0;
  for (int z = 0; z < count; ++z) {
    max_m = ps.p[z].M > max_m ? ps.p[z].M : max_m;
    max_n = ps.p[z].N > max_n ? ps.p[z].N : max_n;
  }
  const dim3 grid((max_n + kTile - 1) / kTile, (max_m + kTile - 1) / kTile, count * ps.splits);
  product_kernel<<<grid, kThreads, 0, stream>>>(ps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int actor_critic_backward_launch(const ActorCriticBackwardArgs* args, void* stream) {
  const ActorCriticBackwardArgs& a = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int B = a.B, A = a.A, nb = a.num_branches, F = nb * kH, S = a.splits;
  if (S < 1 || S > kMaxSplits || nb > kMaxNB) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  int err;

  head_kernel<<<(B * kH + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;

  // dPre_b = (dPre_fc W_fc^T + dcond on the cond branch) * leaky'(F)
  Products dfeat{};
  dfeat.p[0] = product(a.dpre_fc, a.w_fc, a.dpre_b, B, F, 2 * kH, 2 * kH, 1, 1, 2 * kH, F);
  dfeat.splits = 1;
  dfeat.feats = a.feats;
  dfeat.dcond = a.dcond;
  if ((err = run_products(dfeat, 1, s))) return err;

  // depth B, in S slices into the partial tiles: dW_aout = y_a^T dlogits,
  // dW_cout = y_c^T dvalue, dW_fc = F^T dPre_fc and
  // dW_branch[off_b : off_b+1] = x[:, off_b : off_b+1]^T dPre_b[:, 128b : 128b+128]
  Products deep{};
  Reduces red{};
  float* out[kMaxProducts];
  int64_t ldc[kMaxProducts];
  deep.p[0] = product(a.y, a.dlogits, nullptr, kH, A, B, 1, 2 * kH, A, 1, A);
  out[0] = a.dw_aout, ldc[0] = A;
  deep.p[1] = product(a.y + kH, a.dvalue, nullptr, kH, 1, B, 1, 2 * kH, 1, 1, 1);
  out[1] = a.dw_cout, ldc[1] = 1;
  deep.p[2] = product(a.feats, a.dpre_fc, nullptr, F, 2 * kH, B, 1, F, 2 * kH, 1, 2 * kH);
  out[2] = a.dw_fc, ldc[2] = 2 * kH;
  for (int b = 0; b < nb; ++b) {
    const int off = a.branch_off[b], in_b = a.branch_off[b + 1] - off;
    deep.p[3 + b] = product(a.x + off, a.dpre_b + b * kH, nullptr, in_b, kH, B, 1, a.ldx, F, 1,
                            kH);
    out[3 + b] = a.dw_branch + (size_t)off * kH, ldc[3 + b] = kH;
  }
  const int count = 3 + nb;
  float* partial = a.partial;
  int64_t first = 0;
  for (int j = 0; j < count; ++j) {
    Product& g = deep.p[j];
    const int64_t size = (int64_t)g.M * g.N;
    g.c = partial;
    g.ldc = g.N;
    red.r[j] = Reduce{partial, out[j], g.M, g.N, ldc[j], first};
    partial += S * size;
    first += size;
  }
  deep.splits = S;
  if ((err = run_products(deep, count, s))) return err;
  red.count = count, red.splits = S, red.total = first;
  reduce_kernel<<<(unsigned)((first + kThreads - 1) / kThreads), kThreads, 0, s>>>(red);
  if ((err = (int)cudaGetLastError())) return err;

  ColumnSums sums{};
  sums.s[0] = ColumnSum{a.dpre_fc, a.db_fc, B, 2 * kH, 2 * kH};
  sums.s[1] = ColumnSum{a.dpre_b, a.db_branch, B, F, F};
  sums.s[2] = ColumnSum{a.dlogits, a.db_aout, B, A, A};
  sums.s[3] = ColumnSum{a.dvalue, a.db_cout, B, 1, 1};
  column_sum_kernel<<<dim3((F + 31) / 32, 4), dim3(32, 32), 0, s>>>(sums);
  return (int)cudaGetLastError();
}
