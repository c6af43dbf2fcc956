// Linear-Gaussian (LG) family statistics for NVIDIA Hopper (sm_90a): the
// k-fold CV log-likelihood, the holdout log-likelihood, the Grams and the
// BIC of F candidate families in one launch.
//
// lg_cv_f32 computes what `batched_lg_cv_loglik` of
// pybnesian_tpu/ops/gaussian.py:118 computes (jitted XLA there, no Pallas
// kernel), and, with one fold and no test rows, what `family_grams` (:44)
// and `batched_bic` compute; one block per program g = f * K + k (family
// f, fold k), W = P + 2 design columns [1, parents, y]:
//
//   d_r   = [1, x_r1 m_1, ..., x_rP m_P, y_r]      (m: the parent mask)
//   w_r   = tr_mask[k, r] * valid(y_r) * prod_{m_p > 0} valid(x_rp)
//   gram  = sum_r w_r d_r d_r^T  over the train rows, n_eff = gram[0, 0]
//   A     = gram[:P+1, :P+1] m m^T + diag(1 - m),  b = gram[:P+1, P+1] m
//   beta  = A^-1 b by Cholesky (NaN when A is not positive definite)
//   rss   = max(gram[P+1, P+1] - beta . b, 0),  k = sum_p m_p
//   var   = rss / max(n_eff - k - 1, 1),  +inf when n_eff - k - 1 <= 0
//   bic   = the Gaussian BIC of (var, k, n_eff)   (reference bic.cpp:12-27)
//   fold  = sum_r te_mask[k, r] v_r log N(y_r | d_r[:P+1] . beta, var)
//
// over the test rows (v_r: the family's validity of row r), -inf where var
// is < 4 eps or not finite; then out[f] = sum_k fold[f * K + k] in fold
// order, rounded once to float32. Every statistic is float64 of float32
// inputs.
//
// Bound: the work is small and latency-bound. Per program and train row
// W (W + 1) float64 operations for the Gram, per test row 2 (P + 1) + 8;
// the bytes are the family's columns of every row, read from L2 by every
// fold's program. PERF.md has the measured time against the bound of the
// FP64 operations and of each input byte read once.
//
// Design:
//
// - One block of 256 threads per program, so that a program's reduction
//   order is fixed: thread t takes rows t, t + 256, ... in order, sums in
//   float64 registers, and the block's partial sums merge in a fixed tree
//   (a warp's shuffles, then the 8 warps in order through shared memory).
//   No atomics; nothing depends on G, on the program's place in the grid
//   or on the launch. The fold sum is a second kernel, one thread per
//   family adding its K folds in order.
// - Every Gram entry is a sum of its own (grouped 36 at a time, one pass
//   over the rows each, to bound the registers), every term formed by the
//   same explicit float64 operations (w d_i, then one fma with d_j): a
//   family padded to the batch's widest family adds only exact zeros to
//   its own entries, so it gets the bits it gets alone. Parents are packed
//   first, so the padded columns come last in the Cholesky, the solve, the
//   residual sum and the test rows' means, where they add exact zeros.
// - The fold masks are dense (K, n): a program reads its fold's mask row
//   and sums over every row, multiplying by the mask, as the plain
//   version does (a NaN in a row outside the fold still reaches the sums).
// - The solve runs by one thread in shared memory, in one non-inlined
//   function of the runtime width, so every width and both kernels run the
//   same instructions there. A pivot that is not positive, or a factor
//   entry that is not finite, makes beta NaN, as the plain version's
//   cholesky_or_nan does (variance NaN, or +inf when underdetermined).
// - Families of W <= 18 (P <= 16) take a kernel templated on W, which keeps
//   a row's design in registers; wider ones (up to W 64) a runtime-width
//   kernel that reads each design value where it needs it. Both form
//   every sum the same way, so a family alone and padded into a wider
//   batch gives the same bits whichever kernel runs. The templated widths
//   earn their code: the runtime-width kernel alone takes 3.6-4.2 times as
//   long at `hc`'s one-parent batch (F 56, K 10, 8,000 rows) and 2-2.5
//   times at the CV workload's families (tools/lg_kernel_ab.py on an H100;
//   PERF.md has the numbers).
// - An out-of-range column index reads NaN; nothing is read out of bounds.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;       // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 36;        // values of one block sum
constexpr int kMaxTemplated = 18;   // widest W of the templated kernels
constexpr int kMaxW = 64;           // widest W: 62 parents
constexpr int kFoldThreads = 256;   // threads of the fold-sum kernel
constexpr double kLog2Pi = 1.8378770664093454835606594728112;  // log(2 pi)
constexpr double kMachineTol = 2.220446049250313e-16 * 4;

__device__ __forceinline__ double qnan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

struct LgArgs {
  const float* tr_values;        // (n_tr, D) values, nulls zeroed
  const float* tr_valid;         // (n_tr, D) 1.0 where not null
  const float* tr_mask;          // (K, n_tr), or null: every row (K == 1)
  const float* te_values;        // (n_te, D), or null: no test stage
  const float* te_valid;         // (n_te, D)
  const float* te_mask;          // (K, n_te), or null: every row
  const long long* var_idx;      // (F,)
  const long long* parent_idx;   // (F, P)
  const float* parent_mask;      // (F, P)
  int n_tr, n_te, D, K, P;
  double* gram;                  // (G, W, W)
  double* bic;                   // (G,)
  double* fold_ll;               // (G,), with a test stage
};

// The family's design columns, shared by the block: column c's data column
// (c >= 1; -1 when out of range) and its mask (1 for the intercept and y).
struct Family {
  long long col[kMaxW];
  double cm[kMaxW];
  double k;  // parents
};

// Program g's results of the solve, shared by the block.
struct Fit {
  double beta[kMaxW];
  double variance;
  double half_log_var;  // log(variance) / 2
  bool bad;             // variance < 4 eps or not finite
};

// Sums v[0..N) over the block's threads in a fixed tree (each warp's
// shuffles, then the warps in order) into s_sum[0..N), which every thread
// may read on return; each value by its own operations. Called by all
// threads of the block.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N],
                                          double (*s_red)[kMaxSums],
                                          double* s_sum) {
  static_assert(N <= kMaxSums, "one block sum holds kMaxSums");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      v[i] = __dadd_rn(v[i], __shfl_down_sync(0xffffffffu, v[i], off));
    }
  }
  __syncthreads();  // s_red and s_sum are free
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) s_red[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = s_red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __dadd_rn(s, s_red[w][threadIdx.x]);
    s_sum[threadIdx.x] = s;
  }
  __syncthreads();
}

// (i, j), j <= i, of entry p of a lower triangle in row-major order.
__device__ __forceinline__ void tri(int p, int& i, int& j) {
  i = static_cast<int>((sqrt(8.0 * p + 1.0) - 1.0) / 2.0);
  while (i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  j = p - i * (i + 1) / 2;
}

// Cell (row, col) of an (n, D) matrix; NaN for a column out of range.
__device__ __forceinline__ double cell(const float* m, int D, int row,
                                       long long col) {
  return col >= 0 && col < D
             ? static_cast<double>(m[static_cast<size_t>(row) * D + col])
             : qnan();
}

// Design value c (0 <= c < W) of data row `row`.
__device__ __forceinline__ double design(const float* values, int D,
                                         const Family& fam, int row, int c) {
  return c == 0 ? 1.0 : __dmul_rn(cell(values, D, row, fam.col[c]),
                                  fam.cm[c]);
}

// The row's weight: the fold mask times the validity of y and of every
// unmasked parent (columns 1 .. Q - 1; y is column Q).
__device__ __forceinline__ double row_weight(const float* valid, int D,
                                             const Family& fam, int Q,
                                             int row, double mask) {
  double w = cell(valid, D, row, fam.col[Q]);
  for (int c = 1; c < Q; ++c) {
    if (fam.cm[c] > 0.0) w = __dmul_rn(w, cell(valid, D, row, fam.col[c]));
  }
  return __dmul_rn(mask, w);
}

// One test row's weighted log-likelihood term, from its mean.
__device__ __forceinline__ double ll_term(double y, double mean, double w,
                                          const Fit& fit, double acc) {
  const double r = __dsub_rn(y, mean);
  const double ll = __dsub_rn(
      __dsub_rn(__ddiv_rn(__dmul_rn(-0.5, __dmul_rn(r, r)), fit.variance),
                fit.half_log_var),
      0.5 * kLog2Pi);
  return __fma_rn(w, ll, acc);
}

// lg_params_from_gram and the BIC by one thread: g is the (W, W) Gram in
// shared memory (its top-left (W - 1) block is overwritten by the Cholesky
// factor; column W - 1 is kept), cm the design columns' masks. Fills fit
// and returns the BIC. One function of the runtime width for every kernel.
__device__ __noinline__ double solve(double* g, int W, const double* cm,
                                     double k, Fit& fit) {
  const int Q = W - 1;
  const double n_eff = g[0];
  const double yy = g[Q * W + Q];
  // A = gram m m^T + diag(1 - m), lower triangle, in place
  for (int i = 0; i < Q; ++i) {
    for (int j = 0; j <= i; ++j) {
      g[i * W + j] = __dadd_rn(__dmul_rn(__dmul_rn(g[i * W + j], cm[i]),
                                         cm[j]),
                               i == j ? 1.0 - cm[i] : 0.0);
    }
  }
  bool good = true;
  for (int j = 0; j < Q; ++j) {
    double s = g[j * W + j];
    for (int q = 0; q < j; ++q) s = __fma_rn(-g[j * W + q], g[j * W + q], s);
    good = good && s > 0.0;
    const double ljj = __dsqrt_rn(s);
    g[j * W + j] = ljj;
    for (int i = j + 1; i < Q; ++i) {
      double t = g[i * W + j];
      for (int q = 0; q < j; ++q) t = __fma_rn(-g[i * W + q], g[j * W + q], t);
      g[i * W + j] = __ddiv_rn(t, ljj);
    }
  }
  for (int i = 0; i < Q; ++i) {
    for (int j = 0; j <= i; ++j) good = good && isfinite(g[i * W + j]);
  }
  // L z = b, then L^T beta = z; b_i = gram[i, Q] m_i (column Q is kept)
  for (int i = 0; i < Q; ++i) {
    double t = __dmul_rn(g[i * W + Q], cm[i]);
    for (int q = 0; q < i; ++q) t = __fma_rn(-g[i * W + q], fit.beta[q], t);
    fit.beta[i] = good ? __ddiv_rn(t, g[i * W + i]) : qnan();
  }
  for (int i = Q - 1; i >= 0; --i) {
    double t = fit.beta[i];
    for (int q = i + 1; q < Q; ++q) {
      t = __fma_rn(-g[q * W + i], fit.beta[q], t);
    }
    fit.beta[i] = good ? __ddiv_rn(t, g[i * W + i]) : qnan();
  }
  double bb = 0.0;
  for (int i = 0; i < Q; ++i) {
    bb = __fma_rn(fit.beta[i], __dmul_rn(g[i * W + Q], cm[i]), bb);
  }
  double rss = __dsub_rn(yy, bb);
  rss = rss < 0.0 ? 0.0 : rss;  // keeps a NaN, as torch.maximum does
  const double dof = __dsub_rn(__dsub_rn(n_eff, k), 1.0);
  const double var =
      dof > 0.0 ? __ddiv_rn(rss, fmax(dof, 1.0)) : __longlong_as_double(
                                                        0x7ff0000000000000LL);
  fit.variance = var;
  const double log_var = log(var);
  fit.half_log_var = __dmul_rn(0.5, log_var);
  fit.bad = var < kMachineTol || !isfinite(var);
  // 0.5 (1 + k - n) - 0.5 n log(2 pi) - 0.5 n log(var) - 0.5 log(n) (k + 2)
  const double half_n = __dmul_rn(0.5, n_eff);
  const double loglik = __dsub_rn(
      __dsub_rn(__dmul_rn(0.5, __dsub_rn(__dadd_rn(1.0, k), n_eff)),
                __dmul_rn(half_n, kLog2Pi)),
      __dmul_rn(half_n, log_var));
  const double bic = __dsub_rn(
      loglik, __dmul_rn(__dmul_rn(0.5, log(n_eff)), __dadd_rn(k, 2.0)));
  const bool bad = fit.bad || !isfinite(bic);
  return bad ? -__longlong_as_double(0x7ff0000000000000LL) : bic;
}

// A row's W design values in registers and its weight.
template <int W>
__device__ __forceinline__ double load_row(const float* values,
                                           const float* valid, int D,
                                           const Family& fam, int row,
                                           double mask, double (&d)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) d[c] = design(values, D, fam, row, c);
  return row_weight(valid, D, fam, W - 1, row, mask);
}

// Stage 1 of a templated width: every Gram entry over the fold's train
// rows into s_gram (W, W), both triangles.
template <int W>
__device__ __forceinline__ void gram_fixed(const LgArgs& a,
                                           const Family& fam,
                                           const float* mask, double* s_gram,
                                           double (*s_red)[kMaxSums],
                                           double* s_sum) {
  constexpr int E = W * (W + 1) / 2;
  constexpr int C = E < kMaxSums ? E : kMaxSums;
#pragma unroll
  for (int p0 = 0; p0 < E; p0 += C) {
    double acc[C];
#pragma unroll
    for (int e = 0; e < C; ++e) acc[e] = 0.0;
    for (int r = threadIdx.x; r < a.n_tr; r += kThreads) {
      double d[W];
      const double w = load_row<W>(a.tr_values, a.tr_valid, a.D, fam, r,
                                   mask ? mask[r] : 1.0, d);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const double wd = __dmul_rn(w, d[i]);
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          const int p = i * (i + 1) / 2 + j;
          if (p >= p0 && p < p0 + C) {
            acc[p - p0] = __fma_rn(wd, d[j], acc[p - p0]);
          }
        }
      }
    }
    block_sum(acc, s_red, s_sum);
    if (threadIdx.x < C && p0 + static_cast<int>(threadIdx.x) < E) {
      int i, j;
      tri(p0 + threadIdx.x, i, j);
      s_gram[i * W + j] = s_sum[threadIdx.x];
      s_gram[j * W + i] = s_sum[threadIdx.x];
    }
  }
  __syncthreads();
}

// Stage 1 of a runtime width W: the same sums, each design value read
// where a term needs it; s_ij holds the pass's entries.
__device__ __forceinline__ void gram_runtime(const LgArgs& a,
                                             const Family& fam, int W,
                                             const float* mask,
                                             double* s_gram,
                                             double (*s_red)[kMaxSums],
                                             double* s_sum,
                                             int (*s_ij)[2]) {
  const int E = W * (W + 1) / 2;
  for (int p0 = 0; p0 < E; p0 += kMaxSums) {
    const int C = min(kMaxSums, E - p0);
    __syncthreads();  // the last pass's s_ij is read
    if (threadIdx.x < kMaxSums) {
      int i = 0, j = 0;
      if (static_cast<int>(threadIdx.x) < C) tri(p0 + threadIdx.x, i, j);
      s_ij[threadIdx.x][0] = i;
      s_ij[threadIdx.x][1] = j;
    }
    __syncthreads();
    double acc[kMaxSums];
#pragma unroll
    for (int e = 0; e < kMaxSums; ++e) acc[e] = 0.0;
    for (int r = threadIdx.x; r < a.n_tr; r += kThreads) {
      const double w =
          row_weight(a.tr_valid, a.D, fam, W - 1, r, mask ? mask[r] : 1.0);
#pragma unroll
      for (int e = 0; e < kMaxSums; ++e) {
        if (e < C) {
          const double wd =
              __dmul_rn(w, design(a.tr_values, a.D, fam, r, s_ij[e][0]));
          acc[e] = __fma_rn(wd, design(a.tr_values, a.D, fam, r, s_ij[e][1]),
                            acc[e]);
        }
      }
    }
    block_sum(acc, s_red, s_sum);
    if (static_cast<int>(threadIdx.x) < C) {
      const int i = s_ij[threadIdx.x][0], j = s_ij[threadIdx.x][1];
      s_gram[i * W + j] = s_sum[threadIdx.x];
      s_gram[j * W + i] = s_sum[threadIdx.x];
    }
  }
  __syncthreads();
}

// One block per program g = f * K + k. WT > 0: the templated width W = WT;
// WT == 0: the runtime width W = P + 2.
template <int WT>
__global__ void __launch_bounds__(kThreads) lg_kernel(const LgArgs a) {
  constexpr int SW = WT > 0 ? WT : kMaxW;
  __shared__ double s_red[kWarps][kMaxSums];
  __shared__ double s_sum[kMaxSums];
  __shared__ double s_gram[SW * SW];
  __shared__ int s_ij[kMaxSums][2];
  __shared__ Family fam;
  __shared__ Fit fit;

  const int W = WT > 0 ? WT : a.P + 2;
  const int Q = W - 1;
  const int g = blockIdx.x;
  const int f = g / a.K, k = g % a.K;
  if (threadIdx.x < W) {
    const int c = threadIdx.x;
    long long col = -1;
    double cm = 1.0;
    if (c >= 1 && c < Q) {
      col = a.parent_idx[static_cast<size_t>(f) * a.P + c - 1];
      cm = a.parent_mask[static_cast<size_t>(f) * a.P + c - 1];
    } else if (c == Q) {
      col = a.var_idx[f];
    }
    fam.col[c] = col >= 0 && col < a.D ? col : -1;
    fam.cm[c] = cm;
  }
  if (threadIdx.x == 0) {
    double k_par = 0.0;
    for (int p = 0; p < a.P; ++p) {
      k_par += a.parent_mask[static_cast<size_t>(f) * a.P + p];
    }
    fam.k = k_par;
  }
  __syncthreads();

  // stage 1: the Gram over the fold's train rows
  const float* tr_mask =
      a.tr_mask ? a.tr_mask + static_cast<size_t>(k) * a.n_tr : nullptr;
  if constexpr (WT > 0) {
    gram_fixed<WT>(a, fam, tr_mask, s_gram, s_red, s_sum);
  } else {
    gram_runtime(a, fam, W, tr_mask, s_gram, s_red, s_sum, s_ij);
  }
  double* gram_out = a.gram + static_cast<size_t>(g) * W * W;
  for (int e = threadIdx.x; e < W * W; e += kThreads) gram_out[e] = s_gram[e];
  __syncthreads();  // s_gram is written out before the solve overwrites it

  // stage 2: the solve by one thread
  if (threadIdx.x == 0) a.bic[g] = solve(s_gram, W, fam.cm, fam.k, fit);
  __syncthreads();
  if (a.te_values == nullptr) return;

  // stage 3: the fold's weighted test log-likelihood
  const float* te_mask =
      a.te_mask ? a.te_mask + static_cast<size_t>(k) * a.n_te : nullptr;
  double acc[1] = {0.0};
  for (int r = threadIdx.x; r < a.n_te; r += kThreads) {
    const double m = te_mask ? te_mask[r] : 1.0;
    double mean = 0.0, y;
    double w;
    if constexpr (WT > 0) {
      double d[WT];
      w = load_row<WT>(a.te_values, a.te_valid, a.D, fam, r, m, d);
#pragma unroll
      for (int c = 0; c < WT - 1; ++c) mean = __fma_rn(d[c], fit.beta[c], mean);
      y = d[WT - 1];
    } else {
      w = row_weight(a.te_valid, a.D, fam, Q, r, m);
      for (int c = 0; c < Q; ++c) {
        mean = __fma_rn(design(a.te_values, a.D, fam, r, c), fit.beta[c],
                        mean);
      }
      y = design(a.te_values, a.D, fam, r, Q);
    }
    acc[0] = ll_term(y, mean, w, fit, acc[0]);
  }
  block_sum(acc, s_red, s_sum);
  if (threadIdx.x == 0) {
    a.fold_ll[g] = fit.bad ? -__longlong_as_double(0x7ff0000000000000LL)
                           : s_sum[0];
  }
}

// out[f] = sum_k fold_ll[f * K + k] in fold order, rounded once.
__global__ void __launch_bounds__(kFoldThreads)
    fold_sum_kernel(const double* fold_ll, float* out, int F, int K) {
  const int f = blockIdx.x * kFoldThreads + threadIdx.x;
  if (f >= F) return;
  double total = 0.0;
  for (int k = 0; k < K; ++k) {
    total = __dadd_rn(total, fold_ll[static_cast<size_t>(f) * K + k]);
  }
  out[f] = static_cast<float>(total);
}

template <int WT>
cudaError_t launch_lg(const LgArgs& a, int G, cudaStream_t s) {
  lg_kernel<WT><<<G, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_width(const LgArgs& a, int G, int W, cudaStream_t s) {
  switch (W) {
#define LG_CASE(WT) \
  case WT:          \
    return launch_lg<WT>(a, G, s);
    LG_CASE(2)
    LG_CASE(3)
    LG_CASE(4)
    LG_CASE(5)
    LG_CASE(6)
    LG_CASE(7)
    LG_CASE(8)
    LG_CASE(9)
    LG_CASE(10)
    LG_CASE(11)
    LG_CASE(12)
    LG_CASE(13)
    LG_CASE(14)
    LG_CASE(15)
    LG_CASE(16)
    LG_CASE(17)
    LG_CASE(18)
#undef LG_CASE
    default:
      return launch_lg<0>(a, G, s);
  }
}

}  // namespace

// The widest family the kernels take: P + 2 <= lg_cv_max_width().
extern "C" int lg_cv_max_width() { return kMaxW; }

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// the CUDA error code of the launches: 0 on success. Allocates nothing.
// All arrays are contiguous on the current device: tr_values, tr_valid
// (n_tr, D) float32; tr_mask (K, n_tr) float32, or null with K == 1 (every
// row); te_values, te_valid (n_te, D) float32, or both null (no test
// stage: fold_ll and out are not written and may be null); te_mask (K,
// n_te), or null (every row); var_idx (F,) and parent_idx (F, P) int64,
// parent_mask (F, P) float32; gram (F * K, P + 2, P + 2), bic and fold_ll
// (F * K,) float64; out (F,) float32.
// F, K >= 1 with F * K < 2^31, 0 <= P <= lg_cv_max_width() - 2, n_tr,
// n_te, D >= 0; anything else returns cudaErrorInvalidValue.
extern "C" int lg_cv_f32(const float* tr_values, const float* tr_valid,
                         const float* tr_mask, const float* te_values,
                         const float* te_valid, const float* te_mask,
                         const long long* var_idx,
                         const long long* parent_idx,
                         const float* parent_mask, double* gram, double* bic,
                         double* fold_ll, float* out, int n_tr, int n_te,
                         int D, int F, int K, int P, void* stream) {
  const long long G = static_cast<long long>(F) * K;
  const bool test = te_values != nullptr;
  if (F < 1 || K < 1 || G >= (1LL << 31) || P < 0 || P + 2 > kMaxW ||
      n_tr < 0 || n_te < 0 || D < 0 || (tr_mask == nullptr && K != 1) ||
      (test && (te_valid == nullptr || fold_ll == nullptr || out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LgArgs a{tr_values, tr_valid, tr_mask, te_values, te_valid,
                 te_mask,   var_idx,  parent_idx, parent_mask, n_tr,
                 n_te,      D,        K,        P,          gram,
                 bic,       fold_ll};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = P + 2;
  const cudaError_t err =
      launch_width(a, static_cast<int>(G), W <= kMaxTemplated ? W : 0, s);
  if (err != cudaSuccess || !test) return static_cast<int>(err);
  fold_sum_kernel<<<(F + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0,
                    s>>>(fold_ll, out, F, K);
  return static_cast<int>(cudaGetLastError());
}
