// Stages 1 and 3 of the cross-validated conditional KDE (CV-CKDE) score for
// NVIDIA Hopper (sm_90a): the per-(family, fold) whitening before the pairs
// kernel of ckde_cv.cu, and the per-fold sums after it.
//
// 1. ckde_cv_whiten_f32 computes what `ckde_cv_whitened_parts` of
// pybnesian_tpu/ops/kde.py:303 computes (a jitted XLA function there, no
// Pallas kernel), one block per program g = f * K + k (family f, fold k):
//
//   x_r     = data[row_r, col[c]] * cmask[c]      (evidence first, variable
//   w_r     = tr_mask[k, r] * fvalid[row_r]        last; fvalid: no column
//   n_eff   = sum_r w_r                            of the family is null)
//   mean    = sum_r x_r w_r / n_eff
//   S       = sum_r xc_r xc_r^T,  xc_r = (x_r - mean) * w_r * cmask
//   H       = k(n_eff, d) * S / (n_eff - 1) + diag(1 - cmask)
//             (or the caller's bandwidth * cmask cmask^T + diag(1 - cmask))
//   L       = chol(H);  z = L^-1 x for every train and test row
//
// and writes kernel #1's arguments directly in its layout: jtr (G, ntr,
// dpad), neg (G, ntr) 0 / -inf, zv_tr (G, ntr) the variable's coordinate,
// jte, zv_te, no_ev and lm_const = log max(#valid train rows, 1); then the
// fold reduce's: wte (G, nte), lndiff (G,) = -log L_vv - log(2 pi) / 2 in
// float64, ok (G,) = n_eff > d. Every statistic is float64; each float32
// output is one rounding of a float64 value.
//
// 2. ckde_cv_fold_reduce_f32 computes `_flash_reduce` (pybnesian_tpu/ops/
// kde.py:404, XLA there too), one block per family:
//
//   out[f] = sum_k (ok[g] ? sum_i rows[g, i] wte[g, i] + lndiff[g] *
//                           sum_i wte[g, i] : NaN),  g = f * K + k
//
// with rows[g, i] taken as 0 where wte[g, i] is 0, in float64, rounded once.
//
// Bound: bytes. The whitening writes (ntr + nte) * (dpad + 2) floats per
// program and reads each data cell it needs from L2 (the data of a CV call
// is a few hundred KB); its float64 work is ~3 d^2 operations a row. The
// reduce reads two floats per test row. PERF.md has the measured times
// against that bound.
//
// Design:
//
// - One block of 256 threads per program, so that a program's reduction
//   order is fixed: thread t takes rows t, t + 256, ... in order, sums in
//   registers, and the block's 256 partial sums merge in a fixed tree (a
//   warp's shuffles, then the 8 warps in order through shared memory). No
//   atomics, and nothing that depends on G, on the program's place in the
//   grid or on the launch: a family's outputs are the same bits alone and
//   in any batch, as those of kernels #1 and #2 are (ckde_cv.cu).
// - The order of a column's sums does not depend on dpad either: the mean
//   of column c and each covariance entry (i, j) are sums of their own, and
//   the covariance entries are only grouped (36 at a time, one pass
//   over the rows each) to bound the registers. A family padded to the
//   batch's widest family gets the bits it gets alone.
// - Two passes over the train rows, as the plain version: the weighted
//   mean, then the centred covariance; rows are gathered from the data
//   each pass (a row is dpad cells from L2), never staged.
// - Cholesky and the triangular inverse in float64 by one thread, in
//   shared memory (dpad <= 16). A pivot that is not positive, or a factor
//   entry that is not finite, makes the factor NaN, as the plain version's
//   cholesky_or_nan does: every whitened value and lndiff become NaN.
// - The whitened rows are the full dpad x dpad product with L^-1 (zeros
//   above the diagonal included), as the plain matmul forms them, so that
//   a NaN cell of a row reaches every column of it there too.
// - An out-of-range row or column index reads NaN; nothing is read out of
//   bounds.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 16;                   // widest family (kernel #1's)
constexpr int kMaxSums = 36;  // values of one block sum: covariance
                              // entries per pass, or dpad + 2 means
constexpr double kLog2Pi = 1.8378770664093454835606594728112;  // log(2 pi)

__device__ __forceinline__ double qnan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

struct WhitenArgs {
  const float* data;         // (n, D) values, nulls zeroed
  const float* null_mask;    // (n, D) 1.0 where null
  const long long* col_idx;  // (F, dpad) family columns
  const float* col_mask;     // (F, dpad)
  const long long* tr_idx;   // (K, ntr)
  const float* tr_mask;      // (K, ntr)
  const long long* te_idx;   // (K, nte)
  const float* te_mask;      // (K, nte)
  const float* bandwidths;   // (F, K, dpad, dpad), or null: the rule's
  int n, D, K, ntr, nte;
  int rule;                  // 0 normal reference, 1 Scott, 2 bandwidths
  float* jtr;                // (G, ntr, dpad)
  float* neg;                // (G, ntr)
  float* zv_tr;              // (G, ntr)
  float* jte;                // (G, nte, dpad)
  float* zv_te;              // (G, nte)
  float* no_ev;              // (G,)
  float* lm_const;           // (G,)
  float* wte;                // (G, nte)
  double* lndiff;            // (G,)
  float* ok;                 // (G,)
};

// The family's columns, shared by the block: index (-1 when out of range),
// mask, the variable's one-hot and the fold's weighted means.
template <int D>
struct Family {
  long long col[D];
  double cm[D];
  double vsel[D];
  double mean[D];
};

// Sums v[0..N) over the block's threads in a fixed tree (each warp's
// shuffles, then the warps in order) into s_sum[0..N), which every thread
// may read on return. Called by all threads of the block.
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

// Data row `row`: the family's dpad values (times the column mask, as the
// plain version multiplies them) in x, and fvalid, 1 when no column of the
// family is null there. An out-of-range row or column reads NaN.
template <int D>
__device__ __forceinline__ double load_row(const WhitenArgs& a,
                                           const Family<D>& fam,
                                           long long row, double (&x)[D]) {
  const bool row_ok = row >= 0 && row < a.n;
  const size_t base = static_cast<size_t>(row_ok ? row : 0) * a.D;
  double null_max = 0.0;
  bool bad = !row_ok;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const long long ci = fam.col[c];
    bad = bad || ci < 0;
    if (row_ok && ci >= 0) {
      x[c] = __dmul_rn(a.data[base + ci], fam.cm[c]);
      null_max = fmax(null_max, __dmul_rn(a.null_mask[base + ci], fam.cm[c]));
    } else {
      x[c] = qnan();
    }
  }
  return bad ? qnan() : 1.0 - null_max;
}

// x L^-T: the full dpad x dpad product, zeros above the diagonal included.
template <int D>
__device__ __forceinline__ double whiten_row(const double (&x)[D],
                                             const double (*Linv)[D],
                                             const Family<D>& fam,
                                             float* out) {
  double zv = 0.0;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    double z = 0.0;
#pragma unroll
    for (int q = 0; q < D; ++q) z = fma(x[q], Linv[c][q], z);
    out[c] = static_cast<float>(z);
    zv = fma(z, fam.vsel[c], zv);
  }
  return zv;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    whiten_kernel(const WhitenArgs a) {
  constexpr int P = D * (D + 1) / 2;  // lower-triangle covariance entries
  constexpr int C = P < kMaxSums ? P : kMaxSums;  // entries per pass
  __shared__ double s_red[kWarps][kMaxSums];
  __shared__ double s_sum[kMaxSums];
  __shared__ double s_L[D][D];     // H, then its Cholesky factor in place
  __shared__ double s_Linv[D][D];
  __shared__ double s_lndiff;
  __shared__ Family<D> fam;

  const int g = blockIdx.x;
  const int f = g / a.K, k = g % a.K;
  double d_eff = 0.0;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    d_eff += static_cast<double>(a.col_mask[static_cast<size_t>(f) * D + c]);
  }
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    const long long ci = a.col_idx[static_cast<size_t>(f) * D + c];
    const double cm = a.col_mask[static_cast<size_t>(f) * D + c];
    fam.col[c] = ci >= 0 && ci < a.D ? ci : -1;
    fam.cm[c] = cm;
    // one-hot of the variable's position (the last valid column)
    fam.vsel[c] = (static_cast<double>(c) == d_eff - 1.0 ? 1.0 : 0.0) * cm;
  }
  __syncthreads();
  const long long* tr_idx = a.tr_idx + static_cast<size_t>(k) * a.ntr;
  const float* tr_mask = a.tr_mask + static_cast<size_t>(k) * a.ntr;

  // pass 1: weighted column sums, n_eff and the count of valid rows
  double m[D + 2];
#pragma unroll
  for (int i = 0; i < D + 2; ++i) m[i] = 0.0;
  for (int r = threadIdx.x; r < a.ntr; r += kThreads) {
    double x[D];
    const double w = __dmul_rn(tr_mask[r], load_row(a, fam, tr_idx[r], x));
#pragma unroll
    for (int c = 0; c < D; ++c) m[c] = fma(x[c], w, m[c]);
    m[D] = __dadd_rn(m[D], w);
    m[D + 1] += w > 0.0 ? 1.0 : 0.0;
  }
  block_sum(m, s_red, s_sum);
  const double n_eff = s_sum[D];
  const double n_valid = s_sum[D + 1];
  if (threadIdx.x < D) {
    fam.mean[threadIdx.x] = __ddiv_rn(s_sum[threadIdx.x], n_eff);
  }
  __syncthreads();

  if (a.rule == 2) {
    const float* bw = a.bandwidths + static_cast<size_t>(g) * D * D;
    if (threadIdx.x == 0) {
      for (int i = 0; i < D; ++i) {
        for (int j = 0; j < D; ++j) {
          s_L[i][j] = __dadd_rn(
              __dmul_rn(bw[i * D + j], __dmul_rn(fam.cm[i], fam.cm[j])),
              i == j ? 1.0 - fam.cm[i] : 0.0);
        }
      }
    }
  } else {
    // pass 2: the centred covariance, C entries (i, j), j <= i, per pass
    // over the rows
    const double factor =
        a.rule == 0
            ? pow(4.0 / (n_eff * (d_eff + 2.0)), 2.0 / (d_eff + 4.0))
            : pow(n_eff, -2.0 / (d_eff + 4.0));
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += C) {
      double acc[C];
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = 0.0;
      for (int r = threadIdx.x; r < a.ntr; r += kThreads) {
        double x[D];
        const double w =
            __dmul_rn(tr_mask[r], load_row(a, fam, tr_idx[r], x));
#pragma unroll
        for (int c = 0; c < D; ++c) {
          x[c] = __dmul_rn(__dsub_rn(x[c], fam.mean[c]),
                           __dmul_rn(w, fam.cm[c]));
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            const int p = i * (i + 1) / 2 + j;
            if (p >= p0 && p < p0 + C) {
              acc[p - p0] = fma(x[i], x[j], acc[p - p0]);
            }
          }
        }
      }
      block_sum(acc, s_red, s_sum);
      if (threadIdx.x == 0) {
        for (int i = 0; i < D; ++i) {
          for (int j = 0; j <= i; ++j) {
            const int p = i * (i + 1) / 2 + j;
            if (p >= p0 && p < p0 + C) {
              const double h = __dadd_rn(
                  __dmul_rn(factor, __ddiv_rn(s_sum[p - p0], n_eff - 1.0)),
                  i == j ? 1.0 - fam.cm[i] : 0.0);
              s_L[i][j] = h;
              s_L[j][i] = h;
            }
          }
        }
      }
    }
  }

  // Cholesky of H's lower triangle in place, then L^-1, by one thread
  if (threadIdx.x == 0) {
    bool good = true;
    for (int j = 0; j < D; ++j) {
      double s = s_L[j][j];
      for (int q = 0; q < j; ++q) s = fma(-s_L[j][q], s_L[j][q], s);
      good = good && s > 0.0;
      const double ljj = sqrt(s);
      s_L[j][j] = ljj;
      for (int i = j + 1; i < D; ++i) {
        double t = s_L[i][j];
        for (int q = 0; q < j; ++q) t = fma(-s_L[i][q], s_L[j][q], t);
        s_L[i][j] = __ddiv_rn(t, ljj);
      }
    }
    double logdet_v = 0.0;
    for (int i = 0; i < D; ++i) {
      for (int j = 0; j <= i; ++j) good = good && isfinite(s_L[i][j]);
      logdet_v = fma(log(fabs(s_L[i][i])), fam.vsel[i], logdet_v);
    }
    for (int j = 0; j < D; ++j) {
      for (int i = 0; i < D; ++i) {
        double v = 0.0;
        if (i == j) {
          v = __drcp_rn(s_L[j][j]);
        } else if (i > j) {
          double s = 0.0;
          for (int q = j; q < i; ++q) s = fma(s_L[i][q], s_Linv[q][j], s);
          v = __ddiv_rn(-s, s_L[i][i]);
        }
        s_Linv[i][j] = v;
      }
    }
    if (!good) {
      for (int i = 0; i < D; ++i) {
        for (int j = 0; j < D; ++j) s_Linv[i][j] = qnan();
      }
    }
    s_lndiff = good ? -logdet_v - 0.5 * kLog2Pi : qnan();
  }
  __syncthreads();

  // the whitened train rows, their variable coordinate and the row mask
  const size_t tr_base = static_cast<size_t>(g) * a.ntr;
  for (int r = threadIdx.x; r < a.ntr; r += kThreads) {
    double x[D];
    const double w = __dmul_rn(tr_mask[r], load_row(a, fam, tr_idx[r], x));
    a.zv_tr[tr_base + r] = static_cast<float>(
        whiten_row(x, s_Linv, fam, a.jtr + (tr_base + r) * D));
    a.neg[tr_base + r] = w > 0.0 ? 0.0f : -INFINITY;
  }
  // the whitened test rows, their variable coordinate and their weights
  const long long* te_idx = a.te_idx + static_cast<size_t>(k) * a.nte;
  const float* te_mask = a.te_mask + static_cast<size_t>(k) * a.nte;
  const size_t te_base = static_cast<size_t>(g) * a.nte;
  for (int r = threadIdx.x; r < a.nte; r += kThreads) {
    double x[D];
    const double fv = load_row(a, fam, te_idx[r], x);
    a.zv_te[te_base + r] = static_cast<float>(
        whiten_row(x, s_Linv, fam, a.jte + (te_base + r) * D));
    a.wte[te_base + r] = static_cast<float>(__dmul_rn(te_mask[r], fv));
  }
  if (threadIdx.x == 0) {
    a.no_ev[g] = d_eff <= 1.0 ? 1.0f : 0.0f;
    a.lm_const[g] = static_cast<float>(log(fmax(n_valid, 1.0)));
    a.lndiff[g] = s_lndiff;
    a.ok[g] = n_eff > d_eff ? 1.0f : 0.0f;
  }
}

// One block per family: each fold's weighted row sum and weight sum in the
// block's fixed tree, then the folds in order by one thread.
__global__ void __launch_bounds__(kThreads)
    fold_reduce_kernel(const float* rows, const float* wte,
                       const double* lndiff, const float* ok, float* out,
                       int K, int nte) {
  __shared__ double s_red[kWarps][kMaxSums];
  __shared__ double s_sum[2];
  const int f = blockIdx.x;
  double total = 0.0;
  for (int k = 0; k < K; ++k) {
    const size_t g = static_cast<size_t>(f) * K + k;
    const float* rg = rows + g * nte;
    const float* wg = wte + g * nte;
    double s[2] = {0.0, 0.0};
    for (int i = threadIdx.x; i < nte; i += kThreads) {
      const double w = wg[i];
      const double v = w > 0.0 ? static_cast<double>(rg[i]) : 0.0;
      s[0] = fma(v, w, s[0]);
      s[1] = __dadd_rn(s[1], w);
    }
    block_sum(s, s_red, s_sum);
    const double fold = fma(lndiff[g], s_sum[1], s_sum[0]);
    total = __dadd_rn(total, ok[g] > 0.0f ? fold : qnan());
  }
  if (threadIdx.x == 0) out[f] = static_cast<float>(total);
}

template <int D>
cudaError_t launch_whiten(const WhitenArgs& a, int G, cudaStream_t s) {
  whiten_kernel<D><<<G, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// the CUDA error code of the launch: 0 on success. Allocates nothing. All
// arrays are contiguous on the current device, shapes as in WhitenArgs
// above; `bandwidths` is read only when rule is 2 and may be null
// otherwise. G = F * K with 1 <= G < 2^31, 1 <= dpad <= 16, K >= 1, n, D,
// ntr, nte >= 0; anything else returns cudaErrorInvalidValue.
extern "C" int ckde_cv_whiten_f32(
    const float* data, const float* null_mask, const long long* col_idx,
    const float* col_mask, const long long* tr_idx, const float* tr_mask,
    const long long* te_idx, const float* te_mask, const float* bandwidths,
    float* jtr, float* neg, float* zv_tr, float* jte, float* zv_te,
    float* no_ev, float* lm_const, float* wte, double* lndiff, float* ok,
    int n, int D, int F, int K, int ntr, int nte, int dpad, int rule,
    void* stream) {
  const long long G = static_cast<long long>(F) * K;
  if (F < 1 || K < 1 || G >= (1LL << 31) || dpad < 1 || dpad > kMaxD ||
      n < 0 || D < 0 || ntr < 0 || nte < 0 || rule < 0 || rule > 2 ||
      (rule == 2 && bandwidths == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WhitenArgs a{data,   null_mask, col_idx, col_mask, tr_idx, tr_mask,
                     te_idx, te_mask,   bandwidths, n,     D,      K,
                     ntr,    nte,       rule,    jtr,      neg,    zv_tr,
                     jte,    zv_te,     no_ev,   lm_const, wte,    lndiff,
                     ok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(G);
  switch (dpad) {
#define WHITEN_CASE(DP) \
  case DP:              \
    return static_cast<int>(launch_whiten<DP>(a, g, s));
    WHITEN_CASE(1)
    WHITEN_CASE(2)
    WHITEN_CASE(3)
    WHITEN_CASE(4)
    WHITEN_CASE(5)
    WHITEN_CASE(6)
    WHITEN_CASE(7)
    WHITEN_CASE(8)
    WHITEN_CASE(9)
    WHITEN_CASE(10)
    WHITEN_CASE(11)
    WHITEN_CASE(12)
    WHITEN_CASE(13)
    WHITEN_CASE(14)
    WHITEN_CASE(15)
    WHITEN_CASE(16)
#undef WHITEN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches on `stream` without synchronising; returns the launch's CUDA
// error code. rows and wte (F, K, nte) float32, lndiff (F, K) float64, ok
// (F, K) float32, out (F,) float32; 1 <= F < 2^31, K >= 1, nte >= 0.
extern "C" int ckde_cv_fold_reduce_f32(const float* rows, const float* wte,
                                       const double* lndiff, const float* ok,
                                       float* out, int F, int K, int nte,
                                       void* stream) {
  if (F < 1 || K < 1 || nte < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fold_reduce_kernel<<<F, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, wte, lndiff, ok, out, K, nte);
  return static_cast<int>(cudaGetLastError());
}
