// Stages 1 and 3 of the cross-validated conditional KDE (CV-CKDE) score for
// NVIDIA Hopper (sm_90a): the per-(family, fold) whitening before the pairs
// kernel of ckde_cv.cu, and the per-fold sums after it.
//
// 1. ckde_cv_whiten_f32 computes what `ckde_cv_whitened_parts` of
// pybnesian_tpu/ops/kde.py:303 computes (a jitted XLA function there, no
// Pallas kernel), one thread-block cluster per program g = f * K + k
// (family f, fold k):
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
// kde.py:404, XLA there too), one thread-block cluster per family:
//
//   out[f] = sum_k (ok[g] ? sum_i rows[g, i] wte[g, i] + lndiff[g] *
//                           sum_i wte[g, i] : NaN),  g = f * K + k
//
// with rows[g, i] taken as 0 where wte[g, i] is 0, in float64, rounded once.
//
// 3. ucv_starts_f32 forms the inputs of the UCV bandwidth searches of a
// CV score (ucv_pairs.cu's ucv_search_f32) for B = F * K problems of one
// width d, the columns given variable first, one thread-block cluster per
// problem g = f * K + k as in 1, from the same gather, leaves and sums:
//
//   n       = sum_r w_r,  S = sum_r xc_r xc_r^T  (as in 1, every cm 1)
//   start   = vech(chol(k_nr(n, d) * S / (n - 1)))   float64, column by
//             column of the lower triangle; NaN unless ok
//   ok      = n > d and every pivot positive
//   X[g]    = the rows with w_r > 0 in fold order, then zeros: (ntr, d)
//   valid   = 1 on those rows, 0 after;  Ns[g] = n
//
// the normal-reference start of the search and its padded rows, which the
// host formed with a gather, np.cov and np.linalg.cholesky per problem.
// The rows are copies of the data's float32 cells, so the block is the
// bits the host packed. A NaN start makes its search lane end after its
// first phase.
//
// Bound: bytes. The whitening writes (ntr + nte) * (dpad + 2) floats per
// program and reads each data cell it needs from L2 (the data of a CV call
// is a few hundred KB); its float64 work is ~3 d^2 operations a row. The
// reduce reads two floats per test row. The UCV starts read each train
// row's d cells, d null cells, mask and index (from L2, as the whitening's)
// and write its d + 1 floats: (8 d + 12) ntr bytes a problem read, 4 (d +
// 1) ntr written. PERF.md has the measured times against that bound.
//
// Design of the whitening:
//
// - Fixed leaves. A program's train rows fall into leaf_count(ntr) leaves
//   (common.cuh: a power of two up to kMaxLeaves, each at least kLeafRows
//   rows when there are two or more): leaf l holds rows [l * size, (l + 1)
//   * size), size = ceil(ntr / leaves). Within a leaf thread t sums rows
//   lo + t, lo + t + 256, ... in order in float64 registers, and the
//   block's 256 partial sums merge in a fixed tree (a warp's shuffles, then
//   the 8 warps in order); the leaves' sums then merge in a balanced binary
//   tree. No atomics: the order depends on ntr alone, so a family's outputs
//   are the same bits alone and in any batch, as those of kernels #1 and #2
//   are (ckde_cv.cu).
// - The order of a column's sums does not depend on dpad either: the mean
//   of column c and each covariance entry (i, j) are sums of their own, and
//   the covariance entries are only grouped (36 at a time) to bound the
//   registers. A family padded to the batch's widest family gets the bits
//   it gets alone.
// - A thread-block cluster per program. The wrapper chooses its size S
//   (a power of two up to the portable 8) from G and the SM count; cluster
//   rank q sweeps leaves [q L / S, (q + 1) L / S) and keeps each leaf's
//   sums in its shared memory, and after a cluster barrier every rank reads
//   every leaf's sums through distributed shared memory and merges them in
//   the tree. So every rank holds the same mean and covariance and forms
//   the same Cholesky factor and L^-1 itself (warp 0, float64, shared
//   memory, each entry by the operations a one-thread loop would use; no
//   broadcast). S decides only which block sweeps which leaf.
// - Rows gathered once. Each rank gathers its leaves' rows from the data
//   into shared memory with cp.async: the dpad float32 cells, then the row
//   weight in float64; the mean pass, the covariance pass and the whitening
//   read them there. One pipeline runs across a rank's leaves, each thread
//   with two rows in flight (stages_for), reading only the rows it
//   gathered itself. Where a rank's rows do not fit in kResidentBytes,
//   every pass gathers them again through the pipeline's slots.
// - Test rows are split over the cluster's ranks, gathered the same way.
// - Coalesced writes. Each tile of 256 whitened rows is staged in shared
//   memory and written as contiguous 16-byte stores (scalar at the edges).
// - A pivot that is not positive, or a factor entry that is not finite,
//   makes the factor NaN, as the plain version's cholesky_or_nan does:
//   every whitened value and lndiff become NaN.
// - The whitened rows are the full dpad x dpad product with L^-1 (zeros
//   above the diagonal included), as the plain matmul forms them, so that
//   a NaN cell of a row reaches every column of it there too.
// - An out-of-range row or column index reads NaN; nothing is read out of
//   bounds.
//
// Design of the UCV starts. A kernel of its own beside the whitening, which
// every CV score runs: its outputs (raw compacted rows, the factor in the
// variable-first order) have no place there. It shares the whitening's
// device functions and structure:
//
// - The same fixed leaves, cluster, cp.async gather and passes 1 and 2
//   (train_means, train_cov, which both kernels call) and warp-0 Cholesky
//   (factor_warp), so a problem's start is the same bits alone and in any
//   batch, at every S.
// - Compaction in fold order: pass 1's per-leaf counts of valid rows give
//   each leaf its first output row; within a leaf, each step's 256 rows
//   take their places by a block scan (a ballot per warp, the warps'
//   counts in order).
// - The padding (rows n .. ntr - 1 of X, the mask) is split over the
//   cluster's ranks; the start, ok and Ns are written by rank 0.
//
// Design of the fold reduce. Its work is two loads and a float64 fma chain
// per test row, so its time is the latency of the loads and of the block's
// reduction tree, paid once per fold by a block that walks its folds one
// after another. So:
//
// - A thread-block cluster of S blocks per family (S up to the portable 8
//   and up to K, chosen by the wrapper from F and the SM count): rank q
//   takes folds q, q + S, ..., so F S blocks work where F did.
// - A rank's folds go side by side, up to kMaxFolds at a time: each thread
//   loads R rows of every fold before it adds them, in each fold's own
//   row order, and one block_sum (three barriers) merges all their sums.
// - The folds are added in order by one thread of rank 0, from the values
//   that every rank writes into rank 0's shared memory through distributed
//   shared memory: no atomics, no scratch buffer, one launch.
// - The order of every sum is the one-block order (thread t's rows t, t +
//   256, ... of a fold, the block tree, the folds 0 .. K - 1), so the
//   result is the same bits at every S, and a family's result does not
//   depend on the others in its batch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 16;                   // widest family (kernel #1's)
constexpr int kMaxSums = 36;  // values of one block sum: covariance
                              // entries per pass, or dpad + 2 means
constexpr int kResidentBytes = 160 * 1024;  // most shared memory a rank's
                                            // staged rows may take
constexpr int kMaxFolds = 18;  // folds a rank of the fold reduce sums side
                               // by side: two sums each in one block sum
static_assert(2 * kMaxFolds <= kMaxSums, "a round's sums in one block sum");
constexpr double kLog2Pi = 1.8378770664093454835606594728112;  // log(2 pi)

// Rows a thread has in flight while gathering. Deeper pipelines measured
// slower at phase 4's inputs (4 and 8 rows: their slots cost blocks per
// SM; tools/kernel_sweeps.py stages, PERF.md), so two at every width.
__host__ __device__ constexpr int stages_for(int) { return 2; }

// Rows of each of nf folds that a thread of the fold reduce loads before it
// adds them: as many as keep the batch's 2 nf R floats and the nf folds'
// float64 sums (4 nf registers) within 40 registers, at least one. Above
// that ptxas held four folds at 64 registers by spilling (R 4 at nf 4).
__host__ __device__ constexpr int reduce_batch(int nf) {
  return 20 / nf - 2 > 1 ? 20 / nf - 2 : 1;
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
  int split;                 // S, blocks of a program's cluster
  int cap;                   // rows the stage holds
  int resident;              // 1: a rank's train rows stay staged
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

// The rows a block has staged, in its dynamic shared memory.
template <int D>
struct Stage {
  double* w;   // [cap] row weights of the resident rows
  float* x;    // [D][cap] the rows' cells
  float* nl;   // [stages][D][kThreads] null cells of the rows in flight
  float* m;    // [stages][kThreads] their fold mask, NaN for a bad row
  float* out;  // [kThreads * D + 4] a tile of whitened rows
  int cap;
};

// Bytes of a Stage of `cap` rows; cap is a multiple of 4, so that `out`
// starts 16-byte aligned.
__host__ __device__ __forceinline__ size_t stage_bytes(int D, int cap) {
  return 8 * static_cast<size_t>(cap) + 4 * static_cast<size_t>(D) * cap +
         4 * static_cast<size_t>(stages_for(D)) * (D + 1) * kThreads +
         4 * (static_cast<size_t>(kThreads) * D + 4);
}

// Value e summed over the program's leaves in a balanced binary tree,
// ((v0 v1) (v2 v3)) ((v4 v5) (v6 v7)): leaf l's sum is part[(l -
// first_leaf(owner)) * stride + e] in the shared memory of its owner.
__device__ __forceinline__ double merge_leaves(const double* part, int stride,
                                               int e, int leaves, int split) {
  double v[kMaxLeaves];
#pragma unroll
  for (int l = 0; l < kMaxLeaves; ++l) {
    v[l] = 0.0;
    if (l < leaves) {
      const int owner = leaf_owner(l, leaves, split);
      const double* base =
          split > 1 ? cg::this_cluster().map_shared_rank(part, owner) : part;
      v[l] = base[(l - first_leaf(owner, leaves, split)) * stride + e];
    }
  }
#pragma unroll
  for (int w = 1; w < kMaxLeaves; w *= 2) {
#pragma unroll
    for (int b = 0; b + w < kMaxLeaves; b += 2 * w) {
      if (b + w < leaves) v[b] = __dadd_rn(v[b], v[b + w]);
    }
  }
  return v[0];
}

// The rows of leaves [l0, l1): leaf l holds [lo + l * size, min(n, lo + (l
// + 1) * size)) (the train rows' leaves: lo 0; a rank's test rows: one
// leaf of its share).
struct Leaves {
  int lo, n, size, l0, l1;
};

// Where a walk is: leaf `leaf`, step j of its `steps` (thread t's row lo +
// t + j kThreads of [lo, hi)); an empty leaf takes one step with no row.
struct Cursor {
  int leaf, j, lo, hi, steps;
  __device__ __forceinline__ void start(const Leaves& L, int l) {
    leaf = l;
    j = 0;
    lo = l < L.l1 ? min(L.n, L.lo + l * L.size) : 0;
    hi = l < L.l1 ? min(L.n, lo + L.size) : 0;
    steps = max(1, (hi - lo + kThreads - 1) / kThreads);
  }
  __device__ __forceinline__ void next(const Leaves& L) {
    if (++j == steps) start(L, leaf + 1);
  }
  __device__ __forceinline__ int row() const {
    return lo + static_cast<int>(threadIdx.x) + j * kThreads;
  }
  __device__ __forceinline__ bool live() const { return row() < hi; }
  __device__ __forceinline__ bool last() const { return j == steps - 1; }
};

// Walks the rows of leaves [L.l0, L.l1) in order, thread t its rows lo +
// t, lo + t + kThreads, ... of each leaf, in steps that every thread
// takes: at each step it calls use(c, active, x, w), c the cursor (c.last()
// at a leaf's last step), active: the thread has a row r = c.row(), x its
// dpad cells times the column mask, w = mask[r] * fvalid (NaN for an
// out-of-range row or column). With `gather` the rows come from the data
// by cp.async in one pipeline across the leaves, stages_for(D) rows in
// flight per thread: cells to the stage at r - base (base >= 0: the rank's
// resident rows, whose weights are kept in st.w) or at the row's slot
// (base < 0), null cells and mask to its slot. Without, they are read from
// the resident stage. A thread reads only the rows it staged itself.
template <int D, class Use>
__device__ __forceinline__ void walk_rows(const WhitenArgs& a,
                                          const Family<D>& fam,
                                          const Stage<D>& st,
                                          const long long* idx,
                                          const float* mask, const Leaves& L,
                                          int base, bool gather, Use&& use) {
  constexpr int ST = stages_for(D);
  const int t = threadIdx.x;
  int total = 0;
  for (int l = L.l0; l < L.l1; ++l) {
    Cursor c;
    c.start(L, l);
    total += c.steps;
  }
  Cursor u;
  u.start(L, L.l0);
  if (!gather) {
    for (int s = 0; s < total; ++s, u.next(L)) {
      const bool active = u.live();
      double x[D];
      double w = 0.0;
      if (active) {
        const int p = u.row() - base;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          x[c] = __dmul_rn(st.x[c * st.cap + p], fam.cm[c]);
        }
        w = st.w[p];
      }
      use(u, active, x, w);
    }
    return;
  }
  auto fetch = [&](const Cursor& c, int s, long long row) {
    if (c.live()) {
      const int r = c.row();
      const int slot = s % ST;
      const int p = base >= 0 ? r - base : slot * kThreads + t;
      float* nl = st.nl + slot * D * kThreads + t;
      const bool row_ok = row >= 0 && row < a.n;
      bool bad = !row_ok;
#pragma unroll
      for (int c2 = 0; c2 < D; ++c2) {
        const long long ci = fam.col[c2];
        if (row_ok && ci >= 0) {
          const size_t cell = static_cast<size_t>(row) * a.D + ci;
          cp_async4(st.x + c2 * st.cap + p, a.data + cell);
          cp_async4(nl + c2 * kThreads, a.null_mask + cell);
        } else {
          st.x[c2 * st.cap + p] = qnanf();
          nl[c2 * kThreads] = 0.0f;
          bad = true;
        }
      }
      float* m = st.m + slot * kThreads + t;
      if (bad) {
        *m = qnanf();
      } else {
        cp_async4(m, mask + r);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // the rows' indices, read one step ahead of their copies
  Cursor c = u, ahead = u;
  long long rows[ST];
#pragma unroll
  for (int k = 0; k < ST; ++k) {
    rows[k] = ahead.live() ? idx[ahead.row()] : 0;
    ahead.next(L);
  }
#pragma unroll
  for (int k = 0; k < ST - 1; ++k) {
    fetch(c, k, rows[k]);
    c.next(L);
  }
  long long pending = rows[ST - 1];
  for (int s = 0; s < total; ++s) {
    fetch(c, s + ST - 1, pending);
    c.next(L);
    pending = ahead.live() ? idx[ahead.row()] : 0;  // read while s waits
    ahead.next(L);
    cp_async_wait<ST - 1>();  // step s has landed
    const bool active = u.live();
    double x[D];
    double w = 0.0;
    if (active) {
      const int slot = s % ST;
      const int p = base >= 0 ? u.row() - base : slot * kThreads + t;
      const float* nl = st.nl + slot * D * kThreads + t;
      double null_max = 0.0;
#pragma unroll
      for (int c2 = 0; c2 < D; ++c2) {
        x[c2] = __dmul_rn(st.x[c2 * st.cap + p], fam.cm[c2]);
        null_max = fmax(null_max, __dmul_rn(nl[c2 * kThreads], fam.cm[c2]));
      }
      w = __dmul_rn(st.m[slot * kThreads + t], 1.0 - null_max);
      if (base >= 0) st.w[p] = w;
    }
    use(u, active, x, w);
    u.next(L);
  }
  cp_async_wait<0>();
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

// Writes `count` floats s[shift ..) to dst, coalesced: scalar up to dst's
// first 16-byte boundary (dst + head), float4 from there, scalar after.
// (dst - shift) is 16-byte aligned in the caller's array, and s too.
__device__ __forceinline__ void write_rows(const float* s, int shift,
                                           float* dst, int count) {
  const int head = min(count, (4 - shift) & 3);
  const int n4 = (count - head) / 4;
  for (int e = threadIdx.x; e < head; e += kThreads) dst[e] = s[shift + e];
  const float4* s4 = reinterpret_cast<const float4*>(s + shift + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int e = threadIdx.x; e < n4; e += kThreads) d4[e] = s4[e];
  for (int e = head + 4 * n4 + threadIdx.x; e < count; e += kThreads) {
    dst[e] = s[shift + e];
  }
}

// The whitened rows of one walk_rows step at cursor c, in the (G, rows, D)
// output array `out` from row `base`: each thread's row to the staged
// tile, its variable coordinate to zv and its weight to wt (as is) or to
// neg (0 / -inf); then the step's rows written coalesced.
template <int D>
__device__ __forceinline__ void whiten_step(
    const Stage<D>& st, const double (*Linv)[D], const Family<D>& fam,
    const Cursor& c, bool active, const double (&x)[D], double w,
    size_t base, float* out, float* zv, float* wt, float* neg) {
  const int row0 = c.lo + c.j * kThreads;
  const int shift = static_cast<int>(((base + row0) * D) % 4);
  if (active) {
    const int r = c.row();
    zv[base + r] = static_cast<float>(
        whiten_row(x, Linv, fam, st.out + shift + threadIdx.x * D));
    if (wt != nullptr) wt[base + r] = static_cast<float>(w);
    if (neg != nullptr) neg[base + r] = w > 0.0 ? 0.0f : -INFINITY;
  }
  __syncthreads();
  write_rows(st.out, shift, out + (base + row0) * D,
             min(kThreads, c.hi - row0) * D);
  __syncthreads();
}

// The Cholesky factor of H (s_L, lower triangle, in place), L^-1 and
// lndiff by the 32 lanes of warp 0: column j of the factor by lanes j ..
// D - 1, then column j of L^-1 by lane j. Each entry is formed by the same
// operations in the same order as a one-thread loop would form it. A pivot
// that is not positive or an entry that is not finite makes L^-1 and
// lndiff NaN.
template <int D>
__device__ __forceinline__ void factor_warp(double (*s_L)[D],
                                            double (*s_Linv)[D],
                                            const Family<D>& fam,
                                            double* lndiff) {
  const int lane = threadIdx.x;
  bool good = true;
  for (int j = 0; j < D; ++j) {
    double t = 0.0;
    if (lane >= j && lane < D) {
      t = s_L[lane][j];
      for (int q = 0; q < j; ++q) t = fma(-s_L[lane][q], s_L[j][q], t);
    }
    const double s = __shfl_sync(0xffffffffu, t, j);  // the pivot
    good = good && s > 0.0;
    const double ljj = sqrt(s);
    if (lane == j) s_L[j][j] = ljj;
    if (lane > j && lane < D) s_L[lane][j] = __ddiv_rn(t, ljj);
    __syncwarp();
  }
  bool finite = true;
  double lg = 0.0;
  if (lane < D) {
    for (int j = 0; j <= lane; ++j) finite = finite && isfinite(s_L[lane][j]);
    lg = log(fabs(s_L[lane][lane]));
  }
  good = good && __all_sync(0xffffffffu, finite);
  double logdet_v = 0.0;
  for (int i = 0; i < D; ++i) {
    logdet_v = fma(__shfl_sync(0xffffffffu, lg, i), fam.vsel[i], logdet_v);
  }
  if (lane < D) {
    const int j = lane;
    for (int i = 0; i < D; ++i) {
      double v = 0.0;
      if (i == j) {
        v = __drcp_rn(s_L[j][j]);
      } else if (i > j) {
        double s = 0.0;
        for (int q = j; q < i; ++q) s = fma(s_L[i][q], s_Linv[q][j], s);
        v = __ddiv_rn(-s, s_L[i][i]);
      }
      s_Linv[i][j] = good ? v : qnan();
    }
  }
  if (lane == 0) *lndiff = good ? -logdet_v - 0.5 * kLog2Pi : qnan();
}

// Where train_means and train_cov put a program's train-row sums: the
// kernel's own shared arrays. (One shared struct in their place would lay
// them out anew, and ptxas then allocates the kernels' registers anew.)
template <int D>
struct Sums {
  static constexpr int P = D * (D + 1) / 2;  // lower-triangle covariance
                                             // entries
  static constexpr int M = D + 2;  // mean sums: the columns, n_eff, valid
                                   // rows
  static constexpr int T = P > M ? P : M;
  double (*red)[kMaxSums];  // [kWarps] rows of block_sum's
  double* sum;              // [kMaxSums] a block sum
  double* lmean;            // [kMaxLeaves * M] this rank's leaves' sums
  double* lcov;             // [kMaxLeaves * P]
  double* tot;              // [T] the program's merged sums
};

// A program's train rows as train_means sets them: the stage, the fold's
// rows, the rank's leaves, and the merged weight and count of valid rows.
template <int D>
struct TrainRows {
  Stage<D> st;
  const long long* idx;  // (ntr,) the fold's rows
  const float* mask;     // (ntr,)
  Leaves leaves;         // the rank's leaves
  int count;             // the program's leaves
  int split;             // the cluster's blocks
  int base;              // the first resident row, or -1
  double n_eff, n_valid;
};

// Pass 1 over the train rows of fold k by cluster rank `rank` of `split`,
// shared by whiten_kernel and ucv_starts_kernel once they have set the
// family in fam and synchronised: lays out the stage in s_stage, gathers
// the rank's rows and sums per leaf the weighted columns, n_eff and the
// valid rows, then merges the leaves' sums into sums.tot and the means
// into fam.mean; t receives the rows' places and totals. merged(leaves,
// count) runs between the merge and the means, while every rank's leaf
// sums are readable.
template <int D, class Merged>
__device__ __forceinline__ void train_means(const WhitenArgs& a,
                                            Family<D>& fam,
                                            const Sums<D> sums,
                                            unsigned char* s_stage,
                                            int split, int rank, int k,
                                            TrainRows<D>& t,
                                            Merged&& merged) {
  constexpr int M = Sums<D>::M;
  constexpr int ST = stages_for(D);
  Stage<D>& st = t.st;
  st.cap = a.cap;
  st.w = reinterpret_cast<double*>(s_stage);
  st.x = reinterpret_cast<float*>(st.w + a.cap);
  st.nl = st.x + D * a.cap;
  st.m = st.nl + ST * D * kThreads;
  st.out = st.m + ST * kThreads;

  t.idx = a.tr_idx + static_cast<size_t>(k) * a.ntr;
  t.mask = a.tr_mask + static_cast<size_t>(k) * a.ntr;
  const int leaves = leaf_count(a.ntr);
  const int size = (a.ntr + leaves - 1) / leaves;
  const int l0 = first_leaf(rank, leaves, split);
  const int l1 = first_leaf(rank + 1, leaves, split);
  t.leaves = Leaves{0, a.ntr, size, l0, l1};
  t.count = leaves;
  t.split = split;
  t.base = a.resident ? min(a.ntr, l0 * size) : -1;

  double m[M];
#pragma unroll
  for (int i = 0; i < M; ++i) m[i] = 0.0;
  walk_rows(a, fam, st, t.idx, t.mask, t.leaves, t.base, true,
            [&](const Cursor& c, bool active, auto& x, double w) {
              if (active) {
#pragma unroll
                for (int q = 0; q < D; ++q) m[q] = fma(x[q], w, m[q]);
                m[D] = __dadd_rn(m[D], w);
                m[D + 1] += w > 0.0 ? 1.0 : 0.0;
              }
              if (c.last()) {
                block_sum<kWarps>(m, sums.red, sums.sum);
                if (threadIdx.x < M) {
                  sums.lmean[(c.leaf - l0) * M + threadIdx.x] =
                      sums.sum[threadIdx.x];
                }
#pragma unroll
                for (int i = 0; i < M; ++i) m[i] = 0.0;
              }
            });
  cluster_sync(split);  // every leaf's sums are in place
  if (threadIdx.x < M) {
    sums.tot[threadIdx.x] =
        merge_leaves(sums.lmean, M, threadIdx.x, leaves, split);
  }
  merged(t.leaves, leaves);
  __syncthreads();
  t.n_eff = sums.tot[D];
  t.n_valid = sums.tot[D + 1];
  if (threadIdx.x < D) {
    fam.mean[threadIdx.x] = __ddiv_rn(sums.tot[threadIdx.x], t.n_eff);
  }
  __syncthreads();
}

// Pass 2 over the rows of train_means: per leaf the centred covariance, C
// entries (i, j), j <= i, per sweep of the rank's rows, merged into
// sums.tot[0 .. P). Every rank then arrives at the cluster barrier after
// which no rank reads another's sums (the caller waits on it last).
// kMasked: a centred row is scaled by w * cm (the whitening's masked
// columns), else by w (every mask 1).
template <int D, bool kMasked>
__device__ __forceinline__ void train_cov(const WhitenArgs& a,
                                          const Family<D>& fam,
                                          const Sums<D> sums,
                                          const TrainRows<D>& t) {
  constexpr int P = Sums<D>::P;
  constexpr int C = P < kMaxSums ? P : kMaxSums;  // entries per pass
  const int split = t.split;
  const int l0 = t.leaves.l0;
#pragma unroll
  for (int p0 = 0; p0 < P; p0 += C) {
    double acc[C];
#pragma unroll
    for (int e = 0; e < C; ++e) acc[e] = 0.0;
    walk_rows(a, fam, t.st, t.idx, t.mask, t.leaves, t.base, !a.resident,
              [&](const Cursor& c, bool active, auto& x, double w) {
                if (active) {
#pragma unroll
                  for (int q = 0; q < D; ++q) {
                    if constexpr (kMasked) {
                      x[q] = __dmul_rn(__dsub_rn(x[q], fam.mean[q]),
                                       __dmul_rn(w, fam.cm[q]));
                    } else {
                      x[q] = __dmul_rn(__dsub_rn(x[q], fam.mean[q]), w);
                    }
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
                if (c.last()) {
                  block_sum<kWarps>(acc, sums.red, sums.sum);
                  if (threadIdx.x < C &&
                      p0 + static_cast<int>(threadIdx.x) < P) {
                    sums.lcov[(c.leaf - l0) * P + p0 + threadIdx.x] =
                        sums.sum[threadIdx.x];
                  }
#pragma unroll
                  for (int e = 0; e < C; ++e) acc[e] = 0.0;
                }
              });
  }
  cluster_sync(split);  // every leaf's covariance sums are in place
  if (threadIdx.x < P) {
    sums.tot[threadIdx.x] =
        merge_leaves(sums.lcov, P, threadIdx.x, t.count, split);
  }
  if (split > 1) cluster_arrive();  // done reading the cluster's sums
  __syncthreads();
}

// Grid G * split, clusters of `split` blocks along x: program g =
// blockIdx.x / split, cluster rank blockIdx.x % split.
template <int D>
__global__ void __launch_bounds__(kThreads)
    whiten_kernel(const WhitenArgs a) {
  constexpr int P = Sums<D>::P;
  __shared__ double s_red[kWarps][kMaxSums];
  __shared__ double s_sum[kMaxSums];
  __shared__ double s_lmean[kMaxLeaves * Sums<D>::M];
  __shared__ double s_lcov[kMaxLeaves * P];
  __shared__ double s_tot[Sums<D>::T];
  const Sums<D> sums{s_red, s_sum, s_lmean, s_lcov, s_tot};
  __shared__ double s_L[D][D];     // H, then its Cholesky factor in place
  __shared__ double s_Linv[D][D];
  __shared__ double s_lndiff;
  __shared__ Family<D> fam;
  extern __shared__ __align__(16) unsigned char s_stage[];

  const int split = a.split;
  const int g = blockIdx.x / split, rank = blockIdx.x % split;
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
  TrainRows<D> t;
  train_means(a, fam, sums, s_stage, split, rank, k, t,
              [](const Leaves&, int) {});
  if (a.rule == 2) {
    if (split > 1) cluster_arrive();  // done reading the cluster's sums
    const float* bw = a.bandwidths + static_cast<size_t>(g) * D * D;
    if (threadIdx.x < D * D) {
      const int i = threadIdx.x / D, j = threadIdx.x % D;
      s_L[i][j] = __dadd_rn(
          __dmul_rn(bw[i * D + j], __dmul_rn(fam.cm[i], fam.cm[j])),
          i == j ? 1.0 - fam.cm[i] : 0.0);
    }
  } else {
    train_cov<D, true>(a, fam, sums, t);
    if (threadIdx.x < P) {
      const int e = threadIdx.x;
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      const int j = e - i * (i + 1) / 2;
      const double factor =
          a.rule == 0
              ? pow(4.0 / (t.n_eff * (d_eff + 2.0)), 2.0 / (d_eff + 4.0))
              : pow(t.n_eff, -2.0 / (d_eff + 4.0));
      const double h = __dadd_rn(
          __dmul_rn(factor, __ddiv_rn(sums.tot[e], t.n_eff - 1.0)),
          i == j ? 1.0 - fam.cm[i] : 0.0);
      s_L[i][j] = h;
      s_L[j][i] = h;
    }
  }
  __syncthreads();
  // the Cholesky factor and L^-1 by warp 0 of every rank, from the same sums
  if (threadIdx.x < 32) factor_warp(s_L, s_Linv, fam, &s_lndiff);
  __syncthreads();

  // the whitened train rows, their variable coordinate and the row mask
  const size_t tr_base = static_cast<size_t>(g) * a.ntr;
  walk_rows(a, fam, t.st, t.idx, t.mask, t.leaves, t.base, !a.resident,
            [&](const Cursor& c, bool active, auto& x, double w) {
              whiten_step(t.st, s_Linv, fam, c, active, x, w, tr_base, a.jtr,
                          a.zv_tr, nullptr, a.neg);
            });
  __syncthreads();  // the resident rows are read: test rows take the slots

  // the rank's share of the whitened test rows, their variable coordinate
  // and their weights
  const long long* te_idx = a.te_idx + static_cast<size_t>(k) * a.nte;
  const float* te_mask = a.te_mask + static_cast<size_t>(k) * a.nte;
  const size_t te_base = static_cast<size_t>(g) * a.nte;
  const int per = (a.nte + split - 1) / split;
  const Leaves test{min(a.nte, rank * per), a.nte, per, 0, 1};
  walk_rows(a, fam, t.st, te_idx, te_mask, test, -1, true,
            [&](const Cursor& c, bool active, auto& x, double w) {
              whiten_step(t.st, s_Linv, fam, c, active, x, w, te_base, a.jte,
                          a.zv_te, a.wte, nullptr);
            });
  if (rank == 0 && threadIdx.x == 0) {
    a.no_ev[g] = d_eff <= 1.0 ? 1.0f : 0.0f;
    a.lm_const[g] = static_cast<float>(log(fmax(t.n_valid, 1.0)));
    a.lndiff[g] = s_lndiff;
    a.ok[g] = t.n_eff > d_eff ? 1.0f : 0.0f;
  }
  if (split > 1) cluster_wait();  // no block leaves while another reads it
}

// What ucv_starts_kernel writes; it reads the WhitenArgs' data, null_mask,
// col_idx (G / K families of D columns, the variable first), tr_idx,
// tr_mask, n, D, K, ntr and its launch plan (split, cap, resident).
struct StartsOut {
  float* X;        // (G, ntr, D) the valid train rows in fold order, zeros
  float* valid;    // (G, ntr) 1 on those rows, 0 after
  float* Ns;       // (G,) the valid rows
  double* starts;  // (G, D (D + 1) / 2) vech of the start's factor, or NaN
  float* ok;       // (G,) 1: more than D valid rows and a positive factor
};

// Grid G * split, clusters of `split` blocks along x, as whiten_kernel's:
// its passes 1 and 2 with every column mask 1, the normal-reference factor,
// then the compacted rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
    ucv_starts_kernel(const WhitenArgs a, const StartsOut o) {
  constexpr int P = Sums<D>::P;
  constexpr int M = Sums<D>::M;
  __shared__ double s_red[kWarps][kMaxSums];
  __shared__ double s_sum[kMaxSums];
  __shared__ double s_lmean[kMaxLeaves * Sums<D>::M];
  __shared__ double s_lcov[kMaxLeaves * P];
  __shared__ double s_tot[Sums<D>::T];
  const Sums<D> sums{s_red, s_sum, s_lmean, s_lcov, s_tot};
  __shared__ double s_L[D][D];     // H, then its Cholesky factor in place
  __shared__ double s_Linv[D][D];
  __shared__ double s_lndiff;
  __shared__ int s_first[kMaxLeaves];  // first output row of each leaf of
                                       // the rank's
  __shared__ int s_warp[kWarps];       // a step's valid rows by warp
  __shared__ Family<D> fam;
  extern __shared__ __align__(16) unsigned char s_stage[];

  const int split = a.split;
  const int g = blockIdx.x / split, rank = blockIdx.x % split;
  const int f = g / a.K, k = g % a.K;
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    const long long ci = a.col_idx[static_cast<size_t>(f) * D + c];
    fam.col[c] = ci >= 0 && ci < a.D ? ci : -1;
    fam.cm[c] = 1.0;
    // factor_warp's lndiff is then -log L_00 - log(2 pi) / 2: NaN exactly
    // when the factor failed
    fam.vsel[c] = c == 0 ? 1.0 : 0.0;
  }
  __syncthreads();
  TrainRows<D> t;
  train_means(
      a, fam, sums, s_stage, split, rank, k, t,
      [&](const Leaves& L, int leaves) {
        if (threadIdx.x == 32) {
          // the valid rows of the leaves before each of the rank's leaves
          double before = 0.0;
          for (int l = 0; l < L.l1; ++l) {
            if (l >= L.l0) s_first[l - L.l0] = static_cast<int>(before);
            const int owner = leaf_owner(l, leaves, split);
            const double* part = sums.lmean;
            if (split > 1) {
              part = cg::this_cluster().map_shared_rank(part, owner);
            }
            before += part[(l - first_leaf(owner, leaves, split)) * M + D + 1];
          }
        }
      });
  train_cov<D, false>(a, fam, sums, t);
  if (threadIdx.x < P) {
    const int e = threadIdx.x;
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    const int j = e - i * (i + 1) / 2;
    const double factor = pow(4.0 / (t.n_eff * (D + 2.0)), 2.0 / (D + 4.0));
    const double h = __dmul_rn(factor, __ddiv_rn(sums.tot[e], t.n_eff - 1.0));
    s_L[i][j] = h;
    s_L[j][i] = h;
  }
  __syncthreads();
  if (threadIdx.x < 32) factor_warp(s_L, s_Linv, fam, &s_lndiff);
  __syncthreads();

  // the valid rows, compacted: step by step, each leaf from its first
  // output row
  const size_t row0 = static_cast<size_t>(g) * a.ntr;
  int run = 0;  // output rows the leaf's earlier steps took
  walk_rows(a, fam, t.st, t.idx, t.mask, t.leaves, t.base, !a.resident,
            [&](const Cursor& c, bool active, auto& x, double w) {
              const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
              const bool keep = active && w > 0.0;
              const unsigned votes = __ballot_sync(0xffffffffu, keep);
              if (lane == 0) s_warp[warp] = __popc(votes);
              __syncthreads();
              if (c.j == 0) run = s_first[c.leaf - t.leaves.l0];
              int at = run + __popc(votes & ((1u << lane) - 1u));
              int step = 0;
#pragma unroll
              for (int q = 0; q < kWarps; ++q) {
                if (q < warp) at += s_warp[q];
                step += s_warp[q];
              }
              if (keep) {
                float* dst = o.X + (row0 + at) * D;
#pragma unroll
                for (int q = 0; q < D; ++q) dst[q] = static_cast<float>(x[q]);
              }
              run += step;
              __syncthreads();  // s_warp is read before the next step
            });

  // the rank's share of the mask and of the zero rows after the valid ones
  const int nv = static_cast<int>(t.n_valid);
  const int per = (a.ntr + split - 1) / split;
  const int lo = min(a.ntr, rank * per), hi = min(a.ntr, lo + per);
  for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
    o.valid[row0 + r] = r < nv ? 1.0f : 0.0f;
  }
  for (size_t e = (row0 + max(lo, nv)) * D + threadIdx.x;
       e < (row0 + hi) * D; e += kThreads) {
    o.X[e] = 0.0f;
  }
  if (rank == 0) {
    const bool good = t.n_eff > D && !isnan(s_lndiff);
    if (threadIdx.x < P) {
      // vech: the lower triangle column by column
      int j = 0, e = threadIdx.x;
      while (e >= D - j) {
        e -= D - j;
        ++j;
      }
      o.starts[static_cast<size_t>(g) * P + threadIdx.x] =
          good ? s_L[j + e][j] : qnan();
    }
    if (threadIdx.x == 0) {
      o.ok[g] = good ? 1.0f : 0.0f;
      o.Ns[g] = static_cast<float>(t.n_valid);
    }
  }
  if (split > 1) cluster_wait();  // no block leaves while another reads it
}

// A thread-block cluster of `split` blocks per family f: rank q sums the
// folds k = q, q + split, q + 2 split, ... in rounds of NF side by side,
// round r taking folds [r NF split, (r + 1) NF split). For each fold of
// a round, thread t sums rows t, t + 256, ... in order (fma(v, w, s0),
// s1 + w), loading R rows of every fold of the round before it adds them;
// one block_sum then merges all the round's 2 NF sums, each in the tree
// that a block_sum of its fold's two sums alone would use. The rank
// writes each fold's value into rank 0's shared memory (distributed
// shared memory) at its place in the round, and after a cluster barrier
// one thread of rank 0 adds the round's folds in order to the family's
// total. Every fold's value and the order of the folds are those of one
// block summing the folds one after another, at every split.
template <int NF>
__global__ void __launch_bounds__(kThreads)
    fold_reduce_kernel(const float* __restrict__ rows,
                       const float* __restrict__ wte,
                       const double* __restrict__ lndiff,
                       const float* __restrict__ ok, float* __restrict__ out,
                       int K, int nte, int split) {
  constexpr int R = reduce_batch(NF);
  __shared__ double s_red[kWarps][kMaxSums];
  __shared__ double s_sum[kMaxSums];
  __shared__ double s_fold[2][NF * kMaxSplit];  // rank 0's: a round's folds
  const int f = blockIdx.x / split, q = blockIdx.x % split;
  const int t = threadIdx.x;
  const int per_round = NF * split;
  double* dst = &s_fold[0][0];  // rank 0's s_fold
  if (split > 1) {
    dst = cg::this_cluster().map_shared_rank(dst, 0);
    cluster_arrive();  // started: rank 0's shared memory may be written
  }
  const size_t stride = static_cast<size_t>(split) * nte;  // fold j to j + 1
  double total = 0.0;
  for (int k0 = 0, r = 0; k0 < K; k0 += per_round, ++r) {
    const int first = k0 + q;  // the rank's first fold of the round
    const size_t g0 = static_cast<size_t>(f) * K + first;
    // thread j < NF: the term of the round's fold j, read before the rows
    const int kt = first + t * split;
    const bool term = t < NF && kt < K;
    double ld = 0.0;
    float okt = 0.0f;
    if (term) {
      ld = lndiff[g0 + static_cast<size_t>(t) * split];
      okt = ok[g0 + static_cast<size_t>(t) * split];
    }
    const float* rg = rows + g0 * nte;
    const float* wg = wte + g0 * nte;
    double s[2 * NF];
#pragma unroll
    for (int e = 0; e < 2 * NF; ++e) s[e] = 0.0;
    for (int i0 = t; i0 < nte; i0 += R * kThreads) {
      float v[NF][R], w[NF][R];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int i = i0 + m * kThreads;
          const bool in = first + j * split < K && i < nte;
          const size_t at = j * stride + i;
          v[j][m] = in ? rg[at] : 0.0f;
          w[j][m] = in ? wg[at] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          if (first + j * split < K && i0 + m * kThreads < nte) {
            const double wd = w[j][m];
            const double vd = wd > 0.0 ? static_cast<double>(v[j][m]) : 0.0;
            s[2 * j] = fma(vd, wd, s[2 * j]);
            s[2 * j + 1] = __dadd_rn(s[2 * j + 1], wd);
          }
        }
      }
    }
    block_sum<kWarps>(s, s_red, s_sum);
    if (split > 1 && r == 0) cluster_wait();  // every rank has started
    if (term) {
      const double fold = fma(ld, s_sum[2 * t + 1], s_sum[2 * t]);
      dst[(r & 1) * NF * kMaxSplit + q + t * split] =
          okt > 0.0f ? fold : qnan();
    }
    cluster_sync(split);  // the round's folds are in rank 0's s_fold
    if (q == 0 && t == 0) {
      const int n = min(per_round, K - k0);
      for (int e = 0; e < n; ++e) total = __dadd_rn(total, s_fold[r & 1][e]);
    }
  }
  if (q == 0 && t == 0) out[f] = static_cast<float>(total);
}

template <int NF>
cudaError_t launch_reduce(const float* rows, const float* wte,
                          const double* lndiff, const float* ok, float* out,
                          int F, int K, int nte, int split, cudaStream_t s) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(F * split);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fold_reduce_kernel<NF>, rows, wte, lndiff, ok, out, K, nte,
      split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The stage of a launch: a rank's train rows resident when they fit in
// kResidentBytes (at most ceil(leaves / split) leaves of `size` rows, and
// room for the test rows' slots), else the slots alone.
void plan_stage(WhitenArgs& a, int D) {
  const int leaves = leaf_count(a.ntr);
  const int size = (a.ntr + leaves - 1) / leaves;
  const int rows = (leaves + a.split - 1) / a.split * size;
  const int slots = stages_for(D) * kThreads;
  const int cap = ((rows > slots ? rows : slots) + 3) / 4 * 4;
  a.resident = stage_bytes(D, cap) <= kResidentBytes ? 1 : 0;
  a.cap = a.resident ? cap : slots;
}

template <int D>
cudaError_t launch_whiten(WhitenArgs a, int G, cudaStream_t s) {
  plan_stage(a, D);
  const size_t bytes = stage_bytes(D, a.cap);
  // with the static arrays, most stages pass the default 48 KB
  const cudaError_t set = cudaFuncSetAttribute(
      whiten_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * a.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, whiten_kernel<D>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_starts(WhitenArgs a, const StartsOut& o, int G,
                          cudaStream_t s) {
  plan_stage(a, D);
  const size_t bytes = stage_bytes(D, a.cap);
  const cudaError_t set = cudaFuncSetAttribute(
      ucv_starts_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * a.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ucv_starts_kernel<D>, a, o);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// the CUDA error code of the launch: 0 on success. Allocates nothing. All
// arrays are contiguous on the current device, shapes as in WhitenArgs
// above; `bandwidths` is read only when rule is 2 and may be null
// otherwise. G = F * K with 1 <= G * split < 2^31, 1 <= dpad <= 16, K >= 1,
// n, D, ntr, nte >= 0; the launch plan: `split` S, a power of two up to 8,
// blocks of a cluster sharing each program's leaves; anything else returns
// cudaErrorInvalidValue.
extern "C" int ckde_cv_whiten_f32(
    const float* data, const float* null_mask, const long long* col_idx,
    const float* col_mask, const long long* tr_idx, const float* tr_mask,
    const long long* te_idx, const float* te_mask, const float* bandwidths,
    float* jtr, float* neg, float* zv_tr, float* jte, float* zv_te,
    float* no_ev, float* lm_const, float* wte, double* lndiff, float* ok,
    int n, int D, int F, int K, int ntr, int nte, int dpad, int rule,
    int split, void* stream) {
  const long long G = static_cast<long long>(F) * K;
  if (F < 1 || K < 1 || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) != 0 || G * split >= (1LL << 31) || dpad < 1 || dpad > kMaxD || n < 0 ||
      D < 0 || ntr < 0 || nte < 0 || rule < 0 || rule > 2 ||
      (rule == 2 && bandwidths == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WhitenArgs a{data,   null_mask, col_idx, col_mask, tr_idx, tr_mask,
                     te_idx, te_mask,   bandwidths, n,     D,      K,
                     ntr,    nte,       rule,    jtr,      neg,    zv_tr,
                     jte,    zv_te,     no_ev,   lm_const, wte,    lndiff,
                     ok,     split,     0,       0};
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

// Launches on `stream` without synchronising and returns the launch's CUDA
// error code. Allocates nothing. data and null_mask (n, D) float32, col_idx
// (F, d) int64 (each family's columns, the variable first), tr_idx (K, ntr)
// int64, tr_mask (K, ntr) float32; outputs for G = F * K problems: X (G,
// ntr, d), valid (G, ntr), Ns (G,), ok (G,) float32, starts (G, d (d + 1)
// / 2) float64. 1 <= d <= 16, K >= 1, n, D, ntr >= 0, and the launch plan:
// `split` S, a power of two up to 8 with 1 <= G * S < 2^31, as the
// whitening's; anything else returns cudaErrorInvalidValue. The outputs are
// the same bits at every S.
extern "C" int ucv_starts_f32(const float* data, const float* null_mask,
                              const long long* col_idx,
                              const long long* tr_idx, const float* tr_mask,
                              float* X, float* valid, float* Ns,
                              double* starts, float* ok, int n, int D, int F,
                              int K, int ntr, int d, int split,
                              void* stream) {
  const long long G = static_cast<long long>(F) * K;
  if (F < 1 || K < 1 || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) != 0 || G * split >= (1LL << 31) || d < 1 ||
      d > kMaxD || n < 0 || D < 0 || ntr < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WhitenArgs a{};
  a.data = data;
  a.null_mask = null_mask;
  a.col_idx = col_idx;
  a.tr_idx = tr_idx;
  a.tr_mask = tr_mask;
  a.n = n;
  a.D = D;
  a.K = K;
  a.ntr = ntr;
  a.split = split;
  const StartsOut o{X, valid, Ns, starts, ok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(G);
  switch (d) {
#define STARTS_CASE(DP) \
  case DP:              \
    return static_cast<int>(launch_starts<DP>(a, o, g, s));
    STARTS_CASE(1)
    STARTS_CASE(2)
    STARTS_CASE(3)
    STARTS_CASE(4)
    STARTS_CASE(5)
    STARTS_CASE(6)
    STARTS_CASE(7)
    STARTS_CASE(8)
    STARTS_CASE(9)
    STARTS_CASE(10)
    STARTS_CASE(11)
    STARTS_CASE(12)
    STARTS_CASE(13)
    STARTS_CASE(14)
    STARTS_CASE(15)
    STARTS_CASE(16)
#undef STARTS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches on `stream` without synchronising; returns the launch's CUDA
// error code. rows and wte (F, K, nte) float32, lndiff (F, K) float64, ok
// (F, K) float32, out (F,) float32; 1 <= F, K >= 1, nte >= 0, and the
// launch plan: `split` S in 1 .. min(K, 8), the blocks of each family's
// cluster, with F * S < 2^31; anything else returns cudaErrorInvalidValue.
// The result is the same bits at every S.
extern "C" int ckde_cv_fold_reduce_f32(const float* rows, const float* wte,
                                       const double* lndiff, const float* ok,
                                       float* out, int F, int K, int nte,
                                       int split, void* stream) {
  if (F < 1 || K < 1 || nte < 0 || split < 1 || split > kMaxSplit ||
      split > K || static_cast<long long>(F) * split >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int folds = (K + split - 1) / split;  // of rank 0
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (folds < kMaxFolds ? folds : kMaxFolds) {
#define REDUCE_CASE(NF) \
  case NF:              \
    return static_cast<int>(                                              \
        launch_reduce<NF>(rows, wte, lndiff, ok, out, F, K, nte, split, s));
    REDUCE_CASE(1)
    REDUCE_CASE(2)
    REDUCE_CASE(3)
    REDUCE_CASE(4)
    REDUCE_CASE(5)
    REDUCE_CASE(6)
    REDUCE_CASE(7)
    REDUCE_CASE(8)
    REDUCE_CASE(9)
    REDUCE_CASE(10)
    REDUCE_CASE(11)
    REDUCE_CASE(12)
    REDUCE_CASE(13)
    REDUCE_CASE(14)
    REDUCE_CASE(15)
    REDUCE_CASE(16)
    REDUCE_CASE(17)
    REDUCE_CASE(18)
#undef REDUCE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
