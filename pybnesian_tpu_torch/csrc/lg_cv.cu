// Linear-Gaussian (LG) family statistics for NVIDIA Hopper (sm_90a): the
// k-fold CV log-likelihood, the holdout log-likelihood, the Grams and the
// BIC of F candidate families in one launch.
//
// lg_cv_f32 computes what `batched_lg_cv_loglik` of
// pybnesian_tpu/ops/gaussian.py:118 computes (jitted XLA there, no Pallas
// kernel), and, with one fold and no test rows, what `family_grams` (:44)
// and `batched_bic` compute, for each (family f, fold k), W = P + 2 design
// columns [1, parents, y]:
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
// Bound: the sums are small; what costs is reading the rows. A family's
// folds share the frame (the fold masks are dense (K, n)), and a row's
// sector holds every column of it, so a kernel that reads the rows once per
// (family, fold) moves K times the bytes of one that reads them once per
// family: at `hc`'s one-parent batch (56 families, 10 folds, 8,000 rows of
// 8 columns) 560 x 8,000 x 2 x 64 bytes, L2-bound. PERF.md has the
// measured time against the bound of the FP64 operations and of each input
// byte read once.
//
// Design:
//
// - A program is a family and a chunk of its folds (at most fold_chunk(K,
//   W) of them, as many as keep its sums within kMaxPairs; the wrapper's
//   plan takes fewer for a small batch, to have more programs), so a row is
//   read once for all the chunk's folds: its design columns and validity,
//   and each fold's mask.
// - Fixed leaves. The train rows fall into leaf_count(n_tr) leaves
//   (common.cuh: a power of two up to kMaxLeaves, each at least kLeafRows
//   rows when there are two or more): leaf l holds rows [l * size, (l + 1)
//   * size), size = ceil(n_tr / leaves). Within a leaf thread t sums rows
//   lo + t, lo + t + 256, ... in order in float64 registers, the block's
//   partial sums merge in a fixed tree (a warp's shuffles, then the 8 warps
//   in order), and the leaves' sums merge in a balanced binary tree. Each
//   (fold, Gram entry) is a sum of its own, formed by the same explicit
//   float64 operations (w = mask * validity, w d_i, then one fma with d_j),
//   grouped 36 at a time (one sweep of the rows each) to bound the
//   registers. The test rows' sums take the same leaves of n_te. No
//   atomics; nothing depends on G, on the chunk, on the program's place in
//   the grid or on the launch. The fold sum is a second kernel, one thread
//   per family adding its K folds in order.
// - A thread-block cluster per program. The wrapper chooses its size S (a
//   power of two up to the portable 8) from the program count and the SM
//   count; cluster rank q sweeps leaves [q L / S, (q + 1) L / S), an
//   aligned subtree of the tree, which it merges itself in the tree's
//   order; after a cluster barrier every rank reads the ranks' subtree
//   sums through distributed shared memory and merges the tree's top. So
//   every rank holds the same Grams and runs the same solves, one thread a
//   fold, and the test rows are split over the ranks the same way. S
//   decides only which block sweeps which leaf.
// - Rows staged in shared memory with cp.async, one pipeline across a
//   rank's leaves with up to 4 rows in flight per thread (stages_for; each
//   thread reads only the rows it staged): the family's W - 1 data columns
//   and the chunk's fold masks as float32, then the row's validity product
//   in float64. Where the sums take more than one sweep and a rank's rows
//   fit in kResidentBytes, they stay staged for every sweep; otherwise each
//   sweep gathers them again.
// - A family padded to the batch's widest family adds only exact zeros to
//   its own Gram entries, so it gets the bits it gets alone. Parents are
//   packed first, so the padded columns come last in the Cholesky, the
//   solve, the residual sum and the test rows' means, where they add exact
//   zeros.
// - Every row counts, multiplied by its fold's mask, as in the plain
//   version (a NaN in a row outside the fold still reaches the sums).
// - The solve of each fold runs by one thread in shared memory, in one
//   function of the runtime width whose every operation is an explicitly
//   rounded float64 intrinsic (or log), so every width gives it the same
//   bits. A pivot that is not positive, or a factor entry that is not
//   finite, makes beta NaN, as the plain version's cholesky_or_nan does
//   (variance NaN, or +inf when underdetermined).
// - The kernel is templated on W up to 18 (P <= 16), so that the compiler
//   knows the width; wider families (up to W 64) take its runtime-width
//   instance, with one row in flight per thread. Both form every sum the
//   same way, so a family alone and padded into a wider batch gives the
//   same bits whichever instance runs.
// - An out-of-range column index reads NaN; nothing is read out of bounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 36;        // values of one block sum
constexpr int kMaxTemplated = 18;   // widest W of the templated instances
constexpr int kMaxW = 64;           // widest W: 62 parents
constexpr int kFoldThreads = 256;   // threads of the fold-sum kernel
constexpr int kDepth = 4;           // levels of a rank's subtree merge
constexpr int kMaxChunk = 16;       // most folds of a program
constexpr int kMaxPairs = 360;      // most (fold, Gram entry) sums of one
constexpr int kResidentBytes = 160 * 1024;  // most shared memory a rank's
                                            // staged rows may take
constexpr double kLog2Pi = 1.8378770664093454835606594728112;  // log(2 pi)
constexpr double kMachineTol = 2.220446049250313e-16 * 4;

// Rows a thread has in flight while gathering: fewer for wider rows, whose
// slots take more shared memory.
__host__ __device__ constexpr int stages_for(int WT) {
  return WT == 0 ? 1 : (WT <= 8 ? 4 : 2);
}

// Most folds of one program: as many of K as keep its (fold, entry) sums
// within kMaxPairs, at most kMaxChunk, at least one.
__host__ __device__ __forceinline__ int fold_chunk(int K, int W) {
  const int E = W * (W + 1) / 2;
  int chunk = kMaxPairs / E;
  chunk = chunk < kMaxChunk ? chunk : kMaxChunk;
  chunk = chunk < K ? chunk : K;
  return chunk > 1 ? chunk : 1;
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
  double* gram;                  // (F * K, W, W)
  double* bic;                   // (F * K,)
  double* fold_ll;               // (F * K,), with a test stage
  int split;                     // S, blocks of a program's cluster
  int chunk;                     // folds of a program: fold_chunk(K, W)
  int cap;                       // rows the stage holds
  int resident;                  // 1: a rank's train rows stay staged
};

// The family's design columns, shared by the block: column c's data column
// (c >= 1; -1 when out of range) and its mask (1 for the intercept and y).
struct Family {
  long long col[kMaxW];
  double cm[kMaxW];
  double k;  // parents
};

// One fold's results of the solve, shared by the block.
struct Fit {
  double beta[kMaxW];
  double variance;
  double inv_variance;  // 1 / variance
  double half_log_var;  // log(variance) / 2
  bool bad;             // variance < 4 eps or not finite
};

// The rows a block has staged, in its dynamic shared memory (after the
// chunk's Grams and the rank's subtree sums).
struct Stage {
  double* w;   // [cap] the rows' validity products
  float* v;    // [W - 1][cap] design columns 1 .. W - 1 of the rows
  float* mk;   // [chunk][cap] the chunk's fold masks of the rows
  float* vl;   // [stages][W - 1][kThreads] validity of the rows in flight
  int cap;
};

// Bytes of the dynamic shared memory: the chunk's Grams, the subtree sums
// and a Stage of `cap` rows.
__host__ __device__ __forceinline__ size_t dynamic_bytes(int W, int chunk,
                                                         int stages,
                                                         int cap) {
  const size_t E = static_cast<size_t>(W) * (W + 1) / 2;
  return 8 * (static_cast<size_t>(chunk) * (W * W + E) + cap) +
         4 * static_cast<size_t>(W - 1 + chunk) * cap +
         4 * static_cast<size_t>(stages) * (W - 1) * kThreads;
}

// Adds the i-th leaf sum v (i counted from the rank's first leaf) of value
// e to the rank's subtree in the tree's order, a binary counter: leaf sums
// pair as ((v0 v1) (v2 v3)) .... After all of a rank's leaves (a power of
// two of them) stack[0][e] holds its subtree's sum.
__device__ __forceinline__ void push_leaf(double (*stack)[kMaxSums], int i,
                                          int e, double v) {
  int depth = __popc(i);
  stack[depth][e] = v;
  ++depth;
  for (int c = i + 1; c % 2 == 0; c /= 2) {
    stack[depth - 2][e] = __dadd_rn(stack[depth - 2][e], stack[depth - 1][e]);
    --depth;
  }
}

// Value e of the program summed over the ranks' subtree sums in the top of
// the balanced tree: part i (of min(split, leaves)) is part[e] in cluster
// rank leaf_owner(i, parts, split).
__device__ __forceinline__ double merge_parts(const double* part, int e,
                                              int leaves, int split) {
  const int parts = split < leaves ? split : leaves;
  double v[kMaxLeaves];
#pragma unroll
  for (int i = 0; i < kMaxLeaves; ++i) {
    v[i] = 0.0;
    if (i < parts) {
      const int owner = leaf_owner(i, parts, split);
      const double* base =
          split > 1 ? cg::this_cluster().map_shared_rank(part, owner) : part;
      v[i] = base[e];
    }
  }
#pragma unroll
  for (int w = 1; w < kMaxLeaves; w *= 2) {
#pragma unroll
    for (int b = 0; b + w < kMaxLeaves; b += 2 * w) {
      if (b + w < parts) v[b] = __dadd_rn(v[b], v[b + w]);
    }
  }
  return v[0];
}

// (i, j), j <= i, of entry p of a lower triangle in row-major order.
__device__ __forceinline__ void tri(int p, int& i, int& j) {
  i = static_cast<int>((sqrt(8.0 * p + 1.0) - 1.0) / 2.0);
  while (i * (i + 1) / 2 > p) --i;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  j = p - i * (i + 1) / 2;
}

// The rows of leaves [l0, l1) of n rows: leaf l holds [l * size, min(n,
// (l + 1) * size)).
struct Leaves {
  int n, size, l0, l1;
};

// Where a walk is: leaf `leaf`, step j of its `steps` (thread t's row lo +
// t + j kThreads of [lo, hi)); an empty leaf takes one step with no row.
struct Cursor {
  int leaf, j, lo, hi, steps;
  __device__ __forceinline__ void start(const Leaves& L, int l) {
    leaf = l;
    j = 0;
    lo = l < L.l1 ? min(L.n, l * L.size) : 0;
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

// Design value c (0 <= c < W) of the row at stage position p.
__device__ __forceinline__ double design(const Stage& st, const Family& fam,
                                         int p, int c) {
  return c == 0 ? 1.0 : __dmul_rn(st.v[(c - 1) * st.cap + p], fam.cm[c]);
}

// Walks the rows of leaves [L.l0, L.l1) of a frame in order, thread t its
// rows lo + t, lo + t + kThreads, ... of each leaf, in steps that every
// thread takes: at each step it calls use(c, active, p), c the cursor
// (c.last() at a leaf's last step), active: the thread has a row, p the
// row's stage position, where st.w[p] holds valid(y) x the validity of
// every unmasked parent (NaN for an out-of-range column) and st.mk[k *
// cap + p] fold k's mask (folds k0 .. k0 + kc - 1 of `mask`; 1 without
// one). With `gather` the rows come from the frame by cp.async in one
// pipeline across the leaves, STAGES rows in flight per thread, to the
// stage at r - base (base >= 0: the rank's resident rows) or at the row's
// slot (base < 0); without, they are read from the resident stage. A
// thread reads only the rows it staged itself.
template <int WT, int STAGES, class Use>
__device__ __forceinline__ void walk_rows(const Family& fam, const Stage& st,
                                          int W, const float* values,
                                          const float* valid, int D,
                                          const float* mask, int n, int k0,
                                          int kc, const Leaves& L, int base,
                                          bool gather, Use&& use) {
  const int t = threadIdx.x;
  const int Q = WT > 0 ? WT - 1 : W - 1;
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
      use(u, active, active ? u.row() - base : 0);
    }
    return;
  }
  auto fetch = [&](const Cursor& c, int s) {
    if (c.live()) {
      const int r = c.row();
      const int slot = s % STAGES;
      const int p = base >= 0 ? r - base : slot * kThreads + t;
      float* vl = st.vl + slot * Q * kThreads + t;
#pragma unroll
      for (int c2 = 1; c2 <= Q; ++c2) {
        const long long ci = fam.col[c2];
        if (ci >= 0) {
          const size_t cell = static_cast<size_t>(r) * D + ci;
          cp_async4(st.v + (c2 - 1) * st.cap + p, values + cell);
          cp_async4(vl + (c2 - 1) * kThreads, valid + cell);
        } else {
          st.v[(c2 - 1) * st.cap + p] = qnanf();
          vl[(c2 - 1) * kThreads] = qnanf();
        }
      }
      for (int k = 0; k < kc; ++k) {
        float* m = st.mk + k * st.cap + p;
        if (mask != nullptr) {
          cp_async4(m, mask + static_cast<size_t>(k0 + k) * n + r);
        } else {
          *m = 1.0f;
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  Cursor c = u;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    fetch(c, k);
    c.next(L);
  }
  for (int s = 0; s < total; ++s) {
    fetch(c, s + STAGES - 1);
    c.next(L);
    cp_async_wait<STAGES - 1>();  // step s has landed
    const bool active = u.live();
    int p = 0;
    if (active) {
      const int slot = s % STAGES;
      p = base >= 0 ? u.row() - base : slot * kThreads + t;
      const float* vl = st.vl + slot * Q * kThreads + t;
      double wv = vl[(Q - 1) * kThreads];  // y
#pragma unroll
      for (int c2 = 1; c2 < Q; ++c2) {
        if (fam.cm[c2] > 0.0) {
          wv = __dmul_rn(wv, static_cast<double>(vl[(c2 - 1) * kThreads]));
        }
      }
      st.w[p] = wv;
    }
    use(u, active, p);
    u.next(L);
  }
  cp_async_wait<0>();
}

// One test row's weighted log-likelihood term, from its mean: the squared
// residual times the fold's reciprocal variance (within an ulp of the
// plain version's quotient; +inf and 0 variances give its infinities and
// NaNs).
__device__ __forceinline__ double ll_term(double y, double mean, double w,
                                          const Fit& fit, double acc) {
  const double r = __dsub_rn(y, mean);
  const double ll = __dsub_rn(
      __dsub_rn(__dmul_rn(__dmul_rn(-0.5, __dmul_rn(r, r)), fit.inv_variance),
                fit.half_log_var),
      0.5 * kLog2Pi);
  return __fma_rn(w, ll, acc);
}

// lg_params_from_gram and the BIC by one thread: g is the (W, W) Gram in
// shared memory (its top-left (W - 1) block is overwritten by the Cholesky
// factor; column W - 1 is kept), cm the design columns' masks. Fills fit
// and returns the BIC. W is the runtime width in every kernel.
__device__ __forceinline__ double solve(double* g, int W, const double* cm,
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
  fit.inv_variance = __drcp_rn(var);
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

// Stage 1 of a templated width W: per leaf of the rank, each fold's Gram
// entries over the train rows, a row's design in registers and its fold
// weight formed once. A sweep of the rank's rows takes kMaxSums / E folds'
// whole Grams (E <= kMaxSums), or one fold's entries 36 at a time; every
// accumulator's fold offset and entry are known at compile time.
template <int W>
__device__ __forceinline__ void gram_fixed(const LgArgs& a, const Family& fam,
                                           const Stage& st,
                                           const Leaves& train, int base,
                                           int k0, int kc, double* s_part,
                                           double (*s_red)[kMaxSums],
                                           double* s_sum,
                                           double (*s_stack)[kMaxSums]) {
  constexpr int E = W * (W + 1) / 2;
  constexpr int FPS = E <= kMaxSums ? kMaxSums / E : 1;  // folds a sweep
  constexpr int CE = E <= kMaxSums ? E : kMaxSums;  // entries a fold a sweep
  constexpr int C = FPS * CE;
  for (int kk0 = 0; kk0 < kc; kk0 += FPS) {
#pragma unroll
    for (int p0 = 0; p0 < E; p0 += CE) {
      double acc[C];
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = 0.0;
      walk_rows<W, stages_for(W)>(
          fam, st, W, a.tr_values, a.tr_valid, a.D, a.tr_mask, a.n_tr, k0,
          kc, train, base, !(a.resident && (kk0 > 0 || p0 > 0)),
          [&](const Cursor& c, bool active, int p) {
            if (active) {
              const double wv = st.w[p];
              double d[W];
#pragma unroll
              for (int q = 0; q < W; ++q) d[q] = design(st, fam, p, q);
#pragma unroll
              for (int f2 = 0; f2 < FPS; ++f2) {
                if (kk0 + f2 < kc) {
                  const double w =
                      __dmul_rn(st.mk[(kk0 + f2) * st.cap + p], wv);
#pragma unroll
                  for (int i = 0; i < W; ++i) {
                    const double wd = __dmul_rn(w, d[i]);
#pragma unroll
                    for (int j = 0; j <= i; ++j) {
                      const int e = i * (i + 1) / 2 + j;
                      if (e >= p0 && e < p0 + CE) {
                        acc[f2 * CE + e - p0] =
                            __fma_rn(wd, d[j], acc[f2 * CE + e - p0]);
                      }
                    }
                  }
                }
              }
            }
            if (c.last()) {
              block_sum<kWarps>(acc, s_red, s_sum);
              if (threadIdx.x < C) {
                push_leaf(s_stack, c.leaf - train.l0, threadIdx.x,
                          s_sum[threadIdx.x]);
              }
#pragma unroll
              for (int e = 0; e < C; ++e) acc[e] = 0.0;
            }
          });
      const int a2 = threadIdx.x;
      if (a2 < C && kk0 + a2 / CE < kc && p0 + a2 % CE < E &&
          train.l1 > train.l0) {
        s_part[(kk0 + a2 / CE) * E + p0 + a2 % CE] = s_stack[0][a2];
      }
    }
  }
}

// Stage 1 of a runtime width W: the same sums, (fold, entry) pairs 36 to a
// sweep, each design value read from the stage where a term needs it;
// s_pq holds the sweep's (fold, i, j).
__device__ __forceinline__ void gram_runtime(
    const LgArgs& a, const Family& fam, const Stage& st, int W,
    const Leaves& train, int base, int k0, int kc, double* s_part,
    double (*s_red)[kMaxSums], double* s_sum, double (*s_stack)[kMaxSums],
    int (*s_pq)[3]) {
  const int E = W * (W + 1) / 2;
  const int pairs = kc * E;
  for (int q0 = 0; q0 < pairs; q0 += kMaxSums) {
    const int C = min(kMaxSums, pairs - q0);
    __syncthreads();  // the last sweep's s_pq is read
    if (threadIdx.x < kMaxSums) {
      int k = 0, i = 0, j = 0;
      if (static_cast<int>(threadIdx.x) < C) {
        const int q = q0 + threadIdx.x;
        k = q / E;
        tri(q % E, i, j);
      }
      s_pq[threadIdx.x][0] = k;
      s_pq[threadIdx.x][1] = i;
      s_pq[threadIdx.x][2] = j;
    }
    __syncthreads();
    double acc[kMaxSums];
#pragma unroll
    for (int e = 0; e < kMaxSums; ++e) acc[e] = 0.0;
    walk_rows<0, stages_for(0)>(
        fam, st, W, a.tr_values, a.tr_valid, a.D, a.tr_mask, a.n_tr, k0, kc,
        train, base, !(a.resident && q0 > 0),
        [&](const Cursor& c, bool active, int p) {
          if (active) {
            const double wv = st.w[p];
#pragma unroll
            for (int e = 0; e < kMaxSums; ++e) {
              if (e < C) {
                const double w = __dmul_rn(st.mk[s_pq[e][0] * st.cap + p],
                                           wv);
                const double wd = __dmul_rn(w, design(st, fam, p,
                                                      s_pq[e][1]));
                acc[e] = __fma_rn(wd, design(st, fam, p, s_pq[e][2]),
                                  acc[e]);
              }
            }
          }
          if (c.last()) {
            block_sum<kWarps>(acc, s_red, s_sum);
            if (static_cast<int>(threadIdx.x) < C) {
              push_leaf(s_stack, c.leaf - train.l0, threadIdx.x,
                        s_sum[threadIdx.x]);
            }
#pragma unroll
            for (int e = 0; e < kMaxSums; ++e) acc[e] = 0.0;
          }
        });
    if (static_cast<int>(threadIdx.x) < C && train.l1 > train.l0) {
      s_part[q0 + threadIdx.x] = s_stack[0][threadIdx.x];
    }
  }
}

// Grid (programs) * split, clusters of `split` blocks along x: program =
// blockIdx.x / split (family f = program / chunks, folds k0 .. k0 + kc -
// 1), cluster rank blockIdx.x % split. WT > 0: the templated width W = WT;
// WT == 0: the runtime width W = P + 2.
template <int WT>
__global__ void __launch_bounds__(kThreads) lg_kernel(const LgArgs a) {
  constexpr int kStages = stages_for(WT);
  __shared__ double s_red[kWarps][kMaxSums];
  __shared__ double s_sum[kMaxSums];
  __shared__ double s_stack[kDepth][kMaxSums];  // a rank's subtree merge
  __shared__ double s_tpart[kMaxChunk];         // its test rows' sums
  __shared__ int s_pq[kMaxSums][3];             // a sweep's (fold, i, j)
  __shared__ Family fam;
  __shared__ Fit s_fit[kMaxChunk];
  extern __shared__ __align__(16) unsigned char s_dyn[];

  const int W = WT > 0 ? WT : a.P + 2;
  const int Q = W - 1;
  const int E = W * (W + 1) / 2;
  const int split = a.split;
  const int chunks = (a.K + a.chunk - 1) / a.chunk;
  const int program = blockIdx.x / split, rank = blockIdx.x % split;
  const int f = program / chunks;
  const int k0 = (program % chunks) * a.chunk;
  const int kc = min(a.chunk, a.K - k0);
  const int pairs = kc * E;
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
  double* s_gram = reinterpret_cast<double*>(s_dyn);  // [kc][W * W]
  double* s_part = s_gram + kc * W * W;              // [kc * E] subtree sums
  Stage st;
  st.cap = a.cap;
  st.w = s_part + pairs;
  st.v = reinterpret_cast<float*>(st.w + a.cap);
  st.mk = st.v + Q * a.cap;
  st.vl = st.mk + a.chunk * a.cap;

  // stage 1: the chunk's Grams over the train rows, the rank's leaves, 36
  // (fold, entry) sums per sweep
  const int leaves = leaf_count(a.n_tr);
  const int size = (a.n_tr + leaves - 1) / leaves;
  const Leaves train{a.n_tr, size, first_leaf(rank, leaves, split),
                     first_leaf(rank + 1, leaves, split)};
  const int base = a.resident ? min(a.n_tr, train.l0 * size) : -1;
  if constexpr (WT > 0) {
    gram_fixed<WT>(a, fam, st, train, base, k0, kc, s_part, s_red, s_sum,
                   s_stack);
  } else {
    gram_runtime(a, fam, st, W, train, base, k0, kc, s_part, s_red, s_sum,
                 s_stack, s_pq);
  }
  cluster_sync(split);  // every rank's subtree sums are in place
  for (int q = threadIdx.x; q < pairs; q += kThreads) {
    int i, j;
    tri(q % E, i, j);
    const double v = merge_parts(s_part, q, leaves, split);
    double* gk = s_gram + (q / E) * W * W;
    gk[i * W + j] = v;
    gk[j * W + i] = v;
  }
  __syncthreads();
  const size_t g0 = static_cast<size_t>(f) * a.K + k0;  // the first program
  if (rank == 0) {
    for (int e = threadIdx.x; e < kc * W * W; e += kThreads) {
      a.gram[g0 * W * W + e] = s_gram[e];
    }
  }
  __syncthreads();  // s_gram is written out before the solves overwrite it

  // stage 2: the solves, one thread a fold, on every rank
  if (threadIdx.x < kc) {
    const int k = threadIdx.x;
    const double bic = solve(s_gram + k * W * W, a.P + 2, fam.cm, fam.k,
                             s_fit[k]);
    if (rank == 0) a.bic[g0 + k] = bic;
  }
  __syncthreads();

  if (a.te_values != nullptr) {
    // stage 3: each fold's weighted test log-likelihood, the rank's leaves
    // of the test rows, staged in the slots (the resident train rows are
    // read)
    const int te_leaves = leaf_count(a.n_te);
    const Leaves test{a.n_te, (a.n_te + te_leaves - 1) / te_leaves,
                      first_leaf(rank, te_leaves, split),
                      first_leaf(rank + 1, te_leaves, split)};
    double acc[kMaxChunk];
#pragma unroll
    for (int k = 0; k < kMaxChunk; ++k) acc[k] = 0.0;
    walk_rows<WT, kStages>(
        fam, st, W, a.te_values, a.te_valid, a.D, a.te_mask, a.n_te, k0, kc,
        test, -1, true, [&](const Cursor& c, bool active, int p) {
          if (active) {
            const double wv = st.w[p];
            // the row's design once for every fold (in registers at a
            // templated width)
            double d[WT > 0 ? WT : 1];
            if constexpr (WT > 0) {
#pragma unroll
              for (int q = 0; q < WT; ++q) d[q] = design(st, fam, p, q);
            }
            const double y = WT > 0 ? d[WT > 0 ? WT - 1 : 0]
                                    : design(st, fam, p, Q);
#pragma unroll
            for (int k = 0; k < kMaxChunk; ++k) {
              if (k < kc) {
                const Fit& fit = s_fit[k];
                double mean = 0.0;
                if constexpr (WT > 0) {
#pragma unroll
                  for (int q = 0; q < WT - 1; ++q) {
                    mean = __fma_rn(d[q], fit.beta[q], mean);
                  }
                } else {
                  for (int q = 0; q < Q; ++q) {
                    mean = __fma_rn(design(st, fam, p, q), fit.beta[q],
                                    mean);
                  }
                }
                const double w = __dmul_rn(st.mk[k * st.cap + p], wv);
                acc[k] = ll_term(y, mean, w, fit, acc[k]);
              }
            }
          }
          if (c.last()) {
            block_sum<kWarps>(acc, s_red, s_sum);
            if (static_cast<int>(threadIdx.x) < kc) {
              push_leaf(s_stack, c.leaf - test.l0, threadIdx.x,
                        s_sum[threadIdx.x]);
            }
#pragma unroll
            for (int k = 0; k < kMaxChunk; ++k) acc[k] = 0.0;
          }
        });
    if (static_cast<int>(threadIdx.x) < kc && test.l1 > test.l0) {
      s_tpart[threadIdx.x] = s_stack[0][threadIdx.x];
    }
    cluster_sync(split);  // the Gram sums are read; the test sums in place
    if (rank == 0 && static_cast<int>(threadIdx.x) < kc) {
      const int k = threadIdx.x;
      const double ll = merge_parts(s_tpart, k, te_leaves, split);
      a.fold_ll[g0 + k] =
          s_fit[k].bad ? -__longlong_as_double(0x7ff0000000000000LL) : ll;
    }
  }
  if (split > 1) {
    cluster_arrive();  // done reading the cluster's sums
    cluster_wait();    // no block leaves while another reads it
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

// The stage of a launch of width W: a rank's train rows resident when the
// sums sweep them more than once and they fit in kResidentBytes (at most
// ceil(leaves / split) leaves of `size` rows, and room for the test rows'
// slots), else the slots alone.
template <int WT>
void plan_stage(LgArgs& a, int W) {
  constexpr int stages = stages_for(WT);
  const int leaves = leaf_count(a.n_tr);
  const int size = (a.n_tr + leaves - 1) / leaves;
  const int rows = (leaves + a.split - 1) / a.split * size;
  const int slots = stages * kThreads;
  const int cap = ((rows > slots ? rows : slots) + 3) / 4 * 4;
  const int pairs = a.chunk * W * (W + 1) / 2;
  a.resident = pairs > kMaxSums &&
                       dynamic_bytes(W, a.chunk, stages, cap) <= kResidentBytes
                   ? 1
                   : 0;
  a.cap = a.resident ? cap : slots;
}

template <int WT>
cudaError_t launch_lg(LgArgs a, int programs, int W, cudaStream_t s) {
  plan_stage<WT>(a, W);
  const size_t bytes = dynamic_bytes(W, a.chunk, stages_for(WT), a.cap);
  const cudaError_t set = cudaFuncSetAttribute(
      lg_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(programs * a.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lg_kernel<WT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_width(const LgArgs& a, int programs, int W,
                         cudaStream_t s) {
  if (W > kMaxTemplated) return launch_lg<0>(a, programs, W, s);
  switch (W) {
#define LG_CASE(WT) \
  case WT:          \
    return launch_lg<WT>(a, programs, W, s);
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
      return launch_lg<0>(a, programs, W, s);
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
// F, K >= 1 with F * K * split < 2^31, 0 <= P <= lg_cv_max_width() - 2,
// n_tr, n_te, D >= 0; the launch plan: `chunk`, the folds of a program (a
// family and up to `chunk` of its folds), 1 <= chunk <= fold_chunk(K, P +
// 2), and `split` S, a power of two up to 8, blocks of a cluster sharing
// each program's leaves; anything else returns cudaErrorInvalidValue.
extern "C" int lg_cv_f32(const float* tr_values, const float* tr_valid,
                         const float* tr_mask, const float* te_values,
                         const float* te_valid, const float* te_mask,
                         const long long* var_idx,
                         const long long* parent_idx,
                         const float* parent_mask, double* gram, double* bic,
                         double* fold_ll, float* out, int n_tr, int n_te,
                         int D, int F, int K, int P, int chunk,
                         int split, void* stream) {
  const long long G = static_cast<long long>(F) * K;
  const bool test = te_values != nullptr;
  if (F < 1 || K < 1 || P < 0 || P + 2 > kMaxW || chunk < 1 ||
      chunk > fold_chunk(K, P + 2) || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) != 0 || G * split >= (1LL << 31) || P < 0 ||
      P + 2 > kMaxW || n_tr < 0 || n_te < 0 || D < 0 ||
      (tr_mask == nullptr && K != 1) ||
      (test && (te_valid == nullptr || fold_ll == nullptr || out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = P + 2;
  const LgArgs a{tr_values, tr_valid,   tr_mask,     te_values, te_valid,
                 te_mask,   var_idx,    parent_idx,  parent_mask, n_tr,
                 n_te,      D,          K,           P,         gram,
                 bic,       fold_ll,    split,       chunk,     0,
                 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int programs = F * ((K + chunk - 1) / chunk);
  const cudaError_t err = launch_width(a, programs, W, s);
  if (err != cudaSuccess || !test) return static_cast<int>(err);
  fold_sum_kernel<<<(F + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0,
                    s>>>(fold_ll, out, F, K);
  return static_cast<int>(cudaGetLastError());
}
