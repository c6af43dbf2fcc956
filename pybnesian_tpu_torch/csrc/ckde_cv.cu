// Streaming logsumexp kernels of Gaussian kernel density estimation (KDE)
// for NVIDIA Hopper (sm_90a): the joint-and-marginal pairs kernel of
// cross-validated conditional KDE (CV-CKDE) and the joint-only KDE kernel.
//
// 1. ckde_cv_pairs_f32 replaces the Pallas TPU kernel `_ckde_cv_kernel` in
// pybnesian_tpu/ops/pallas_kde.py (launched by `pallas_ckde_cv_pairs`). It
// computes what that kernel computes, not how: the TPU kernel built an
// augmented MXU matmul and put the train rows in lanes, both TPU artefacts.
//
// For program g (one (family, fold) pair) and test row i:
//
//   out[g, i] = LSE_j(lj) - (no_ev[g] ? lm_const[g] : LSE_j(lm))
//   lj = -1/2 * sum_k (te[i,k] - tr[j,k])^2 + neg[j]
//   lm = lj + 1/2 * (zte[i] - ztr[j])^2
//
// LSE is logsumexp over the program's ntr train rows; neg is 0 or -inf
// (padding and null rows). No nte x ntr matrix is ever stored.
//
// 2. kde_logl_f32 replaces the Pallas TPU kernel `_kde_kernel` in the same
// file (launched by `pallas_kde_logl`): per program g and test row i,
//
//   out[g, i] = LSE_j(-1/2 * sum_k (te[i,k] - tr[j,k])^2 over valid j)
//               + lognorm[g]
//
// with one exp per pair and no marginal. Programs share the launch: one
// fitted KDE is one program; a CKDE factor's joint and its marginal (its
// columns zero-padded to the joint's width, which adds nothing to a
// distance) are two.
//
// Bound: the exponentials, one SFU `ex2` each (16 per clock per SM), then
// the FP32 pipe: 13 instructions per pair at dpad 3 with the marginal, 8
// without. Bytes are no limit: each train row is read from device memory
// once per test tile and reused by 128 * R test rows. PERF.md has the
// measured times against that bound.
//
// Design, for d <= 16 (both kernels share one template):
//
// - Log2 domain with one MUFU per exp. Coordinates are scaled by
//   sqrt(log2(e) / 2) as they are loaded, so that the distance sum is
//   already lj in log2 units; each exp is `ex2.approx.ftz.f32`, and a row's
//   result converts once at the end, ln2 * (m + log2(s)). lm_const and
//   lognorm stay in natural log.
// - Tile max-then-sum, taken lazily. A thread forms a group of T train
//   rows' values in registers relative to its running reference m, which
//   starts at 0 (every lj is <= 0) and seeds the distance sum, and adds
//   ex2 of each: one MUFU and one FADD per pair. Only when the group's sum
//   leaves [2^-20, 2^20] (the first group of far test rows, a much closer
//   train row, a NaN) does it take the group's max with fmaxf and move m
//   there, rescaling the sum. fmaxf drops a NaN, so m never holds one; a
//   NaN reaches the result through the sum. Invalid and padding train rows
//   are staged with coordinate 0 at 1e30 (unless it is NaN), so that their
//   distance is +inf and their exp 0 without a per-pair mask.
// - Register tiling. A thread holds R = 2 test rows. The block stages train
//   rows in shared memory column by column, so that one float4 load gives
//   one coordinate of 4 train rows, which serves 8 pairs, and every step of
//   a group's distances is 2 * T independent updates.
// - A fixed reduction tree. A program's train rows fall into P leaves, P a
//   power of two that depends on ntr alone (reduction_leaves); each leaf is
//   swept from a fresh (m, s) pair, and the P leaf pairs of a test row are
//   merged in a balanced binary tree. So the float32 result of a (program,
//   test row) is a function of its own inputs, ntr and d: not of G, of the
//   other programs, or of the launch plan.
// - The leaves split across a thread-block cluster. When the programs and
//   test tiles give too few blocks to fill the card, the launch plan
//   (chosen by the Python wrapper) spreads each program's leaves over S
//   blocks of one cluster. Each block sweeps its leaves for the same test
//   tile and keeps each leaf's (m, s) pairs in shared memory; the blocks
//   then merge the leaves through distributed shared memory in the tree's
//   order, each finishing 1/S of the tile's rows. S only decides which
//   block sweeps which leaf. No scratch buffer and no second launch.
//
// Wider KDE programs (d up to 256) take a runtime-width kernel with the
// same exps, invalid-row staging and lazy max-then-sum, over groups of 32:
// one test row per thread, no split, the test coordinates in dynamic
// shared memory.
//
// Distances are direct per-column FMAs: exact at the small distances that
// dominate the sums, with none of the cancellation of |a|^2 + |b|^2 - 2ab.
// Rows past ntr and nte are masked here, so callers need no padding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;      // threads per block
constexpr int kTile = 256;         // train rows per shared-memory tile
constexpr int kRowsPerThread = 2;  // R: test rows a thread holds
constexpr int kGroup = 16;         // T: train rows per group
constexpr int kWideGroup = 32;     // T of the runtime-width KDE kernel
constexpr int kMaxSplit = 8;       // portable cluster size
constexpr int kMinBlocks = 3;      // blocks per SM the register budget keeps
constexpr int kMaxTemplated = 16;  // widest program of the templated kernel
constexpr int kWideTile = 64;      // train rows per tile, runtime-width KDE
constexpr int kMaxWide = 256;      // widest runtime-width KDE program
constexpr float kInit = -1e30f;
constexpr float kHalfLog2e = 0.72134752044448170f;  // log2(e) / 2
constexpr float kScale = 0.84932180028801907f;      // sqrt(log2(e) / 2)
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kFar = 1e30f;        // coordinate 0 of an invalid train row
constexpr float kSumHi = 1048576.0f;  // 2^20: a group sum above moves m up
constexpr float kSumLo = 1.0f / kSumHi;  // a running sum below moves m down

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Adds a group of T values y = x - m, relative to the running reference m,
// to the running sum s (the pair stands for s * 2^m). While the group's sum
// stays in [kSumLo, kSumHi] the reference needs no max: one exp and one add
// per value. Otherwise (the first valid group, a much closer row, a NaN)
// the group is taken again by max-then-sum: the reference moves to the
// group's max and s is rescaled to it. fmaxf drops a NaN, so m never holds
// one; a NaN value reaches s through the sum.
template <int T>
__device__ __forceinline__ void lse_lazy(const float (&y)[T], float& m,
                                         float& s) {
  static_assert(T % 4 == 0, "T is a multiple of 4");
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < T; ++t) p[t % 4] += ex2(y[t]);
  const float acc = (p[0] + p[1]) + (p[2] + p[3]);
  if (acc <= kSumHi && s + acc >= kSumLo) {
    s += acc;
    return;
  }
  float gm = y[0];
#pragma unroll
  for (int t = 1; t < T; ++t) gm = fmaxf(gm, y[t]);
  if (!(gm > -INFINITY)) {  // nothing valid, or all NaN
    s += acc;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) p[q] = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) p[t % 4] += ex2(y[t] - gm);
  const float shifted = (p[0] + p[1]) + (p[2] + p[3]);
  s = s == 0.0f ? shifted : fmaf(s, ex2(-gm), shifted);
  m += gm;
}

// Merges the log2-domain pair (m2, s2) into (m, s). m never holds a NaN, so
// a NaN sum on either side reaches the result.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mx = fmaxf(m, m2);
  s = fmaf(s, ex2(m - mx), s2 * ex2(m2 - mx));
  m = mx;
}

// Natural-log logsumexp of a log2-domain pair.
__device__ __forceinline__ float lse_ln(float m, float s) {
  return kLn2 * (m + log2f(s));
}

struct PairsArgs {
  const float* tr;      // (G, ntr, D) train rows
  const float* neg;     // CV: (G, ntr) 0 or -inf; KDE: (G, ntr) > 0 valid
  const float* ztr;     // CV: (G, ntr) variable coordinate; KDE: unused
  const float* te;      // (G, nte, D) test rows
  const float* zte;     // CV: (G, nte); KDE: unused
  const float* no_ev;   // CV: (G,) > 0.5 for evidence-free; KDE: unused
  const float* offset;  // CV: lm_const (G,); KDE: lognorm (G,)
  float* out;           // (G, nte)
  int ntr, nte, split;
};

// Stages train rows [t0, t0 + rows) of program g column by column, scaled
// by kScale: s[k * kTile + r] holds coordinate k of row r for k < D, and
// ztr at k = D (CV). An invalid row (neg -inf, or valid <= 0) and a
// padding row in [rows, padded) get coordinate 0 = kFar, so that every
// distance to it is +inf and its exp 0, as neg -inf gives. A NaN
// coordinate 0 stays NaN, so that a NaN in any coordinate of an invalid
// row reaches the result, as -1/2 * NaN + -inf does in the plain version.
template <int D, bool kCv>
__device__ __forceinline__ void stage_tile(const PairsArgs& a, int g, int t0,
                                           int rows, int padded, float* s) {
  const size_t base = static_cast<size_t>(g) * a.ntr + t0;
  const float* tr = a.tr + base * D;
  // coalesced over the tile's contiguous (rows x D) slab
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, k = e % D;
    float v = kScale * tr[e];
    if (k == 0) {
      const float n = a.neg[base + r];
      if ((kCv ? n != 0.0f : !(n > 0.0f)) && !isnan(v)) v = kFar;
    }
    s[k * kTile + r] = v;
  }
  for (int r = rows + threadIdx.x; r < padded; r += kThreads) {
    s[r] = kFar;
#pragma unroll
    for (int k = 1; k < D; ++k) s[k * kTile + r] = 0.0f;
  }
  if constexpr (kCv) {
    for (int r = threadIdx.x; r < padded; r += kThreads) {
      s[D * kTile + r] = r < rows ? kScale * a.ztr[base + r] : 0.0f;
    }
  }
}

// Loads column values [j0, j0 + T) of one staged column, T / 4 vector loads
// each of which every thread of the block reads alike (a broadcast).
template <int T>
__device__ __forceinline__ void load_column(const float* col, int j0,
                                            float (&x)[T]) {
#pragma unroll
  for (int v = 0; v < T / 4; ++v) {
    const float4 q = reinterpret_cast<const float4*>(col + j0)[v];
    x[4 * v] = q.x;
    x[4 * v + 1] = q.y;
    x[4 * v + 2] = q.z;
    x[4 * v + 3] = q.w;
  }
}

// Sweeps `padded` staged rows (a whole number of groups) for R test rows
// (coordinates and zte scaled by kScale). A group's values are formed
// column by column, each step's R * T updates independent of one another:
// y = -m - sum_k (te_k - tr_k)^2 is the joint's lj in log2 units relative
// to its reference m, one FADD and one FFMA per column; the marginal adds
// (zte - ztr)^2 and the gap between the two references.
template <int D, int R, bool kMarg>
__device__ __forceinline__ void sweep_tile(const float* s, int padded,
                                           const float (&te)[R][D],
                                           const float (&zte)[R],
                                           float (&mj)[R], float (&sj)[R],
                                           float (&mm)[R], float (&sm)[R]) {
  constexpr int T = kGroup;
#pragma unroll 1
  for (int j0 = 0; j0 < padded; j0 += T) {
    float yj[R][T], x[T];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      load_column(s + k * kTile, j0, x);
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float df = te[r][k] - x[t];
          yj[r][t] = fmaf(-df, df, k == 0 ? -mj[r] : yj[r][t]);
        }
      }
    }
    if constexpr (kMarg) {
      float ym[R][T], gap[R];
      load_column(s + D * kTile, j0, x);  // ztr
#pragma unroll
      for (int r = 0; r < R; ++r) gap[r] = mj[r] - mm[r];
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float vd = zte[r] - x[t];
          ym[r][t] = fmaf(vd, vd, yj[r][t]) + gap[r];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lse_lazy(yj[r], mj[r], sj[r]);
        lse_lazy(ym[r], mm[r], sm[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) lse_lazy(yj[r], mj[r], sj[r]);
    }
  }
}

// Result of one test row of program g from its log2-domain pairs.
template <bool kCv>
__device__ __forceinline__ float finish(const PairsArgs& a, int g, bool marg,
                                        float mj, float sj, float mm,
                                        float sm) {
  const float lse_j = lse_ln(mj, sj);
  if constexpr (kCv) {
    return lse_j - (marg ? lse_ln(mm, sm) : a.offset[g]);
  } else {
    return lse_j + a.offset[g];
  }
}

// Leaves of a program's train rows for the templated widths: the largest
// power of two up to kMaxSplit that leaves each leaf a full tile, 1 below
// two tiles. Leaf q holds rows [q * size, min(ntr, (q + 1) * size)) for
// size = ceil(ntr / leaves). A function of ntr alone, so that a test row's
// reduction tree is the same in every launch.
__host__ __device__ __forceinline__ int reduction_leaves(int ntr) {
  int leaves = 1;
  while (2 * leaves <= kMaxSplit && 2 * leaves * kTile <= ntr) leaves *= 2;
  return leaves;
}

// The first leaf of cluster rank q of `split`: rank q sweeps leaves
// [first_leaf(q), first_leaf(q + 1)), none when split exceeds the leaves.
__device__ __forceinline__ int first_leaf(int q, int leaves, int split) {
  return q * leaves / split;
}

// Merges the P leaf pairs v[0..P) of one test row in a balanced binary
// tree, into v[0]: ((v0 v1) (v2 v3)) ((v4 v5) (v6 v7)). P is a power of
// two up to kMaxSplit; the marginal's pairs only when `marg`.
__device__ __forceinline__ void merge_tree(float4 (&v)[kMaxSplit], int P,
                                           bool marg) {
#pragma unroll
  for (int w = 1; w < kMaxSplit; w *= 2) {
#pragma unroll
    for (int b = 0; b + w < kMaxSplit; b += 2 * w) {
      if (b + w < P) {
        lse_merge(v[b].x, v[b].y, v[b + w].x, v[b + w].y);
        if (marg) lse_merge(v[b].z, v[b].w, v[b + w].z, v[b + w].w);
      }
    }
  }
}

// Grid (tiles * split, G), clusters of `split` blocks along x. Block x
// serves test rows [tile * 128R, (tile + 1) * 128R) of program g, thread t
// rows tile * 128R + r * 128 + t, and the leaves of its cluster rank. Each
// leaf's (mj, sj, mm, sm) per test row goes to a slot of the dynamic shared
// memory s_leaf (slots x kRows float4). The minimum of kMinBlocks blocks
// per SM caps a thread at 168 registers; without it ptxas held some widths
// to 64 or 128 and spilled.
template <int D, int R, bool kCv>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pairs_kernel(const PairsArgs a) {
  constexpr int T = kGroup;
  constexpr int kRows = kThreads * R;
  static_assert(kTile % T == 0, "a tile holds whole groups");
  __shared__ __align__(16) float s_tr[(D + (kCv ? 1 : 0)) * kTile];
  extern __shared__ float4 s_leaf[];

  const int g = blockIdx.y;
  const int split = a.split;
  const int rank = split > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                             : 0;
  const int i0 = (blockIdx.x / split) * kRows;
  const bool marg = kCv && !(a.no_ev[g] > 0.5f);  // uniform over the block

  float te[R][D], zte[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads + threadIdx.x;
    const bool active = i < a.nte;
    const size_t row = static_cast<size_t>(g) * a.nte + (active ? i : 0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      te[r][k] = active ? kScale * a.te[row * D + k] : 0.0f;
    }
    zte[r] = (kCv && active) ? kScale * a.zte[row] : 0.0f;
  }

  const int leaves = reduction_leaves(a.ntr);
  const int size = (a.ntr + leaves - 1) / leaves;
  const int lo_leaf = first_leaf(rank, leaves, split);
  const int hi_leaf = first_leaf(rank + 1, leaves, split);
  for (int leaf = lo_leaf; leaf < hi_leaf; ++leaf) {
    // (m, s) pairs of the joint and the marginal in log2 units: every value
    // is <= 0, so the reference starts at 0 (see lse_lazy)
    float mj[R], sj[R], mm[R], sm[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mj[r] = 0.0f, sj[r] = 0.0f, mm[r] = 0.0f, sm[r] = 0.0f;
    }
    const int lo = min(a.ntr, leaf * size);
    const int hi = min(a.ntr, lo + size);
    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int rows = min(kTile, hi - t0);
      const int padded = (rows + T - 1) / T * T;
      stage_tile<D, kCv>(a, g, t0, rows, padded, s_tr);
      __syncthreads();
      if (marg) {
        if constexpr (kCv) {
          sweep_tile<D, R, true>(s_tr, padded, te, zte, mj, sj, mm, sm);
        }
      } else {
        sweep_tile<D, R, false>(s_tr, padded, te, zte, mj, sj, mm, sm);
      }
      __syncthreads();
    }
    float4* slot = s_leaf + (leaf - lo_leaf) * kRows;
#pragma unroll
    for (int r = 0; r < R; ++r) {  // an empty sum's reference means nothing
      slot[r * kThreads + threadIdx.x] =
          make_float4(sj[r] == 0.0f ? kInit : mj[r], sj[r],
                      sm[r] == 0.0f ? kInit : mm[r], sm[r]);
    }
  }

  // Merge the leaves: rank q finishes rows [q * per, (q + 1) * per) of the
  // tile from every rank's shared memory (with no split, thread t its own
  // rows r * 128 + t, from its own slots).
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  const int per = (kRows + split - 1) / split;
  const int end = min(kRows, (rank + 1) * per);
  for (int q = rank * per + threadIdx.x; q < end; q += kThreads) {
    float4 v[kMaxSplit];
#pragma unroll
    for (int l = 0; l < kMaxSplit; ++l) {
      if (l < leaves) {
        const int owner = ((l + 1) * split - 1) / leaves;
        const float4* base =
            split > 1 ? cluster.map_shared_rank(s_leaf, owner) : s_leaf;
        v[l] = base[(l - first_leaf(owner, leaves, split)) * kRows + q];
      }
    }
    merge_tree(v, leaves, kCv && marg);
    const int i = i0 + q;
    if (i < a.nte) {
      a.out[static_cast<size_t>(g) * a.nte + i] =
          finish<kCv>(a, g, marg, v[0].x, v[0].y, v[0].z, v[0].w);
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads it
}

// Any width d: the block's test coordinates live in shared memory as
// s_te[k * kThreads + thread] (consecutive threads, consecutive banks), the
// train tile as s_tr[k * kWideTile + row] (one broadcast per step), an
// invalid or padding row at coordinate 0 = kFar (a NaN kept) as in
// stage_tile. One test
// row per thread, groups of 32 train rows, lse_lazy, no split.
__global__ void __launch_bounds__(kThreads)
kde_logl_wide_kernel(const PairsArgs a, int d) {
  constexpr int T = kWideGroup;
  static_assert(kWideTile % T == 0, "a tile holds whole groups");
  extern __shared__ float smem[];
  float* s_te = smem;                 // d x kThreads
  float* s_tr = s_te + d * kThreads;  // d x kWideTile

  const int g = blockIdx.y;
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  const int nrows = min(kThreads, a.nte - i0);
  const size_t base = static_cast<size_t>(g) * a.ntr;
  const float* tr_g = a.tr + base * d;
  const float* te_b = a.te + (static_cast<size_t>(g) * a.nte + i0) * d;

  for (int e = threadIdx.x; e < kThreads * d; e += kThreads) {
    s_te[(e % d) * kThreads + e / d] = e < nrows * d ? te_b[e] : 0.0f;
  }
  float m = 0.0f, s = 0.0f;  // log2-domain pair, as in pairs_kernel
  for (int t0 = 0; t0 < a.ntr; t0 += kWideTile) {
    const int rows = min(kWideTile, a.ntr - t0);
    const int padded = (rows + T - 1) / T * T;
    // coalesced over the tile's contiguous (rows x d) slab
    for (int e = threadIdx.x; e < padded * d; e += kThreads) {
      const int r = e / d, k = e % d;
      float v = r < rows ? tr_g[static_cast<size_t>(t0) * d + e] : 0.0f;
      if (k == 0 && !(r < rows && a.neg[base + t0 + r] > 0.0f) && !isnan(v)) {
        v = kFar;
      }
      s_tr[k * kWideTile + r] = v;
    }
    __syncthreads();
    for (int j0 = 0; j0 < padded; j0 += T) {
      float x[T];
#pragma unroll
      for (int t = 0; t < T; ++t) x[t] = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float c = s_te[k * kThreads + threadIdx.x];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float df = c - s_tr[k * kWideTile + j0 + t];
          x[t] = fmaf(df, df, x[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t) x[t] = fmaf(-kHalfLog2e, x[t], -m);
      lse_lazy(x, m, s);
    }
    __syncthreads();
  }
  if (i < a.nte) {
    a.out[static_cast<size_t>(g) * a.nte + i] = lse_ln(m, s) + a.offset[g];
  }
}

template <int D, int R, bool kCv>
cudaError_t launch_pairs(const PairsArgs& a, int G, cudaStream_t stream) {
  constexpr int kRows = kThreads * R;
  constexpr size_t kStatic = sizeof(float) * (D + (kCv ? 1 : 0)) * kTile;
  const int tiles = (a.nte + kRows - 1) / kRows;
  const int leaves = reduction_leaves(a.ntr);
  const int slots = (leaves + a.split - 1) / a.split;  // most leaves a block
  const size_t bytes = sizeof(float4) * kRows * slots;
  if (kStatic + bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairs_kernel<D, R, kCv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.split, G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pairs_kernel<D, R, kCv>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The launch plan a templated width takes: R = kRowsPerThread, T = kGroup
// and 1 <= split <= kMaxSplit.
bool plan_ok(int R, int T, int split) {
  return R == kRowsPerThread && T == kGroup && split >= 1 &&
         split <= kMaxSplit;
}

template <bool kCv>
cudaError_t launch_templated(const PairsArgs& a, int G, int d,
                             cudaStream_t s) {
  switch (d) {
#define PAIRS_CASE(D) \
  case D:             \
    return launch_pairs<D, kRowsPerThread, kCv>(a, G, s);
    PAIRS_CASE(1)
    PAIRS_CASE(2)
    PAIRS_CASE(3)
    PAIRS_CASE(4)
    PAIRS_CASE(5)
    PAIRS_CASE(6)
    PAIRS_CASE(7)
    PAIRS_CASE(8)
    PAIRS_CASE(9)
    PAIRS_CASE(10)
    PAIRS_CASE(11)
    PAIRS_CASE(12)
    PAIRS_CASE(13)
    PAIRS_CASE(14)
    PAIRS_CASE(15)
    PAIRS_CASE(16)
#undef PAIRS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// the launch's CUDA error code: 0 on success. Allocates nothing. All arrays
// are contiguous float32 on the current device: jtr (G, ntr, dpad), neg and
// zv_tr (G, ntr), jte (G, nte, dpad), zv_te (G, nte), no_ev and lm_const
// (G,), out (G, nte). 1 <= dpad <= 16, 1 <= G <= 65535, nte >= 1. The
// launch plan: `rows_per_thread` R = 2 test rows per thread, `group` T = 16
// train rows per group, `split` S in 1..8 blocks of a cluster sharing each
// test tile's train rows; anything else returns cudaErrorInvalidValue.
extern "C" int ckde_cv_pairs_f32(const float* jtr, const float* neg,
                                 const float* zv_tr, const float* jte,
                                 const float* zv_te, const float* no_ev,
                                 const float* lm_const, float* out, int G,
                                 int ntr, int nte, int dpad,
                                 int rows_per_thread, int group, int split,
                                 void* stream) {
  if (dpad < 1 || dpad > kMaxTemplated ||
      !plan_ok(rows_per_thread, group, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PairsArgs a{jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const, out,
                    ntr, nte, split};
  return static_cast<int>(
      launch_templated<true>(a, G, dpad, static_cast<cudaStream_t>(stream)));
}

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// the launch's CUDA error code: 0 on success. Allocates nothing. All arrays
// are contiguous float32 on the current device: train (G, ntr, d), valid
// (G, ntr) with > 0 for a valid row, test (G, nte, d), lognorm (G,), out
// (G, nte). 1 <= d <= 256, 1 <= G <= 65535, nte >= 1. The launch plan as
// for ckde_cv_pairs_f32 up to d = 16; above, R = 1, T = 32 and split 1
// (the runtime-width kernel).
extern "C" int kde_logl_f32(const float* train, const float* valid,
                            const float* test, const float* lognorm,
                            float* out, int G, int ntr, int nte, int d,
                            int rows_per_thread, int group, int split,
                            void* stream) {
  const PairsArgs a{train, valid, nullptr, test, nullptr, nullptr, lognorm,
                    out, ntr, nte, split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d >= 1 && d <= kMaxTemplated) {
    if (!plan_ok(rows_per_thread, group, split)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_templated<false>(a, G, d, s));
  }
  if (d < 1 || d > kMaxWide || rows_per_thread != 1 ||
      group != kWideGroup || split != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes =
      sizeof(float) * static_cast<size_t>(d) * (kThreads + kWideTile);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kde_logl_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((nte + kThreads - 1) / kThreads, G);
  kde_logl_wide_kernel<<<grid, kThreads, bytes, s>>>(a, d);
  return static_cast<int>(cudaGetLastError());
}
