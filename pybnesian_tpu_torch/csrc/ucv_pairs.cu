// The pair sums of the UCV (unbiased cross-validation) bandwidth objective
// for NVIDIA Hopper (sm_90a), and the whole UCV bandwidth search built on
// them.
//
// ucv_pair_sums_f32 replaces `ucv_pair_sums` of pybnesian_tpu/ops/kde.py,
// which the JAX package runs as one jitted XLA program (a lax.map over
// upper-triangle chunk pairs; no Pallas kernel), itself the counterpart of
// upstream PyBNesian's sum_ucv OpenCL kernels (KDE.cl.src:471-565). For
// each of B problems of whitened rows w (N, d) with a validity mask:
//
//   s2h[b] = sum_{i<j, both valid} exp(-1/4 * |w_i - w_j|^2)
//   sh[b]  = sum_{i<j, both valid} exp(-1/2 * |w_i - w_j|^2)
//
// from one exp per pair: the second term is the square of the first.
//
// Bound: the exponentials, one SFU `ex2` each (16 per clock per SM), and
// the FP32 pipe's instruction rate: d + 3 instructions per pair (an add and d
// FMAs for the exponent, an add and an FMA for the two sums), 6 at d 3
// against the difference form's 2d + 2 = 8, which alone took as long as
// the SFU's bound. Bytes are no limit: every row is read once per tile
// pair and reused by 256 rows of the other tile. PERF.md has the measured
// times against that bound.
//
// Design:
//
// - Grid (upper-triangle tile pair, problem): block (ti, tj), ti <= tj,
//   sums the pairs of row tile ti against column tile tj. A thread of the
//   64 holds R = 4 consecutive rows of tile ti in registers; the block
//   stages tile tj coordinate by coordinate in shared memory, so that one
//   float4 load gives one coordinate of 4 columns, which serves 16 pairs.
// - One `ex2.approx.ftz` per pair: coordinates are scaled by
//   sqrt(log2(e) / 4) as they are loaded, so that minus the distance sum
//   is the first term's exponent in log2 units; e and e * e are summed.
// - The dot-product form of the distance: with z the scaled rows less an
//   origin o, -|z_i - z_j|^2 = a_i + b_j + sum_k (2 z_ik) z_jk, where a_i
//   = b_i = -|z_i|^2 are formed once per row (the rows' in registers, the
//   columns' staged after their coordinates): an add and d FMAs a pair. Its
//   rounding grows with |z|^2 against |z_i - z_j|^2, so o is a row of the
//   data, not 0: each block takes the first valid row of its row tile, so
//   |z| is the spread of the data in bandwidths, wherever the data lie
//   (tools/ucv_dot_form_error.py, which emulates this origin: within 1e-6
//   of float64 from 1.25 to a quarter of the normal-reference bandwidth,
//   1.04e-5 at an eighth, where the difference form stays within 6e-8;
//   3e-5 with o = 0 on data 50 standard deviations out). Phase 9 of
//   chip_smoke.py holds the kernel to 1e-5 on the smallest bandwidth its
//   searches visit.
//   Every block picks its origin from its own rows, so the sums still
//   depend on nothing but the problem's rows.
// - Invalid rows without a per-pair mask: an invalid (or padding) row is
//   staged as (+1e30, 0, ..., 0) on the row side and (-1e30, 0, ..., 0) on
//   the column side, so that its a_i or b_j is -inf and every pair that
//   holds one, two invalid rows included, has exponent -inf and term 0
//   (no inf - inf: the cross term of two invalid rows is -inf too). A NaN
//   coordinate is kept, so that it reaches the sums, as NaN * 0 does in
//   the plain version.
// - Off-diagonal tiles run a loop with no mask at all. Diagonal tiles
//   (ti == tj) run their own: a warp (128 consecutive rows) skips the
//   column groups that lie wholly below its first row, and in the groups
//   it computes keeps the pairs i < j, the others set to 0 unless NaN, as
//   the plain version's mask gives them (a min that keeps a NaN, not a
//   product with 0: a self-pair's exponent, 0 in exact arithmetic, may
//   round past 128 in the dot form at a bandwidth far below the data's
//   spread, and inf * 0 is NaN).
// - Deterministic and batch-independent: per-thread FP32 sums in a fixed
//   order, a fixed float64 tree over the block's threads, one float64
//   partial per (problem, tile pair), no atomic in any sum (a shared
//   atomicMin only finds the origin row, a minimum). A second kernel sums
//   each problem's partials in a fixed order: per row tile over its column
//   tiles in order, those row sums in order of ti within each of 256
//   threads (row tiles ti = t, t + 256, ...), then a fixed tree over the
//   threads. A problem's sums depend on its own rows alone: padding it
//   with invalid rows to a batch's N only adds exact zeros at the ends of
//   those sums, so its two sums are bit-equal alone, inside any batch, and
//   from run to run.
//
// Families wider than 16 columns take a runtime-width kernel in the
// difference form (2d + 2 instructions a pair): 128 threads, one row per
// thread, tiles of 128 rows, groups of 32 columns, coordinates staged 32 at
// a time, so any width fits its shared memory.
//
// ucv_search_f32 replaces `_device_minimize` and `ucv_minimize_batch` of
// pybnesian_tpu/kde/ucv.py (:106, :171) with the `nelder_mead_batch` they
// run (pybnesian_tpu/ops/nelder_mead.py:24): the whole Nelder–Mead search
// of B UCV problems, every objective evaluation inside it, as one
// cooperative launch whose blocks stay resident for the whole search (the
// grid is the co-resident block count). The JAX package runs that search
// as one jitted `lax.while_loop` for the same reason: a dispatch per
// evaluation would set the pace.
//
// Each lane (problem) moves through its own phases, with no grid-wide
// barrier after the set-up: a phase is the tiles of the points the lane
// must evaluate next (its start and simplex; a reflection; the second
// point, expansion or a contraction; its n shrunk vertices), one work
// item a (point, tile pair), numbered 0 .. points x pairs - 1 over the
// lane's own tiles. The lane's queue word holds the phase's item count and
// the next item to claim (the phase's kind sits in the lane's state):
//
//   - a block claims an item with one atomicAdd on the word (its old
//     value names the item, or lies past the phase's items: no claim);
//     warp 0 scans the lanes from a block-dependent start, 32 words at a
//     time;
//   - it builds L from the point (vech(L) or diag(L)) in shared memory,
//     whitens its row tile and column tile into shared memory by forward
//     substitution (d^2 FMAs a row against 256 d a row's pairs) and
//     writes the item's float64 partial to its fixed slot, with the pair
//     kernel's own tile body reading the whitened tiles, then counts the
//     item done (a fence, then an atomicAdd on the lane's count);
//   - the block that counts a phase's last item runs the lane's step with
//     one warp: it sums each point's partials in the pair kernel's fixed
//     order (the same bits as ucv_pair_sums_f32 on those whitened rows),
//     forms the score and the guards in float32 as the plain objective
//     does, and takes the Nelder–Mead step: the second point (none when
//     the reflection is kept), scipy's accept rules or a shrink, the order
//     of the n + 1 vertices by a stable insertion sort of slot indices
//     (the vertices stay in their slots), the iteration count and the
//     convergence test; then it publishes the next phase's points and,
//     after a fence, the next queue word;
//   - idle blocks back off with __nanosleep and leave when the count of
//     live lanes reaches 0; the last lane to finish writes the batched
//     evaluation count.
//
// A lane's steps read its own state alone and its partials sit in fixed
// slots, so a lane gives the same bits whichever block ran which item,
// alone and in any batch: the plain loop's. Atomics only claim items,
// count completions and lanes, and OR the shrink flags; no atomic touches
// a value that is summed. A lane that has converged, or reached max_iter,
// costs nothing more; a lane whose start scores NaN is done after its
// first phase. Work items come from a lane's own rows (up to its last
// valid row), whose extra tiles in a padded batch would add only exact
// zeros.
//
// Bound: the exponentials of the pair evaluations the lanes' searches
// need (their `lane_evals`, each a pair-kernel evaluation of the lane's
// valid rows), on the SFU. Lanes converge after very different numbers of
// iterations, and each step waits on its lane's last item: the queue keeps
// every block on whatever lane has items left, so the card stays fed
// until the last lanes' tail, and a step's latency (the reduce's loads
// above all) stays short on its lane's critical path.
//
// Evaluations: the plain loop counts its batched objective calls, which
// run in lockstep: 1 + (n + 1), then 2 a round while any lane runs, and n
// more in a round where some lane shrinks. Round t is every lane's own
// iteration t, so the kernel counts 2 + n + 2 max_b iterations_b + n |{t :
// some lane shrank at its iteration t}|, the set kept as max_iter bits set
// with atomicOr. Each lane also counts the evaluations its own search
// needed (its n + 1 starting points, then per iteration its reflection,
// its second point unless the reflection was kept, and n when it shrank).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;         // threads per block, templated width
constexpr int kRowsPerThread = 4;    // R: consecutive rows a thread holds
constexpr int kTile = 256;           // rows per tile: kThreads * R
constexpr int kWarpRows = 32 * kRowsPerThread;  // rows of one warp
constexpr int kGroup = 16;           // columns per group
constexpr int kMaxTemplated = 16;    // widest problem of the templated kernel
constexpr int kWideThreads = 128;    // threads per block, runtime width
constexpr int kWideTile = 128;       // rows per tile, runtime width
constexpr int kWideGroup = 32;       // columns per group, runtime width
constexpr int kWideChunk = 32;       // coordinates staged at a time
constexpr int kReduceThreads = 256;  // threads of the per-problem reduction
constexpr int kSumBatch = 8;    // partial pairs a reducing thread loads at once
constexpr float kScale = 0.60056120439322491f;  // sqrt(log2(e) / 4)
constexpr float kFar = 1e30f;  // coordinate 0 of an invalid row, signed

// the search
constexpr double kLog2Pi = 1.8378770664093454836;  // log(2 pi)
constexpr double kLog2 = 0.69314718055994530942;
// MACHINE_TOL of the port (4 float64 epsilons), compared in float32 as the
// plain objective compares it
constexpr float kMachineTol = static_cast<float>(2.220446049250313e-16 * 4);
constexpr int kBest = 2, kMid = 4, kOutside = 8;  // a reflection's flags
// flags, iterations, tiles, the lane's evaluations, the items of its
// phase done, its phase
constexpr int kLaneInts = 6;
constexpr int kLaneFloats = 8;  // f start, det start, fatol, xatol, f of
                                // the reflection, N, unused
// blocks an SM that the search kernel's registers must allow: 8 up to 4
// columns (128 registers), 6 wider (168), 4 of the runtime width's 128
// threads (128), what the tile bodies take alone
template <int D>
constexpr int kSearchBlocksPerSm = D == 0 ? 4 : D <= 4 ? 8 : 6;
// a lane's phase, in its state: the points whose tiles are its items
constexpr int kNoItems = 0, kStartPoints = 1, kReflection = 2,
              kSecondPoint = 3, kShrunk = 4;
constexpr unsigned kNapMin = 64, kNapMax = 1024;  // ns an idle block sleeps
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- rows
// The whitened rows of the pair-sums entry, in device memory.
struct WhiteRows {
  const float* white;  // (B, N, d)
  const float* valid;  // (B, N), > 0 for a row that counts; null: all count
  int N;

  template <int D>
  __device__ __forceinline__ void row(int b, int r, float (&w)[D]) const {
    const float* p = white + (static_cast<size_t>(b) * N + r) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) w[k] = p[k];
  }
  __device__ __forceinline__ float coord(int b, int r, int k, int d) const {
    return white[(static_cast<size_t>(b) * N + r) * d + k];
  }
  __device__ __forceinline__ bool counts(int b, int r) const {
    return valid == nullptr || valid[static_cast<size_t>(b) * N + r] > 0.0f;
  }
};

// L^-1 x by forward substitution, L lower triangular and row-major (d x
// d): w_k = (x_k - L_k0 w_0 - L_k1 w_1 - ...) / L_kk, each product rounded
// before it is subtracted, in order of j, as the plain version's tensor
// operations round them. The fixed and the runtime width do the same
// operations in the same order, so they give the same bits.
template <int D>
__device__ __forceinline__ void whiten_fixed(const float* x, const float* L,
                                             float (&w)[D]) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float s = x[k];
#pragma unroll
    for (int j = 0; j < k; ++j) {
      s = __fsub_rn(s, __fmul_rn(L[k * D + j], w[j]));
    }
    w[k] = __fdiv_rn(s, L[k * D + k]);
  }
}

__device__ __forceinline__ void whiten_var(const float* x, const float* L,
                                           int d, float* w, int stride) {
  for (int k = 0; k < d; ++k) {
    float s = x[k];
    for (int j = 0; j < k; ++j) {
      s = __fsub_rn(s, __fmul_rn(L[k * d + j], w[j * stride]));
    }
    w[k * stride] = __fdiv_rn(s, L[k * d + k]);
  }
}

// The rows of one tile of a search, whitened into shared memory:
// coordinate k of row base + t at tile[k * stride + t] (stride kTile for
// the templated width, kWideTile for the runtime width).
template <int Stride>
struct SharedTile {
  const float* tile;
  const float* valid;
  int N, base;

  template <int D>
  __device__ __forceinline__ void row(int, int r, float (&w)[D]) const {
#pragma unroll
    for (int k = 0; k < D; ++k) w[k] = tile[k * Stride + (r - base)];
  }
  __device__ __forceinline__ float coord(int, int r, int k, int) const {
    return tile[k * Stride + (r - base)];
  }
  __device__ __forceinline__ bool counts(int b, int r) const {
    return valid == nullptr || valid[static_cast<size_t>(b) * N + r] > 0.0f;
  }
};

// Coordinate k of a row, less the block's origin, scaled: an out-of-range
// row (`in` false), or an invalid one, is (far, 0, ..., 0), but a NaN
// coordinate is kept.
__device__ __forceinline__ float moved(bool in, bool counts, float x,
                                       float origin, int k, float far) {
  if (!in) return k == 0 ? far : 0.0f;
  if (isnan(x)) return x;
  if (!counts) return k == 0 ? far : 0.0f;
  return kScale * (x - origin);
}

// Coordinate k of row `row` of problem b, scaled; an out-of-range or
// invalid row has coordinate 0 at `far` unless it is NaN.
template <class Rows>
__device__ __forceinline__ float staged(const Rows& src, int b, int row,
                                        int k, int d, float far) {
  if (row >= src.N) return k == 0 ? far : 0.0f;
  const float v = kScale * src.coord(b, row, k, d);
  if (k == 0 && !src.counts(b, row) && !isnan(v)) return far;
  return v;
}

// (ti, tj), ti <= tj, of tile pair p in row-major order over the upper
// triangle of nt x nt tiles: row ti starts at ti * nt - ti * (ti - 1) / 2.
__device__ __forceinline__ void tile_pair(long long p, int nt, int& ti,
                                          int& tj) {
  const double m = 2.0 * nt + 1.0;
  long long i = static_cast<long long>((m - sqrt(m * m - 8.0 * p)) / 2.0);
  auto start = [nt](long long t) { return t * nt - t * (t - 1) / 2; };
  while (i > 0 && start(i) > p) --i;
  while (start(i + 1) <= p) ++i;
  ti = static_cast<int>(i);
  tj = static_cast<int>(i + (p - start(i)));
}

// Sums (s2h, sh) over the block's NT threads in float64, in a fixed tree,
// and writes them to out[0], out[1].
template <int NT>
__device__ __forceinline__ void write_partial(double* out, float se,
                                              float se2) {
  __shared__ double s_warp[2][NT / 32];
  double x = se, y = se2;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    x += __shfl_down_sync(kFull, x, off);
    y += __shfl_down_sync(kFull, y, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_warp[0][warp] = x;
    s_warp[1][warp] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sx = s_warp[0][0], sy = s_warp[1][0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) {
      sx += s_warp[0][w];
      sy += s_warp[1][w];
    }
    out[0] = sx;
    out[1] = sy;
  }
}

// A masked term: 0, or NaN when e is (e >= 0 here, so min(e, 0) by the
// min that keeps a NaN); not e * 0, which is NaN for an e that is inf.
__device__ __forceinline__ float zero_unless_nan(float e) {
  asm("min.NaN.f32 %0, %0, 0f00000000;" : "+f"(e));
  return e;
}

// Adds the terms of a group of T distance sums y (minus the distance in
// log2 units) to (se, se2): four partial sums each, in a fixed order.
// DIAG: keeps the pairs whose column `j0 + t` lies past `row`.
template <int T, bool DIAG>
__device__ __forceinline__ void add_group(const float (&y)[T], int row,
                                          int j0, float& se, float& se2) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float e = ex2(y[t]);
    if (DIAG && !(row < j0 + t)) e = zero_unless_nan(e);
    p[t % 4] += e;
    q[t % 4] = fmaf(e, e, q[t % 4]);
  }
  se += (p[0] + p[1]) + (p[2] + p[3]);
  se2 += (q[0] + q[1]) + (q[2] + q[3]);
}

// The column groups j0 = j_begin, j_begin + T, ... of the staged column
// tile against the thread's R rows (tile rows row0 .. row0 + R - 1): per
// pair y = (a_i + b_j) + sum_k u_ik v_jk, the column biases b_j staged
// after the D coordinates.
template <int D, bool DIAG>
__device__ __forceinline__ void tile_sums(const float (&u)[kRowsPerThread][D],
                                          const float (&ar)[kRowsPerThread],
                                          const float* s_col, int row0,
                                          int j_begin, float& se,
                                          float& se2) {
  constexpr int R = kRowsPerThread;
  constexpr int T = kGroup;
#pragma unroll 1
  for (int j0 = j_begin; j0 < kTile; j0 += T) {
    float y[R][T], x[T];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      // k == 0: the biases (row D of the staging), then coordinates 0..D-1
      const int row = k == 0 ? D : k - 1;
#pragma unroll
      for (int v = 0; v < T / 4; ++v) {
        const float4 q =
            reinterpret_cast<const float4*>(s_col + row * kTile + j0)[v];
        x[4 * v] = q.x;
        x[4 * v + 1] = q.y;
        x[4 * v + 2] = q.z;
        x[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (k == 0) {
            y[r][t] = ar[r] + x[t];
          } else {
            y[r][t] = fmaf(u[r][k - 1], x[t], y[r][t]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      add_group<T, DIAG>(y[r], row0 + r, j0, se, se2);
    }
  }
}

// The sums (se, se2) of one block's thread over tile pair (ti, tj) of
// problem b, the whitened rows of tile ti from `rows`, those of tile tj
// from `cols`: thread t holds rows ti * kTile + t * R + r, r < R. s_col
// holds (D + 1) * kTile floats, s_first one int, both shared.
template <int D, class RowSrc, class ColSrc>
__device__ __forceinline__ void pair_tile(const RowSrc& rows,
                                          const ColSrc& cols, int b, int ti,
                                          int tj, float* s_col, int* s_first,
                                          float& se, float& se2) {
  constexpr int R = kRowsPerThread;
  static_assert(kTile == kThreads * R, "a tile is a block's rows");
  static_assert(kTile % kGroup == 0 && kWarpRows % kGroup == 0,
                "a tile and a warp's rows hold whole groups");

  // the block's origin: the first valid row of tile ti (0 when it has none)
  const int row0 = threadIdx.x * R;  // the thread's first row in the tile
  if (threadIdx.x == 0) *s_first = kTile;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = ti * kTile + row0 + r;
    if (row < rows.N && rows.counts(b, row)) {
      atomicMin(s_first, row0 + r);
      break;
    }
  }
  __syncthreads();
  const int first = *s_first;
  float origin[D];
  if (first < kTile) {
    rows.template row<D>(b, ti * kTile + first, origin);
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) origin[k] = 0.0f;
  }

  // rows: u_i = 2 z_i and a_i = -|z_i|^2, z_i the scaled moved row
  float u[R][D], ar[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = ti * kTile + row0 + r;
    const bool in = row < rows.N;
    float w[D];
    if (in) {
      rows.template row<D>(b, row, w);
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) w[k] = 0.0f;
    }
    const bool ok = in && rows.counts(b, row);
    ar[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float z = moved(in, ok, w[k], origin[k], k, kFar);
      u[r][k] = 2.0f * z;
      ar[r] = fmaf(-z, z, ar[r]);
    }
  }
  // columns: z_j by coordinate, then b_j = -|z_j|^2
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int row = tj * kTile + c;
    const bool in = row < cols.N;
    float w[D];
    if (in) {
      cols.template row<D>(b, row, w);
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) w[k] = 0.0f;
    }
    const bool ok = in && cols.counts(b, row);
    float bj = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float z = moved(in, ok, w[k], origin[k], k, -kFar);
      s_col[k * kTile + c] = z;
      bj = fmaf(-z, z, bj);
    }
    s_col[D * kTile + c] = bj;
  }
  __syncthreads();

  se = 0.0f;
  se2 = 0.0f;
  if (ti == tj) {
    // groups wholly below the warp's first row hold no pair i < j
    const int first_row = (threadIdx.x / 32) * kWarpRows;
    tile_sums<D, true>(u, ar, s_col, row0, first_row, se, se2);
  } else {
    tile_sums<D, false>(u, ar, s_col, row0, 0, se, se2);
  }
}

// Any width d: tiles of kWideTile rows, one row per thread; columns in
// groups of kWideGroup, each group's distances summed over coordinates
// staged kWideChunk at a time (rows and columns both in shared memory:
// s_row kWideChunk * kWideTile floats, s_col kWideChunk * kWideGroup).
template <class RowSrc, class ColSrc>
__device__ __forceinline__ void pair_tile_wide(const RowSrc& rows,
                                               const ColSrc& cols, int b,
                                               int ti, int tj, int d,
                                               float* s_row, float* s_col,
                                               float& se, float& se2) {
  static_assert(kWideTile == kWideThreads, "one row per thread");
  const bool diag = ti == tj;
  const int i0 = ti * kWideTile, c0 = tj * kWideTile;

  se = 0.0f;
  se2 = 0.0f;
#pragma unroll 1
  for (int j0 = 0; j0 < kWideTile; j0 += kWideGroup) {
    float y[kWideGroup];
#pragma unroll
    for (int t = 0; t < kWideGroup; ++t) y[t] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kWideChunk) {
      const int kc = min(kWideChunk, d - k0);
      __syncthreads();  // the previous chunk is read
      for (int e = threadIdx.x; e < kWideTile * kc; e += kWideThreads) {
        const int r = e / kc, k = e % kc;
        s_row[k * kWideTile + r] = staged(rows, b, i0 + r, k0 + k, d, kFar);
      }
      for (int e = threadIdx.x; e < kWideGroup * kc; e += kWideThreads) {
        const int c = e / kc, k = e % kc;
        s_col[k * kWideGroup + c] =
            staged(cols, b, c0 + j0 + c, k0 + k, d, -kFar);
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const float wk = s_row[k * kWideTile + threadIdx.x];
#pragma unroll
        for (int t = 0; t < kWideGroup; ++t) {
          const float df = wk - s_col[k * kWideGroup + t];
          y[t] = fmaf(-df, df, y[t]);
        }
      }
    }
    if (diag) {
      add_group<kWideGroup, true>(y, threadIdx.x, j0, se, se2);
    } else {
      add_group<kWideGroup, false>(y, threadIdx.x, j0, se, se2);
    }
  }
}

// ------------------------------------------------------------- reduction
// Thread t's sums of one problem's partials (nt tiles, row-major upper
// triangle, an (s2h, sh) pair a tile pair): each row tile ti = t, t +
// kReduceThreads, ... over its column tiles in order, those row sums in
// order of ti. A row's partials are loaded kSumBatch pairs at a time
// ahead of their adds, which keep their order (in the search's lane steps
// the loads' latency sets the pace).
__device__ __forceinline__ void thread_sums(const double* part, int nt, int t,
                                            double& x, double& y) {
  x = 0.0;
  y = 0.0;
  for (int ti = t; ti < nt; ti += kReduceThreads) {
    const double* row =
        part + 2 * (static_cast<long long>(ti) * nt -
                    static_cast<long long>(ti) * (ti - 1) / 2);
    const int len = nt - ti;
    double rx = 0.0, ry = 0.0;
    int tj = 0;
    for (; tj + kSumBatch <= len; tj += kSumBatch) {
      double2 v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        v[u] = __ldcg(reinterpret_cast<const double2*>(row) + tj + u);
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        rx += v[u].x;
        ry += v[u].y;
      }
    }
#pragma unroll 4
    for (; tj < len; ++tj) {
      rx += __ldcg(row + 2 * tj);
      ry += __ldcg(row + 2 * tj + 1);
    }
    x += rx;
    y += ry;
  }
}

// A warp's fixed tree: lane 0 ends with the warp's sums.
__device__ __forceinline__ void warp_sums(double& x, double& y) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    x += __shfl_down_sync(kFull, x, off);
    y += __shfl_down_sync(kFull, y, off);
  }
}

// One block per problem: the threads' sums (thread_sums), each warp's by
// warp_sums, then the warps in order.
__global__ void __launch_bounds__(kReduceThreads)
    ucv_reduce_kernel(const double* partials, float* out, int nt, int pairs) {
  __shared__ double s_warp[2][kReduceThreads / 32];
  const int b = blockIdx.x;
  double x, y;
  thread_sums(partials + 2 * static_cast<size_t>(b) * pairs, nt, threadIdx.x,
              x, y);
  warp_sums(x, y);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_warp[0][warp] = x;
    s_warp[1][warp] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sx = s_warp[0][0], sy = s_warp[1][0];
#pragma unroll
    for (int w = 1; w < kReduceThreads / 32; ++w) {
      sx += s_warp[0][w];
      sy += s_warp[1][w];
    }
    out[2 * b] = static_cast<float>(sx);
    out[2 * b + 1] = static_cast<float>(sy);
  }
}

// ucv_reduce_kernel's sums by one warp: the kReduceThreads threads' sums
// taken 32 at a time, each group by warp_sums, the groups in order (a
// group past the last row tile adds exact zeros and is skipped). Lane 0
// ends with the sums. Not inlined: its batched loads stay out of the
// register budget of the search kernel's tile work.
__device__ __noinline__ void warp_reduce(const double* part, int nt,
                                            double& sx, double& sy) {
  const int lane = threadIdx.x & 31;
  sx = 0.0;
  sy = 0.0;
#pragma unroll 1
  for (int w = 0; w < kReduceThreads / 32 && w * 32 < nt; ++w) {
    double x, y;
    thread_sums(part, nt, w * 32 + lane, x, y);
    warp_sums(x, y);
    if (w == 0) {
      sx = x;
      sy = y;
    } else {
      sx += x;
      sy += y;
    }
  }
}

// ------------------------------------------------------------ pair sums
struct UcvArgs {
  const float* white;  // (B, N, d) whitened rows
  const float* valid;  // (B, N), > 0 for a row that counts; null: all count
  double* partials;    // (B, pairs, 2) per tile pair (s2h, sh)
  int N, nt;           // rows, tiles
};

// Grid (pairs, B).
template <int D>
__global__ void __launch_bounds__(kThreads)
    ucv_pairs_kernel(const UcvArgs a, int pairs) {
  // D coordinates, then the biases b_j, of the column tile's rows
  __shared__ __align__(16) float s_col[(D + 1) * kTile];
  __shared__ int s_first;  // the row tile's first valid row
  const int b = blockIdx.y;
  const long long p = blockIdx.x;
  int ti, tj;
  tile_pair(p, a.nt, ti, tj);
  const WhiteRows src{a.white, a.valid, a.N};
  float se, se2;
  pair_tile<D>(src, src, b, ti, tj, s_col, &s_first, se, se2);
  write_partial<kThreads>(a.partials + 2 * (static_cast<size_t>(b) * pairs + p),
                          se, se2);
}

__global__ void __launch_bounds__(kWideThreads)
    ucv_pairs_wide_kernel(const UcvArgs a, int pairs, int d) {
  __shared__ float s_row[kWideChunk * kWideTile];
  __shared__ float s_col[kWideChunk * kWideGroup];
  const int b = blockIdx.y;
  const long long p = blockIdx.x;
  int ti, tj;
  tile_pair(p, a.nt, ti, tj);
  const WhiteRows src{a.white, a.valid, a.N};
  float se, se2;
  pair_tile_wide(src, src, b, ti, tj, d, s_row, s_col, se, se2);
  write_partial<kWideThreads>(
      a.partials + 2 * (static_cast<size_t>(b) * pairs + p), se, se2);
}

template <int D>
cudaError_t launch_templated(const UcvArgs& a, int B, int pairs,
                             cudaStream_t s) {
  ucv_pairs_kernel<D><<<dim3(pairs, B), kThreads, 0, s>>>(a, pairs);
  return cudaGetLastError();
}

cudaError_t launch_pairs(const UcvArgs& a, int B, int d, int pairs,
                         cudaStream_t s) {
  switch (d) {
#define UCV_CASE(D) \
  case D:           \
    return launch_templated<D>(a, B, pairs, s);
    UCV_CASE(1)
    UCV_CASE(2)
    UCV_CASE(3)
    UCV_CASE(4)
    UCV_CASE(5)
    UCV_CASE(6)
    UCV_CASE(7)
    UCV_CASE(8)
    UCV_CASE(9)
    UCV_CASE(10)
    UCV_CASE(11)
    UCV_CASE(12)
    UCV_CASE(13)
    UCV_CASE(14)
    UCV_CASE(15)
    UCV_CASE(16)
#undef UCV_CASE
    default:
      ucv_pairs_wide_kernel<<<dim3(pairs, B), kWideThreads, 0, s>>>(a, pairs,
                                                                    d);
      return cudaGetLastError();
  }
}

// --------------------------------------------------------------- search
struct SearchArgs {
  const float* X;      // (B, N, d) training rows, padded with invalid rows
  const float* valid;  // (B, N) or null: every row counts
  const float* Ns;     // (B,) row counts
  const float* x0;     // (B, nv) starts: vech(L) or diag(L)
  const float* given;  // (B, P, nv) points to evaluate, or null
  int B, N, d, nv, diagonal, max_iter;
  int P;               // > 0: evaluate the given points only
  int Q;               // point slots a lane: max(nv + 1, P + 1)
  int tile, pairs_max;  // rows a tile, tile pairs a point slot
  int shrink_words;     // words of `shrunk`
  // scratch
  float* pts;       // (B, Q, nv) the points of the current evaluation
  float* sim;       // (B, nv + 1, nv) the vertices, by slot
  float* fv;        // (B, nv + 1) their objective values, by slot
  float* xbar;      // (B, nv) the centroid of the best nv vertices
  float* lanef;     // (B, kLaneFloats)
  float* Lrows;     // (B, d, d) L of an exported point
  // (B,) a lane's queue word: its phase's items << 32 | the next to claim
  unsigned long long* queue;
  int* order;        // (B, nv + 1) slots, best first
  int* state;        // (B, kLaneInts)
  unsigned* shrunk;  // bit t: some lane shrank at its iteration t + 1
  int* live;         // (1,) lanes not done
  double* partials;  // (B, Q, pairs_max, 2)
  // results
  float* x_best;    // (B, nv)
  float* f_out;     // (B,) f best; evaluate: (B, P) f at the given points
  float* f_start;   // (B,) the start's score
  int* iters;       // (B,)
  int* evals;       // (1,) batched objective calls, as the plain loop counts
  int* lane_evals;  // (B,) the evaluations each lane's search needed
  float* sums;      // evaluate: (B, P, 2) (s2h, sh) of the given points
  float* white;     // evaluate: (B, P, N, d) their whitened rows, or null
};

__device__ __forceinline__ float* point(const SearchArgs& a, int b, int q) {
  return a.pts + (static_cast<size_t>(b) * a.Q + q) * a.nv;
}
__device__ __forceinline__ double* partials_of(const SearchArgs& a, int b,
                                               int q) {
  return a.partials + 2 * (static_cast<size_t>(b) * a.Q + q) * a.pairs_max;
}
__device__ __forceinline__ float* vertex(const SearchArgs& a, int b,
                                         int slot) {
  return a.sim + (static_cast<size_t>(b) * (a.nv + 1) + slot) * a.nv;
}
__device__ __forceinline__ float* values(const SearchArgs& a, int b) {
  return a.fv + static_cast<size_t>(b) * (a.nv + 1);
}
__device__ __forceinline__ int* order_of(const SearchArgs& a, int b) {
  return a.order + static_cast<size_t>(b) * (a.nv + 1);
}
__device__ __forceinline__ int* state_of(const SearchArgs& a, int b) {
  return a.state + static_cast<size_t>(b) * kLaneInts;
}
__device__ __forceinline__ float* floats_of(const SearchArgs& a, int b) {
  return a.lanef + static_cast<size_t>(b) * kLaneFloats;
}

// The points a phase evaluates; its first sits in slot phase_slot(kind).
__device__ __forceinline__ int phase_points(const SearchArgs& a, int kind) {
  switch (kind) {
    case kStartPoints:
      return a.P > 0 ? a.P + 1 : a.nv + 1;
    case kReflection:
    case kSecondPoint:
      return 1;
    case kShrunk:
      return a.nv;
    default:
      return 0;
  }
}
__device__ __forceinline__ int phase_slot(int kind) {
  return kind == kSecondPoint || kind == kShrunk ? 1 : 0;
}

// The queue word of a phase of `items` work items, none claimed yet.
__device__ __forceinline__ unsigned long long queue_word(int items) {
  return static_cast<unsigned long long>(items) << 32;
}

// A load from device memory that another block may have just written,
// read at the L2 each time (a spin loop's).
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// L[r][c] of the point x: vech(L) (column-major lower triangle) or diag(L).
__device__ __forceinline__ float l_entry(const float* x, int d, int diagonal,
                                         int r, int c) {
  if (r < c) return 0.0f;
  if (diagonal) return r == c ? __ldcg(x + r) : 0.0f;
  return __ldcg(x + c * d - c * (c - 1) / 2 + (r - c));
}

__device__ __forceinline__ float nan_max(float m, float v) {
  return (isnan(m) || v <= m) ? m : v;  // a NaN on either side wins
}

__device__ __forceinline__ float warp_nan_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  }
  return m;
}

// The plain objective's order: ascending, NaN last, ties in place.
__device__ __forceinline__ bool before(float f, float g) {
  return f < g || (isnan(g) && !isnan(f));
}

// The guarded objective: a bad point scores f_start + 1e-7. float32
// throughout, as the plain objective compares.
__device__ __forceinline__ float guarded(float2 raw, float ss, float sd) {
  const float score = raw.x, det = raw.y;
  const bool bad = det <= kMachineTol || det < __fmul_rn(1e-3f, sd) ||
                   det > __fmul_rn(1e3f, sd) || isnan(det) || isnan(score) ||
                   fabsf(score) > __fmul_rn(1e3f, fabsf(ss));
  return bad ? __fadd_rn(ss, 1e-7f) : score;
}

// (score, det) of point q of lane b from its partials, by one warp: the
// pair sums in ucv_reduce_kernel's order, then the plain objective's
// float32 expression. Every lane of the warp gets the result; `sums`,
// when given, gets (s2h, sh) from lane 0.
__device__ __noinline__ float2 evaluate_point(const SearchArgs& a, int b,
                                              int q, float* sums) {
  const int lane = threadIdx.x & 31;
  double sx, sy;
  warp_reduce(partials_of(a, b, q), __ldcg(state_of(a, b) + 2), sx, sy);
  float score = 0.0f, det = 0.0f;
  if (lane == 0) {
    const float* x = point(a, b, q);
    float sumlog = logf(fabsf(l_entry(x, a.d, a.diagonal, 0, 0)));
    for (int k = 1; k < a.d; ++k) {
      sumlog = __fadd_rn(sumlog, logf(fabsf(l_entry(x, a.d, a.diagonal, k,
                                                    k))));
    }
    det = expf(2.0f * sumlog);
    const float lh = -sumlog - static_cast<float>(0.5 * a.d * kLog2Pi);
    const float l2h = lh - static_cast<float>(0.5 * a.d * kLog2);
    const float n = __ldcg(floats_of(a, b) + 5);
    const float s2h = static_cast<float>(sx), sh = static_cast<float>(sy);
    const float e2 = expf(l2h), e1 = expf(lh);
    score = e2 + 2.0f * s2h * e2 / n - 4.0f * sh * e1 / (n - 1.0f);
    if (sums != nullptr) {
      sums[0] = s2h;
      sums[1] = sh;
    }
  }
  return make_float2(__shfl_sync(kFull, score, 0),
                     __shfl_sync(kFull, det, 0));
}

// Whether lane b's simplex has converged: the spreads of its values and
// of its vertices about the best, NaN never converging. One warp.
__device__ __noinline__ bool converged(const SearchArgs& a, int b) {
  const int n = a.nv, lane = threadIdx.x & 31;
  const int* o = order_of(a, b);
  const float* f = values(a, b);
  const int o0 = __ldcg(o);
  const float f0 = __ldcg(f + o0);
  const float* v0 = vertex(a, b, o0);
  float fs = 0.0f, xs = 0.0f;
  for (int k = 1 + lane; k <= n; k += 32) {
    fs = nan_max(fs, fabsf(__ldcg(f + __ldcg(o + k)) - f0));
  }
  for (int e = lane; e < n * n; e += 32) {
    const int k = e / n + 1, j = e % n;
    xs = nan_max(xs, fabsf(__ldcg(vertex(a, b, __ldcg(o + k)) + j) -
                           __ldcg(v0 + j)));
  }
  fs = warp_nan_max(fs);
  xs = warp_nan_max(xs);
  const float* l = floats_of(a, b);
  return fs <= __ldcg(l + 2) && xs <= __ldcg(l + 3);
}

// The centroid of lane b's best n vertices, summed in order, and the
// reflection of its worst through it, into point slot 0. One warp.
__device__ __noinline__ void reflect(const SearchArgs& a, int b) {
  const int n = a.nv, lane = threadIdx.x & 31;
  const int* o = order_of(a, b);
  const float* xw = vertex(a, b, __ldcg(o + n));
  float* xr = point(a, b, 0);
  for (int j = lane; j < n; j += 32) {
    float s = 0.0f;
    for (int k = 0; k < n; ++k) s += __ldcg(vertex(a, b, __ldcg(o + k)) + j);
    const float m = __fdiv_rn(s, static_cast<float>(n));
    a.xbar[static_cast<size_t>(b) * n + j] = m;
    xr[j] = __fadd_rn(m, __fsub_rn(m, __ldcg(xw + j)));
  }
}

// Stable insertion sort of lane b's slots by value, by lane 0.
__device__ __forceinline__ void sort_slots(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31;
  int* o = order_of(a, b);
  const float* f = values(a, b);
  if (lane != 0) return;
  for (int i = 1; i <= a.nv; ++i) {
    const int key = __ldcg(o + i);
    const float fk = __ldcg(f + key);
    int j = i - 1;
    while (j >= 0) {
      const int oj = __ldcg(o + j);
      if (!before(fk, __ldcg(f + oj))) break;
      o[j + 1] = oj;
      --j;
    }
    o[j + 1] = key;
  }
}

// The end of an iteration of lane b: its order, its count, its
// convergence and, if it goes on, its next reflection. Returns the lane's
// next phase: kReflection, or kNoItems when it is done. One warp.
__device__ __noinline__ int finish_iteration(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31;
  int* s = state_of(a, b);
  sort_slots(a, b);
  __syncwarp();
  const int it = __shfl_sync(kFull, lane == 0 ? __ldcg(s + 1) + 1 : 0, 0);
  const bool done = converged(a, b) || it >= a.max_iter;
  __syncwarp();
  if (lane == 0) s[1] = it;
  if (done) return kNoItems;
  reflect(a, b);
  return kReflection;
}

// Lane b's rows (up to its last row that counts or holds a NaN, which the
// plain sums would carry), its point slots, its state and its first
// phase, the start and the simplex (or the given points). One warp.
__device__ __noinline__ void setup_lane(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, n = a.nv;
  int last = -1;
  for (int r = lane; r < a.N; r += 32) {
    const size_t i = static_cast<size_t>(b) * a.N + r;
    bool keep = a.valid == nullptr || a.valid[i] > 0.0f;
    for (int k = 0; k < a.d && !keep; ++k) keep = isnan(a.X[i * a.d + k]);
    if (keep) last = r;
  }
  last = __reduce_max_sync(kFull, last);
  const float* x0 = a.x0 + static_cast<size_t>(b) * n;
  if (a.P > 0) {
    for (int e = lane; e < (a.P + 1) * n; e += 32) {
      const int q = e / n, j = e % n;
      point(a, b, q)[j] =
          q == 0 ? x0[j]
                 : a.given[(static_cast<size_t>(b) * a.P + q - 1) * n + j];
    }
  } else {
    // vertex 0 the start, vertex k + 1 the start with coordinate k moved
    // 5% (0.00025 from 0)
    for (int e = lane; e < (n + 1) * n; e += 32) {
      const int q = e / n, j = e % n;
      const float v = x0[j];
      point(a, b, q)[j] =
          q == j + 1 ? (v != 0.0f ? __fmul_rn(v, 1.05f) : 0.00025f) : v;
    }
  }
  if (lane == 0) {
    const int nt = (last + a.tile) / a.tile;  // tiles up to row `last`
    const int points = phase_points(a, kStartPoints);
    int* s = state_of(a, b);
    s[0] = 0;
    s[1] = 0;
    s[2] = nt;
    s[3] = points;
    s[4] = 0;
    s[5] = kStartPoints;
    floats_of(a, b)[5] = a.Ns[b];
    a.queue[b] = queue_word(points * (nt * (nt + 1) / 2));
  }
}

// After the first evaluation: the start's raw score, the initial simplex
// guarded and ordered, the tolerances, and the first reflection. Returns
// kReflection, or kNoItems when the lane is done at once. One warp.
__device__ __noinline__ int start_lane(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, n = a.nv;
  float* f = values(a, b);
  int* o = order_of(a, b);
  float ss = 0.0f, sd = 0.0f;
  for (int q = 0; q <= n; ++q) {
    const float2 r = evaluate_point(a, b, q, nullptr);
    if (q == 0) {
      ss = r.x;
      sd = r.y;
    }
    const float fq = guarded(r, ss, sd);
    float* v = vertex(a, b, q);
    const float* src = point(a, b, q);
    for (int j = lane; j < n; j += 32) v[j] = __ldcg(src + j);
    if (lane == 0) {
      f[q] = fq;
      o[q] = q;
    }
  }
  float m = 0.0f;
  const float* x0 = a.x0 + static_cast<size_t>(b) * n;
  for (int j = lane; j < n; j += 32) m = nan_max(m, fabsf(x0[j]));
  m = warp_nan_max(m);
  if (lane == 0) {
    float* l = floats_of(a, b);
    l[0] = ss;
    l[1] = sd;
    l[2] = __fadd_rn(__fmul_rn(1e-4f, fabsf(ss)), 1e-12f);
    l[3] = __fadd_rn(__fmul_rn(1e-4f, m), 1e-12f);
  }
  __syncwarp();
  sort_slots(a, b);
  __syncwarp();
  // a lane whose best value is NaN (a NaN start: every value NaN) never
  // converges, and is done at once
  const bool done = isnan(__ldcg(f + __ldcg(o))) || converged(a, b);
  __syncwarp();
  if (done) return kNoItems;
  reflect(a, b);
  return kReflection;
}

// Evaluate mode, after the evaluation: the given points' guarded values,
// pair sums and (when asked) whitened rows. One warp.
__device__ __noinline__ void finish_evaluate(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, d = a.d;
  float ss = 0.0f, sd = 0.0f;
  for (int q = 0; q <= a.P; ++q) {
    const size_t i = static_cast<size_t>(b) * a.P + q - 1;
    const float2 r =
        evaluate_point(a, b, q, q == 0 ? nullptr : a.sums + 2 * i);
    if (q == 0) {
      ss = r.x;
      sd = r.y;
    } else if (lane == 0) {
      a.f_out[i] = guarded(r, ss, sd);
    }
    if (q == 0 || a.white == nullptr) continue;
    float* L = a.Lrows + static_cast<size_t>(b) * d * d;
    __syncwarp();
    for (int e = lane; e < d * d; e += 32) {
      L[e] = l_entry(point(a, b, q), d, a.diagonal, e / d, e % d);
    }
    __syncwarp();
    for (int r = lane; r < a.N; r += 32) {
      const size_t row = static_cast<size_t>(b) * a.N + r;
      whiten_var(a.X + row * d, L, d, a.white + (i * a.N + r) * d, 1);
    }
  }
  if (lane == 0) a.f_start[b] = ss;
}

// After the reflection's evaluation: its guarded value, the step it calls
// for and the second point, in slot 1. Returns whether the second point
// is needed (not when the reflection is kept as it is). One warp.
__device__ __noinline__ bool second_point(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, n = a.nv;
  const float* l = floats_of(a, b);
  const float fr = guarded(evaluate_point(a, b, 0, nullptr), __ldcg(l),
                           __ldcg(l + 1));
  const int* o = order_of(a, b);
  const float* f = values(a, b);
  const int o_best = __ldcg(o), o_next = __ldcg(o + n - 1),
            o_worst = __ldcg(o + n);
  const float f_best = __ldcg(f + o_best), f_next = __ldcg(f + o_next),
              f_worst = __ldcg(f + o_worst);
  const bool best = fr < f_best;
  const bool mid = !best && fr < f_next;
  const bool outside = !best && !mid && fr < f_worst;
  if (!mid) {
    const float* xw = vertex(a, b, o_worst);
    const float* xb = a.xbar + static_cast<size_t>(b) * n;
    float* x2 = point(a, b, 1);
    for (int j = lane; j < n; j += 32) {
      const float m = __ldcg(xb + j), t = __fsub_rn(m, __ldcg(xw + j));
      x2[j] = best      ? __fadd_rn(m, __fmul_rn(2.0f, t))   // expansion
              : outside ? __fadd_rn(m, __fmul_rn(0.5f, t))   // outside
                        : __fsub_rn(m, __fmul_rn(0.5f, t));  // inside
    }
  }
  __syncwarp();
  if (lane == 0) {
    state_of(a, b)[0] =
        (best ? kBest : 0) | (mid ? kMid : 0) | (outside ? kOutside : 0);
    floats_of(a, b)[4] = fr;
  }
  return !mid;
}

// After the second point's evaluation (or a kept reflection): scipy's
// accept rules. The accepted point replaces the worst vertex and the
// iteration ends, or the lane shrinks towards its best vertex, writes its
// n shrunk vertices into slots 1..n and sets the bit of its iteration in
// `shrunk`. Returns the lane's next phase: kReflection, kShrunk, or
// kNoItems when it is done. One warp.
__device__ __noinline__ int accept(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, n = a.nv;
  int* s = state_of(a, b);
  const float* l = floats_of(a, b);
  const int flags = __ldcg(s);
  const bool best = flags & kBest, mid = flags & kMid,
             outside = flags & kOutside;
  const float fr = __ldcg(l + 4);
  float f2 = 0.0f;
  if (!mid) {
    f2 = guarded(evaluate_point(a, b, 1, nullptr), __ldcg(l), __ldcg(l + 1));
  }
  const int* o = order_of(a, b);
  float* f = values(a, b);
  const int worst = __ldcg(o + n);
  const float fw = __ldcg(f + worst);
  const bool take2 = best ? f2 < fr : outside ? f2 <= fr : f2 < fw;
  const bool use_r = mid || (!take2 && best);
  const bool shrink = !best && !mid && (outside ? f2 > fr : f2 >= fw);
  if (!shrink) {
    float* v = vertex(a, b, worst);
    const float* src = point(a, b, use_r ? 0 : 1);
    for (int j = lane; j < n; j += 32) v[j] = __ldcg(src + j);
    if (lane == 0) f[worst] = use_r ? fr : f2;
    __syncwarp();
    return finish_iteration(a, b);
  }
  const float* v0 = vertex(a, b, __ldcg(o));
  for (int e = lane; e < n * n; e += 32) {
    const int k = e / n + 1, j = e % n;
    const float x0 = __ldcg(v0 + j);
    point(a, b, k)[j] = __fadd_rn(
        x0,
        __fmul_rn(0.5f, __fsub_rn(__ldcg(vertex(a, b, __ldcg(o + k)) + j),
                                  x0)));
  }
  if (lane == 0) {
    const int t = __ldcg(s + 1);  // the iteration is t + 1
    atomicOr(a.shrunk + t / 32, 1u << (t % 32));
  }
  return kShrunk;
}

// After the shrunk vertices' evaluation: they take their slots (the best
// vertex stays), and the iteration ends. Returns kReflection, or kNoItems
// when the lane is done. One warp.
__device__ __noinline__ int finish_shrink(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, n = a.nv;
  const float* l = floats_of(a, b);
  const float ss = __ldcg(l), sd = __ldcg(l + 1);
  const int* o = order_of(a, b);
  float* f = values(a, b);
  for (int k = 1; k <= n; ++k) {
    const float fk = guarded(evaluate_point(a, b, k, nullptr), ss, sd);
    const int slot = __ldcg(o + k);
    float* v = vertex(a, b, slot);
    const float* src = point(a, b, k);
    for (int j = lane; j < n; j += 32) v[j] = __ldcg(src + j);
    if (lane == 0) f[slot] = fk;
  }
  __syncwarp();
  return finish_iteration(a, b);
}

__device__ __noinline__ void write_result(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, n = a.nv;
  const int best = __ldcg(order_of(a, b));
  const float* v = vertex(a, b, best);
  for (int j = lane; j < n; j += 32) {
    a.x_best[static_cast<size_t>(b) * n + j] = __ldcg(v + j);
  }
  if (lane == 0) {
    a.f_out[b] = __ldcg(values(a, b) + best);
    a.f_start[b] = __ldcg(floats_of(a, b));
    a.iters[b] = __ldcg(state_of(a, b) + 1);
    a.lane_evals[b] = __ldcg(state_of(a, b) + 3);
  }
}

// The batched objective calls the plain loop would have made, by the warp
// of the last lane to finish: 1 + (n + 1) for the starts and the simplex,
// 2 a round up to the most iterations of any lane, n more for each round
// in which some lane shrank (P + 1 in evaluate mode). One warp.
__device__ __noinline__ void count_evaluations(const SearchArgs& a) {
  const int lane = threadIdx.x & 31;
  int rounds = 0;
  unsigned shrinks = 0;
  for (int b = lane; b < a.B; b += 32) {
    rounds = max(rounds, __ldcg(state_of(a, b) + 1));
  }
  for (int w = lane; w < a.shrink_words; w += 32) {
    shrinks += __popc(__ldcg(a.shrunk + w));
  }
  rounds = __reduce_max_sync(kFull, rounds);
  shrinks = __reduce_add_sync(kFull, shrinks);
  if (lane == 0) {
    *a.evals = a.P > 0 ? a.P + 1
                       : 2 + a.nv + 2 * rounds +
                             a.nv * static_cast<int>(shrinks);
  }
}

// Lane b's step after the points of phase `kind` are evaluated, by one
// warp, and the steps after it while its phases have no items (a lane
// with no rows): publishes the lane's next phase, its points written
// first, or finishes the lane; the last lane to finish counts the
// evaluations.
__device__ __noinline__ void lane_step(const SearchArgs& a, int b,
                                       int kind) {
  const int lane = threadIdx.x & 31;
  __threadfence();  // the phase's partials and the lane's state
  int* s = state_of(a, b);
  const int nt = __ldcg(s + 2), pairs = nt * (nt + 1) / 2;
  int next;
  do {
    if (kind == kStartPoints) {
      if (a.P > 0) {
        finish_evaluate(a, b);
        next = kNoItems;
      } else {
        next = start_lane(a, b);
      }
    } else if (kind == kReflection) {
      if (second_point(a, b)) {
        next = kSecondPoint;
      } else {  // the reflection is kept: its flags to every lane
        __threadfence();
        __syncwarp();
        next = accept(a, b);
      }
    } else if (kind == kSecondPoint) {
      next = accept(a, b);
    } else {
      next = finish_shrink(a, b);
    }
    __threadfence();  // every lane's writes of the step, before it goes on
    __syncwarp();
    if (lane == 0 && next != kNoItems) {
      s[3] = __ldcg(s + 3) + phase_points(a, next);
    }
    kind = next;
  } while (next != kNoItems && pairs == 0);
  if (next != kNoItems) {
    if (lane == 0) {
      s[4] = 0;
      s[5] = next;
      __threadfence();  // the points and the state before the word
      atomicExch(a.queue + b, queue_word(phase_points(a, next) * pairs));
    }
    return;
  }
  if (a.P == 0) write_result(a, b);
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    __threadfence();  // the lane's result before its count
    last = atomicSub(a.live, 1) == 1;
  }
  if (__shfl_sync(kFull, last, 0)) {
    __threadfence();  // every lane's state, as each left it
    count_evaluations(a);
  }
}

// The fixed width: the thread's rows t = threadIdx.x + r kThreads, r < R,
// of rows base .. base + kTile - 1 of lane b, loaded all at once into
// registers (those past the last row are not read) ...
template <int D>
__device__ __forceinline__ void load_rows(const SearchArgs& a, int b, int base,
                                          float (&x)[kRowsPerThread][D]) {
  const float* src = a.X + (static_cast<size_t>(b) * a.N + base) * D;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int t = threadIdx.x + r * kThreads;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      x[r][k] = base + t < a.N ? src[static_cast<size_t>(t) * D + k] : 0.0f;
    }
  }
}

// ... then whitened by L (shared, D x D) into tile[k * kTile + t], those
// past the last row left as they are.
template <int D>
__device__ __forceinline__ void whiten_rows(const SearchArgs& a, int base,
                                            const float* L,
                                            const float (&x)[kRowsPerThread][D],
                                            float* tile) {
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int t = threadIdx.x + r * kThreads;
    if (base + t >= a.N) continue;
    float w[D];
    whiten_fixed<D>(x[r], L, w);
#pragma unroll
    for (int k = 0; k < D; ++k) tile[k * kTile + t] = w[k];
  }
}

// Any width: rows base .. base + kWideTile - 1 of lane b whitened by L
// into tile[k * kWideTile + t], one row a thread.
__device__ __forceinline__ void whiten_wide(const SearchArgs& a, int b,
                                            int base, const float* L,
                                            float* tile) {
  const int t = threadIdx.x;
  if (base + t >= a.N) return;
  const size_t row = static_cast<size_t>(b) * a.N + base + t;
  whiten_var(a.X + row * a.d, L, a.d, tile + t, kWideTile);
}

// Work item (lane b, point slot q, tile pair p) of a lane of nt tiles: the
// point's L, the item's row tile and column tile whitened into shared
// memory (dynamic: L, then the two tiles), their pair sums by the pair
// kernel's tile body and the partial. Not inlined: the tile body keeps the
// registers and the code of the pair kernel's own, apart from the
// search's work queue around it.
template <int D>
__device__ __noinline__ void tile_item(const SearchArgs& a, int b, int q,
                                       int p, int nt) {
  constexpr int NT = D > 0 ? kThreads : kWideThreads;
  constexpr int T = D > 0 ? kTile : kWideTile;
  __shared__ __align__(16) float s_col[D > 0 ? (D + 1) * kTile
                                             : kWideChunk * kWideGroup];
  __shared__ float s_row[D > 0 ? 1 : kWideChunk * kWideTile];
  __shared__ int s_first;
  extern __shared__ __align__(16) float s_dyn[];
  float* L = s_dyn;
  float* rows = s_dyn + a.d * a.d;
  float* cols = rows + a.d * T;

  const float* x = point(a, b, q);
  int ti, tj;
  tile_pair(p, nt, ti, tj);
  // a diagonal item's column tile is its row tile, whitened once
  const float* col_rows = ti == tj ? rows : cols;
  __syncthreads();  // the previous item's shared memory is read
  if constexpr (D > 0) {
    // the rows' loads in flight with the point's (up to 8 columns both
    // tiles' at once, wider the column tile's after the row tile)
    constexpr bool kBoth = D <= 8;
    float xr[kRowsPerThread][D], xc[kRowsPerThread][D];
    load_rows<D>(a, b, ti * T, xr);
    if (kBoth && ti != tj) load_rows<D>(a, b, tj * T, xc);
    for (int e = threadIdx.x; e < D * D; e += NT) {
      L[e] = l_entry(x, D, a.diagonal, e / D, e % D);
    }
    __syncthreads();
    whiten_rows<D>(a, ti * T, L, xr, rows);
    if (ti != tj) {
      if (!kBoth) load_rows<D>(a, b, tj * T, xc);
      whiten_rows<D>(a, tj * T, L, xc, cols);
    }
  } else {
    for (int e = threadIdx.x; e < a.d * a.d; e += NT) {
      L[e] = l_entry(x, a.d, a.diagonal, e / a.d, e % a.d);
    }
    __syncthreads();
    whiten_wide(a, b, ti * T, L, rows);
    if (ti != tj) whiten_wide(a, b, tj * T, L, cols);
  }
  __syncthreads();
  const SharedTile<T> row_tile{rows, a.valid, a.N, ti * T};
  const SharedTile<T> col_tile{col_rows, a.valid, a.N, tj * T};
  float se, se2;
  if constexpr (D > 0) {
    pair_tile<D>(row_tile, col_tile, b, ti, tj, s_col, &s_first, se, se2);
  } else {
    pair_tile_wide(row_tile, col_tile, b, ti, tj, a.d, s_row, s_col, se,
                   se2);
  }
  write_partial<NT>(partials_of(a, b, q) + 2 * p, se, se2);
}

// One work item for the block, claimed by warp 0: it reads the queue
// words of the lanes from `start` on, 32 at a time, and claims an item of
// the first lane whose phase has one left with one atomicAdd on the word
// (whose old value may show that the phase ran out meanwhile, or that the
// lane moved on to a new phase: then the item is of that phase). Returns
// (lane, item, items of the phase), or lane -1 when none is left.
__device__ __forceinline__ int3 claim_item(const SearchArgs& a, int start) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < a.B; base += 32) {
    int b = start + base + lane;
    if (b >= a.B) b -= a.B;
    bool open = false;
    if (base + lane < a.B) {
      const unsigned long long w = load_relaxed(a.queue + b);
      open = static_cast<unsigned>(w) < static_cast<unsigned>(w >> 32);
    }
    for (unsigned m = __ballot_sync(kFull, open); m != 0; m &= m - 1) {
      const int src = __ffs(m) - 1;
      int3 got = make_int3(-1, 0, 0);
      if (lane == src) {
        const unsigned long long w = atomicAdd(a.queue + b, 1ull);
        const unsigned item = static_cast<unsigned>(w);
        const unsigned items = static_cast<unsigned>(w >> 32);
        if (item < items) {
          got = make_int3(b, static_cast<int>(item), static_cast<int>(items));
        }
      }
      got.x = __shfl_sync(kFull, got.x, src);
      got.y = __shfl_sync(kFull, got.y, src);
      got.z = __shfl_sync(kFull, got.z, src);
      if (got.x >= 0) return got;
    }
  }
  return make_int3(-1, 0, 0);
}

// The block's share of the search: claim an item, evaluate it, count it
// done, and run the lane's step when it was the phase's last; sleep while
// no item is left; leave when no lane is live.
template <int D>
__device__ void run_lanes(const SearchArgs& a) {
  __shared__ int3 s_item;
  __shared__ int s_kind, s_last;
  const bool lead = threadIdx.x < 32;
  const int start = static_cast<int>(blockIdx.x % a.B);
  unsigned nap = 0;
  for (;;) {
    if (lead) {
      int3 got = claim_item(a, start);
      if (got.x >= 0) {
        nap = 0;
        __threadfence();  // the phase's points and kind, as published
        if (threadIdx.x == 0) s_kind = __ldcg(state_of(a, got.x) + 5);
      } else if (load_relaxed(a.live) == 0) {
        got.x = -2;  // every lane is done
      } else {
        nap = nap == 0 ? kNapMin : min(2 * nap, kNapMax);
        __nanosleep(nap);
      }
      if (threadIdx.x == 0) s_item = got;
    }
    __syncthreads();
    const int3 item = s_item;
    const int kind = s_kind;
    __syncthreads();  // read before warp 0 claims again
    if (item.x == -2) return;
    if (item.x < 0) continue;
    const int b = item.x;
    const int nt = __ldcg(state_of(a, b) + 2), pairs = nt * (nt + 1) / 2;
    tile_item<D>(a, b, phase_slot(kind) + item.y / pairs, item.y % pairs, nt);
    if (threadIdx.x == 0) {
      __threadfence();  // the partial before its count
      s_last = atomicAdd(state_of(a, b) + 4, 1) + 1 == item.z;
    }
    __syncthreads();
    if (s_last && lead) lane_step(a, b, kind);
  }
}

// The whole search (or, with P > 0, one evaluation of the given points):
// the lanes set up, one grid barrier, then the work queue until every
// lane is done.
template <int D>
__global__ void __launch_bounds__(D > 0 ? kThreads : kWideThreads,
                                  kSearchBlocksPerSm<D>)
    ucv_search_kernel(const SearchArgs a) {
  constexpr int NT = D > 0 ? kThreads : kWideThreads;
  const int warps = gridDim.x * (NT / 32);
  const int gw = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  for (int b = gw; b < a.B; b += warps) setup_lane(a, b);
  for (int w = blockIdx.x * NT + threadIdx.x; w < a.shrink_words;
       w += gridDim.x * NT) {
    a.shrunk[w] = 0u;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.live = a.B;
  cg::this_grid().sync();
  // a lane with no rows has no items: its steps run at once
  for (int b = gw; b < a.B; b += warps) {
    if (__ldcg(state_of(a, b) + 2) == 0) lane_step(a, b, kStartPoints);
  }
  run_lanes<D>(a);
}

struct SearchShape {
  int nv, Q, tile, pairs_max, shrink_words;
  long long floats, ints, doubles;
};

// The scratch a search of these sizes takes; false when they are out of
// range.
bool search_shape(int B, int N, int d, int diagonal, int P, int max_iter,
                  SearchShape& s) {
  if (B < 1 || N < 0 || d < 1 || P < 0) return false;
  const long long nv = diagonal ? d : static_cast<long long>(d) * (d + 1) / 2;
  const long long Q = nv + 1 > P + 1 ? nv + 1 : P + 1;
  s.tile = d <= kMaxTemplated ? kTile : kWideTile;
  const long long nt = (static_cast<long long>(N) + s.tile - 1) / s.tile;
  const long long pairs = nt * (nt + 1) / 2;
  if (nv * (nv + 1) > (1ll << 30) || pairs * Q > (1ll << 31) - 1) {
    return false;
  }
  s.nv = static_cast<int>(nv);
  s.Q = static_cast<int>(Q);
  s.pairs_max = static_cast<int>(pairs);
  s.shrink_words = ((max_iter > 1 ? max_iter : 1) - 1) / 32 + 1;
  s.floats = B * (Q * nv + (nv + 1) * nv + (nv + 1) + nv + kLaneFloats +
                  static_cast<long long>(d) * d);
  // the queue words (two ints each) first, 8-byte aligned
  s.ints = 2ll * B + B * ((nv + 1) + kLaneInts) + s.shrink_words + 1;
  s.doubles = 2 * B * Q * pairs;
  return true;
}

template <int D>
cudaError_t launch_search(const SearchArgs& a, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&ucv_search_kernel<D>);
  const int threads = D > 0 ? kThreads : kWideThreads;
  int dev = 0, cooperative = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                               dev);
  if (err != cudaSuccess) return err;
  if (!cooperative) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // dynamic shared memory: L and the two whitened tiles
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(a.d) * a.d +
                       2 * static_cast<size_t>(a.d) * a.tile);
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  if (smem + attr.sharedSizeBytes > static_cast<size_t>(optin)) {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  SearchArgs args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(fn, dim3(per_sm * sms), dim3(threads),
                                     params, smem, stream);
}

cudaError_t launch_search_width(const SearchArgs& a, cudaStream_t s) {
  switch (a.d) {
#define UCV_CASE(D) \
  case D:           \
    return launch_search<D>(a, s);
    UCV_CASE(1)
    UCV_CASE(2)
    UCV_CASE(3)
    UCV_CASE(4)
    UCV_CASE(5)
    UCV_CASE(6)
    UCV_CASE(7)
    UCV_CASE(8)
    UCV_CASE(9)
    UCV_CASE(10)
    UCV_CASE(11)
    UCV_CASE(12)
    UCV_CASE(13)
    UCV_CASE(14)
    UCV_CASE(15)
    UCV_CASE(16)
#undef UCV_CASE
    default:
      return launch_search<0>(a, s);
  }
}

}  // namespace

// Rows per tile for problems of width d: the caller sizes `partials` with
// it, (B, nt (nt + 1) / 2, 2) float64 for nt = ceil(N / tile).
extern "C" int ucv_pair_sums_tile(int d) {
  return d <= kMaxTemplated ? kTile : kWideTile;
}

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// the CUDA error code of the two launches: 0 on success. Allocates
// nothing. All arrays are contiguous on the current device: white (B, N,
// d) float32, valid (B, N) float32 or null (every row counts), partials
// (B, pairs, 2) float64 scratch, out (B, 2) float32 (s2h, sh) per problem.
// 1 <= B <= 65535, N >= 0, d >= 1, pairs = nt (nt + 1) / 2 for nt =
// ceil(N / ucv_pair_sums_tile(d)); anything else returns
// cudaErrorInvalidValue.
extern "C" int ucv_pair_sums_f32(const float* white, const float* valid,
                                 double* partials, float* out, int B, int N,
                                 int d, int pairs, void* stream) {
  if (B < 1 || B > 65535 || N < 0 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = ucv_pair_sums_tile(d);
  const long long nt = (static_cast<long long>(N) + tile - 1) / tile;
  if (nt * (nt + 1) / 2 != pairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const UcvArgs a{white, valid, partials, N, static_cast<int>(nt)};
  if (pairs > 0) {
    const cudaError_t err = launch_pairs(a, B, d, pairs, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ucv_reduce_kernel<<<B, kReduceThreads, 0, s>>>(
      partials, out, static_cast<int>(nt), pairs);
  return static_cast<int>(cudaGetLastError());
}

// The scratch of a ucv_search_f32 call, written to sizes[0..2]: float32,
// int32 and float64 elements. Returns 0, or cudaErrorInvalidValue when the
// sizes are out of range.
extern "C" int ucv_search_scratch(int B, int N, int d, int diagonal, int P,
                                  int max_iter, long long* sizes) {
  SearchShape s;
  if (!search_shape(B, N, d, diagonal, P, max_iter, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sizes[0] = s.floats;
  sizes[1] = s.ints;
  sizes[2] = s.doubles;
  return 0;
}

// The whole UCV bandwidth search of B problems in one cooperative launch
// on `stream`, without synchronising; returns the CUDA error code of the
// launch: 0 on success, cudaErrorCooperativeLaunchTooLarge or
// cudaErrorNotSupported when the card cannot hold the grid, and
// cudaErrorInvalidValue for sizes out of range. Allocates nothing. All
// arrays are contiguous float32 (int32 where named) on the current device:
// X (B, N, d) training rows, valid (B, N) or null, Ns (B,) row counts, x0
// (B, nv) starts (nv = d with `diagonal`, else d (d + 1) / 2: vech of the
// lower-triangular L), scratch as ucv_search_scratch sizes it (fscratch,
// iscratch int32 and 8-byte aligned, partials float64); results x_best
// (B, nv), f_out (B,), f_start (B,), iters int32 (B,), evals int32 (1,),
// lane_evals int32 (B,).
// With P > 0 the launch evaluates the given points (B, P, nv) instead:
// f_out (B, P) their guarded objective values, sums (B, P, 2) their pair
// sums, white (B, P, N, d) their whitened rows unless null.
extern "C" int ucv_search_f32(const float* X, const float* valid,
                              const float* Ns, const float* x0,
                              const float* given, int B, int N, int d,
                              int diagonal, int max_iter, int P,
                              float* fscratch, int* iscratch,
                              double* partials, float* x_best, float* f_out,
                              float* f_start, int* iters, int* evals,
                              int* lane_evals, float* sums, float* white,
                              void* stream) {
  SearchShape s;
  if (!search_shape(B, N, d, diagonal, P, max_iter, s) ||
      (P > 0) != (given != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SearchArgs a{};
  a.X = X;
  a.valid = valid;
  a.Ns = Ns;
  a.x0 = x0;
  a.given = given;
  a.B = B;
  a.N = N;
  a.d = d;
  a.nv = s.nv;
  a.diagonal = diagonal ? 1 : 0;
  a.max_iter = max_iter;
  a.P = P;
  a.Q = s.Q;
  a.tile = s.tile;
  a.pairs_max = s.pairs_max;
  a.shrink_words = s.shrink_words;
  const long long nv = s.nv;
  float* f = fscratch;
  a.pts = f;
  f += B * s.Q * nv;
  a.sim = f;
  f += B * (nv + 1) * nv;
  a.fv = f;
  f += B * (nv + 1);
  a.xbar = f;
  f += B * nv;
  a.lanef = f;
  f += static_cast<long long>(B) * kLaneFloats;
  a.Lrows = f;
  a.queue = reinterpret_cast<unsigned long long*>(iscratch);
  a.order = iscratch + 2ll * B;
  a.state = a.order + B * (nv + 1);
  a.shrunk = reinterpret_cast<unsigned*>(a.state + static_cast<long long>(B) *
                                                       kLaneInts);
  a.live = reinterpret_cast<int*>(a.shrunk + s.shrink_words);
  a.partials = partials;
  a.x_best = x_best;
  a.f_out = f_out;
  a.f_start = f_start;
  a.iters = iters;
  a.evals = evals;
  a.lane_evals = lane_evals;
  a.sums = sums;
  a.white = white;
  return static_cast<int>(
      launch_search_width(a, static_cast<cudaStream_t>(stream)));
}
