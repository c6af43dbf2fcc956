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
//   it computes keeps the pairs i < j, the others multiplied by 0, which
//   keeps a NaN, as the plain version's mask does.
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
// grid is the co-resident block count) and meet at grid-wide barriers.
// The JAX package runs that search as one jitted `lax.while_loop` for the
// same reason: a dispatch per evaluation would set the pace. Per
// iteration, for the lanes (problems) still searching:
//
//   (a) every block walks (lane, point, tile pair) work items: it builds L
//       from the point (vech(L) or diag(L)) in shared memory, whitens its
//       row tile and column tile into shared memory by forward
//       substitution (d^2 FMAs a row against 256 d a row's pairs) and
//       writes the tile's float64 partial, with the pair kernel's own tile
//       body reading the whitened tiles;
//   (b) one warp per lane sums the reflection's partials in the pair
//       kernel's fixed order (the same bits as ucv_pair_sums_f32 on those
//       whitened rows), forms the score and the guards in float32 as the
//       plain objective does, and writes the second point (expansion or a
//       contraction; none when the reflection is kept);
//   (c) the second point's tiles; (d) one warp per lane takes the accept
//       rule, and a lane that shrinks writes its n shrunk vertices;
//   (e) only when some lane shrinks: their tiles, then their values;
//   (f) one warp per lane orders its n + 1 vertices by a stable insertion
//       sort of slot indices (the vertices stay in their slots), counts
//       the iteration and tests convergence; the grid stops when every
//       lane is done, which each block reads from the lanes' flags.
//
// A lane that has converged, or reached max_iter, costs nothing more; a
// lane whose start scores NaN is done before the first iteration. Work
// items come from a lane's own rows (up to its last valid row), whose
// extra tiles in a padded batch would add only exact zeros, so a lane's
// result is the same bits alone and in any batch. No atomic anywhere: the
// flags and the evaluation count are written by one thread each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

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
constexpr float kScale = 0.60056120439322491f;  // sqrt(log2(e) / 4)
constexpr float kFar = 1e30f;  // coordinate 0 of an invalid row, signed

// the search
constexpr double kLog2Pi = 1.8378770664093454836;  // log(2 pi)
constexpr double kLog2 = 0.69314718055994530942;
// MACHINE_TOL of the port (4 float64 epsilons), compared in float32 as the
// plain objective compares it
constexpr float kMachineTol = static_cast<float>(2.220446049250313e-16 * 4);
constexpr int kDone = 1, kBest = 2, kMid = 4, kOutside = 8, kShrink = 16;
constexpr int kLaneInts = 4;    // flags, iterations, tiles, unused
constexpr int kLaneFloats = 8;  // f start, det start, fatol, xatol, f of
                                // the reflection, N, unused
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
    if (DIAG && !(row < j0 + t)) e *= 0.0f;  // keeps a NaN
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
// triangle): each row tile ti = t, t + kReduceThreads, ... over its column
// tiles in order, those row sums in order of ti.
__device__ __forceinline__ void thread_sums(const double* part, int nt, int t,
                                            double& x, double& y) {
  x = 0.0;
  y = 0.0;
  for (int ti = t; ti < nt; ti += kReduceThreads) {
    const double* row =
        part + 2 * (static_cast<long long>(ti) * nt -
                    static_cast<long long>(ti) * (ti - 1) / 2);
    double rx = 0.0, ry = 0.0;
#pragma unroll 4
    for (int tj = 0; tj < nt - ti; ++tj) {
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
// ends with the sums.
__device__ __forceinline__ void warp_reduce(const double* part, int nt,
                                            double& sx, double& sy) {
  const int lane = threadIdx.x & 31;
  sx = 0.0;
  sy = 0.0;
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
  // scratch
  float* pts;       // (B, Q, nv) the points of the current evaluation
  float* sim;       // (B, nv + 1, nv) the vertices, by slot
  float* fv;        // (B, nv + 1) their objective values, by slot
  float* xbar;      // (B, nv) the centroid of the best nv vertices
  float* lanef;     // (B, kLaneFloats)
  float* Lrows;     // (B, d, d) L of an exported point
  int* order;       // (B, nv + 1) slots, best first
  int* state;       // (B, kLaneInts)
  double* partials;  // (B, Q, pairs_max, 2)
  // results
  float* x_best;   // (B, nv)
  float* f_out;    // (B,) f best; evaluate: (B, P) f at the given points
  float* f_start;  // (B,) the start's score
  int* iters;      // (B,)
  int* evals;      // (1,) batched objective calls, as the plain loop counts
  float* sums;     // evaluate: (B, P, 2) (s2h, sh) of the given points
  float* white;    // evaluate: (B, P, N, d) their whitened rows, or null
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
  int* o = order_of(a, b);
  const float* f = values(a, b);
  for (int i = 1; i <= a.nv; ++i) {
    const int key = o[i];
    const float fk = f[key];
    int j = i - 1;
    while (j >= 0) {
      const int oj = o[j];
      if (!before(fk, f[oj])) break;
      o[j + 1] = oj;
      --j;
    }
    o[j + 1] = key;
  }
}

// The end of an iteration of lane b: its order, its count, its
// convergence and, if it goes on, its next reflection. One warp.
__device__ __noinline__ void finish_iteration(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31;
  int* s = state_of(a, b);
  if (lane == 0) sort_slots(a, b);
  __syncwarp();
  const int it = __shfl_sync(kFull, lane == 0 ? s[1] + 1 : 0, 0);
  const bool done = converged(a, b) || it >= a.max_iter;
  __syncwarp();
  if (lane == 0) {
    s[1] = it;
    s[0] = done ? kDone : 0;
  }
  if (!done) reflect(a, b);
}

// Lane b's rows (up to its last row that counts or holds a NaN, which the
// plain sums would carry), its point slots and its state. One warp.
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
    int* s = state_of(a, b);
    s[0] = 0;
    s[1] = 0;
    s[2] = (last + a.tile) / a.tile;  // tiles up to row `last`
    s[3] = 0;
    floats_of(a, b)[5] = a.Ns[b];
  }
}

// After the first evaluation: the start's raw score, the initial simplex
// guarded and ordered, the tolerances, and the first reflection. One warp.
__device__ __noinline__ void start_lane(const SearchArgs& a, int b) {
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
    sort_slots(a, b);
  }
  __syncwarp();
  // a lane whose best value is NaN (a NaN start: every value NaN) never
  // converges, and is done at once
  const bool done = isnan(__ldcg(f + __ldcg(o))) || converged(a, b);
  __syncwarp();
  if (lane == 0) state_of(a, b)[0] = done ? kDone : 0;
  if (!done) reflect(a, b);
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
// for and the second point, in slot 1 (none when the reflection is kept
// as it is). One warp.
__device__ __noinline__ void second_point(const SearchArgs& a, int b) {
  const int lane = threadIdx.x & 31, n = a.nv;
  const float* l = floats_of(a, b);
  const float fr = guarded(evaluate_point(a, b, 0, nullptr), __ldcg(l),
                           __ldcg(l + 1));
  const int* o = order_of(a, b);
  const float* f = values(a, b);
  const bool best = fr < __ldcg(f + __ldcg(o));
  const bool mid = !best && fr < __ldcg(f + __ldcg(o + n - 1));
  const bool outside = !best && !mid && fr < __ldcg(f + __ldcg(o + n));
  if (!mid) {
    const float* xw = vertex(a, b, __ldcg(o + n));
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
}

// After the second point's evaluation: scipy's accept rules. The accepted
// point replaces the worst vertex and the iteration ends, or the lane
// shrinks towards its best vertex and writes its n shrunk vertices into
// slots 1..n. One warp.
__device__ __noinline__ void accept(const SearchArgs& a, int b) {
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
    finish_iteration(a, b);
    return;
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
  __syncwarp();
  if (lane == 0) s[0] = flags | kShrink;
}

// After the shrunk vertices' evaluation: they take their slots (the best
// vertex stays), and the iteration ends. One warp.
__device__ __noinline__ void finish_shrink(const SearchArgs& a, int b) {
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
  finish_iteration(a, b);
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
  }
}

// Whether some lane's flags masked by `mask` equal `want`: the same answer
// in every block, read after a grid barrier.
__device__ __forceinline__ bool any_lane(const SearchArgs& a, int mask,
                                         int want) {
  int found = 0;
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    found |= (__ldcg(state_of(a, b)) & mask) == want;
  }
  return __syncthreads_or(found);
}

// The next work item at or after w of this block (w, w + G, ...) that
// lies at or past `to`.
__device__ __forceinline__ long long skip_to(long long w, long long to) {
  const long long G = gridDim.x;
  return w + (to - w + G - 1) / G * G;
}

// Rows base .. base + T - 1 of lane b whitened by L (shared, d x d) into
// tile[k * T + t], those past the last row left as they are: one row a
// thread at a time, the fixed width in registers.
template <int D, int T>
__device__ __forceinline__ void whiten_tile(const SearchArgs& a, int b,
                                            int base, const float* L,
                                            float* tile) {
  constexpr int NT = D > 0 ? kThreads : kWideThreads;
  const size_t first = static_cast<size_t>(b) * a.N + base;
#pragma unroll 1
  for (int t = threadIdx.x; t < T && base + t < a.N; t += NT) {
    const float* x = a.X + (first + t) * a.d;
    if constexpr (D > 0) {
      float w[D];
      whiten_fixed<D>(x, L, w);
#pragma unroll
      for (int k = 0; k < D; ++k) tile[k * T + t] = w[k];
    } else {
      whiten_var(x, L, a.d, tile + t, T);
    }
  }
}

// Work item (lane b, point slot q, tile pair p) of a lane of nt tiles: the
// point's L, the item's row tile and column tile whitened into shared
// memory, their pair sums by the pair kernel's tile body and the partial.
// Not inlined: the tile body keeps the registers and the code of the pair
// kernel's own, apart from the search's phases around it.
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
  __syncthreads();  // the previous item's shared memory is read
  for (int e = threadIdx.x; e < a.d * a.d; e += NT) {
    L[e] = l_entry(x, a.d, a.diagonal, e / a.d, e % a.d);
  }
  __syncthreads();
  whiten_tile<D, T>(a, b, ti * T, L, rows);
  whiten_tile<D, T>(a, b, tj * T, L, cols);
  __syncthreads();
  const SharedTile<T> row_tile{rows, a.valid, a.N, ti * T};
  const SharedTile<T> col_tile{cols, a.valid, a.N, tj * T};
  float se, se2;
  if constexpr (D > 0) {
    pair_tile<D>(row_tile, col_tile, b, ti, tj, s_col, &s_first, se, se2);
  } else {
    pair_tile_wide(row_tile, col_tile, b, ti, tj, a.d, s_row, s_col, se,
                   se2);
  }
  write_partial<NT>(partials_of(a, b, q) + 2 * p, se, se2);
}

// The tiles of `count` point slots from q0 of every lane whose flags
// masked by `mask` equal `want`: one work item a (lane, slot, tile pair),
// walked by the blocks in turn. A block builds the point's L, whitens the
// item's row tile and column tile into shared memory (dynamic: L, then
// the two tiles), sums the tile pair with the pair kernel's tile body
// and writes its partial.
template <int D>
__device__ void evaluate_tiles(const SearchArgs& a, int q0, int count,
                               int mask, int want) {
  const long long per_lane = static_cast<long long>(count) * a.pairs_max;
  const long long total = per_lane * a.B;
  long long w = blockIdx.x;
  while (w < total) {
    const int b = static_cast<int>(w / per_lane);
    const long long rem = w - b * per_lane;
    const int qi = static_cast<int>(rem / a.pairs_max);
    const int p = static_cast<int>(rem - static_cast<long long>(qi) *
                                             a.pairs_max);
    const int* s = state_of(a, b);
    if ((__ldcg(s) & mask) != want) {
      w = skip_to(w, (b + 1) * per_lane);
      continue;
    }
    const int nt = __ldcg(s + 2);
    if (p >= nt * (nt + 1) / 2) {
      w = skip_to(w, b * per_lane + static_cast<long long>(qi + 1) *
                                        a.pairs_max);
      continue;
    }
    tile_item<D>(a, b, q0 + qi, p, nt);
    w += gridDim.x;
  }
}

// The whole search (or, with P > 0, one evaluation of the given points):
// every block runs the same phases, a grid barrier between phases.
template <int D>
__global__ void __launch_bounds__(D > 0 ? kThreads : kWideThreads)
    ucv_search_kernel(const SearchArgs a) {
  constexpr int NT = D > 0 ? kThreads : kWideThreads;
  cg::grid_group grid = cg::this_grid();
  const int warps = gridDim.x * (NT / 32);
  const int gw = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;

  for (int b = gw; b < a.B; b += warps) setup_lane(a, b);
  grid.sync();
  // the start (vertex 0) and the initial simplex, or the given points
  const int points = a.P > 0 ? a.P + 1 : a.nv + 1;
  evaluate_tiles<D>(a, 0, points, 0, 0);
  grid.sync();
  if (a.P > 0) {
    for (int b = gw; b < a.B; b += warps) finish_evaluate(a, b);
    if (first) *a.evals = points;
    return;
  }
  for (int b = gw; b < a.B; b += warps) start_lane(a, b);
  if (first) *a.evals = 1 + points;  // the start, then the simplex
  grid.sync();
  while (any_lane(a, kDone, 0)) {
    if (first) *a.evals += 2;
    evaluate_tiles<D>(a, 0, 1, kDone, 0);  // the reflections
    grid.sync();
    for (int b = gw; b < a.B; b += warps) {
      if (!(__ldcg(state_of(a, b)) & kDone)) second_point(a, b);
    }
    grid.sync();
    evaluate_tiles<D>(a, 1, 1, kDone | kMid, 0);
    grid.sync();
    for (int b = gw; b < a.B; b += warps) {
      if (!(__ldcg(state_of(a, b)) & kDone)) accept(a, b);
    }
    grid.sync();
    if (any_lane(a, kShrink, kShrink)) {
      if (first) *a.evals += a.nv;
      evaluate_tiles<D>(a, 1, a.nv, kShrink, kShrink);
      grid.sync();
      for (int b = gw; b < a.B; b += warps) {
        if (__ldcg(state_of(a, b)) & kShrink) finish_shrink(a, b);
      }
      grid.sync();
    }
  }
  for (int b = gw; b < a.B; b += warps) write_result(a, b);
}

struct SearchShape {
  int nv, Q, tile, pairs_max;
  long long floats, ints, doubles;
};

// The scratch a search of these sizes takes; false when they are out of
// range.
bool search_shape(int B, int N, int d, int diagonal, int P,
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
  s.floats = B * (Q * nv + (nv + 1) * nv + (nv + 1) + nv + kLaneFloats +
                  static_cast<long long>(d) * d);
  s.ints = B * ((nv + 1) + kLaneInts);
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
                                  long long* sizes) {
  SearchShape s;
  if (!search_shape(B, N, d, diagonal, P, s)) {
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
// iscratch int32, partials float64); results x_best (B, nv), f_out (B,),
// f_start (B,), iters int32 (B,), evals int32 (1,).
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
                              float* sums, float* white, void* stream) {
  SearchShape s;
  if (!search_shape(B, N, d, diagonal, P, s) || (P > 0) != (given != nullptr)) {
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
  a.order = iscratch;
  a.state = iscratch + B * (nv + 1);
  a.partials = partials;
  a.x_best = x_best;
  a.f_out = f_out;
  a.f_start = f_start;
  a.iters = iters;
  a.evals = evals;
  a.sums = sums;
  a.white = white;
  return static_cast<int>(
      launch_search_width(a, static_cast<cudaStream_t>(stream)));
}
