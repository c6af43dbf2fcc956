// The pair sums of the UCV (unbiased cross-validation) bandwidth objective
// for NVIDIA Hopper (sm_90a).
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

#include <cuda_runtime.h>

#include <math.h>

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct UcvArgs {
  const float* white;  // (B, N, d) whitened rows
  const float* valid;  // (B, N), > 0 for a row that counts; null: all count
  double* partials;    // (B, pairs, 2) per tile pair (s2h, sh)
  int N, nt;           // rows, tiles
};

// Coordinate k of row `row` of problem b, scaled; an invalid or padding
// row has coordinate 0 at `far` unless it is NaN.
__device__ __forceinline__ float staged(const UcvArgs& a, int b, int row,
                                        int k, int d, float far) {
  if (row >= a.N) return k == 0 ? far : 0.0f;
  const size_t r = static_cast<size_t>(b) * a.N + row;
  const float v = kScale * a.white[r * d + k];
  if (k == 0 && a.valid != nullptr && !(a.valid[r] > 0.0f) && !isnan(v)) {
    return far;
  }
  return v;
}

// Coordinate k of row `row` of problem b, less the block's origin, scaled;
// an invalid or padding row is (far, 0, ..., 0), but a NaN coordinate is
// kept.
__device__ __forceinline__ float moved(const UcvArgs& a, int b, int row,
                                       int k, int d, float far,
                                       float origin) {
  if (row >= a.N) return k == 0 ? far : 0.0f;
  const size_t r = static_cast<size_t>(b) * a.N + row;
  const float x = a.white[r * d + k];
  if (isnan(x)) return x;
  if (a.valid != nullptr && !(a.valid[r] > 0.0f)) return k == 0 ? far : 0.0f;
  return kScale * (x - origin);
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
// and writes the block's partial.
template <int NT>
__device__ __forceinline__ void write_partial(const UcvArgs& a, int b,
                                              long long p, int pairs,
                                              float se, float se2) {
  __shared__ double s_warp[2][NT / 32];
  double x = se, y = se2;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
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
    double* out = a.partials + 2 * (static_cast<size_t>(b) * pairs + p);
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

// Grid (pairs, B). Thread t holds rows ti * kTile + t * R + r, r < R.
template <int D>
__global__ void __launch_bounds__(kThreads)
    ucv_pairs_kernel(const UcvArgs a, int pairs) {
  constexpr int R = kRowsPerThread;
  static_assert(kTile == kThreads * R, "a tile is a block's rows");
  static_assert(kTile % kGroup == 0 && kWarpRows % kGroup == 0,
                "a tile and a warp's rows hold whole groups");
  // D coordinates, then the biases b_j, of the column tile's rows
  __shared__ __align__(16) float s_col[(D + 1) * kTile];
  __shared__ int s_first;  // the row tile's first valid row

  const int b = blockIdx.y;
  const long long p = blockIdx.x;
  int ti, tj;
  tile_pair(p, a.nt, ti, tj);

  // the block's origin: the first valid row of tile ti (0 when it has none)
  const int row0 = threadIdx.x * R;  // the thread's first row in the tile
  if (threadIdx.x == 0) s_first = kTile;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = ti * kTile + row0 + r;
    if (row < a.N &&
        (a.valid == nullptr ||
         a.valid[static_cast<size_t>(b) * a.N + row] > 0.0f)) {
      atomicMin(&s_first, row0 + r);
      break;
    }
  }
  __syncthreads();
  float origin[D];
  const size_t first = static_cast<size_t>(b) * a.N + ti * kTile + s_first;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    origin[k] = s_first < kTile ? a.white[first * D + k] : 0.0f;
  }

  // rows: u_i = 2 z_i and a_i = -|z_i|^2, z_i the scaled moved row
  float u[R][D], ar[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ar[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float z = moved(a, b, ti * kTile + row0 + r, k, D, kFar,
                            origin[k]);
      u[r][k] = 2.0f * z;
      ar[r] = fmaf(-z, z, ar[r]);
    }
  }
  // columns: z_j by coordinate, then b_j = -|z_j|^2
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    float bj = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float z = moved(a, b, tj * kTile + c, k, D, -kFar, origin[k]);
      s_col[k * kTile + c] = z;
      bj = fmaf(-z, z, bj);
    }
    s_col[D * kTile + c] = bj;
  }
  __syncthreads();

  float se = 0.0f, se2 = 0.0f;
  if (ti == tj) {
    // groups wholly below the warp's first row hold no pair i < j
    const int first_row = (threadIdx.x / 32) * kWarpRows;
    tile_sums<D, true>(u, ar, s_col, row0, first_row, se, se2);
  } else {
    tile_sums<D, false>(u, ar, s_col, row0, 0, se, se2);
  }
  write_partial<kThreads>(a, b, p, pairs, se, se2);
}

// Any width d: tiles of kWideTile rows, one row per thread; columns in
// groups of kWideGroup, each group's distances summed over coordinates
// staged kWideChunk at a time (rows and columns both in shared memory).
__global__ void __launch_bounds__(kWideThreads)
    ucv_pairs_wide_kernel(const UcvArgs a, int pairs, int d) {
  static_assert(kWideTile == kWideThreads, "one row per thread");
  __shared__ float s_row[kWideChunk * kWideTile];
  __shared__ float s_col[kWideChunk * kWideGroup];

  const int b = blockIdx.y;
  const long long p = blockIdx.x;
  int ti, tj;
  tile_pair(p, a.nt, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kWideTile, c0 = tj * kWideTile;

  float se = 0.0f, se2 = 0.0f;
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
        s_row[k * kWideTile + r] = staged(a, b, i0 + r, k0 + k, d, kFar);
      }
      for (int e = threadIdx.x; e < kWideGroup * kc; e += kWideThreads) {
        const int c = e / kc, k = e % kc;
        s_col[k * kWideGroup + c] =
            staged(a, b, c0 + j0 + c, k0 + k, d, -kFar);
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
  write_partial<kWideThreads>(a, b, p, pairs, se, se2);
}

// One block per problem: each row tile's partials summed over its column
// tiles in order of tj, those row sums in order of ti within each thread
// (row tiles ti = t, t + kReduceThreads, ...), then the threads' sums in a
// fixed tree (each warp's shuffles, then the warps in order).
__global__ void __launch_bounds__(kReduceThreads)
    ucv_reduce_kernel(const double* partials, float* out, int nt, int pairs) {
  __shared__ double s_warp[2][kReduceThreads / 32];
  const int b = blockIdx.x;
  const double* part = partials + 2 * static_cast<size_t>(b) * pairs;
  double x = 0.0, y = 0.0;
  for (int ti = threadIdx.x; ti < nt; ti += kReduceThreads) {
    const double* row = part + 2 * (static_cast<long long>(ti) * nt -
                                    static_cast<long long>(ti) * (ti - 1) / 2);
    double rx = 0.0, ry = 0.0;
#pragma unroll 4
    for (int tj = 0; tj < nt - ti; ++tj) {
      rx += row[2 * tj];
      ry += row[2 * tj + 1];
    }
    x += rx;
    y += ry;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
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
    for (int w = 1; w < kReduceThreads / 32; ++w) {
      sx += s_warp[0][w];
      sy += s_warp[1][w];
    }
    out[2 * b] = static_cast<float>(sx);
    out[2 * b + 1] = static_cast<float>(sy);
  }
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
