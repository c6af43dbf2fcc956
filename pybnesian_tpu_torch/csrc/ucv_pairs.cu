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
// Bound: the exponentials, one SFU `ex2` each (16 per clock per SM), then
// the FP32 pipe: 2d + 2 instructions per pair (a subtraction and an FMA
// per column, an add and an FMA for the two sums). Bytes are no limit:
// every row is read once per tile pair and reused by 256 rows of the
// other tile. PERF.md has the measured times against that bound.
//
// Design:
//
// - Grid (upper-triangle tile pair, problem): block (ti, tj), ti <= tj,
//   sums the pairs of row tile ti against column tile tj. A thread holds
//   R = 2 rows of tile ti in registers; the block stages tile tj column by
//   column in shared memory, so that one float4 load gives one coordinate
//   of 4 columns, which serves 8 pairs (kernel #2's layout in ckde_cv.cu).
// - One `ex2.approx.ftz` per pair: coordinates are scaled by
//   sqrt(log2(e) / 4) as they are loaded, so that minus the distance sum
//   is the first term's exponent in log2 units; e and e * e are summed.
// - Invalid rows without a per-pair mask: an invalid (or padding) row is
//   staged with coordinate 0 at +1e30 on the row side and -1e30 on the
//   column side, so that every pair that holds one, two invalid rows
//   included, has distance +inf and term 0. A NaN coordinate is kept, so
//   that it reaches the sums, as NaN * 0 does in the plain version.
// - Diagonal tiles (ti == tj) keep the pairs i < j; the others are
//   multiplied by 0, which keeps a NaN, as the plain version's mask does.
// - Deterministic and batch-independent: per-thread FP32 sums in a fixed
//   order, a fixed float64 tree over the block's threads, one float64
//   partial per (problem, tile pair) and no atomics. A second kernel sums
//   each problem's partials in a fixed order: per row tile over its
//   column tiles, then over the row tiles. A problem's sums depend on its
//   own rows alone: padding it with invalid rows to a batch's N only adds
//   exact zeros at the ends of those sums, so its two sums are bit-equal
//   alone, inside any batch, and from run to run.
//
// Families wider than 16 columns take a runtime-width kernel: one row per
// thread, tiles of 128 rows, groups of 32 columns, coordinates staged 32
// at a time, so any width fits its shared memory.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 128;        // threads per block
constexpr int kRowsPerThread = 2;    // R: rows of tile ti a thread holds
constexpr int kTile = 256;           // rows per tile: kThreads * R
constexpr int kGroup = 16;           // columns per group
constexpr int kMaxTemplated = 16;    // widest problem of the templated kernel
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

// Sums (s2h, sh) over the block's threads in float64, in a fixed tree, and
// writes the block's partial.
__device__ __forceinline__ void write_partial(const UcvArgs& a, int b,
                                              long long p, int pairs,
                                              float se, float se2) {
  __shared__ double s_warp[2][kThreads / 32];
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
    for (int w = 1; w < kThreads / 32; ++w) {
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
// Diagonal tiles keep the pairs whose column `j0 + t` lies past `row`.
template <int T>
__device__ __forceinline__ void add_group(const float (&y)[T], bool diag,
                                          int row, int j0, float& se,
                                          float& se2) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float e = ex2(y[t]);
    if (diag && !(row < j0 + t)) e *= 0.0f;  // keeps a NaN
    p[t % 4] += e;
    q[t % 4] = fmaf(e, e, q[t % 4]);
  }
  se += (p[0] + p[1]) + (p[2] + p[3]);
  se2 += (q[0] + q[1]) + (q[2] + q[3]);
}

// Grid (pairs, B). Thread t holds rows ti * kTile + r * kThreads + t.
template <int D>
__global__ void __launch_bounds__(kThreads)
    ucv_pairs_kernel(const UcvArgs a, int pairs) {
  constexpr int R = kRowsPerThread;
  constexpr int T = kGroup;
  static_assert(kTile == kThreads * R, "a tile is a block's rows");
  static_assert(kTile % T == 0, "a tile holds whole groups");
  __shared__ __align__(16) float s_col[D * kTile];

  const int b = blockIdx.y;
  const long long p = blockIdx.x;
  int ti, tj;
  tile_pair(p, a.nt, ti, tj);
  const bool diag = ti == tj;

  float w[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = ti * kTile + r * kThreads + threadIdx.x;
#pragma unroll
    for (int k = 0; k < D; ++k) w[r][k] = staged(a, b, row, k, D, kFar);
  }
  // coalesced over the column tile's contiguous (rows x D) slab
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int c = e / D, k = e % D;
    s_col[k * kTile + c] = staged(a, b, tj * kTile + c, k, D, -kFar);
  }
  __syncthreads();

  float se = 0.0f, se2 = 0.0f;
#pragma unroll 1
  for (int j0 = 0; j0 < kTile; j0 += T) {
    float y[R][T], x[T];
#pragma unroll
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int v = 0; v < T / 4; ++v) {
        const float4 q =
            reinterpret_cast<const float4*>(s_col + k * kTile + j0)[v];
        x[4 * v] = q.x;
        x[4 * v + 1] = q.y;
        x[4 * v + 2] = q.z;
        x[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float df = w[r][k] - x[t];
          y[r][t] = k == 0 ? -df * df : fmaf(-df, df, y[r][t]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      add_group(y[r], diag, r * kThreads + threadIdx.x, j0, se, se2);
    }
  }
  write_partial(a, b, p, pairs, se, se2);
}

// Any width d: tiles of kWideTile rows, one row per thread; columns in
// groups of kWideGroup, each group's distances summed over coordinates
// staged kWideChunk at a time (rows and columns both in shared memory).
__global__ void __launch_bounds__(kThreads)
    ucv_pairs_wide_kernel(const UcvArgs a, int pairs, int d) {
  static_assert(kWideTile == kThreads, "one row per thread");
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
      for (int e = threadIdx.x; e < kWideTile * kc; e += kThreads) {
        const int r = e / kc, k = e % kc;
        s_row[k * kWideTile + r] = staged(a, b, i0 + r, k0 + k, d, kFar);
      }
      for (int e = threadIdx.x; e < kWideGroup * kc; e += kThreads) {
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
    add_group(y, diag, threadIdx.x, j0, se, se2);
  }
  write_partial(a, b, p, pairs, se, se2);
}

// One block per problem: each row tile's partials summed over its column
// tiles (thread ti % kReduceThreads, in order of tj), written over the
// row's first partial, then those row sums in order of ti by one thread.
__global__ void __launch_bounds__(kReduceThreads)
    ucv_reduce_kernel(double* partials, float* out, int nt, int pairs) {
  const int b = blockIdx.x;
  double* part = partials + 2 * static_cast<size_t>(b) * pairs;
  for (int ti = threadIdx.x; ti < nt; ti += kReduceThreads) {
    const long long start = static_cast<long long>(ti) * nt -
                            static_cast<long long>(ti) * (ti - 1) / 2;
    double x = 0.0, y = 0.0;
    for (int tj = ti; tj < nt; ++tj) {
      x += part[2 * (start + tj - ti)];
      y += part[2 * (start + tj - ti) + 1];
    }
    part[2 * start] = x;
    part[2 * start + 1] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double x = 0.0, y = 0.0;
    for (int ti = 0; ti < nt; ++ti) {
      const long long start = static_cast<long long>(ti) * nt -
                              static_cast<long long>(ti) * (ti - 1) / 2;
      x += part[2 * start];
      y += part[2 * start + 1];
    }
    out[2 * b] = static_cast<float>(x);
    out[2 * b + 1] = static_cast<float>(y);
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
      ucv_pairs_wide_kernel<<<dim3(pairs, B), kThreads, 0, s>>>(a, pairs, d);
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
