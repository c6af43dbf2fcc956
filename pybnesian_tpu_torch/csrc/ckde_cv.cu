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
// Design: one thread per (program, test row), 128 threads per block, grid
// (ceil(nte / 128), G). A thread keeps its dpad coordinates and zte in
// registers. The block stages the program's train rows through shared
// memory in tiles of 256 rows x (dpad + 2) floats. Distances are direct
// per-column FMAs: exact at the small distances that dominate the sums,
// with none of the cancellation of |a|^2 + |b|^2 - 2ab. Each logsumexp is
// an online (max, sum) pair that starts at -1e30, as the TPU CV kernel's
// accumulators do, so all-padding tiles stay NaN-free; a NaN input still
// propagates to the result. (The Pallas `_kde_kernel` starts at -inf and
// gives NaN when a test block's first train block is all invalid; this
// port does not.) Evidence-free programs skip the marginal pass. Rows past
// ntr and nte are masked here, so callers need no padding.
//
// The KDE kernel takes any width: dpad <= 16 is templated as above; wider
// programs take a runtime-width variant that keeps the block's test
// coordinates in shared memory too (dynamic shared memory, 64-row tiles).
//
// Bound: the exponentials. bench.py's workload (150 programs, 9,000 train
// rows, 1,000 test rows) is about 1.4e9 pairs at up to 2 exps each, every
// exp through the SFU. The tile-wise max-then-sum that halves the exps,
// fast-math exps, wgmma for the distance products, TMA staging and any
// other speed work are left to later changes; this version is the simple
// one that is right.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 128;  // test rows per block
constexpr int kTile = 256;     // train rows per shared-memory tile
constexpr int kWideTile = 64;  // train rows per tile, runtime-width KDE
constexpr int kMaxWide = 256;  // widest runtime-width KDE program
constexpr float kInit = -1e30f;

// One step of an online logsumexp with a single exp and no branch. A NaN x
// makes `up` false and `e` NaN, so the sum turns NaN.
__device__ __forceinline__ void online_lse(float x, float& m, float& s) {
  const bool up = x > m;
  const float e = expf(up ? m - x : x - m);
  s = up ? fmaf(s, e, 1.0f) : s + e;
  m = up ? x : m;
}

template <int D, bool MARG>
__device__ __forceinline__ void sweep_tile(const float (&te)[D], float zte,
                                           const float (*s_tr)[kTile],
                                           const float* s_neg,
                                           const float* s_z, int rows,
                                           float& mj, float& sj, float& mm,
                                           float& sm) {
#pragma unroll 4
  for (int j = 0; j < rows; ++j) {
    float d2 = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float df = te[k] - s_tr[k][j];
      d2 = fmaf(df, df, d2);
    }
    const float lj = fmaf(-0.5f, d2, s_neg[j]);
    online_lse(lj, mj, sj);
    if (MARG) {
      const float vd = zte - s_z[j];
      online_lse(fmaf(0.5f * vd, vd, lj), mm, sm);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ckde_cv_pairs_kernel(const float* __restrict__ jtr,
                     const float* __restrict__ neg,
                     const float* __restrict__ zv_tr,
                     const float* __restrict__ jte,
                     const float* __restrict__ zv_te,
                     const float* __restrict__ no_ev,
                     const float* __restrict__ lm_const,
                     float* __restrict__ out, int ntr, int nte) {
  __shared__ float s_tr[D][kTile];
  __shared__ float s_neg[kTile];
  __shared__ float s_z[kTile];

  const int g = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < nte;
  const bool marg = !(no_ev[g] > 0.5f);  // uniform over the block

  const float* tr_g = jtr + static_cast<size_t>(g) * ntr * D;
  const float* neg_g = neg + static_cast<size_t>(g) * ntr;
  const float* ztr_g = zv_tr + static_cast<size_t>(g) * ntr;
  const size_t row = static_cast<size_t>(g) * nte + (active ? i : 0);

  float te[D];
#pragma unroll
  for (int k = 0; k < D; ++k) te[k] = active ? jte[row * D + k] : 0.0f;
  const float zte = active ? zv_te[row] : 0.0f;

  float mj = kInit, sj = 0.0f, mm = kInit, sm = 0.0f;
  for (int t0 = 0; t0 < ntr; t0 += kTile) {
    const int rows = min(kTile, ntr - t0);
    // coalesced over the tile's contiguous (rows x D) slab
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      s_tr[e % D][e / D] = tr_g[static_cast<size_t>(t0) * D + e];
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      s_neg[r] = neg_g[t0 + r];
      s_z[r] = ztr_g[t0 + r];
    }
    __syncthreads();
    if (marg) {
      sweep_tile<D, true>(te, zte, s_tr, s_neg, s_z, rows, mj, sj, mm, sm);
    } else {
      sweep_tile<D, false>(te, zte, s_tr, s_neg, s_z, rows, mj, sj, mm, sm);
    }
    __syncthreads();
  }
  if (active) {
    const float lse_j = mj + logf(sj);
    const float lse_m = marg ? mm + logf(sm) : lm_const[g];
    out[row] = lse_j - lse_m;
  }
}

// Stages rows [t0, t0 + rows) of one program's (ntr, d) train block into
// s_tr[k * stride + r], with s_neg[r] = 0 for a valid row, -inf otherwise.
__device__ __forceinline__ void stage_kde_tile(const float* tr_g,
                                               const float* valid_g, int t0,
                                               int rows, int d, int stride,
                                               float* s_tr, float* s_neg) {
  // coalesced over the tile's contiguous (rows x d) slab
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    s_tr[(e % d) * stride + e / d] = tr_g[static_cast<size_t>(t0) * d + e];
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    s_neg[r] = valid_g[t0 + r] > 0.0f ? 0.0f : -INFINITY;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
kde_logl_kernel(const float* __restrict__ train,
                const float* __restrict__ valid,
                const float* __restrict__ test,
                const float* __restrict__ lognorm,
                float* __restrict__ out, int ntr, int nte) {
  __shared__ float s_tr[D][kTile];
  __shared__ float s_neg[kTile];

  const int g = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < nte;
  const float* tr_g = train + static_cast<size_t>(g) * ntr * D;
  const float* valid_g = valid + static_cast<size_t>(g) * ntr;
  const size_t row = static_cast<size_t>(g) * nte + (active ? i : 0);

  float te[D];
#pragma unroll
  for (int k = 0; k < D; ++k) te[k] = active ? test[row * D + k] : 0.0f;

  float m = kInit, s = 0.0f, unused_m = kInit, unused_s = 0.0f;
  for (int t0 = 0; t0 < ntr; t0 += kTile) {
    const int rows = min(kTile, ntr - t0);
    stage_kde_tile(tr_g, valid_g, t0, rows, D, kTile, &s_tr[0][0], s_neg);
    __syncthreads();
    sweep_tile<D, false>(te, 0.0f, s_tr, s_neg, nullptr, rows, m, s,
                         unused_m, unused_s);
    __syncthreads();
  }
  if (active) out[row] = m + logf(s) + lognorm[g];
}

// Any width d: the block's test coordinates live in shared memory as
// s_te[k * kThreads + thread] (consecutive threads, consecutive banks), the
// train tile as s_tr[k * kWideTile + row] (one broadcast per step).
__global__ void __launch_bounds__(kThreads)
kde_logl_wide_kernel(const float* __restrict__ train,
                     const float* __restrict__ valid,
                     const float* __restrict__ test,
                     const float* __restrict__ lognorm,
                     float* __restrict__ out, int ntr, int nte, int d) {
  extern __shared__ float smem[];
  float* s_te = smem;                        // d x kThreads
  float* s_tr = s_te + d * kThreads;         // d x kWideTile
  float* s_neg = s_tr + d * kWideTile;       // kWideTile

  const int g = blockIdx.y;
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  const int nrows = min(kThreads, nte - i0);
  const float* tr_g = train + static_cast<size_t>(g) * ntr * d;
  const float* valid_g = valid + static_cast<size_t>(g) * ntr;
  const float* te_b = test + (static_cast<size_t>(g) * nte + i0) * d;

  for (int e = threadIdx.x; e < kThreads * d; e += kThreads) {
    s_te[(e % d) * kThreads + e / d] = e < nrows * d ? te_b[e] : 0.0f;
  }
  float m = kInit, s = 0.0f;
  for (int t0 = 0; t0 < ntr; t0 += kWideTile) {
    const int rows = min(kWideTile, ntr - t0);
    stage_kde_tile(tr_g, valid_g, t0, rows, d, kWideTile, s_tr, s_neg);
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      float d2 = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float df = s_te[k * kThreads + threadIdx.x] -
                         s_tr[k * kWideTile + j];
        d2 = fmaf(df, df, d2);
      }
      online_lse(fmaf(-0.5f, d2, s_neg[j]), m, s);
    }
    __syncthreads();
  }
  if (i < nte) out[static_cast<size_t>(g) * nte + i] = m + logf(s) + lognorm[g];
}

}  // namespace

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// cudaGetLastError() after the launch: 0 on success. Allocates nothing.
// All arrays are contiguous float32 on the current device: jtr (G, ntr,
// dpad), neg and zv_tr (G, ntr), jte (G, nte, dpad), zv_te (G, nte), no_ev
// and lm_const (G,), out (G, nte). 1 <= dpad <= 16, 1 <= G <= 65535, nte >= 1.
extern "C" int ckde_cv_pairs_f32(const float* jtr, const float* neg,
                                 const float* zv_tr, const float* jte,
                                 const float* zv_te, const float* no_ev,
                                 const float* lm_const, float* out, int G,
                                 int ntr, int nte, int dpad, void* stream) {
  const dim3 grid((nte + kThreads - 1) / kThreads, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dpad) {
#define CKDE_CV_CASE(D)                                                  \
  case D:                                                                \
    ckde_cv_pairs_kernel<D><<<grid, kThreads, 0, s>>>(                   \
        jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const, out, ntr, nte);    \
    break;
    CKDE_CV_CASE(1)
    CKDE_CV_CASE(2)
    CKDE_CV_CASE(3)
    CKDE_CV_CASE(4)
    CKDE_CV_CASE(5)
    CKDE_CV_CASE(6)
    CKDE_CV_CASE(7)
    CKDE_CV_CASE(8)
    CKDE_CV_CASE(9)
    CKDE_CV_CASE(10)
    CKDE_CV_CASE(11)
    CKDE_CV_CASE(12)
    CKDE_CV_CASE(13)
    CKDE_CV_CASE(14)
    CKDE_CV_CASE(15)
    CKDE_CV_CASE(16)
#undef CKDE_CV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// cudaGetLastError() after the launch: 0 on success. Allocates nothing.
// All arrays are contiguous float32 on the current device: train (G, ntr,
// d), valid (G, ntr) with > 0 for a valid row, test (G, nte, d), lognorm
// (G,), out (G, nte). 1 <= d <= 256, 1 <= G <= 65535, nte >= 1.
extern "C" int kde_logl_f32(const float* train, const float* valid,
                            const float* test, const float* lognorm,
                            float* out, int G, int ntr, int nte, int d,
                            void* stream) {
  const dim3 grid((nte + kThreads - 1) / kThreads, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define KDE_CASE(D)                                                      \
  case D:                                                                \
    kde_logl_kernel<D><<<grid, kThreads, 0, s>>>(train, valid, test,     \
                                                 lognorm, out, ntr, nte); \
    break;
    KDE_CASE(1)
    KDE_CASE(2)
    KDE_CASE(3)
    KDE_CASE(4)
    KDE_CASE(5)
    KDE_CASE(6)
    KDE_CASE(7)
    KDE_CASE(8)
    KDE_CASE(9)
    KDE_CASE(10)
    KDE_CASE(11)
    KDE_CASE(12)
    KDE_CASE(13)
    KDE_CASE(14)
    KDE_CASE(15)
    KDE_CASE(16)
#undef KDE_CASE
    default: {
      if (d < 1 || d > kMaxWide) return static_cast<int>(cudaErrorInvalidValue);
      const size_t bytes =
          sizeof(float) * (static_cast<size_t>(d) * (kThreads + kWideTile) +
                           kWideTile);
      if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kde_logl_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      kde_logl_wide_kernel<<<grid, kThreads, bytes, s>>>(
          train, valid, test, lognorm, out, ntr, nte, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
