// What the port's kernels share (ckde_cv.cu, cv_whiten.cu, lg_cv.cu and
// ucv_pairs.cu): the fixed-leaf rule of their sums and small device
// helpers. ops/cuda_build.py keys every library on this header as well as
// on its own source, so an edit here rebuilds them all, and mirrors the
// leaf rule in Python (leaf_count there).
//
// The fixed leaves. A kernel that sums a program's n rows splits them into
// leaf_count(n) leaves: the largest power of two up to kMaxLeaves that
// leaves each leaf kLeafRows rows, 1 below two leaves' worth. Leaf l holds
// rows [l * size, min(n, (l + 1) * size)) for size = ceil(n / leaves).
// Each leaf is summed in a fixed order and the leaves merge in a balanced
// binary tree, so a float32 result is a function of the program's own
// rows: not of the batch, of the launch plan or of the cluster size. Rank
// q of a thread-block cluster of `split` blocks sweeps leaves
// [first_leaf(q), first_leaf(q + 1)), and leaf l's sums live in the shared
// memory of rank leaf_owner(l).

#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxLeaves = 8;   // most leaves of a program's rows
constexpr int kLeafRows = 256;  // least rows of a leaf, with two or more
constexpr int kMaxSplit = 8;    // most blocks of a cluster (portable)

__host__ __device__ __forceinline__ int leaf_count(int n) {
  int leaves = 1;
  while (2 * leaves <= kMaxLeaves && 2 * leaves * kLeafRows <= n) {
    leaves *= 2;
  }
  return leaves;
}

// Rank q sweeps leaves / split of them when split is a power of two up to
// the leaves, one leaf or none when split exceeds the leaves.
__host__ __device__ __forceinline__ int first_leaf(int q, int leaves,
                                                   int split) {
  return q * leaves / split;
}

__device__ __forceinline__ int leaf_owner(int l, int leaves, int split) {
  return ((l + 1) * split - 1) / leaves;
}

__device__ __forceinline__ double qnan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ float qnanf() { return __int_as_float(0x7fc00000); }

// 2^x by one SFU instruction (flushes denormals).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 4-byte cp.async from global to shared memory, and its groups.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of a cluster barrier (all threads of the cluster).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync(int split) {
  if (split > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// Sums v[0..N) over the block's threads (Warps warps) in a fixed tree (each
// warp's shuffles, then the warps in order) into s_sum[0..N), which every
// thread may read on return; each value by its own operations. Called by
// all threads of the block; s_red holds a row of Max values per warp.
template <int Warps, int Max, int N>
__device__ __forceinline__ void block_sum(double (&v)[N],
                                          double (*s_red)[Max],
                                          double* s_sum) {
  static_assert(N <= Max, "one block sum holds Max values");
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
    for (int w = 1; w < Warps; ++w) s = __dadd_rn(s, s_red[w][threadIdx.x]);
    s_sum[threadIdx.x] = s;
  }
  __syncthreads();
}

}  // namespace
