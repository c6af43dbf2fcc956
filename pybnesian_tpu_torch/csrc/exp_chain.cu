// Exp-throughput probe for NVIDIA Hopper (sm_90a): the card's float32 exp
// ceiling, against which the KDE kernels' exp rates are stated.
//
// Replaces the Pallas TPU kernel `kern` of `pallas_exp_chain_rate` in
// benchmarks/micro_exp_roofline.py. Per element of x (n floats):
//
//   acc = 0;  64 times:  acc = 0.5 * acc + exp(x - 1e-3 * acc - 1)
//   out = acc
//
// Each step depends on the one before, so no exp can be skipped or
// reordered, and x and acc never leave registers: the probe reads 4 bytes
// and writes 4 bytes per 64 exps. The TPU kernel ran the same tile on a
// grid of 64 identical steps; here the grid's y axis holds `repeats`
// identical copies that all write the same output, so the work is done
// `repeats` times and none of it can be elided.
//
// Design: one thread per element, 256 threads per block, grid
// (ceil(n / 256), repeats). Accurate `expf`, as the KDE kernels use: it is
// one SFU ex2 plus a few FMAs of range reduction, so the SFU's issue rate
// bounds the probe. No fast-math.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChain = 64;

__global__ void __launch_bounds__(kThreads)
exp_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < kChain; ++c) {
    acc = acc * 0.5f + expf(xi - acc * 1e-3f - 1.0f);
  }
  out[i] = acc;
}

}  // namespace

// Launches on `stream` (a cudaStream_t) without synchronising and returns
// cudaGetLastError() after the launch: 0 on success. Allocates nothing.
// x and out are contiguous float32 (n,) on the current device; 1 <= repeats
// <= 65535, n >= 1.
extern "C" int exp_chain_f32(const float* x, float* out, int n, int repeats,
                             void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, repeats);
  exp_chain_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n);
  return static_cast<int>(cudaGetLastError());
}
