// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (bound from Python with
// ctypes), launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Adjoint sign of |x| as the reference differentiates it: +1 at x >= 0
// (zero included), -1 below.
__device__ __forceinline__ float abs_grad_sign(float x) {
  return x >= 0.f ? 1.f : -1.f;
}

// sign(x) with sign(0) = 0 (jnp.sign), for the hand-written L1 adjoint.
__device__ __forceinline__ float sign0(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Sum over the 32 lanes of a warp; the result is valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over a block whose size is a multiple of 32 (at most 1024); the
// result is valid in thread 0. Call once per kernel (one shared buffer).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[wid] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = (int)threadIdx.x < nw ? part[threadIdx.x] : 0.f;
  if (wid == 0) v = warp_sum(v);
  return v;
}

// Blocks for a grid-stride loop over ``total`` elements (at most 4096).
static inline int grid_for(long long total, int threads) {
  const long long blocks = (total + threads - 1) / threads;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

extern "C" const char* fcsr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
