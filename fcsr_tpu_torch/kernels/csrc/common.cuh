// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (bound from Python with
// ctypes), launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

// Adjoint sign of |x| as the reference differentiates it: +1 at x >= 0
// (zero included), -1 below.
__device__ __forceinline__ float abs_grad_sign(float x) {
  return x >= 0.f ? 1.f : -1.f;
}

// x rounded to bf16 (round to nearest even) and back: how the JAX
// package's single-pass bf16 product (FCSR_MM_MODE=bf16, core/mosaic_mm.py
// ::mm_bf16) takes each operand. A product of two such values is exact in
// fp32, so an fp32 sum of them is that mode's product.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as a kernel's RND instance reads it: bf16-rounded, or as stored.
template <bool RND>
__device__ __forceinline__ float rnd_if(float x) {
  if constexpr (RND) return bf16_round(x);
  else return x;
}

// sign(x) with sign(0) = 0 (jnp.sign), for the hand-written L1 adjoint.
__device__ __forceinline__ float sign0(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Sum and maximum over the 32 lanes of a warp, returned to every lane (a
// butterfly: lane 0 adds in the same order as a shift-down tree would).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// Asynchronous copies from global to shared memory that bypass registers,
// so a block issues all its loads before waiting on any: cp_async*, then
// cp_async_commit(), cp_async_wait<0>() and __syncthreads().
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: ``bytes`` of the 16 (or 4) are read, the rest
// of the destination is set to 0 (bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of a cluster barrier (barrier.cluster: release on
// arrive, acquire on wait). Every thread of every block arrives, then
// waits; work placed between the two overlaps the other blocks' arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The tile pair of block p: p = tj (tj + 1) / 2 + ti, 0 <= ti <= tj; a
// float square root, then an integer correction that makes it exact
// (ops.sym_pair is its Python twin; tail.cu's symmetric pair and triu.cu's
// anti-vectorize walk their mirrored tiles by it).
__device__ __forceinline__ void sym_pair(int p, int& ti, int& tj) {
  long long t = (long long)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  tj = (int)t;
  ti = (int)(p - t * (t + 1) / 2);
}

// 16-byte accesses need 16-byte-aligned addresses.
__host__ __device__ static inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

namespace {

// Per-device state. A kernel attribute (cudaFuncSetAttribute) and a value
// read from the card hold for the device that was current, so whatever an
// entry point sets up or reads once, it does once per device, in a small
// table indexed by cudaGetDevice. A set-up is idempotent: host threads
// racing on one device set the same attributes twice.
constexpr int MAX_DEVICES = 64;

// The current device into *dev (0 or a CUDA error).
inline int current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev < 0 || *dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  return 0;
}

// The opt-in shared memory per block of each device, read on the first
// launch there that needs it.
std::atomic<int> g_smem_optin[MAX_DEVICES];

// The current device's opt-in shared memory into *optin, and the device
// into *dev.
inline int read_smem_optin(int* optin, int* dev) {
  int err = current_device(dev);
  if (err) return err;
  int v = g_smem_optin[*dev].load(std::memory_order_relaxed);
  if (v == 0) {
    err = (int)cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err) return err;
    g_smem_optin[*dev].store(v, std::memory_order_relaxed);
  }
  *optin = v;
  return 0;
}

// One launch of a cluster kernel on ``grid``, clusters of ``cluster``
// blocks along x (cudaLaunchKernelExC: capturable in a CUDA graph). A
// cluster shape the card refuses fails here.
inline int launch_cluster(const void* fn, dim3 grid, int cluster,
                          int threads, size_t smem, cudaStream_t st,
                          void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* fcsr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
