// triu: the data-path kernels between vectorized connectomes (the strict
// upper triangle of a symmetric matrix, as the challenge CSVs store it) and
// dense adjacency stacks, batched over subjects.
//
// Replaces the three TPU kernels of fcsr_tpu/core/pallas_kernels.py:
//   anti_vectorize_normalize  (anti_vectorize_normalize) row-major triu
//                             vectors (B, V >= n(n-1)/2) -> symmetric
//                             (B, n, n), optional diagonal fill, optional
//                             degree normalisation (a r_i) r_j
//   vectorize_colmajor        (vectorize_colmajor_pallas) (B, n, n) ->
//                             (B, n(n-1)/2), entry p = M[i, j] with
//                             p = j(j-1)/2 + i, i < j
//   normalize_adj_batch       (normalize_adj_pallas) (B, n, n) ->
//                             (a r_i) r_j, r = rowsum^-1/2, no transpose
// The TPU versions load aligned windows and rotate them because Mosaic has
// no gather; here a thread computes its index and loads.
//
// All three are bound by bytes (a copy with index arithmetic, plus n row
// sums). The normalising kernels need every row sum of a matrix before any
// of its outputs, and a 268 x 268 matrix (287 KB) does not fit a block's
// shared memory, so they run one block per matrix with the n reciprocal
// roots in shared memory and read the input twice (the second time from
// L2). Only one half of the anti-vectorize reads (j > i) and none of the
// column-major reads are coalesced; writes always are.
//
// The guard is the reference's: only the infinite r of a ZERO row sum
// (-0.0 included) becomes 0; a negative row sum gives NaN and the NaN
// reaches the output. 1 / sqrtf is IEEE here (no fast-math).
#include "common.cuh"

namespace {

__device__ __forceinline__ float guarded_rsqrt(float rowsum) {
  return rowsum == 0.f ? 0.f : 1.f / sqrtf(rowsum);
}

// Entry (i, j) of the symmetric matrix stored as the row-major strict upper
// triangle ``v``: row lo's run starts at lo n - lo (lo + 1) / 2.
__device__ __forceinline__ float triu_entry(const float* __restrict__ v, int n,
                                            int i, int j, float diag) {
  if (i == j) return diag;
  const long long lo = i < j ? i : j, hi = i < j ? j : i;
  return v[lo * n - lo * (lo + 1) / 2 + (hi - lo - 1)];
}

// One block per matrix, one warp per row at a time.
__global__ void anti_vectorize_normalize_kernel(const float* __restrict__ v,
                                                long long vstride,
                                                float* __restrict__ out,
                                                int n, float diag,
                                                int normalize) {
  extern __shared__ float r[];
  const float* V = v + blockIdx.x * vstride;
  float* A = out + (long long)blockIdx.x * n * n;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (normalize) {
    for (int i = w; i < n; i += nw) {
      float acc = 0.f;
      for (int j = lane; j < n; j += 32) acc += triu_entry(V, n, i, j, diag);
      acc = warp_sum(acc);
      if (lane == 0) r[i] = guarded_rsqrt(acc);
    }
    __syncthreads();
  }
  for (int i = w; i < n; i += nw) {
    for (int j = lane; j < n; j += 32) {
      float a = triu_entry(V, n, i, j, diag);
      if (normalize) a = (a * r[i]) * r[j];
      A[(long long)i * n + j] = a;
    }
  }
}

// One thread per output entry; blockIdx.y is the matrix.
__global__ void vectorize_colmajor_kernel(const float* __restrict__ m,
                                          float* __restrict__ out, int n,
                                          long long len) {
  const float* M = m + (long long)blockIdx.y * n * n;
  float* O = out + blockIdx.y * len;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       p < len; p += (long long)gridDim.x * blockDim.x) {
    // column j holds entries j(j-1)/2 .. j(j+1)/2 - 1; the float root is
    // off by one near triangular numbers, so settle it on integers
    long long j = (long long)((1.0 + sqrt(1.0 + 8.0 * (double)p)) * 0.5);
    while (j * (j - 1) / 2 > p) --j;
    while (j * (j + 1) / 2 <= p) ++j;
    const long long i = p - j * (j - 1) / 2;
    O[p] = M[i * n + j];
  }
}

// One block per matrix, one warp per row at a time.
__global__ void normalize_adj_batch_kernel(const float* __restrict__ a,
                                           float* __restrict__ out, int n) {
  extern __shared__ float r[];
  const float* A = a + (long long)blockIdx.x * n * n;
  float* O = out + (long long)blockIdx.x * n * n;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = w; i < n; i += nw) {
    float acc = 0.f;
    for (int j = lane; j < n; j += 32) acc += A[(long long)i * n + j];
    acc = warp_sum(acc);
    if (lane == 0) r[i] = guarded_rsqrt(acc);
  }
  __syncthreads();
  for (int i = w; i < n; i += nw)
    for (int j = lane; j < n; j += 32)
      O[(long long)i * n + j] = (A[(long long)i * n + j] * r[i]) * r[j];
}

}  // namespace

extern "C" int fcsr_anti_vectorize_normalize(const float* v, long long vstride,
                                             float* out, int batch, int n,
                                             float diag, int normalize,
                                             void* stream) {
  anti_vectorize_normalize_kernel<<<batch, 1024, n * sizeof(float),
                                    (cudaStream_t)stream>>>(
      v, vstride, out, n, diag, normalize);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_vectorize_colmajor(const float* m, float* out, int batch,
                                       int n, void* stream) {
  const long long len = (long long)n * (n - 1) / 2;
  const dim3 grid(grid_for(len, 256), batch);
  vectorize_colmajor_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      m, out, n, len);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_normalize_adj_batch(const float* a, float* out, int batch,
                                        int n, void* stream) {
  normalize_adj_batch_kernel<<<batch, 1024, n * sizeof(float),
                               (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}
