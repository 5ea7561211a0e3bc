// bgemm_f32: batched C = op(A) op(B) [+ bias row] [+ D] in IEEE fp32.
//
// Replaces the in-kernel matrix products of the TPU training-step kernel
// (fcsr_tpu/models/fused_step.py::_make_train_step_kernel, whose body runs
// ~70 products per fold per step through core/mosaic_mm.py's compensated
// bf16x3 matmul): the U-Net forward and backward, the spectral tail forward
// and backward, and the column sums (ones @ G). All are <= 268 x 536 x 268
// and batched over the fold axis.
//
// Bound: at these shapes the work is fp32 FMA (no TF32, matching the
// reference's f32-class precision), so the card's fp32 SIMT rate bounds it.
// Design: the simplest correct tiled kernel — a 64 x 64 output tile per
// block, 16-deep K slices staged through shared memory, 256 threads each
// accumulating a 4 x 4 micro-tile with fmaf. Transposes are folded into
// the tile loads; leading dimensions and batch strides are arbitrary, so
// operands can be views into the flat parameter / gradient buffers.
// wgmma / TMA / TF32 variants are later work.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

// A == nullptr means op(A) is a 1 x K row of ones (a column sum of op(B)).
__global__ void __launch_bounds__(THREADS)
bgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ bias, const float* D, float* C,
             int M, int N, int K, int ta, int tb,
             long long sA, int ldA, long long sB, int ldB, long long sBias,
             long long sD, int ldD, long long sC, int ldC) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int bz = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const float* Ab = A ? A + bz * sA : nullptr;
  const float* Bb = B + bz * sB;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      int i, kk;
      if (ta) { kk = e / BM; i = e % BM; }  // A stored K x M
      else    { i = e / BK; kk = e % BK; }  // A stored M x K
      const int gi = row0 + i, gk = k0 + kk;
      float v = 0.f;
      if (gi < M && gk < K) {
        if (!Ab) v = 1.f;
        else v = ta ? Ab[(long long)gk * ldA + gi] : Ab[(long long)gi * ldA + gk];
      }
      As[kk][i] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      int j, kk;
      if (tb) { j = e / BK; kk = e % BK; }  // B stored N x K
      else    { kk = e / BN; j = e % BN; }  // B stored K x N
      const int gj = col0 + j, gk = k0 + kk;
      float v = 0.f;
      if (gj < N && gk < K)
        v = tb ? Bb[(long long)gj * ldB + gk] : Bb[(long long)gk * ldB + gj];
      Bs[kk][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = row0 + ty + 16 * i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = col0 + tx + 16 * j;
      if (gj >= N) continue;
      float c = acc[i][j];
      if (bias) c += bias[bz * sBias + gj];
      if (D) c += D[bz * sD + (long long)gi * ldD + gj];  // D may alias C
      C[bz * sC + (long long)gi * ldC + gj] = c;
    }
  }
}

}  // namespace

extern "C" int fcsr_bgemm_f32(const float* A, const float* B,
                              const float* bias, const float* D, float* C,
                              int batch, int M, int N, int K, int ta, int tb,
                              long long sA, int ldA, long long sB, int ldB,
                              long long sBias, long long sD, int ldD,
                              long long sC, int ldC, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  bgemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      A, B, bias, D, C, M, N, K, ta, tb, sA, ldA, sB, ldB, sBias, sD, ldD,
      sC, ldC);
  return (int)cudaGetLastError();
}
