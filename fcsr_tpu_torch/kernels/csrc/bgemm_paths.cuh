// The product kernels' shared arguments and their non-dense paths:
// matrix-vector products (M = 1, column sums when a == nullptr; N = 1)
// and K <= 1 (rank-1 plus add). bgemm.cu (IEEE fp32) and bgemm_bf16.cu
// (single-pass bf16 products) both launch them; the RND instances round
// each operand to bf16 as they load it. A product of two bf16 values is
// exact in fp32, so an fp32 FMA chain over rounded operands computes the
// bf16 mode's function: its products, summed in fp32. bias and D are
// added in fp32; with `rbias` the bias is rounded too (the pool logits'
// bias, a product with a column of ones in the JAX package).
//
// Where X runs along k in memory: one warp per output with lanes along k
// and a shuffle tree; where it runs along the outputs: lanes along the
// outputs (coalesced) with k split over 8 warps, summed in warp order. A
// square tile would waste 63/64 of itself on these.
#pragma once

#include "common.cuh"

namespace {

constexpr int VEC_WARPS = 8;  // warps of the outputs-along-lanes path
constexpr int DOT_WARPS = 4;  // outputs per block of the warp-per-output path

struct Args {
  const float* A;
  const float* B;
  const float* bias;
  const float* D;
  float* C;
  int M, N, K;
  long long sA, sB, sBias, sD, sC;
  int ldA, ldB, ldD, ldC;
  int rbias;  // round the bias to bf16 before adding it
};

// bias value of output column n of fold f as the epilogue adds it
__device__ __forceinline__ float bias_at(const float* bias, long long at,
                                         int rbias) {
  const float b = bias[at];
  return rbias ? bf16_round(b) : b;
}

// y[i] = sum_k X(i, k) v(k) (+ bias) (+ D) for i < L, per fold; v == nullptr
// is a vector of ones. ROWC: X(i, k) = X[i * ldX + k], else X[k * ldX + i].
struct Vec {
  const float* X;
  const float* v;
  const float* bias;
  const float* D;
  float* C;
  long long sX, sv, sBias, sD, sC;
  int ldX, incv, incBias, incD, incC;
  int L, K;
  int rbias;
};

__device__ __forceinline__ void vec_store(const Vec& q, int f, int i,
                                          float s) {
  if (q.bias)
    s += bias_at(q.bias, f * q.sBias + (long long)i * q.incBias, q.rbias);
  if (q.D) s += q.D[f * q.sD + (long long)i * q.incD];  // D may alias C
  q.C[f * q.sC + (long long)i * q.incC] = s;
}

// X along k: one warp per output, lanes along k, a shuffle tree.
template <bool RND>
__global__ void __launch_bounds__(32 * DOT_WARPS) gemv_dot(Vec q) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * DOT_WARPS + (threadIdx.x >> 5);
  const int f = blockIdx.y;
  if (i >= q.L) return;  // the whole warp
  const float* __restrict__ x = q.X + f * q.sX + (long long)i * q.ldX;
  const float* __restrict__ v = q.v ? q.v + f * q.sv : nullptr;
  float s = 0.f;
#pragma unroll 4
  for (int k = lane; k < q.K; k += 32)
    s = fmaf(rnd_if<RND>(x[k]),
             v ? rnd_if<RND>(v[(long long)k * q.incv]) : 1.f, s);
  s = warp_sum(s);
  if (lane == 0) vec_store(q, f, i, s);
}

// X along the outputs: lanes along i (coalesced), k split over the warps
// in contiguous ranges, the partial sums added in warp order.
template <bool RND>
__global__ void __launch_bounds__(32 * VEC_WARPS) gemv_cols(Vec q) {
  __shared__ float part[VEC_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane, f = blockIdx.y;
  const int k0 = w * q.K / VEC_WARPS, k1 = (w + 1) * q.K / VEC_WARPS;
  float s = 0.f;
  if (i < q.L) {
    const float* __restrict__ x = q.X + f * q.sX + i;
    const float* __restrict__ v = q.v ? q.v + f * q.sv : nullptr;
#pragma unroll 8
    for (int k = k0; k < k1; ++k)
      s = fmaf(rnd_if<RND>(x[(long long)k * q.ldX]),
               v ? rnd_if<RND>(v[(long long)k * q.incv]) : 1.f, s);
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < q.L) {
    float t = part[0][lane];
#pragma unroll
    for (int r = 1; r < VEC_WARPS; ++r) t += part[r][lane];
    vec_store(q, f, i, t);
  }
}

// K <= 1: C = op(A) op(B) as an outer product (0 for K = 0) + bias + D.
template <bool RND>
__global__ void __launch_bounds__(256) rank1_kernel(Args p, int ta, int tb) {
  const int f = blockIdx.y;
  const long long total = (long long)p.M * p.N;
  const float* Ab = p.A + f * p.sA;
  const float* Bb = p.B + f * p.sB;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < total;
       e += (long long)gridDim.x * 256) {
    const int m = (int)(e / p.N), n = (int)(e % p.N);
    float c = 0.f;
    if (p.K == 1)
      c = rnd_if<RND>(ta ? Ab[m] : Ab[(long long)m * p.ldA]) *
          rnd_if<RND>(tb ? Bb[(long long)n * p.ldB] : Bb[n]);
    if (p.bias) c += bias_at(p.bias, f * p.sBias + n, p.rbias);
    if (p.D) c += p.D[f * p.sD + (long long)m * p.ldD + n];
    p.C[f * p.sC + (long long)m * p.ldC + n] = c;
  }
}

// Path classes of a launch (bgemm.cu's plan codes: cls * 10000 + ...).
enum { DENSE = 0, VEC_DOT = 1, VEC_COLS = 2, RANK1 = 3 };

inline int path_class(int M, int N, int K, int ta, int tb) {
  if (M == 1) return tb ? VEC_DOT : VEC_COLS;
  if (N == 1) return ta ? VEC_COLS : VEC_DOT;
  if (K <= 1) return RANK1;
  return DENSE;
}

// Launch a VEC_DOT / VEC_COLS / RANK1 path (the caller classified it).
template <bool RND>
int launch_thin(const Args& p, int batch, int ta, int tb, int cls,
                cudaStream_t st) {
  if (cls == RANK1) {
    const long long total = (long long)p.M * p.N;
    long long blocks = (total + 255) / 256;
    if (blocks > 512) blocks = 512;
    rank1_kernel<RND><<<dim3((unsigned)blocks, batch), 256, 0, st>>>(p, ta,
                                                                     tb);
    return (int)cudaGetLastError();
  }
  Vec q;
  q.bias = p.bias;
  q.sBias = p.sBias;
  q.rbias = p.rbias;
  q.D = p.D;
  q.sD = p.sD;
  q.C = p.C;
  q.sC = p.sC;
  q.K = p.K;
  bool rowc;
  if (p.M == 1) {  // y[n] = sum_k a(k) op(B)(k, n)
    q.L = p.N;
    q.X = p.B;
    q.sX = p.sB;
    q.ldX = p.ldB;
    rowc = tb;
    q.v = p.A;  // nullptr: ones
    q.sv = p.sA;
    q.incv = ta ? p.ldA : 1;
    q.incBias = 1;
    q.incD = 1;
    q.incC = 1;
  } else {  // N == 1: y[m] = sum_k op(A)(m, k) b(k)
    q.L = p.M;
    q.X = p.A;
    q.sX = p.sA;
    q.ldX = p.ldA;
    rowc = !ta;
    q.v = p.B;
    q.sv = p.sB;
    q.incv = tb ? 1 : p.ldB;
    q.incBias = 0;
    q.incD = p.ldD;
    q.incC = p.ldC;
  }
  if (rowc) {
    dim3 grid((q.L + DOT_WARPS - 1) / DOT_WARPS, batch);
    gemv_dot<RND><<<grid, 32 * DOT_WARPS, 0, st>>>(q);
  } else {
    dim3 grid((q.L + 31) / 32, batch);
    gemv_cols<RND><<<grid, 32 * VEC_WARPS, 0, st>>>(q);
  }
  return (int)cudaGetLastError();
}

Args make_args(const float* A, const float* B, const float* bias,
               const float* D, float* C, int M, int N, int K, long long sA,
               int ldA, long long sB, int ldB, long long sBias, long long sD,
               int ldD, long long sC, int ldC, int rbias) {
  Args p;
  p.A = A;
  p.B = B;
  p.bias = bias;
  p.D = D;
  p.C = C;
  p.M = M;
  p.N = N;
  p.K = K;
  p.sA = sA;
  p.ldA = ldA;
  p.sB = sB;
  p.ldB = ldB;
  p.sBias = sBias;
  p.sD = sD;
  p.ldD = ldD;
  p.sC = sC;
  p.ldC = ldC;
  p.rbias = rbias;
  return p;
}

}  // namespace
