// bgemm_bf16: batched C = op(A) op(B) [+ bias row] [+ D] with single-pass
// bf16 products: each operand rounded to bf16 (round to nearest even), the
// products summed in fp32, bias and D added in fp32 (the bias rounded too
// with `round_bias`).
//
// Replaces the in-kernel products of the TPU training-step kernels under
// FCSR_MM_MODE=bf16, the mode the JAX package's bench runs:
// fcsr_tpu/models/fused_step.py:925 (train_step_fused; and :742, :970,
// the U-Net kernels :167/:178/:235/:582/:591/:613) and
// fcsr_tpu/models/fused_tail.py:94, whose bodies run every product through
// core/mosaic_mm.py::mm, there mm_bf16: operands cast to bf16, one MXU
// pass, f32 accumulation. A GSR step launches 79 of them (3.57 GFLOP at
// F = 3); all are <= 268 x 268 x 268 per fold.
//
// Bound on an H100: the bf16 tensor cores (989 TFLOP/s) or the bytes of
// the fp32 operands (3.35 TB/s), whichever is larger; at these sizes both
// are far below a launch, so the kernel is bound by latency. The operands
// are the fp32 flat-buffer views the fp32 kernel reads (bgemm.cu: TMA's
// 16-byte rules fail on them), read with 4-byte loads as stored, rounded
// on their way into shared memory, so no bf16 copy of any tensor is made.
//
// The dense path (M, N > 1, K > 1): a 32 x 32 output tile per block of 4
// warps, each warp a 16 x 16 quarter as two mma.sync.m16n8k16 bf16 tiles
// with fp32 accumulators; 32-deep K slices staged in shared memory as
// bf16 ([m][k] and [n][k], rows padded to 40 halves: the fragment loads
// hit 32 distinct banks), the next slice's loads in flight in registers
// while the tensor cores take the current one. No split-K and one tile
// for every shape: a fold's sums never depend on the fold count, so
// ops.plan_folds has nothing to set here (fold-sharded runs stay
// bit-equal to unsharded ones). The matrix-vector, column-sum and K = 1
// paths are bgemm.cu's (bgemm_paths.cuh) with the operands rounded on
// load: a product of two bf16 values is exact in fp32, so they compute
// the same function. wgmma, TMA and a deeper pipeline are later work.
#include "bgemm_paths.cuh"

namespace {

constexpr int TM = 32, TN = 32, TK = 32;  // block tile, K slice
constexpr int LDS = TK + 8;               // bf16 per shared row (padded)
constexpr int THREADS = 128;              // 4 warps, a 16 x 16 quarter each
constexpr int PER = TM * TK / THREADS;    // slice elements a thread loads

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b for one m16n8k16 tile: a 4 registers of bf16 pairs (row major),
// b 2 (column major), c 4 fp32 accumulators (PTX ISA fragment layouts).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// AK: A stored K x M (ta); BKM: B stored K x N (!tb). Grid (N tiles,
// M tiles, F). Element e of a slice maps to (row, k) along the operand's
// contiguous axis, so a warp's loads are coalesced for every ta / tb.
template <bool AK, bool BKM>
__global__ void __launch_bounds__(THREADS) mma_kernel(Args p) {
  __shared__ __align__(16) __nv_bfloat16 As[TM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[TN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN, f = blockIdx.z;
  const float* Ab = p.A + f * p.sA;
  const float* Bb = p.B + f * p.sB;
  float ra[PER], rb[PER];

  auto a_at = [&](int e, int& m, int& k) {
    if (AK) k = e / TM, m = e % TM;
    else m = e / TK, k = e % TK;
  };
  auto b_at = [&](int e, int& n, int& k) {
    if (BKM) k = e / TN, n = e % TN;
    else n = e / TK, k = e % TK;
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      int m, k, n, kb;
      a_at(e, m, k);
      b_at(e, n, kb);
      const int gm = m0 + m, gk = k0 + k, gn = n0 + n, gkb = k0 + kb;
      ra[i] = gm < p.M && gk < p.K
                  ? Ab[AK ? (long long)gk * p.ldA + gm
                          : (long long)gm * p.ldA + gk]
                  : 0.f;
      rb[i] = gn < p.N && gkb < p.K
                  ? Bb[BKM ? (long long)gkb * p.ldB + gn
                           : (long long)gn * p.ldB + gkb]
                  : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      int m, k, n, kb;
      a_at(e, m, k);
      b_at(e, n, kb);
      As[m * LDS + k] = __float2bfloat16_rn(ra[i]);
      Bs[n * LDS + kb] = __float2bfloat16_rn(rb[i]);
    }
  };

  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int nk = (p.K + TK - 1) / TK;
  if (nk > 0) fetch(0);
  for (int s = 0; s < nk; ++s) {
    stash();
    __syncthreads();
    if (s + 1 < nk) fetch((s + 1) * TK);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      const __nv_bfloat16* ap = As + (wm + g) * LDS + kk + 2 * t;
      const uint32_t a[4] = {ld_pair(ap), ld_pair(ap + 8 * LDS),
                             ld_pair(ap + 8), ld_pair(ap + 8 * LDS + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* bp = Bs + (wn + 8 * j + g) * LDS + kk + 2 * t;
        mma_bf16(acc[j], a, ld_pair(bp), ld_pair(bp + 8));
      }
    }
    __syncthreads();
  }

  // each output is read (D) and written (C) by its own thread: D may
  // alias C
  float* Cb = p.C + f * p.sC;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + wm + g + (r >= 2 ? 8 : 0);
      const int col = n0 + wn + 8 * j + 2 * t + (r & 1);
      if (row >= p.M || col >= p.N) continue;
      float c = acc[j][r];
      if (p.bias) c += bias_at(p.bias, f * p.sBias + col, p.rbias);
      if (p.D) c += p.D[f * p.sD + (long long)row * p.ldD + col];
      Cb[(long long)row * p.ldC + col] = c;
    }
}

int launch(const Args& p, int batch, int ta, int tb, void* stream) {
  if (batch <= 0 || p.M <= 0 || p.N <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cls = path_class(p.M, p.N, p.K, ta, tb);
  if (cls != DENSE) return launch_thin<true>(p, batch, ta, tb, cls, st);
  if (p.A == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p.N + TN - 1) / TN),
                  (unsigned)((p.M + TM - 1) / TM), (unsigned)batch);
  if (ta) {
    if (tb) mma_kernel<true, false><<<grid, THREADS, 0, st>>>(p);
    else mma_kernel<true, true><<<grid, THREADS, 0, st>>>(p);
  } else {
    if (tb) mma_kernel<false, false><<<grid, THREADS, 0, st>>>(p);
    else mma_kernel<false, true><<<grid, THREADS, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fcsr_bgemm_f32's arguments, plus `round_bias`; `plan_batch` is taken for
// the shared signature and sets nothing (one tile, no split-K).
extern "C" int fcsr_bgemm_bf16(const float* A, const float* B,
                               const float* bias, const float* D, float* C,
                               int batch, int M, int N, int K, int ta, int tb,
                               long long sA, int ldA, long long sB, int ldB,
                               long long sBias, long long sD, int ldD,
                               long long sC, int ldC, int plan_batch,
                               int round_bias, void* stream) {
  (void)plan_batch;
  const Args p = make_args(A, B, bias, D, C, M, N, K, sA, ldA, sB, ldB, sBias,
                           sD, ldD, sC, ldC, round_bias);
  return launch(p, batch, ta, tb, stream);
}
