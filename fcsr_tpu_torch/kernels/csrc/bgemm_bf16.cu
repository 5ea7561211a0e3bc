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
// are 0.3-1 us against a launch of ~2 us, so the kernel is bound by
// latency: measured, a fixed ~3 us a launch and 0.2-0.4 us for each K
// slice a block walks, more where the busiest of the 132 SMs holds more
// blocks (choose_dense's model). The operands are the fp32 flat-buffer
// views the fp32 kernel reads (bgemm.cu: TMA's 16-byte rules fail on
// them), rounded as they enter the tensor cores, so no bf16 copy of any
// tensor is made.
//
// The matrix-vector, column-sum and K = 1 paths are bgemm.cu's
// (bgemm_paths.cuh) with the operands rounded on load: a product of two
// bf16 values is exact in fp32, so they compute the same function.
//
// The dense path (M, N > 1, K > 1):
// - A 32 x 32 output tile per block of 4 warps, each warp a 16 x 16
//   quarter as two mma.sync.m16n8k16 bf16 tiles with fp32 accumulators.
// - fp32 K slices (BK = 32 or 64 deep) stream through a cp.async ring in
//   shared memory (bgemm_paths.cuh::load_tile), each operand copied as it
//   is stored: 16-byte copies where vec_ok allows, 4-byte ones otherwise.
//   STAGES - 1 slices are in flight while the tensor cores take one. Two
//   variants, 32- and 64-deep slices in a 3-stage ring (30 and 54 KB): a
//   block pays a fixed cost per slice (a wait, a barrier, the fragment
//   loads' chain), so fewer, deeper slices win where B is stored along n
//   and 32-deep ones where both operands lie along k. Deeper rings (9 x 32,
//   5 x 64) and a 64 x 32 tile of 8 warps measured no faster at any
//   product of the step (PERF.md).
// - Rounding and transposes happen in the fragment loads: a fragment
//   register is a pair of bf16 values adjacent in k at one row (m for A, n
//   for B), built from two fp32 values with __floats2bfloat162_rn
//   (cvt.rn.bf16x2.f32). An operand stored along k gives the pair as one
//   8-byte shared load; one stored along m or n as two 4-byte loads one row
//   apart. Both are free of bank conflicts with these row strides (in
//   4-byte words; g = lane / 4 picks the row, t = lane % 4 the k pair):
//   . along k, row stride BK + 8 (40 or 72): an 8-byte load is served a
//     half-warp at a time, lanes g = 0..3 (or 4..7), t = 0..3 at words
//     (BK + 8) g + 2 t (+1): (BK + 8) g = 8 g (mod 32) puts the four rows 8
//     banks apart and the 8 words of a row on the 8 banks between, 32
//     distinct banks;
//   . along m or n, row stride 36 (32 + 4): a 4-byte load, all 32 lanes
//     at words (2 t) 36 + g: 2 x 36 = 8 (mod 32) puts the four k rows 8
//     banks apart and the 8 m's (or n's) of a row between.
//   Every pad keeps rows 16-byte aligned for the copies.
// - Without split-K each output sums the same k16 steps in the same order
//   in both variants, so neither changes a bit.
// - Split-K across a thread-block cluster where M x N alone cannot fill
//   the card: S = 2 or 4 blocks of a cluster each take a contiguous range
//   of K slices; the partial tiles meet in distributed shared memory,
//   where the cluster's rank-0 block adds them in rank order, then alone
//   applies bias and D and writes C (so D may alias C). No atomics, no
//   second launch: a launch is bit-identical from run to run.
// - The plan (variant, S) comes from a cost model fitted to measured times
//   (choose_dense below; kernels/bgemm_sweep.py --bf16 measures every plan)
//   and is chosen for `plan_batch` folds (ops.plan_folds), so a fold's
//   sums do not depend on how many folds a launch carries: a fold-sharded
//   run stays bit-equal to the unsharded one.
// Every dense launch goes through cudaLaunchKernelExC (capturable in a CUDA
// graph); shared memory above 48 KB is enabled once per device.
#include "bgemm_paths.cuh"

namespace {

constexpr int BM = 32, BN = 32;  // block tile
constexpr int THREADS = 128;     // 4 warps, a 16 x 16 quarter each
constexpr int LDMN = BM + 4;  // shared row stride of an operand along m / n

// shared row stride of an operand stored along k, for BK-deep slices
template <int BK>
__host__ __device__ constexpr int ld_k() {
  return BK + 8;
}

// floats of one stage of an operand, as stored
template <int BK, bool ALONG_MN>
__host__ __device__ constexpr int stage_floats() {
  return ALONG_MN ? BK * LDMN : BM * ld_k<BK>();
}

template <int BK, int STAGES, bool AK, bool BKM>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * STAGES * (stage_floats<BK, AK>() + stage_floats<BK, BKM>());
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

// Two fp32 values rounded to a bf16 pair (lo in the low half: the smaller
// k of a fragment register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The fragment register of row r (m or n) and ks k, k + 1 from one stage
// of an operand in shared memory, stored along m or n ([k][r]) or along k
// ([r][k]); LD is its row stride.
template <bool ALONG_MN, int LD>
__device__ __forceinline__ uint32_t frag(const float* s, int r, int k) {
  if constexpr (ALONG_MN) {
    return pack_bf16(s[k * LD + r], s[(k + 1) * LD + r]);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(s + r * LD + k);
    return pack_bf16(v.x, v.y);
  }
}

// The dense path. AK: A stored K x M (ta); BKM: B stored K x N (!tb).
// Grid (N tiles x S, M tiles, F); clusters (S, 1, 1), the rank blockIdx.x
// % S. Warp w takes rows (w / 2) 16 .. + 16 and columns (w % 2) 16 .. + 16
// of the block tile.
template <int BK, int STAGES, bool AK, bool BKM>
__global__ void __launch_bounds__(THREADS)
    dense_kernel(Args p, int S, int vecA, int vecB) {
  constexpr int SA = stage_floats<BK, AK>();
  constexpr int SB = stage_floats<BK, BKM>();
  constexpr int LDA = AK ? LDMN : ld_k<BK>();
  constexpr int LDB = BKM ? LDMN : ld_k<BK>();
  static_assert(8 * THREADS <= STAGES * (SA + SB), "reduction buffer");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* As = smem;
  float* Bs = smem + STAGES * SA;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % S;
  const int n0 = (blockIdx.x / S) * BN, m0 = blockIdx.y * BM;
  const int f = blockIdx.z;
  const float* Ab = p.A + f * p.sA;
  const float* Bb = p.B + f * p.sB;

  const int nk = (p.K + BK - 1) / BK;
  const int kb = split * nk / S, ke = (split + 1) * nk / S;
  const int cnt = ke - kb;

  auto load = [&](int buf, int slice) {
    const int k0 = slice * BK;
    float* as = As + buf * SA;
    float* bs = Bs + buf * SB;
    if (AK)
      load_tile<BK, BM, THREADS, LDA>(as, Ab, p.ldA, p.K, p.M, k0, m0, vecA);
    else
      load_tile<BM, BK, THREADS, LDA>(as, Ab, p.ldA, p.M, p.K, m0, k0, vecA);
    if (BKM)
      load_tile<BK, BN, THREADS, LDB>(bs, Bb, p.ldB, p.K, p.N, k0, n0, vecB);
    else
      load_tile<BN, BK, THREADS, LDB>(bs, Bb, p.ldB, p.N, p.K, n0, k0, vecB);
  };

  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < cnt) load(s, kb + s);
    cp_async_commit();
  }
  for (int it = 0; it < cnt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nt = it + STAGES - 1;
    if (nt < cnt) load(nt % STAGES, kb + nt);
    cp_async_commit();
    const float* as = As + (it % STAGES) * SA;
    const float* bs = Bs + (it % STAGES) * SB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int k = kk + 2 * t;
      const uint32_t a[4] = {frag<AK, LDA>(as, wm + g, k),
                             frag<AK, LDA>(as, wm + g + 8, k),
                             frag<AK, LDA>(as, wm + g, k + 8),
                             frag<AK, LDA>(as, wm + g + 8, k + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + 8 * j + g;
        mma_bf16(acc[j], a, frag<BKM, LDB>(bs, n, k),
                 frag<BKM, LDB>(bs, n, k + 8));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The epilogue's operands, read into registers before any store to C
  // (D may alias C); issued now, they land during the cluster's exchange.
  // Output (r, j) of this thread: row wm + g + 8 (r / 2), column wn + 8 j
  // + 2 t + r % 2 (the accumulator layout).
  const bool writer = split == 0;
  float* Cb = p.C + f * p.sC;
  float bv[2][2], dv[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + wm + g + (r >= 2 ? 8 : 0);
      const int col = n0 + wn + 8 * j + 2 * t + (r & 1);
      const bool in = writer && row < p.M && col < p.N;
      if (r < 2)
        bv[j][r] = in && p.bias
                       ? bias_at(p.bias, f * p.sBias + col, p.rbias)
                       : 0.f;
      dv[j][r] = in && p.D ? p.D[f * p.sD + (long long)row * p.ldD + col]
                           : 0.f;
    }

  // the ring is free: the other ranks leave their partial tiles there
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    float* red = smem;
    if (split != 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[e * THREADS + tid] = acc[e / 4][e % 4];
    }
    cluster.sync();
    if (writer) {
      for (int q = 1; q < S; ++q) {
        const float* rr = cluster.map_shared_rank(red, q);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e / 4][e % 4] += rr[e * THREADS + tid];
      }
    }
    cluster.sync();  // the other ranks' shared memory stays until read
  }
  if (!writer) return;

#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + wm + g + (r >= 2 ? 8 : 0);
      const int col = n0 + wn + 8 * j + 2 * t + (r & 1);
      if (row < p.M && col < p.N)
        Cb[(long long)row * p.ldC + col] = acc[j][r] + bv[j][r & 1] + dv[j][r];
    }
}

// ---------------------------------------------------------------------------
// host side: variants, the plan, the launch
// ---------------------------------------------------------------------------

struct Variant {
  const void* fn[4];  // by (AK, BKM): (0,0), (0,1), (1,0), (1,1)
  int bk, stages, smem[4];
  // the cost model's fitted constants (us): fixed, per slice, per slice
  // more with B along n, the share more per further block an SM holds
  double fixed, slice, slice_bn, per_block;
};

template <int BK, int STAGES>
Variant make_variant(double fixed, double slice, double slice_bn,
                     double per_block) {
  Variant v;
  v.fn[0] = (const void*)dense_kernel<BK, STAGES, false, false>;
  v.fn[1] = (const void*)dense_kernel<BK, STAGES, false, true>;
  v.fn[2] = (const void*)dense_kernel<BK, STAGES, true, false>;
  v.fn[3] = (const void*)dense_kernel<BK, STAGES, true, true>;
  v.smem[0] = smem_bytes<BK, STAGES, false, false>();
  v.smem[1] = smem_bytes<BK, STAGES, false, true>();
  v.smem[2] = smem_bytes<BK, STAGES, true, false>();
  v.smem[3] = smem_bytes<BK, STAGES, true, true>();
  v.bk = BK;
  v.stages = STAGES;
  v.fixed = fixed;
  v.slice = slice;
  v.slice_bn = slice_bn;
  v.per_block = per_block;
  return v;
}

// (BK, STAGES): 32 x 3 (30 KB), 64 x 3 (54 KB)
constexpr int N_TILES = 2;
const Variant& variant(int t) {
  static const Variant table[N_TILES] = {
      make_variant<32, 3>(3.088, 0.217, 0.068, 0.338),
      make_variant<64, 3>(3.296, 0.364, 0.006, 0.53)};
  return table[t];
}

// SMs of each device, 0 until its first call there has enabled the
// variants' shared memory (54 KB for the 64-deep one)
std::atomic<int> g_sms[MAX_DEVICES];

int init_device(int* sms) {
  int dev = 0;
  int err = current_device(&dev);
  if (err) return err;
  *sms = g_sms[dev].load(std::memory_order_acquire);
  if (*sms > 0) return 0;
  int n = 0;
  err = (int)cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  for (int t = 0; t < N_TILES; ++t)
    for (int l = 0; l < 4; ++l) {
      err = (int)cudaFuncSetAttribute(
          variant(t).fn[l], cudaFuncAttributeMaxDynamicSharedMemorySize,
          variant(t).smem[l]);
      if (err) return err;
    }
  *sms = n > 0 ? n : 132;
  g_sms[dev].store(*sms, std::memory_order_release);
  return 0;
}

// Estimated microseconds of a dense launch: a fixed cost, the K slices of
// one block times the variant's slice cost (more with B stored along n),
// a share more for each further block the busiest SM holds, and the
// cluster's exchange for each of them. Fitted (least squares, soft L1) to
// the plans within 1.4x of the fastest at every dense product of the
// full-width bf16 GSR step on an H100 80GB HBM3 at 700 W
// (kernels/bgemm_sweep.py --bf16): rms 0.36 us; the plans it picks sum
// to within 0.4% of the fastest ones over the step's 52 dense launches.
void choose_dense(int M, int N, int K, int F, int tb, int sms, int* tile,
                  int* split) {
  double best = 1e30;
  *tile = 0;
  *split = 1;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) * F;
  for (int t = 0; t < N_TILES; ++t) {
    const Variant& v = variant(t);
    const int nk = (K + v.bk - 1) / v.bk;
    for (int s = 1; s <= 4 && s <= nk; s *= 2) {
      const long long ctas = tiles * s;
      const int kc = (nk + s - 1) / s;
      const long long per_sm = (ctas + sms - 1) / sms;
      const double exchange = s == 4 ? 0.68 : s == 2 ? 0.506 : 0.0;
      const double est =
          v.fixed + (v.slice + (tb ? 0.0 : v.slice_bn)) * kc *
                        (1.0 + v.per_block * (per_sm - 1)) +
          exchange * per_sm;
      if (est < best) {
        best = est;
        *tile = t;
        *split = s;
      }
    }
  }
}

// Plan codes as bgemm.cu's: cls * 10000 (+ vecB * 2000 + vecA * 1000 +
// tile * 10 + split if dense).
int plan(const Args& p, int batch, int ta, int tb, int sms) {
  const int cls = path_class(p.M, p.N, p.K, ta, tb);
  if (cls != DENSE) return cls * 10000;
  int tile, split;
  choose_dense(p.M, p.N, p.K, batch, tb, sms, &tile, &split);
  const int vecA = vec_ok(p.A, p.ldA, ta ? p.K : p.M, p.sA, batch);
  const int vecB = vec_ok(p.B, p.ldB, tb ? p.N : p.K, p.sB, batch);
  return vecB * 2000 + vecA * 1000 + tile * 10 + split;
}

// ``plan_batch`` (0: batch) is the fold count the dense tile and split-K
// are chosen for; ``forced`` (>= 0) a tile * 10 + split to take instead.
int launch(const Args& p, int batch, int ta, int tb, int forced,
           int plan_batch, void* stream) {
  if (batch <= 0 || p.M <= 0 || p.N <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cls = path_class(p.M, p.N, p.K, ta, tb);
  if (cls != DENSE) return launch_thin<true>(p, batch, ta, tb, cls, st);
  if (p.A == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = init_device(&sms);
  if (err) return err;
  const int code =
      forced >= 0 ? forced
                  : plan(p, plan_batch > 0 ? plan_batch : batch, ta, tb, sms);
  const int tile = (code / 10) % 10;
  int split = code % 10;
  if (tile >= N_TILES || (split != 1 && split != 2 && split != 4))
    return (int)cudaErrorInvalidValue;
  const Variant& v = variant(tile);
  const int nk = (p.K + v.bk - 1) / v.bk;
  while (split > nk) split /= 2;
  const int layout = (ta ? 2 : 0) + (tb ? 0 : 1);
  int vecA = vec_ok(p.A, p.ldA, ta ? p.K : p.M, p.sA, batch);
  int vecB = vec_ok(p.B, p.ldB, tb ? p.N : p.K, p.sB, batch);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p.N + BN - 1) / BN) * split),
                     (unsigned)((p.M + BM - 1) / BM), (unsigned)batch);
  cfg.blockDim = dim3((unsigned)THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)v.smem[layout];
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  Args a = p;
  void* args[] = {&a, &split, &vecA, &vecB};
  err = (int)cudaLaunchKernelExC(&cfg, v.fn[layout], args);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// fcsr_bgemm_f32's arguments, plus `round_bias`.
extern "C" int fcsr_bgemm_bf16(const float* A, const float* B,
                               const float* bias, const float* D, float* C,
                               int batch, int M, int N, int K, int ta, int tb,
                               long long sA, int ldA, long long sB, int ldB,
                               long long sBias, long long sD, int ldD,
                               long long sC, int ldC, int plan_batch,
                               int round_bias, void* stream) {
  const Args p = make_args(A, B, bias, D, C, M, N, K, sA, ldA, sB, ldB, sBias,
                           sD, ldD, sC, ldC, round_bias);
  return launch(p, batch, ta, tb, -1, plan_batch, stream);
}

// The plan fcsr_bgemm_bf16 takes for these arguments with plan_batch =
// batch (nothing launches): cls * 10000 (+ vecB * 2000 + vecA * 1000 +
// tile * 10 + split if dense).
extern "C" int fcsr_bgemm_bf16_plan(const float* A, const float* B, int batch,
                                    int M, int N, int K, int ta, int tb,
                                    long long sA, int ldA, long long sB,
                                    int ldB) {
  int sms = 0;
  if (init_device(&sms)) return -1;
  const Args p = make_args(A, B, nullptr, nullptr, nullptr, M, N, K, sA, ldA,
                           sB, ldB, 0, 0, 0, 0, 0, 0);
  return plan(p, batch, ta, tb, sms);
}

// A dense launch with the variant (an index into the table) and split
// given as tile * 10 + split, for measuring every plan; other shapes as
// usual.
extern "C" int fcsr_bgemm_bf16_forced(int code, const float* A,
                                      const float* B, const float* bias,
                                      const float* D, float* C, int batch,
                                      int M, int N, int K, int ta, int tb,
                                      long long sA, int ldA, long long sB,
                                      int ldB, long long sBias, long long sD,
                                      int ldD, long long sC, int ldC,
                                      int round_bias, void* stream) {
  const Args p = make_args(A, B, bias, D, C, M, N, K, sA, ldA, sB, ldB, sBias,
                           sD, ldD, sC, ldC, round_bias);
  return launch(p, batch, ta, tb, code % 100, 0, stream);
}

// Variant t of the table: bm * 1000000 + bn * 10000 + the slice depth *
// 100 + the ring's stages (-1 past the table; 4 warps each).
extern "C" int fcsr_bgemm_bf16_tile(int t) {
  if (t < 0 || t >= N_TILES) return -1;
  return BM * 1000000 + BN * 10000 + variant(t).bk * 100 + variant(t).stages;
}
