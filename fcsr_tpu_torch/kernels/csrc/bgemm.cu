// bgemm_f32: batched C = op(A) op(B) [+ bias row] [+ D] in IEEE fp32.
//
// Replaces the in-kernel matrix products of the TPU training-step kernels:
// fcsr_tpu/models/fused_step.py:925 (train_step_fused's pallas_call, whose
// body runs every U-Net and spectral-tail product through
// core/mosaic_mm.py::mm, compensated bf16x3) and fcsr_tpu/models/
// fused_gat.py:497 / :547 (gat_train_step_fused / gat_val_fused, through
// mosaic_mm.mm_compensated). A GSR step launches 79 products (3.57 GFLOP
// at F = 3), a GAT step 44 (61 MFLOP); all are <= 268 x 268 x 536 per fold.
//
// Bound on an H100: fp32 FMAs outside the tensor cores (67 TFLOP/s). At
// these sizes that bound is 0.1-2 us against a 2-3 us launch, so the
// kernel is bound by latency and by how many of the 132 SMs a launch
// keeps busy. Tensor cores have no IEEE fp32 mode and TF32 would change
// the port's numbers; a 3xTF32 mode (the analogue of the reference's
// bf16x3) waits for a CUDA bench with the quality gates. TMA is not used:
// its 16-byte base and stride rules fail on the flat-buffer views (leaf
// views start 1-3 floats past a 16-byte boundary after the 1-element pool
// biases; leading dimensions of 1, 16 and 268 floats occur).
//
// One entry point, four paths, chosen on the host from the shape:
// - M = 1 (a == nullptr: column sums of op(B); N = 1 included) and N = 1
//   (matrix-vector, ta or not) are matrix-vector products y = X v.
//   Where X runs along k in memory, one warp per output with lanes along
//   k and a shuffle tree; where it runs along the outputs, lanes along
//   the outputs (coalesced) with k split over 8 warps, summed in warp
//   order. A square tile would waste 63/64 of itself on these.
// - K = 1 (rank-1 update plus add): one elementwise pass.
//   These two live in bgemm_paths.cuh, shared with bgemm_bf16.cu.
// - Otherwise the dense path: an output tile per block, 32 x 32 (128
//   threads: two warp groups, each a 4 x 4 register tile per thread over
//   alternate 4-deep chunks of each K slice, summed in shared memory at
//   the end) or 64 x 64 (256 threads), with the split-K factor below,
//   chosen from (M, N, K, F) by a cost model fitted to measured times: a
//   fixed cost, the K slices of one block times the tile's slice cost, the
//   blocks the busiest SM holds, the cluster's exchange. At F = 3 and
//   these widths 32 x 32 wins everywhere (108-243 blocks for the 61-268-row
//   products): on an H100 a 64 x 64 block's K slice costs 3x a 32 x 32
//   one, and larger register tiles (8 x 8, 8 x 4) measured no faster.
//   32-deep K slices stream through a 3-stage cp.async ring in shared
//   memory, so loads overlap the FMAs. Each operand is copied as it is
//   stored (16-byte copies where its base, row stride and batch stride
//   allow, else 4-byte ones), so global reads are coalesced for every
//   ta / tb; the transpose is folded into how the compute reads shared
//   memory: 128-bit shared loads along m / n or along k, whichever is
//   contiguous (rows padded by 4 floats: no bank conflicts). bias and D
//   are read into registers before any store (D may alias C).
// - Split-K across a thread-block cluster where M x N alone cannot fill
//   the card: S = 2 or 4 blocks of a cluster each take a contiguous K
//   range; the partial tiles meet in distributed shared memory, where the
//   cluster's rank-0 block adds them in rank order, then alone applies
//   bias / D and writes C (so D may alias C). No atomics, no second
//   launch: results are bit-identical from run to run.
// Every variant launches with cudaLaunchKernelExC (capturable in a CUDA
// graph); dynamic shared memory above 48 KB is enabled once per variant on
// the first call.
#include "bgemm_paths.cuh"

namespace {

constexpr int BK = 32;      // K slice per pipeline step
constexpr int STAGES = 3;   // depth of the cp.async ring
constexpr int PAD = 4;      // floats of padding per shared-memory row

// Copy rows [r0, r0 + TR) x cols [c0, c0 + TC) of a stored (rows x cols)
// operand with row stride ld into shared memory (row stride TC + PAD),
// zero outside the operand.
template <int TR, int TC, int THREADS>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int rows, int cols, int r0, int c0,
                                          int vec) {
  constexpr int LDS = TC + PAD;
  if (vec) {
    constexpr int VPR = TC / 4;
    constexpr int NV = TR * VPR;
#pragma unroll
    for (int it = 0; it < (NV + THREADS - 1) / THREADS; ++it) {
      const int v = threadIdx.x + it * THREADS;
      if (NV % THREADS == 0 || v < NV) {
        const int r = v / VPR, c = (v % VPR) * 4;
        const int gr = r0 + r, gc = c0 + c;
        const float* src = g;
        int bytes = 0;
        if (gr < rows && gc < cols) {
          const int left = cols - gc;
          bytes = 4 * (left < 4 ? left : 4);
          src = g + (long long)gr * ld + gc;
        }
        cp_async16(s + r * LDS + c, src, bytes);
      }
    }
  } else {
    constexpr int NE = TR * TC;
#pragma unroll
    for (int it = 0; it < (NE + THREADS - 1) / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      if (NE % THREADS == 0 || e < NE) {
        const int r = e / TC, c = e % TC;
        const int gr = r0 + r, gc = c0 + c;
        const bool in = gr < rows && gc < cols;
        cp_async4(s + r * LDS + c, in ? g + (long long)gr * ld + gc : g,
                  in ? 4 : 0);
      }
    }
  }
}

template <int BM, int BN, bool AK, bool BKM>
constexpr int smem_floats() {
  return STAGES * ((AK ? BK * (BM + PAD) : BM * (BK + PAD)) +
                   (BKM ? BK * (BN + PAD) : BN * (BK + PAD)));
}

// The dense path. AK: A stored K x M (ta); BKM: B stored K x N (!tb).
// Threads: KG groups of (BM / 4) x (BN / 4), each thread a 4 x 4 register
// tile; group g takes the 4-deep chunks g, g + KG, ... of every slice, and
// the groups' tiles are summed in group order at the end. A thread's rows
// are ty * 4 + i where A is stored K x M (one 128-bit load along m per
// k), else ty + i * BM / 4 (one 128-bit load along k per row); its
// columns likewise.
template <int BM, int BN, int KG, bool AK, bool BKM>
__global__ void __launch_bounds__(BM * BN / 16 * KG)
    dense_kernel(Args p, int S, int vecA, int vecB) {
  constexpr int TNx = BN / 4;
  constexpr int TMy = BM / 4;
  constexpr int TG = TMy * TNx;
  constexpr int THREADS = TG * KG;
  constexpr int SA = AK ? BK * (BM + PAD) : BM * (BK + PAD);
  constexpr int SB = BKM ? BK * (BN + PAD) : BN * (BK + PAD);
  static_assert(BK % (4 * KG) == 0, "slices");
  static_assert(16 * TG * (KG > 1 ? KG - 1 : 1) <= STAGES * (SA + SB),
                "reduction buffer");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* As = smem;
  float* Bs = smem + STAGES * SA;

  const int tid = threadIdx.x;
  const int kg = tid / TG, lt = tid % TG;
  const int tx = lt % TNx, ty = lt / TNx;
  const int split = blockIdx.x % S;  // the cluster rank: clusters are (S,1,1)
  const int n0 = (blockIdx.x / S) * BN, m0 = blockIdx.y * BM;
  const int f = blockIdx.z;
  const float* Ab = p.A + f * p.sA;
  const float* Bb = p.B + f * p.sB;
  auto row = [&](int i) { return m0 + (AK ? ty * 4 + i : ty + i * TMy); };
  auto col = [&](int j) { return n0 + (BKM ? tx * 4 + j : tx + j * TNx); };

  const int nk = (p.K + BK - 1) / BK;
  const int kb = split * nk / S, ke = (split + 1) * nk / S;
  const int cnt = ke - kb;

  auto load = [&](int buf, int slice) {
    const int k0 = slice * BK;
    if (AK)
      load_tile<BK, BM, THREADS>(As + buf * SA, Ab, p.ldA, p.K, p.M, k0, m0,
                                 vecA);
    else
      load_tile<BM, BK, THREADS>(As + buf * SA, Ab, p.ldA, p.M, p.K, m0, k0,
                                 vecA);
    if (BKM)
      load_tile<BK, BN, THREADS>(Bs + buf * SB, Bb, p.ldB, p.K, p.N, k0, n0,
                                 vecB);
    else
      load_tile<BN, BK, THREADS>(Bs + buf * SB, Bb, p.ldB, p.N, p.K, n0, k0,
                                 vecB);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < cnt) load(s, kb + s);
    cp_async_commit();
  }
  for (int t = 0; t < cnt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nt = t + STAGES - 1;
    if (nt < cnt) load(nt % STAGES, kb + nt);
    cp_async_commit();
    const float* as = As + (t % STAGES) * SA;
    const float* bs = Bs + (t % STAGES) * SB;
#pragma unroll
    for (int c = 0; c < BK / 4 / KG; ++c) {
      const int k4 = (c * KG + kg) * 4;
      float a[4][4], b[4][4];  // a[i][kk], b[j][kk]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            AK ? as + (k4 + q) * (BM + PAD) + ty * 4
               : as + (ty + q * TMy) * (BK + PAD) + k4);
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (AK) a[r][q] = w[r];
          else a[q][r] = w[r];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            BKM ? bs + (k4 + q) * (BN + PAD) + tx * 4
                : bs + (tx + q * TNx) * (BK + PAD) + k4);
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (BKM) b[r][q] = w[r];
          else b[q][r] = w[r];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The epilogue's operands, read into registers before any store to C:
  // D may alias C, so loads interleaved with the stores would each wait a
  // full memory latency. Issued now, they land during the reductions.
  const bool writer = kg == 0 && split == 0;
  float bv[4], dv[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bv[j] = writer && p.bias && col(j) < p.N ? p.bias[f * p.sBias + col(j)]
                                             : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dv[i][j] = writer && p.D && row(i) < p.M && col(j) < p.N
                     ? p.D[f * p.sD + (long long)row(i) * p.ldD + col(j)]
                     : 0.f;

  // the ring is free: reuse it to sum the warp groups, then the cluster
  float* red = smem;
  if (KG > 1) {
    if (kg > 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        red[((kg - 1) * 16 + e) * TG + lt] = acc[e / 4][e % 4];
    }
    __syncthreads();
    if (kg == 0) {
      for (int g = 0; g < KG - 1; ++g)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[e / 4][e % 4] += red[(g * 16 + e) * TG + lt];
    }
    __syncthreads();
  }
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (split != 0 && kg == 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) red[e * TG + lt] = acc[e / 4][e % 4];
    }
    cluster.sync();
    if (writer) {
      for (int r = 1; r < S; ++r) {
        const float* rr = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e / 4][e % 4] += rr[e * TG + lt];
      }
    }
    cluster.sync();  // the other ranks' shared memory stays until read
  }
  if (!writer) return;

  float* Cb = p.C + f * p.sC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row(i) >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col(j) < p.N)
        Cb[(long long)row(i) * p.ldC + col(j)] = acc[i][j] + bv[j] + dv[i][j];
  }
}

// ---------------------------------------------------------------------------
// host side: variants, the plan, the launch
// ---------------------------------------------------------------------------

struct Variant {
  const void* fn[4];  // by (AK, BKM): 0 = (0,0), 1 = (0,1), 2 = (1,0), 3 = (1,1)
  int bm, bn, kg, threads, smem[4];
  double cost;  // time of one K slice relative to the 32 x 32 tile's
};

template <int BM, int BN, int KG>
Variant make_variant(double cost) {
  Variant v;
  v.fn[0] = (const void*)dense_kernel<BM, BN, KG, false, false>;
  v.fn[1] = (const void*)dense_kernel<BM, BN, KG, false, true>;
  v.fn[2] = (const void*)dense_kernel<BM, BN, KG, true, false>;
  v.fn[3] = (const void*)dense_kernel<BM, BN, KG, true, true>;
  v.smem[0] = 4 * smem_floats<BM, BN, false, false>();
  v.smem[1] = 4 * smem_floats<BM, BN, false, true>();
  v.smem[2] = 4 * smem_floats<BM, BN, true, false>();
  v.smem[3] = 4 * smem_floats<BM, BN, true, true>();
  v.bm = BM;
  v.bn = BN;
  v.kg = KG;
  v.threads = BM * BN / 16 * KG;
  v.cost = cost;
  return v;
}

// 32 x 32 in two warp groups over k: the tile every census product of
// the GSR and GAT steps takes; 64 x 64 (a K slice 3x as long, measured)
// where a launch holds enough work to fill the card with it.
constexpr int N_TILES = 2;
const Variant& variant(int t) {
  static const Variant table[N_TILES] = {make_variant<32, 32, 2>(1.0),
                                         make_variant<64, 64, 1>(3.0)};
  return table[t];
}

// SMs of each device, 0 until its first call has set the tiles' shared
// memory attributes there
std::atomic<int> g_sms[MAX_DEVICES];

// The current device's SM count into *sms, its tiles set up on the first
// call there.
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

// Plan codes: cls * 10000 + vecB * 2000 + vecA * 1000 + tile * 10 + S
// (dense), cls alone for the others (bgemm_paths.cuh's path classes).

// Estimated microseconds of a dense launch, fitted to every plan's time
// at every dense product of the full-width GSR and GAT steps on an H100
// (kernels/bgemm_sweep.py): a fixed cost, the K slices of one block times
// the tile's slice cost, 1.5x for each further block the busiest SM holds,
// the cluster's exchange (~1 us), and a little per block.
void choose_dense(int M, int N, int K, int F, int sms, int* tile,
                  int* split) {
  const int nk = (K + BK - 1) / BK;
  double best = 1e30;
  *tile = 0;
  *split = 1;
  for (int t = 0; t < N_TILES; ++t) {
    const Variant& v = variant(t);
    const long long tiles =
        (long long)((M + v.bm - 1) / v.bm) * ((N + v.bn - 1) / v.bn) * F;
    for (int s = 1; s <= 4 && s <= nk; s *= 2) {
      const long long ctas = tiles * s;
      const int kc = (nk + s - 1) / s;
      const long long per_sm = (ctas + sms - 1) / sms;
      const double est = 1.8 + 0.35 * kc * v.cost * (1.0 + 0.5 * (per_sm - 1)) +
                         (s > 1 ? 1.0 : 0.0) + 0.002 * ctas;
      if (est < best) {
        best = est;
        *tile = t;
        *split = s;
      }
    }
  }
}

bool vec_ok(const float* ptr, int ld, int rows, long long stride, int batch) {
  return ptr != nullptr && ((uintptr_t)ptr & 15) == 0 &&
         (rows == 1 || (ld & 3) == 0) && (batch == 1 || (stride & 3) == 0);
}

int plan(const Args& p, int batch, int ta, int tb, int sms) {
  const int cls = path_class(p.M, p.N, p.K, ta, tb);
  if (cls != DENSE) return cls * 10000;
  int tile, split;
  choose_dense(p.M, p.N, p.K, batch, sms, &tile, &split);
  const int vecA = vec_ok(p.A, p.ldA, ta ? p.K : p.M, p.sA, batch);
  const int vecB = vec_ok(p.B, p.ldB, tb ? p.N : p.K, p.sB, batch);
  return vecB * 2000 + vecA * 1000 + tile * 10 + split;
}

// ``plan_batch`` (0: batch) is the fold count the dense tile and split-K
// are chosen for: a fold's sums depend on them alone, so a fold sharded
// over devices takes the order of the unsharded run.
int launch(const Args& p, int batch, int ta, int tb, int forced,
           int plan_batch, void* stream) {
  if (batch <= 0 || p.M <= 0 || p.N <= 0) return 0;
  int sms = 0;
  int err = init_device(&sms);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int cls = path_class(p.M, p.N, p.K, ta, tb);
  if (cls != DENSE) return launch_thin<false>(p, batch, ta, tb, cls, st);
  if (p.A == nullptr) return (int)cudaErrorInvalidValue;
  const int code =
      forced >= 0 ? forced
                  : plan(p, plan_batch > 0 ? plan_batch : batch, ta, tb, sms);
  int tile = (code / 10) % 10, split = code % 10;
  if (tile >= N_TILES || (split != 1 && split != 2 && split != 4))
    return (int)cudaErrorInvalidValue;
  const int nk = (p.K + BK - 1) / BK;
  while (split > nk) split /= 2;
  const Variant& v = variant(tile);
  const int layout = (ta ? 2 : 0) + (tb ? 0 : 1);
  int vecA = vec_ok(p.A, p.ldA, ta ? p.K : p.M, p.sA, batch);
  int vecB = vec_ok(p.B, p.ldB, tb ? p.N : p.K, p.sB, batch);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p.N + v.bn - 1) / v.bn) * split),
                     (unsigned)((p.M + v.bm - 1) / v.bm), (unsigned)batch);
  cfg.blockDim = dim3((unsigned)v.threads, 1, 1);
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

extern "C" int fcsr_bgemm_f32(const float* A, const float* B,
                              const float* bias, const float* D, float* C,
                              int batch, int M, int N, int K, int ta, int tb,
                              long long sA, int ldA, long long sB, int ldB,
                              long long sBias, long long sD, int ldD,
                              long long sC, int ldC, int plan_batch,
                              void* stream) {
  const Args p = make_args(A, B, bias, D, C, M, N, K, sA, ldA, sB, ldB, sBias,
                           sD, ldD, sC, ldC, 0);
  return launch(p, batch, ta, tb, -1, plan_batch, stream);
}

// The plan fcsr_bgemm_f32 takes for these arguments (nothing launches):
// cls * 10000 (+ vecB * 2000 + vecA * 1000 + tile * 10 + split if dense).
extern "C" int fcsr_bgemm_f32_plan(const float* A, const float* B, int batch,
                                   int M, int N, int K, int ta, int tb,
                                   long long sA, int ldA, long long sB,
                                   int ldB) {
  int sms = 0;
  if (init_device(&sms)) return -1;
  const Args p = make_args(A, B, nullptr, nullptr, nullptr, M, N, K, sA, ldA,
                           sB, ldB, 0, 0, 0, 0, 0, 0);
  return plan(p, batch, ta, tb, sms);
}

// The dense tile (0-5) and split (1, 2, 4) of a dense launch given as
// tile * 10 + split, for measuring every plan; other shapes as usual.
extern "C" int fcsr_bgemm_f32_forced(int code, const float* A,
                                     const float* B, const float* bias,
                                     const float* D, float* C, int batch,
                                     int M, int N, int K, int ta, int tb,
                                     long long sA, int ldA, long long sB,
                                     int ldB, long long sBias, long long sD,
                                     int ldD, long long sC, int ldC,
                                     void* stream) {
  const Args p = make_args(A, B, bias, D, C, M, N, K, sA, ldA, sB, ldB, sBias,
                           sD, ldD, sC, ldC, 0);
  return launch(p, batch, ta, tb, code % 100, 0, stream);
}

// Shape of tile t: bm * 1000000 + bn * 1000 + 4 * 100 + 4 * 10 + kg (a
// 4 x 4 tile per thread; -1 past the table).
extern "C" int fcsr_bgemm_f32_tile(int t) {
  if (t < 0 || t >= N_TILES) return -1;
  const Variant& v = variant(t);
  return v.bm * 1000000 + v.bn * 1000 + 440 + v.kg;
}
