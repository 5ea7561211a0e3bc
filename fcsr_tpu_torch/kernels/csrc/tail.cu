// tail_elementwise: the non-product steps of the GSR spectral tail, forward
// and hand-written backward, batched over the fold axis.
//
// Replaces the elementwise and reduction part of the tail inside the TPU
// training-step kernel (fcsr_tpu/models/fused_step.py::
// _make_train_step_kernel, which runs jax.value_and_grad over
// fcsr_tpu/models/fused_tail.py::_tail_loss in-kernel):
//   tail_normalize      f_d = fill_diag(|T|, 1); r = rowsum(f_d)^-1/2 (inf->0);
//                       adj = D^-1/2 f_d^T D^-1/2 (the transposing form)
//   tail_normalize_bwd  its adjoint through the row-sum rsqrt, |.| and the
//                       diagonal fill, back to dT
//   sym_abs_fill        |fill_diag((X + X^T) / 2, 1)|
//   sym_sign_grad       the adjoint of sym_abs_fill: c (G + G^T), with
//                       G = g * sign(sym X), zero diagonal
//   l1_term             value_scale * mean|a - b| and its sign adjoint
//                       and, with its last term (the spectral one), the
//                       (loss, recon) scalars of a loss entry point: it
//                       stands where the TPU kernels of the loss entry
//                       points store their two (1, 1) outputs
//                       (fcsr_tpu/models/fused_tail.py:79-80,
//                       fused_step.py:286-287 and :721-722)
// Each matrix is 268 x 268 (288 KB) per fold: these kernels are bound by
// bytes moved (a few hundred KB each) and, at this size, by launch latency.
// The forward normalisation needs every row sum before any output, and
// l1_term one sum over the whole fold: each runs a thread-block cluster
// per fold whose blocks take a share of the fold and meet once in
// distributed shared memory, inside the one launch, in a fixed order (no
// atomics). The adjoint needs no such exchange (r is an input there) and
// runs in independent row bands across the card; sym_abs_fill and its
// adjoint run a block per pair of mirrored tiles. The wrappers
// (kernels/ops.py) plan the cluster launches and the pairs' 16-byte path
// on the host.
#include "common.cuh"

#include <type_traits>

namespace {

// tail_normalize: a cluster of C blocks per fold (grid (C, F)); block b
// owns rows I = [b R, b R + R). It stages T[I, :] in shared memory with
// cp.async, sums each row in a fixed lane-strided order and a shuffle
// tree (warp per row: r is the same bits whatever the plan), and writes
// r_i into the r array of every block of the cluster. After one cluster
// barrier each block holds all m of r and writes COLUMNS I of adj from
// the rows it holds: adj[j, i] = fd[i, j] r_j r_i for every j, as m runs
// of R contiguous floats. T is read from memory once and adj written
// once. The staged rows have stride ld: = 4 (mod 32) with 16-byte copies
// where m % 4 == 0 and T is 16-byte aligned (vec), else odd with 4-byte
// ones, so the transposed reads of the writes meet at most 2-3 to a bank.
// Where R rows do not fit in shared memory (m past ~950 at C = 16) the
// block sums its rows straight from memory and stages them again for the
// writes, J columns at a time (4-byte copies, odd ld). At F = 3, m = 268,
// C = 16: 48 blocks, 17 rows each, 20 KB staged. On an H100 (700 W),
// timed in turns in CUDA graphs: 0.0063 ms, against 0.0068 with 4-byte
// staging, 0.0079-0.0090 at C = 8, 0.0100 in chunks of 64 columns (one
// 1024-thread block per fold, reading T down columns, took 0.035). The
// wrapper takes C = 16 at every m.
constexpr int NORM_THREADS = 512;

__global__ void __launch_bounds__(NORM_THREADS)
    tail_normalize_kernel(const float* __restrict__ t,
                          float* __restrict__ adj, float* __restrict__ r_out,
                          int m, int R, int J, int ld, int vec) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), b = (int)cluster.block_rank();
  const int f = blockIdx.y, i0 = b * R;
  const int rows = max(0, min(R, m - i0));
  const size_t mm = (size_t)m * m;
  const float* T = t + f * mm;
  float* A = adj + f * mm;
  float* r = sh;           // m: r of every row, own and pushed by the peers
  float* tile = sh + m;    // rows x ld: tile[c ld + jj] = T[i0 + c, j0 + jj]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const bool staged = J >= m;

  auto stage = [&](int j0, int cols) {
    if (vec) {  // whole rows, 16 bytes a copy
      const int q4 = m >> 2;
      for (int e = tid; e < rows * q4; e += NORM_THREADS) {
        const int c = e / q4, jj = 4 * (e - c * q4);
        cp_async16(tile + c * ld + jj, T + (size_t)(i0 + c) * m + jj, 16);
      }
    } else {
      for (int e = tid; e < rows * cols; e += NORM_THREADS) {
        const int c = e / cols, jj = e - c * cols;
        cp_async4(tile + c * ld + jj, T + (size_t)(i0 + c) * m + j0 + jj, 4);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  cluster_arrive();  // this block has started: peers may write into r
  if (staged) stage(0, m);
  cluster_wait();    // every block of the cluster has started
  for (int c = w; c < rows; c += NORM_THREADS / 32) {
    const int i = i0 + c;
    float acc = 0.f;
    if (staged) {
      for (int j = lane; j < m; j += 32)
        acc += (j == i) ? 1.f : fabsf(tile[c * ld + j]);
    } else {
      for (int j = lane; j < m; j += 32)
        acc += (j == i) ? 1.f : fabsf(T[(size_t)i * m + j]);
    }
    acc = __shfl_sync(0xffffffffu, warp_sum(acc), 0);
    float ri = 1.f / sqrtf(acc);  // 0 -> inf -> 0 below; < 0 -> NaN
    if (isinf(ri)) ri = 0.f;
    for (int q = lane; q < C; q += 32) cluster.map_shared_rank(r, q)[i] = ri;
    if (lane == 0) r_out[(size_t)f * m + i] = ri;
  }
  cluster_arrive();  // this block's r is in every block
  cluster_wait();    // every block's r is here; no remote access after this

  for (int j0 = 0; j0 < m; j0 += J) {
    const int cols = min(J, m - j0);
    if (!staged) {
      __syncthreads();  // the previous chunk is written out
      stage(j0, cols);
    }
    for (int e = tid; e < rows * cols; e += NORM_THREADS) {
      const int jj = e / rows, c = e - jj * rows;
      const int i = i0 + c, j = j0 + jj;
      const float fd = (i == j) ? 1.f : fabsf(tile[c * ld + jj]);
      A[(size_t)j * m + i] = fd * r[j] * r[i];
    }
  }
}

// adj[i, j] = fd[j, i] r_i r_j, r_q = rs_q^-1/2, rs_q = sum_k fd[q, k]:
//   d r_i   = sum_q r_q (g[q, i] fd[i, q] + g[i, q] fd[q, i])
//   d rs_i  = -1/2 rs_i^-3/2 d r_i = -1/2 r_i^3 d r_i
//   d fd[i, j] = g[j, i] r_i r_j + d rs_i;  dT = d fd * sign(T), 0 on diag
// Output row i reads only row i and column i of g and T (r is an input),
// so row bands are independent: block (b, f) owns rows I = [b R, b R + R)
// of fold f. It stages T[I, :], g[I, :] (R contiguous rows), T[:, I],
// g[:, I] (m runs of R floats, transposed into rows padded against bank
// conflicts) and r with cp.async, all in flight at once; then warp c takes
// row i0 + c: its sum over q in a fixed lane-strided order and a shuffle
// tree, then the row of dT, coalesced. One launch, no atomics: the same
// bits from run to run, whatever R. At F = 3, m = 268, R = 8 that is 102
// blocks of 8 warps, each staging 37 KB (one block per fold, reading g and
// T down columns at a 32-byte sector per float, took 17x as long).
template <int R>
__global__ void __launch_bounds__(R * 32)
    tail_normalize_bwd_kernel(const float* __restrict__ g_adj,
                              const float* __restrict__ t,
                              const float* __restrict__ r_in,
                              float* __restrict__ g_t, int m, int ld) {
  extern __shared__ float sh[];
  const int f = blockIdx.y, i0 = blockIdx.x * R;
  const int rows = min(R, m - i0);
  const size_t mm = (size_t)m * m;
  const float* T = t + f * mm;
  const float* G = g_adj + f * mm;
  float* r = sh;                    // m
  float* rowT = r + m;              // R x m: T[i0 + c, :]
  float* rowG = rowT + R * m;       // R x m: g[i0 + c, :]
  float* colT = rowG + R * m;       // R x ld: colT[c ld + q] = T[q, i0 + c]
  float* colG = colT + R * ld;      // R x ld: g[q, i0 + c]
  const int tid = threadIdx.x;
  for (int e = tid; e < m; e += R * 32) cp_async4(r + e, r_in + f * m + e, 4);
  for (int e = tid; e < rows * m; e += R * 32) {
    cp_async4(rowT + e, T + i0 * m + e, 4);
    cp_async4(rowG + e, G + i0 * m + e, 4);
  }
  // lanes along the band's R columns, then down q: 32 / R runs per warp
  for (int e = tid; e < m * R; e += R * 32) {
    const int q = e / R, c = e % R;
    if (c < rows) {
      cp_async4(colT + c * ld + q, T + q * m + i0 + c, 4);
      cp_async4(colG + c * ld + q, G + q * m + i0 + c, 4);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int c = tid >> 5, lane = tid & 31;
  if (c >= rows) return;
  const int i = i0 + c;
  const float* tr = rowT + c * m;
  const float* gr = rowG + c * m;
  const float* tc = colT + c * ld;
  const float* gc = colG + c * ld;
  float acc = 0.f;
  for (int q = lane; q < m; q += 32) {
    const float fd_iq = (q == i) ? 1.f : fabsf(tr[q]);
    const float fd_qi = (q == i) ? 1.f : fabsf(tc[q]);
    acc += gc[q] * fd_iq * r[q];
    acc += gr[q] * r[q] * fd_qi;
  }
  acc = __shfl_sync(0xffffffffu, warp_sum(acc), 0);
  const float ri = r[i];
  const float grs = acc * -0.5f * (ri * ri * ri);
  float* out = g_t + f * mm + i * m;
  for (int j = lane; j < m; j += 32) {
    float v = 0.f;
    if (j != i) v = (gc[j] * ri * r[j] + grs) * abs_grad_sign(tr[j]);
    out[j] = v;
  }
}

// sym_abs_fill and sym_sign_grad: out[i, j] and out[j, i] come from the
// same two entries of each input, so a block owns an unordered pair of
// T x T tiles, (ti, tj) with ti <= tj, and its mirror (tj, ti): grid
// (pairs, F), pairs = nt (nt + 1) / 2, nt = ceil(m / T); blockIdx.x = p
// maps to tj (tj + 1) / 2 + ti. Each thread loads its units (VW floats
// along a row: 16-byte loads where VEC, m % 4 == 0 and every pointer
// 16-byte aligned, else 4-byte) of the tile and of its mirror, every
// input, all before the first use: the tile's values stay in registers,
// the mirror's go to shared memory in rows of T + 1 floats (the
// transposed reads meet no bank twice at T = 32). A thread computes
// its units of the tile once and stores them as rows of out(ti, tj); it
// writes each value over the one mirror entry that it alone read, so
// after one barrier the mirror tile holds the transposed result and is
// stored as rows of out(tj, ti): every element is read once and written
// once, all coalesced, no per-element division. A diagonal pair is one
// tile, its own mirror: each thread stores its own positions (an
// unordered entry there is computed by both its threads, sparing the
// barrier). Bound by bytes (2 and 3 tensors of 862 KB at F = 3, m =
// 268), and at this size by launch latency. The tile edge and the
// threads per block are fixed (SYM_T, SYM_THREADS: best or tied in a
// sweep of 16, 32 and 64 float tiles on the card, PERF.md); the wrapper
// plans the 16-byte path (ops.sym_tiles_plan).
//
// Bits, equal to the plain version's: (x_ij + x_ji) / 2 is the same float
// for both mirrors (addition commutes), the adjoint c (G_ij s) + c (G_ji s)
// is written with __fmul_rn / __fadd_rn (no FMA contraction), the sign
// is abs_grad_sign (+1 at +-0, -1 at NaN); the diagonal is 1 in the
// forward and c 0 + c 0 in the adjoint, as the plain version computes it.
__device__ __forceinline__ float sym_abs_fill_value(float a, float b) {
  return fabsf((a + b) / 2.f);
}

__device__ __forceinline__ float sym_sign_grad_value(float g_ij, float g_ji,
                                                     float x_ij, float x_ji,
                                                     float c) {
  const float s = abs_grad_sign((x_ij + x_ji) / 2.f);
  return __fadd_rn(__fmul_rn(c, __fmul_rn(g_ij, s)),
                   __fmul_rn(c, __fmul_rn(g_ji, s)));
}

constexpr int SYM_T = 32, SYM_THREADS = 256;

template <bool VEC, bool GRAD>
__global__ void __launch_bounds__(SYM_THREADS)
    sym_tiles_kernel(const float* __restrict__ g,
                     const float* __restrict__ x, float c,
                     float* __restrict__ out, int m) {
  constexpr int T = SYM_T, THREADS = SYM_THREADS;
  constexpr int VW = VEC ? 4 : 1;       // floats per unit
  constexpr int UR = T / VW;            // units per tile row
  constexpr int UPT = T * T / VW / THREADS;  // units per thread
  constexpr int NIN = GRAD ? 2 : 1;     // inputs: x, and g first
  constexpr int LD = T + 1;
  static_assert(UPT >= 1 && UPT * THREADS * VW == T * T, "tile / threads");
  using V = typename std::conditional<VEC, float4, float>::type;
  __shared__ float mir[NIN][T * LD];    // mir[k][r LD + c]: mirror tile
  int ti, tj;
  sym_pair(blockIdx.x, ti, tj);
  const bool diag = ti == tj;
  const size_t base = (size_t)blockIdx.y * m * m;
  const float* in[NIN];
  if constexpr (GRAD) {
    in[0] = g + base;
    in[1] = x + base;
  } else {
    in[0] = x + base;
  }
  float* o = out + base;
  const int i0 = ti * T, j0 = tj * T;   // the tile's first row, column

  // every load first: the tile into registers, its mirror (unless the
  // pair is one tile) into registers on their way to shared memory
  float a[NIN][UPT][VW], b[NIN][UPT][VW];
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / UR, cc = (e % UR) * VW;
    const bool in_a = i0 + r < m && j0 + cc < m;
    const bool in_b = !diag && j0 + r < m && i0 + cc < m;
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      V va = {}, vb = {};
      if (in_a)
        va = *reinterpret_cast<const V*>(in[k] + (size_t)(i0 + r) * m + j0 +
                                         cc);
      if (in_b)
        vb = *reinterpret_cast<const V*>(in[k] + (size_t)(j0 + r) * m + i0 +
                                         cc);
      const float* pa = reinterpret_cast<const float*>(&va);
      const float* pb = reinterpret_cast<const float*>(&vb);
#pragma unroll
      for (int q = 0; q < VW; ++q) {
        a[k][u][q] = pa[q];
        b[k][u][q] = pb[q];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / UR, cc = (e % UR) * VW;
#pragma unroll
    for (int k = 0; k < NIN; ++k)
#pragma unroll
      for (int q = 0; q < VW; ++q)
        mir[k][r * LD + cc + q] = diag ? a[k][u][q] : b[k][u][q];
  }
  __syncthreads();

  // the tile: out[i0 + r, j0 + cc + q] from its own entry and the mirror's
  // [cc + q, r]; the value then replaces that mirror entry
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / UR, cc = (e % UR) * VW;
    float v[VW];
#pragma unroll
    for (int q = 0; q < VW; ++q) {
      const int t = (cc + q) * LD + r;
      if (diag && r == cc + q) {
        v[q] = GRAD ? __fadd_rn(__fmul_rn(c, 0.f), __fmul_rn(c, 0.f)) : 1.f;
      } else if constexpr (GRAD) {
        v[q] = sym_sign_grad_value(a[0][u][q], mir[0][t], a[1][u][q],
                                   mir[1][t], c);
      } else {
        v[q] = sym_abs_fill_value(a[0][u][q], mir[0][t]);
      }
    }
    if (i0 + r < m && j0 + cc < m) {
      if constexpr (VEC)
        *reinterpret_cast<float4*>(o + (size_t)(i0 + r) * m + j0 + cc) =
            make_float4(v[0], v[1], v[2], v[3]);
      else
        o[(size_t)(i0 + r) * m + j0 + cc] = v[0];
    }
    if (!diag) {
#pragma unroll
      for (int q = 0; q < VW; ++q) mir[0][(cc + q) * LD + r] = v[q];
    }
  }
  if (diag) return;  // block-uniform
  __syncthreads();

  // the mirror: out[j0 + r, i0 + cc + q] = mir[0][r, cc + q], as rows
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / UR, cc = (e % UR) * VW;
    if (j0 + r < m && i0 + cc < m) {
      const float* s = &mir[0][r * LD + cc];
      if constexpr (VEC)
        *reinterpret_cast<float4*>(o + (size_t)(j0 + r) * m + i0 + cc) =
            make_float4(s[0], s[1], s[2], s[3]);
      else
        o[(size_t)(j0 + r) * m + i0 + cc] = s[0];
    }
  }
}

template <bool GRAD>
int launch_sym(const float* g, const float* x, float c, float* out,
               int batch, int m, int vec, cudaStream_t st) {
  if (batch <= 0 || m <= 0) return 0;
  const long long nt = (m + (long long)SYM_T - 1) / SYM_T,
                  pairs = nt * (nt + 1) / 2;
  if (batch > 65535 || pairs >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (vec && !(m % 4 == 0 && aligned16(x) && aligned16(out) &&
               (!GRAD || aligned16(g))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)pairs, (unsigned)batch);
  if (vec)
    sym_tiles_kernel<true, GRAD><<<grid, SYM_THREADS, 0, st>>>(g, x, c, out,
                                                               m);
  else
    sym_tiles_kernel<false, GRAD><<<grid, SYM_THREADS, 0, st>>>(g, x, c, out,
                                                                m);
  return (int)cudaGetLastError();
}

// l1_term: vals[f][slot] = value_scale * mean|a - b|, grad =
// gsign(a - b) * grad_scale, neg = -grad (either may be null). A cluster
// of C blocks per fold (grid (C, F)); block b takes the contiguous groups
// of 4 elements [b G, b G + G) and streams them once: |a - b| summed per
// thread in group order, the sign adjoint written as it goes (16-byte
// loads and stores where VEC: a, b and both batch strides 16-byte
// aligned, n % 4 == 0; else 4-byte, the same order and bits). The block's
// sum (warp trees, then the warps in order) goes into rank 0's shared
// memory; after one cluster barrier rank 0 adds the C partials in rank
// order and writes vals, and with ``loss`` (slot 2 only) the loss entry
// point's scalars from the fold's three terms. No atomics: the same bits from run to run, and
// for a given C whatever the alignment. At F = 3, n = 71 824, C = 16: 48
// blocks of 256 threads. On an H100 (700 W), timed in turns in CUDA
// graphs: 1 / 2 / 4 / 8 / 16 blocks per fold 0.0140 / 0.0090 / 0.0061 /
// 0.0046 / 0.0040 ms (one 1024-thread block per fold took 0.017); the
// wrapper takes the fewest blocks that leave each thread about 4 groups.
constexpr int L1_THREADS = 256;
constexpr int L1_TERMS = 3;  // vals[f] = [lmbda * L1(net, start), recon,
                             // spectral]

template <bool VEC>
__global__ void __launch_bounds__(L1_THREADS)
    l1_term_kernel(const float* __restrict__ a, long long sa,
                   const float* __restrict__ b, long long sb, int n, int G,
                   float value_scale, float grad_scale, int zero_sign,
                   float* __restrict__ vals, int slot,
                   float* __restrict__ grad, float* __restrict__ neg,
                   float* __restrict__ loss, float* __restrict__ recon,
                   int with_l1) {
  __shared__ float parts[16];  // rank 0's: the cluster's partial sums
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int f = blockIdx.y;
  const float* A = a + f * sa;
  const float* B = b + f * sb;
  float* Gr = grad ? grad + (size_t)f * n : nullptr;
  float* Ng = neg ? neg + (size_t)f * n : nullptr;
  const int groups = (n + 3) / 4;
  const int g1 = min(groups, (rank + 1) * G);

  cluster_arrive();  // this block has started: rank 0 may be written
  float acc = 0.f;
  for (int g = rank * G + threadIdx.x; g < g1; g += L1_THREADS) {
    const int e = 4 * g;
    float d[4];
    if constexpr (VEC) {
      const float4 va = *reinterpret_cast<const float4*>(A + e);
      const float4 vb = *reinterpret_cast<const float4*>(B + e);
      d[0] = va.x - vb.x;
      d[1] = va.y - vb.y;
      d[2] = va.z - vb.z;
      d[3] = va.w - vb.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = e + k < n ? A[e + k] - B[e + k] : 0.f;
    }
    float s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc += fabsf(d[k]);  // + 0 past n: the same bits as stopping
      s[k] = (zero_sign ? sign0(d[k]) : abs_grad_sign(d[k])) * grad_scale;
    }
    if (Gr) {
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(Gr + e) = make_float4(s[0], s[1], s[2], s[3]);
        if (Ng)
          *reinterpret_cast<float4*>(Ng + e) =
              make_float4(-s[0], -s[1], -s[2], -s[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (e + k < n) {
            Gr[e + k] = s[k];
            if (Ng) Ng[e + k] = -s[k];
          }
      }
    }
  }
  acc = block_sum(acc);
  cluster_wait();    // every block has started
  if (threadIdx.x == 0) cluster.map_shared_rank(parts, 0)[rank] = acc;
  cluster_arrive();  // this block's partial is in rank 0
  cluster_wait();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int q = 0; q < C; ++q) total += parts[q];
    float* V = vals + (size_t)f * L1_TERMS;
    const float value = value_scale * (total / (float)n);
    V[slot] = value;
    // The loss entry point's scalars, with the last term: slots 0 (the
    // step's L1 term) and 1 (recon) were written by earlier launches on
    // this stream. loss = recon + spectral, then the L1 term in front
    // (adam_masked's order: the same bits as its loss); slot 0 is not
    // read without with_l1 (the tail's entry point never writes it).
    if (loss) {
      const float tail = __fadd_rn(V[1], value);
      loss[f] = with_l1 ? __fadd_rn(V[0], tail) : tail;
      if (recon) recon[f] = V[1];
    }
  }
}

// Rows per band: 8 ran 0.0037 ms against 4's 0.0041 at F = 3, m = 268 on
// an H100, so the kernel takes 8. Where a band's tiles exceed the card's
// shared memory R halves, down to 1 row (m up to ~11 600).
constexpr int BWD_ROWS = 8;

// The cluster kernels' attributes, set once on their first launch (so no
// later launch, none inside a CUDA graph capture, sets one): clusters of
// up to 16 blocks (past the portable 8) and, for tail_normalize, the
// card's opt-in shared memory.
int init_cluster_kernels() {
  static bool done = false;
  if (done) return 0;
  int err = read_smem_optin();
  if (err) return err;
  const void* fns[] = {(const void*)tail_normalize_kernel,
                       (const void*)l1_term_kernel<true>,
                       (const void*)l1_term_kernel<false>};
  for (const void* fn : fns) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  err = (int)cudaFuncSetAttribute(
      (const void*)tail_normalize_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_optin);
  if (err) return err;
  done = true;
  return 0;
}

template <int R>
int launch_bwd(const float* g_adj, const float* t, const float* r, float* g_t,
               int batch, int m, cudaStream_t st) {
  // the transposed tiles' row stride: ld = 32 / R (mod 32), so the R runs
  // of one warp's cp.async land in distinct banks
  const int ld = m + ((32 / R - m % 32) % 32 + 32) % 32;
  const size_t smem = sizeof(float) * ((size_t)m + 2 * R * (size_t)m +
                                       2 * R * (size_t)ld);
  if (smem > 48 * 1024) {
    const int err = read_smem_optin();
    if (err) return err;
    if (smem > (size_t)g_smem_optin) {
      if constexpr (R == 1)
        return (int)cudaErrorInvalidValue;
      else
        return launch_bwd<R / 2>(g_adj, t, r, g_t, batch, m, st);
    }
    // once per instance: its limit raised to the card's, so no later
    // launch (none inside a CUDA graph capture) sets an attribute
    static bool raised = false;
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          tail_normalize_bwd_kernel<R>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_optin);
      if (err != cudaSuccess) return (int)err;
      raised = true;
    }
  }
  dim3 grid((m + R - 1) / R, batch);
  tail_normalize_bwd_kernel<R><<<grid, R * 32, smem, st>>>(g_adj, t, r, g_t,
                                                           m, ld);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (cluster size, rows per block, columns per staged chunk, the
// tile's row stride, 16-byte copies) comes from the wrapper
// (ops.tail_normalize_plan, sized against the card's opt-in shared memory,
// which is checked again here): chunk >= m stages the block's rows once,
// else J columns at a time; 16-byte copies stage whole rows only.
extern "C" int fcsr_tail_normalize(const float* t, float* adj, float* r,
                                   int batch, int m, int cluster, int rows,
                                   int chunk, int ld, int vec, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  if (cluster < 1 || cluster > 16 || rows < 1 ||
      (long long)cluster * rows < m || chunk < 1 ||
      ld < (chunk < m ? chunk : m))
    return (int)cudaErrorInvalidValue;
  if (vec && !(chunk >= m && m % 4 == 0 && ld % 4 == 0 && aligned16(t)))
    return (int)cudaErrorInvalidValue;
  const int err = init_cluster_kernels();
  if (err) return err;
  const size_t smem = sizeof(float) * ((size_t)m + (size_t)rows * ld);
  if (smem > (size_t)g_smem_optin) return (int)cudaErrorInvalidValue;
  void* args[] = {&t, &adj, &r, &m, &rows, &chunk, &ld, &vec};
  return launch_cluster((const void*)tail_normalize_kernel,
                        dim3((unsigned)cluster, (unsigned)batch), cluster,
                        NORM_THREADS, smem, (cudaStream_t)stream, args);
}

extern "C" int fcsr_tail_normalize_bwd(const float* g_adj, const float* t,
                                       const float* r, float* g_t, int batch,
                                       int m, void* stream) {
  return launch_bwd<BWD_ROWS>(g_adj, t, r, g_t, batch, m,
                              (cudaStream_t)stream);
}

// The 16-byte path comes from the wrapper (ops.sym_tiles_plan); one
// that m or the pointers do not allow is refused, as is F > 65535.
extern "C" int fcsr_sym_abs_fill(const float* x, float* out, int batch,
                                 int m, int vec, void* stream) {
  return launch_sym<false>(nullptr, x, 0.f, out, batch, m, vec,
                           (cudaStream_t)stream);
}

extern "C" int fcsr_sym_sign_grad(const float* g, const float* x, float c,
                                  float* out, int batch, int m, int vec,
                                  void* stream) {
  return launch_sym<true>(g, x, c, out, batch, m, vec, (cudaStream_t)stream);
}

// The plan (cluster size, groups of 4 elements per block, 16-byte path)
// comes from the wrapper (ops.l1_term_plan); a 16-byte path the pointers
// or strides do not allow is refused, as are a slot outside vals' three,
// and loss with another slot than the last (or recon without loss).
extern "C" int fcsr_l1_term(const float* a, long long sa, const float* b,
                            long long sb, int n, float value_scale,
                            float grad_scale, int zero_sign, float* vals,
                            int slot, float* grad, float* neg, float* loss,
                            float* recon, int with_l1, int batch,
                            int cluster, int per_block, int vec,
                            void* stream) {
  if (batch <= 0) return 0;
  if (n < 1 || cluster < 1 || cluster > 16 ||
      (long long)cluster * per_block < (n + 3) / 4 || !vals || slot < 0 ||
      slot >= L1_TERMS || (recon && !loss) ||
      (loss && slot != L1_TERMS - 1))
    return (int)cudaErrorInvalidValue;
  if (vec && !(n % 4 == 0 && aligned16(a) && aligned16(b) &&
               (!grad || aligned16(grad)) && (!neg || aligned16(neg)) &&
               (batch == 1 || (sa % 4 == 0 && sb % 4 == 0))))
    return (int)cudaErrorInvalidValue;
  const int err = init_cluster_kernels();
  if (err) return err;
  void* args[] = {&a,         &sa,        &b,           &sb,
                  &n,         &per_block, &value_scale, &grad_scale,
                  &zero_sign, &vals,      &slot,        &grad,
                  &neg,       &loss,      &recon,       &with_l1};
  return launch_cluster(vec ? (const void*)l1_term_kernel<true>
                            : (const void*)l1_term_kernel<false>,
                        dim3((unsigned)cluster, (unsigned)batch), cluster,
                        L1_THREADS, 0, (cudaStream_t)stream, args);
}
