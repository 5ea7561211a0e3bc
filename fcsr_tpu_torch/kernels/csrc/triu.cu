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
// no gather; here the two copies stage tiles in shared memory and write
// them in the order of their output.
//
// All three are bound by bytes (a copy with index arithmetic, plus n row
// sums). anti_vectorize_normalize and vectorize_colmajor walk the matrix
// by 32 x 32 tiles (the symmetric pair's map, sym_pair), staged in shared
// memory as rows of 33 floats, so that both sides of every copy are
// contiguous runs: row i of the upper tile (ti, tj) is one run of the
// row-major vector, column j's entries from it one run of the
// column-major vector. anti_vectorize_normalize reads each entry of v
// once with lanes on consecutive floats and writes the tile and its
// mirror as rows; vectorize_colmajor reads the upper tile's rows of M
// (lanes on consecutive floats, two matrices a block) and writes its
// columns as runs (lanes on consecutive addresses). Every access coalesced, every output written
// once. Normalised, every row sum of a matrix is needed before any
// output: a thread-block cluster per matrix splits its tile pairs, each
// block sums its pairs' rows and columns into partial row sums in its
// own shared memory, and after one cluster barrier each block adds the
// partials of the rows it writes in rank order (distributed shared
// memory, no atomics). normalize_adj_batch runs one block per matrix
// with the n reciprocal roots in shared memory and reads its input twice
// (the second time from L2).
//
// The guard is the reference's: only the infinite r of a ZERO row sum
// (-0.0 included) becomes 0; a negative row sum gives NaN and the NaN
// reaches the output. 1 / sqrtf is IEEE here (no fast-math).
#include "common.cuh"

namespace {

__device__ __forceinline__ float guarded_rsqrt(float rowsum) {
  return rowsum == 0.f ? 0.f : 1.f / sqrtf(rowsum);
}

// ---------------------------------------------------------------------------
// anti_vectorize_normalize. Two forms, planned on the host
// (ops.antivec_plan): 0, the copy: a block per (tile pair, matrix); 1,
// normalised: a cluster of C blocks per matrix, block b owning pairs
// [b per, b per + per), staged in chunks of up to AV_CHUNK tiles (a
// chunk's copies all in flight at once): v is read once where a block's
// pairs make one chunk (every CSV-path shape), else again for the writes.
// The grid's y extent holds up to 65 535 matrices; past that each block
// walks matrices blockIdx.y + k gridDim.y. At the CSV path's B = 167, n =
// 268: 9 tiles a side, 45 pairs, 7 515 blocks of 256 threads for the
// copy; normalised 6 blocks of 8 pairs a matrix. Bound by bytes: v read
// once, B n^2 floats written (72 MB at that shape). PERF.md gives the
// times warm (v in L2 on graph replays) and with L2 flushed.
//
// Bits: an entry written is v's value plus +0.f, as the reference's upper
// + upper^T adds the zero below the diagonal (-0.0 becomes +0.0); the
// diagonal is ``diag`` (+ 0.f: the wrapper passes +0.0 or a non-zero
// fill). The copy is the plain version bit for bit; the
// normalised form multiplies (a r_i) r_j in the plain version's order,
// and only its row sums take another order.
// ---------------------------------------------------------------------------
constexpr int AV_T = 32;                     // tile edge
constexpr int AV_THREADS = 256;              // 8 warps
constexpr int AV_WARPS = AV_THREADS / 32;
constexpr int AV_RPW = AV_T / AV_WARPS;      // rows of a tile per warp
constexpr int AV_LD = AV_T + 1;              // staged row stride
constexpr int AV_TILE = AV_T * AV_LD;        // floats per staged tile
constexpr int AV_MAX_CLUSTER = 16;
constexpr int AV_MAX_GRID_Y = 65535;
constexpr int AV_CHUNK = 8;                   // tiles a normalised block stages
static_assert(AV_THREADS == 8 * AV_T, "av_row_sum: 4 threads a row");

// Stage the upper tile whose first row is i0 and first column j0:
// s[r AV_LD + c] = A[i0 + r, j0 + c] where i0 + r < j0 + c < n, else 0.
// Row i's entries are the run of v from i n - i (i + 1) / 2 + (j - i - 1)
// (ops.antivec_tile_runs is its Python twin); lane c reads column j0 + c,
// so a warp reads one run. 4-byte cp.async (the runs start anywhere:
// neither 16-byte copies nor TMA take them), zero-filled outside the
// triangle; the block then waits for them (av_staged).
__device__ __forceinline__ void av_stage(const float* __restrict__ V, int n,
                                         int i0, int j0, float* s) {
  const int c = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long j = j0 + c;
#pragma unroll
  for (int k = 0; k < AV_RPW; ++k) {
    const long long i = i0 + w + k * AV_WARPS;
    const bool in = i < j && j < n;
    cp_async4(s + (w + k * AV_WARPS) * AV_LD + c,
              in ? V + i * n - i * (i + 1) / 2 + (j - i - 1) : V, in ? 4 : 0);
  }
}

__device__ __forceinline__ void av_staged() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// A[i0 + r, j0 + c] from the staged upper tile: off the diagonal pair the
// staged entry; on it (i0 == j0) the entry above the diagonal, its mirror
// below it (the transposed read), and diag on it. A warp's lanes c read
// banks (r + c) % 32 either way: no conflict.
__device__ __forceinline__ float av_entry(const float* s, int r, int c,
                                          bool dp, float diag) {
  if (!dp || c > r) return s[r * AV_LD + c];
  return c < r ? s[c * AV_LD + r] : diag;
}

// Row q = threadIdx.x / 4 < 32 of the staged pair's tile (a row of the
// symmetric matrix across the tile's columns), or for q >= 32 row q - 32
// of its mirror (a column of the staged tile): each of the row's four
// threads sums 8 columns in order, then two shuffles add the four (the
// four get the same bits). A warp's 8 rows x 4 column groups read 32
// distinct banks at every step.
__device__ __forceinline__ float av_row_sum(const float* s, bool dp,
                                            float diag) {
  const int q = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 8;
  float acc = 0.f;
  if (q < AV_T) {
#pragma unroll
    for (int c = c0; c < c0 + 8; ++c) acc += av_entry(s, q, c, dp, diag);
  } else {
#pragma unroll
    for (int c = c0; c < c0 + 8; ++c) acc += s[c * AV_LD + (q - AV_T)];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// Write the pair's tiles from the staged one: the tile (i0, j0) row by
// row, then (off the diagonal) its mirror (j0, i0) row by row from the
// transposed staging. Each entry gets + 0.f first (av_out) and with NORM
// is then (a r_row) r_col. With VEC
// (n % 4 == 0, A 16-byte aligned: every tile edge and row start falls on
// 16 bytes) a thread stores 4 consecutive floats of row t / 8 of each
// tile, one 16-byte store a tile; its lanes still read distinct banks.
template <bool NORM>
__device__ __forceinline__ float av_out(float a, const float* r, int i,
                                        int j) {
  a = __fadd_rn(a, 0.f);
  if constexpr (NORM) a = (a * r[i]) * r[j];
  return a;
}

template <bool NORM, bool VEC>
__device__ __forceinline__ void av_write(float* __restrict__ A, int n, int i0,
                                         int j0, const float* s, float diag,
                                         const float* r) {
  const bool dp = i0 == j0;
  if constexpr (VEC) {
    const int q = threadIdx.x >> 3, c4 = (threadIdx.x & 7) * 4;
    int i = i0 + q, j = j0 + c4;
    if (i < n && j < n) {
      float a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        a[k] = av_out<NORM>(av_entry(s, q, c4 + k, dp, diag), r, i, j + k);
      *reinterpret_cast<float4*>(A + (size_t)i * n + j) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
    i = j0 + q;
    j = i0 + c4;
    if (!dp && i < n && j < n) {
      float a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        a[k] = av_out<NORM>(s[(c4 + k) * AV_LD + q], r, i, j + k);
      *reinterpret_cast<float4*>(A + (size_t)i * n + j) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  } else {
    const int c = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < AV_RPW; ++k) {
      const int q = w + k * AV_WARPS;
      int i = i0 + q, j = j0 + c;
      if (i < n && j < n)
        A[(size_t)i * n + j] = av_out<NORM>(av_entry(s, q, c, dp, diag), r,
                                            i, j);
      i = j0 + q;
      j = i0 + c;
      if (!dp && i < n && j < n)
        A[(size_t)i * n + j] = av_out<NORM>(s[c * AV_LD + q], r, i, j);
    }
  }
}

// Form 0: a block per (tile pair, matrix).
template <bool VEC>
__global__ void __launch_bounds__(AV_THREADS)
    antivec_tiles(const float* __restrict__ v, long long vstride,
                  float* __restrict__ out, int batch, int n, float diag) {
  __shared__ float s[AV_TILE];
  int ti, tj;
  sym_pair(blockIdx.x, ti, tj);
  for (long long mat = blockIdx.y; mat < batch; mat += gridDim.y) {
    av_stage(v + mat * vstride, n, ti * AV_T, tj * AV_T, s);
    av_staged();
    av_write<false, VEC>(out + (size_t)mat * n * n, n, ti * AV_T, tj * AV_T,
                         s, diag, nullptr);
    if (mat + gridDim.y < batch) __syncthreads();  // s staged again
  }
}

// Stage the block's pairs p .. p + cn - 1 (cn <= AV_CHUNK) into the
// slots 0 .. cn - 1 and wait for them (one cp.async batch).
__device__ __forceinline__ void av_stage_chunk(const float* V, int n, int p,
                                               int cn, float* tiles) {
  for (int k = 0; k < cn; ++k) {
    int ti, tj;
    sym_pair(p + k, ti, tj);
    av_stage(V, n, ti * AV_T, tj * AV_T, tiles + k * AV_TILE);
  }
  av_staged();
}

// Form 1: a cluster per matrix. Shared memory: AV_CHUNK staged tiles; part
// (n: this block's partial row sums, zero where its tiles do not reach),
// r (n: the reciprocal roots of the rows its tiles touch) and need (nt
// flags: those tile rows). Chunk by chunk the block stages its pairs, then
// pair by pair adds each tile's rows and its mirror's (av_row_sum, every
// thread) to part; after one cluster barrier each row's partials are
// added in rank order; then it writes its tiles, staged again chunk by
// chunk unless its pairs made one chunk (then still staged).
template <bool VEC>
__global__ void __launch_bounds__(AV_THREADS)
    antivec_norm_tiles(const float* __restrict__ v, long long vstride,
                       float* __restrict__ out, int batch, int n, float diag,
                       int per_block) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), b = (int)cluster.block_rank();
  const int nt = (n + AV_T - 1) / AV_T;
  const long long pairs = (long long)nt * (nt + 1) / 2;
  const int p0 = b * per_block;
  const int np = (int)max(0ll, min(pairs - p0, (long long)per_block));
  const bool kept = np <= AV_CHUNK;
  float* tiles = sh;
  float* part = tiles + AV_CHUNK * AV_TILE;
  float* r = part + n;
  int* need = reinterpret_cast<int*>(r + n);
  const int tid = threadIdx.x, q = tid >> 2;

  for (long long mat = blockIdx.y; mat < batch; mat += gridDim.y) {
    const float* V = v + mat * vstride;
    float* A = out + (size_t)mat * n * n;
    for (int t = tid; t < nt; t += AV_THREADS) need[t] = 0;
    for (int i = tid; i < n; i += AV_THREADS) part[i] = 0.f;
    for (int c0 = 0; c0 < np; c0 += AV_CHUNK) {
      const int cn = min(AV_CHUNK, np - c0);
      av_stage_chunk(V, n, p0 + c0, cn, tiles);   // its barrier orders the
                                                  // zeroing before the sums
      for (int k = 0; k < cn; ++k) {
        int ti, tj;
        sym_pair(p0 + c0 + k, ti, tj);
        const bool dp = ti == tj;
        const float sum = av_row_sum(tiles + k * AV_TILE, dp, diag);
        const int row = q < AV_T ? ti * AV_T + q : tj * AV_T + q - AV_T;
        if ((tid & 3) == 0 && (q < AV_T || !dp) && row < n) part[row] += sum;
        if (tid == 0) need[ti] = need[tj] = 1;
        __syncthreads();  // the next pair may reach the same rows
      }
    }
    cluster_arrive();   // this block's partial sums are complete
    cluster_wait();     // every block's are
    // a row's C partials: every load issued, then added in rank order
    for (int i = tid; i < n; i += AV_THREADS) {
      if (!need[i / AV_T]) continue;
      float pq[AV_MAX_CLUSTER];
#pragma unroll
      for (int k = 0; k < AV_MAX_CLUSTER; ++k)
        pq[k] = k < C ? cluster.map_shared_rank(part, k)[i] : 0.f;
      float acc = pq[0];
#pragma unroll
      for (int k = 1; k < AV_MAX_CLUSTER; ++k)
        if (k < C) acc += pq[k];
      r[i] = guarded_rsqrt(acc);
    }
    cluster_arrive();   // this block reads no peer's shared memory after this
    __syncthreads();
    for (int c0 = 0; c0 < np; c0 += AV_CHUNK) {
      const int cn = min(AV_CHUNK, np - c0);
      if (!kept) av_stage_chunk(V, n, p0 + c0, cn, tiles);
      for (int k = 0; k < cn; ++k) {
        int ti, tj;
        sym_pair(p0 + c0 + k, ti, tj);
        av_write<true, VEC>(A, n, ti * AV_T, tj * AV_T, tiles + k * AV_TILE,
                            diag, r);
      }
      if (!kept) __syncthreads();  // the slots are staged again next chunk
    }
    cluster_wait();     // no peer reads this block's partial sums any more
  }
}

// Shared memory of the normalised form (the plan computes the same):
// AV_CHUNK staged tiles, 2 n row sums and nt flags.
inline size_t antivec_smem(int n) {
  const size_t nt = (n + AV_T - 1) / AV_T;
  return sizeof(float) *
         ((size_t)AV_CHUNK * AV_TILE + 2 * (size_t)n + nt);
}

// The cluster kernel's attributes, set once on its first launch (no later
// launch, none inside a CUDA graph capture, sets one): clusters of up to
// 16 blocks and the card's opt-in shared memory.
int init_antivec_kernels() {
  static bool done = false;
  if (done) return 0;
  int err = read_smem_optin();
  if (err) return err;
  const void* fns[] = {(const void*)antivec_norm_tiles<true>,
                       (const void*)antivec_norm_tiles<false>};
  for (const void* fn : fns) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_optin);
    if (err) return err;
  }
  done = true;
  return 0;
}

// ---------------------------------------------------------------------------
// vectorize_colmajor: a block per (upper tile, pair of matrices), grid
// (nt (nt + 1) / 2, min(ceil(B / 2), 65 535)), the tile (ti, tj) =
// sym_pair(blockIdx.x), ti <= tj; past 131 070 matrices each block walks
// pairs blockIdx.y + k gridDim.y. The block stages M[i0 + r, j0 + c] for
// i0 + r < j0 + c < n of both matrices in one cp.async batch (a diagonal
// tile's lower half is never read): lane c reads column j0 + c, so a warp
// reads 128 contiguous bytes of a row (4-byte copies: the rows of M start
// 4 n bytes apart, on no wider boundary in general), 8 loads a thread in
// flight. Then warp w writes the tiles' columns w, w + 8, ...: column j's
// entries from a tile, i in [i0, min(i0 + 32, j)), are the run of the
// output from j (j - 1) / 2 + i0 (ops.colmajor_tile_runs is its Python
// twin), lane r writing entry i0 + r, lanes on consecutive addresses,
// reading banks (r + c) % 32 of the staged tile. The input is not taken
// as symmetric: the strict upper triangle is what is read. Bound by
// bytes: B n (n - 1) / 2 floats read once and written once (32 MB at the
// predict command's B = 112, n = 268: 45 tiles x 56 pairs, 2 520 blocks).
// On an H100 (700 W) at that shape a block per matrix took 0.0162 ms warm
// and 0.0226 with L2 flushed, two matrices 0.0120 and 0.0207, four
// 0.0115-0.0119 and 0.0215-0.0222 (11% slower than two at B = 167);
// capping registers for 8 blocks an SM gained nothing with one matrix and
// lost with two (PERF.md PR 15). A copy: every bit kept (-0.0, NaN).
// ---------------------------------------------------------------------------
constexpr int CM_MATS = 2;  // matrices a block stages at once

__global__ void __launch_bounds__(AV_THREADS)
    colmajor_tiles(const float* __restrict__ m, float* __restrict__ out,
                   int batch, int n) {
  __shared__ float s[CM_MATS][AV_TILE];
  int ti, tj;
  sym_pair(blockIdx.x, ti, tj);
  const int i0 = ti * AV_T, j0 = tj * AV_T;
  const int c = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long len = (long long)n * (n - 1) / 2;
  for (long long mat0 = (long long)blockIdx.y * CM_MATS; mat0 < batch;
       mat0 += (long long)gridDim.y * CM_MATS) {
    const int j = j0 + c;
#pragma unroll
    for (int q = 0; q < CM_MATS; ++q) {
      const long long mat = mat0 + q;
      if (mat >= batch) break;
      const float* M = m + mat * n * n;
#pragma unroll
      for (int k = 0; k < AV_RPW; ++k) {
        const int r = w + k * AV_WARPS, i = i0 + r;
        const bool in = i < j && j < n;
        cp_async4(s[q] + r * AV_LD + c, in ? M + (long long)i * n + j : M,
                  in ? 4 : 0);
      }
    }
    av_staged();
#pragma unroll
    for (int q = 0; q < CM_MATS; ++q) {
      const long long mat = mat0 + q;
      if (mat >= batch) break;
      float* O = out + mat * len;
#pragma unroll
      for (int k = 0; k < AV_T / AV_WARPS; ++k) {
        const int col = w + k * AV_WARPS, jc = j0 + col;
        const int count = jc < n ? min(AV_T, jc - i0) : 0;
        if (c < count)
          O[(long long)jc * (jc - 1) / 2 + i0 + c] = s[q][c * AV_LD + col];
      }
    }
    if (mat0 + (long long)gridDim.y * CM_MATS < batch)
      __syncthreads();  // s staged again
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

// The plan (form, cluster size, tile pairs per block, 16-byte stores)
// comes from the wrapper (ops.antivec_plan); one that does not cover the
// matrix's pairs, or that the grid, the card's shared memory or the
// pointers cannot take, is refused.
extern "C" int fcsr_anti_vectorize_normalize(const float* v, long long vstride,
                                             float* out, int batch, int n,
                                             float diag, int form,
                                             int cluster, int per_block,
                                             int vec, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const long long nt = (n + AV_T - 1) / AV_T, pairs = nt * (nt + 1) / 2;
  if (!v || !out || pairs >= (1ll << 31) || form < 0 || form > 1 ||
      (vec && !(n % 4 == 0 && aligned16(out))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned gy =
      (unsigned)(batch < AV_MAX_GRID_Y ? batch : AV_MAX_GRID_Y);
  if (form == 0) {
    if (cluster != 1 || per_block != 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)pairs, gy);
    if (vec)
      antivec_tiles<true><<<grid, AV_THREADS, 0, st>>>(v, vstride, out,
                                                       batch, n, diag);
    else
      antivec_tiles<false><<<grid, AV_THREADS, 0, st>>>(v, vstride, out,
                                                        batch, n, diag);
    return (int)cudaGetLastError();
  }
  if (cluster < 1 || cluster > AV_MAX_CLUSTER || per_block < 1 ||
      (long long)cluster * per_block < pairs)
    return (int)cudaErrorInvalidValue;
  const int err = init_antivec_kernels();
  if (err) return err;
  const size_t smem = antivec_smem(n);
  if (smem > (size_t)g_smem_optin) return (int)cudaErrorInvalidValue;
  void* args[] = {&v, &vstride, &out, &batch, &n, &diag, &per_block};
  const void* fn = vec ? (const void*)antivec_norm_tiles<true>
                       : (const void*)antivec_norm_tiles<false>;
  return launch_cluster(fn, dim3((unsigned)cluster, gy), cluster, AV_THREADS,
                        smem, st, args);
}

// The grid is the tile count by the matrix pairs (ops.colmajor_plan
// computes the same and refuses what this entry refuses): n < 2 writes
// nothing; null pointers and a tile count past the grid are refused.
extern "C" int fcsr_vectorize_colmajor(const float* m, float* out, int batch,
                                       int n, void* stream) {
  if (batch <= 0 || n < 2) return 0;
  const long long nt = (n + AV_T - 1) / AV_T, pairs = nt * (nt + 1) / 2;
  if (!m || !out || pairs >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const long long gy = (batch + CM_MATS - 1) / CM_MATS;
  const dim3 grid((unsigned)pairs,
                  (unsigned)(gy < AV_MAX_GRID_Y ? gy : AV_MAX_GRID_Y));
  colmajor_tiles<<<grid, AV_THREADS, 0, (cudaStream_t)stream>>>(m, out, batch,
                                                                n);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_normalize_adj_batch(const float* a, float* out, int batch,
                                        int n, void* stream) {
  normalize_adj_batch_kernel<<<batch, 1024, n * sizeof(float),
                               (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}
