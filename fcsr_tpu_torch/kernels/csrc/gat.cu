// gat: the GAT Graph-U-Net training step and validation forward —
// dense masked multi-head attention with its hand-written adjoint, the
// counter-based dropout generator, the pooled-adjacency gather, the
// upsampler's column softmax, the off-diagonal losses and masked AdamW.
//
// Replaces the two TPU kernels of fcsr_tpu/models/fused_gat.py
// (_make_gat_train_kernel / _make_gat_val_kernel, which hold one subject's
// whole step in VMEM and differentiate their own body with
// jax.value_and_grad) and the keep-mask kernel of
// tools/experiments/gat_dropout_keeprate.py. Neither a 100 MB on-chip
// memory nor in-kernel AD exists on Hopper, so the step is a sequence of
// small kernels over (F, ...) device buffers, F = folds (or validation
// subjects), with every adjoint written out. The x @ w products around
// them are bgemm_f32 launches.
//
// Bound: every kernel here moves a few hundred KB and does a few MFLOP at
// the shipped width (n = 160 -> 20 nodes, 4 heads of 4..64 features), so
// each is bound by bytes on paper and by launch latency in practice. Sums
// run in a fixed order (no atomics, so results are reproducible); dropout
// masks are regenerated from (seed, mask, head, element) wherever they are
// needed, so none is stored between forward and backward. The forward
// runs a block per attention row; the adjoint and the off-diagonal losses
// run a thread-block cluster per (head, fold) or per fold whose blocks
// meet in distributed shared memory inside the one launch.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Philox-4x32-10 (Salmon et al., SC'11), written out; word 0 of the block at
// counter (element, head, mask, 0) under the key (seed0, seed1).
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned philox_word(unsigned k0, unsigned k1,
                                                unsigned c0, unsigned c1,
                                                unsigned c2, unsigned c3) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return c0;
}

// The keep transform of the reference (_bits_to_keep_mask): logical shift
// right by 8, times 2^-24 (u uniform in [0, 1)), keep when u >= p.
__device__ __forceinline__ float bits_to_keep(unsigned word, float p) {
  const float u = (float)(word >> 8) * (1.f / 16777216.f);
  return u >= p ? 1.f : 0.f;
}

// keep (1) or drop (0) of element ``elem`` of head ``head`` of dropout mask
// ``mask_id`` under the fold's two seed words.
__device__ __forceinline__ float keep_at(const int* __restrict__ seed2,
                                         int mask_id, int head, unsigned elem,
                                         float p) {
  return bits_to_keep(philox_word((unsigned)seed2[0], (unsigned)seed2[1],
                                  elem, (unsigned)head, (unsigned)mask_id,
                                  0u), p);
}

// Sum (or max) over a block whose size is a multiple of 32, returned to
// every thread; ``red`` is 32 floats of shared memory, reusable after.
template <bool IS_MAX>
__device__ __forceinline__ float block_all(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = IS_MAX ? fmaxf(v, w) : v + w;
  }
  if (lane == 0) red[wid] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = lane < nw ? red[lane] : (IS_MAX ? -INFINITY : 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = IS_MAX ? fmaxf(v, w) : v + w;
  }
  __syncthreads();
  return v;
}

__device__ __forceinline__ float leaky(float z) {
  return z >= 0.f ? z : 0.2f * z;          // slope 1 at exactly 0
}

constexpr float MASKED = -1e30f;

// <h[row, head block], att[head]> over the head's d features
__device__ __forceinline__ float head_dot(const float* __restrict__ hrow,
                                          const float* __restrict__ att,
                                          int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc += hrow[c] * att[c];
  return acc;
}

// ---------------------------------------------------------------------------
// gat_attention: block (target row i, head j, fold f).
//   s[src] = <h[src, j], att_src[j]>, t = <h[i, j], att_dst[j]>
//   logit[src] = leaky(s[src] + t) where a[i, src] != 0 or src == i
//   alpha = softmax over the unmasked sources (shift: the head's row maximum,
//           or with global_shift the row's maximum over all heads)
//   y[i, j block] = relu(sum_src alpha keep / (1 - p) h[src, j block] + bias)
// Dynamic shared memory: n floats.
// ---------------------------------------------------------------------------
__global__ void gat_attention_kernel(
    const float* __restrict__ h, const float* __restrict__ att_src,
    long long s_src, const float* __restrict__ att_dst, long long s_dst,
    const float* __restrict__ bias, long long s_bias,
    const float* __restrict__ a, const int* __restrict__ seeds,
    float* __restrict__ y, float* __restrict__ alpha, int n, int heads, int d,
    int mask_id, float drop_p, float scale, int global_shift) {
  extern __shared__ float sh[];
  __shared__ float red[32];
  const int i = blockIdx.x, j = blockIdx.y, f = blockIdx.z;
  const int HD = heads * d;
  const float* hf = h + (long long)f * n * HD;
  const float* arow = a + ((long long)f * n + i) * n;
  const float* asrc = att_src + f * s_src + j * d;
  const float* adst = att_dst + f * s_dst + j * d;
  const float t = head_dot(hf + (long long)i * HD + j * d, adst, d);

  float mx = -INFINITY;
  for (int src = threadIdx.x; src < n; src += blockDim.x) {
    const bool on = arow[src] != 0.f || src == i;
    const float z = leaky(head_dot(hf + (long long)src * HD + j * d, asrc, d) + t);
    const float logit = on ? z : MASKED;
    sh[src] = logit;
    mx = fmaxf(mx, logit);
  }
  if (global_shift) {
    for (int jj = 0; jj < heads; ++jj) {
      if (jj == j) continue;
      const float* asrc2 = att_src + f * s_src + jj * d;
      const float t2 = head_dot(hf + (long long)i * HD + jj * d,
                                att_dst + f * s_dst + jj * d, d);
      for (int src = threadIdx.x; src < n; src += blockDim.x) {
        const bool on = arow[src] != 0.f || src == i;
        if (on)
          mx = fmaxf(mx, leaky(head_dot(hf + (long long)src * HD + jj * d,
                                        asrc2, d) + t2));
      }
    }
  }
  mx = block_all<true>(mx, red);
  float part = 0.f;
  for (int src = threadIdx.x; src < n; src += blockDim.x) {
    const float logit = sh[src];
    const float e = logit > 0.5f * MASKED ? expf(logit - mx) : 0.f;
    sh[src] = e;
    part += e;
  }
  const float denom = block_all<false>(part, red);
  float* alrow = alpha ? alpha + (((long long)f * heads + j) * n + i) * n
                       : nullptr;
  const int* seed2 = seeds ? seeds + 2 * f : nullptr;
  for (int src = threadIdx.x; src < n; src += blockDim.x) {
    float al = sh[src] / denom;
    if (alrow) alrow[src] = al;
    if (drop_p > 0.f)
      al = al * keep_at(seed2, mask_id, j, (unsigned)(i * n + src), drop_p)
           * scale;
    sh[src] = al;
  }
  __syncthreads();
  const float* b = bias + f * s_bias + j * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int src = 0; src < n; ++src)
      acc += sh[src] * hf[(long long)src * HD + j * d + c];
    const float v = acc + b[c];
    y[((long long)f * n + i) * HD + j * d + c] = v > 0.f ? v : 0.f;
  }
}

// ---------------------------------------------------------------------------
// gat_attention_bwd: the adjoint of gat_attention, one launch. Per head j
// of fold f, with g_o = g_y [y > 0], k = keep / (1 - p) (1 without
// dropout), s / t the source / target terms of the forward:
//   g_al[i, src] = <g_o[i], h[src]> k        dot[i] = sum_src alpha g_al
//   gz[i, src]   = leaky'(s[src] + t[i]) alpha (g_al - dot[i])
//   gt[i] = sum_src gz[i, src]                gs[src] = sum_i gz[i, src]
//   g_h[src] = sum_i alpha k g_o[i] + gs[src] att_src + gt[src] att_dst
//   g_att_src = sum gs h,  g_att_dst = sum gt h,  g_bias = sum_i g_o[i]
// A thread-block cluster of C blocks per (head, fold) (grid (C, H, F));
// block b owns the band of R target rows I = [b R, b R + R) and the same
// range of sources. Where the head fits in shared memory (every shipped
// layer: "staged") the block stages by cp.async, all in flight at once,
// the head's h rows (n x d, padded to an odd stride) and its band's alpha
// rows (R x n, read along rows), and its band's g_o; s and t are computed
// once per node, not per pair. Pass 1 fills a tile of (band rows x
// sources) with g_al k and alpha k, each pair's keep bit drawn once (two
// pairs per thread at a time); a warp per row then sums dot[i] and, from
// the same sums, gt[i] = sum lk alpha g_al k - dot[i] sum lk alpha. Pass
// 2 turns the tile into gz in place (gz and alpha k never reach device
// memory) and sums the band's partial columns of gz and (alpha k)^T g_o
// (sources x (d + 1)) in a fixed row order. After a cluster barrier each
// block adds the C blocks' partials for its own sources in rank order
// through distributed shared memory (all C loads in flight) and writes
// those rows of g_h; its band's shares of the three parameter gradients go
// into rank 0, which adds them in rank order after a second barrier. No
// atomics and no scratch in device memory: the same bits from run to
// run. Past what shared memory holds both passes walk the sources in
// chunks and the band in sub-bands of 32 rows, restaging h and
// recomputing the tiles in pass 2 (alpha and g_o are read from memory),
// with a cluster barrier per chunk: n up to 12 288 on an H100. The
// wrapper plans C, R, the chunk and the sub-band
// (ops.gat_attention_bwd_plan). At F = 3, n = 160, 4 heads of 8: 12
// clusters of 8 blocks of 20 rows, ~58 KB of shared memory each.
// ---------------------------------------------------------------------------
constexpr int BWD_THREADS = 512;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_MAX_CLUSTER = 16;

// g_o = g_y [y > 0] at element e, both loads issued before either is used
__device__ __forceinline__ float relu_grad(const float* __restrict__ y,
                                           const float* __restrict__ g_y,
                                           size_t e) {
  const float yv = __ldg(y + e), gv = __ldg(g_y + e);
  return yv > 0.f ? gv : 0.f;
}

// sum over the cluster's blocks, in rank order, of ``buf[at]`` in each
// block's shared memory (all C remote loads in flight at once)
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* buf, int at, int C) {
  float v[BWD_MAX_CLUSTER];
#pragma unroll
  for (int p = 0; p < BWD_MAX_CLUSTER; ++p)
    v[p] = p < C ? cluster.map_shared_rank(buf, p)[at] : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int p = 0; p < BWD_MAX_CLUSTER; ++p)
    if (p < C) acc += v[p];
  return acc;
}

__global__ void __launch_bounds__(BWD_THREADS)
    gat_attention_bwd_kernel(
        const float* __restrict__ g_y, const float* __restrict__ y,
        const float* __restrict__ alpha, const float* __restrict__ h,
        const float* __restrict__ att_src, long long s_src,
        const float* __restrict__ att_dst, long long s_dst,
        const int* __restrict__ seeds, float* __restrict__ g_h,
        float* __restrict__ g_src, long long sg_src,
        float* __restrict__ g_dst, long long sg_dst,
        float* __restrict__ g_bias, long long sg_bias, int n, int heads,
        int d, int mask_id, float drop_p, float scale, int R, int chunk,
        int sub) {
  extern __shared__ float4 sh4[];  // 16-byte aligned for cp.async16
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), b = (int)cluster.block_rank();
  const int j = blockIdx.y, f = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int HD = heads * d, ldh = d | 1, dp = d + 1;
  const int i0 = b * R, rows = max(0, min(R, n - i0));
  const bool staged = chunk >= n;  // h and the band's alpha in shared memory
  const bool whole = R <= sub;     // the band's g_o in one sub-band
  const bool drop = drop_p > 0.f;
  float* alb = reinterpret_cast<float*>(sh4);  // staged: R x n band alpha
  float* hs = alb + (staged ? (size_t)R * n : 0);  // chunk x ldh: h rows
  float* s = hs + (size_t)chunk * ldh;       // n: <h[src], att_src[j]>
  float* tb = s + n;                         // R: <h[i], att_dst[j]>
  float* dot = tb + R;                       // R: sum alpha g_al
  float* gtb = dot + R;                      // R: gt of the band
  float* a3 = gtb + R;                       // R: sum lk alpha
  float* gsb = a3 + R;                       // R: gs of the band's sources
  float* atts = gsb + R;                     // d: att_src[j]
  float* attd = atts + d;                    // d: att_dst[j]
  float* gos = attd + d;                     // sub x d: g_o of a sub-band
  float* tgz = gos + (size_t)sub * d;        // sub x chunk: gz
  float* tad = tgz + (size_t)sub * chunk;    // sub x chunk: alpha k
  float* part = tad + (size_t)sub * chunk;   // chunk x (d + 1): partials
  float* wgo = part + (size_t)chunk * dp;    // warps x d: a row's g_o
  float* red = wgo + BWD_WARPS * d;          // 3 x threads: param shares
  float* prm = red + 3 * BWD_THREADS;        // C x 3d: rank 0's shares
  const size_t head0 = (size_t)f * n * HD + j * d;
  const float* hf = h + head0;               // row r: hf[r HD + c]
  const float* yf = y + head0;
  const float* gyf = g_y + head0;
  const float* alg = alpha + (((size_t)f * heads + j) * n + i0) * n;
  const int* seed2 = seeds ? seeds + 2 * f : nullptr;

  if (staged) {
    for (int e = tid; e < n * d; e += BWD_THREADS) {
      const int r = e / d, c = e - r * d;
      cp_async4(hs + r * ldh + c, hf + (size_t)r * HD + c, 4);
    }
    if ((n & 3) == 0 && aligned16(alg)) {  // the band's rows: contiguous
      for (int e = 4 * tid; e < rows * n; e += 4 * BWD_THREADS)
        cp_async16(alb + e, alg + e, 16);
    } else {
      for (int e = tid; e < rows * n; e += BWD_THREADS)
        cp_async4(alb + e, alg + e, 4);
    }
    cp_async_commit();
  }
  for (int c = tid; c < d; c += BWD_THREADS) {
    atts[c] = att_src[f * s_src + j * d + c];
    attd[c] = att_dst[f * s_dst + j * d + c];
  }
  if (whole) {
    for (int e = tid; e < rows * d; e += BWD_THREADS) {
      const int r = e / d, c = e - r * d;
      const size_t g = (size_t)(i0 + r) * HD + c;
      gos[e] = relu_grad(yf, gyf, g);
    }
  }
  if (staged) cp_async_wait<0>();
  __syncthreads();
  const float* H1 = staged ? hs : hf;        // h row i: H1[i ld1 + c]
  const size_t ld1 = staged ? ldh : HD;
  const float* AL = staged ? alb : alg;      // band row r: AL[r n + src]

  // t of the band rows: a warp per row, lanes along the features
  for (int r = w; r < rows; r += BWD_WARPS) {
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc += H1[(i0 + r) * ld1 + c] * attd[c];
    acc = warp_sum(acc);
    if (lane == 0) tb[r] = acc;
  }

  // (g_al k, alpha k) of the pairs (band rows r0 .. r0 + nr, sources
  // c0 .. c0 + cols) into tgz / tad, each keep bit drawn once; two pairs
  // per thread at a time, so that their dependent chains overlap
  auto tile = [&](int c0, int cols, int r0, int nr) {
    const int np = nr * cols;
    for (int e0 = tid; e0 < np; e0 += 2 * BWD_THREADS) {
      float gk[2], ak[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = e0 + u * BWD_THREADS;
        gk[u] = ak[u] = 0.f;
        if (e < np) {
          const int r = e / cols, jj = e - r * cols;
          const int i = i0 + r0 + r, src = c0 + jj;
          const float a = AL[(size_t)(r0 + r) * n + src];
          const float* gr = gos + r * d;
          const float* hr = hs + jj * ldh;
          float g = 0.f;
#pragma unroll 4
          for (int c = 0; c < d; ++c) g += gr[c] * hr[c];
          float k = 1.f;
          if (drop) {
            k = keep_at(seed2, mask_id, j, (unsigned)(i * n + src),
                        drop_p) * scale;
            g *= k;
          }
          gk[u] = g;
          ak[u] = a * k;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = e0 + u * BWD_THREADS;
        if (e < np) {
          tgz[e] = gk[u];
          tad[e] = ak[u];
        }
      }
    }
  };

  // pass 1, chunk by chunk and sub-band by sub-band: s of the chunk's
  // sources, the tile, then a warp per band row adds the tile's share of
  // dot, sum lk alpha g_al k and sum lk alpha (lanes along the sources)
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cols = min(chunk, n - c0);
    if (!staged) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = tid; e < cols * d; e += BWD_THREADS) {
        const int r = e / d, c = e - r * d;
        cp_async4(hs + r * ldh + c, hf + (size_t)(c0 + r) * HD + c, 4);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int jj = tid; jj < cols; jj += BWD_THREADS) {
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) acc += hs[jj * ldh + c] * atts[c];
      s[c0 + jj] = acc;
    }
    for (int r0 = 0; r0 < rows; r0 += sub) {
      const int nr = min(sub, rows - r0);
      if (!whole) {
        for (int e = tid; e < nr * d; e += BWD_THREADS) {
          const int r = e / d, c = e - r * d;
          const size_t g = (size_t)(i0 + r0 + r) * HD + c;
          gos[e] = relu_grad(yf, gyf, g);
        }
      }
      __syncthreads();  // s, g_o in place; the last tile's sums are done
      tile(c0, cols, r0, nr);
      __syncthreads();
      for (int r = w; r < nr; r += BWD_WARPS) {
        const float ti = tb[r0 + r];
        const float* arow = AL + (size_t)(r0 + r) * n + c0;
        float s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int jj = lane; jj < cols; jj += 32) {
          const float a = arow[jj];
          const float ag = a * tgz[r * cols + jj];
          const float lk = s[c0 + jj] + ti >= 0.f ? 1.f : 0.2f;
          s1 += ag;
          s2 += ag * lk;
          s3 += a * lk;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        s3 = warp_sum(s3);
        if (lane == 0) {
          const int q = r0 + r;
          dot[q] = c0 == 0 ? s1 : dot[q] + s1;
          gtb[q] = c0 == 0 ? s2 : gtb[q] + s2;
          a3[q] = c0 == 0 ? s3 : a3[q] + s3;
        }
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < rows; r += BWD_THREADS) gtb[r] -= dot[r] * a3[r];
  __syncthreads();

  // pass 2: gz, then the band's partial column sums, chunk by chunk; with
  // one chunk and one sub-band pass 1's tile is still in place
  const bool single = staged && whole;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cols = min(chunk, n - c0);
    if (!staged) {
      for (int e = tid; e < cols * d; e += BWD_THREADS) {
        const int r = e / d, c = e - r * d;
        cp_async4(hs + r * ldh + c, hf + (size_t)(c0 + r) * HD + c, 4);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int r0 = 0; r0 < max(rows, 1); r0 += sub) {
      const int nr = max(0, min(sub, rows - r0));
      if (!single) {
        if (!whole) {
          for (int e = tid; e < nr * d; e += BWD_THREADS) {
            const int r = e / d, c = e - r * d;
            const size_t g = (size_t)(i0 + r0 + r) * HD + c;
            gos[e] = relu_grad(yf, gyf, g);
          }
        }
        __syncthreads();
        tile(c0, cols, r0, nr);
        __syncthreads();
      }
      for (int e = tid; e < nr * cols; e += BWD_THREADS) {
        const int r = e / cols, jj = e - r * cols;
        const float gl = AL[(size_t)(r0 + r) * n + c0 + jj] *
                         (tgz[e] - dot[r0 + r]);
        tgz[e] = s[c0 + jj] + tb[r0 + r] >= 0.f ? gl : 0.2f * gl;
      }
      __syncthreads();
      for (int e = tid; e < cols * dp; e += BWD_THREADS) {
        const int jj = e / dp, c = e - jj * dp;
        float acc = r0 == 0 ? 0.f : part[e];
        if (c < d) {
#pragma unroll 4
          for (int r = 0; r < nr; ++r)
            acc += tad[r * cols + jj] * gos[r * d + c];
        } else {
#pragma unroll 4
          for (int r = 0; r < nr; ++r) acc += tgz[r * cols + jj];
        }
        part[e] = acc;
      }
      __syncthreads();
    }
    cluster_arrive();  // this block's partials of the chunk are in place
    cluster_wait();    // and every other block's
    // this block's own sources in the chunk, summed over the cluster in
    // rank order: each (source, feature) thread adds its column of g_h and
    // the source's gs in one round of remote loads
    const int lo = max(i0, c0), hi = min(i0 + rows, c0 + cols);
    const int own = max(0, hi - lo);
    for (int e = tid; e < own * d; e += BWD_THREADS) {
      const int q = e / d, c = e - q * d, src = lo + q;
      const float gs = cluster_sum(cluster, part, (src - c0) * dp + d, C);
      const float acc = cluster_sum(cluster, part, (src - c0) * dp + c, C);
      if (c == 0) gsb[src - i0] = gs;
      g_h[head0 + (size_t)src * HD + c] =
          acc + gs * atts[c] + gtb[src - i0] * attd[c];
    }
    if (c0 + chunk < n) {  // the peers have read this chunk's partials
      cluster_arrive();
      cluster_wait();
    }
  }

  // the band's shares of the parameter gradients: K row groups per
  // feature, then the groups in order, into rank 0
  __syncthreads();
  const int K = BWD_THREADS / d;
  if (tid < K * d) {
    const int k = tid / d, c = tid - k * d;
    float ps = 0.f, pd = 0.f, pb = 0.f;
    for (int r = k; r < rows; r += K) {
      const int i = i0 + r;
      const float hv = H1[i * ld1 + c];
      ps += gsb[r] * hv;
      pd += gtb[r] * hv;
      if (whole) {
        pb += gos[r * d + c];
      } else {
        pb += relu_grad(yf, gyf, (size_t)i * HD + c);
      }
    }
    red[tid] = ps;
    red[BWD_THREADS + tid] = pd;
    red[2 * BWD_THREADS + tid] = pb;
  }
  __syncthreads();
  float* prm0 = cluster.map_shared_rank(prm, 0);
  for (int e = tid; e < 3 * d; e += BWD_THREADS) {
    const int which = e / d, c = e - which * d;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += red[which * BWD_THREADS + k * d + c];
    prm0[b * 3 * d + e] = acc;
  }
  cluster_arrive();  // this block's shares are in rank 0
  cluster_wait();    // no block reads a peer after this
  if (b == 0) {
    for (int e = tid; e < 3 * d; e += BWD_THREADS) {
      float acc = 0.f;
      for (int p = 0; p < C; ++p) acc += prm[p * 3 * d + e];
      const int which = e / d, c = e - which * d;
      if (which == 0)
        g_src[f * sg_src + j * d + c] = acc;
      else if (which == 1)
        g_dst[f * sg_dst + j * d + c] = acc;
      else
        g_bias[f * sg_bias + j * d + c] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// philox_keep_mask: out[f, head, e] = (x ? x[f, head, e] : 1) keep scale.
// With x = nullptr and scale = 1 it dumps the mask the other kernels draw.
// ---------------------------------------------------------------------------
__global__ void philox_keep_mask_kernel(const int* __restrict__ seeds,
                                        const float* __restrict__ x,
                                        float* __restrict__ out, int batch,
                                        int heads, long long per_head,
                                        int mask_id, float drop_p,
                                        float scale) {
  const long long total = (long long)batch * heads * per_head;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long fh = e / per_head;
    const int f = (int)(fh / heads), head = (int)(fh % heads);
    const float k = keep_at(seeds + 2 * f, mask_id, head,
                            (unsigned)(e % per_head), drop_p);
    out[e] = (x ? x[e] * k : k) * scale;
  }
}

// ---------------------------------------------------------------------------
// gat_pool_adj: out[f] = symnorm(a[f][idx][:, idx]), d = rowsum + eps,
// out = (g r_col) r_row with r = d^-1/2. One block per fold; dynamic shared
// memory: k floats.
// ---------------------------------------------------------------------------
__global__ void gat_pool_adj_kernel(const float* __restrict__ a,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, int n, int k,
                                    float eps) {
  extern __shared__ float r[];
  const int f = blockIdx.x;
  const float* af = a + (long long)f * n * n;
  const int* ix = idx + (long long)f * k;
  for (int row = threadIdx.x; row < k; row += blockDim.x) {
    const float* arow = af + (long long)ix[row] * n;
    float sum = 0.f;
    for (int c = 0; c < k; ++c) sum += arow[ix[c]];
    r[row] = 1.f / sqrtf(sum + eps);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) {
    const int row = e / k, col = e % k;
    out[(long long)f * k * k + e] =
        af[(long long)ix[row] * n + ix[col]] * r[col] * r[row];
  }
}

// ---------------------------------------------------------------------------
// col_softmax / col_softmax_bwd over the rows of (F, R, C): thread per
// (fold, column). q = softmax over rows; g_y = q (g_q - sum_rows q g_q).
// ---------------------------------------------------------------------------
__global__ void col_softmax_kernel(const float* __restrict__ y,
                                   float* __restrict__ q, int batch, int R,
                                   int C) {
  const long long total = (long long)batch * C;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long f = e / C, c = e % C;
    const float* col = y + f * R * C + c;
    float* qc = q + f * R * C + c;
    float mx = -INFINITY;
    for (int r = 0; r < R; ++r) mx = fmaxf(mx, col[(long long)r * C]);
    float sum = 0.f;
    for (int r = 0; r < R; ++r) {
      const float ev = expf(col[(long long)r * C] - mx);
      qc[(long long)r * C] = ev;
      sum += ev;
    }
    for (int r = 0; r < R; ++r) qc[(long long)r * C] = qc[(long long)r * C] / sum;
  }
}

__global__ void col_softmax_bwd_kernel(const float* __restrict__ g_q,
                                       const float* __restrict__ q,
                                       float* __restrict__ g_y, int batch,
                                       int R, int C) {
  const long long total = (long long)batch * C;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long f = e / C, c = e % C, base = f * R * C + c;
    float dot = 0.f;
    for (int r = 0; r < R; ++r)
      dot += q[base + (long long)r * C] * g_q[base + (long long)r * C];
    for (int r = 0; r < R; ++r)
      g_y[base + (long long)r * C] =
          q[base + (long long)r * C] * (g_q[base + (long long)r * C] - dot);
  }
}

// ---------------------------------------------------------------------------
// offdiag_mse: vals[f, slot] = sum_{i != j} (relu(G) - T)^2 / n^2 and,
// if gsym, the symmetrised cotangent of G,
//   gsym[i, j] = c (d_ij [G_ij > 0] + d_ji [G_ji > 0]), d = relu(G) - T off
//   the diagonal, c = 2 / n^2
// (G = X X^T is symmetric in X, so d loss / d X = gsym X).
// offdiag_mae: vals[f, slot] = sum_{i != j} |relu(G) - T| / n^2.
// A thread-block cluster of C blocks per fold (grid (C, F)) over the
// fold's 32 x 32 tiles: block b takes tiles b, b + C, b + 2C, ... in
// batches of ``stages``, each batch staged at once by cp.async (G and T
// tiles along rows, with gsym also the mirrored tiles (tj, ti), into rows
// padded to 36 floats: every access to device memory is coalesced; 16-byte
// copies where n % 4 == 0 and the operands are 16-byte aligned, else
// 4-byte ones and rows of 33 floats). Each thread sums its
// entries in tile order with a compensated (Kahan) sum; the block's sum
// (warp trees, then the warps in order) goes into rank 0, which adds the
// C partials in rank order after one cluster barrier. No atomics: the
// value's bits depend on C alone, with or without gsym. The wrapper plans
// C, the tiles per block and the batch (ops.offdiag_plan). At F = 3,
// n = 268: 16 blocks per fold, 6 tiles each, staged in one batch.
// ---------------------------------------------------------------------------
constexpr int OD_TILE = 32;
// 512 threads per block: at 268^2 the value and cotangent at F = 3 ran
// 0.0105 ms against 0.0113 with 256, the value alone at F = 56 0.0244
// against 0.0202 (chip_smoke.py's check_gat_reductions, NVIDIA H100 80GB
// HBM3, 700 W); one count for both, so the value has the same bits with
// and without the cotangent
constexpr int OD_THREADS = 512;

// A staged tile: dst[r * LD + c] = src[(ti 32 + r) n + tj 32 + c] (zero
// outside n x n), in 16-byte copies when VEC, else 4-byte ones.
template <bool VEC, int LD>
__device__ __forceinline__ void od_stage(float* dst, const float* src, int n,
                                         int ti, int tj) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < OD_TILE * OD_TILE / 4; e += OD_THREADS) {
      const int r = e >> 3, c = (e & 7) * 4;
      const int i = ti * OD_TILE + r, jc = tj * OD_TILE + c;
      const bool in = i < n && jc < n;
      cp_async16(dst + r * LD + c, in ? src + (size_t)i * n + jc : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < OD_TILE * OD_TILE; e += OD_THREADS) {
      const int r = e >> 5, c = e & 31;
      const int i = ti * OD_TILE + r, jc = tj * OD_TILE + c;
      const bool in = i < n && jc < n;
      cp_async4(dst + r * LD + c, in ? src + (size_t)i * n + jc : src,
                in ? 4 : 0);
    }
  }
}

template <bool VEC, bool GRAD>
__global__ void __launch_bounds__(OD_THREADS)
    offdiag_loss_kernel(const float* __restrict__ G,
                        const float* __restrict__ T, float* __restrict__ vals,
                        int n_vals, int slot, float* __restrict__ gsym, int n,
                        int per_block, int stages, int absolute) {
  // the mirrored tiles' row stride: 36 (16-byte rows, the transposed reads
  // 4 to a bank) with 16-byte copies, else 33 (conflict-free)
  constexpr int LDT = VEC ? OD_TILE + 4 : OD_TILE + 1;
  constexpr int SQ = OD_TILE * OD_TILE;
  constexpr int STAGE = 2 * SQ + (GRAD ? 2 * OD_TILE * LDT : 0);
  extern __shared__ float4 sh4[];  // 16-byte aligned for cp.async16
  float* sh = reinterpret_cast<float*>(sh4);
  __shared__ float parts[16];  // rank 0's: the cluster's partial sums
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int f = blockIdx.y;
  const size_t nn = (size_t)n * n;
  const float* g = G + f * nn;
  const float* t = T + f * nn;
  float* out = GRAD ? gsym + f * nn : nullptr;
  const int nt = (n + OD_TILE - 1) / OD_TILE, total = nt * nt;
  const float c2 = 2.f / (float)nn;

  cluster_arrive();  // this block has started: rank 0 may be written
  float acc = 0.f, comp = 0.f;  // Kahan: comp carries the lost low bits
  for (int k0 = 0; k0 < per_block; k0 += stages) {
    const int kn = min(stages, per_block - k0);
    for (int q = 0; q < kn; ++q) {
      const int tile = rank + (k0 + q) * C;
      if (tile >= total) break;
      const int ti = tile / nt, tj = tile - ti * nt;
      float* st = sh + q * STAGE;
      od_stage<VEC, OD_TILE>(st, g, n, ti, tj);
      od_stage<VEC, OD_TILE>(st + SQ, t, n, ti, tj);
      if constexpr (GRAD) {  // the mirrored tile (tj, ti)
        od_stage<VEC, LDT>(st + 2 * SQ, g, n, tj, ti);
        od_stage<VEC, LDT>(st + 2 * SQ + OD_TILE * LDT, t, n, tj, ti);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int q = 0; q < kn; ++q) {
      const int tile = rank + (k0 + q) * C;
      if (tile >= total) break;
      const int ti = tile / nt, tj = tile - ti * nt;
      const float* Gs = sh + q * STAGE;
      const float* Ts = Gs + SQ;
      for (int e = threadIdx.x; e < SQ; e += OD_THREADS) {
        const int r = e >> 5, c = e & 31;
        const int i = ti * OD_TILE + r, jc = tj * OD_TILE + c;
        if (i >= n || jc >= n) continue;
        const float gij = Gs[e];
        const float dij = fmaxf(gij, 0.f) - Ts[e];
        if (i != jc) {
          const float v = (absolute ? fabsf(dij) : dij * dij) - comp;
          const float sum = acc + v;
          comp = (sum - acc) - v;
          acc = sum;
        }
        if constexpr (GRAD) {
          const float gji = Gs[2 * SQ + c * LDT + r];
          const float dji =
              fmaxf(gji, 0.f) - Gs[2 * SQ + OD_TILE * LDT + c * LDT + r];
          const float sym = (gij > 0.f ? dij : 0.f) + (gji > 0.f ? dji : 0.f);
          out[(size_t)i * n + jc] = i == jc ? 0.f : c2 * sym;
        }
      }
    }
    __syncthreads();  // the batch is consumed before the next is staged
  }
  acc = block_sum(acc);
  cluster_wait();  // every block has started
  if (threadIdx.x == 0) cluster.map_shared_rank(parts, 0)[rank] = acc;
  cluster_arrive();  // this block's partial is in rank 0
  cluster_wait();
  if (rank == 0 && threadIdx.x == 0) {
    float sum = 0.f;
    for (int q = 0; q < C; ++q) sum += parts[q];
    vals[(size_t)f * n_vals + slot] = sum / (float)nn;
  }
}

// ---------------------------------------------------------------------------
// adamw_masked: masked AdamW (decay inside the step, as optax.adamw) over
// flat (F, P) buffers with per-fold scalars scal[f] = [ok, lr, 1 - b1^t,
// 1 - b2^t] read from device memory; loss[f] = vals[f, 0] + vals[f, 1] + ...
// IEEE round-to-nearest with no FMA contraction: the plain version's bits.
// ---------------------------------------------------------------------------
__global__ void adamw_masked_kernel(const float* __restrict__ p,
                                    const float* __restrict__ m,
                                    const float* __restrict__ v,
                                    const float* __restrict__ g,
                                    const float* __restrict__ scal,
                                    const float* __restrict__ vals,
                                    int n_vals, float* p_out, float* m_out,
                                    float* v_out, float* __restrict__ loss,
                                    int batch, long long P, float b1,
                                    float omb1, float b2, float omb2,
                                    float eps, float wd) {
  const long long total = P * batch;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long f = e / P;
    const float ok = scal[f * 4], lr = scal[f * 4 + 1], d1 = scal[f * 4 + 2],
                d2 = scal[f * 4 + 3];
    const float gg = g[e], mo = m[e], vo = v[e], po = p[e];
    const float mn = __fadd_rn(__fmul_rn(b1, mo), __fmul_rn(omb1, gg));
    const float vn = __fadd_rn(__fmul_rn(b2, vo),
                               __fmul_rn(omb2, __fmul_rn(gg, gg)));
    const float mhat = __fdiv_rn(mn, d1);
    const float vhat = __fdiv_rn(vn, d2);
    const float step = __fmul_rn(
        lr, __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
                      __fmul_rn(wd, po)));
    const bool on = ok > 0.f;
    p_out[e] = on ? __fsub_rn(po, step) : po;
    m_out[e] = on ? mn : mo;
    v_out[e] = on ? vn : vo;
  }
  if (blockIdx.x == 0) {
    for (int f = threadIdx.x; f < batch; f += blockDim.x) {
      float total_loss = vals[(long long)f * n_vals];
      for (int s = 1; s < n_vals; ++s)
        total_loss = __fadd_rn(total_loss, vals[(long long)f * n_vals + s]);
      loss[f] = total_loss;
    }
  }
}

int block_for(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

// The cluster kernels' attributes, set once on their first launch (so no
// later launch, none inside a CUDA graph capture, sets one): clusters of
// up to 16 blocks (past the portable 8) and the card's opt-in shared
// memory (less what the kernel declares statically).
int init_cluster_kernels() {
  static bool done = false;
  if (done) return 0;
  int err = read_smem_optin();
  if (err) return err;
  const void* fns[] = {(const void*)gat_attention_bwd_kernel,
                       (const void*)offdiag_loss_kernel<true, true>,
                       (const void*)offdiag_loss_kernel<true, false>,
                       (const void*)offdiag_loss_kernel<false, true>,
                       (const void*)offdiag_loss_kernel<false, false>};
  for (const void* fn : fns) {
    cudaFuncAttributes fa;
    err = (int)cudaFuncGetAttributes(&fa, fn);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          g_smem_optin - (int)fa.sharedSizeBytes);
    if (err) return err;
  }
  done = true;
  return 0;
}

// The shared memory gat_attention_bwd_kernel lays out for a plan (the
// wrapper's ops.gat_attention_bwd_plan computes the same bytes).
size_t bwd_smem(int n, int d, int cluster, int rows, int chunk, int sub) {
  return sizeof(float) *
         ((size_t)chunk * (d | 1) + n + 5 * (size_t)rows + 2 * (size_t)d +
          (size_t)sub * d + 2 * (size_t)sub * chunk +
          (size_t)chunk * (d + 1) + (size_t)BWD_WARPS * d +
          3 * (size_t)BWD_THREADS + 3 * (size_t)cluster * d +
          (chunk >= n ? (size_t)rows * n : 0));
}

int launch_offdiag(const float* G, const float* T, float* vals, int n_vals,
                   int slot, float* gsym, int batch, int n, int cluster,
                   int per_block, int stages, int vec, int absolute,
                   cudaStream_t st) {
  if (batch <= 0 || n <= 0) return 0;
  const long long nt = (n + OD_TILE - 1) / OD_TILE;
  if (cluster < 1 || cluster > 16 || per_block < 1 ||
      (long long)cluster * per_block < nt * nt || stages < 1 ||
      stages > per_block || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (vec && !(n % 4 == 0 && aligned16(G) && aligned16(T) &&
               (!gsym || aligned16(gsym))))
    return (int)cudaErrorInvalidValue;
  const int err = init_cluster_kernels();
  if (err) return err;
  const int ldt = vec ? OD_TILE + 4 : OD_TILE + 1;
  const size_t stage = sizeof(float) * (2 * OD_TILE * OD_TILE +
                                        (gsym ? 2 * OD_TILE * ldt : 0));
  const size_t smem = stage * stages;
  if (smem > (size_t)g_smem_optin) return (int)cudaErrorInvalidValue;
  const void* fn =
      vec ? (gsym ? (const void*)offdiag_loss_kernel<true, true>
                  : (const void*)offdiag_loss_kernel<true, false>)
          : (gsym ? (const void*)offdiag_loss_kernel<false, true>
                  : (const void*)offdiag_loss_kernel<false, false>);
  void* args[] = {&G, &T, &vals, &n_vals, &slot, &gsym,
                  &n, &per_block, &stages, &absolute};
  return launch_cluster(fn, dim3((unsigned)cluster, (unsigned)batch),
                        cluster, OD_THREADS, smem, st, args);
}

}  // namespace

extern "C" int fcsr_gat_attention(
    const float* h, const float* att_src, long long s_src,
    const float* att_dst, long long s_dst, const float* bias,
    long long s_bias, const float* a, const int* seeds, float* y,
    float* alpha, int batch, int n, int heads, int d, int mask_id,
    float drop_p, float scale, int global_shift, void* stream) {
  dim3 grid(n, heads, batch);
  gat_attention_kernel<<<grid, block_for(n), n * sizeof(float),
                         (cudaStream_t)stream>>>(
      h, att_src, s_src, att_dst, s_dst, bias, s_bias, a, seeds, y, alpha, n,
      heads, d, mask_id, drop_p, scale, global_shift);
  return (int)cudaGetLastError();
}

// The plan (cluster size, rows per block, source chunk, sub-band rows)
// comes from the wrapper (ops.gat_attention_bwd_plan, sized against the
// card's opt-in shared memory, which is checked again here); chunk >= n
// stages the head's h once.
extern "C" int fcsr_gat_attention_bwd(
    const float* g_y, const float* y, const float* alpha, const float* h,
    const float* att_src, long long s_src, const float* att_dst,
    long long s_dst, const int* seeds, float* g_h, float* g_src,
    long long sg_src, float* g_dst, long long sg_dst, float* g_bias,
    long long sg_bias, int batch, int n, int heads, int d, int mask_id,
    float drop_p, float scale, int cluster, int rows, int chunk, int sub,
    void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return 0;
  if (d < 1 || d > BWD_THREADS || cluster < 1 ||
      cluster > BWD_MAX_CLUSTER || rows < 1 ||
      (long long)cluster * rows < n || chunk < 1 || sub < 1 ||
      sub > rows || (drop_p > 0.f && !seeds) || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int err = init_cluster_kernels();
  if (err) return err;
  const size_t smem = bwd_smem(n, d, cluster, rows, chunk, sub);
  if (smem > (size_t)g_smem_optin) return (int)cudaErrorInvalidValue;
  void* args[] = {&g_y,    &y,       &alpha,   &h,     &att_src, &s_src,
                  &att_dst, &s_dst,  &seeds,   &g_h,   &g_src,   &sg_src,
                  &g_dst,  &sg_dst,  &g_bias,  &sg_bias, &n,     &heads,
                  &d,      &mask_id, &drop_p,  &scale, &rows,    &chunk,
                  &sub};
  return launch_cluster((const void*)gat_attention_bwd_kernel,
                        dim3((unsigned)cluster, (unsigned)heads,
                             (unsigned)batch),
                        cluster, BWD_THREADS, smem, (cudaStream_t)stream,
                        args);
}

extern "C" int fcsr_philox_keep_mask(const int* seeds, const float* x,
                                     float* out, int batch, int heads,
                                     long long per_head, int mask_id,
                                     float drop_p, float scale,
                                     void* stream) {
  const long long total = (long long)batch * heads * per_head;
  philox_keep_mask_kernel<<<grid_for(total, 256), 256, 0,
                            (cudaStream_t)stream>>>(
      seeds, x, out, batch, heads, per_head, mask_id, drop_p, scale);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_gat_pool_adj(const float* a, const int* idx, float* out,
                                 int batch, int n, int k, float eps,
                                 void* stream) {
  gat_pool_adj_kernel<<<batch, 256, k * sizeof(float),
                        (cudaStream_t)stream>>>(a, idx, out, n, k, eps);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_col_softmax(const float* y, float* q, int batch, int R,
                                int C, void* stream) {
  col_softmax_kernel<<<grid_for((long long)batch * C, 128), 128, 0,
                       (cudaStream_t)stream>>>(y, q, batch, R, C);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_col_softmax_bwd(const float* g_q, const float* q,
                                    float* g_y, int batch, int R, int C,
                                    void* stream) {
  col_softmax_bwd_kernel<<<grid_for((long long)batch * C, 128), 128, 0,
                           (cudaStream_t)stream>>>(g_q, q, g_y, batch, R, C);
  return (int)cudaGetLastError();
}

// The plan (cluster size, tiles per block, tiles staged at once, 16-byte
// copies) comes from the wrapper (ops.offdiag_plan); a plan the pointers
// or the card do not allow is refused.
extern "C" int fcsr_offdiag_mse(const float* G, const float* T, float* vals,
                                int n_vals, int slot, float* gsym, int batch,
                                int n, int cluster, int per_block, int stages,
                                int vec, void* stream) {
  return launch_offdiag(G, T, vals, n_vals, slot, gsym, batch, n, cluster,
                        per_block, stages, vec, 0, (cudaStream_t)stream);
}

extern "C" int fcsr_offdiag_mae(const float* G, const float* T, float* vals,
                                int n_vals, int slot, int batch, int n,
                                int cluster, int per_block, int stages,
                                int vec, void* stream) {
  return launch_offdiag(G, T, vals, n_vals, slot, nullptr, batch, n,
                        cluster, per_block, stages, vec, 1,
                        (cudaStream_t)stream);
}

extern "C" int fcsr_adamw_masked(const float* p, const float* m,
                                 const float* v, const float* g,
                                 const float* scal, const float* vals,
                                 int n_vals, float* p_out, float* m_out,
                                 float* v_out, float* loss, int batch,
                                 long long P, float b1, float omb1, float b2,
                                 float omb2, float eps, float wd,
                                 void* stream) {
  const long long total = P * batch;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  adamw_masked_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      p, m, v, g, scal, vals, n_vals, p_out, m_out, v_out, loss, batch, P, b1,
      omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}
