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
// needed, so none is stored between forward and backward: the attention's
// inside the attention kernels, the pool's inside its two products
// (philox_drop_logits, philox_drop_outer). The forward
// runs a block per (band of target rows, head, fold) over its head's
// staged h, a warp per row; the pooled adjacency runs bands of pooled
// rows per fold, each block summing every row itself; the adjoint and the
// off-diagonal losses run a thread-block cluster per fold or per (head,
// fold) whose blocks meet in distributed shared memory inside the one
// launch. Every such launch takes a plan made on the host (ops.*_plan).
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

__device__ __forceinline__ float leaky(float z) {
  return z >= 0.f ? z : 0.2f * z;          // slope 1 at exactly 0
}

// <h[row, head block], att[head]> over the head's d features
__device__ __forceinline__ float head_dot(const float* __restrict__ hrow,
                                          const float* __restrict__ att,
                                          int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc += hrow[c] * att[c];
  return acc;
}

// ---------------------------------------------------------------------------
// gat_attention: block (band b of R target rows, head j, fold f).
//   s[src] = <h[src, j], att_src[j]>, t[i] = <h[i, j], att_dst[j]>
//   logit[i, src] = leaky(s[src] + t[i]) where a[i, src] != 0 or src == i
//   alpha = softmax over the unmasked sources (shift: the head's row maximum,
//           or with global_shift the row's maximum over all heads)
//   y[i, j block] = relu(sum_src alpha keep / (1 - p) h[src, j block] + bias)
// The block stages by cp.async, all in flight at once, the h columns of
// its head (of every head with global_shift; rows padded to an odd
// stride) and its band's rows of a (16-byte copies where n % 4 == 0 and a
// is aligned), and computes s once per source and head and t once per band
// row and head, not once per pair (``sl`` lanes per dot). A warp per band
// row then walks the sources (lanes along them, every access to a and
// alpha coalesced, the max and the sum by shuffles, no block barrier per
// row): the logits into the row of a's place (-inf where masked) and
// their maximum, then exp and the denominator, then alpha (written when
// asked for) and alpha keep / (1 - p), each pair's keep bit drawn once.
// The output product (alpha keep) @ h_head runs over all threads: each
// (row, feature) output is summed by ``group`` lanes over interleaved
// sources, then a shuffle tree, in a fixed order (no atomics: the same
// bits from run to run). Past what shared memory holds the sources go in
// chunks of ``chunk``: pass 1 keeps a running (shift, sum) per row,
// rescaled as the shift grows; pass 2 restages each chunk and adds its
// share of the product into a band accumulator. The wrapper plans R, the
// chunk and the group (ops.gat_attention_plan): at F = 3, n = 160, 4 heads
// of 8, 20 bands of 8 rows per (head, fold).
// Bound: bytes on paper (a read and alpha written, F H n^2 floats); on the
// card the staging round trip and the phases' dependent instructions, a
// few microseconds a launch at the step's widths (PERF.md Findings).
// ---------------------------------------------------------------------------
constexpr int FWD_THREADS = 256;
constexpr int FWD_WARPS = FWD_THREADS / 32;

__global__ void __launch_bounds__(FWD_THREADS, 3)
    gat_attention_kernel(
        const float* __restrict__ h, const float* __restrict__ att_src,
        long long s_src, const float* __restrict__ att_dst, long long s_dst,
        const float* __restrict__ bias, long long s_bias,
        const float* __restrict__ a, const int* __restrict__ seeds,
        float* __restrict__ y, float* __restrict__ alpha, int n, int heads,
        int d, int mask_id, float drop_p, float scale, int global_shift,
        int R, int chunk, int group, int vec) {
  extern __shared__ float4 sh4[];  // 16-byte aligned for cp.async16
  const int b = blockIdx.x, j = blockIdx.y, f = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int HD = heads * d;
  const int hh = global_shift ? heads : 1;    // heads whose logits it needs
  const int jo = global_shift ? j : 0;        // its own head among them
  const int col0 = global_shift ? 0 : j * d;  // first staged column of h
  const int wd = hh * d, ldh = wd | 1;
  const int ldp = (chunk + 3) / 4 * 4 + 4;    // 16-byte rows
  const int i0 = b * R, rows = max(0, min(R, n - i0));
  const bool staged = chunk >= n;
  const bool drop = drop_p > 0.f;
  float* P = reinterpret_cast<float*>(sh4);   // R x ldp: a, then alpha k
  float* hs = P + (size_t)R * ldp;            // chunk x ldh: h rows
  float* sc = hs + (size_t)chunk * ldh;       // hh x chunk: s of the chunk
  float* tb = sc + (size_t)hh * chunk;        // hh x R: t of the band
  float* mx = tb + (size_t)hh * R;            // R: the rows' shift
  float* den = mx + R;                        // R: the rows' denominator
  float* atts = den + R;                      // wd: att_src of the heads
  float* attd = atts + wd;                    // wd: att_dst of the heads
  float* acc = attd + wd;                     // chunks: R x d partial y
  const float* hf = h + (size_t)f * n * HD + col0;
  const float* ab = a + ((size_t)f * n + i0) * n;  // the band's rows of a
  const int* seed2 = seeds ? seeds + 2 * f : nullptr;

  // h rows c0 .. c0 + cols (the staged heads' columns) and the band's
  // columns c0 .. c0 + cols of a, by cp.async
  auto stage = [&](int c0, int cols) {
    for (int e = tid; e < cols * wd; e += FWD_THREADS) {
      const int q = e / wd, c = e - q * wd;
      cp_async4(hs + q * ldh + c, hf + (size_t)(c0 + q) * HD + c, 4);
    }
    if (vec) {
      const int c4 = cols >> 2;
      for (int e = tid; e < rows * c4; e += FWD_THREADS) {
        const int r = e / c4, q = (e - r * c4) * 4;
        cp_async16(P + r * ldp + q, ab + (size_t)r * n + c0 + q, 16);
      }
    } else {
      for (int e = tid; e < rows * cols; e += FWD_THREADS) {
        const int r = e / cols, q = e - r * cols;
        cp_async4(P + r * ldp + q, ab + (size_t)r * n + c0 + q, 4);
      }
    }
    cp_async_commit();
  };
  // <h row, att> for heads jj0 .. jj1 of ``count`` rows: s of the
  // chunk's sources, or with ``targets`` t of the band rows (staged: their
  // h rows are in place); ``sl`` lanes per dot along the features, then a
  // shuffle tree
  int sl = 1;
  while (sl < 32 && 8 * sl <= d) sl *= 2;  // 4 to 7 terms per lane
  auto dots = [&](int count, int jj0, int jj1, bool targets) {
    const int part = tid & (sl - 1);
    for (int jj = jj0; jj < jj1; ++jj) {
      const float* at = (targets ? attd : atts) + jj * d;
      float* out = targets ? tb + jj * R : sc + jj * chunk;
      for (int q0 = 0; q0 < count; q0 += FWD_THREADS / sl) {  // uniform
        const int q = q0 + tid / sl;
        float v = 0.f;
        if (q < count) {
          const float* hr = hs + (targets ? i0 + q : q) * ldh + jj * d;
          for (int c = part; c < d; c += sl) v += hr[c] * at[c];
        }
        for (int o = sl >> 1; o > 0; o >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, o, sl);
        if (q < count && part == 0) out[q] = v;
      }
    }
  };

  // the band's share of (alpha keep) @ h_head over the chunk's sources:
  // ``group`` lanes per (row, feature) output over interleaved sources,
  // then a shuffle tree; with chunks, added to the band's partial outputs
  const float* b_j = bias + f * s_bias + j * d;
  const int per = FWD_THREADS / group, g = tid & (group - 1);
  const int outs = rows * d;
  auto product = [&](int c0, int cols) {
    const float* hj = hs + jo * d;
    const bool last = c0 + chunk >= n;
    for (int o0 = 0; o0 < outs; o0 += per) {  // uniform over the block
      const int o = o0 + tid / group;
      const bool act = o < outs;
      const int r = act ? o / d : 0, c = o - r * d;
      float v = 0.f;
      if (act) {
        const float* pr = P + r * ldp;
        for (int q = g; q < cols; q += group) v += pr[q] * hj[q * ldh + c];
      }
      for (int s = group >> 1; s > 0; s >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, s, group);
      if (act && g == 0) {
        if (c0 > 0) v += acc[o];
        if (last) {
          v += b_j[c];
          y[((size_t)f * n + i0 + r) * HD + j * d + c] = v > 0.f ? v : 0.f;
        } else {
          acc[o] = v;
        }
      }
    }
  };
  // band row r's logits over the chunk's sources into P in place of a
  // (-inf where masked) and, with ``want_max``, their maximum over the
  // staged heads (every lane gets it)
  auto row_logits = [&](int r, int c0, int cols, bool want_max) {
    const int i = i0 + r;
    float* pr = P + r * ldp;
    const float t = tb[jo * R + r];
    const float* so = sc + jo * chunk;
    float m = -INFINITY;
    for (int q = lane; q < cols; q += 32) {
      const bool on = pr[q] != 0.f || c0 + q == i;
      const float z = on ? leaky(so[q] + t) : -INFINITY;
      pr[q] = z;
      m = fmaxf(m, z);
      if (want_max && hh > 1 && on) {
        for (int jj = 0; jj < hh; ++jj)
          m = fmaxf(m, leaky(sc[jj * chunk + q] + tb[jj * R + r]));
      }
    }
    return want_max ? warp_max(m) : 0.f;
  };
  // exp(z - m) of row r's logits in P (0 where masked), into P where
  // ``keep_e``; the lane's share of their sum
  auto row_exp = [&](int r, int cols, float m, bool keep_e) {
    float* pr = P + r * ldp;
    float part = 0.f;
    for (int q = lane; q < cols; q += 32) {
      const float z = pr[q];
      const float e = z > -INFINITY ? expf(z - m) : 0.f;
      if (keep_e) pr[q] = e;
      part += e;
    }
    return part;
  };
  // alpha = e inv of row r (e in P, or exp(z - m) from its logits with
  // ``from_z``), written out when asked for, and alpha keep / (1 - p) into
  // P, each pair's keep bit drawn once
  const unsigned key0 = seed2 ? (unsigned)seed2[0] : 0u;
  const unsigned key1 = seed2 ? (unsigned)seed2[1] : 0u;
  auto row_alpha = [&](int r, int c0, int cols, float m, float inv,
                       bool from_z) {
    const int i = i0 + r;
    float* pr = P + r * ldp;
    float* alrow = alpha
        ? alpha + (((size_t)f * heads + j) * n + i) * n + c0 : nullptr;
    for (int q = lane; q < cols; q += 32) {
      const float e = from_z ? expf(pr[q] - m) : pr[q];
      float al = e * inv;
      if (alrow) alrow[q] = al;
      if (drop)
        al = al * bits_to_keep(philox_word(key0, key1,
                                           (unsigned)(i * n + c0 + q),
                                           (unsigned)j, (unsigned)mask_id,
                                           0u), drop_p) * scale;
      pr[q] = al;
    }
  };

  stage(0, min(chunk, n));
  for (int r = tid; r < R; r += FWD_THREADS) {
    mx[r] = -INFINITY;
    den[r] = 0.f;
  }
  for (int e = tid; e < wd; e += FWD_THREADS) {
    atts[e] = att_src[f * s_src + col0 + e];
    attd[e] = att_dst[f * s_dst + col0 + e];
  }
  if (!staged) {  // t of the band rows, from device memory
    for (int e = tid; e < hh * rows; e += FWD_THREADS) {
      const int jj = e / rows, r = e - jj * rows;
      tb[jj * R + r] = head_dot(hf + (size_t)(i0 + r) * HD + jj * d,
                                att_dst + f * s_dst + col0 + jj * d, d);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  dots(min(chunk, n), 0, hh, false);
  if (staged) dots(rows, 0, hh, true);
  __syncthreads();

  if (staged) {
    // every source in place: a warp takes its rows from logits to
    // alpha keep / (1 - p) with no block barrier, e kept in P between
    for (int r = w; r < rows; r += FWD_WARPS) {
      const float m = row_logits(r, 0, n, true);
      const float inv = 1.f / warp_sum(row_exp(r, n, m, true));
      row_alpha(r, 0, n, m, inv, false);
    }
    __syncthreads();
    product(0, n);
    return;
  }

  // chunks, pass 1: each band row's running shift (over the staged heads)
  // and its head's denominator, rescaled as the shift grows
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cols = min(chunk, n - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous chunk is consumed
      stage(c0, cols);
      cp_async_wait<0>();
      __syncthreads();
      dots(cols, 0, hh, false);
      __syncthreads();
    }
    for (int r = w; r < rows; r += FWD_WARPS) {
      const float old = mx[r];
      const float mn = fmaxf(old, row_logits(r, c0, cols, true));
      const float part = warp_sum(row_exp(r, cols, mn, false));
      if (lane == 0) {
        den[r] = (old == -INFINITY ? 0.f : den[r] * expf(old - mn)) + part;
        mx[r] = mn;
      }
    }
  }
  // pass 2: each chunk restaged, alpha and alpha keep / (1 - p) in place
  // of a, then the chunk's share of the output product
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cols = min(chunk, n - c0);
    __syncthreads();  // the shifts are final; the last chunk is consumed
    stage(c0, cols);
    cp_async_wait<0>();
    __syncthreads();
    dots(cols, jo, jo + 1, false);
    __syncthreads();
    for (int r = w; r < rows; r += FWD_WARPS) {
      row_logits(r, c0, cols, false);  // the shifts are final
      row_alpha(r, c0, cols, mx[r], 1.f / den[r], true);
    }
    __syncthreads();
    product(c0, cols);
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
// Replaces mask_kernel of tools/experiments/gat_dropout_keeprate.py (one
// (256, 256) mask a call from the TPU core's own generator, prng_seed /
// prng_random_bits, whose bits the card cannot draw).
// Bound: the output's bytes (4 a draw, and 4 of x) and the draws' integer
// work (Philox-4x32-10: 10 rounds of two 32 x 32 -> 64-bit products and
// their XORs), each near 1.2 us at the keep-rate shape (4 seeds x 4 heads
// x 256^2) by NVIDIA's per-clock rates. The design spends no instruction
// on anything else: a block walks one strip of one (fold, head) plane
// (grid (strips, heads, F)), so the plane comes from blockIdx with no
// division and the element counter is the 32-bit index within the plane;
// the fold's seeds are loaded once and the key schedule (PhiloxPlane) is
// made once per thread, outside the loop, with the half of round 0 that
// only sees the head and mask id; a thread draws four consecutive
// elements and writes them with one 16-byte store (one 16-byte load of
// x), at most 32 registers so that 8 blocks share an SM. Where per_head %
// 4 != 0 or x is not 16-byte aligned, VEC = 1: a draw and a 4-byte access
// a thread. Planes longer than the grid's strip are walked grid-stride in
// 32 bits. The strips come from the host (ops.philox_keep_mask_plan: the
// card about full in one wave). Each product is written as one 64-bit
// multiply so that ptxas keeps it one IMAD.WIDE.U32 (as high and low
// halves it split a third of them in two). On the card a draw takes about
// twice the SM clocks its instruction count gives; what binds is not
// measured (PERF.md Findings).
// ---------------------------------------------------------------------------
constexpr int KM_THREADS = 256;

// The draws of one plane: Philox-4x32-10 word 0 at counter (e, head,
// mask_id, 0) under the key (seed0, seed1), philox_word's bits, with the
// key of every round and round 0's product of the mask id made once. Round
// 0 of counter (e, head, mask, 0) leaves c0 = hi(M1 mask) ^ head ^ k0 and
// c1 = lo(M1 mask), the same for every e, and c2 = hi(M0 e) ^ k1,
// c3 = lo(M0 e).
struct PhiloxPlane {
  unsigned k0[10], k1[10], c0, c1;

  __device__ __forceinline__ PhiloxPlane(unsigned s0, unsigned s1,
                                         unsigned head, unsigned mask) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      k0[r] = s0 + (unsigned)r * 0x9E3779B9u;
      k1[r] = s1 + (unsigned)r * 0xBB67AE85u;
    }
    c0 = __umulhi(0xCD9E8D57u, mask) ^ head ^ k0[0];
    c1 = 0xCD9E8D57u * mask;
  }

  __device__ __forceinline__ unsigned word(unsigned e) const {
    unsigned long long p0 = 0xD2511F53ull * e;
    unsigned a = c0, b = c1, c2 = (unsigned)(p0 >> 32) ^ k1[0],
             c3 = (unsigned)p0;
#pragma unroll
    for (int r = 1; r < 10; ++r) {
      p0 = 0xD2511F53ull * a;
      const unsigned long long p1 = 0xCD9E8D57ull * c2;
      a = (unsigned)(p1 >> 32) ^ b ^ k0[r];
      c2 = (unsigned)(p0 >> 32) ^ c3 ^ k1[r];
      b = (unsigned)p1;
      c3 = (unsigned)p0;
    }
    return a;
  }
};

template <int VEC>
__global__ void __launch_bounds__(KM_THREADS, 8) philox_keep_mask_kernel(
    const int* __restrict__ seeds, const float* __restrict__ x,
    float* __restrict__ out, unsigned per_head, int mask_id, float drop_p,
    float scale) {
  const unsigned head = blockIdx.y, f = blockIdx.z;
  const size_t plane = ((size_t)f * gridDim.y + head) * per_head;
  const PhiloxPlane key((unsigned)seeds[2 * f], (unsigned)seeds[2 * f + 1],
                        head, (unsigned)mask_id);
  const float* __restrict__ xp = x ? x + plane : nullptr;
  float* __restrict__ op = out + plane;
  const unsigned stride = gridDim.x * (unsigned)(KM_THREADS * VEC);
#pragma unroll 1
  for (unsigned e = (blockIdx.x * KM_THREADS + threadIdx.x) * VEC;
       e < per_head;) {
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = bits_to_keep(key.word(e + j), drop_p);
    if constexpr (VEC == 4) {
      if (xp) {
        const float4 xv = *reinterpret_cast<const float4*>(xp + e);
        v[0] = __fmul_rn(xv.x, v[0]);
        v[1] = __fmul_rn(xv.y, v[1]);
        v[2] = __fmul_rn(xv.z, v[2]);
        v[3] = __fmul_rn(xv.w, v[3]);
      }
      *reinterpret_cast<float4*>(op + e) =
          make_float4(__fmul_rn(v[0], scale), __fmul_rn(v[1], scale),
                      __fmul_rn(v[2], scale), __fmul_rn(v[3], scale));
    } else {
      if (xp) v[0] = __fmul_rn(xp[e], v[0]);
      op[e] = __fmul_rn(v[0], scale);
    }
    if (per_head - e <= stride) break;  // e + stride: past the plane
    e += stride;
  }
}

// ---------------------------------------------------------------------------
// philox_drop_logits / philox_drop_outer: the pool's dropout (mask
// ``mask_id``, head 0, element r c + col of the fold's (n, c) input) drawn
// inside the two products that consume it, so no mask and no masked copy
// makes a launch of its own:
//   forward  z = (x keep) scale, logits[f, r] = sum_col z[r, col] w[col] + b
//   adjoint  g_z[f, r, col] = ((gl[f, r] w[col]) keep) scale
// The forward is gemv_dot's warp per row (bgemm.cu): lanes along the row,
// each lane's fmaf chain in the same order, warp_sum, then + b, so the
// logits are bit-equal to philox_keep_mask followed by bgemm_f32 (they
// feed a top-k, where one ulp can swap a kept node at a near tie). The
// products are __fmul_rn, as philox_keep_mask's and rank1_kernel's are
// rounded, so no contraction into an FMA moves a bit. The adjoint writes
// each row coalesced, ``VEC`` consecutive columns a thread (16-byte stores
// where c % 4 == 0). Bound: a few hundred KB and one Philox draw per
// element; at the step's (3, 160..40, 32..128) launch latency. The grid
// comes from the host (ops.philox_drop_logits_plan /
// ops.philox_drop_outer_plan).
// ---------------------------------------------------------------------------
constexpr int DROP_THREADS = 128;
constexpr int DROP_WARPS = DROP_THREADS / 32;

__global__ void __launch_bounds__(DROP_THREADS) philox_drop_logits_kernel(
    const float* __restrict__ x, const float* __restrict__ w, long long sw,
    const float* __restrict__ b, long long sb, const int* __restrict__ seeds,
    float* __restrict__ z, float* __restrict__ logits, int n, int c,
    int mask_id, float drop_p, float scale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * DROP_WARPS + (threadIdx.x >> 5);
  const int f = blockIdx.y;
  if (r >= n) return;  // the whole warp
  const unsigned k0 = (unsigned)seeds[2 * f], k1 = (unsigned)seeds[2 * f + 1];
  const size_t row = ((size_t)f * n + r) * c;
  const float* __restrict__ wf = w + f * sw;
  const unsigned e0 = (unsigned)r * (unsigned)c;
  float s = 0.f;
#pragma unroll 4
  for (int k = lane; k < c; k += 32) {
    const float keep = bits_to_keep(
        philox_word(k0, k1, e0 + (unsigned)k, 0u, (unsigned)mask_id, 0u),
        drop_p);
    const float zv = __fmul_rn(__fmul_rn(x[row + k], keep), scale);
    z[row + k] = zv;
    s = fmaf(zv, wf[k], s);
  }
  s = warp_sum(s);
  if (lane == 0) logits[(size_t)f * n + r] = s + b[f * sb];
}

template <int VEC>
__global__ void __launch_bounds__(DROP_THREADS) philox_drop_outer_kernel(
    const float* __restrict__ gl, const float* __restrict__ w, long long sw,
    const int* __restrict__ seeds, float* __restrict__ gz, int n, int c,
    int mask_id, float drop_p, float scale) {
  const int f = blockIdx.y;
  const long long v = blockIdx.x * (long long)DROP_THREADS + threadIdx.x;
  if (v >= (long long)n * c / VEC) return;
  const unsigned e = (unsigned)(v * VEC);  // VEC divides c: one row
  const int r = (int)(e / (unsigned)c), col = (int)(e % (unsigned)c);
  const unsigned k0 = (unsigned)seeds[2 * f], k1 = (unsigned)seeds[2 * f + 1];
  const float g = gl[(size_t)f * n + r];
  const float* __restrict__ wf = w + f * sw + col;
  float out[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float keep = bits_to_keep(
        philox_word(k0, k1, e + j, 0u, (unsigned)mask_id, 0u), drop_p);
    out[j] = __fmul_rn(__fmul_rn(__fmul_rn(g, wf[j]), keep), scale);
  }
  float* dst = gz + (size_t)f * n * c + e;
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(dst) =
        make_float4(out[0], out[1], out[2], out[3]);
  else
    dst[0] = out[0];
}

// ---------------------------------------------------------------------------
// gat_pool_adj: out[f] = symnorm(g), g = a[f][idx][:, idx] (k x k),
// r = (rowsum(g) + eps)^-1/2, out = (g r_col) r_row.
// Grid (bands, F): block b writes the band of R pooled rows [b R, b R + R),
// a warp per row, coalesced along it, the row gathered through the fold's
// idx (staged in shared memory). Every block needs all k values of r, and
// each sums all k rows itself (k^2 gathered reads: no barrier between
// blocks, cheap at the step's k <= 80), a warp per row too: the lanes take
// interleaved columns of one row (a row's reads stay within it, so its
// sectors are reused from L1), two rows at a time, and shuffles reduce
// them in a fixed order (no atomics). The wrapper plans the bands and R
// (ops.gat_pool_adj_plan): at F = 3, 160 -> 80, 16 blocks of 5 rows per
// fold.
// ---------------------------------------------------------------------------
constexpr int POOL_THREADS = 512;
constexpr int POOL_WARPS = POOL_THREADS / 32;

__global__ void __launch_bounds__(POOL_THREADS)
    gat_pool_adj_kernel(const float* __restrict__ a,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int n, int k, float eps, int R, int vec) {
  extern __shared__ float4 sh4[];  // 16-byte aligned for cp.async16
  const int b = blockIdx.x, f = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int* ix = reinterpret_cast<int*>(sh4);           // k: the fold's idx
  float* rall = reinterpret_cast<float*>(ix + k);  // k: every row's r
  const float* af = a + (size_t)f * n * n;
  const int* ixf = idx + (size_t)f * k;

  if (vec) {
    for (int e = 4 * tid; e < k; e += 4 * POOL_THREADS)
      cp_async16(reinterpret_cast<float*>(ix + e),
                 reinterpret_cast<const float*>(ixf + e), 16);
  } else {
    for (int e = tid; e < k; e += POOL_THREADS)
      cp_async4(reinterpret_cast<float*>(ix + e),
                reinterpret_cast<const float*>(ixf + e), 4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // r of every row: a warp per row, rows w and w + POOL_WARPS together
  for (int r0 = w; r0 < k; r0 += 2 * POOL_WARPS) {
    const int r1 = r0 + POOL_WARPS;
    const float* a0 = af + (size_t)ix[r0] * n;
    const float* a1 = af + (size_t)ix[r1 < k ? r1 : r0] * n;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int c = lane; c < k; c += 32) {
      const int col = ix[c];
      s0 += __ldg(a0 + col);
      s1 += __ldg(a1 + col);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      rall[r0] = rsqrtf(s0 + eps);
      if (r1 < k) rall[r1] = rsqrtf(s1 + eps);
    }
  }
  __syncthreads();
  const int i0 = b * R, rows = max(0, min(R, k - i0));
  for (int r = w; r < rows; r += POOL_WARPS) {
    const int i = i0 + r;
    const float ri = rall[i];
    const float* arow = af + (size_t)ix[i] * n;
    float* orow = out + ((size_t)f * k + i) * k;
    for (int c = lane; c < k; c += 32)
      orow[c] = __ldg(arow + ix[c]) * rall[c] * ri;
  }
}

// ---------------------------------------------------------------------------
// col_softmax: q = softmax over the R rows of (F, R, C), column by column
// (the reference's upsampler: shift by the column max, e = exp(y - max),
// q = e / sum e, a true division). Grid (column blocks, F): a block takes
// 32 consecutive columns of a fold, a lane each, so every load and store
// of a warp is one 128-byte row segment; its warps split the rows. Each y
// is read once and q written once. The column's max and sum meet across
// the warps in shared memory, summed in warp order (no atomics: the same
// bits from run to run). Two forms, planned on the host
// (ops.col_softmax_plan): up to 128 rows the values stay in registers
// (CSM_PER = 4 per thread, warps = ceil(R / 4): of 2, 4, 8 and 16 rows a
// thread, 4 was the fastest at 16 and 64 rows on an H100, PERF.md); past
// that 32 warps walk the rows and read y again from L2 (three reads).
// Bound: bytes (R C floats in and out), launch latency at the step's
// 16 x 268; the old form's thread per column walked the rows three times.
// ---------------------------------------------------------------------------
constexpr int CSM_PER = 4;
constexpr int CSM_MAX_WARPS = 32;

// max (sum) of the lane's column over the block's W warps, in warp order
__device__ __forceinline__ float csm_meet(float v, bool is_max, int w, int W,
                                          float (*red)[32]) {
  if (W == 1) return v;
  const int lane = threadIdx.x & 31;
  red[w][lane] = v;
  __syncthreads();
  v = red[0][lane];
  for (int i = 1; i < W; ++i)
    v = is_max ? fmaxf(v, red[i][lane]) : v + red[i][lane];
  __syncthreads();  // red is written again by the next meeting
  return v;
}

__global__ void __launch_bounds__(32 * CSM_MAX_WARPS)
    col_softmax_regs(const float* __restrict__ y, float* __restrict__ q,
                     int R, int C) {
  __shared__ float red[CSM_MAX_WARPS][32];
  const int w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + (threadIdx.x & 31), f = blockIdx.y;
  const bool on = col < C;
  const size_t base = (size_t)f * R * C + col;
  float v[CSM_PER];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < CSM_PER; ++j) {
    const int r = w * CSM_PER + j;
    v[j] = on && r < R ? y[base + (size_t)r * C] : -INFINITY;
    mx = fmaxf(mx, v[j]);
  }
  mx = csm_meet(mx, true, w, W, red);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CSM_PER; ++j) {
    v[j] = w * CSM_PER + j < R ? expf(v[j] - mx) : 0.f;
    s += v[j];
  }
  s = csm_meet(s, false, w, W, red);
  if (!on) return;
#pragma unroll
  for (int j = 0; j < CSM_PER; ++j) {
    const int r = w * CSM_PER + j;
    if (r < R) q[base + (size_t)r * C] = v[j] / s;
  }
}

// R past the registers: warp w takes rows w, w + W, ...; the later passes
// read y again.
__global__ void __launch_bounds__(32 * CSM_MAX_WARPS)
    col_softmax_rows(const float* __restrict__ y, float* __restrict__ q,
                     int R, int C) {
  __shared__ float red[CSM_MAX_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5,
            W = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + lane, f = blockIdx.y;
  const bool on = col < C;
  const float* __restrict__ yc = y + (size_t)f * R * C + (on ? col : 0);
  float mx = -INFINITY;
  for (int r = w; r < R; r += W) mx = fmaxf(mx, on ? yc[(size_t)r * C] : 0.f);
  mx = csm_meet(mx, true, w, W, red);
  float s = 0.f;
  for (int r = w; r < R; r += W) s += expf(yc[(size_t)r * C] - mx);
  s = csm_meet(s, false, w, W, red);
  if (!on) return;
  float* __restrict__ qc = q + (size_t)f * R * C + col;
  for (int r = w; r < R; r += W)
    qc[(size_t)r * C] = expf(yc[(size_t)r * C] - mx) / s;
}

// ---------------------------------------------------------------------------
// col_softmax_bwd: g_y = q (g_q - sum_rows q g_q) over the R rows of
// (F, R, C), the adjoint of col_softmax, in its layout and plan: grid
// (column blocks, F), a lane a column (every load and store of a warp one
// 128-byte row segment), the warps splitting the rows. Up to 128 rows
// (form 0) each warp keeps its CSM_PER rows of q and g_q in registers:
// its lanes' partial dots meet across the warps once in shared memory,
// summed in warp order (no atomics: the same bits run to run), then each
// warp writes its own rows; q and g_q are read once and g_y written once.
// Past that (form 1) 32 warps walk the rows and read q and g_q again.
// Bound: bytes (3 R C floats), launch latency at the step's 16 x 268; the
// first form's thread per column walked its rows twice in serial chains
// on 7 of the card's SMs.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * CSM_MAX_WARPS)
    col_softmax_bwd_regs(const float* __restrict__ g_q,
                         const float* __restrict__ q, float* __restrict__ g_y,
                         int R, int C) {
  __shared__ float red[CSM_MAX_WARPS][32];
  const int w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + (threadIdx.x & 31), f = blockIdx.y;
  const bool on = col < C;
  const size_t base = (size_t)f * R * C + col;
  float qv[CSM_PER], gv[CSM_PER];
#pragma unroll
  for (int j = 0; j < CSM_PER; ++j) {
    const int r = w * CSM_PER + j;
    const bool in = on && r < R;
    qv[j] = in ? q[base + (size_t)r * C] : 0.f;
    gv[j] = in ? g_q[base + (size_t)r * C] : 0.f;
  }
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < CSM_PER; ++j) dot = fmaf(qv[j], gv[j], dot);
  dot = csm_meet(dot, false, w, W, red);
  if (!on) return;
#pragma unroll
  for (int j = 0; j < CSM_PER; ++j) {
    const int r = w * CSM_PER + j;
    if (r < R) g_y[base + (size_t)r * C] = qv[j] * (gv[j] - dot);
  }
}

// R past the registers: warp w takes rows w, w + W, ...; the writes read q
// and g_q again.
__global__ void __launch_bounds__(32 * CSM_MAX_WARPS)
    col_softmax_bwd_rows(const float* __restrict__ g_q,
                         const float* __restrict__ q, float* __restrict__ g_y,
                         int R, int C) {
  __shared__ float red[CSM_MAX_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5,
            W = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + lane, f = blockIdx.y;
  const bool on = col < C;
  const size_t base = (size_t)f * R * C + (on ? col : 0);
  const float* __restrict__ qc = q + base;
  const float* __restrict__ gc = g_q + base;
  float dot = 0.f;
  if (on)
    for (int r = w; r < R; r += W)
      dot = fmaf(qc[(size_t)r * C], gc[(size_t)r * C], dot);
  dot = csm_meet(dot, false, w, W, red);
  if (!on) return;
  float* __restrict__ yc = g_y + base;
  for (int r = w; r < R; r += W)
    yc[(size_t)r * C] = qc[(size_t)r * C] * (gc[(size_t)r * C] - dot);
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
// Two forms with one body: out of place (p, m, v read through __restrict__
// pointers, p', m', v' written elsewhere) and in place (p, m, v read and
// written through the same pointers, none of them __restrict__), which
// the MLP trainer takes where a second copy of its buffers does not fit.
// ---------------------------------------------------------------------------
struct AdamwElem {
  float p, m, v;
};

__device__ __forceinline__ AdamwElem adamw_elem(
    float po, float mo, float vo, float gg, const float* __restrict__ sc,
    float b1, float omb1, float b2, float omb2, float eps, float wd) {
  const float ok = sc[0], lr = sc[1], d1 = sc[2], d2 = sc[3];
  const float mn = __fadd_rn(__fmul_rn(b1, mo), __fmul_rn(omb1, gg));
  const float vn = __fadd_rn(__fmul_rn(b2, vo),
                             __fmul_rn(omb2, __fmul_rn(gg, gg)));
  const float mhat = __fdiv_rn(mn, d1);
  const float vhat = __fdiv_rn(vn, d2);
  const float step = __fmul_rn(
      lr, __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)),
                    __fmul_rn(wd, po)));
  if (ok > 0.f) return {__fsub_rn(po, step), mn, vn};
  return {po, mo, vo};
}

__device__ __forceinline__ void adamw_loss(const float* __restrict__ vals,
                                           int n_vals,
                                           float* __restrict__ loss,
                                           int batch) {
  if (blockIdx.x != 0) return;
  for (int f = threadIdx.x; f < batch; f += blockDim.x) {
    float total_loss = vals[(long long)f * n_vals];
    for (int s = 1; s < n_vals; ++s)
      total_loss = __fadd_rn(total_loss, vals[(long long)f * n_vals + s]);
    loss[f] = total_loss;
  }
}

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
    const AdamwElem r = adamw_elem(p[e], m[e], v[e], g[e], scal + e / P * 4,
                                   b1, omb1, b2, omb2, eps, wd);
    p_out[e] = r.p;
    m_out[e] = r.m;
    v_out[e] = r.v;
  }
  adamw_loss(vals, n_vals, loss, batch);
}

__global__ void adamw_masked_inplace_kernel(
    float* p, float* m, float* v, const float* __restrict__ g,
    const float* __restrict__ scal, const float* __restrict__ vals,
    int n_vals, float* __restrict__ loss, int batch, long long P, float b1,
    float omb1, float b2, float omb2, float eps, float wd) {
  const long long total = P * batch;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const AdamwElem r = adamw_elem(p[e], m[e], v[e], g[e], scal + e / P * 4,
                                   b1, omb1, b2, omb2, eps, wd);
    p[e] = r.p;
    m[e] = r.m;
    v[e] = r.v;
  }
  adamw_loss(vals, n_vals, loss, batch);
}

// The attributes of the kernels that take a plan, set once per device on
// their first launch there (so no later launch, none inside a CUDA graph
// capture, sets one): the card's opt-in shared memory (less what the
// kernel declares statically) and, for the cluster kernels, clusters of up
// to 16 blocks (past the portable 8). The C entries refuse a plan whose
// dynamic shared memory passes the kernel's cap on the current device.
struct Caps {
  size_t fwd, bwd, pool, od;
};
Caps g_caps[MAX_DEVICES];
std::atomic<bool> g_caps_ready[MAX_DEVICES];

int init_planned_kernels(const Caps** caps) {
  int optin = 0, dev = 0;
  int err = read_smem_optin(&optin, &dev);
  if (err) return err;
  Caps& c = g_caps[dev];
  *caps = &c;
  if (g_caps_ready[dev].load(std::memory_order_acquire)) return 0;
  const struct {
    const void* fn;
    bool cluster;
    size_t* cap;
  } fns[] = {{(const void*)gat_attention_kernel, false, &c.fwd},
             {(const void*)gat_attention_bwd_kernel, true, &c.bwd},
             {(const void*)gat_pool_adj_kernel, false, &c.pool},
             {(const void*)offdiag_loss_kernel<true, true>, true, &c.od},
             {(const void*)offdiag_loss_kernel<true, false>, true, &c.od},
             {(const void*)offdiag_loss_kernel<false, true>, true, &c.od},
             {(const void*)offdiag_loss_kernel<false, false>, true, &c.od}};
  for (const auto& k : fns) {
    cudaFuncAttributes fa;
    err = (int)cudaFuncGetAttributes(&fa, k.fn);
    if (!err && k.cluster)
      err = (int)cudaFuncSetAttribute(
          k.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    const int cap = optin - (int)fa.sharedSizeBytes;
    if (!err)
      err = (int)cudaFuncSetAttribute(
          k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err) return err;
    *k.cap = (size_t)cap;
  }
  g_caps_ready[dev].store(true, std::memory_order_release);
  return 0;
}

// The shared memory gat_attention_kernel lays out for a plan (the
// wrapper's ops.gat_attention_plan computes the same bytes).
size_t fwd_smem(int n, int hh, int d, int rows, int chunk) {
  const size_t ldp = (size_t)(chunk + 3) / 4 * 4 + 4;
  return sizeof(float) *
         ((size_t)rows * ldp + (size_t)chunk * ((hh * d) | 1) +
          (size_t)hh * chunk + (size_t)hh * rows + 2 * (size_t)rows +
          2 * (size_t)hh * d + (chunk >= n ? 0 : (size_t)rows * d));
}

// ... and gat_pool_adj_kernel (ops.gat_pool_adj_plan): idx and every r
size_t pool_smem(int k) { return sizeof(float) * 2 * (size_t)k; }

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
  const Caps* caps = nullptr;
  const int err = init_planned_kernels(&caps);
  if (err) return err;
  const int ldt = vec ? OD_TILE + 4 : OD_TILE + 1;
  const size_t stage = sizeof(float) * (2 * OD_TILE * OD_TILE +
                                        (gsym ? 2 * OD_TILE * ldt : 0));
  const size_t smem = stage * stages;
  if (smem > caps->od) return (int)cudaErrorInvalidValue;
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

// The plan (rows per block, source chunk, lanes per output) comes from the
// wrapper (ops.gat_attention_plan, sized against the card's opt-in shared
// memory, which is checked again here); chunk == n stages the head's h once.
extern "C" int fcsr_gat_attention(
    const float* h, const float* att_src, long long s_src,
    const float* att_dst, long long s_dst, const float* bias,
    long long s_bias, const float* a, const int* seeds, float* y,
    float* alpha, int batch, int n, int heads, int d, int mask_id,
    float drop_p, float scale, int global_shift, int rows, int chunk,
    int group, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return 0;
  const bool staged = chunk >= n;
  if (d < 1 || rows < 1 || rows > n || chunk < 1 || (staged && chunk != n) ||
      (!staged && chunk % 4 != 0) || group < 1 || group > 32 ||
      (group & (group - 1)) != 0 || (drop_p > 0.f && !seeds) ||
      heads > 65535 || batch > 65535 || (long long)n * n >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  const Caps* caps = nullptr;
  const int err = init_planned_kernels(&caps);
  if (err) return err;
  const int hh = global_shift ? heads : 1;
  const size_t smem = fwd_smem(n, hh, d, rows, chunk);
  if (smem > caps->fwd) return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && aligned16(a);
  const dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)heads,
                  (unsigned)batch);
  gat_attention_kernel<<<grid, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      h, att_src, s_src, att_dst, s_dst, bias, s_bias, a, seeds, y, alpha, n,
      heads, d, mask_id, drop_p, scale, global_shift, rows, chunk, group,
      vec);
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
  const Caps* caps = nullptr;
  const int err = init_planned_kernels(&caps);
  if (err) return err;
  const size_t smem = bwd_smem(n, d, cluster, rows, chunk, sub);
  if (smem > caps->bwd) return (int)cudaErrorInvalidValue;
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

// The strips and the 16-byte path come from the wrapper
// (ops.philox_keep_mask_plan). Refused: more folds or heads than the
// grid's z and y extents, a counter past 32 bits (per_head >= 2^32), more
// strips than keep the stride in 32 bits, a missing pointer, the 16-byte
// path where per_head % 4 != 0 or out or x is not 16-byte aligned.
extern "C" int fcsr_philox_keep_mask(const int* seeds, const float* x,
                                     float* out, int batch, int heads,
                                     long long per_head, int strips, int vec,
                                     int mask_id, float drop_p, float scale,
                                     void* stream) {
  if (batch <= 0 || heads <= 0 || per_head <= 0) return 0;
  if (!seeds || !out || batch > 65535 || heads > 65535 ||
      per_head >= (1LL << 32) || strips < 1 || strips > 65535 ||
      (vec != 1 && vec != 4) ||
      (vec == 4 && ((per_head & 3) || !aligned16(out) ||
                    (x && !aligned16(x)))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)strips, (unsigned)heads, (unsigned)batch);
  if (vec == 4)
    philox_keep_mask_kernel<4><<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(
        seeds, x, out, (unsigned)per_head, mask_id, drop_p, scale);
  else
    philox_keep_mask_kernel<1><<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(
        seeds, x, out, (unsigned)per_head, mask_id, drop_p, scale);
  return (int)cudaGetLastError();
}

// The grids come from the wrapper (ops.philox_drop_logits_plan,
// ops.philox_drop_outer_plan). Refused: a counter past 32 bits (n c >=
// 2^32), more folds than the grid's y extent, a grid that does not cover
// the rows, a missing pointer, 16-byte stores where c % 4 != 0 or g_z is
// not 16-byte aligned.
extern "C" int fcsr_philox_drop_logits(const float* x, const float* w,
                                       long long sw, const float* b,
                                       long long sb, const int* seeds,
                                       float* z, float* logits, int batch,
                                       int n, int c, int blocks, int mask_id,
                                       float drop_p, float scale,
                                       void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return 0;
  if (!x || !w || !b || !seeds || !z || !logits || batch > 65535 ||
      (long long)n * c >= (1LL << 32) ||
      (long long)blocks * DROP_WARPS < n ||
      (long long)(blocks - 1) * DROP_WARPS >= n)
    return (int)cudaErrorInvalidValue;
  philox_drop_logits_kernel<<<dim3((unsigned)blocks, (unsigned)batch),
                              DROP_THREADS, 0, (cudaStream_t)stream>>>(
      x, w, sw, b, sb, seeds, z, logits, n, c, mask_id, drop_p, scale);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_philox_drop_outer(const float* gl, const float* w,
                                      long long sw, const int* seeds,
                                      float* gz, int batch, int n, int c,
                                      int blocks, int vec, int mask_id,
                                      float drop_p, float scale,
                                      void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return 0;
  const long long vecs = (long long)n * c / (vec == 4 ? 4 : 1);
  if (!gl || !w || !seeds || !gz || batch > 65535 ||
      (long long)n * c >= (1LL << 32) || (vec != 1 && vec != 4) ||
      (vec == 4 && (c % 4 != 0 || !aligned16(gz))) ||
      (long long)blocks * DROP_THREADS < vecs ||
      (long long)(blocks - 1) * DROP_THREADS >= vecs)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  if (vec == 4)
    philox_drop_outer_kernel<4><<<grid, DROP_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        gl, w, sw, seeds, gz, n, c, mask_id, drop_p, scale);
  else
    philox_drop_outer_kernel<1><<<grid, DROP_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        gl, w, sw, seeds, gz, n, c, mask_id, drop_p, scale);
  return (int)cudaGetLastError();
}

// The plan (bands, rows per band) comes from the wrapper
// (ops.gat_pool_adj_plan); a plan the card does not allow is refused.
extern "C" int fcsr_gat_pool_adj(const float* a, const int* idx, float* out,
                                 int batch, int n, int k, float eps,
                                 int bands, int rows, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (k > n || bands < 1 || rows < 1 || (long long)bands * rows < k ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Caps* caps = nullptr;
  const int err = init_planned_kernels(&caps);
  if (err) return err;
  const size_t smem = pool_smem(k);
  if (smem > caps->pool) return (int)cudaErrorInvalidValue;
  const int vec = k % 4 == 0 && aligned16(idx);
  gat_pool_adj_kernel<<<dim3((unsigned)bands, (unsigned)batch),
                        POOL_THREADS, smem, (cudaStream_t)stream>>>(
      a, idx, out, n, k, eps, rows, vec);
  return (int)cudaGetLastError();
}

// The plan (form, warps) comes from the wrapper (ops.col_softmax_plan); a
// plan that does not cover R is refused.
extern "C" int fcsr_col_softmax(const float* y, float* q, int batch, int R,
                                int C, int form, int warps, void* stream) {
  if (batch <= 0 || R <= 0 || C <= 0) return 0;
  if (!y || !q || batch > 65535 || warps < 1 || warps > CSM_MAX_WARPS ||
      (form == 0 && (long long)warps * CSM_PER < R) || form < 0 || form > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + 31) / 32), (unsigned)batch);
  if (form == 0)
    col_softmax_regs<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(y, q, R,
                                                                     C);
  else
    col_softmax_rows<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(y, q, R,
                                                                     C);
  return (int)cudaGetLastError();
}

// col_softmax's plan (ops.col_softmax_plan) serves its adjoint too; a plan
// that does not cover R is refused.
extern "C" int fcsr_col_softmax_bwd(const float* g_q, const float* q,
                                    float* g_y, int batch, int R, int C,
                                    int form, int warps, void* stream) {
  if (batch <= 0 || R <= 0 || C <= 0) return 0;
  if (!g_q || !q || !g_y || batch > 65535 || warps < 1 ||
      warps > CSM_MAX_WARPS ||
      (form == 0 && (long long)warps * CSM_PER < R) || form < 0 || form > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + 31) / 32), (unsigned)batch);
  if (form == 0)
    col_softmax_bwd_regs<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
        g_q, q, g_y, R, C);
  else
    col_softmax_bwd_rows<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
        g_q, q, g_y, R, C);
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
  // outputs either all alias their inputs (in place) or none does
  const bool inplace = p_out == p && m_out == m && v_out == v;
  if (!inplace && (p_out == p || m_out == m || v_out == v))
    return (int)cudaErrorInvalidValue;
  const long long total = P * batch;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  if (inplace)
    adamw_masked_inplace_kernel<<<(int)blocks, 256, 0,
                                  (cudaStream_t)stream>>>(
        p_out, m_out, v_out, g, scal, vals, n_vals, loss, batch, P, b1, omb1,
        b2, omb2, eps, wd);
  else
    adamw_masked_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
        p, m, v, g, scal, vals, n_vals, p_out, m_out, v_out, loss, batch, P,
        b1, omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}
