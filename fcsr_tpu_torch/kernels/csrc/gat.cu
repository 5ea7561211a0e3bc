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
// each is bound by bytes on paper and by launch latency in practice. The
// design is the simplest correct one: one block per attention row, sums in
// a fixed order (no atomics, so results are reproducible), dropout masks
// regenerated from (seed, mask, head, element) wherever they are needed so
// none is stored between forward and backward.
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
// gat_attention_bwd, stage A: block (target row i, head j, fold f).
//   g_o = g_y (y > 0)                                (relu, bias)
//   g_ad[src] = <g_o[i, j block], h[src, j block]>
//   g_alpha = g_ad keep / (1 - p)
//   g_logit = alpha (g_alpha - sum_src alpha g_alpha)  (softmax; 0 if masked)
//   gz[i, src] = g_logit (z >= 0 ? 1 : 0.2)             (leaky)
//   gt[i] = sum_src gz[i, src]
// Dynamic shared memory: n + d floats.
// ---------------------------------------------------------------------------
__global__ void gat_attention_bwd_rows_kernel(
    const float* __restrict__ g_y, const float* __restrict__ y,
    const float* __restrict__ alpha, const float* __restrict__ h,
    const float* __restrict__ att_src, long long s_src,
    const float* __restrict__ att_dst, long long s_dst,
    const int* __restrict__ seeds, float* __restrict__ gz,
    float* __restrict__ gt, int n, int heads, int d, int mask_id,
    float drop_p, float scale) {
  extern __shared__ float sh[];
  __shared__ float red[32];
  float* go = sh + n;
  const int i = blockIdx.x, j = blockIdx.y, f = blockIdx.z;
  const int HD = heads * d;
  const float* hf = h + (long long)f * n * HD;
  const float* asrc = att_src + f * s_src + j * d;
  const float* adst = att_dst + f * s_dst + j * d;
  const long long yrow = ((long long)f * n + i) * HD + j * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    go[c] = y[yrow + c] > 0.f ? g_y[yrow + c] : 0.f;
  __syncthreads();
  const float t = head_dot(hf + (long long)i * HD + j * d, adst, d);
  const long long arow = (((long long)f * heads + j) * n + i) * n;
  const int* seed2 = seeds ? seeds + 2 * f : nullptr;
  float part = 0.f;
  for (int src = threadIdx.x; src < n; src += blockDim.x) {
    float g_al = head_dot(hf + (long long)src * HD + j * d, go, d);
    if (drop_p > 0.f)
      g_al = g_al * keep_at(seed2, mask_id, j, (unsigned)(i * n + src), drop_p)
             * scale;
    sh[src] = g_al;
    part += alpha[arow + src] * g_al;
  }
  const float dot = block_all<false>(part, red);
  float tsum = 0.f;
  for (int src = threadIdx.x; src < n; src += blockDim.x) {
    const float g_logit = alpha[arow + src] * (sh[src] - dot);
    const float z = head_dot(hf + (long long)src * HD + j * d, asrc, d) + t;
    const float g = z >= 0.f ? g_logit : 0.2f * g_logit;
    gz[arow + src] = g;
    tsum += g;
  }
  tsum = block_all<false>(tsum, red);
  if (threadIdx.x == 0) gt[((long long)f * heads + j) * n + i] = tsum;
}

// stage B: block (source node src, head j, fold f).
//   gs[src] = sum_i gz[i, src]
//   g_h[src, j block] = sum_i alpha[i, src] keep / (1 - p) g_o[i, j block]
//                       + gs[src] att_src[j] + gt[src] att_dst[j]
// Dynamic shared memory: n floats.
__global__ void gat_attention_bwd_cols_kernel(
    const float* __restrict__ g_y, const float* __restrict__ y,
    const float* __restrict__ alpha, const float* __restrict__ att_src,
    long long s_src, const float* __restrict__ att_dst, long long s_dst,
    const int* __restrict__ seeds, const float* __restrict__ gz,
    const float* __restrict__ gt, float* __restrict__ gs,
    float* __restrict__ g_h, int n, int heads, int d, int mask_id,
    float drop_p, float scale) {
  extern __shared__ float sh[];
  __shared__ float red[32];
  const int src = blockIdx.x, j = blockIdx.y, f = blockIdx.z;
  const int HD = heads * d;
  const long long base = ((long long)f * heads + j) * n;
  const int* seed2 = seeds ? seeds + 2 * f : nullptr;
  float part = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    part += gz[(base + i) * n + src];
    float ad = alpha[(base + i) * n + src];
    if (drop_p > 0.f)
      ad = ad * keep_at(seed2, mask_id, j, (unsigned)(i * n + src), drop_p)
           * scale;
    sh[i] = ad;
  }
  const float gsv = block_all<false>(part, red);   // syncs: sh is visible
  if (threadIdx.x == 0) gs[base + src] = gsv;
  const float gtv = gt[base + src];
  const float* asrc = att_src + f * s_src + j * d;
  const float* adst = att_dst + f * s_dst + j * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) {
      const long long e = ((long long)f * n + i) * HD + j * d + c;
      acc += sh[i] * (y[e] > 0.f ? g_y[e] : 0.f);
    }
    g_h[((long long)f * n + src) * HD + j * d + c] =
        acc + gsv * asrc[c] + gtv * adst[c];
  }
}

// stage C: block (head j, fold f), thread per feature c.
//   g_att_src[j, c] = sum_i gs[i] h[i, j block c]
//   g_att_dst[j, c] = sum_i gt[i] h[i, j block c]
//   g_bias[j block c] = sum_i g_o[i, j block c]
__global__ void gat_attention_bwd_params_kernel(
    const float* __restrict__ g_y, const float* __restrict__ y,
    const float* __restrict__ h, const float* __restrict__ gs,
    const float* __restrict__ gt, float* __restrict__ g_src, long long sg_src,
    float* __restrict__ g_dst, long long sg_dst, float* __restrict__ g_bias,
    long long sg_bias, int n, int heads, int d) {
  const int j = blockIdx.x, f = blockIdx.y;
  const int HD = heads * d;
  const long long base = ((long long)f * heads + j) * n;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float a_s = 0.f, a_d = 0.f, a_b = 0.f;
    for (int i = 0; i < n; ++i) {
      const long long e = ((long long)f * n + i) * HD + j * d + c;
      const float hv = h[e];
      a_s += gs[base + i] * hv;
      a_d += gt[base + i] * hv;
      a_b += y[e] > 0.f ? g_y[e] : 0.f;
    }
    g_src[f * sg_src + j * d + c] = a_s;
    g_dst[f * sg_dst + j * d + c] = a_d;
    g_bias[f * sg_bias + j * d + c] = a_b;
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
// One block per fold, sums in a fixed order.
// ---------------------------------------------------------------------------
__global__ void offdiag_loss_kernel(const float* __restrict__ G,
                                    const float* __restrict__ T,
                                    float* __restrict__ vals, int n_vals,
                                    int slot, float* __restrict__ gsym, int n,
                                    int absolute) {
  const int f = blockIdx.x;
  const long long nn = (long long)n * n;
  const float* g = G + f * nn;
  const float* t = T + f * nn;
  const float inv = 1.f / (float)nn, c = 2.f / (float)nn;
  float acc = 0.f;
  for (long long e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = (int)(e / n), j = (int)(e % n);
    if (i == j) {
      if (gsym) gsym[f * nn + e] = 0.f;
      continue;
    }
    const float gij = g[e];
    const float dij = fmaxf(gij, 0.f) - t[e];
    acc += absolute ? fabsf(dij) : dij * dij;
    if (gsym) {
      const long long et = (long long)j * n + i;
      const float gji = g[et];
      const float dji = fmaxf(gji, 0.f) - t[et];
      gsym[f * nn + e] =
          c * ((gij > 0.f ? dij : 0.f) + (gji > 0.f ? dji : 0.f));
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) vals[(long long)f * n_vals + slot] = acc * inv;
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

extern "C" int fcsr_gat_attention_bwd(
    const float* g_y, const float* y, const float* alpha, const float* h,
    const float* att_src, long long s_src, const float* att_dst,
    long long s_dst, const int* seeds, float* gz, float* gs, float* gt,
    float* g_h, float* g_src, long long sg_src, float* g_dst,
    long long sg_dst, float* g_bias, long long sg_bias, int batch, int n,
    int heads, int d, int mask_id, float drop_p, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n, heads, batch);
  gat_attention_bwd_rows_kernel<<<grid, block_for(n),
                                  (n + d) * sizeof(float), st>>>(
      g_y, y, alpha, h, att_src, s_src, att_dst, s_dst, seeds, gz, gt, n,
      heads, d, mask_id, drop_p, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  gat_attention_bwd_cols_kernel<<<grid, block_for(n), n * sizeof(float),
                                  st>>>(
      g_y, y, alpha, att_src, s_src, att_dst, s_dst, seeds, gz, gt, gs, g_h,
      n, heads, d, mask_id, drop_p, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid_p(heads, batch);
  gat_attention_bwd_params_kernel<<<grid_p, block_for(d), 0, st>>>(
      g_y, y, h, gs, gt, g_src, sg_src, g_dst, sg_dst, g_bias, sg_bias, n,
      heads, d);
  return (int)cudaGetLastError();
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

extern "C" int fcsr_offdiag_mse(const float* G, const float* T, float* vals,
                                int n_vals, int slot, float* gsym, int batch,
                                int n, void* stream) {
  offdiag_loss_kernel<<<batch, 1024, 0, (cudaStream_t)stream>>>(
      G, T, vals, n_vals, slot, gsym, n, 0);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_offdiag_mae(const float* G, const float* T, float* vals,
                                int n_vals, int slot, int batch, int n,
                                void* stream) {
  offdiag_loss_kernel<<<batch, 1024, 0, (cudaStream_t)stream>>>(
      G, T, vals, n_vals, slot, nullptr, n, 1);
  return (int)cudaGetLastError();
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
