// rank_select: the Graph U-Net's top-k pooling as index selection and the
// pooling gather in one launch, plus the row gather / scatter helpers of
// unpooling and the adjoints.
//
// Replaces the rank-select pooling inside the TPU training-step kernel
// (fcsr_tpu/models/fused_step.py::_topk_projection and its one-hot
// matmuls P @ X, P^T @ X in _unet_fwd_math / _unet_bwd_math). Mosaic had no
// gather, so the TPU kernel multiplied by a (k, n) one-hot matrix; here the
// rank yields indices directly and pooling is a gather, unpooling a
// scatter — exact, no products.
//
// The score is sigmoid(logits * r), r = 1 / div rounded to fp32: div = 100
// in GSR-Net's pool, 1 in the GAT U-Net's. XLA computes the JAX package's
// logits / div so (a division by a constant becomes a product with its
// fp32 reciprocal), and the port's plain version and modules follow it.
// Rank: rank_i = #{j : s_j > s_i} + #{j < i : s_j == s_i} (descending, ties
// to the lower index, as lax.top_k), n <= 1024.
//
// The pool (rank_select_kernel) is one launch of a grid (bands, F): every
// block ranks all n scores of its fold itself (O(n^2) compares, ~26k at
// n = 160: no block waits on another, no scratch, no second launch), then
// writes its band of idx / vals (block 0 also s and slot) and, given the
// source rows, gathers its band: pre = src[idx], x = pre * vals. The
// function moves a few hundred KB: bound by bytes, and by launch latency
// at these sizes, so the design spends its time on the latency chain —
// the rank's compares as integer keys with 16-byte shared loads, two
// instructions each into four independent counts, split over `lanes`
// lanes per node so one pass covers every node, the rows copied by a
// warp each with 16-byte accesses. The wrapper plans the
// launch (ops.rank_select_plan); the C entry refuses a plan the pointers
// or the card do not allow.
//
// Each kernel here also has an RND instance, the `*_bf16` entry points,
// for FCSR_MM_MODE=bf16: there the JAX package gathers, scatters and adds
// some biases as one-hot products through core/mosaic_mm.py::mm_bf16,
// which round the data operand to bf16 (fused_step.py:361-470). The RND
// instances round what such a product rounds (the gathered or scattered
// rows, the kept scores, the adjoint's products before their row sum) and
// nothing else; the fp32 instances are unchanged. The pair's AD instance
// (`fcsr_pool_bwd_pair_bf16_ad`) rounds as the JAX package's autodiff of
// its bf16 forward does (fused_step.py:384-387, differentiated by jax.vjp
// in its unet_fused and step_value_and_grad_fused kernels): x = pre * ks
// is an elementwise product there, so the logits' dot sums the unrounded
// products g * pre, is rounded as the operand of mm(P^T, .), then scaled
// by the forward's s (1 - s) and 1 / div.
#include "common.cuh"

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int SEL_MAX_N = 1024;       // the most scores a fold may have
constexpr int SEL_MAX_SMEM = 48 * 1024;  // no opt-in: at most 16 KB used

// Rows [r0, r1) of a band: out[r] = src[ix[r]] and, with outs,
// outs[r] = out[r] * sc[r] (sc null: 1). A warp per row, coalesced along
// it, 16-byte accesses when VEC (cols % 4 == 0, src / out / outs 16-byte
// aligned). A lane loads up to GATHER_BATCH of its vectors before storing
// any, so a row of 268 floats costs one round trip to memory, not three.
// ix and sc may lie in shared or global memory. The pool and the
// backward's gather both copy their rows here.
constexpr int GATHER_BATCH = 4;

template <bool RND>
__device__ __forceinline__ float vrnd(float a) {
  return rnd_if<RND>(a);
}
template <bool RND>
__device__ __forceinline__ float4 vrnd(float4 a) {
  return make_float4(rnd_if<RND>(a.x), rnd_if<RND>(a.y), rnd_if<RND>(a.z),
                     rnd_if<RND>(a.w));
}

// RND: the rows are rounded to bf16 as they are read (and sc, where given,
// is already).
template <bool VEC, bool RND>
__device__ __forceinline__ void gather_band(const float* __restrict__ src,
                                            const int* ix, const float* sc,
                                            float* __restrict__ out,
                                            float* __restrict__ outs, int r0,
                                            int r1, int cols) {
  using V = typename std::conditional<VEC, float4, float>::type;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int nv = VEC ? cols >> 2 : cols;  // vectors per row
  for (int r = r0 + (int)(threadIdx.x >> 5); r < r1; r += nw) {
    const V* s = reinterpret_cast<const V*>(src + (size_t)ix[r] * cols);
    V* o = reinterpret_cast<V*>(out + (size_t)r * cols);
    V* os = outs ? reinterpret_cast<V*>(outs + (size_t)r * cols) : nullptr;
    const float c = sc ? sc[r] : 1.f;
    for (int g0 = lane; g0 < nv; g0 += 32 * GATHER_BATCH) {
      V v[GATHER_BATCH];
#pragma unroll
      for (int u = 0; u < GATHER_BATCH; ++u)
        if (g0 + 32 * u < nv) v[u] = vrnd<RND>(__ldg(s + g0 + 32 * u));
#pragma unroll
      for (int u = 0; u < GATHER_BATCH; ++u) {
        const int g = g0 + 32 * u;
        if (g >= nv) break;
        o[g] = v[u];
        if (os) {
          if constexpr (VEC)
            os[g] = make_float4(v[u].x * c, v[u].y * c, v[u].z * c,
                                v[u].w * c);
          else
            os[g] = v[u] * c;
        }
      }
    }
  }
}

// Whether key b sorts above key a, as 0 / 1: (a - b - t) < 0 with t = 1
// for kj >= ki (j below i) and t = 0 for kj > ki (j above i). Keys are
// small (see rank_select_kernel), so the difference cannot overflow.
__device__ __forceinline__ int above(int a, int b, int t) {
  return (int)((unsigned)(a - b - t) >> 31);
}

// Grid (bands, F), blockDim.x threads (a multiple of 32). Shared memory:
// key and s over npad = n rounded up to 4, then the kept nodes and their
// scores by rank. The key is s's bits as an int (s >= +0, so the ints
// order as the floats do), -1 for NaN (below every score); pads past n
// are -1 too: a pad never outranks a real score and never wins a tie,
// as ties go to the lower index. Block 0 writes s and slot (n values);
// block b writes idx and vals for rows [b R, b R + R) and gathers those
// rows. `lanes` is a power of two: shifts, no division on the way. RND:
// vals, the scale of x and the gathered rows pre are rounded to bf16
// (x = pre * vals is then exact), s stays fp32.
template <bool VEC, bool RND>
__global__ void __launch_bounds__(1024)
    rank_select_kernel(const float* __restrict__ logits,
                       const float* __restrict__ src,
                       float* __restrict__ s_out, int* __restrict__ idx,
                       float* __restrict__ vals, int* __restrict__ slot,
                       float* __restrict__ pre, float* __restrict__ x, int n,
                       int k, int cols, float rdiv, int R, int lanes) {
  extern __shared__ int4 sel_sh[];
  const int npad = (n + 3) & ~3;
  int* key = reinterpret_cast<int*>(sel_sh);
  float* sv = reinterpret_cast<float*>(key + npad);
  int* ix = reinterpret_cast<int*>(sv + npad);
  float* kv = reinterpret_cast<float*>(ix + k);
  const int b = blockIdx.x, f = blockIdx.y;
  const int tid = threadIdx.x, T = blockDim.x;
  const int shift = __ffs(lanes) - 1;
  const float* lf = logits + (size_t)f * n;

  for (int i = tid; i < npad; i += T) {
    float si = 0.f;
    int ki = -1;
    if (i < n) {
      si = 1.f / (1.f + expf(-(lf[i] * rdiv)));
      // NaN scores sort last, so the ranks stay a permutation and every
      // selected index is in range
      ki = isnan(si) ? -1 : __float_as_int(si);
      if (b == 0) s_out[(size_t)f * n + i] = si;
    }
    key[i] = ki;
    sv[i] = si;
  }
  __syncthreads();

  // rank_i = #{j < i : k_j >= k_i} + #{j > i : k_j > k_i}. Node
  // base + tid / lanes: its lane `part` takes every lanes-th group of 4
  // keys (16-byte loads): the groups below i's with >=, i's own with the
  // exact rule, those above with >; four independent counts (no select
  // chain), then the lanes summed by shuffles (integers: any order). The
  // pass loop's trip count is the same on every thread, so whole warps
  // reach each shuffle.
  const int4* key4 = reinterpret_cast<const int4*>(key);
  const int groups = npad >> 2, part = tid & (lanes - 1);
  for (int base = 0; base < n; base += T >> shift) {
    const int i = base + (tid >> shift);
    int c = 0;
    if (i < n) {
      const int ki = key[i], gi = i >> 2;
      int c0 = 0, c1 = 0, c2 = 0, c3 = 0, g = part;
#pragma unroll 4
      for (; g < gi; g += lanes) {
        const int4 kj = key4[g];
        c0 += above(ki, kj.x, 1);
        c1 += above(ki, kj.y, 1);
        c2 += above(ki, kj.z, 1);
        c3 += above(ki, kj.w, 1);
      }
      if (g == gi) {
        const int4 kj = key4[g];
        const int j = 4 * g;
        c0 += above(ki, kj.x, j < i);
        c1 += above(ki, kj.y, j + 1 < i);
        c2 += above(ki, kj.z, j + 2 < i);
        c3 += above(ki, kj.w, j + 3 < i);
        g += lanes;
      }
#pragma unroll 4
      for (; g < groups; g += lanes) {
        const int4 kj = key4[g];
        c0 += above(ki, kj.x, 0);
        c1 += above(ki, kj.y, 0);
        c2 += above(ki, kj.z, 0);
        c3 += above(ki, kj.w, 0);
      }
      c = (c0 + c1) + (c2 + c3);
    }
    for (int o = lanes >> 1; o > 0; o >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, o);
    if (part == 0 && i < n) {
      if (c < k) {
        ix[c] = i;
        kv[c] = rnd_if<RND>(sv[i]);
      }
      if (b == 0) slot[(size_t)f * n + i] = c < k ? c : -1;
    }
  }
  __syncthreads();

  const int r0 = b * R, r1 = min(k, r0 + R);
  for (int r = r0 + tid; r < r1; r += T) {
    idx[(size_t)f * k + r] = ix[r];
    vals[(size_t)f * k + r] = kv[r];
  }
  if (src)
    gather_band<VEC, RND>(src + (size_t)f * n * cols, ix, kv,
                     pre + (size_t)f * k * cols, x + (size_t)f * k * cols,
                     r0, r1, cols);
}

// The backward's gather: out[f, r, :] = src[f, idx[f, r], :] and, with
// scale, out_scaled = out * scale[f, r]. Grid (bands, F): block b copies
// rows [b R, b R + R) through gather_band, idx and scale read from device
// memory.
template <bool VEC, bool RND>
__global__ void gather_rows_kernel(const float* __restrict__ src,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out,
                                   float* __restrict__ out_scaled,
                                   int n_src, int k, int cols, int R) {
  const int f = blockIdx.y, r0 = blockIdx.x * R, r1 = min(k, r0 + R);
  const size_t fo = (size_t)f * k * cols;
  gather_band<VEC, RND>(src + (size_t)f * n_src * cols, idx + (size_t)f * k,
                   scale ? scale + (size_t)f * k : nullptr, out + fo,
                   out_scaled ? out_scaled + fo : nullptr, r0, r1, cols);
}

// The unpool and the pool's adjoints: row p of fold f of an (F, n, cols)
// output reads row slot[f, p] of an (F, k, cols) input (a dropped node,
// slot -1, reads none). The work is a few hundred KB per call: bound by
// launch latency and the chain of dependent loads, so the design spends
// nothing on tiles and shared memory and everything on that chain. Grid
// (bands, F) as the pool's (ops.scatter_rows_plan): block b takes rows
// [b R, b R + R), a group of `lanes` lanes per row, a lane per 16-byte
// vector (VEC) up to 4 warps: rows of 32-128 floats do not idle most of
// a warp, and on the card a lane loading several vectors of its row cost
// more than the lanes it saved. The node's slot, score and its own row
// of the addend are loaded together; the kept row, its scale and its row
// of pre in the second round trip, up to ROW_BATCH vectors a lane before
// any is used. Products and sums are __fmul_rn / __fadd_rn (no FMA
// contraction), so the rows equal the plain version's bit for bit; the
// adjoint's dot is one fixed-order sum (row_dot, then group_sum), so the
// standalone and the fused launch give it the same bits.
constexpr int ROW_BATCH = 4;
constexpr int ROW_MAX_THREADS = 256;  // ops.ROW_MAX_THREADS (registers)
constexpr int ROW_MAX_LANES = 128;    // ops.ROW_MAX_LANES: a row's group

__device__ __forceinline__ float vmul(float a, float c) {
  return __fmul_rn(a, c);
}
__device__ __forceinline__ float4 vmul(float4 a, float c) {
  return make_float4(__fmul_rn(a.x, c), __fmul_rn(a.y, c), __fmul_rn(a.z, c),
                     __fmul_rn(a.w, c));
}
__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
// acc + <a, b> over the vector's entries in order, one rounding each
__device__ __forceinline__ float row_dot(float a, float b, float acc) {
  return __fmaf_rn(a, b, acc);
}
__device__ __forceinline__ float row_dot(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}
// RND: acc + sum of bf16(a b) over the entries in order (the JAX bf16
// mode rounds g * pre before its row sum, a product with a column of ones)
template <bool RND>
__device__ __forceinline__ float row_dot_as(float a, float b, float acc) {
  if constexpr (RND) return __fadd_rn(acc, bf16_round(__fmul_rn(a, b)));
  else return row_dot(a, b, acc);
}
// AD: acc + sum of the fp32 products a b in order, each rounded to fp32
// (the JAX bf16 mode's autodiff: an elementwise product, then a row sum)
__device__ __forceinline__ float row_dot_ad(float a, float b, float acc) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ float row_dot_ad(float4 a, float4 b, float acc) {
  acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
  acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
  acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
  return __fadd_rn(acc, __fmul_rn(a.w, b.w));
}
template <bool RND>
__device__ __forceinline__ float row_dot_as(float4 a, float4 b, float acc) {
  if constexpr (RND) {
    acc = __fadd_rn(acc, bf16_round(__fmul_rn(a.x, b.x)));
    acc = __fadd_rn(acc, bf16_round(__fmul_rn(a.y, b.y)));
    acc = __fadd_rn(acc, bf16_round(__fmul_rn(a.z, b.z)));
    return __fadd_rn(acc, bf16_round(__fmul_rn(a.w, b.w)));
  } else {
    return row_dot(a, b, acc);
  }
}
template <class V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Sum over the `lanes` lanes of a row's group, in one fixed order on
// every launch: an xor tree inside each warp, then for a group of 64 or
// 128 lanes its warps' sums in warp order through `part` (a float per
// warp of the block). Valid in the group's first lane. Every thread of
// the block calls it (full-mask shuffles; block barriers for wide
// groups, `lanes` being the same on every thread).
__device__ __forceinline__ float group_sum(float v, int lanes,
                                           float* part) {
  for (int o = (lanes < 32 ? lanes : 32) >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lanes <= 32) return v;
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[w] = v;
  __syncthreads();
  if ((threadIdx.x & (lanes - 1)) == 0)
    for (int j = 1; j < lanes >> 5; ++j) v += part[w + j];
  __syncthreads();
  return v;
}

// Rows [r0, r1) of one fold. SCATTER writes out[p] = (slot >= 0 ?
// src[slot] (* scale[slot] given scale) : 0) (+ add[p] given add), where
// scale and add can be given only with EXTRA; DOT writes g_logits[p] =
// <src[slot], pre[slot]> s (1 - s) gscale (0 times that for a dropped
// node, as the plain version computes it). A lane loads BATCH vectors
// of a row before it uses any (the wrapper's plan gives a row a lane per
// vector up to 128 lanes, so BATCH = 1 up to rows of 512 floats): every
// instruction on the path from the slot to the stores counts at these
// sizes, so each form is compiled with only the code it runs. The loop
// over rows has the same trip count on every thread (group_sum). RND:
// the scattered row (scaled, before its addend) and each product of the
// dot are rounded to bf16, and the dot before it is scaled. AD (with
// RND): the dot sums the unrounded products (row_dot_ad), is rounded, and
// is scaled as dot (s (1 - s)) gscale.
template <bool VEC, int BATCH, bool SCATTER, bool EXTRA, bool DOT, bool RND,
          bool AD = false>
__device__ __forceinline__ void rows_band(
    const float* __restrict__ src, const float* __restrict__ pre,
    const int* __restrict__ slot, const float* __restrict__ scale,
    const float* __restrict__ add, const float* __restrict__ s,
    float* __restrict__ out, float* __restrict__ g_logits, int cols,
    float gscale, int r0, int r1, int lanes) {
  using V = typename std::conditional<VEC, float4, float>::type;
  const int shift = __ffs(lanes) - 1;
  const int l = threadIdx.x & (lanes - 1);
  const int groups = blockDim.x >> shift;
  const int nv = VEC ? cols >> 2 : cols;  // vectors per row
  __shared__ float part[DOT ? ROW_MAX_THREADS / 32 : 1];
  for (int base = r0; base < r1; base += groups) {
    const int p = base + (int)(threadIdx.x >> shift);
    const bool live = p < r1;
    // first round trip: the slot, the score and the node's own addend
    int r = -1;
    float sp = 0.f;
    if (live) {
      r = __ldg(slot + p);
      if constexpr (DOT) sp = __ldg(s + p);
    }
    const V* A = nullptr;
    V a[BATCH];
    if constexpr (EXTRA) {
      if (add && live) {
        A = reinterpret_cast<const V*>(add + (size_t)p * cols);
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          if (l + u * lanes < nv) a[u] = __ldg(A + l + u * lanes);
      }
    }
    // second: the kept row (and pre, and its scale)
    const bool kept = r >= 0;
    const V* S = reinterpret_cast<const V*>(src + (size_t)(kept ? r : 0) *
                                                      cols);
    const V* P = reinterpret_cast<const V*>(pre + (size_t)(kept ? r : 0) *
                                                      cols);
    float sc = 1.f;
    if constexpr (EXTRA)
      if (scale && kept) sc = __ldg(scale + r);
    V* O = reinterpret_cast<V*>(out + (size_t)p * cols);
    float acc = 0.f;
    for (int g0 = l; g0 < nv; g0 += lanes * BATCH) {
      V v[BATCH], w[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int g = g0 + u * lanes;
        if (g < nv) {
          if constexpr (EXTRA)  // the first batch's addend: above
            if (A && g0 != l) a[u] = __ldg(A + g);
          v[u] = kept ? __ldg(S + g) : vzero<V>();
          if constexpr (DOT) w[u] = kept ? __ldg(P + g) : vzero<V>();
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int g = g0 + u * lanes;
        if (g >= nv) break;
        if constexpr (DOT)
          if (kept)
            acc = AD ? row_dot_ad(v[u], w[u], acc)
                     : row_dot_as<RND>(v[u], w[u], acc);
        if constexpr (SCATTER) {
          if (live) {
            V o = v[u];
            if constexpr (EXTRA)
              if (scale && kept) o = vmul(o, sc);
            o = vrnd<RND>(o);
            if constexpr (EXTRA)
              if (A) o = vadd(o, a[u]);
            O[g] = o;
          }
        }
      }
    }
    if constexpr (DOT) {
      acc = group_sum(acc, lanes, part);
      if (live && l == 0) {
        if constexpr (AD)
          g_logits[p] = __fmul_rn(
              __fmul_rn(rnd_if<RND>(acc), __fmul_rn(sp, __fsub_rn(1.f, sp))),
              gscale);
        else
          g_logits[p] = __fmul_rn(__fmul_rn(__fmul_rn(rnd_if<RND>(acc), sp),
                                            __fsub_rn(1.f, sp)),
                                  gscale);
      }
    }
  }
}

// Unpooling as a scatter: out[f, p, :] = (slot >= 0 ? src[f, slot, :]
// (* scale[f, slot]) : 0) (+ add[f, p, :]); scale and add may be null,
// and are with EXTRA = false (the forward's unpool).
template <bool VEC, int BATCH, bool EXTRA, bool RND>
__global__ void __launch_bounds__(ROW_MAX_THREADS)
    scatter_rows_kernel(const float* __restrict__ src,
                        const int* __restrict__ slot,
                        const float* __restrict__ scale,
                        const float* __restrict__ add,
                        float* __restrict__ out, int n, int k, int cols,
                        int R, int lanes) {
  const int f = blockIdx.y, r0 = blockIdx.x * R, r1 = min(n, r0 + R);
  const size_t fo = (size_t)f * n * cols;
  rows_band<VEC, BATCH, true, EXTRA, false, RND>(
      src + (size_t)f * k * cols, nullptr, slot + (size_t)f * n,
      scale ? scale + (size_t)f * k : nullptr, add ? add + fo : nullptr,
      nullptr, out + fo, nullptr, cols, 1.f, r0, r1, lanes);
}

// Adjoint of the pooled rows pre * s[idx] w.r.t. the pre-sigmoid logits:
// out[f, p] = <g[f, slot], pre[f, slot]> s (1 - s) scale (a dropped node's
// dot is 0); scale = 1 / div of the forward's score sigmoid(logits / div).
template <bool VEC, int BATCH>
__global__ void __launch_bounds__(ROW_MAX_THREADS)
    pool_logits_bwd_kernel(const float* __restrict__ g,
                           const float* __restrict__ pre,
                           const int* __restrict__ slot,
                           const float* __restrict__ s,
                           float* __restrict__ out, int n, int k, int cols,
                           float scale, int R, int lanes) {
  const int f = blockIdx.y, r0 = blockIdx.x * R, r1 = min(n, r0 + R);
  const size_t fk = (size_t)f * k * cols;
  rows_band<VEC, BATCH, false, false, true, false>(
      g + fk, pre + fk, slot + (size_t)f * n, nullptr, nullptr,
      s + (size_t)f * n, nullptr, out + (size_t)f * n, cols, scale, r0, r1,
      lanes);
}

// The GSR backward's pair in one pass over g: g_d[f, p, :] = g[f, slot]
// * vals[f, slot] + add[f, p, :] (scatter_rows with scale and addend) and
// g_logits[f, p] (pool_logits_bwd), each kept row of g read once.
template <bool VEC, int BATCH, bool RND, bool AD>
__global__ void __launch_bounds__(ROW_MAX_THREADS)
    pool_bwd_pair_kernel(const float* __restrict__ g,
                         const float* __restrict__ pre,
                         const int* __restrict__ slot,
                         const float* __restrict__ s,
                         const float* __restrict__ vals,
                         const float* __restrict__ add,
                         float* __restrict__ g_d,
                         float* __restrict__ g_logits, int n, int k,
                         int cols, float scale, int R, int lanes) {
  const int f = blockIdx.y, r0 = blockIdx.x * R, r1 = min(n, r0 + R);
  const size_t fk = (size_t)f * k * cols, fn = (size_t)f * n * cols;
  rows_band<VEC, BATCH, true, true, true, RND, AD>(
      g + fk, pre + fk, slot + (size_t)f * n, vals + (size_t)f * k,
      add + fn, s + (size_t)f * n, g_d + fn, g_logits + (size_t)f * n, cols,
      scale, r0, r1, lanes);
}

// Calls fn(VEC, BATCH) with the two as std::integral_constant values
// (decltype(...)::value in the caller) for the instance of a row kernel
// that takes (vec, batch); batch clamped to 1..ROW_BATCH.
template <class Fn>
void row_dispatch(bool vec, int batch, Fn&& fn) {
  using B1 = std::integral_constant<int, 1>;
  using B2 = std::integral_constant<int, 2>;
  using B3 = std::integral_constant<int, 3>;
  using B4 = std::integral_constant<int, 4>;
  using T = std::true_type;
  using F = std::false_type;
  batch = batch < 1 ? 1 : (batch > ROW_BATCH ? ROW_BATCH : batch);
  if (vec) {
    if (batch == 1) fn(T(), B1());
    else if (batch == 2) fn(T(), B2());
    else if (batch == 3) fn(T(), B3());
    else fn(T(), B4());
  } else {
    if (batch == 1) fn(F(), B1());
    else if (batch == 2) fn(F(), B2());
    else if (batch == 3) fn(F(), B3());
    else fn(F(), B4());
  }
}

// out[f, i, j] = x[f, i, j] + bias[f, j]; x and bias rows contiguous, any
// batch stride (views into the flat parameter buffer). Once per GSR step
// (I W + b at 3 x 160 x 268): 0.5 MB, far below a launch, so the aim is
// the launch floor. Block (b, f) takes ADD_ROWS rows of fold f; thread
// (x, y) a group of 4 columns, its bias read once into registers, and
// every blockDim.y-th row of the block's: one 16-byte load and store per
// row where x, bias, out and their strides allow (VEC), else four 4-byte
// ones. 32-bit offsets inside a fold. RND: x is rounded to bf16 before
// the fp32 add (the JAX bf16 mode's start_gcn, eye @ W + b).
constexpr int ADD_ROWS = 4;

template <bool VEC, bool RND>
__global__ void add_bias_kernel(const float* __restrict__ x, long long sx,
                                const float* __restrict__ bias, long long sb,
                                float* __restrict__ out, int rows, int cols) {
  const int f = blockIdx.y, groups = (cols + 3) / 4;
  const int r0 = blockIdx.x * ADD_ROWS, r1 = min(r0 + ADD_ROWS, rows);
  const float* X = x + f * sx;
  const float* Bf = bias + f * sb;
  float* O = out + (size_t)f * rows * cols;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c = 4 * g;
    if constexpr (VEC) {
      const float4 b = *reinterpret_cast<const float4*>(Bf + c);
      for (int i = r0 + threadIdx.y; i < r1; i += blockDim.y) {
        const float4 v =
            vrnd<RND>(*reinterpret_cast<const float4*>(X + i * cols + c));
        *reinterpret_cast<float4*>(O + i * cols + c) =
            make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
      }
    } else {
      const int n = min(4, cols - c);
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = j < n ? Bf[c + j] : 0.f;
      for (int i = r0 + threadIdx.y; i < r1; i += blockDim.y) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n)
            O[i * cols + c + j] = rnd_if<RND>(X[i * cols + c + j]) + b[j];
      }
    }
  }
}

}  // namespace

// The pool's plan (bands, rows per band, threads, lanes per node, 16-byte
// rows) comes from the wrapper (ops.rank_select_plan); src = null ranks
// only. A plan the pointers or the card do not allow is refused.
template <bool RND>
static int rank_select_entry(const float* logits, const float* src, float* s,
                             int* idx, float* vals, int* slot, float* pre,
                             float* x, int batch, int n, int k, int cols,
                             float div, int bands, int rows, int threads,
                             int lanes, int vec, void* stream) {
  if (batch <= 0) return 0;
  if (k <= 0 || k > n || n > SEL_MAX_N || bands < 1 || rows < 1 ||
      (long long)bands * rows < k || threads < 32 || threads > 1024 ||
      threads % 32 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (src && (cols <= 0 || !pre || !x)) return (int)cudaErrorInvalidValue;
  if (vec && !(src && cols % 4 == 0 && aligned16(src) && aligned16(pre) &&
               aligned16(x)))
    return (int)cudaErrorInvalidValue;
  const int npad = (n + 3) & ~3;
  const size_t smem = sizeof(float) * (2 * (size_t)npad + 2 * (size_t)k);
  if (smem > (size_t)SEL_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const float rdiv = 1.f / div;
  const dim3 grid((unsigned)bands, (unsigned)batch);
  if (vec)
    rank_select_kernel<true, RND>
        <<<grid, threads, smem, (cudaStream_t)stream>>>(
        logits, src, s, idx, vals, slot, pre, x, n, k, cols, rdiv, rows,
        lanes);
  else
    rank_select_kernel<false, RND>
        <<<grid, threads, smem, (cudaStream_t)stream>>>(
        logits, src, s, idx, vals, slot, pre, x, n, k, cols, rdiv, rows,
        lanes);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_rank_select(const float* logits, const float* src,
                                float* s, int* idx, float* vals, int* slot,
                                float* pre, float* x, int batch, int n, int k,
                                int cols, float div, int bands, int rows,
                                int threads, int lanes, int vec,
                                void* stream) {
  return rank_select_entry<false>(logits, src, s, idx, vals, slot, pre, x,
                                  batch, n, k, cols, div, bands, rows, threads,
                                  lanes, vec, stream);
}

extern "C" int fcsr_rank_select_bf16(const float* logits, const float* src,
                                     float* s, int* idx, float* vals,
                                     int* slot, float* pre, float* x,
                                     int batch, int n, int k, int cols,
                                     float div, int bands, int rows,
                                     int threads, int lanes, int vec,
                                     void* stream) {
  return rank_select_entry<true>(logits, src, s, idx, vals, slot, pre, x,
                                 batch, n, k, cols, div, bands, rows, threads,
                                 lanes, vec, stream);
}

// The gather's plan (bands, rows per band, threads, 16-byte rows) comes
// from the wrapper (ops.gather_rows_plan); a plan the pointers do not
// allow is refused.
template <bool RND>
static int gather_rows_entry(const float* src, const int* idx,
                             const float* scale, float* out, float* out_scaled,
                             int batch, int n_src, int k, int cols, int bands,
                             int rows, int threads, int vec, void* stream) {
  if (batch <= 0 || k <= 0 || cols <= 0) return 0;
  if (bands < 1 || rows < 1 || (long long)bands * rows < k || threads < 32 ||
      threads > 1024 || threads % 32 || batch > 65535 ||
      (scale != nullptr) != (out_scaled != nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec && !(cols % 4 == 0 && aligned16(src) && aligned16(out) &&
               (!out_scaled || aligned16(out_scaled))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bands, (unsigned)batch);
  if (vec)
    gather_rows_kernel<true, RND><<<grid, threads, 0, (cudaStream_t)stream>>>(
        src, idx, scale, out, out_scaled, n_src, k, cols, rows);
  else
    gather_rows_kernel<false, RND><<<grid, threads, 0, (cudaStream_t)stream>>>(
        src, idx, scale, out, out_scaled, n_src, k, cols, rows);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_gather_rows(const float* src, const int* idx,
                                const float* scale, float* out,
                                float* out_scaled, int batch, int n_src, int k,
                                int cols, int bands, int rows, int threads,
                                int vec, void* stream) {
  return gather_rows_entry<false>(src, idx, scale, out, out_scaled, batch,
                                  n_src, k, cols, bands, rows, threads, vec,
                                  stream);
}

extern "C" int fcsr_gather_rows_bf16(const float* src, const int* idx,
                                     const float* scale, float* out,
                                     float* out_scaled, int batch, int n_src,
                                     int k, int cols, int bands, int rows,
                                     int threads, int vec, void* stream) {
  return gather_rows_entry<true>(src, idx, scale, out, out_scaled, batch,
                                 n_src, k, cols, bands, rows, threads, vec,
                                 stream);
}

// The row kernels' plan (bands, rows per band, threads, lanes per row,
// 16-byte rows) comes from the wrapper (ops.scatter_rows_plan): 0 if it
// is one the card can run for these rows, else the error to return.
static int row_plan_error(int batch, int n, int cols, int bands, int rows,
                          int threads, int lanes) {
  if (cols <= 0 || bands < 1 || rows < 1 || (long long)bands * rows < n ||
      threads < 32 || threads > ROW_MAX_THREADS || threads % 32 ||
      lanes < 1 || lanes > ROW_MAX_LANES || (lanes & (lanes - 1)) ||
      threads % lanes || batch > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The vectors a lane of a row's group loads at once: all of its share of
// the row, up to ROW_BATCH.
static int row_batch(int cols, int lanes, int vec) {
  const int nv = vec ? cols / 4 : cols;
  return (nv + lanes - 1) / lanes;
}

template <bool RND>
static int scatter_rows_entry(const float* src, const int* slot,
                              const float* scale, const float* add, float* out,
                              int batch, int n, int k, int cols, int bands,
                              int rows, int threads, int lanes, int vec,
                              void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (int err = row_plan_error(batch, n, cols, bands, rows, threads, lanes))
    return err;
  if (vec && !(cols % 4 == 0 && aligned16(src) && aligned16(out) &&
               (!add || aligned16(add))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bands, (unsigned)batch);
  const cudaStream_t st = (cudaStream_t)stream;
  row_dispatch(vec, row_batch(cols, lanes, vec), [&](auto V, auto B) {
    constexpr bool VEC = decltype(V)::value;
    constexpr int BATCH = decltype(B)::value;
    if (scale || add)
      scatter_rows_kernel<VEC, BATCH, true, RND><<<grid, threads, 0, st>>>(
          src, slot, scale, add, out, n, k, cols, rows, lanes);
    else
      scatter_rows_kernel<VEC, BATCH, false, RND><<<grid, threads, 0, st>>>(
          src, slot, scale, add, out, n, k, cols, rows, lanes);
  });
  return (int)cudaGetLastError();
}

extern "C" int fcsr_scatter_rows(const float* src, const int* slot,
                                 const float* scale, const float* add,
                                 float* out, int batch, int n, int k, int cols,
                                 int bands, int rows, int threads, int lanes,
                                 int vec, void* stream) {
  return scatter_rows_entry<false>(src, slot, scale, add, out, batch, n, k,
                                   cols, bands, rows, threads, lanes, vec,
                                   stream);
}

extern "C" int fcsr_scatter_rows_bf16(const float* src, const int* slot,
                                      const float* scale, const float* add,
                                      float* out, int batch, int n, int k,
                                      int cols, int bands, int rows,
                                      int threads, int lanes, int vec,
                                      void* stream) {
  return scatter_rows_entry<true>(src, slot, scale, add, out, batch, n, k,
                                  cols, bands, rows, threads, lanes, vec,
                                  stream);
}

extern "C" int fcsr_pool_logits_bwd(const float* g, const float* pre,
                                    const int* slot, const float* s,
                                    float* out, int batch, int n, int k,
                                    int cols, float scale, int bands,
                                    int rows, int threads, int lanes,
                                    int vec, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (int err = row_plan_error(batch, n, cols, bands, rows, threads, lanes))
    return err;
  if (vec && !(cols % 4 == 0 && aligned16(g) && aligned16(pre)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bands, (unsigned)batch);
  const cudaStream_t st = (cudaStream_t)stream;
  row_dispatch(vec, row_batch(cols, lanes, vec), [&](auto V, auto B) {
    pool_logits_bwd_kernel<decltype(V)::value, decltype(B)::value>
        <<<grid, threads, 0, st>>>(g, pre, slot, s, out, n, k, cols, scale,
                                   rows, lanes);
  });
  return (int)cudaGetLastError();
}

template <bool RND, bool AD = false>
static int pool_bwd_pair_entry(const float* g, const float* pre,
                               const int* slot, const float* s,
                               const float* vals, const float* add, float* g_d,
                               float* g_logits, int batch, int n, int k,
                               int cols, float scale, int bands, int rows,
                               int threads, int lanes, int vec, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (int err = row_plan_error(batch, n, cols, bands, rows, threads, lanes))
    return err;
  if (vec && !(cols % 4 == 0 && aligned16(g) && aligned16(pre) &&
               aligned16(add) && aligned16(g_d)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bands, (unsigned)batch);
  const cudaStream_t st = (cudaStream_t)stream;
  row_dispatch(vec, row_batch(cols, lanes, vec), [&](auto V, auto B) {
    pool_bwd_pair_kernel<decltype(V)::value, decltype(B)::value, RND, AD>
        <<<grid, threads, 0, st>>>(g, pre, slot, s, vals, add, g_d,
                                   g_logits, n, k, cols, scale, rows, lanes);
  });
  return (int)cudaGetLastError();
}

extern "C" int fcsr_pool_bwd_pair(const float* g, const float* pre,
                                  const int* slot, const float* s,
                                  const float* vals, const float* add,
                                  float* g_d, float* g_logits, int batch,
                                  int n, int k, int cols, float scale,
                                  int bands, int rows, int threads, int lanes,
                                  int vec, void* stream) {
  return pool_bwd_pair_entry<false>(g, pre, slot, s, vals, add, g_d, g_logits,
                                    batch, n, k, cols, scale, bands, rows,
                                    threads, lanes, vec, stream);
}

extern "C" int fcsr_pool_bwd_pair_bf16(const float* g, const float* pre,
                                       const int* slot, const float* s,
                                       const float* vals, const float* add,
                                       float* g_d, float* g_logits, int batch,
                                       int n, int k, int cols, float scale,
                                       int bands, int rows, int threads,
                                       int lanes, int vec, void* stream) {
  return pool_bwd_pair_entry<true>(g, pre, slot, s, vals, add, g_d, g_logits,
                                   batch, n, k, cols, scale, bands, rows,
                                   threads, lanes, vec, stream);
}

extern "C" int fcsr_pool_bwd_pair_bf16_ad(const float* g, const float* pre,
                                          const int* slot, const float* s,
                                          const float* vals, const float* add,
                                          float* g_d, float* g_logits,
                                          int batch, int n, int k, int cols,
                                          float scale, int bands, int rows,
                                          int threads, int lanes, int vec,
                                          void* stream) {
  return pool_bwd_pair_entry<true, true>(g, pre, slot, s, vals, add, g_d,
                                         g_logits, batch, n, k, cols, scale,
                                         bands, rows, threads, lanes, vec,
                                         stream);
}

template <bool RND>
static int add_bias_entry(const float* x, long long sx, const float* bias,
                          long long sb, float* out, int batch, int rows,
                          int cols, void* stream) {
  if ((long long)rows * cols > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = cols % 4 == 0 && aligned16(x) && aligned16(bias) &&
                   aligned16(out) &&
                   (batch == 1 || (sx % 4 == 0 && sb % 4 == 0));
  const int groups = (cols + 3) / 4;
  const int tx = groups < 256 ? (groups + 31) / 32 * 32 : 256;
  const int ty = 256 / tx < ADD_ROWS ? 256 / tx : ADD_ROWS;
  const dim3 block(tx, ty), grid((rows + ADD_ROWS - 1) / ADD_ROWS, batch);
  if (vec)
    add_bias_kernel<true, RND><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, sx, bias, sb, out, rows, cols);
  else
    add_bias_kernel<false, RND><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, sx, bias, sb, out, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_add_bias(const float* x, long long sx, const float* bias,
                             long long sb, float* out, int batch, int rows,
                             int cols, void* stream) {
  return add_bias_entry<false>(x, sx, bias, sb, out, batch, rows, cols,
                               stream);
}

extern "C" int fcsr_add_bias_bf16(const float* x, long long sx,
                                  const float* bias, long long sb, float* out,
                                  int batch, int rows, int cols,
                                  void* stream) {
  return add_bias_entry<true>(x, sx, bias, sb, out, batch, rows, cols, stream);
}
