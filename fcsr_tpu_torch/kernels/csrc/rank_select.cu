// rank_select: the Graph U-Net's top-k pooling as index selection, plus the
// row gather / scatter helpers of pooling, unpooling and their adjoints.
//
// Replaces the rank-select pooling inside the TPU training-step kernel
// (fcsr_tpu/models/fused_step.py::_topk_projection and its one-hot
// matmuls P @ X, P^T @ X in _unet_fwd_math / _unet_bwd_math). Mosaic had no
// gather, so the TPU kernel multiplied by a (k, n) one-hot matrix; here the
// rank yields indices directly and pooling is a gather, unpooling a
// scatter — exact, no products.
//
// The score is sigmoid(logits / div): div = 100 in GSR-Net's pool, 1 in the
// GAT U-Net's.
// Rank: rank_i = #{j : s_j > s_i} + #{j < i : s_j == s_i} (descending, ties
// to the lower index, as lax.top_k). One block per fold, n <= 1024 scores in
// shared memory, O(n^2) compares — ~25k at n = 160, far below any bound.
// The row kernels move a few hundred KB per call: bound by bytes, and by
// launch latency at these sizes.
#include "common.cuh"

#include <stdint.h>

namespace {

__global__ void rank_select_kernel(const float* __restrict__ logits,
                                   float* __restrict__ s_out,
                                   int* __restrict__ idx,
                                   float* __restrict__ vals,
                                   int* __restrict__ slot, int n, int k,
                                   float div) {
  extern __shared__ float key[];
  const int f = blockIdx.x, i = threadIdx.x;
  float si = 0.f;
  if (i < n) {
    si = 1.f / (1.f + expf(-(logits[(long long)f * n + i] / div)));
    s_out[(long long)f * n + i] = si;
    // NaN scores sort last, so the ranks stay a permutation and every
    // selected index is in range
    key[i] = isnan(si) ? -INFINITY : si;
  }
  __syncthreads();
  if (i >= n) return;
  const float ki = key[i];
  int rank = 0;
  for (int j = 0; j < n; ++j) {
    const float kj = key[j];
    rank += (kj > ki) || (kj == ki && j < i);
  }
  slot[(long long)f * n + i] = rank < k ? rank : -1;
  if (rank < k) {
    idx[(long long)f * k + rank] = i;
    vals[(long long)f * k + rank] = si;
  }
}

// out[f, r, :] = src[f, idx[f, r], :]; out_scaled = out * scale[f, r]
__global__ void gather_rows_kernel(const float* __restrict__ src,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out,
                                   float* __restrict__ out_scaled,
                                   int n_src, int k, int cols) {
  const int r = blockIdx.x, f = blockIdx.y;
  const long long orow = ((long long)f * k + r) * cols;
  const float* s = src + ((long long)f * n_src + idx[(long long)f * k + r]) * cols;
  const float sc = scale ? scale[(long long)f * k + r] : 1.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = s[c];
    out[orow + c] = v;
    if (out_scaled) out_scaled[orow + c] = v * sc;
  }
}

// out[f, p, :] = (slot >= 0 ? src[f, slot, :] * scale[f, slot] : 0) + add[f, p, :]
__global__ void scatter_rows_kernel(const float* __restrict__ src,
                                    const int* __restrict__ slot,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ add,
                                    float* __restrict__ out,
                                    int n, int k, int cols) {
  const int p = blockIdx.x, f = blockIdx.y;
  const int r = slot[(long long)f * n + p];
  const long long orow = ((long long)f * n + p) * cols;
  const float* s = src + ((long long)f * k + (r >= 0 ? r : 0)) * cols;
  const float sc = (scale && r >= 0) ? scale[(long long)f * k + r] : 1.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float v = 0.f;
    if (r >= 0) v = s[c] * sc;
    if (add) v += add[orow + c];
    out[orow + c] = v;
  }
}

// Adjoint of the pooling gate w.r.t. the pre-sigmoid logits:
// out[f, p] = slot >= 0 ? <g[f, slot], pre[f, slot]> * s (1 - s) * scale : 0
// (scale = 1 / div of the forward's sigmoid(logits / div)).
// One warp per node.
__global__ void pool_logits_bwd_kernel(const float* __restrict__ g,
                                       const float* __restrict__ pre,
                                       const int* __restrict__ slot,
                                       const float* __restrict__ s,
                                       float* __restrict__ out,
                                       int n, int k, int cols, float scale) {
  const int f = blockIdx.y;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= n) return;
  const int r = slot[(long long)f * n + p];
  float acc = 0.f;
  if (r >= 0) {
    const long long row = ((long long)f * k + r) * cols;
    for (int c = lane; c < cols; c += 32) acc += g[row + c] * pre[row + c];
    acc = warp_sum(acc);
  }
  if (lane == 0) {
    const float sp = s[(long long)f * n + p];
    out[(long long)f * n + p] =
        r >= 0 ? acc * sp * (1.f - sp) * scale : 0.f;
  }
}

// out[f, i, j] = x[f, i, j] + bias[f, j]; x and bias rows contiguous, any
// batch stride (views into the flat parameter buffer). Once per GSR step
// (I W + b at 3 x 160 x 268): 0.5 MB, far below a launch, so the aim is
// the launch floor. Block (b, f) takes ADD_ROWS rows of fold f; thread
// (x, y) a group of 4 columns, its bias read once into registers, and
// every blockDim.y-th row of the block's: one 16-byte load and store per
// row where x, bias, out and their strides allow (VEC), else four 4-byte
// ones. 32-bit offsets inside a fold.
constexpr int ADD_ROWS = 4;

template <bool VEC>
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
        const float4 v = *reinterpret_cast<const float4*>(X + i * cols + c);
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
          if (j < n) O[i * cols + c + j] = X[i * cols + c + j] + b[j];
      }
    }
  }
}

}  // namespace

extern "C" int fcsr_rank_select(const float* logits, float* s, int* idx,
                                float* vals, int* slot, int batch, int n,
                                int k, float div, void* stream) {
  const int threads = ((n + 31) / 32) * 32;
  rank_select_kernel<<<batch, threads, n * sizeof(float),
                       (cudaStream_t)stream>>>(logits, s, idx, vals, slot, n,
                                               k, div);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_gather_rows(const float* src, const int* idx,
                                const float* scale, float* out,
                                float* out_scaled, int batch, int n_src,
                                int k, int cols, void* stream) {
  dim3 grid(k, batch);
  gather_rows_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      src, idx, scale, out, out_scaled, n_src, k, cols);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_scatter_rows(const float* src, const int* slot,
                                 const float* scale, const float* add,
                                 float* out, int batch, int n, int k,
                                 int cols, void* stream) {
  dim3 grid(n, batch);
  scatter_rows_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      src, slot, scale, add, out, n, k, cols);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_pool_logits_bwd(const float* g, const float* pre,
                                    const int* slot, const float* s,
                                    float* out, int batch, int n, int k,
                                    int cols, float scale, void* stream) {
  dim3 grid((n + 7) / 8, batch);
  pool_logits_bwd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      g, pre, slot, s, out, n, k, cols, scale);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_add_bias(const float* x, long long sx, const float* bias,
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
    add_bias_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, sx, bias, sb, out, rows, cols);
  else
    add_bias_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, sx, bias, sb, out, rows, cols);
  return (int)cudaGetLastError();
}
