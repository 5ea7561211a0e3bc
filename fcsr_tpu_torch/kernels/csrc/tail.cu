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
//   loss_terms          the (loss, recon) scalars of a loss entry point from
//                       the three loss terms; it stands where the TPU kernels
//                       of tail_loss_fused (fused_tail.py:73-84) and
//                       gsr_step_loss_fused (fused_step.py:721-722) store
//                       their two (1, 1) outputs. 2F + 3F floats: latency
// Each matrix is 268 x 268 (288 KB) per fold: these kernels are bound by
// bytes moved (a few hundred KB each) and, at this size, by launch latency.
// The forward normalisation needs every row sum before any output, so it
// runs one block per fold with the row sums in shared memory. Its adjoint
// does not (r is an input there) and runs in row bands across the card.
#include "common.cuh"

namespace {

__global__ void tail_normalize_kernel(const float* __restrict__ t,
                                      float* __restrict__ adj,
                                      float* __restrict__ r_out, int m) {
  extern __shared__ float r[];
  const int f = blockIdx.x;
  const long long mm = (long long)m * m;
  const float* T = t + f * mm;
  float* A = adj + f * mm;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = w; i < m; i += nw) {
    float acc = 0.f;
    for (int j = lane; j < m; j += 32)
      acc += (j == i) ? 1.f : fabsf(T[(long long)i * m + j]);
    acc = warp_sum(acc);
    if (lane == 0) {
      float ri = 1.f / sqrtf(acc);  // 0 -> inf -> 0 below; < 0 -> NaN
      if (isinf(ri)) ri = 0.f;
      r[i] = ri;
      r_out[(long long)f * m + i] = ri;
    }
  }
  __syncthreads();
  for (long long e = threadIdx.x; e < mm; e += blockDim.x) {
    const int i = (int)(e / m), j = (int)(e % m);
    const float fd = (i == j) ? 1.f : fabsf(T[(long long)j * m + i]);
    A[e] = fd * r[i] * r[j];
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

__global__ void sym_abs_fill_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int batch,
                                    int m) {
  const long long mm = (long long)m * m, total = mm * batch;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long f = e / mm, rem = e % mm;
    const int i = (int)(rem / m), j = (int)(rem % m);
    const float* X = x + f * mm;
    out[e] = (i == j) ? 1.f
                      : fabsf((X[(long long)i * m + j] + X[(long long)j * m + i]) / 2.f);
  }
}

__global__ void sym_sign_grad_kernel(const float* __restrict__ g,
                                     const float* __restrict__ x, float c,
                                     float* __restrict__ out, int batch,
                                     int m) {
  const long long mm = (long long)m * m, total = mm * batch;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long f = e / mm, rem = e % mm;
    const int i = (int)(rem / m), j = (int)(rem % m);
    float v = 0.f;
    if (i != j) {
      const float* X = x + f * mm;
      const float* Gm = g + f * mm;
      const long long ij = (long long)i * m + j, ji = (long long)j * m + i;
      const float sgn = abs_grad_sign((X[ij] + X[ji]) / 2.f);  // sym is symmetric
      v = c * (Gm[ij] * sgn) + c * (Gm[ji] * sgn);
    }
    out[e] = v;
  }
}

// One block per fold: vals[f * vstride] = value_scale * mean|a - b|;
// grad = gsign(a - b) * grad_scale, neg = -grad (either may be null).
__global__ void l1_term_kernel(const float* __restrict__ a, long long sa,
                               const float* __restrict__ b, long long sb,
                               int n, float value_scale, float grad_scale,
                               int zero_sign, float* __restrict__ vals,
                               int vstride, float* __restrict__ grad,
                               float* __restrict__ neg) {
  const int f = blockIdx.x;
  const float* A = a + f * sa;
  const float* B = b + f * sb;
  float acc = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float d = A[e] - B[e];
    acc += fabsf(d);
    if (grad) {
      const float gs = (zero_sign ? sign0(d) : abs_grad_sign(d)) * grad_scale;
      grad[(long long)f * n + e] = gs;
      if (neg) neg[(long long)f * n + e] = -gs;
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) vals[(long long)f * vstride] = value_scale * (acc / (float)n);
}

// The scalars a loss entry point returns, from the per-fold loss terms
// vals[f] = [lmbda * L1(net, start), recon, spectral]: recon[f] = vals[f][1]
// and loss[f] = recon + spectral, plus the L1 term when with_l1 (the whole
// step's loss; without it, the tail's). The sum is taken in the order of
// adam_masked's, so the step's loss is the same bits with or without the
// Adam launch.
__global__ void loss_terms_kernel(const float* __restrict__ vals,
                                  float* __restrict__ loss,
                                  float* __restrict__ recon, int batch,
                                  int with_l1) {
  for (int f = blockIdx.x * blockDim.x + threadIdx.x; f < batch;
       f += gridDim.x * blockDim.x) {
    const float tail = __fadd_rn(vals[f * 3 + 1], vals[f * 3 + 2]);
    loss[f] = with_l1 ? __fadd_rn(vals[f * 3], tail) : tail;
    recon[f] = vals[f * 3 + 1];
  }
}

// Rows per band: 8 ran 0.0037 ms against 4's 0.0041 at F = 3, m = 268 on
// an H100, so the kernel takes 8. Where a band's tiles exceed the card's
// shared memory R halves, down to 1 row (m up to ~11 600).
constexpr int BWD_ROWS = 8;

// The card's opt-in shared memory per block, read on the first launch
// that needs more than 48 KB.
int g_smem_optin = 0;

template <int R>
int launch_bwd(const float* g_adj, const float* t, const float* r, float* g_t,
               int batch, int m, cudaStream_t st) {
  // the transposed tiles' row stride: ld = 32 / R (mod 32), so the R runs
  // of one warp's cp.async land in distinct banks
  const int ld = m + ((32 / R - m % 32) % 32 + 32) % 32;
  const size_t smem = sizeof(float) * ((size_t)m + 2 * R * (size_t)m +
                                       2 * R * (size_t)ld);
  if (smem > 48 * 1024) {
    if (g_smem_optin == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &g_smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return (int)err;
    }
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

extern "C" int fcsr_tail_normalize(const float* t, float* adj, float* r,
                                   int batch, int m, void* stream) {
  tail_normalize_kernel<<<batch, 1024, m * sizeof(float),
                          (cudaStream_t)stream>>>(t, adj, r, m);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_tail_normalize_bwd(const float* g_adj, const float* t,
                                       const float* r, float* g_t, int batch,
                                       int m, void* stream) {
  return launch_bwd<BWD_ROWS>(g_adj, t, r, g_t, batch, m,
                              (cudaStream_t)stream);
}

extern "C" int fcsr_sym_abs_fill(const float* x, float* out, int batch,
                                 int m, void* stream) {
  const long long total = (long long)batch * m * m;
  sym_abs_fill_kernel<<<grid_for(total, 256), 256, 0,
                        (cudaStream_t)stream>>>(x, out, batch, m);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_sym_sign_grad(const float* g, const float* x, float c,
                                  float* out, int batch, int m,
                                  void* stream) {
  const long long total = (long long)batch * m * m;
  sym_sign_grad_kernel<<<grid_for(total, 256), 256, 0,
                         (cudaStream_t)stream>>>(g, x, c, out, batch, m);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_l1_term(const float* a, long long sa, const float* b,
                            long long sb, int n, float value_scale,
                            float grad_scale, int zero_sign, float* vals,
                            int vstride, float* grad, float* neg, int batch,
                            void* stream) {
  l1_term_kernel<<<batch, 1024, 0, (cudaStream_t)stream>>>(
      a, sa, b, sb, n, value_scale, grad_scale, zero_sign, vals, vstride,
      grad, neg);
  return (int)cudaGetLastError();
}

extern "C" int fcsr_loss_terms(const float* vals, float* loss, float* recon,
                               int batch, int with_l1, void* stream) {
  loss_terms_kernel<<<grid_for(batch, 128), 128, 0, (cudaStream_t)stream>>>(
      vals, loss, recon, batch, with_l1);
  return (int)cudaGetLastError();
}
