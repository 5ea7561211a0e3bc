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
// The normalisation passes need every row sum before any output, so they
// run one block per fold with the row sums in shared memory.
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
//   d r_q   = sum_i g[i, q] fd[q, i] r_i + sum_a g[q, a] r_a fd[a, q]
//   d rs_q  = -1/2 rs_q^-3/2 d r_q = -1/2 r_q^3 d r_q
//   d fd[i, j] = g[j, i] r_i r_j + d rs_i;  dT = d fd * sign(T), 0 on diag
__global__ void tail_normalize_bwd_kernel(const float* __restrict__ g_adj,
                                          const float* __restrict__ t,
                                          const float* __restrict__ r_in,
                                          float* __restrict__ g_t, int m) {
  extern __shared__ float sh[];
  float* r = sh;
  float* grs = sh + m;
  const int f = blockIdx.x;
  const long long mm = (long long)m * m;
  const float* T = t + f * mm;
  const float* G = g_adj + f * mm;
  float* GT = g_t + f * mm;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    r[i] = r_in[(long long)f * m + i];
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int q = w; q < m; q += nw) {
    float acc = 0.f;
    for (int i = lane; i < m; i += 32) {
      const float fd_qi = (q == i) ? 1.f : fabsf(T[(long long)q * m + i]);
      const float fd_iq = (q == i) ? 1.f : fabsf(T[(long long)i * m + q]);
      acc += G[(long long)i * m + q] * fd_qi * r[i];
      acc += G[(long long)q * m + i] * r[i] * fd_iq;
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float rq = r[q];
      grs[q] = acc * -0.5f * (rq * rq * rq);
    }
  }
  __syncthreads();
  for (long long e = threadIdx.x; e < mm; e += blockDim.x) {
    const int i = (int)(e / m), j = (int)(e % m);
    float v = 0.f;
    if (i != j)
      v = (G[(long long)j * m + i] * r[i] * r[j] + grs[i]) *
          abs_grad_sign(T[e]);
    GT[e] = v;
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
  tail_normalize_bwd_kernel<<<batch, 1024, 2 * m * sizeof(float),
                              (cudaStream_t)stream>>>(g_adj, t, r, g_t, m);
  return (int)cudaGetLastError();
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
