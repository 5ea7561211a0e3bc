// adam_masked: one launch of the masked Adam update over the flat (F, P)
// parameter, moment and gradient buffers, with per-fold scalars
// scal[f] = [ok, 1 - b1^t, 1 - b2^t].
//
// Replaces the per-leaf Adam tail of the TPU training-step kernel
// (fcsr_tpu/models/fused_step.py::_make_train_step_kernel, lines 890-912),
// which kept p, m and v for all folds in VMEM. Here they stay in device
// memory: the update reads p, m, v, g and writes p', m', v' once each,
// so it is bound by bytes (about 7 x 4 x F x P). A masked step (ok = 0)
// copies p, m and v through bit-unchanged. The arithmetic is pinned to
// IEEE round-to-nearest with no FMA contraction, so it matches the plain
// version's op order exactly. Thread f < F of block 0 also writes the
// masked step loss and reconstruction error from the three loss terms
// vals[f] = [lmbda * L1(net, start), recon, spectral].
#include "common.cuh"

namespace {

__global__ void adam_masked_kernel(const float* __restrict__ p,
                                   const float* __restrict__ m,
                                   const float* __restrict__ v,
                                   const float* __restrict__ g,
                                   const float* __restrict__ scal,
                                   const float* __restrict__ vals,
                                   float* p_out, float* m_out, float* v_out,
                                   float* __restrict__ loss,
                                   float* __restrict__ recon, int batch,
                                   long long P, float lr, float b1,
                                   float omb1, float b2, float omb2,
                                   float eps) {
  const long long total = P * batch;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long f = e / P;
    const float ok = scal[f * 3], d1 = scal[f * 3 + 1], d2 = scal[f * 3 + 2];
    const float gg = g[e], mo = m[e], vo = v[e], po = p[e];
    const float mn = __fadd_rn(__fmul_rn(b1, mo), __fmul_rn(omb1, gg));
    const float vn = __fadd_rn(__fmul_rn(b2, vo),
                               __fmul_rn(omb2, __fmul_rn(gg, gg)));
    const float mhat = __fdiv_rn(mn, d1);
    const float vhat = __fdiv_rn(vn, d2);
    const float step = __fdiv_rn(__fmul_rn(lr, mhat),
                                 __fadd_rn(__fsqrt_rn(vhat), eps));
    const bool on = ok > 0.f;
    p_out[e] = on ? __fsub_rn(po, step) : po;
    m_out[e] = on ? mn : mo;
    v_out[e] = on ? vn : vo;
  }
  if (blockIdx.x == 0) {
    for (int f = threadIdx.x; f < batch; f += blockDim.x) {
      const float ok = scal[f * 3];
      loss[f] = (vals[f * 3] + (vals[f * 3 + 1] + vals[f * 3 + 2])) * ok;
      recon[f] = vals[f * 3 + 1] * ok;
    }
  }
}

}  // namespace

extern "C" int fcsr_adam_masked(const float* p, const float* m,
                                const float* v, const float* g,
                                const float* scal, const float* vals,
                                float* p_out, float* m_out, float* v_out,
                                float* loss, float* recon, int batch,
                                long long P, float lr, float b1, float omb1,
                                float b2, float omb2, float eps,
                                void* stream) {
  const long long total = P * batch;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  adam_masked_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      p, m, v, g, scal, vals, p_out, m_out, v_out, loss, recon, batch, P, lr,
      b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}
