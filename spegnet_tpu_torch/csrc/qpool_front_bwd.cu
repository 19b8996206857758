// Backward of the Hiera stage-transition front (Q-pooling block) on Hopper.
// The chain (ops/fused_block_t.qpool_front_cuda_bwd) recomputes
// h1 = LN(x), y = h1 [Wqkv; Wsc]^T + b, the pooled q and the attention with
// its log-sum-exp (qpool_front.cu), then:
//
//   dk, dv, dq_pooled = attention'(d out)    sp_attention_bwd (hiera_block_bwd.cu)
//   dy[:, q]  = scatter4(dq_pooled)          sp_pool4_scatter
//   dy[:, sc] = scatter4(d shortcut)         sp_pool4_scatter
//   d[Wqkv; Wsc] = dy^T h1, d[bqkv; bsc]     sp_gemm_tn, one GEMM
//   dh1 = dy [Wqkv; Wsc]                     sp_gemm
//   dx  = LN'(dh1)                           sp_layernorm_bwd
//
// Replaces spegnet_tpu/ops/fused_block_t.py `_qpool_bwd_kernel` (:833, entry
// `_qpool_backward` :935) and its max-pool scatter `_pool4_scatter` (:801).
// In Morton order a 2x2 pool group is 4 consecutive rows, so the scatter is
// a pass over row quadruples: the pooled gradient goes to every maximal row
// of its group, split evenly among ties, comparing the bf16 values as stored
// (jax's reduce_max VJP and torch's amax backward both split ties; bf16
// makes 4-way ties common).  It is a pure bandwidth pass.
#include "common.cuh"

namespace spk {
namespace {

// out[(4r+i)*ldo + ocol0 + c] = g[r*ldg + c] / #ties if y[(4r+i)*ldy + ycol0 + c]
// is the max of its group of 4 rows, else 0; 8 columns per thread.
__global__ void pool4_scatter_kernel(const bf16* __restrict__ y, long ldy, int ycol0,
                                     const bf16* __restrict__ g, long ldg,
                                     bf16* __restrict__ out, long ldo, int ocol0,
                                     long rows_out, int ncols) {
  const int nv = ncols / 8;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows_out * nv) return;
  const long r = idx / nv;
  const int cv = (int)(idx % nv);
  uint4 yv[4], ov[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    yv[i] = *reinterpret_cast<const uint4*>(y + (4 * r + i) * ldy + ycol0 + cv * 8);
  uint4 gv = *reinterpret_cast<const uint4*>(g + r * ldg + cv * 8);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = bf(lanes(yv[i])[e]);
    const float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    const int cnt = (v[0] == m) + (v[1] == m) + (v[2] == m) + (v[3] == m);
    const float share = bf(lanes(gv)[e]) / (float)cnt;
#pragma unroll
    for (int i = 0; i < 4; ++i) lanes(ov[i])[e] = to_bf(v[i] == m ? share : 0.f);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<uint4*>(out + (4 * r + i) * ldo + ocol0 + cv * 8) = ov[i];
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

int sp_pool4_scatter(const void* y, long ldy, int ycol0, const void* g, long ldg, void* out,
                     long ldo, int ocol0, long rows_out, int ncols, void* stream) {
  const long n = rows_out * (ncols / 8);
  const int threads = 256;
  spk::pool4_scatter_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                              (cudaStream_t)stream>>>((const bf16*)y, ldy, ycol0,
                                                      (const bf16*)g, ldg, (bf16*)out, ldo,
                                                      ocol0, rows_out, ncols);
  return (int)cudaGetLastError();
}

}  // extern "C"
