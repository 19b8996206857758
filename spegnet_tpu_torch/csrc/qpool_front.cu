// Front of a Hiera stage transition (Q-pooling block) on Hopper:
//
//   h1 = LN(x)                                   sp_layernorm (hiera_block.cu)
//   y  = h1 [Wqkv; Wsc]^T + [bqkv; bsc]          sp_gemm (hiera_block.cu), one GEMM
//   o  = attention(maxpool4(q), k, v) per window sp_qpool_attention
//   sc = maxpool4(y[:, shortcut columns])        sp_pool4_rows
//
// Replaces spegnet_tpu/ops/fused_block_t.py `_qpool_kernel` (:634).  The
// TPU kernel pooled q with lane rolls and compacted every 4th lane with a
// selection matmul; in Morton order a 2x2 pool group is 4 consecutive token
// rows, so here the pooled q row is formed while loading the query tile
// (after the bf16 cast, as `_qpool_kernel` :642-655 does) and the window's
// L keys are read in place.  Outputs are token-major at the pooled grid,
// still in Morton order: o [tokens/4, H*D], sc [tokens/4, Cout].
//
// Bound on the H100: the combined projection GEMM (3*H*D + Cout columns) is
// ~90% of the FLOPs and compute bound; attention runs Lq = L/4 query rows per
// window, and the pool kernel is a pure bandwidth pass over Cout columns.
#include "attention.cuh"

namespace spk {
namespace {

// dst[r, c] = max_{i<4} src[(4r + i) * ld + col0 + c], 8 columns per thread.
__global__ void pool4_rows_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst,
                                  long rows_out, int ld, int col0, int ncols) {
  const int nv = ncols / 8;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows_out * nv) return;
  const long r = idx / nv;
  const int cv = (int)(idx % nv);
  const bf16* s = src + 4 * r * ld + col0 + cv * 8;
  uint4 v = *reinterpret_cast<const uint4*>(s);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    uint4 w = *reinterpret_cast<const uint4*>(s + i * (long)ld);
#pragma unroll
    for (int e = 0; e < 4; ++e) pairs(v)[e] = __hmax2(pairs(v)[e], pairs(w)[e]);
  }
  *reinterpret_cast<uint4*>(dst + r * ncols + cv * 8) = v;
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

// y [rows_in, ld] (q/k/v columns first) -> out [rows_in / 4, heads * D];
// key windows of L consecutive input rows, query windows of L / 4 pooled rows.
// lse (nullable): [rows_in / 4, heads] f32 log-sum-exp of each pooled row.
int sp_qpool_attention(const void* y, void* out, void* lse, int rows_in, int ld, int heads,
                       int D, int L, float scale, void* stream) {
  return (int)spk::launch_attention<true>((const bf16*)y, (bf16*)out, (float*)lse,
                                           rows_in / 4, ld, heads, D, L / 4, L, scale,
                                           (cudaStream_t)stream);
}

int sp_pool4_rows(const void* src, void* dst, long rows_out, int ld, int col0, int ncols,
                  void* stream) {
  const long n = rows_out * (ncols / 8);
  const int threads = 256;
  spk::pool4_rows_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>((const bf16*)src, (bf16*)dst, rows_out,
                                                   ld, col0, ncols);
  return (int)cudaGetLastError();
}

}  // extern "C"
