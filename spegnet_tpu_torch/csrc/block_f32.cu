// f32 building blocks of the gen-1 whole-block chain on Hopper:
//
//   sp_layernorm_f32  LayerNorm of an f32 row: f32 statistics, f32 output
//   sp_gemm_f32       C[M, N] = A[M, K] . W[N, K]^T + bias (-> GELU, erf or
//                     tanh) (+ residual[M, N]), all f32
//
// Chained with the f32 attention kernel (attention_f32.cu) they replace
// the TPU kernel spegnet_tpu/ops/fused_block.py `_kernel` (:99, #7) at
// dt = f32, the block of Hiera's f32 compute (`use_amp: false`):
// LN1 -> qkv -> window attention -> proj + x -> LN2 -> fc1 + GELU -> fc2 + u
// (ops/fused_block.block_cuda_f32).  The TPU kernel keeps every activation
// in VMEM and makes one HBM round trip; here each link goes through device
// memory, as the bf16 chain of hiera_block.cu does.
//
// Products must be f32-accurate: the JAX kernel contracts f32 operands with
// an f32 result.  The GEMM runs 3xTF32 on mma.sync.m16n8k8 (common.cuh
// `mma_3xtf32`: each operand split into a tf32 big part and the rest, three
// products), ~f32 accuracy at a third of the TF32 tensor-core rate; a
// single TF32 pass keeps ~3 decimal digits and is not the f32 the JAX
// kernel computes.
//
// Bound on the H100: the four projections carry ~95% of a block's
// operations at 165 TFLOP/s (3 x TF32 on the dense 495 TF32 rate, the
// card's fastest f32-accurate product): operations-bound at every Hiera-L
// geometry.  The GEMM is a plain kernel: 128 x 128 x 16 tiles, 8 warps of
// 64 x 32, a 3-stage cp.async ring, fragments read from padded shared
// memory; wgmma (tf32) and TMA are later work.  LayerNorm is a bandwidth
// pass, one warp per row.
#include "common.cuh"

namespace spk {
namespace {

constexpr int LN_WARPS = 8;

// One warp per row; C % 4 == 0.  y = ((x - mu) * rsqrt(var + eps)) * w + b
// in the plain version's order, each step rounded.
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y, long rows, int C,
                     float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * LN_WARPS + warp;
  if (row >= rows) return;
  const float4* xr = reinterpret_cast<const float4*>(x + row * C);
  const int nv = C / 4;
  float s = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    const float4 v = xr[cv];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / C;
  float var = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    const float4 v = xr[cv];
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    var += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float r = rsqrtf(warp_sum(var) / C + eps);
  float4* yr = reinterpret_cast<float4*>(y + row * C);
  for (int cv = lane; cv < nv; cv += 32) {
    const float4 v = xr[cv];
    const float4 wv = reinterpret_cast<const float4*>(w)[cv];
    const float4 bv = reinterpret_cast<const float4*>(b)[cv];
    float4 o;
    o.x = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.x, mu), r), wv.x), bv.x);
    o.y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.y, mu), r), wv.y), bv.y);
    o.z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.z, mu), r), wv.z), bv.z);
    o.w = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.w, mu), r), wv.w), bv.w);
    yr[cv] = o;
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 GEMM
// ---------------------------------------------------------------------------

constexpr int G_BM = 128, G_BN = 128, G_BK = 16, G_STAGES = 3, G_THREADS = 256;
// floats per shared-memory row: 80 bytes keeps rows 16-byte aligned for
// cp.async and the fragment reads (row 4g + k, g = 0..7) on 32 banks.
constexpr int G_PITCH = G_BK + 4;
constexpr int G_TILE = (G_BM + G_BN) * G_PITCH;
constexpr int G_SMEM = G_STAGES * G_TILE * 4;

// The model's f32 blocks take the erf GELU (models/hiera.py: approx_gelu is
// bf16 only, as in the JAX package). The tanh form stays because the TPU
// kernel's f32 form takes ``approx_gelu`` as an argument like its bf16 one,
// and ops/fused_block.fused_block keeps that signature for every dtype.
enum { G_ACT_NONE = 0, G_ACT_GELU_ERF = 1, G_ACT_GELU_TANH = 2 };

// K % 4 == 0, N % 4 == 0; the M, N and K tails are zero-filled in shared
// memory and not stored.
template <int ACT>
__global__ void __launch_bounds__(G_THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) float smem_g[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int g = lane >> 2, t = lane & 3;
  // One grid axis, N tiles fastest.
  const int n_tiles = (N + G_BN - 1) / G_BN;
  const long m0 = (long)(blockIdx.x / n_tiles) * G_BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * G_BN;
  const int nk = (K + G_BK - 1) / G_BK;

  // One stage: 128 A rows and 128 W rows of 16 floats, 4 16-byte chunks each.
  auto load_stage = [&](int s, int kt) {
    float* As = smem_g + s * G_TILE;
    float* Bs = As + G_BM * G_PITCH;
    const int k0 = kt * G_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * G_THREADS;
      const int r = idx / 4, ck = (idx % 4) * 4;
      const bool kin = k0 + ck < K;
      const long ra = m0 + r;
      const bool ina = kin && ra < M;
      cp_async16(As + r * G_PITCH + ck, ina ? A + ra * K + k0 + ck : A, ina ? 16 : 0);
      const int rb = n0 + r;
      const bool inb = kin && rb < N;
      cp_async16(Bs + r * G_PITCH + ck, inb ? W + (long)rb * K + k0 + ck : W, inb ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();
    const int nxt = kt + G_STAGES - 1;
    if (nxt < nk) load_stage(nxt % G_STAGES, nxt);
    cp_async_commit();
    const float* As = smem_g + (kt % G_STAGES) * G_TILE;
    const float* Bs = As + G_BM * G_PITCH;
#pragma unroll
    for (int ks = 0; ks < G_BK / 8; ++ks) {
      uint32_t ab[4][4], as[4][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* p = As + (wm * 64 + mi * 16 + g) * G_PITCH + ks * 8 + t;
        split_tf32(p[0], ab[mi][0], as[mi][0]);
        split_tf32(p[8 * G_PITCH], ab[mi][1], as[mi][1]);
        split_tf32(p[4], ab[mi][2], as[mi][2]);
        split_tf32(p[8 * G_PITCH + 4], ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* p = Bs + (wn * 32 + ni * 8 + g) * G_PITCH + ks * 8 + t;
        split_tf32(p[0], bb[ni][0], bs[ni][0]);
        split_tf32(p[4], bb[ni][1], bs[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_3xtf32(acc[mi][ni], ab[mi], as[mi], bb[ni], bs[ni]);
    }
  }
  cp_async_wait<0>();

  // Epilogue from the fragments: pairs of columns, rows g and g + 8.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    if (col >= N) continue;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = m0 + wm * 64 + mi * 16 + g + 8 * hh;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * hh] + b0, v1 = acc[mi][ni][2 * hh + 1] + b1;
        if (ACT == G_ACT_GELU_ERF) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        } else if (ACT == G_ACT_GELU_TANH) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        if (res) {
          const float2 r = *reinterpret_cast<const float2*>(res + row * N + col);
          v0 = r.x + v0;
          v1 = r.y + v1;
        }
        *reinterpret_cast<float2*>(C + row * N + col) = make_float2(v0, v1);
      }
    }
  }
}

template <int ACT>
cudaError_t launch_gemm_f32(const float* a, const float* w, const float* bias,
                            const float* res, float* c, int M, int N, int K, cudaStream_t st) {
  cudaFuncSetAttribute(gemm_f32_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       G_SMEM);
  const long blocks = (long)((N + G_BN - 1) / G_BN) * ((M + G_BM - 1) / G_BM);
  if (blocks >= (1L << 31)) return cudaErrorInvalidConfiguration;
  gemm_f32_kernel<ACT><<<(unsigned)blocks, G_THREADS, G_SMEM, st>>>(a, w, bias, res, c, M, N,
                                                                     K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spk

extern "C" {

int sp_layernorm_f32(const void* x, const void* w, const void* b, void* y, long rows, int C,
                     float eps, void* stream) {
  const unsigned grid = (unsigned)((rows + spk::LN_WARPS - 1) / spk::LN_WARPS);
  spk::layernorm_f32_kernel<<<grid, spk::LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, rows, C, eps);
  return (int)cudaGetLastError();
}

// act: 0 none, 1 erf GELU, 2 tanh GELU; bias and res may be null.
int sp_gemm_f32(const void* a, const void* w, const void* bias, const void* res, void* c,
                int M, int N, int K, int act, void* stream) {
  using namespace spk;
  cudaStream_t st = (cudaStream_t)stream;
  const float *A = (const float*)a, *W = (const float*)w, *B = (const float*)bias,
              *R = (const float*)res;
  float* C = (float*)c;
  switch (act) {
    case G_ACT_NONE:
      return (int)launch_gemm_f32<G_ACT_NONE>(A, W, B, R, C, M, N, K, st);
    case G_ACT_GELU_ERF:
      return (int)launch_gemm_f32<G_ACT_GELU_ERF>(A, W, B, R, C, M, N, K, st);
    case G_ACT_GELU_TANH:
      return (int)launch_gemm_f32<G_ACT_GELU_TANH>(A, W, B, R, C, M, N, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
