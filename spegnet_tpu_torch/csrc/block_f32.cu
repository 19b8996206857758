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
// an f32 result.  The GEMM runs 3xTF32 (each operand split into a tf32 big
// part and the rest, three products), ~f32 accuracy at a third of the TF32
// tensor-core rate; a single TF32 pass keeps ~3 decimal digits and is not
// the f32 the JAX kernel computes.
//
// Bound on the H100: the four projections carry ~95% of a block's
// operations at 165 TFLOP/s (3 x TF32 on the dense 495 TF32 rate, the
// card's fastest f32-accurate product): operations-bound at every Hiera-L
// geometry, near the balance of bytes and operations at stage 1 (qkv reads
// 75 MB of A and writes 226 MB at batch 8: ~90 us of bytes against ~99 us
// of operations).  The GEMM is the persistent TMA + wgmma kernel of
// gemm_persistent.cuh in its 3xTF32 form (pg_gemm_3xtf32: W's small part
// split once per stage by the producer warpgroup, A split once into register
// fragments, 12 tf32 wgmma per 32-deep k-step summed from zero and added on
// the FP32 pipe), 128 x 144 tiles (every Hiera-L width is a multiple of 144), with
// the epilogue below.  It replaced an mma.sync.m16n8k8 kernel (one 128 x
// 128 tile per block, every operand split by each warp that read it), which
// ran at 29-38 TFLOP/s on an H100, below cuBLAS's f32 GEMM.  LayerNorm is a
// bandwidth pass, one warp per row.
#include "gemm_persistent.cuh"

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

constexpr int G_BN = 144;  // output columns of a tile (kernels.GEMM_BN["f32"])

// The model's f32 blocks take the erf GELU (models/hiera.py: approx_gelu is
// bf16 only, as in the JAX package). The tanh form stays because the TPU
// kernel's f32 form takes ``approx_gelu`` as an argument like its bf16 one,
// and ops/fused_block.fused_block keeps that signature for every dtype.
enum { G_ACT_NONE = 0, G_ACT_GELU_ERF = 1, G_ACT_GELU_TANH = 2 };

// The epilogue on one consumer's 64 x 144 tile of f32 sums: + bias, then
// the GELU of ACT, then residual + value, as the unfused f32 expression.
// The tile goes out in two halves of 72 columns through a 64 x 72 staging
// buffer (two full 64 x 144 f32 tiles do not fit beside three ring stages):
// the first half's residual is prefetched there by cp.async before the
// k-loop; the second half's is read into the registers the k-loop's fresh
// sums held, issued before the first half is finished so its latency
// overlaps.  Each half's values are written over the staged residual, then
// leave as coalesced 16-byte row vectors.  Requires N % 4 == 0.
template <int ACT>
struct F32Epi {
  static constexpr int H = G_BN / 2;          // columns of a half, the staging pitch
  static constexpr int kBytes = 64 * H * 4;   // 18 KB, a multiple of 1024
  const float* bias;
  const float* res;
  float* C;
  int M, N;

  __device__ __forceinline__ void prefetch(int mrow0, int n0, unsigned char* stage,
                                           int cw) const {
    pg_prefetch_tile<H, H>(res, M, N, mrow0, n0, stage, cw);
  }

  __device__ __forceinline__ void operator()(float (&d)[G_BN / 2], int mrow0, int n0,
                                             unsigned char* stage, int cw) const {
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rl = w * 16 + g;
    float* Cs = reinterpret_cast<float*>(stage);
    float r2[H / 2];  // the second half's residual, in the accumulators' layout
    if (res) {
#pragma unroll
      for (int jj = 0; jj < H / 8; ++jj) {
        const int col = n0 + H + jj * 8 + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long row = mrow0 + rl + 8 * hh;
          float2 r = make_float2(0.f, 0.f);
          if (row < M && col < N) r = *reinterpret_cast<const float2*>(res + row * N + col);
          r2[4 * jj + 2 * hh] = r.x;
          r2[4 * jj + 2 * hh + 1] = r.y;
        }
      }
      pg_prefetch_wait(cw);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
      for (int jj = 0; jj < H / 8; ++jj) {
        const int j = half * (H / 8) + jj;
        const int cl = jj * 8 + 2 * t;
        const int col = n0 + half * H + cl;
        const float b0 = (bias && col < N) ? bias[col] : 0.f;
        const float b1 = (bias && col < N) ? bias[col + 1] : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v0 = d[4 * j + 2 * hh] + b0, v1 = d[4 * j + 2 * hh + 1] + b1;
          if (ACT == G_ACT_GELU_ERF) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          } else if (ACT == G_ACT_GELU_TANH) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          float2* slot = reinterpret_cast<float2*>(Cs + (rl + 8 * hh) * H + cl);
          if (res) {
            const float2 r = half ? make_float2(r2[4 * jj + 2 * hh], r2[4 * jj + 2 * hh + 1])
                                  : *slot;
            v0 = r.x + v0;
            v1 = r.y + v1;
          }
          *slot = make_float2(v0, v1);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      for (int idx = tid; idx < 64 * (H / 4); idx += 128) {
        const int r = idx / (H / 4), c = idx % (H / 4);
        const long row = mrow0 + r;
        const int col = n0 + half * H + c * 4;
        if (row < M && col < N)
          *reinterpret_cast<float4*>(C + row * N + col) =
              *reinterpret_cast<const float4*>(Cs + r * H + c * 4);
      }
    }
  }
};

// C[M, N] = A[M, K] W[N, K]^T with F32Epi<ACT>: the persistent GEMM of
// gemm_persistent.cuh in its 3xTF32 form.  Requires K % 4 == 0 and N % 4 ==
// 0 (16-byte rows for TMA and the epilogue's vectors); TMA zero-fills the
// M, N and K tails (K 144 is 4.5 k-steps).
template <int ACT>
__global__ void __launch_bounds__(PG_THREADS, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                F32Epi<ACT> epi, int K) {
  pg_gemm_3xtf32<G_BN>(&tmA, &tmB, epi.M, epi.N, K, epi);
}

template <int ACT>
cudaError_t launch_gemm_f32(const void* a, const void* w, const float* bias, const float* res,
                            float* c, int M, int N, int K, int grid, cudaStream_t st) {
  using Epi = F32Epi<ACT>;
  constexpr int smem = PgTf32Cfg<G_BN, Epi::kBytes>::kBytes;
  // the shared-memory attribute, set once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_f32_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  CUtensorMap ta, tb;
  cudaError_t e = pg_tmap_cached<float>(&ta, a, M, K, PG_BM);
  if (e == cudaSuccess) e = pg_tmap_cached<float>(&tb, w, N, K, G_BN);
  if (e != cudaSuccess) return e;
  const Epi epi{bias, res, c, M, N};
  gemm_f32_kernel<ACT><<<grid, PG_THREADS, smem, st>>>(ta, tb, epi, K);
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

// act: 0 none, 1 erf GELU, 2 tanh GELU; bias and res may be null; `bn`
// (144) and `grid` (min(tiles, SMs)) from kernels.gemm_plan(..., "f32").
int sp_gemm_f32(const void* a, const void* w, const void* bias, const void* res, void* c,
                int M, int N, int K, int act, int bn, int grid, void* stream) {
  using namespace spk;
  cudaStream_t st = (cudaStream_t)stream;
  const float *B = (const float*)bias, *R = (const float*)res;
  float* C = (float*)c;
  if (bn != G_BN || M < 1 || N < 1 || K < 1 || K % 4 || N % 4) return (int)cudaErrorInvalidValue;
  switch (act) {
    case G_ACT_NONE:
      return (int)launch_gemm_f32<G_ACT_NONE>(a, w, B, R, C, M, N, K, grid, st);
    case G_ACT_GELU_ERF:
      return (int)launch_gemm_f32<G_ACT_GELU_ERF>(a, w, B, R, C, M, N, K, grid, st);
    case G_ACT_GELU_TANH:
      return (int)launch_gemm_f32<G_ACT_GELU_TANH>(a, w, B, R, C, M, N, K, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
