// W8A8 building blocks of the int8 encoder blocks on Hopper:
//
//   sp_layernorm_q8  LayerNorm of a bf16 row (f32 statistics, output rounded
//                    to bf16), then the row's symmetric int8 quant
//   sp_quant_rows    symmetric per-row int8 quant of a bf16 matrix
//   sp_gemm_i8       A[M, K] int8 . W[N, K]^T int8 -> int32, dequantized
//                    with one f32 scale per row of A and of W, + f32 bias,
//                    (-> tanh GELU) -> bf16 (+ bf16 residual)
//
// Chained with the bf16 attention kernels (attention.cuh) they replace the
// TPU kernels spegnet_tpu/ops/fused_block_t_i8.py `_kernel_i8` (:137, #10)
// and `_qpool_kernel_i8` (:294, #11), and spegnet_tpu/ops/fused_block_i8.py
// `_kernel_i8` (:128, #12): see ops/fused_block_t_i8.py for the chains.
//
// The quant follows the TPU kernels exactly, since a different rounding
// changes codes: scale s = max(absmax * f32(1/127), 1e-12), codes
// rint(x * (1/s)) with the reciprocal taken first and ties to even.  The
// dequant is a rank-1 rescale of the exact int32 sum in one of the TPU
// kernels' two orders (`SW_FIRST`: acc * s_w * s_x, fused_block_t_i8.py:134;
// else acc * s_x * s_w, fused_block_i8.py:125), each product rounded (no
// FMA contraction), then + bias.
//
// Bound on the H100: the four projections carry ~90% of a block's
// operations and run at the int8 tensor-core rate (twice bf16's) at stages
// 3-4; the quant passes are row-local bandwidth passes that read bf16 and
// write a quarter of a bf16 matrix's bytes less.  The GEMM is a plain
// mma.sync m16n8k32 kernel (128 x 128 x 64 tiles, 8 warps of 64 x 32, a
// 3-stage cp.async ring, ldmatrix fragments); wgmma with s8 operands and
// TMA is later work.
#include "common.cuh"

namespace spk {
namespace {

constexpr float INV127 = (float)(1.0 / 127.0);
constexpr float QFLOOR = 1e-12f;
constexpr int Q_WARPS = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row scale from its absmax, and the reciprocal the codes are taken with.
__device__ __forceinline__ float q_scale(float amax) { return fmaxf(amax * INV127, QFLOOR); }

__device__ __forceinline__ int8_t q_code(float v, float inv) {
  return (int8_t)__float2int_rn(__fmul_rn(v, inv));
}

// 8 int8 codes of 8 floats, packed for one 8-byte store.
__device__ __forceinline__ uint2 q_pack8(const float (&v)[8], float inv) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e / 4] |= (uint32_t)(uint8_t)q_code(v[e], inv) << (8 * (e % 4));
  return make_uint2(w[0], w[1]);
}

// One warp per row; C % 8 == 0.  y = bf16((x - mu) * rsqrt(var + eps) * w + b),
// each step rounded as the unfused f32 expression, so the two passes over the
// row (absmax, then codes) see identical values.
__device__ __forceinline__ float ln_val(float x, float mu, float r, float w, float b) {
  return bf(to_bf(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), r), w), b)));
}

__global__ void __launch_bounds__(Q_WARPS * 32)
layernorm_q8_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, int8_t* __restrict__ q,
                    float* __restrict__ scale, long rows, int C, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * Q_WARPS + warp;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  const int nv = C / 8;
  float s = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + cv * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += bf(lanes(v)[e]);
  }
  const float mu = warp_sum(s) / C;
  float var = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + cv * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = bf(lanes(v)[e]) - mu;
      var += d * d;
    }
  }
  const float r = rsqrtf(warp_sum(var) / C + eps);
  float amax = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + cv * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = cv * 8 + e;
      amax = fmaxf(amax, fabsf(ln_val(bf(lanes(v)[e]), mu, r, w[c], b[c])));
    }
  }
  const float sc = q_scale(warp_max(amax));
  const float inv = 1.0f / sc;
  int8_t* qr = q + row * C;
  for (int cv = lane; cv < nv; cv += 32) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + cv * 8);
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = cv * 8 + e;
      y[e] = ln_val(bf(lanes(v)[e]), mu, r, w[c], b[c]);
    }
    *reinterpret_cast<uint2*>(qr + cv * 8) = q_pack8(y, inv);
  }
  if (lane == 0) scale[row] = sc;
}

// One warp per row of a bf16 [rows, K] matrix; K % 8 == 0.
__global__ void __launch_bounds__(Q_WARPS * 32)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, long rows, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * Q_WARPS + warp;
  if (row >= rows) return;
  const bf16* xr = x + row * K;
  const int nv = K / 8;
  float amax = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + cv * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(bf(lanes(v)[e])));
  }
  const float sc = q_scale(warp_max(amax));
  const float inv = 1.0f / sc;
  int8_t* qr = q + row * K;
  for (int cv = lane; cv < nv; cv += 32) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + cv * 8);
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = bf(lanes(v)[e]);
    *reinterpret_cast<uint2*>(qr + cv * 8) = q_pack8(y, inv);
  }
  if (lane == 0) scale[row] = sc;
}

// ---------------------------------------------------------------------------
// int8 GEMM
// ---------------------------------------------------------------------------

constexpr int I8_BM = 128, I8_BN = 128, I8_BK = 64, I8_STAGES = 3;
constexpr int I8_PITCH = I8_BK + 16;  // bytes per smem row: conflict-free ldmatrix
constexpr int I8_TILE = (I8_BM + I8_BN) * I8_PITCH;
constexpr int I8_SMEM = I8_STAGES * I8_TILE;
constexpr int I8_THREADS = 256;

// mma.m16n8k32 s8 x s8 -> s32 fragments, lane = 4g + t: A (16 x 32 row-major)
// a0 (row g, k 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..), a3 (g+8, 16+4t..);
// B (32 x 8, "col") b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g); C as for bf16.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

enum { I8_ACT_NONE = 0, I8_ACT_GELU = 1 };

// C[M, N] = dequant(A W^T) + bias (-> GELU), rounded to bf16 (+ res[M, N],
// a bf16 + bf16 sum rounded once more).  K % 32 == 0, N % 8 == 0; the M, N
// and K tails are zero-filled in shared memory.
template <int ACT, bool SW_FIRST>
__global__ void __launch_bounds__(I8_THREADS)
gemm_i8_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa,
               const int8_t* __restrict__ W, const float* __restrict__ sw,
               const float* __restrict__ bias, const bf16* __restrict__ res,
               bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int g = lane >> 2, t = lane & 3;
  const long m0 = (long)blockIdx.y * I8_BM;
  const int n0 = blockIdx.x * I8_BN;
  const int nk = (K + I8_BK - 1) / I8_BK;

  // One stage: 128 A rows and 128 W rows of 64 bytes, 4 16-byte chunks each.
  auto load_stage = [&](int s, int kt) {
    unsigned char* As = smem_i8 + s * I8_TILE;
    unsigned char* Bs = As + I8_BM * I8_PITCH;
    const int k0 = kt * I8_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * I8_THREADS;
      const int r = idx / 4, ck = (idx % 4) * 16;
      const bool kin = k0 + ck < K;
      const long ra = m0 + r;
      const bool ina = kin && ra < M;
      cp_async16(As + r * I8_PITCH + ck, ina ? A + ra * K + k0 + ck : A, ina ? 16 : 0);
      const int rb = n0 + r;
      const bool inb = kin && rb < N;
      cp_async16(Bs + r * I8_PITCH + ck, inb ? W + (long)rb * K + k0 + ck : W, inb ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < I8_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<I8_STAGES - 2>();
    __syncthreads();
    const int nxt = kt + I8_STAGES - 1;
    if (nxt < nk) load_stage(nxt % I8_STAGES, nxt);
    cp_async_commit();
    const unsigned char* As = smem_i8 + (kt % I8_STAGES) * I8_TILE;
    const unsigned char* Bs = As + I8_BM * I8_PITCH;
#pragma unroll
    for (int ks = 0; ks < I8_BK / 32; ++ks) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], As + (wm * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     I8_PITCH + ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Bs + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * I8_PITCH +
                           ks * 32 + ((lane >> 3) & 1) * 16);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the fragments: bf16 pairs, rows g and g + 8.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    if (col >= N) continue;
    const float w0 = sw[col], w1 = sw[col + 1], b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = m0 + wm * 64 + mi * 16 + g + 8 * hh;
        if (row >= M) continue;
        const float x = sa[row];
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __int2float_rn(acc[mi][ni][2 * hh + e]);
          const float ws = e ? w1 : w0;
          const float p = SW_FIRST ? __fmul_rn(__fmul_rn(a, ws), x)
                                   : __fmul_rn(__fmul_rn(a, x), ws);
          v[e] = __fadd_rn(p, e ? b1 : b0);
          if (ACT == I8_ACT_GELU) v[e] = gelu_tanh(v[e]);
        }
        __nv_bfloat162 o = __floats2bfloat162_rn(v[0], v[1]);
        if (res) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(res + row * N + col);
          o = __floats2bfloat162_rn(__low2float(rv) + __low2float(o),
                                    __high2float(rv) + __high2float(o));
        }
        *reinterpret_cast<__nv_bfloat162*>(C + row * N + col) = o;
      }
    }
  }
}

template <int ACT, bool SW_FIRST>
cudaError_t launch_gemm_i8(const void* a, const void* sa, const void* w, const void* sw,
                           const void* bias, const void* res, void* c, int M, int N, int K,
                           cudaStream_t st) {
  cudaFuncSetAttribute(gemm_i8_kernel<ACT, SW_FIRST>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM);
  const dim3 grid((N + I8_BN - 1) / I8_BN, (M + I8_BM - 1) / I8_BM);
  gemm_i8_kernel<ACT, SW_FIRST><<<grid, I8_THREADS, I8_SMEM, st>>>(
      (const int8_t*)a, (const float*)sa, (const int8_t*)w, (const float*)sw,
      (const float*)bias, (const bf16*)res, (bf16*)c, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spk

extern "C" {

int sp_layernorm_q8(const void* x, const void* w, const void* b, void* q, void* scale,
                    long rows, int C, float eps, void* stream) {
  const unsigned grid = (unsigned)((rows + spk::Q_WARPS - 1) / spk::Q_WARPS);
  spk::layernorm_q8_kernel<<<grid, spk::Q_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const spk::bf16*)x, (const float*)w, (const float*)b, (int8_t*)q, (float*)scale, rows,
      C, eps);
  return (int)cudaGetLastError();
}

int sp_quant_rows(const void* x, void* q, void* scale, long rows, int K, void* stream) {
  const unsigned grid = (unsigned)((rows + spk::Q_WARPS - 1) / spk::Q_WARPS);
  spk::quant_rows_kernel<<<grid, spk::Q_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const spk::bf16*)x, (int8_t*)q, (float*)scale, rows, K);
  return (int)cudaGetLastError();
}

// gelu: 0 none, 1 tanh GELU; sw_first: the dequant order (see the header).
int sp_gemm_i8(const void* a, const void* sa, const void* w, const void* sw, const void* bias,
               const void* res, void* c, int M, int N, int K, int gelu, int sw_first,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gelu && sw_first)
    return (int)spk::launch_gemm_i8<spk::I8_ACT_GELU, true>(a, sa, w, sw, bias, res, c, M, N,
                                                             K, st);
  if (gelu)
    return (int)spk::launch_gemm_i8<spk::I8_ACT_GELU, false>(a, sa, w, sw, bias, res, c, M,
                                                              N, K, st);
  if (sw_first)
    return (int)spk::launch_gemm_i8<spk::I8_ACT_NONE, true>(a, sa, w, sw, bias, res, c, M, N,
                                                             K, st);
  return (int)spk::launch_gemm_i8<spk::I8_ACT_NONE, false>(a, sa, w, sw, bias, res, c, M, N,
                                                            K, st);
}

}  // extern "C"
