// W8A8 building blocks of the int8 encoder blocks on Hopper:
//
//   sp_layernorm_q8  LayerNorm of a bf16 or f32 row (f32 statistics, output
//                    rounded to the activation dtype), then the row's
//                    symmetric int8 quant
//   sp_quant_rows    symmetric per-row int8 quant of a bf16 or f32 matrix
//   sp_gemm_i8       A[M, K] int8 . W[N, K]^T int8 -> int32, dequantized
//                    with one f32 scale per row of A and of W, + f32 bias,
//                    (-> GELU, tanh or erf) -> bf16 or f32 (+ a residual of
//                    the output dtype)
//
// Chained with the attention kernels (attention.cuh in bf16,
// attention_f32.cu in f32) they replace the TPU kernels
// spegnet_tpu/ops/fused_block_t_i8.py `_kernel_i8` (:137, #10) and
// `_qpool_kernel_i8` (:294, #11), bf16, and spegnet_tpu/ops/fused_block_i8.py
// `_kernel_i8` (:128, #12), bf16 and f32 (the JAX package's gen-1 gate
// ignores dtype, so an f32 `int8_encoder` model runs #12 at dt = f32 with the
// erf GELU): see ops/fused_block_t_i8.py for the chains.
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
// 3-4; the quant passes are row-local bandwidth passes that read the
// activations and write a quarter (f32: an eighth) of their bytes.  The GEMM
// is a plain mma.sync m16n8k32 kernel (128 x 128 x 64 tiles, 8 warps of 64 x
// 32, a 3-stage cp.async ring, ldmatrix fragments); wgmma with s8 operands
// and TMA is later work.
#include "common.cuh"

namespace spk {
namespace {

constexpr float INV127 = (float)(1.0 / 127.0);
constexpr float QFLOOR = 1e-12f;
constexpr int Q_WARPS = 8;

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

// Activations: bf16 (8 per 16-byte load) or f32 (4 per load).
template <typename T>
struct Act;

template <>
struct Act<bf16> {
  static constexpr int kVec = 8;
  using Vec = uint4;
  __device__ __forceinline__ static float get(Vec& v, int e) { return bf(lanes(v)[e]); }
  // the LayerNorm output as the block keeps it: rounded to bf16
  __device__ __forceinline__ static float keep(float v) { return bf(to_bf(v)); }
};

template <>
struct Act<float> {
  static constexpr int kVec = 4;
  using Vec = float4;
  __device__ __forceinline__ static float get(Vec& v, int e) {
    return reinterpret_cast<float*>(&v)[e];
  }
  __device__ __forceinline__ static float keep(float v) { return v; }
};

// kVec int8 codes of kVec floats, packed for one store.
__device__ __forceinline__ void q_store(int8_t* dst, const float (&v)[8], float inv) {
  *reinterpret_cast<uint2*>(dst) = q_pack8(v, inv);
}

__device__ __forceinline__ void q_store(int8_t* dst, const float (&v)[4], float inv) {
  uint32_t w = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) w |= (uint32_t)(uint8_t)q_code(v[e], inv) << (8 * e);
  *reinterpret_cast<uint32_t*>(dst) = w;
}

// One warp per row; C % kVec == 0.  y = keep((x - mu) * rsqrt(var + eps) * w
// + b), each step rounded as the unfused f32 expression, so the two passes
// over the row (absmax, then codes) see identical values.
template <typename T>
__device__ __forceinline__ float ln_val(float x, float mu, float r, float w, float b) {
  return Act<T>::keep(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), r), w), b));
}

template <typename T>
__global__ void __launch_bounds__(Q_WARPS * 32)
layernorm_q8_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, int8_t* __restrict__ q,
                    float* __restrict__ scale, long rows, int C, float eps) {
  using A = Act<T>;
  constexpr int VE = A::kVec;
  using Vec = typename A::Vec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * Q_WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * C;
  const int nv = C / VE;
  float s = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    Vec v = *reinterpret_cast<const Vec*>(xr + cv * VE);
#pragma unroll
    for (int e = 0; e < VE; ++e) s += A::get(v, e);
  }
  const float mu = warp_sum(s) / C;
  float var = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    Vec v = *reinterpret_cast<const Vec*>(xr + cv * VE);
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float d = A::get(v, e) - mu;
      var += d * d;
    }
  }
  const float r = rsqrtf(warp_sum(var) / C + eps);
  float amax = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    Vec v = *reinterpret_cast<const Vec*>(xr + cv * VE);
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int c = cv * VE + e;
      amax = fmaxf(amax, fabsf(ln_val<T>(A::get(v, e), mu, r, w[c], b[c])));
    }
  }
  const float sc = q_scale(warp_max(amax));
  const float inv = 1.0f / sc;
  int8_t* qr = q + row * C;
  for (int cv = lane; cv < nv; cv += 32) {
    Vec v = *reinterpret_cast<const Vec*>(xr + cv * VE);
    float y[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int c = cv * VE + e;
      y[e] = ln_val<T>(A::get(v, e), mu, r, w[c], b[c]);
    }
    q_store(qr + cv * VE, y, inv);
  }
  if (lane == 0) scale[row] = sc;
}

// One warp per row of a [rows, K] matrix; K % kVec == 0.
template <typename T>
__global__ void __launch_bounds__(Q_WARPS * 32)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, long rows, int K) {
  using A = Act<T>;
  constexpr int VE = A::kVec;
  using Vec = typename A::Vec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * Q_WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * K;
  const int nv = K / VE;
  float amax = 0.f;
  for (int cv = lane; cv < nv; cv += 32) {
    Vec v = *reinterpret_cast<const Vec*>(xr + cv * VE);
#pragma unroll
    for (int e = 0; e < VE; ++e) amax = fmaxf(amax, fabsf(A::get(v, e)));
  }
  const float sc = q_scale(warp_max(amax));
  const float inv = 1.0f / sc;
  int8_t* qr = q + row * K;
  for (int cv = lane; cv < nv; cv += 32) {
    Vec v = *reinterpret_cast<const Vec*>(xr + cv * VE);
    float y[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) y[e] = A::get(v, e);
    q_store(qr + cv * VE, y, inv);
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

enum { I8_ACT_NONE = 0, I8_ACT_GELU = 1, I8_ACT_GELU_ERF = 2 };

// Two output values, rounded to the output type (bf16 or f32).
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ float2 load2(const bf16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

__device__ __forceinline__ float round_to(bf16*, float v) { return bf(to_bf(v)); }

__device__ __forceinline__ float round_to(float*, float v) { return v; }

// C[M, N] = dequant(A W^T) + bias (-> GELU), rounded to OutT (+ res[M, N],
// an OutT + OutT sum rounded once more).  K % 32 == 0, N % 8 == 0; the M, N
// and K tails are zero-filled in shared memory.
template <int ACT, bool SW_FIRST, typename OutT>
__global__ void __launch_bounds__(I8_THREADS)
gemm_i8_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa,
               const int8_t* __restrict__ W, const float* __restrict__ sw,
               const float* __restrict__ bias, const OutT* __restrict__ res,
               OutT* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int g = lane >> 2, t = lane & 3;
  // One grid axis, N tiles fastest (see gemm_tma_kernel).
  const int n_tiles = (N + I8_BN - 1) / I8_BN;
  const long m0 = (long)(blockIdx.x / n_tiles) * I8_BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * I8_BN;
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

  // Epilogue straight from the fragments: pairs, rows g and g + 8.
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
          if (ACT == I8_ACT_GELU_ERF) v[e] = gelu_erf(v[e]);
        }
        OutT* dst = C + row * N + col;
        if (res) {
          const float2 rv = load2(res + row * N + col);
          v[0] = rv.x + round_to(dst, v[0]);
          v[1] = rv.y + round_to(dst, v[1]);
        }
        store2(dst, v[0], v[1]);
      }
    }
  }
}

template <int ACT, bool SW_FIRST, typename OutT>
cudaError_t launch_gemm_i8(const void* a, const void* sa, const void* w, const void* sw,
                           const void* bias, const void* res, void* c, int M, int N, int K,
                           cudaStream_t st) {
  cudaFuncSetAttribute(gemm_i8_kernel<ACT, SW_FIRST, OutT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM);
  const long blocks = (long)((N + I8_BN - 1) / I8_BN) * ((M + I8_BM - 1) / I8_BM);
  if (blocks >= (1L << 31)) return cudaErrorInvalidConfiguration;
  gemm_i8_kernel<ACT, SW_FIRST, OutT><<<(unsigned)blocks, I8_THREADS, I8_SMEM, st>>>(
      (const int8_t*)a, (const float*)sa, (const int8_t*)w, (const float*)sw,
      (const float*)bias, (const OutT*)res, (OutT*)c, M, N, K);
  return cudaGetLastError();
}

template <bool SW_FIRST, typename OutT>
cudaError_t launch_gemm_i8_act(int act, const void* a, const void* sa, const void* w,
                               const void* sw, const void* bias, const void* res, void* c,
                               int M, int N, int K, cudaStream_t st) {
  switch (act) {
    case I8_ACT_NONE:
      return launch_gemm_i8<I8_ACT_NONE, SW_FIRST, OutT>(a, sa, w, sw, bias, res, c, M, N, K,
                                                         st);
    case I8_ACT_GELU:
      return launch_gemm_i8<I8_ACT_GELU, SW_FIRST, OutT>(a, sa, w, sw, bias, res, c, M, N, K,
                                                         st);
    case I8_ACT_GELU_ERF:
      return launch_gemm_i8<I8_ACT_GELU_ERF, SW_FIRST, OutT>(a, sa, w, sw, bias, res, c, M, N,
                                                             K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spk

extern "C" {

// f32: x is f32 (else bf16).
int sp_layernorm_q8(const void* x, const void* w, const void* b, void* q, void* scale,
                    long rows, int C, float eps, int f32, void* stream) {
  const unsigned grid = (unsigned)((rows + spk::Q_WARPS - 1) / spk::Q_WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    spk::layernorm_q8_kernel<float><<<grid, spk::Q_WARPS * 32, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)b, (int8_t*)q, (float*)scale, rows, C,
        eps);
  else
    spk::layernorm_q8_kernel<spk::bf16><<<grid, spk::Q_WARPS * 32, 0, st>>>(
        (const spk::bf16*)x, (const float*)w, (const float*)b, (int8_t*)q, (float*)scale,
        rows, C, eps);
  return (int)cudaGetLastError();
}

int sp_quant_rows(const void* x, void* q, void* scale, long rows, int K, int f32,
                  void* stream) {
  const unsigned grid = (unsigned)((rows + spk::Q_WARPS - 1) / spk::Q_WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    spk::quant_rows_kernel<float><<<grid, spk::Q_WARPS * 32, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)scale, rows, K);
  else
    spk::quant_rows_kernel<spk::bf16><<<grid, spk::Q_WARPS * 32, 0, st>>>(
        (const spk::bf16*)x, (int8_t*)q, (float*)scale, rows, K);
  return (int)cudaGetLastError();
}

// act: 0 none, 1 tanh GELU, 2 erf GELU; sw_first: the dequant order (see the
// header); f32: the output and the residual are f32 (else bf16).
int sp_gemm_i8(const void* a, const void* sa, const void* w, const void* sw, const void* bias,
               const void* res, void* c, int M, int N, int K, int act, int sw_first, int f32,
               void* stream) {
  using namespace spk;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return (int)(sw_first ? launch_gemm_i8_act<true, float>(act, a, sa, w, sw, bias, res, c, M,
                                                            N, K, st)
                          : launch_gemm_i8_act<false, float>(act, a, sa, w, sw, bias, res, c,
                                                             M, N, K, st));
  if (act == I8_ACT_GELU_ERF) return (int)cudaErrorInvalidValue;
  return (int)(sw_first ? launch_gemm_i8_act<true, bf16>(act, a, sa, w, sw, bias, res, c, M, N,
                                                         K, st)
                        : launch_gemm_i8_act<false, bf16>(act, a, sa, w, sw, bias, res, c, M,
                                                          N, K, st));
}

}  // extern "C"
