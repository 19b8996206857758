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
// Chained with the attention kernels (attention_window.cu in bf16,
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
// is the persistent TMA + wgmma kernel of gemm_persistent.cuh on s8
// operands (wgmma m64nBNk32, int32 sums), with the dequant epilogue below.
#include <type_traits>

#include "gemm_persistent.cuh"

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

enum { I8_ACT_NONE = 0, I8_ACT_GELU = 1, I8_ACT_GELU_ERF = 2 };

// The rounded output pair at `slot` of the staging tile, plus the residual
// pair prefetched there (OutT + OutT, rounded once more) where there is one.
__device__ __forceinline__ void finish2(bf16* slot, float a, float b, bool res) {
  __nv_bfloat162 out = __floats2bfloat162_rn(a, b);
  if (res) {
    const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(slot);
    out = __floats2bfloat162_rn(__low2float(r) + __low2float(out),
                                __high2float(r) + __high2float(out));
  }
  *reinterpret_cast<__nv_bfloat162*>(slot) = out;
}

__device__ __forceinline__ void finish2(float* slot, float a, float b, bool res) {
  float2 out = make_float2(a, b);
  if (res) {
    const float2 r = *reinterpret_cast<const float2*>(slot);
    out = make_float2(r.x + a, r.y + b);
  }
  *reinterpret_cast<float2*>(slot) = out;
}

// The dequant epilogue on one consumer's 64 x BN tile of exact int32 sums
// (gemm_persistent.cuh): C = dequant(A W^T) + bias (-> GELU), rounded to
// OutT (+ res[M, N], an OutT + OutT sum rounded once more).  Each sum is
// converted with __int2float_rn and rescaled in the order SW_FIRST gives,
// each product rounded (no FMA contraction), then + bias, the tanh or erf
// GELU and the rounding to OutT; the residual tile waits in the consumer's
// staging tile (prefetched by cp.async before the k-loop), each output
// pair is finished against it in place, then the tile goes out on
// coalesced 16-byte rows.  Requires N % 8 == 0.
template <int BN, int ACT, bool SW_FIRST, typename OutT>
struct I8Epi {
  static constexpr int VE = 16 / sizeof(OutT);  // outputs per 16-byte vector
  static constexpr int P = BN + VE;             // staging pitch (elements)
  static constexpr int kBytes = (64 * P * (int)sizeof(OutT) + 1023) / 1024 * 1024;
  const float* sa;
  const float* sw;
  const float* bias;
  const OutT* res;
  OutT* C;
  int M, N;

  __device__ __forceinline__ void prefetch(int mrow0, int n0, unsigned char* stage,
                                           int cw) const {
    pg_prefetch_tile<BN, P>(res, M, N, mrow0, n0, stage, cw);
  }

  __device__ __forceinline__ void operator()(int (&d)[BN / 2], int mrow0, int n0,
                                             unsigned char* stage, int cw) const {
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rl = w * 16 + g;
    OutT* Cs = reinterpret_cast<OutT*>(stage);
    float x[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long row = mrow0 + rl + 8 * hh;
      x[hh] = row < M ? sa[row] : 0.f;
    }
    if (res) pg_prefetch_wait(cw);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = j * 8 + 2 * t;
      const int col = n0 + cl;
      const bool in = col < N;
      const float w0 = in ? sw[col] : 0.f, w1 = in ? sw[col + 1] : 0.f;
      const float b0 = in ? bias[col] : 0.f, b1 = in ? bias[col + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __int2float_rn(d[4 * j + 2 * hh + e]);
          const float ws = e ? w1 : w0;
          const float p = SW_FIRST ? __fmul_rn(__fmul_rn(a, ws), x[hh])
                                   : __fmul_rn(__fmul_rn(a, x[hh]), ws);
          v[e] = __fadd_rn(p, e ? b1 : b0);
          if (ACT == I8_ACT_GELU) v[e] = gelu_tanh(v[e]);
          if (ACT == I8_ACT_GELU_ERF) v[e] = gelu_erf(v[e]);
        }
        finish2(Cs + (rl + 8 * hh) * P + cl, v[0], v[1], res != nullptr);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    for (int idx = tid; idx < 64 * (BN / VE); idx += 128) {
      const int r = idx / (BN / VE), c = idx % (BN / VE);
      const long row = mrow0 + r;
      const int col = n0 + c * VE;
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(C + row * N + col) =
            *reinterpret_cast<const uint4*>(Cs + r * P + c * VE);
    }
  }
};

// C[M, N] = dequant(A W^T) ... with I8Epi: the persistent GEMM of
// gemm_persistent.cuh on int8 operands (wgmma m64nBNk32 s8 x s8 -> s32, a
// k-step of 128 codes).  K % 32 == 0 (so K % 16 == 0 for TMA's row pitch),
// N % 8 == 0.
template <int BN, int ACT, bool SW_FIRST, typename OutT>
__global__ void __launch_bounds__(PG_THREADS, 1)
gemm_i8_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
               I8Epi<BN, ACT, SW_FIRST, OutT> epi, int K) {
  pg_gemm<int8_t, BN>(&tmA, &tmB, epi.M, epi.N, K, epi);
}

template <int BN, int ACT, bool SW_FIRST, typename OutT>
cudaError_t launch_gemm_i8(const void* a, const void* sa, const void* w, const void* sw,
                           const void* bias, const void* res, void* c, int M, int N, int K,
                           int grid, cudaStream_t st) {
  using Epi = I8Epi<BN, ACT, SW_FIRST, OutT>;
  const Epi epi{(const float*)sa, (const float*)sw, (const float*)bias, (const OutT*)res,
                (OutT*)c, M, N};
  return pg_launch<int8_t, BN, Epi::kBytes>(gemm_i8_kernel<BN, ACT, SW_FIRST, OutT>, a, w, M, N,
                                            K, grid, st, epi, K);
}

template <int BN, bool SW_FIRST, typename OutT>
cudaError_t launch_gemm_i8_act(int act, const void* a, const void* sa, const void* w,
                               const void* sw, const void* bias, const void* res, void* c,
                               int M, int N, int K, int grid, cudaStream_t st) {
  switch (act) {
    case I8_ACT_NONE:
      return launch_gemm_i8<BN, I8_ACT_NONE, SW_FIRST, OutT>(a, sa, w, sw, bias, res, c, M, N,
                                                             K, grid, st);
    case I8_ACT_GELU:
      return launch_gemm_i8<BN, I8_ACT_GELU, SW_FIRST, OutT>(a, sa, w, sw, bias, res, c, M, N,
                                                             K, grid, st);
    case I8_ACT_GELU_ERF:  // written in f32 only
      if constexpr (std::is_same<OutT, float>::value)
        return launch_gemm_i8<BN, I8_ACT_GELU_ERF, SW_FIRST, OutT>(a, sa, w, sw, bias, res, c,
                                                                  M, N, K, grid, st);
      else
        return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool SW_FIRST>
cudaError_t launch_gemm_i8_bn(int bn, int act, int f32, const void* a, const void* sa,
                              const void* w, const void* sw, const void* bias, const void* res,
                              void* c, int M, int N, int K, int grid, cudaStream_t st) {
  if (f32)  // #12 on f32: one tile width
    return bn == 144 ? launch_gemm_i8_act<144, SW_FIRST, float>(act, a, sa, w, sw, bias, res, c,
                                                                M, N, K, grid, st)
                     : cudaErrorInvalidValue;
  if (bn == 144)
    return launch_gemm_i8_act<144, SW_FIRST, bf16>(act, a, sa, w, sw, bias, res, c, M, N, K,
                                                   grid, st);
  if (bn == 192)
    return launch_gemm_i8_act<192, SW_FIRST, bf16>(act, a, sa, w, sw, bias, res, c, M, N, K,
                                                   grid, st);
  return cudaErrorInvalidValue;
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

// act: 0 none, 1 tanh GELU, 2 erf GELU (f32 only); sw_first: the dequant
// order (see the header); f32: the output and the residual are f32 (else
// bf16); `bn` (144, or 192 for a bf16 output) and `grid` from
// kernels.gemm_plan.
int sp_gemm_i8(const void* a, const void* sa, const void* w, const void* sw, const void* bias,
               const void* res, void* c, int M, int N, int K, int act, int sw_first, int f32,
               int bn, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(sw_first ? spk::launch_gemm_i8_bn<true>(bn, act, f32, a, sa, w, sw, bias, res, c,
                                                       M, N, K, grid, st)
                        : spk::launch_gemm_i8_bn<false>(bn, act, f32, a, sa, w, sw, bias, res,
                                                        c, M, N, K, grid, st));
}

}  // extern "C"
