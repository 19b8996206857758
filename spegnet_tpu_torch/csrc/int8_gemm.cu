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
  __device__ __forceinline__ static void set(Vec& v, int e, float y) { lanes(v)[e] = to_bf(y); }
  __device__ __forceinline__ static Vec zero() { return zero_vec8(); }
};

template <>
struct Act<float> {
  static constexpr int kVec = 4;
  using Vec = float4;
  __device__ __forceinline__ static float get(Vec& v, int e) {
    return reinterpret_cast<float*>(&v)[e];
  }
  __device__ __forceinline__ static float keep(float v) { return v; }
  __device__ __forceinline__ static void set(Vec& v, int e, float y) {
    reinterpret_cast<float*>(&v)[e] = y;
  }
  __device__ __forceinline__ static Vec zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
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

// y = keep((x - mu) * r * w + b), each step rounded as the unfused f32
// expression.
template <typename T>
__device__ __forceinline__ float ln_val(float x, float mu, float r, float w, float b) {
  return Act<T>::keep(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), r), w), b));
}

// ---------------------------------------------------------------------------
// LayerNorm + quant: one pass over the row, shaped for latency
// ---------------------------------------------------------------------------
//
// The call moves few bytes (a stage-3 call of a 512^2 batch-8 forward reads
// 9.4 MB and writes 4.7 MB, ~4 us at the HBM rate), so its time is the
// latency of a row's chain of reductions, not bandwidth.  A group of G =
// 2^lg lanes serves a row: lane j holds the row's 16-byte vectors j, j + G,
// ... (at most NV) in registers, read from HBM once and coalesced across the
// group; the mean, the variance, the absmax and the codes all come from
// those registers, each reduction a shuffle tree inside the group (offsets
// G/2 .. 1, every lane getting the same bits), so no pass goes back to
// memory.  A warp serves 32 / G rows at once; each group walks its rows
// grid-strided with the next row's loads issued before the current row's
// reductions, so two rows per group are in flight.  The LayerNorm weight
// and bias of the lane's columns are loaded once into registers and reused
// for every row (WREG); the wide form, for rows longer than 32 NV vectors
// of the narrow one, reads them per row from L1 instead and loads one row
// at a time (its row alone fills the registers).  The codes leave as one
// packed store per vector (8 bytes for bf16), and each group's scale by its
// lane 0, the warp's groups holding consecutive rows.
// kernels.layernorm_q8_plan picks G (the fewest lanes that hold a row in NV
// vectors each) and the form; the grid is the card's resident blocks (SMs x
// occupancy), no more blocks than rows need.
//
// Arithmetic, each step rounded: the lane's sum of its elements in vector
// order, then the group's tree; mu = sum / C; the variance the same over
// (x - mu)^2 (no FMA contraction); r = rsqrtf(var / C + eps); y = ln_val,
// kept in place of x (bf16: rounded to bf16, as the block keeps it); s =
// max(absmax * f32(1/127), 1e-12); codes rint(y * (1 / s)), ties to even.
// tests/test_torch_layernorm_q8.py emulates it on the CPU.
constexpr int LQ_THREADS = 128;

// Sum / max over the G = 2^lg lanes of an aligned group.
__device__ __forceinline__ float group_sum(float v, int lg) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < (1 << lg)) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_max(float v, int lg) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < (1 << lg)) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VE f32 values at src (16-byte aligned) by float4 loads, or zeros.
template <int VE>
__device__ __forceinline__ void load_f32(float (&dst)[VE], const float* src, bool in) {
#pragma unroll
  for (int e = 0; e < VE; e += 4) {
    const float4 v =
        in ? *reinterpret_cast<const float4*>(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[e] = v.x;
    dst[e + 1] = v.y;
    dst[e + 2] = v.z;
    dst[e + 3] = v.w;
  }
}

// C % kVec == 0 and C / kVec <= NV << lg.
template <typename T, int NV, bool WREG>
__global__ void __launch_bounds__(LQ_THREADS)
layernorm_q8_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, int8_t* __restrict__ q,
                    float* __restrict__ scale, long rows, int C, int lg, float eps) {
  using A = Act<T>;
  constexpr int VE = A::kVec;
  using Vec = typename A::Vec;
  const int G = 1 << lg, j = threadIdx.x & (G - 1);
  const int nvec = C / VE;
  const float fc = (float)C;
  const long per_block = LQ_THREADS >> lg;  // rows a block serves at once
  const long stride = per_block * gridDim.x;
  long row = (long)blockIdx.x * per_block + (threadIdx.x >> lg);
  // the warp's first row: the loop runs while it is a row, so the whole
  // warp takes part in every shuffle (a group past the last row computes on
  // zeros and stores nothing)
  long wrow = (long)blockIdx.x * per_block + ((threadIdx.x >> 5) << (5 - lg));

  float wr[WREG ? NV : 1][VE], br[WREG ? NV : 1][VE];
  if constexpr (WREG) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int cv = j + G * i;
      const bool in = cv < nvec;
      load_f32<VE>(wr[i], w + (in ? cv * VE : 0), in);
      load_f32<VE>(br[i], b + (in ? cv * VE : 0), in);
    }
  }
  auto load_row = [&](Vec(&v)[NV], long r) {
    const T* xr = x + (r < rows ? r : 0) * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int cv = j + G * i;
      v[i] = (r < rows && cv < nvec) ? *reinterpret_cast<const Vec*>(xr + cv * VE) : A::zero();
    }
  };

  Vec cur[NV], nxt[NV];
  if constexpr (WREG) load_row(cur, row);
  for (; wrow < rows; wrow += stride, row += stride) {
    if constexpr (WREG)
      load_row(nxt, row + stride);
    else
      load_row(cur, row);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VE; ++e) s = __fadd_rn(s, A::get(cur[i], e));
    const float mu = __fdiv_rn(group_sum(s, lg), fc);
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (j + G * i < nvec)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const float d = __fsub_rn(A::get(cur[i], e), mu);
          var = __fadd_rn(var, __fmul_rn(d, d));
        }
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(group_sum(var, lg), fc), eps));
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int cv = j + G * i;
      float wv[VE], bv[VE];
      if constexpr (WREG) {
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          wv[e] = wr[i][e];
          bv[e] = br[i][e];
        }
      } else {
        load_f32<VE>(wv, w + (cv < nvec ? cv * VE : 0), cv < nvec);
        load_f32<VE>(bv, b + (cv < nvec ? cv * VE : 0), cv < nvec);
      }
      // past the row: x, w and b are 0, so y is 0 and leaves amax alone
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float y = ln_val<T>(A::get(cur[i], e), mu, r, wv[e], bv[e]);
        A::set(cur[i], e, y);
        amax = fmaxf(amax, fabsf(y));
      }
    }
    const float sc = q_scale(group_max(amax, lg));
    const float inv = 1.0f / sc;
    if (row < rows) {
      int8_t* qr = q + row * C;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int cv = j + G * i;
        if (cv < nvec) {
          float y[VE];
#pragma unroll
          for (int e = 0; e < VE; ++e) y[e] = A::get(cur[i], e);
          q_store(qr + cv * VE, y, inv);
        }
      }
      if (j == 0) scale[row] = sc;
    }
    if constexpr (WREG) {
#pragma unroll
      for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
    }
  }
}

// The grid: the card's resident blocks of this instantiation (SMs x
// occupancy, looked up once), no more than the rows need.
template <typename T, int NV, bool WREG>
cudaError_t launch_layernorm_q8(const void* x, const void* w, const void* b, void* q,
                                void* scale, long rows, int C, int lg, float eps,
                                cudaStream_t st) {
  static const long resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layernorm_q8_kernel<T, NV, WREG>,
                                                  LQ_THREADS, 0);
    return (long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  if (lg < 0 || lg > 5 || C % Act<T>::kVec || C / Act<T>::kVec > (NV << lg))
    return cudaErrorInvalidValue;
  if (rows < 1) return cudaSuccess;
  const long per_block = LQ_THREADS >> lg;
  const long need = (rows + per_block - 1) / per_block;
  const int grid = (int)(need < resident ? need : resident);
  layernorm_q8_kernel<T, NV, WREG><<<grid, LQ_THREADS, 0, st>>>(
      (const T*)x, (const float*)w, (const float*)b, (int8_t*)q, (float*)scale, rows, C, lg,
      eps);
  return cudaGetLastError();
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

// f32: x is f32 (else bf16); 2^lg lanes per row, nv vectors per lane (the
// narrow form's 5 in bf16 / 9 in f32, or the wide form's 16 / 12), from
// kernels.layernorm_q8_plan.
int sp_layernorm_q8(const void* x, const void* w, const void* b, void* q, void* scale,
                    long rows, int C, float eps, int f32, int lg, int nv, void* stream) {
  using namespace spk;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32 && nv == 9)
    return (int)launch_layernorm_q8<float, 9, true>(x, w, b, q, scale, rows, C, lg, eps, st);
  if (f32 && nv == 12)
    return (int)launch_layernorm_q8<float, 12, false>(x, w, b, q, scale, rows, C, lg, eps, st);
  if (!f32 && nv == 5)
    return (int)launch_layernorm_q8<bf16, 5, true>(x, w, b, q, scale, rows, C, lg, eps, st);
  if (!f32 && nv == 16)
    return (int)launch_layernorm_q8<bf16, 16, false>(x, w, b, q, scale, rows, C, lg, eps, st);
  return (int)cudaErrorInvalidValue;
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
