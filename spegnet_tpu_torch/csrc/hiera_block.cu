// Whole non-pooling Hiera block on Hopper, as a short chain of launches:
//
//   h1 = LN1(x)                       sp_layernorm
//   qkv = h1 Wqkv^T + b               sp_gemm
//   a  = window/global attention(qkv) sp_window_attention (attention_window.cu)
//   u  = x + (a Wproj^T + b)          sp_gemm, residual epilogue
//   h2 = LN2(u)                       sp_layernorm
//   z  = gelu_tanh_sfu(h2 Wfc1^T + b) sp_gemm, GELU on the f32 pre-activation
//   y  = u + (z Wfc2^T + b)           sp_gemm, residual epilogue
//
// Replaces the TPU whole-block kernels spegnet_tpu/ops/fused_block_t.py
// `_kernel` (:349, transposed [B, C, N] layout, stages 1-3) and
// spegnet_tpu/ops/fused_block.py `_kernel` (:99, token-major, stage 4).  One
// CTA cannot hold a stage-3 window's activations (256 x 576 bf16 = 295 KB)
// or a global block's K/V, so the block is split at the GEMMs; what the TPU
// kernel kept out of HBM inside attention (the [L, L] scores) stays on chip
// here too (attention_window.cu).  Activations are token-major [tokens, C] in
// Morton order, so every window is L consecutive rows and needs no packing
// or mask.  Weights stay in the unpadded nn.Linear layout [N, K].
//
// Bound on the H100: the four GEMMs carry ~93% of the block's FLOPs.  At
// stages 3-4 (K >= 576) they are compute bound; at stages 1-2 (K = 144 /
// 288, M up to 131072 rows at batch 8) the output write dominates.  They
// run on the persistent TMA + wgmma GEMM of gemm_persistent.cuh, whose
// epilogue (staged for coalesced 16-byte stores) overlaps the next tile's
// loads, or, for fc1 and the fronts' products (width 192, no residual), on
// the hand-off GEMM of gemm_handoff.cuh, whose epilogue warps run the
// GELU beside the next tile's wgmma.
#include "gemm_handoff.cuh"

namespace spk {
namespace {

constexpr int LN_WARPS = 8;

// One warp per row, f32 statistics (mean, then centred variance), eps as
// given; output rounded to bf16 as the TPU kernel's `_ln_sub` does.
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, bf16* __restrict__ y, long rows,
                 int C, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * LN_WARPS + warp;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += bf(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = bf(xr[c]) - mu;
    v += d * d;
  }
  const float r = rsqrtf(warp_sum(v) / C + eps);
  bf16* yr = y + row * C;
  for (int c = lane; c < C; c += 32) yr[c] = to_bf((bf(xr[c]) - mu) * r * w[c] + b[c]);
}

enum { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_PRE = 2, ACT_GELU_GRAD = 3 };

// The bf16 GEMM's epilogue on one consumer's 64 x BN tile of f32 sums
// (gemm_persistent.cuh): C = sum (+ bias[N]), then by ACT:
//   ACT_NONE:      (+ residual[M, N])
//   ACT_GELU:      gelu_tanh_sfu of the f32 sum (+ residual)
//   ACT_GELU_PRE:  C = the pre-activation, aux = gelu_tanh_sfu(it), both
//                  rounded from the same f32 sum (the backward's recompute of
//                  fc1; C is stored from the accumulators, uncoalesced)
//   ACT_GELU_GRAD: C = bf16(sum) * gelu_tanh'(res), res holding the
//                  pre-activation (dz = dg * gelu'(z) of the block backward)
// Rounding follows the TPU kernel: the f32 sum (+ bias, -> GELU) is rounded
// to bf16, and the residual add is a bf16 + bf16 sum rounded once more.
// The residual tile waits in the consumer's staging tile (prefetched by
// cp.async before the k-loop); each output pair is finished against it in
// place, then the tile goes out on coalesced 16-byte rows.  Requires
// N % 8 == 0.
template <int BN, int ACT>
struct Bf16Epi {
  static constexpr int P = BN + 8;  // staging pitch (elements), 16-byte rows
  static constexpr int kBytes = (64 * P * 2 + 1023) / 1024 * 1024;
  const bf16* bias;
  const bf16* res;
  bf16* C;
  bf16* aux;
  int M, N;

  __device__ __forceinline__ void prefetch(int mrow0, int n0, unsigned char* stage,
                                           int cw) const {
    pg_prefetch_tile<BN, P>(res, M, N, mrow0, n0, stage, cw);
  }

  __device__ __forceinline__ void operator()(float (&d)[BN / 2], int mrow0, int n0,
                                             unsigned char* stage, int cw) const {
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rl = w * 16 + g;
    if (ACT == ACT_GELU_PRE) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        if (col >= N) continue;
        const float b0 = bias ? bf(bias[col]) : 0.f, b1 = bias ? bf(bias[col + 1]) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long row = mrow0 + rl + 8 * hh;
          if (row < M)
            *reinterpret_cast<__nv_bfloat162*>(C + row * N + col) =
                __floats2bfloat162_rn(d[4 * j + 2 * hh] + b0, d[4 * j + 2 * hh + 1] + b1);
        }
      }
    }
    constexpr bool gelu = ACT == ACT_GELU || ACT == ACT_GELU_PRE;
    bf16* dst = ACT == ACT_GELU_PRE ? aux : C;
    bf16* Cs = reinterpret_cast<bf16*>(stage);
    if (res) pg_prefetch_wait(cw);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = j * 8 + 2 * t;
      const int col = n0 + cl;
      const float b0 = (bias && col < N) ? bf(bias[col]) : 0.f;
      const float b1 = (bias && col < N) ? bf(bias[col + 1]) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v0 = d[4 * j + 2 * hh] + b0, v1 = d[4 * j + 2 * hh + 1] + b1;
        if (gelu) {
          v0 = gelu_tanh_sfu(v0);
          v1 = gelu_tanh_sfu(v1);
        }
        __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(Cs + (rl + 8 * hh) * P + cl);
        __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
        if (res) {
          const __nv_bfloat162 r = *slot;
          if (ACT == ACT_GELU_GRAD)
            out = __floats2bfloat162_rn(__low2float(out) * gelu_tanh_grad(__low2float(r)),
                                        __high2float(out) * gelu_tanh_grad(__high2float(r)));
          else
            out = __floats2bfloat162_rn(__low2float(r) + __low2float(out),
                                        __high2float(r) + __high2float(out));
        }
        *slot = out;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    for (int idx = tid; idx < 64 * (BN / 8); idx += 128) {
      const int r = idx / (BN / 8), c = idx % (BN / 8);
      const long row = mrow0 + r;
      const int col = n0 + c * 8;
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(dst + row * N + col) =
            *reinterpret_cast<const uint4*>(Cs + r * P + c * 8);
    }
  }
};

// C[M, N] = A[M, K] W[N, K]^T with Bf16Epi<BN, ACT>: the persistent GEMM of
// gemm_persistent.cuh on bf16 operands.  Requires K % 8 == 0 and N % 8 == 0
// (16-byte rows).
template <int BN, int ACT>
__global__ void __launch_bounds__(PG_THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                 Bf16Epi<BN, ACT> epi, int K) {
  pg_gemm<bf16, BN>(&tmA, &tmB, epi.M, epi.N, K, epi);
}

template <int BN, int ACT>
cudaError_t launch_gemm(const void* a, const void* w, const void* bias, const void* res, void* c,
                        void* aux, int M, int N, int K, int grid, cudaStream_t st) {
  const Bf16Epi<BN, ACT> epi{(const bf16*)bias, (const bf16*)res, (bf16*)c, (bf16*)aux, M, N};
  return pg_launch<bf16, BN, Bf16Epi<BN, ACT>::kBytes>(gemm_bf16_kernel<BN, ACT>, a, w, M, N, K,
                                                        grid, st, epi, K);
}

// The hand-off GEMM's epilogue (gemm_handoff.cuh) on a row pair of a 64 x
// 192 hand-off buffer of f32 sums, for the epilogues without a residual: C
// = sum (+ bias[N]), then by ACT: ACT_NONE that, ACT_GELU gelu_tanh_sfu of it,
// ACT_GELU_PRE both (C the pre-activation, aux its GELU), each rounded once
// to bf16 from the same f32 value, as Bf16Epi rounds.  Lane l takes the
// float4 chunks 32j + l (j < 3) of the pair's 96: one 128-byte line per 8
// lanes, and 8 bytes of output a lane.  Requires N % 8 == 0.
template <int ACT>
struct Bf16HoEpi {
  const bf16* bias;
  bf16* C;
  bf16* aux;
  int M, N;

  __device__ __forceinline__ void bias_of(int n0, int lane, float (&bv)[3][4]) const {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int col = n0 + 4 * ((32 * j + lane) % HO_CHUNKS);
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[j][e] = (bias && col < N) ? bf(bias[col + e]) : 0.f;
    }
  }

  __device__ __forceinline__ void store(bf16* dst, long row, int col, const float (&v)[4]) const {
    *reinterpret_cast<uint2*>(dst + row * N + col) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }

  __device__ __forceinline__ void operator()(const float* hb, int q, int lane,
                                             const float (&bv)[3][4], long mrow0,
                                             int n0) const {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int flat = 32 * j + lane, c = flat % HO_CHUNKS;
      const int rl = 2 * q + flat / HO_CHUNKS;
      const float4 h = *reinterpret_cast<const float4*>(hb + rl * HO_P + 4 * c);
      float v[4] = {h.x + bv[j][0], h.y + bv[j][1], h.z + bv[j][2], h.w + bv[j][3]};
      const long row = mrow0 + rl;
      const int col = n0 + 4 * c;
      const bool in = row < M && col < N;
      if (ACT == ACT_GELU_PRE && in) store(C, row, col, v);
      if (ACT == ACT_GELU || ACT == ACT_GELU_PRE) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = gelu_tanh_sfu(v[e]);
      }
      if (in) store(ACT == ACT_GELU_PRE ? aux : C, row, col, v);
    }
  }
};

// C[M, N] = A[M, K] W[N, K]^T with Bf16HoEpi<ACT>, BN 192
// (gemm_handoff.cuh).  Requires K % 8 == 0 and N % 8 == 0.
template <int ACT>
__global__ void __launch_bounds__(HO_THREADS, 1)
gemm_handoff_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB, Bf16HoEpi<ACT> epi, int K) {
  ho_gemm(&tmA, &tmB, epi.M, epi.N, K, epi);
}

template <int ACT>
cudaError_t launch_handoff(const void* a, const void* w, const void* bias, void* c, void* aux,
                           int M, int N, int K, int grid, cudaStream_t st) {
  const Bf16HoEpi<ACT> epi{(const bf16*)bias, (bf16*)c, (bf16*)aux, M, N};
  return ho_launch(gemm_handoff_kernel<ACT>, a, w, M, N, K, grid, st, epi, K);
}

int gemm_handoff(const void* a, const void* w, const void* bias, void* c, void* aux, int M,
                 int N, int K, int act, int grid, cudaStream_t st) {
  switch (act) {
    case ACT_NONE:
      return (int)launch_handoff<ACT_NONE>(a, w, bias, c, aux, M, N, K, grid, st);
    case ACT_GELU:
      return (int)launch_handoff<ACT_GELU>(a, w, bias, c, aux, M, N, K, grid, st);
    case ACT_GELU_PRE:
      return (int)launch_handoff<ACT_GELU_PRE>(a, w, bias, c, aux, M, N, K, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int BN>
int gemm_act(const void* a, const void* w, const void* bias, const void* res, void* c,
             void* aux, int M, int N, int K, int act, int grid, cudaStream_t st) {
  switch (act) {
    case ACT_NONE:
      return (int)launch_gemm<BN, ACT_NONE>(a, w, bias, res, c, aux, M, N, K, grid, st);
    case ACT_GELU:
      return (int)launch_gemm<BN, ACT_GELU>(a, w, bias, res, c, aux, M, N, K, grid, st);
    case ACT_GELU_PRE:
      return (int)launch_gemm<BN, ACT_GELU_PRE>(a, w, bias, res, c, aux, M, N, K, grid, st);
    case ACT_GELU_GRAD:
      return (int)launch_gemm<BN, ACT_GELU_GRAD>(a, w, bias, res, c, aux, M, N, K, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

const char* sp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int sp_layernorm(const void* x, const void* w, const void* b, void* y, long rows,
                 int C, float eps, void* stream) {
  const unsigned grid = (unsigned)((rows + spk::LN_WARPS - 1) / spk::LN_WARPS);
  spk::layernorm_kernel<<<grid, spk::LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)w, (const float*)b, (bf16*)y, rows, C, eps);
  return (int)cudaGetLastError();
}

// `bn` (144 or 192), `grid` and `handoff` from kernels.gemm_plan: 0 the
// persistent kernel (gemm_persistent.cuh), 1 the hand-off kernel
// (gemm_handoff.cuh: BN 192, no residual); `act` as Bf16Epi's ACT; aux is
// written only by ACT_GELU_PRE.
int sp_gemm(const void* a, const void* w, const void* bias, const void* res, void* c,
            void* aux, int M, int N, int K, int act, int bn, int grid, int handoff,
            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (handoff)
    return bn == 192 && !res ? spk::gemm_handoff(a, w, bias, c, aux, M, N, K, act, grid, st)
                             : (int)cudaErrorInvalidValue;
  if (bn == 144) return spk::gemm_act<144>(a, w, bias, res, c, aux, M, N, K, act, grid, st);
  if (bn == 192) return spk::gemm_act<192>(a, w, bias, res, c, aux, M, N, K, act, grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
