// Whole non-pooling Hiera block on Hopper, as a short chain of launches:
//
//   h1 = LN1(x)                       sp_layernorm
//   qkv = h1 Wqkv^T + b               sp_gemm
//   a  = window/global attention(qkv) sp_window_attention
//   u  = x + (a Wproj^T + b)          sp_gemm, residual epilogue
//   h2 = LN2(u)                       sp_layernorm
//   z  = gelu_tanh(h2 Wfc1^T + b)     sp_gemm, GELU on the f32 pre-activation
//   y  = u + (z Wfc2^T + b)           sp_gemm, residual epilogue
//
// Replaces the TPU whole-block kernels spegnet_tpu/ops/fused_block_t.py
// `_kernel` (:349, transposed [B, C, N] layout, stages 1-3) and
// spegnet_tpu/ops/fused_block.py `_kernel` (:99, token-major, stage 4).  One
// CTA cannot hold a stage-3 window's activations (256 x 576 bf16 = 295 KB)
// or a global block's K/V, so the block is split at the GEMMs; what the TPU
// kernel kept out of HBM inside attention (the [L, L] scores) stays on chip
// here too (attention.cuh).  Activations are token-major [tokens, C] in
// Morton order, so every window is L consecutive rows and needs no packing
// or mask.  Weights stay in the unpadded nn.Linear layout [N, K].
//
// Bound on the H100: the four GEMMs carry ~93% of the block's FLOPs.  At
// stages 3-4 (K >= 576) they are compute bound and run on TMA + wgmma; at
// stages 1-2 (K = 144 / 288, M up to 131072 rows at batch 8) the output
// write dominates and the epilogue is staged for coalesced 16-byte stores.
#include "attention.cuh"

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

constexpr int WG_BM = 128, WG_BK = 64;
enum { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_PRE = 2, ACT_GELU_GRAD = 3 };
constexpr int GEMM_STAGES = 4;

template <int NACC>
__device__ __forceinline__ void fence_regs(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// C[M, N] = A[M, K] W[N, K]^T (+ bias[N]), then by ACT:
//   ACT_NONE:      (+ residual[M, N])
//   ACT_GELU:      gelu_tanh of the f32 sum (+ residual)
//   ACT_GELU_PRE:  C = the pre-activation, aux = gelu_tanh(it), both rounded
//                  from the same f32 sum (the backward's recompute of fc1;
//                  C is stored from the accumulators, uncoalesced)
//   ACT_GELU_GRAD: C = bf16(sum) * gelu_tanh'(res), res holding the
//                  pre-activation (dz = dg * gelu'(z) of the block backward)
// Rounding follows the TPU kernel: the f32 sum (+ bias, -> GELU) is rounded
// to bf16, and the residual add is a bf16 + bf16 sum rounded once more.
//
// A 128 x BN block tile on Hopper's warpgroup MMA, warp-specialized:
// warpgroup 0 is the producer (one thread issues the TMA loads of each
// 64-deep k step, 128-byte swizzled, into a STAGES-deep ring of full/empty
// mbarriers); warpgroups 1 and 2 consume it, 64 rows each, with four
// wgmma.m64nBNk16 per k step, keep one step's MMAs in flight and release a
// stage once the MMAs that read it have completed.  No block-wide barrier
// runs in the main loop.  TMA zero-fills the M, N and K tails.  Requires
// K % 8 == 0 and N % 8 == 0 (16-byte rows).
template <int BN, int STAGES, int ACT>
__global__ void __launch_bounds__(384, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                const bf16* __restrict__ bias, const bf16* __restrict__ res,
                bf16* __restrict__ C, bf16* __restrict__ aux, int M, int N, int K) {
  constexpr int NACC = BN / 2;
  constexpr int TILE_A = WG_BM * WG_BK, STAGE = (WG_BM + BN) * WG_BK;
  constexpr uint32_t STAGE_BYTES = STAGE * 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const long m0 = (long)blockIdx.y * WG_BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        bf16* As = base + s * STAGE;
        tma_load_2d(As, &tmA, &full[s], kt * WG_BK, (int)m0);
        tma_load_2d(As + TILE_A, &tmB, &full[s], kt * WG_BK, n0);
      }
    }
    return;
  }

  const int cw = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  float d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) d[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const bf16* As = base + s * STAGE;
    const bf16* Bs = As + TILE_A;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_m64k16(d, wgmma_desc_sw128(As + cw * 64 * WG_BK + kk * 16),
                   wgmma_desc_sw128(Bs + kk * 16));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(d);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(d);

  // Epilogue: bias (+ GELU) rounded into this warpgroup's own staging tile,
  // then the residual add (or the GELU-gradient product) and the store on
  // coalesced 16-byte rows.  ACT_GELU_PRE first stores the pre-activation
  // straight from the accumulators into C, then stages its GELU for aux.
  const int rl = w * 16 + g;
  if (ACT == ACT_GELU_PRE) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
      const float b0 = bias ? bf(bias[col]) : 0.f, b1 = bias ? bf(bias[col + 1]) : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = m0 + cw * 64 + rl + 8 * hh;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(C + row * N + col) =
              __floats2bfloat162_rn(d[4 * j + 2 * hh] + b0, d[4 * j + 2 * hh + 1] + b1);
      }
    }
  }
  constexpr bool gelu = ACT == ACT_GELU || ACT == ACT_GELU_PRE;
  bf16* dst = ACT == ACT_GELU_PRE ? aux : C;
  constexpr int P = BN + 8;  // staging pitch (elements), 16-byte rows
  bf16* Cs = reinterpret_cast<bf16*>(empty + STAGES) + cw * 64 * P;
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
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(Cs + (rl + 8 * hh) * P + cl) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  const int ct = tid % 128;
  for (int idx = ct; idx < 64 * (BN / 8); idx += 128) {
    const int r = idx / (BN / 8), c = idx % (BN / 8);
    const long row = m0 + cw * 64 + r;
    const int col = n0 + c * 8;
    if (row >= M || col >= N) continue;
    uint4 v = *reinterpret_cast<const uint4*>(Cs + r * P + c * 8);
    if (res) {
      uint4 rv = *reinterpret_cast<const uint4*>(res + row * N + col);
      if (ACT == ACT_GELU_GRAD) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          lanes(v)[e] = to_bf(bf(lanes(v)[e]) * gelu_tanh_grad(bf(lanes(rv)[e])));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) lanes(v)[e] = to_bf(bf(lanes(rv)[e]) + bf(lanes(v)[e]));
      }
    }
    *reinterpret_cast<uint4*>(dst + row * N + col) = v;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor map of a row-major [rows, K] bf16 matrix read in boxes of
// box_rows x 64 with the 128-byte swizzle (the layout wgmma_desc_sw128 reads).
cudaError_t make_tmap(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                            reinterpret_cast<void**>(&encode),
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !encode)
      return e != cudaSuccess ? e : cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, int STAGES, int ACT>
cudaError_t launch_tma_gemm(const void* a, const void* w, const void* bias, const void* res,
                            void* c, void* aux, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t e = make_tmap(&ta, a, M, K, WG_BM);
  if (e == cudaSuccess) e = make_tmap(&tb, w, N, K, BN);
  if (e != cudaSuccess) return e;
  const int smem = STAGES * (WG_BM + BN) * WG_BK * 2 + 2 * STAGES * 8 + WG_BM * (BN + 8) * 2 +
                   1024;
  cudaFuncSetAttribute(gemm_tma_kernel<BN, STAGES, ACT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + BN - 1) / BN, (M + WG_BM - 1) / WG_BM);
  gemm_tma_kernel<BN, STAGES, ACT><<<grid, 384, smem, stream>>>(
      ta, tb, (const bf16*)bias, (const bf16*)res, (bf16*)c, (bf16*)aux, M, N, K);
  return cudaGetLastError();
}

template <int BN>
int gemm_act(const void* a, const void* w, const void* bias, const void* res, void* c,
             void* aux, int M, int N, int K, int act, cudaStream_t st) {
  switch (act) {
    case ACT_NONE:
      return (int)launch_tma_gemm<BN, GEMM_STAGES, ACT_NONE>(a, w, bias, res, c, aux, M, N, K, st);
    case ACT_GELU:
      return (int)launch_tma_gemm<BN, GEMM_STAGES, ACT_GELU>(a, w, bias, res, c, aux, M, N, K, st);
    case ACT_GELU_PRE:
      return (int)launch_tma_gemm<BN, GEMM_STAGES, ACT_GELU_PRE>(a, w, bias, res, c, aux, M, N,
                                                                 K, st);
    case ACT_GELU_GRAD:
      return (int)launch_tma_gemm<BN, GEMM_STAGES, ACT_GELU_GRAD>(a, w, bias, res, c, aux, M, N,
                                                                  K, st);
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

// The N tile (128 or 192) is the one that pads N least; ties go to 192.
// `act` as gemm_tma_kernel's ACT; aux is written only by ACT_GELU_PRE.
int sp_gemm(const void* a, const void* w, const void* bias, const void* res, void* c,
            void* aux, int M, int N, int K, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int pad128 = (N + 127) / 128 * 128, pad192 = (N + 191) / 192 * 192;
  if (pad128 < pad192) return spk::gemm_act<128>(a, w, bias, res, c, aux, M, N, K, act, st);
  return spk::gemm_act<192>(a, w, bias, res, c, aux, M, N, K, act, st);
}

// lse (nullable): [rows, heads] f32 log-sum-exp of each row's scores.
int sp_window_attention(const void* qkv, void* out, void* lse, int rows, int ld, int heads,
                        int D, int L, float scale, void* stream) {
  return (int)spk::launch_attention<false>((const bf16*)qkv, (bf16*)out, (float*)lse, rows,
                                            ld, heads, D, L, L, scale, (cudaStream_t)stream);
}

}  // extern "C"
