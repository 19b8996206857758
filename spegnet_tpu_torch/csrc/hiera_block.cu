// Whole non-pooling Hiera block on Hopper, as a short chain of launches:
//
//   h1 = LN1(x)                       sp_layernorm
//   qkv = h1 Wqkv^T + b               sp_gemm
//   a  = window/global attention(qkv) sp_window_attention (attention_window.cu)
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
// gemm_tma_kernel, one tile per block, measured faster there.
#include "gemm_persistent.cuh"

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
//   ACT_GELU:      gelu_tanh of the f32 sum (+ residual)
//   ACT_GELU_PRE:  C = the pre-activation, aux = gelu_tanh(it), both rounded
//                  from the same f32 sum (the backward's recompute of fc1;
//                  C is stored from the accumulators, uncoalesced)
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
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
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

constexpr int WG_BM = 128, WG_BK = 64;
constexpr int GEMM_STAGES = 4;

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
// One 128 x BN output tile per block (grid = tiles), kept beside the
// persistent GEMM for the bf16 products whose epilogue reads no residual at
// BN 192 (fc1 with its GELU, the fronts' stacked qkv + shortcut), where it
// measured 3-15% faster on an H100 (PERF.md, utils/gemm_bench.py); its sums
// and roundings are the persistent kernel's, bit for bit.
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
  // One grid axis: N tiles fastest, so the blocks in flight share A's rows
  // (the order a (N tiles, M tiles) grid gives), with no 65535 cap on M tiles.
  const int n_tiles = (N + BN - 1) / BN;
  const long m0 = (long)(blockIdx.x / n_tiles) * WG_BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
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
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_m64k16(d, wgmma_desc_sw128(As + cw * 64 * WG_BK + kk * 16),
                   wgmma_desc_sw128(Bs + kk * 16));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(d);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(d);

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

// Tensor map of a row-major [rows, K] bf16 matrix read in boxes of
// box_rows x 64 with the 128-byte swizzle (the layout wgmma_desc_sw128 reads).
cudaError_t make_tmap(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
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
cudaError_t launch_tile_gemm(const void* a, const void* w, const void* bias, const void* res,
                            void* c, void* aux, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t e = make_tmap(&ta, a, M, K, WG_BM);
  if (e == cudaSuccess) e = make_tmap(&tb, w, N, K, BN);
  if (e != cudaSuccess) return e;
  const int smem = STAGES * (WG_BM + BN) * WG_BK * 2 + 2 * STAGES * 8 + WG_BM * (BN + 8) * 2 +
                   1024;
  cudaFuncSetAttribute(gemm_tma_kernel<BN, STAGES, ACT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long blocks = (long)((N + BN - 1) / BN) * ((M + WG_BM - 1) / WG_BM);
  if (blocks >= (1L << 31)) return cudaErrorInvalidConfiguration;
  gemm_tma_kernel<BN, STAGES, ACT><<<(unsigned)blocks, 384, smem, stream>>>(
      ta, tb, (const bf16*)bias, (const bf16*)res, (bf16*)c, (bf16*)aux, M, N, K);
  return cudaGetLastError();
}

// The one-tile-per-block kernel at BN 192 for the epilogues without a
// residual (see gemm_tma_kernel).
int gemm_tile_act(const void* a, const void* w, const void* bias, void* c, void* aux, int M,
                  int N, int K, int act, cudaStream_t st) {
  switch (act) {
    case ACT_NONE:
      return (int)launch_tile_gemm<192, GEMM_STAGES, ACT_NONE>(a, w, bias, nullptr, c, aux, M, N,
                                                               K, st);
    case ACT_GELU:
      return (int)launch_tile_gemm<192, GEMM_STAGES, ACT_GELU>(a, w, bias, nullptr, c, aux, M, N,
                                                               K, st);
    case ACT_GELU_PRE:
      return (int)launch_tile_gemm<192, GEMM_STAGES, ACT_GELU_PRE>(a, w, bias, nullptr, c, aux, M,
                                                                   N, K, st);
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

// `bn` (144 or 192), `grid` and `one_tile` (gemm_tma_kernel, one tile per
// block, BN 192, no residual) from kernels.gemm_plan; `act` as Bf16Epi's
// ACT; aux is written only by ACT_GELU_PRE.
int sp_gemm(const void* a, const void* w, const void* bias, const void* res, void* c,
            void* aux, int M, int N, int K, int act, int bn, int grid, int one_tile,
            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (one_tile)
    return bn == 192 && !res ? spk::gemm_tile_act(a, w, bias, c, aux, M, N, K, act, st)
                             : (int)cudaErrorInvalidValue;
  if (bn == 144) return spk::gemm_act<144>(a, w, bias, res, c, aux, M, N, K, act, grid, st);
  if (bn == 192) return spk::gemm_act<192>(a, w, bias, res, c, aux, M, N, K, act, grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
