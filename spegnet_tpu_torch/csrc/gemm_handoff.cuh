// Persistent, warp-specialised TMA + wgmma GEMM whose epilogue runs on
// warps of its own, beside the next tile's wgmma: the bf16 products of
// width 192 without a residual (fc1 + tanh GELU of the T-block #1 / #2 and
// the gen-1 block #7, fc1's GELU-pre in the backward's recompute, the
// transition fronts' stacked qkv + shortcut product #3), C[M, N] = A[M, K]
// W[N, K]^T with both operands row-major (K-major).  It replaces, inside
// the TPU whole-block kernels spegnet_tpu/ops/fused_block_t.py `_kernel`
// (:339-344, fc1 and its GELU) and spegnet_tpu/ops/fused_block.py `_kernel`
// (:142-145), the matmul + GELU that JAX's kernel keeps in VMEM.
//
// Bound on the H100: stage 3's fc1 (M 8192, N 2304, K 576) is compute bound
// (a 128 x 192 tile's MMA is ~3.8 us at an SM's share of the bf16 rate);
// stages 1-2 (K 144 / 288) and the fronts are bound by the output's bytes.
// Every output also costs its epilogue (bias, GELU, rounding, store): in
// the persistent frame of gemm_persistent.cuh the warpgroups that issue
// wgmma run it, and the tensor cores wait for it.  Here they do not:
//
// * Warp 15, one thread (the producer): the TMA loads of every k-step of
//   the block's walk into a ring of HO_STAGES stages (full / empty
//   mbarriers), across tile boundaries on one step counter, as pg_gemm
//   does.
// * Warpgroups 0 and 1 (the MMA warpgroups): rows 0-63 / 64-127 of each
//   128 x 192 tile, four wgmma m64n192k16 per 64-deep k-step, one step in
//   flight, each warp releasing a stage once its MMAs that read it retired.
//   At the end of a tile each writes its 96 f32 sums per thread into a
//   hand-off buffer of its own (64 x HO_P f32; float2 stores, no bank
//   conflict at pitch 200), arrives on its `hfull` barrier and starts the
//   next tile's k-loop at once.
// * Warps 8-14 (the epilogue warps), for each tile and each of the two
//   buffers in turn: wait on its `hfull`, take row pairs e, e + 7, ... of
//   its 32, read them as float4 rows (8 lanes one 128-byte line), add the
//   bias, apply the epilogue (the GELU of the f32 sum), round to bf16 and
//   store 8 bytes a lane (a warp 256 contiguous bytes), then arrive on its
//   `hempty`, which that MMA warpgroup waits on before its next hand-off.
// A tile then costs max(k-loop + hand-off, epilogue), not their sum.
//
// Registers: ptxas compiles every warp to the launch's limit (setmaxnreg
// does not raise it: a 640-thread form, 96 registers, could not compile the
// m64n192 wgmma, which needs 122), so the block is 16 warps at 128
// registers, and the epilogue gets the 7 warps that fit beside the MMA
// warpgroups and the producer (PERF.md: 4 epilogue warps took 3.64 ms per
// 512^2 forward where 7 took 3.39, both with tanhf).
//
// The sums are the persistent kernel's: f32 over K in 64-deep k-steps in k
// order on the same wgmma shape, so every output is bit-equal to the
// persistent kernel's (and the one-tile kernel's this replaced), and two
// calls give the same bits.
// Shared memory: 3 stages of 40 KB and two 50 KB hand-off buffers (226 KB).
#pragma once

#include "gemm_persistent.cuh"

namespace spk {

constexpr int HO_BN = 192;              // output columns per tile
constexpr int HO_EPI_WARPS = 7;         // warps 8-14
constexpr int HO_THREADS = 32 * (8 + HO_EPI_WARPS + 1);  // MMA, epilogue, producer warps
constexpr int HO_STAGES = 3;
constexpr int HO_P = HO_BN + 8;         // hand-off buffer pitch (floats)
constexpr int HO_HALF = 64 * HO_P * 4;  // one MMA warpgroup's hand-off buffer (bytes)
constexpr int HO_CHUNKS = HO_BN / 4;    // float4 chunks of a hand-off row
constexpr int HO_A = PG_BM * PG_ROW;             // a stage's A box
constexpr int HO_STAGE = HO_A + HO_BN * PG_ROW;  // A and W boxes of one k-step
constexpr int HO_SMEM = 1024 + HO_STAGES * HO_STAGE + 2 * HO_HALF + (2 * HO_STAGES + 4) * 8;
static_assert(HO_SMEM <= PG_SMEM_MAX, "shared memory");

// mbar_wait that traps after ~2^24 polls, so a protocol fault fails the
// launch instead of hanging the card.
__device__ __forceinline__ void ho_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (int n = 0; !done; ++n) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (n > (1 << 24)) __trap();
  }
}

// The kernel body.  Epi's bias_of(n0, lane, bias) reads a lane's bias for
// a tile; its operator()(hand-off buffer, row pair q, lane, bias, first
// output row of the buffer, n0) is run by an epilogue warp on rows 2q and
// 2q + 1 of a 64 x HO_BN buffer of sums (pitch HO_P): lane l takes the
// float4 chunks 32j + l (j < 3) of the pair's 96.  Block b takes the tiles
// b, b + gridDim.x, ... (N fastest).
template <class Epi>
__device__ __forceinline__ void ho_gemm(const CUtensorMap* tmA, const CUtensorMap* tmB, int M,
                                        int N, int K, const Epi& epi) {
  constexpr int ST = HO_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* hand = reinterpret_cast<float*>(base + ST * HO_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ST * HO_STAGE + 2 * HO_HALF);
  uint64_t* empty = full + ST;
  uint64_t* hfull = empty + ST;  // one per MMA warpgroup
  uint64_t* hempty = hfull + 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (N + HO_BN - 1) / HO_BN;
  const int tiles = (M + PG_BM - 1) / PG_BM * n_tiles;
  const int nk = (K + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // each MMA warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&hfull[i], 128);
      mbar_init(&hempty[i], 32 * HO_EPI_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8 + HO_EPI_WARPS) {
    if (lane != 0) return;
    int s = 0, ph = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * PG_BM, n0 = tile % n_tiles * HO_BN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        if (it >= ST) ho_wait(&empty[s], ph ^ 1);
        unsigned char* st = base + s * HO_STAGE;
        mbar_arrive_expect_tx(&full[s], HO_STAGE);
        tma_load_2d(st, tmA, &full[s], kt * 64, m0);
        tma_load_2d(st + HO_A, tmB, &full[s], kt * 64, n0);
        if (++s == ST) s = 0, ph ^= 1;
      }
    }
    return;
  }

  if (warp < 8) {
    const int cw = warp / 4, w = warp % 4;
    // this thread's first sum in the buffer: row 16w + g, column 2t
    float* hb = hand + cw * 64 * HO_P + (16 * w + (lane >> 2)) * HO_P + 2 * (lane & 3);
    int s = 0, ph = 0, prev = 0, t = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++t) {
      float d[HO_BN / 2];
#pragma unroll
      for (int i = 0; i < HO_BN / 2; ++i) d[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        ho_wait(&full[s], ph);
        const unsigned char* As = base + s * HO_STAGE + cw * 64 * PG_ROW;
        const unsigned char* Bs = base + s * HO_STAGE + HO_A;
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64k16(d, wgmma_desc_sw128(As + kk * 32), wgmma_desc_sw128(Bs + kk * 32));
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(d);
        // the warp's MMAs that read the previous stage have retired
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == ST) s = 0, ph ^= 1;
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(&empty[prev]);
      if (t > 0) ho_wait(&hempty[cw], (t - 1) & 1);
#pragma unroll
      for (int j = 0; j < HO_BN / 8; ++j) {
        *reinterpret_cast<float2*>(hb + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(hb + 8 * HO_P + 8 * j) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
      mbar_arrive(&hfull[cw]);
    }
    return;
  }

  const int ew = warp - 8;
  int t = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++t) {
    const int mt = tile / n_tiles, n0 = tile % n_tiles * HO_BN;
    float bv[3][4];  // the bias of this lane's chunks, read before the wait
    epi.bias_of(n0, lane, bv);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const float* hb = hand + h * 64 * HO_P;
      const long mrow0 = (long)mt * PG_BM + h * 64;
      ho_wait(&hfull[h], t & 1);
#pragma unroll 2
      for (int q = ew; q < 32; q += HO_EPI_WARPS) epi(hb, q, lane, bv, mrow0, n0);
      mbar_arrive(&hempty[h]);
    }
  }
}

// Launches kernel<<<grid, HO_THREADS>>>(tmA, tmB, args...) after building
// A's and W's tensor maps.
template <typename Kernel, typename... Args>
cudaError_t ho_launch(Kernel kernel, const void* a, const void* w, int M, int N, int K, int grid,
                      cudaStream_t stream, Args... args) {
  CUtensorMap ta, tb;
  cudaError_t e = pg_tmap<bf16>(&ta, a, M, K, PG_BM);
  if (e == cudaSuccess) e = pg_tmap<bf16>(&tb, w, N, K, HO_BN);
  if (e != cudaSuccess) return e;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HO_SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, HO_THREADS, HO_SMEM, stream>>>(ta, tb, args...);
  return cudaGetLastError();
}

}  // namespace spk
