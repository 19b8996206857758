// Persistent, warp-specialised TMA + wgmma GEMM for Hopper, shared by the
// bf16 GEMM of hiera_block.cu (T-block #1 / #2, the fronts #3, the gen-1
// block #7 and every dX product of the backwards), the int8 GEMM of
// int8_gemm.cu (#10, #11, #12) and, in its 3xTF32 form (pg_gemm_3xtf32,
// below), the f32 GEMM of block_f32.cu (#7 at f32): C[M, N] = A[M, K]
// W[N, K]^T with both operands row-major, i.e. K-major, the one layout
// wgmma takes for 8-bit and tf32 operands.
//
// Schedule.  The grid is min(tiles, SMs) (kernels.gemm_plan); block b walks
// the 128 x BN output tiles b, b + gridDim.x, ... in an N-fastest order, so
// the blocks in flight share A's rows.  Warpgroup 0 is the producer: one
// thread issues the TMA loads of every k-step of every tile of the block
// into a STAGES-deep ring of full / empty mbarriers, running ahead across
// tile boundaries (one step counter for the block's whole walk carries the
// phase bits).  Warpgroups 1 and 2 consume it, rows 0-63 and 64-127 of each
// tile, with four wgmma per k-step (m64nBNk16 on bf16, m64nBNk32 on s8: a
// k-step is one 128-byte swizzle row of each operand row, 64 bf16 or 128
// int8 codes), one step's MMAs in flight, and release a stage once the MMAs
// that read it have retired.  The f32 (bf16) or s32 (int8) sum of every
// output runs over K in k order, so two calls give the same bits.  Each
// consumer then hands its accumulators to the caller's epilogue with a
// staging buffer of its own, outside the ring: while the epilogue rounds,
// stages and stores, the producer already fills the ring with the next
// tile's k-steps.  TMA zero-fills the M, N and K tails.
//
// Bound: at the T-block's stage-3 products (K 576) a tile's k-loop is ~4 us
// of MMA at an SM's share of the bf16 rate, and its epilogue writes 128 x BN
// outputs (and reads as many residuals, prefetched here by cp.async while
// the k-loop runs).  The one-tile-per-block kernels this replaces read each
// residual vector just before its store, padded N = 432 / 144 / 288 with
// 128 / 192 tiles and left N = 576 at 1.45 waves of 132 SMs (the int8 one
// ran mma.sync).  The plan picks BN 144 (every Hiera width is a multiple of
// 144) or 192 per product from the wave count; the bf16 products of width
// 192 without a residual go to gemm_handoff.cuh instead, whose epilogue runs
// beside the next tile's wgmma (kernels.gemm_plan).  The feed of operand tiles from L2 (~65 GB/s per SM
// measured, PERF.md) holds the k-loop near 60% of the bf16 rate.
#pragma once

#include "wgmma_attn.cuh"

namespace spk {

constexpr int PG_BM = 128;           // output rows per tile
constexpr int PG_ROW = 128;          // bytes of one operand row per k-step
constexpr int PG_THREADS = 384;      // producer + two consumer warpgroups
constexpr int PG_SMEM_MAX = 232448;  // dynamic shared memory a block may take
constexpr int PG_MAX_STAGES = 6;
// The producer issues TMA loads only; a consumer holds up to 96 accumulators
// and the epilogue's values.
constexpr int PG_PRODUCER_REGS = 40, PG_CONSUMER_REGS = 232;

// wgmma forms beyond common.cuh's (m64n128k16 / m64n192k16 bf16): bf16 at N
// 144, s8 x s8 -> s32 at N 144 and 192.  Accumulator layout as common.cuh's.

__device__ __forceinline__ void wgmma_m64k16(float (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64k32(int (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64k32(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <typename T>
struct PgOp;

template <>
struct PgOp<bf16> {
  using Acc = float;
  static constexpr int kBK = 64;  // elements per k-step
  static constexpr CUtensorMapDataType kTmap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int NACC>
  __device__ __forceinline__ static void mma(float (&d)[NACC], uint64_t da, uint64_t db) {
    wgmma_m64k16(d, da, db);
  }
};

template <>
struct PgOp<int8_t> {
  using Acc = int;
  static constexpr int kBK = 128;
  static constexpr CUtensorMapDataType kTmap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  template <int NACC>
  __device__ __forceinline__ static void mma(int (&d)[NACC], uint64_t da, uint64_t db) {
    wgmma_s8_m64k32(d, da, db);
  }
};

// f32 operands (pg_gemm_3xtf32): 32 per 128-byte k-step; only pg_tmap reads
// this.
template <>
struct PgOp<float> {
  static constexpr int kBK = 32;
  static constexpr CUtensorMapDataType kTmap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// Shared memory: the ring (STAGES x (128 + BN) rows of 128 bytes), then the
// two consumers' staging buffers (EPI bytes each), then the barriers.
template <int BN, int EPI>
struct PgCfg {
  static constexpr int kStage = (PG_BM + BN) * PG_ROW;
  static constexpr int kFit = (PG_SMEM_MAX - 1024 - 2 * EPI - 2 * PG_MAX_STAGES * 8) / kStage;
  static constexpr int ST = kFit > PG_MAX_STAGES ? PG_MAX_STAGES : kFit;
  static constexpr int kBytes = 1024 + ST * kStage + 2 * EPI + 2 * ST * 8;
  static_assert(ST >= 3 && kBytes <= PG_SMEM_MAX, "shared memory");
  static_assert(EPI % 1024 == 0, "staging buffers keep the barriers 8-byte aligned");
};

// The kernel body: Epi supplies kBytes (its staging bytes per consumer, a
// multiple of 1024), prefetch(first row of the consumer's 64, n0, staging
// buffer, consumer), which the consumer's 128 threads run before the tile's
// k-loop (pg_prefetch_tile: the residual tile into the staging buffer by
// cp.async, so its loads overlap the k-loop), and operator()(acc, the same),
// which they run after it.
template <typename T, int BN, class Epi>
__device__ __forceinline__ void pg_gemm(const CUtensorMap* tmA, const CUtensorMap* tmB, int M,
                                        int N, int K, const Epi& epi) {
  using Op = PgOp<T>;
  using Cfg = PgCfg<BN, Epi::kBytes>;
  constexpr int ST = Cfg::ST, NACC = BN / 2;
  constexpr uint32_t STAGE = Cfg::kStage;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = base + ST * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * Epi::kBytes);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n_tiles = (N + BN - 1) / BN;
  const long tiles = (long)n_tiles * ((M + PG_BM - 1) / PG_BM);
  const int nk = (K + Op::kBK - 1) / Op::kBK;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PG_PRODUCER_REGS>();
    if (tid != 0) return;
    long it = 0;  // k-steps issued by this block, across its tiles
    for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (int)(tile / n_tiles) * PG_BM, n0 = (int)(tile % n_tiles) * BN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = (int)(it % ST);
        if (it >= ST) mbar_wait(&empty[s], (int)((it / ST - 1) & 1));
        unsigned char* st = base + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_2d(st, tmA, &full[s], kt * Op::kBK, m0);
        tma_load_2d(st + PG_BM * PG_ROW, tmB, &full[s], kt * Op::kBK, n0);
      }
    }
    return;
  }

  setmaxnreg_inc<PG_CONSUMER_REGS>();
  const int cw = wg - 1;
  unsigned char* my_staging = staging + cw * Epi::kBytes;
  long it = 0;  // k-steps consumed by this block, across its tiles
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (int)(tile / n_tiles) * PG_BM, n0 = (int)(tile % n_tiles) * BN;
    epi.prefetch(m0 + cw * 64, n0, my_staging, cw);
    typename Op::Acc d[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) d[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = (int)(it % ST);
      mbar_wait(&full[s], (int)((it / ST) & 1));
      const unsigned char* As = base + s * STAGE + cw * 64 * PG_ROW;
      const unsigned char* Bs = base + s * STAGE + PG_BM * PG_ROW;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Op::mma(d, wgmma_desc_sw128(As + kk * 32), wgmma_desc_sw128(Bs + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0) mbar_arrive(&empty[(int)((it - 1) % ST)]);
    }
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(&empty[(int)((it - 1) % ST)]);
    epi(d, m0 + cw * 64, n0, my_staging, cw);
  }
}

// Epilogue helper: waits until the consumer's threads are done with the
// staging buffer (the previous tile's stores), then copies the 64 x BN tile
// of `res` at (mrow0, n0) (elements of OutT, row pitch P) into it with
// cp.async, zero-filled past M and N, without waiting for it.
template <int BN, int P, typename OutT>
__device__ __forceinline__ void pg_prefetch_tile(const OutT* res, int M, int N, int mrow0, int n0,
                                                 unsigned char* stage, int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (!res) return;
  constexpr int VE = 16 / sizeof(OutT);
  OutT* Cs = reinterpret_cast<OutT*>(stage);
  for (int idx = threadIdx.x % 128; idx < 64 * (BN / VE); idx += 128) {
    const int r = idx / (BN / VE), c = idx % (BN / VE);
    const long row = mrow0 + r;
    const int col = n0 + c * VE;
    const bool in = row < M && col < N;
    cp_async16(Cs + r * P + c * VE, in ? res + row * N + col : res, in ? 16 : 0);
  }
  cp_async_commit();
}

// Epilogue helper: the prefetched residual tile is in the staging buffer.
__device__ __forceinline__ void pg_prefetch_wait(int cw) {
  cp_async_wait<0>();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

// Tensor map of a row-major [rows, K] matrix of T read in boxes of box_rows
// rows x one 128-byte k-step, 128-byte swizzled (wgmma_desc_sw128's layout),
// zero-filled past its edges.
template <typename T>
cudaError_t pg_tmap(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)PgOp<T>::kBK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, PgOp<T>::kTmap, 2, const_cast<void*>(ptr), dims, strides, box,
                            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// pg_tmap through a cache of the last 16 maps of this host thread, keyed by
// (pointer, shape): a forward hands a launcher the same few operands again
// and again (the caching allocator reuses its blocks), and encoding a map
// is host time on every call.  A map depends on nothing but its key.
template <typename T>
cudaError_t pg_tmap_cached(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  struct Key {
    const void* ptr;
    int rows, K, box_rows;
  };
  constexpr int N = 16;
  thread_local Key keys[N] = {};
  thread_local CUtensorMap maps[N];
  thread_local int next = 0;
  for (int i = 0; i < N; ++i) {
    const Key& k = keys[i];
    if (k.ptr == ptr && k.rows == rows && k.K == K && k.box_rows == box_rows) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const cudaError_t e = pg_tmap<T>(map, ptr, rows, K, box_rows);
  if (e == cudaSuccess) {
    keys[next] = Key{ptr, rows, K, box_rows};
    maps[next] = *map;
    next = (next + 1) % N;
  }
  return e;
}

// Launches kernel<<<grid, 384>>>(tmA, tmB, args...) with the shared memory
// of PgCfg<BN, EPI>, after building A's and W's tensor maps.
template <typename T, int BN, int EPI, typename Kernel, typename... Args>
cudaError_t pg_launch(Kernel kernel, const void* a, const void* w, int M, int N, int K, int grid,
                      cudaStream_t stream, Args... args) {
  CUtensorMap ta, tb;
  cudaError_t e = pg_tmap<T>(&ta, a, M, K, PG_BM);
  if (e == cudaSuccess) e = pg_tmap<T>(&tb, w, N, K, BN);
  if (e != cudaSuccess) return e;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  constexpr int smem = PgCfg<BN, EPI>::kBytes;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, PG_THREADS, smem, stream>>>(ta, tb, args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The 3xTF32 form: f32 operands, f32-accurate products (block_f32.cu)
// ---------------------------------------------------------------------------
//
// The schedule above (grid-strided 128 x BN tiles walked N-fastest, one
// producer thread issuing every k-step of the block's walk into a ring of
// full / empty mbarriers across tile boundaries, two consumer warpgroups of
// 64 rows, an epilogue staged outside the ring with its residual prefetched
// before the k-loop) on f32 operands: a k-step is one 128-byte swizzle row
// of 32 f32, and every product is 3xTF32: v = big + small, big = v
// truncated to tf32 and small = the rest rounded to tf32 (common.cuh
// `tf32_small`); a b ~ big_a big_b + big_a small_b + small_a big_b.  The
// tensor cores read only an operand's top 19 bits, so an f32 value is its
// own big part, and each operand element is split once:
// * W by the producer warpgroup's warps 1-3, once per stage after its TMA
//   lands: the tile TMA wrote is W's big part, and they write its small
//   part in a plane beside it, in the same swizzled K-major layout wgmma
//   reads (tf32 wgmma takes B K-major only, which W[N, K] row-major is);
//   they then arrive on the stage's `ready` barrier;
// * A by each consumer, which reads its 64 rows of the stage once into
//   registers as the big (the raw values) and small A fragments of
//   WgmmaTf32RS (the layout of an mma.m16n8k8 tf32 A fragment), so A needs
//   no second plane.
// Per k-step a consumer issues 12 wgmma m64nBNk8 (small * big for the four
// k8 slices, then big * small, then big * big), the first with scale-d 0:
// the step's 32-deep sum starts from zero on the tensor cores, and the
// consumer adds it to its running f32 accumulators on the FP32 pipe, k-step
// by k-step in k order.  The tensor cores' own accumulation truncates: an
// f32 kernel that summed the whole K on them read 3.3e-5 of the output
// against the 2e-5 limit on an H100; over 32-deep steps the error stays at
// the level of f32 sums.
// The sum over K runs in one fixed order, so two calls give the same bits.
//
// Budget at BN 144: a stage is A (16 KB) + W big + W small (18 KB each);
// three stages and two 64 x 72 f32 staging halves fit the 227 KB.  A
// consumer holds 72 running and 72 fresh accumulators and 32 A-fragment
// registers of a k-step (PG_CONSUMER_REGS: at 224 the k-loop spilled); BN
// 192 would need 96 + 96 + 32 and a 64 KB stage, so it is not built.

constexpr int PG_SPLIT = 96;  // producer warps 1-3: the W split pass

// Shared memory: the ring (STAGES x [A | W big | W small]), the two
// consumers' staging buffers (EPI bytes each), then the full, ready and
// empty barriers.
template <int BN, int EPI>
struct PgTf32Cfg {
  static constexpr uint32_t kA = PG_BM * PG_ROW;  // the A box of a stage
  static constexpr uint32_t kW = BN * PG_ROW;     // one W plane
  static constexpr uint32_t kTx = kA + kW;        // the bytes TMA writes to a stage
  static constexpr uint32_t kStage = kA + 2 * kW;
  static constexpr int kFit =
      (PG_SMEM_MAX - 1024 - 2 * EPI - 3 * PG_MAX_STAGES * 8) / (int)kStage;
  static constexpr int ST = kFit > PG_MAX_STAGES ? PG_MAX_STAGES : kFit;
  static constexpr int kBytes = 1024 + ST * (int)kStage + 2 * EPI + 3 * ST * 8;
  static_assert(ST >= 3 && kBytes <= PG_SMEM_MAX, "shared memory");
  static_assert(kW % 1024 == 0 && EPI % 1024 == 0, "1024-byte aligned planes and barriers");
};

// The kernel body on f32 operands; Epi as pg_gemm's, its operator() taking
// float (&)[BN / 2].
template <int BN, class Epi>
__device__ __forceinline__ void pg_gemm_3xtf32(const CUtensorMap* tmA, const CUtensorMap* tmB,
                                               int M, int N, int K, const Epi& epi) {
  using Cfg = PgTf32Cfg<BN, Epi::kBytes>;
  constexpr int ST = Cfg::ST, NACC = BN / 2;
  constexpr uint32_t STAGE = Cfg::kStage, KA = Cfg::kA, KW = Cfg::kW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = base + ST * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * Epi::kBytes);
  uint64_t* ready = full + ST;
  uint64_t* empty = ready + ST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n_tiles = (N + BN - 1) / BN;
  const long tiles = (long)n_tiles * ((M + PG_BM - 1) / PG_BM);
  const int nk = (K + 31) / 32;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], PG_SPLIT);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PG_PRODUCER_REGS>();
    if (tid == 0) {
      long it = 0;  // k-steps issued by this block, across its tiles
      for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (int)(tile / n_tiles) * PG_BM, n0 = (int)(tile % n_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = (int)(it % ST);
          if (it >= ST) mbar_wait(&empty[s], (int)((it / ST - 1) & 1));
          unsigned char* st = base + s * STAGE;
          mbar_arrive_expect_tx(&full[s], Cfg::kTx);
          tma_load_2d(st, tmA, &full[s], kt * 32, m0);
          tma_load_2d(st + KA, tmB, &full[s], kt * 32, n0);
        }
      }
    } else if (tid >= 32) {
      // The split pass of every stage, in the loads' order: the small part
      // of each 16-byte chunk of the W tile, at the same offset of the plane
      // after it (the swizzle maps both alike).
      const int sid = tid - 32;
      long it = 0;
      for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = (int)(it % ST);
          mbar_wait(&full[s], (int)((it / ST) & 1));
          unsigned char* wt = base + s * STAGE + KA;
          for (int u = sid; u < BN * 8; u += PG_SPLIT) {
            const float4 v = *reinterpret_cast<const float4*>(wt + u * 16);
            *reinterpret_cast<uint4*>(wt + KW + u * 16) =
                make_uint4(tf32_small(v.x), tf32_small(v.y), tf32_small(v.z), tf32_small(v.w));
          }
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
    }
    return;
  }

  setmaxnreg_inc<PG_CONSUMER_REGS>();
  const int cw = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // This thread's A rows in the stage's box (r0 and r0 + 8; r0 % 8 == g).
  const int r0 = cw * 64 + 16 * w + g;
  unsigned char* my_staging = staging + cw * Epi::kBytes;
  long it = 0;  // k-steps consumed by this block, across its tiles
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (int)(tile / n_tiles) * PG_BM, n0 = (int)(tile % n_tiles) * BN;
    epi.prefetch(m0 + cw * 64, n0, my_staging, cw);
    float d[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) d[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = (int)(it % ST), par = (int)((it / ST) & 1);
      const unsigned char* st = base + s * STAGE;
      mbar_wait(&full[s], par);
      // A fragments of the four k8 slices: (row r0 / r0 + 8, k 8kk + t /
      // 8kk + t + 4), read from the 128-byte swizzled box: big the value,
      // small its rest.
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e & 1) * 8, chunk = 2 * kk + (e >> 1);
          const float v =
              *reinterpret_cast<const float*>(st + r * PG_ROW + ((chunk ^ g) << 4) + 4 * t);
          ab[kk][e] = __float_as_uint(v);
          as[kk][e] = tf32_small(v);
        }
      mbar_wait(&ready[s], par);
      const unsigned char* wb = st + KA;
      float f[NACC];  // the step's sum, fresh: the first wgmma ignores it
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32RS<BN>::run(f, as[kk], wgmma_desc_sw128(wb + kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32RS<BN>::run(f, ab[kk], wgmma_desc_sw128(wb + KW + kk * 32), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32RS<BN>::run(f, ab[kk], wgmma_desc_sw128(wb + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(f);
      fence_frag(ab);
      fence_frag(as);
      // this thread's reads of A come before the TMA that refills the stage
      fence_proxy_async();
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) d[i] += f[i];
    }
    epi(d, m0 + cw * 64, n0, my_staging, cw);
  }
}

}  // namespace spk
