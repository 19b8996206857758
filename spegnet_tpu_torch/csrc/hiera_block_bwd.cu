// Backward of the whole non-pooling Hiera block on Hopper, as a chain of
// launches that recomputes the forward from the block input (the kernels of
// hiera_block.cu, with the attention's log-sum-exp and fc1's pre-activation
// kept) and then runs, on Morton token-major rows (M = B * N):
//
//   dW2 = dOut^T g, db2            sp_gemm_tn (split over M, column sums)
//   dz  = (dOut W2) * gelu'(z)     sp_gemm, ACT_GELU_GRAD epilogue
//   dW1 = dz^T h2, db1             sp_gemm_tn
//   dh2 = dz W1                    sp_gemm
//   du  = dOut + LN2'(dh2)         sp_layernorm_bwd (+ dln2 weight / bias)
//   dWproj = du^T a, dbproj        sp_gemm_tn
//   da  = du Wproj                 sp_gemm
//   dqkv = attention'(da)          sp_attention_bwd (attention_window_bwd.cu)
//   dWqkv = dqkv^T h1, dbqkv       sp_gemm_tn
//   dh1 = dqkv Wqkv                sp_gemm
//   dx  = du + LN1'(dh1)           sp_layernorm_bwd (+ dln1 weight / bias)
//
// Replaces the TPU backward kernel spegnet_tpu/ops/fused_block_t.py
// `_bwd_kernel` (:1165, entry `_backward` :1363), which recomputed the
// forward and produced dx and the 12 weight gradients of one attention
// chunk inside VMEM, accumulating the weight gradients across the
// sequential grid.  Hopper's blocks run in parallel and in no order, so
// every cross-row sum here (weight, bias and LayerNorm-parameter gradients)
// is written as per-split f32 partials and summed by a second pass in a
// fixed order: the result does not change from run to run.  dX = dY W
// products reuse the forward's TMA + wgmma GEMM on weights transposed once
// per call by the caller.
//
// Bound on the H100: like the forward, the GEMMs carry most of the FLOPs
// (the backward runs ~2x the forward's GEMM work plus its recompute).  The
// weight-gradient GEMMs have small outputs (432 x 144 at stage 1) over
// contractions of up to 131072 rows, so they split M to fill the card.
#include "wgmma_attn.cuh"

namespace spk {
namespace {

// ---------------------------------------------------------------------------
// Weight-gradient GEMM: part[s][n][k] = sum_{m in split s} A[m][n] B[m][k]
// and cspart[s][n] = sum_{m in split s} A[m][n] (the bias gradient), for
// row-major A [M, N] and B [M, K] bf16, f32 sums.  The contraction runs over
// the rows of both operands, so both are read "transposed": wgmma takes A' =
// A^T (64 output rows n x 16 rows m) and B (16 rows m x TK columns k) from
// shared memory MN-major (n, respectively k, contiguous: the rows TMA loads),
// with the transpose bits of bf16 wgmma.  One producer thread streams
// 64-row slices of M through a ring of stages by TMA (A: 2 MT boxes of 64
// columns, B: TK / 64 boxes, 128-byte swizzle, zero-filled past M, N and
// K); two consumer warpgroups each own 64 MT output rows x TK columns of a
// 128 MT x TK tile and release a stage as soon as its wgmma group retires
// (holding one stage, not two, gives the loads a stage more of lead).
// The bias gradient is summed from the A tile in shared memory by the
// tiles of the first k-tile column: each thread 16 MT rows of two columns
// per slice, in order, then the row groups in order.  M is cut into splits to fill the card (kernels.gemm_tn_plan:
// the tile and split count of least estimated time, at most 8192 rows a
// split, since the tensor cores' accumulation truncates); each split writes
// its f32 partials and reduce_splits_kernel sums them in split order, so
// two calls give the same bits (one split writes the result itself).  N %
// 8 == 0, K % 8 == 0 (16-byte TMA strides).
//
// Bound on the H100: 2 M N K FLOPs against 2 M (N + K) bytes: bytes at the
// T-block's stages 1-2 (M 131072 / 32768 rows of 144 / 288 columns),
// operations at stage 3 and the global blocks.  On an H100 80GB HBM3 at
// 700 W a block reaches ~65% of an SM's share of the bf16 peak with 128-
// and 256-row tiles alike (PERF.md); what holds it there is not identified
// (no profiler counters on the card's machine).
// ---------------------------------------------------------------------------

constexpr int TN_BM = 64;          // rows of M per stage
constexpr int TN_THREADS = 384;    // producer + two consumer warpgroups
// The producer issues TMA loads only; a consumer holds up to 192
// accumulators (256-row tiles of 192 columns).
constexpr int TN_PRODUCER_REGS = 24, TN_CONSUMER_REGS = 240;
constexpr int TN_SMEM = 225 * 1024;
constexpr uint32_t TN_ATOM = TN_BM * 128;   // 64 rows x 64 bf16 columns

// A tile of 128 * MT output rows (MT 64-row blocks per consumer) x TK
// columns; a stage holds 2 * MT 64-column atoms of A and TK / 64 of B.
template <int TK, int MT>
struct TnCfg {
  static_assert(MT == 1 || (MT == 2 && TK <= 192), "accumulator registers");
  static constexpr int NB = (TK + 63) / 64;
  static constexpr uint32_t kA = 2 * MT * TN_ATOM;
  static constexpr uint32_t kStage = kA + NB * TN_ATOM;
  static constexpr int kCsum = 2 * 4 * 64 * 4;   // [consumer][warp][64] f32
  static constexpr int ST_FIT = (TN_SMEM - kCsum) / (int)kStage;
  static constexpr int ST = ST_FIT > 6 ? 6 : ST_FIT;
  static constexpr int kBytes = ST * kStage + kCsum + 2 * ST * 8 + 1024;
  static_assert(ST >= 3 && kBytes <= 232448, "shared memory");
};

template <int TK, int MT>
__global__ void __launch_bounds__(TN_THREADS, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               int M, int N, int K, int n_tiles, int k_tiles, int m_split,
               float* __restrict__ part, float* __restrict__ cspart) {
  using C = TnCfg<TK, MT>;
  constexpr int ST = C::ST, BN = 128 * MT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* csum_s = reinterpret_cast<float*>(base + ST * C::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ST * C::kStage + C::kCsum);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int kt = blockIdx.x % k_tiles, nt = (blockIdx.x / k_tiles) % n_tiles;
  const int split = blockIdx.x / k_tiles / n_tiles;
  const int n0 = nt * BN, k0 = kt * TK;
  const int mb = split * m_split, me = min(M, mb + m_split);
  const int steps = (me - mb + TN_BM - 1) / TN_BM;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<TN_PRODUCER_REGS>();
    if (tid != 0) return;
    for (int i = 0; i < steps; ++i) {
      const int s = i % ST, m = mb + i * TN_BM;
      if (i >= ST) mbar_wait(&empty[s], ((i / ST) - 1) & 1);
      unsigned char* st = base + s * C::kStage;
      mbar_arrive_expect_tx(&full[s], C::kStage);
#pragma unroll
      for (int a = 0; a < 2 * MT; ++a) tma_load_2d(st + a * TN_ATOM, &ta, &full[s], n0 + 64 * a, m);
#pragma unroll
      for (int b = 0; b < C::NB; ++b)
        tma_load_2d(st + C::kA + b * TN_ATOM, &tb, &full[s], k0 + 64 * b, m);
    }
    return;
  }

  // Consumer c: output rows n0 + 128 c * MT ... (its MT atoms of A), warp w's
  // share of the column sums: atom w / (4 / MT), rows (w % (4 / MT)) * 16 MT
  // onward, columns 2 lane and 2 lane + 1.
  setmaxnreg_inc<TN_CONSUMER_REGS>();
  const int c = wg - 1, ctid = tid % 128, w = ctid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool colsum = kt == 0;
  const int cs_atom = w / (4 / MT), cs_row = (w % (4 / MT)) * 16 * MT;
  float acc[MT][TK / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) acc[i][e] = 0.f;
  float cs0 = 0.f, cs1 = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % ST;
    mbar_wait(&full[s], (i / ST) & 1);
    const unsigned char* a_t = base + s * C::kStage + c * MT * TN_ATOM;
    const unsigned char* b_t = base + s * C::kStage + C::kA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TN_BM / 16; ++kk)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        WgmmaSSTT<TK>::run(acc[j], wgmma_desc_sw128_mn(a_t + j * TN_ATOM + kk * 2048, TN_ATOM),
                           wgmma_desc_sw128_mn(b_t + kk * 2048, TN_ATOM), 1);
    wgmma_commit();
    if (colsum) {
      const unsigned char* at = a_t + cs_atom * TN_ATOM;
#pragma unroll
      for (int r = cs_row; r < cs_row + 16 * MT; ++r) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            at + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4);
        cs0 += __low2float(v);
        cs1 += __high2float(v);
      }
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[s]);
  }
  fence_acc(acc);

  float* out = part + (long)split * N * K;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const int k = k0 + 8 * j + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = n0 + 64 * (c * MT + i) + 16 * w + g + 8 * hh;
        if (n < N && k < K)
          *reinterpret_cast<float2*>(out + (long)n * K + k) =
              make_float2(acc[i][4 * j + 2 * hh], acc[i][4 * j + 2 * hh + 1]);
      }
    }
  if (colsum) {
    // The warps of an atom in order: rows of the atom in order.
    float* cs = csum_s + c * 4 * 64;
    cs[w * 64 + 2 * lane] = cs0;
    cs[w * 64 + 2 * lane + 1] = cs1;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    const int n = n0 + 64 * c * MT + ctid;
    if (ctid < 64 * MT && n < N) {
      const int a = ctid / 64, col = ctid % 64;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < 4 / MT; ++q) v += cs[(a * (4 / MT) + q) * 64 + col];
      cspart[(long)split * N + n] = v;
    }
  }
}

// Tensor map of a row-major [rows, cols] bf16 matrix read in boxes of 64
// rows x 64 columns with the 128-byte swizzle, zero-filled past its edges.
cudaError_t make_tn_tmap(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)TN_BM};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int TK, int MT>
cudaError_t launch_gemm_tn(const CUtensorMap& ta, const CUtensorMap& tb, int M, int N, int K,
                           int m_split, int splits, float* part, float* cspart,
                           cudaStream_t st) {
  constexpr int smem = TnCfg<TK, MT>::kBytes;
  static bool attr = false;  // the shared-memory attribute, set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tn_kernel<TK, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int n_tiles = (N + 128 * MT - 1) / (128 * MT), k_tiles = (K + TK - 1) / TK;
  const long blocks = (long)n_tiles * k_tiles * splits;
  if (blocks >= (1L << 31)) return cudaErrorInvalidConfiguration;
  gemm_tn_kernel<TK, MT><<<(unsigned)blocks, TN_THREADS, smem, st>>>(
      ta, tb, M, N, K, n_tiles, k_tiles, m_split, part, cspart);
  return cudaGetLastError();
}

// out[i] = sum_{s < splits} part[s * len + i], in order.
__global__ void reduce_splits_kernel(const float* __restrict__ part, int splits, long len,
                                     float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long)k * len + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// LayerNorm backward: one pass over the rows, each input read once
// ---------------------------------------------------------------------------
//
// dx = bf16(r (dy w - mean(dy w) - xhat mean(dy w xhat)) (+ dres)), dw =
// sum dy xhat and db = sum dy over the rows, in f32, for bf16 rows x, dy,
// dres of C = 8 nvec columns; xhat = (x - mu) r with the f32 statistics
// recomputed from x (mean, then the centred variance).  It is the
// backward of the forward's LayerNorm in the block backward's chains
// (LN1 / LN2 of #4-#7: spegnet_tpu/ops/fused_block_t.py `_ln_bwd`, :1141,
// inside `_bwd_kernel` :1165, `_qpool_bwd_kernel` :833, `_bwd_kernel_res`
// :1449 and fused_block.py's backward).
//
// Bound on the H100: bytes.  x, dy (and dres) are read and dx written once,
// 6-8 bytes an element, a few flops each.  A group of G = 2^lg lanes serves
// a row: lane j holds the row's 16-byte vectors j, j + G, ... (at most NV)
// of x, dy and dres in registers, read once with coalesced 16-byte loads,
// and every row reduction (the sum, the centred variance, the pair m1 / m2)
// is a shuffle tree inside the group, so no pass goes back to memory and no
// [rows] statistics buffer exists.  A CTA walks a contiguous strip of rows,
// its groups taking rows strip0 + group, + groups, ...; a group loads
// dres with x and dy, so that its load overlaps the row's reductions (a
// prefetch of the next row as well measured slower on an H100: its
// registers cost more occupancy than it hid latency).  Each lane keeps the
// f32 sums of dy xhat and dy of its columns over the strip in registers
// (the wide form, for rows past 32 x 5 vectors: in the warp's slice of
// shared memory, which only that lane touches); at the end of the strip
// the warp's groups are added by a shuffle tree (offsets 16 .. G), the
// warps in order through shared memory, and the CTA writes one [2C]
// partial row.  reduce_rows_kernel then adds the partial rows in a fixed
// order, 32 warps to a column (a column's ~512 partial rows walked by one
// thread, as reduce_splits_kernel does, was a large share of a call).  No
// atomics: two calls give the same bits.  The weight w (f32) is read per
// vector from L1.  kernels.layernorm_bwd_plan picks G, NV, the form and
// the strips.
//
// Arithmetic, each step rounded (no FMA contraction): the lane's sum of its
// elements in vector order, then the group's tree; mu = sum / C; the
// variance the same over (x - mu)^2; r = rsqrtf(var / C + eps); xhat = (x -
// mu) r; g = dy w; m1 = tree(sum g) / C, m2 = tree(sum g xhat) / C; dx =
// r ((g - m1) - xhat m2) (+ dres) rounded to bf16.  tests/test_torch_
// layernorm_bwd.py emulates it on the CPU.
constexpr int LB_THREADS = 128;
constexpr int LB_RWARPS = 32;  // reduce_rows_kernel: warps a block, 32 columns

__device__ __forceinline__ float lb_group_sum(float v, int lg) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < (1 << lg)) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The 8 f32 LayerNorm weights of vector cv.
__device__ __forceinline__ void lb_weights(float (&wv)[8], const float* __restrict__ w, int cv) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w + cv * 8));
  const float4 b = __ldg(reinterpret_cast<const float4*>(w + cv * 8 + 4));
  wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
  wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
}

// part [gridDim.x][2C]: the CTA's [dw; db] over its strip of r_strip rows.
// Shared memory: [4 warps][2C] f32.
template <int NV>
__global__ void __launch_bounds__(LB_THREADS)
layernorm_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                     const bf16* __restrict__ dy, const bf16* __restrict__ dres,
                     bf16* __restrict__ dx, float* __restrict__ part, long rows, int C, int lg,
                     long r_strip, float eps) {
  constexpr bool WIDE = NV > 5;
  extern __shared__ float red[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = 1 << lg, j = tid & (G - 1), group = tid >> lg, groups = LB_THREADS >> lg;
  const int nvec = C / 8;
  const float fc = (float)C;
  const long r0 = (long)blockIdx.x * r_strip, r1 = lmin(rows, r0 + r_strip);
  float* wred = red + warp * 2 * C;
  float adw[WIDE ? 1 : NV][8], adb[WIDE ? 1 : NV][8];
#pragma unroll
  for (int i = 0; i < (WIDE ? 1 : NV); ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) adw[i][e] = adb[i][e] = 0.f;
  if constexpr (WIDE) {
    // one group a warp (G 32): the lane's columns of the warp's slice are its own
    for (int i = 0; i < NV; ++i) {
      const int cv = j + G * i;
      if (cv < nvec)
#pragma unroll
        for (int e = 0; e < 8; ++e) wred[cv * 8 + e] = wred[C + cv * 8 + e] = 0.f;
    }
  }

  // every lane of a warp runs the same passes, so the whole warp takes part
  // in every shuffle (a group past the strip computes on zeros, stores and
  // sums nothing)
  for (long base = r0; base < r1; base += groups) {
    const long row = base + group;
    const bool live = row < r1;
    const long off = (live ? row : r0) * C;
    // x, dy and (the narrow form) dres of the row
    uint4 xv[NV], gv[NV], rv[WIDE ? 1 : NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int cv = j + G * i;
      const bool in = live && cv < nvec;
      xv[i] = in ? *reinterpret_cast<const uint4*>(x + off + cv * 8) : zero_vec8();
      gv[i] = in ? *reinterpret_cast<const uint4*>(dy + off + cv * 8) : zero_vec8();
      if constexpr (!WIDE)
        rv[i] = in && dres ? *reinterpret_cast<const uint4*>(dres + off + cv * 8) : zero_vec8();
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) s = __fadd_rn(s, bf(lanes(xv[i])[e]));
    const float mu = __fdiv_rn(lb_group_sum(s, lg), fc);
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (j + G * i < nvec)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __fsub_rn(bf(lanes(xv[i])[e]), mu);
          var = __fadd_rn(var, __fmul_rn(d, d));
        }
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(lb_group_sum(var, lg), fc), eps));
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int cv = j + G * i;
      if (cv < nvec) {
        float wv[8];
        lb_weights(wv, w, cv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = __fmul_rn(__fsub_rn(bf(lanes(xv[i])[e]), mu), r);
          const float g = __fmul_rn(bf(lanes(gv[i])[e]), wv[e]);
          m1 = __fadd_rn(m1, g);
          m2 = __fadd_rn(m2, __fmul_rn(g, xh));
        }
      }
    }
    m1 = __fdiv_rn(lb_group_sum(m1, lg), fc);
    m2 = __fdiv_rn(lb_group_sum(m2, lg), fc);
    if (live) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int cv = j + G * i;
        if (cv >= nvec) continue;
        float wv[8];
        lb_weights(wv, w, cv);
        uint4 rd = zero_vec8();
        if constexpr (WIDE) {
          if (dres) rd = *reinterpret_cast<const uint4*>(dres + off + cv * 8);
        } else {
          rd = rv[i];
        }
        uint4 o;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float gy = bf(lanes(gv[i])[e]);
          const float xh = __fmul_rn(__fsub_rn(bf(lanes(xv[i])[e]), mu), r);
          float v = __fmul_rn(r, __fsub_rn(__fsub_rn(__fmul_rn(gy, wv[e]), m1), __fmul_rn(xh, m2)));
          if (dres) v = __fadd_rn(v, bf(lanes(rd)[e]));
          lanes(o)[e] = to_bf(v);
          if constexpr (WIDE) {
            wred[cv * 8 + e] = __fadd_rn(wred[cv * 8 + e], __fmul_rn(gy, xh));
            wred[C + cv * 8 + e] = __fadd_rn(wred[C + cv * 8 + e], gy);
          } else {
            adw[i][e] = __fadd_rn(adw[i][e], __fmul_rn(gy, xh));
            adb[i][e] = __fadd_rn(adb[i][e], gy);
          }
        }
        *reinterpret_cast<uint4*>(dx + off + cv * 8) = o;
      }
    }
  }

  if constexpr (!WIDE) {
    // the warp's groups in a fixed tree (offsets 16 .. G), then its first
    // group writes the warp's sums
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          if (o >= G) {
            adw[i][e] = __fadd_rn(adw[i][e], __shfl_xor_sync(0xffffffffu, adw[i][e], o));
            adb[i][e] = __fadd_rn(adb[i][e], __shfl_xor_sync(0xffffffffu, adb[i][e], o));
          }
    if (lane < G)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int cv = j + G * i;
        if (cv < nvec)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            wred[cv * 8 + e] = adw[i][e];
            wred[C + cv * 8 + e] = adb[i][e];
          }
      }
  }
  __syncthreads();
  float* out = part + (long)blockIdx.x * 2 * C;
  for (int c = tid; c < 2 * C; c += LB_THREADS) {
    float v = red[c];
#pragma unroll
    for (int k = 1; k < LB_THREADS / 32; ++k) v = __fadd_rn(v, red[k * 2 * C + c]);
    out[c] = v;
  }
}

// out[c] = sum over the rows k of part [rows, len] in a fixed order: warp w
// of the block of columns c adds rows w, w + LB_RWARPS, ... in turn, then
// the warps' sums are added in warp order.
__global__ void __launch_bounds__(LB_RWARPS * 32)
reduce_rows_kernel(const float* __restrict__ part, int rows, int len, float* __restrict__ out) {
  __shared__ float sums[LB_RWARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < len) {
#pragma unroll 4
    for (int k = warp; k < rows; k += LB_RWARPS) s = __fadd_rn(s, __ldg(part + (long)k * len + c));
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < len) {
    float v = sums[0][lane];
#pragma unroll
    for (int k = 1; k < LB_RWARPS; ++k) v = __fadd_rn(v, sums[k][lane]);
    out[c] = v;
  }
}

template <int NV>
cudaError_t launch_layernorm_bwd(const void* x, const void* w, const void* dy, const void* dres,
                                 void* dx, float* part, long rows, int C, int lg, long r_strip,
                                 int ctas, float eps, cudaStream_t st) {
  const int smem = (LB_THREADS / 32) * 2 * C * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layernorm_bwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  layernorm_bwd_kernel<NV><<<ctas, LB_THREADS, smem, st>>>(
      (const bf16*)x, (const float*)w, (const bf16*)dy, (const bf16*)dres, (bf16*)dx, part, rows,
      C, lg, r_strip, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

// out [N, K] f32 = A[M, N]^T B[M, K] and colsum [N] f32 = the column sums
// of A, for contiguous bf16 A and B (16-byte aligned, N % 8 == 0, K % 8 ==
// 0).  part: [splits, N, K] f32 scratch, cspart: [splits, N] f32 scratch
// (with one split, out and colsum themselves: the blocks write the result
// and no reduce runs); M is cut into splits of m_split rows (a multiple of
// 64), the output into 128 mt x tk tiles (mt 1 with tk 192 or 256, mt 2
// with tk 192), as kernels.gemm_tn_plan chooses.
int sp_gemm_tn(const void* a, const void* b, int M, int N, int K, int tk, int mt, int m_split,
               int splits, void* part, void* cspart, void* out, void* colsum, void* stream) {
  using namespace spk;
  if (M < 1 || N % 8 || K % 8 || m_split % TN_BM || splits < 1 ||
      (long)(splits - 1) * m_split >= M || (long)splits * m_split < M ||
      (splits == 1 && (part != out || cspart != colsum)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap ta, tb;
  cudaError_t e = make_tn_tmap(&ta, a, M, N);
  if (e == cudaSuccess) e = make_tn_tmap(&tb, b, M, K);
  if (e != cudaSuccess) return (int)e;
#define SPK_TN_CASE(TKV, MTV)                                                         \
  case TKV * 4 + MTV:                                                                 \
    e = launch_gemm_tn<TKV, MTV>(ta, tb, M, N, K, m_split, splits, (float*)part,      \
                                 (float*)cspart, st);                                 \
    break;
  switch (tk * 4 + mt) {
    SPK_TN_CASE(192, 1)
    SPK_TN_CASE(256, 1)
    SPK_TN_CASE(192, 2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_TN_CASE
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long len = (long)N * K;
  reduce_splits_kernel<<<(unsigned)((len + 255) / 256), 256, 0, st>>>((const float*)part, splits,
                                                                     len, (float*)out);
  reduce_splits_kernel<<<(N + 255) / 256, 256, 0, st>>>((const float*)cspart, splits, N,
                                                         (float*)colsum);
  return (int)cudaGetLastError();
}

// LayerNorm backward over bf16 rows of C (C % 8 == 0, 16-byte aligned
// rows): dx (bf16, + dres when non-null) and dwb = [dw; db] (2C f32).  The
// plan (kernels.layernorm_bwd_plan): groups of 2^lg lanes a row, nv vectors
// a lane (1-5, the narrow form; 16, the wide form, lg 5), ctas strips of
// r_strip rows; part [ctas, 2C] f32 scratch (with one CTA, dwb itself).
int sp_layernorm_bwd(const void* x, const void* w, const void* dy, const void* dres, void* dx,
                     void* part, long rows, int C, int lg, int nv, long r_strip, int ctas,
                     void* dwb, float eps, void* stream) {
  using namespace spk;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || C < 8 || C % 8 || lg < 0 || lg > 5 || ctas < 1 || r_strip < 1 ||
      r_strip % (LB_THREADS >> lg) || (long)(ctas - 1) * r_strip >= rows ||
      (long)ctas * r_strip < rows || C / 8 > (nv << lg) || (nv == 16 && lg != 5) ||
      !((nv >= 1 && nv <= 5) || nv == 16) || (ctas == 1 && part != dwb))
    return (int)cudaErrorInvalidValue;
  float* p = (float*)part;
  cudaError_t e;
#define SPK_LB_CASE(NVV)                                                                     \
  case NVV:                                                                                  \
    e = launch_layernorm_bwd<NVV>(x, w, dy, dres, dx, p, rows, C, lg, r_strip, ctas, eps, st); \
    break;
  switch (nv) {
    SPK_LB_CASE(1)
    SPK_LB_CASE(2)
    SPK_LB_CASE(3)
    SPK_LB_CASE(4)
    SPK_LB_CASE(5)
    default:
      e = launch_layernorm_bwd<16>(x, w, dy, dres, dx, p, rows, C, lg, r_strip, ctas, eps, st);
  }
#undef SPK_LB_CASE
  if (e != cudaSuccess || ctas == 1) return (int)e;
  reduce_rows_kernel<<<(2 * C + 31) / 32, LB_RWARPS * 32, 0, st>>>(p, ctas, 2 * C, (float*)dwb);
  return (int)cudaGetLastError();
}

}  // extern "C"
