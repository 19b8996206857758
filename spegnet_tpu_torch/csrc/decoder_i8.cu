// PED decoder block 2 in the W8A8 mode (model.int8_decoder) on Hopper:
//
//   sp_quant_image_i8   per-image absmax of x [B, S, S, Cin] bf16 and the
//                       codes round(x / sx), sx = max(absmax * f32(1/127),
//                       1e-12), a true division, ties to even
//   sp_dec_strips       the exact border strips of conv1 (the outermost rows
//                       and columns of conv3x3(up2(x)), [4, B, 2S, Cm] bf16:
//                       top, bottom, left, right) on bf16 wgmma, the sample
//                       built as ops/fused_upsample_conv.border_strips builds
//                       it (decoder_conv.cuh, DC_STRIP)
//   sp_polyconv1_i8     conv1 in the TPU kernel's polyphase form: for cell
//                       (i, j) the 3x3 edge-clamped source cells of the codes
//                       times the composed weights [4 Cm, 9 Cin] (int8,
//                       K contiguous) -> exact int32 sums, relu(acc * (sx *
//                       sw1[n]) + t1) in bf16, written as the 2S x 2S map
//                       y1 [B, 2S, 2S, Cm] (column n = (py, px, c) is output
//                       pixel (2i + py, 2j + px)); the strips, activated
//                       (relu(strip * s1 + t1) in bf16), are pasted in the
//                       epilogue, left / right winning at the corners; the
//                       epilogue also keeps conv2's activation maxima per
//                       (image, strip of sh cell rows): everything written in
//                       the strip's rows and one cell row of halo on each
//                       side, and in the first / last strip the unpasted row
//                       0 / 2S - 1 but its outermost columns -- what the TPU
//                       kernel's `a_ref` holds (atomic max: order-free)
//   sp_conv2_i8_head    conv2 as a SAME 3x3 conv on the 2S grid of the codes
//                       round(a * (1 / sa)) of the strip the output row lies
//                       in, sa = max(amax * f32(1/127), 1e-12), weights [Cm,
//                       9 Cm] int8 with per-output-channel scales, relu(acc *
//                       (sa * sw2) + t2) in bf16, then the 1x1 head in f32 +
//                       hb (in a fixed order, no FMA), rounded to bf16: pred
//                       [B, 2S, 2S] (decoder_conv.cuh, DC_Q8)
//
// Together they replace spegnet_tpu/ops/fused_decoder.py `_dec_kernel`
// (:338) with int8=True and its border strips (`make_strips` :251, computed
// in XLA by the JAX package); ops/fused_decoder.i8_parts_plain is the same
// arithmetic in plain PyTorch.  Each dequant product is rounded alone (no
// FMA contraction), the scale product first, as the TPU kernel computes.
//
// Bound on the H100: conv1 is 2 * 9 Cin * 4 Cm int8 operations per cell,
// conv2 2 * 9 Cm * Cm per output pixel, at the int8 tensor-core rate; y1
// (bf16, 4 x the cells x Cm) is written once and read once, the largest
// traffic.  Both convs run m64n128k32 s8 wgmma on operands in shared memory
// fed by a producer warpgroup through a ring of mbarrier stages; their sums
// are exact integers, so the bits are those of the mma.sync kernels they
// replaced.
#include "decoder_conv.cuh"

namespace spk {
namespace {

// Block-wide max of non-negative values; the result is thread 0's.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float red[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) m = warp_max(lane < (int)(blockDim.x / 32) ? red[lane] : 0.f);
  return m;
}

// ---------------------------------------------------------------------------
// per-image quant
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
image_absmax_kernel(const bf16* __restrict__ x, float* __restrict__ amax, long nvec) {
  const uint4* xb = reinterpret_cast<const uint4*>(x) + (long)blockIdx.y * nvec;
  float m = 0.f;
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < nvec; i += (long)gridDim.x * 256) {
    uint4 v = xb[i];
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(bf(lanes(v)[e])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomic_max_nonneg(amax + blockIdx.y, m);
}

// The codes of x [S, S, Cin] per image, written with a replicated border
// into q [S + 2, S + 2, Cin]: conv1's edge-clamped source cells.
__global__ void __launch_bounds__(256)
image_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ amax,
                   int8_t* __restrict__ q, float* __restrict__ sx, int S, int Cin) {
  const int b = blockIdx.y, cv8 = Cin / 8, P = S + 2;
  const float s = dc_q_scale(amax[b]);
  if (blockIdx.x == 0 && threadIdx.x == 0) sx[b] = s;
  const long nvec = (long)S * S * cv8;
  const uint4* xb = reinterpret_cast<const uint4*>(x) + (long)b * nvec;
  uint2* qb = reinterpret_cast<uint2*>(q) + (long)b * P * P * cv8;
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < nvec; i += (long)gridDim.x * 256) {
    uint4 v = xb[i];
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(bf(lanes(v)[e]), s))
                  << (8 * (e % 4));
    const uint2 code = make_uint2(w[0], w[1]);
    const int cv = (int)(i % cv8);
    const long pix = i / cv8;
    const int r = (int)(pix / S), c = (int)(pix % S);
    const int rr = r == 0 ? 0 : (r == S - 1 ? S + 1 : -1);
    const int cc = c == 0 ? 0 : (c == S - 1 ? S + 1 : -1);
    qb[((long)(r + 1) * P + c + 1) * cv8 + cv] = code;
    if (rr >= 0) qb[((long)rr * P + c + 1) * cv8 + cv] = code;
    if (cc >= 0) qb[((long)(r + 1) * P + cc) * cv8 + cv] = code;
    if (rr >= 0 && cc >= 0) qb[((long)rr * P + cc) * cv8 + cv] = code;
  }
}

// ---------------------------------------------------------------------------
// conv1 (polyphase) + border paste, on s8 wgmma
// ---------------------------------------------------------------------------
//
// A block owns P1_NT = 128 of the 4 Cm = 256 composed columns (block b the
// columns of half b % 2) and keeps their weights resident in shared memory
// ([9 taps][128 columns][128 B], K-major, 128-byte swizzled); it walks
// the tiles of two cell rows x 64 cells of its half, the consumer warpgroups
// taking them in turn (tile k of the walk to consumer k % 2, so that one's
// epilogue overlaps the other's MMAs).  Per cell row: M = its 64 cells, N =
// the 128 columns, m64n128k32 per k-step (the cells on M, so the
// accumulators hold pairs of adjacent columns, i.e. channel pairs of one
// output pixel, as mma.sync's did).  One producer thread loads each stage,
// the 4 x 66 source cells of all 128 input channels, by one TMA box of
// 128-byte rows written with the 128-byte swizzle, from the codes with their
// replicated border (image_quant_kernel): the edge-clamped cells of the
// polyphase form, which a box's zero fill would not give.  The nine taps
// are shifted descriptors into the stage: the swizzle is of the address, so
// any cell is a legal start.

constexpr int P1_CM = 64;                          // output channels (4 Cm = 256 columns)
constexpr int P1_TC = 64;                          // cells of a row (wgmma M)
constexpr int P1_HC = P1_TC + 2;                   // halo cells of a row
constexpr int P1_NT = 128;                         // composed columns of a block (wgmma N)
constexpr int P1_CIN = 128;                        // input channels: one 128-byte row a cell
constexpr int P1_STAGE = 4 * P1_HC * P1_CIN;       // the 4 x 66 halo cells, swizzled rows
constexpr int P1_WBYTES = 9 * P1_CIN * P1_NT;      // [9 taps][128 columns][128 B], swizzled
constexpr int P1_ST = 2;
constexpr int P1_CONST = (P1_NT + 2 * P1_CM) * 4;  // sw1 of the block's columns, s1, t1
constexpr int P1_SMEM = 1024 + P1_WBYTES + P1_ST * P1_STAGE + P1_CONST + 128;
static_assert(P1_SMEM <= DC_SMEM_MAX, "shared memory");

__global__ void __launch_bounds__(DC_THREADS, 1)
polyconv1_i8_kernel(const __grid_constant__ CUtensorMap txq, const float* __restrict__ sx,
                    const int8_t* __restrict__ w1t, const float* __restrict__ sw1,
                    const float* __restrict__ s1, const float* __restrict__ t1,
                    const bf16* __restrict__ strips, bf16* __restrict__ y1,
                    float* __restrict__ amax, int B, int S, int sh) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ws = base;
  unsigned char* ring = base + P1_WBYTES;
  float* csw = reinterpret_cast<float*>(ring + P1_ST * P1_STAGE);  // [128]
  float* cs1 = csw + P1_NT;                                         // [64]
  float* ct1 = cs1 + P1_CM;                                         // [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ct1 + P1_CM);
  uint64_t* empty = full + P1_ST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = (blockIdx.x % 2) * P1_NT, step = gridDim.x / 2;
  const int ct = (S + P1_TC - 1) / P1_TC, rows = S / 2;
  const long tiles = (long)B * rows * ct;

  dc_load_sw128(Ws, w1t, n0, P1_NT, 9 * P1_CIN, tid, DC_THREADS);
  if (tid < P1_NT) csw[tid] = sw1[n0 + tid];
  else if (tid < P1_NT + P1_CM) cs1[tid - P1_NT] = s1[tid - P1_NT];
  else if (tid < P1_NT + 2 * P1_CM) ct1[tid - P1_NT - P1_CM] = t1[tid - P1_NT - P1_CM];
  if (tid == 0) {
    for (int s = 0; s < P1_ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (tid != 0) return;
    long it = 0;  // stages filled by this block, across its tiles
    for (long tile = blockIdx.x / 2; tile < tiles; tile += step) {
      const int j0 = (int)(tile % ct) * P1_TC, i0 = 2 * (int)((tile / ct) % rows);
      const int b = (int)(tile / ct / rows);
      const int s = (int)(it % P1_ST);
      if (it >= P1_ST) dc_wait(&empty[s], (int)((it / P1_ST - 1) & 1));
      mbar_arrive_expect_tx(&full[s], P1_STAGE);
      // padded cell (i0, j0) is cell (i0 - 1, j0 - 1)
      tma_load_4d(ring + s * P1_STAGE, &txq, &full[s], 0, j0, i0, b);
      ++it;
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int cw = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int S2 = 2 * S, nsi = S / sh;
  const long plane = (long)S2 * P1_CM;  // one strip row of [B, 2S, Cm]
  const int py = n0 / (2 * P1_CM);      // the output row parity of the block's columns
  // tile k of the block's walk goes to consumer k % 2; both wait for every
  // fill of the ring in order and release it (the other's tiles at once)
  long k = 0;
  for (long tile = blockIdx.x / 2; tile < tiles; tile += step, ++k) {
    if (k % 2 != cw) {
      dc_wait(&full[(int)(k % P1_ST)], (int)((k / P1_ST) & 1));
      mbar_arrive(&empty[(int)(k % P1_ST)]);
      continue;
    }
    const int j0 = (int)(tile % ct) * P1_TC, i0 = 2 * (int)((tile / ct) % rows);
    const int b = (int)(tile / ct / rows);
    int d[2][64];  // each row's sums start from zero at its first k-step (scale-d 0)
    const int s = (int)(k % P1_ST);
    dc_wait(&full[s], (int)((k / P1_ST) & 1));
    const unsigned char* st = ring + s * P1_STAGE;
    // descriptors as offsets (16-byte units) from the stage's and the weights'
    const uint64_t da0 = wgmma_desc_sw128(st), db0 = wgmma_desc_sw128(Ws);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3, v = tap % 3;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          dc_mma(d[r], da0 + ((((r + u) * P1_HC + v) * P1_CIN + ks * 32) >> 4),
                 db0 + ((tap * P1_NT * 128 + ks * 32) >> 4), tap > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d[0]);
    fence_acc(d[1]);
    mbar_arrive(&empty[s]);

    // Epilogue: dequant + t1 + ReLU -> bf16, the border paste (the raw
    // strips activated here as activate_strips does), the maxima of what is
    // written for the strip scales, and of the unpasted rows 0 / 2S - 1 but
    // their outermost columns.  d[r][4 j + 2 hh + e]: cell row i0 + r, cell
    // j0 + 16 w + g + 8 hh, column n0 + 8 j + 2 t + e.
    const float sxb = sx[b];
    const bf16* top = strips + (0L * B + b) * plane;
    const bf16* bot = strips + (1L * B + b) * plane;
    const bf16* left = strips + (2L * B + b) * plane;
    const bf16* right = strips + (3L * B + b) * plane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r, R = 2 * i + py;
      float m_all = 0.f, m_edge = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int nl = 8 * j + 2 * t;
        const float sc0 = __fmul_rn(sxb, csw[nl]), sc1 = __fmul_rn(sxb, csw[nl + 1]);
        const int px = nl / P1_CM, c = nl % P1_CM;
        const float o0 = ct1[c], o1 = ct1[c + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jc = j0 + 16 * w + g + 8 * hh;
          if (jc >= S) continue;
          const int C = 2 * jc + px;
          const float v0 =
              fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(d[r][4 * j + 2 * hh]), sc0), o0), 0.f);
          const float v1 =
              fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(d[r][4 * j + 2 * hh + 1]), sc1), o1), 0.f);
          __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          const bool rowb = R == 0 || R == S2 - 1, colb = C == 0 || C == S2 - 1;
          if (rowb && !colb) m_edge = fmaxf(m_edge, fmaxf(__low2float(o), __high2float(o)));
          if (rowb || colb) {
            const bf16* src = colb ? (C == 0 ? left : right) + (long)R * P1_CM
                                   : (R == 0 ? top : bot) + (long)C * P1_CM;
            const __nv_bfloat162 raw = *reinterpret_cast<const __nv_bfloat162*>(src + c);
            o = __floats2bfloat162_rn(
                fmaxf(__fadd_rn(__fmul_rn(__low2float(raw), cs1[c]), o0), 0.f),
                fmaxf(__fadd_rn(__fmul_rn(__high2float(raw), cs1[c + 1]), o1), 0.f));
          }
          *reinterpret_cast<__nv_bfloat162*>(y1 + (((long)b * S2 + R) * S2 + C) * P1_CM + c) = o;
          m_all = fmaxf(m_all, fmaxf(__low2float(o), __high2float(o)));
        }
      }
      // Cell row i (output rows 2i, 2i + 1) lies in strip si and, as its
      // first (last) cell row, in the halo of strip si - 1 (si + 1); the
      // unpasted row 0 (2S - 1) counts in the first (last) strip.
      m_all = warp_max(m_all);
      m_edge = warp_max(m_edge);
      if (lane == 0) {
        float* am = amax + (long)b * nsi;
        const int si = i / sh;
        if (m_all > 0.f) {
          atomic_max_nonneg(am + si, m_all);
          if (i % sh == 0 && si > 0) atomic_max_nonneg(am + si - 1, m_all);
          if (i % sh == sh - 1 && si < nsi - 1) atomic_max_nonneg(am + si + 1, m_all);
        }
        if (m_edge > 0.f) atomic_max_nonneg(am + (R == 0 ? 0 : nsi - 1), m_edge);
      }
    }
  }
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

// x [B, S, S, Cin] bf16 -> codes q [B, S + 2, S + 2, Cin] int8 (the border
// replicated), sx [B]; amax [B] is scratch, zeroed here.
int sp_quant_image_i8(const void* x, void* q, void* sx, void* amax, int B, int S, int Cin,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(amax, 0, sizeof(float) * B, st);
  const long nvec = (long)S * S * Cin / 8;
  const long blocks = (nvec + 255) / 256;
  const dim3 grid((unsigned)(blocks < 1024 ? blocks : 1024), B);
  spk::image_absmax_kernel<<<grid, 256, 0, st>>>((const bf16*)x, (float*)amax, nvec);
  spk::image_quant_kernel<<<grid, 256, 0, st>>>((const bf16*)x, (const float*)amax, (int8_t*)q,
                                                (float*)sx, S, Cin);
  return (int)cudaGetLastError();
}

// x [B, S, S, Cin] bf16, wt [64, 9 Cin] bf16 (conv1, K (dy, dx, ci)) -> the
// raw border strips [4, B, 2S, 64] bf16 (top, bottom, left, right).
int sp_dec_strips(const void* x, const void* wt, void* strips, int B, int S, int Cin, int grid,
                  void* stream) {
  spk::DcArgs a{};
  a.x = x;
  a.w = wt;
  a.out = strips;
  a.B = B;
  a.H = a.W = 2 * S;
  a.Cin = Cin;
  return (int)spk::dc_launch<spk::DC_STRIP>(a, grid, (cudaStream_t)stream);
}

// xq [B, S + 2, S + 2, Cin] int8 (the codes with their replicated border),
// w1t [4 Cm, 9 Cin] int8, the raw strips [4, B, 2S, Cm] bf16 (activated here
// with s1, t1) -> y1 [B, 2S, 2S, Cm] bf16 and the strip maxima amax
// [B, S / sh] f32 (zeroed here); Cm 64, Cin 128, grid even.
int sp_polyconv1_i8(const void* xq, const void* sx, const void* w1t, const void* sw1,
                    const void* s1, const void* t1, const void* strips, void* y1, void* amax,
                    int B, int S, int Cin, int sh, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap map;
  if (Cin != spk::P1_CIN) return (int)cudaErrorInvalidValue;
  cudaError_t e = spk::dc_tmap(&map, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, B, S + 2, S + 2, Cin,
                               spk::P1_CIN, spk::P1_HC, 4, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  cudaMemsetAsync(amax, 0, sizeof(float) * B * (S / sh), st);
  e = cudaFuncSetAttribute(spk::polyconv1_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           spk::P1_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  spk::polyconv1_i8_kernel<<<grid, spk::DC_THREADS, spk::P1_SMEM, st>>>(
      map, (const float*)sx, (const int8_t*)w1t, (const float*)sw1,
      (const float*)s1, (const float*)t1, (const bf16*)strips, (bf16*)y1, (float*)amax, B, S,
      sh);
  return (int)cudaGetLastError();
}

// y1 [B, S2, S2, 64] coded per strip of sh cell rows with the scales sa_in
// [B, S2 / (2 sh)], or, when sa_in is null, the scales of the maxima amax
// (then written to sa_out unless it is null); w2q [64, 576] int8 -> pred
// [B, S2, S2], and y2 [B, S2, S2, 64] unless y2 is null.
int sp_conv2_i8_head(const void* y1, const void* amax, const void* sa_in, void* sa_out,
                     const void* w2q, const void* sw2, const void* t2, const void* hw,
                     const void* hb, void* pred, void* y2, int B, int S2, int sh, int grid,
                     void* stream) {
  spk::DcArgs a{};
  a.x = y1;
  a.w = w2q;
  a.s = (const float*)sw2;
  a.t = (const float*)t2;
  a.hw = (const float*)hw;
  a.hb = (const float*)hb;
  a.amax = (const float*)amax;
  a.sa_in = (const float*)sa_in;
  a.sa_out = (float*)sa_out;
  a.out = pred;
  a.y2 = y2;
  a.B = B;
  a.H = a.W = S2;
  a.Cin = 64;
  a.sh = sh;
  a.nsi = S2 / (2 * sh);
  cudaStream_t st = (cudaStream_t)stream;
  return y2 ? (int)spk::dc_launch<spk::DC_Q8Y2>(a, grid, st)
            : (int)spk::dc_launch<spk::DC_Q8>(a, grid, st);
}

}  // extern "C"
