// PED decoder block 2 in the W8A8 mode (model.int8_decoder) on Hopper:
//
//   sp_quant_image_i8   per-image absmax of x [B, S, S, Cin] bf16 and the
//                       codes round(x / sx), sx = max(absmax * f32(1/127),
//                       1e-12), a true division, ties to even
//   sp_polyconv1_i8     conv1 in the TPU kernel's polyphase form: for cell
//                       (i, j) the 3x3 edge-clamped source cells of the codes
//                       times the composed weights [4 Cm, 9 Cin] (int8,
//                       K contiguous) -> exact int32 sums, relu(acc * (sx *
//                       sw1[n]) + t1) in bf16, written as the 2S x 2S map
//                       y1 [B, 2S, 2S, Cm] (column n = (py, px, c) is output
//                       pixel (2i + py, 2j + px)); the exact border strips
//                       (activated, [4, B, 2S, Cm]: top, bottom, left, right)
//                       are pasted in the epilogue, left / right winning at
//                       the corners, which also keeps the maxima of the
//                       unpasted rows 0 and 2S - 1 (but their outermost
//                       columns) for the scales below
//   sp_strip_scales_i8  conv2's activation scale per (image, strip of sh cell
//                       rows): max(amax * f32(1/127), 1e-12), amax over the
//                       strip's rows and one cell row of halo on each side,
//                       and in the first / last strip the unpasted row
//                       0 / 2S - 1 -- what the TPU kernel's `a_ref` holds
//   sp_conv2_i8_head    conv2 as a SAME 3x3 conv on the 2S grid of the codes
//                       round(a * (1 / sa)) of the strip the output row lies
//                       in (made as the halo is staged), weights [Cm, 9 Cm]
//                       int8 with per-output-channel scales, relu(acc * (sa *
//                       sw2) + t2) in bf16, then the 1x1 head in f32 + hb
//                       (in a fixed order, no FMA), rounded to bf16: pred
//                       [B, 2S, 2S]
//
// Together they replace spegnet_tpu/ops/fused_decoder.py `_dec_kernel`
// (:338) with int8=True; ops/fused_decoder.i8_parts_plain is the same
// arithmetic in plain PyTorch.  Each dequant product is rounded alone (no
// FMA contraction), the scale product first, as the TPU kernel computes.
//
// Bound on the H100: conv1 is 2 * 9 Cin * 4 Cm int8 operations per cell,
// conv2 2 * 9 Cm * Cm per output pixel, at the int8 tensor-core rate; y1
// (bf16, 4 x the cells x Cm) is written once and read twice (scales, conv2)
// and is the largest traffic.  Both convs are implicit GEMMs on
// mma.sync.m16n8k32 over a halo staged in shared memory (shifted ldmatrix
// reads per tap); wgmma with s8 operands and TMA are later work.
#include "common.cuh"

namespace spk {
namespace {

constexpr float INV127 = (float)(1.0 / 127.0);
constexpr float QFLOOR = 1e-12f;

__device__ __forceinline__ float q_scale(float amax) { return fmaxf(__fmul_rn(amax, INV127), QFLOOR); }

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

__global__ void __launch_bounds__(256)
image_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ amax,
                   int8_t* __restrict__ q, float* __restrict__ sx, long nvec) {
  const int b = blockIdx.y;
  const float s = q_scale(amax[b]);
  if (blockIdx.x == 0 && threadIdx.x == 0) sx[b] = s;
  const uint4* xb = reinterpret_cast<const uint4*>(x) + (long)b * nvec;
  uint2* qb = reinterpret_cast<uint2*>(q) + (long)b * nvec;
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < nvec; i += (long)gridDim.x * 256) {
    uint4 v = xb[i];
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(bf(lanes(v)[e]), s))
                  << (8 * (e % 4));
    qb[i] = make_uint2(w[0], w[1]);
  }
}

// ---------------------------------------------------------------------------
// conv1 (polyphase) + border paste
// ---------------------------------------------------------------------------

constexpr int C1_TC = 128;   // cells per tile (one cell row)
constexpr int C1_NT = 128;   // composed columns per tile
constexpr int C1_HC = C1_TC + 2;
constexpr int C1_P = 48;     // bytes per smem row: 32 codes + 16 (conflict-free ldmatrix)
constexpr int C1_SMEM = (3 * C1_HC + 9 * C1_NT) * C1_P;

__global__ void __launch_bounds__(256)
polyconv1_i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                    const int8_t* __restrict__ w1t, const float* __restrict__ sw1,
                    const float* __restrict__ t1, const bf16* __restrict__ strips,
                    bf16* __restrict__ y1, float* __restrict__ edge_max, int B, int S, int Cin,
                    int Cm) {
  extern __shared__ __align__(16) unsigned char smem_c1[];
  unsigned char* Xs = smem_c1;                     // [3 * HC][P]
  unsigned char* Ws = smem_c1 + 3 * C1_HC * C1_P;  // [9 * NT][P]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 32 cells, 2 x 64 columns
  const int j0 = blockIdx.y * C1_TC, n0 = blockIdx.z * C1_NT;
  const int b = blockIdx.x / S, i = blockIdx.x % S;
  const int8_t* xb = xq + (long)b * S * S * Cin;
  const long K = 9L * Cin;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  for (int c0 = 0; c0 < Cin; c0 += 32) {
    __syncthreads();
    for (int idx = tid; idx < 3 * C1_HC * 2; idx += 256) {
      const int cell = idx >> 1, half = idx & 1;
      const int u = cell / C1_HC, jj = cell % C1_HC;
      const int r = min(max(i - 1 + u, 0), S - 1), c = min(max(j0 - 1 + jj, 0), S - 1);
      cp_async16(Xs + cell * C1_P + half * 16, xb + ((long)r * S + c) * Cin + c0 + half * 16, 16);
    }
    for (int idx = tid; idx < 9 * C1_NT * 2; idx += 256) {
      const int row = idx >> 1, half = idx & 1;  // row = tap * NT + n
      const int tap = row / C1_NT, n = row % C1_NT;
      cp_async16(Ws + row * C1_P + half * 16, w1t + (long)(n0 + n) * K + tap * Cin + c0 + half * 16,
                 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3, v = tap % 3;
      uint32_t af[2][4], bfr[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], Xs + (u * C1_HC + wm * 32 + mi * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8 + v) * C1_P + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Ws + (tap * C1_NT + wn * 64 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                C1_P + ((lane >> 3) & 1) * 16);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }

  // Epilogue: dequant + t1 + ReLU -> bf16, border paste, unpasted maxima.
  const int S2 = 2 * S;
  const float sxb = sx[b];
  const long plane = (long)S2 * Cm;  // one strip row of [B, 2S, Cm]
  const bf16* top = strips + (0L * B + b) * plane;
  const bf16* bot = strips + (1L * B + b) * plane;
  const bf16* left = strips + (2L * B + b) * plane;
  const bf16* right = strips + (3L * B + b) * plane;
  float m_top = 0.f, m_bot = 0.f;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int n = n0 + wn * 64 + ni * 8 + 2 * t;
    const float sc0 = __fmul_rn(sxb, sw1[n]), sc1 = __fmul_rn(sxb, sw1[n + 1]);
    const int py = n / (2 * Cm), px = (n / Cm) & 1, c = n % Cm;
    const float o0 = t1[c], o1 = t1[c + 1];
    const int R = 2 * i + py;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = j0 + wm * 32 + mi * 16 + g + 8 * hh;
        if (j >= S) continue;
        const int C = 2 * j + px;
        const float v0 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hh]), sc0), o0), 0.f);
        const float v1 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hh + 1]), sc1), o1),
                               0.f);
        __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        const bool rowb = R == 0 || R == S2 - 1, colb = C == 0 || C == S2 - 1;
        if (rowb && !colb) {
          const float mm = fmaxf(__low2float(o), __high2float(o));
          if (R == 0) m_top = fmaxf(m_top, mm);
          else m_bot = fmaxf(m_bot, mm);
        }
        if (colb)
          o = *reinterpret_cast<const __nv_bfloat162*>((C == 0 ? left : right) + (long)R * Cm + c);
        else if (R == 0)
          o = *reinterpret_cast<const __nv_bfloat162*>(top + (long)C * Cm + c);
        else if (R == S2 - 1)
          o = *reinterpret_cast<const __nv_bfloat162*>(bot + (long)C * Cm + c);
        *reinterpret_cast<__nv_bfloat162*>(y1 + (((long)b * S2 + R) * S2 + C) * Cm + c) = o;
      }
    }
  }
  if (m_top > 0.f) atomic_max_nonneg(edge_max + 2 * b, m_top);
  if (m_bot > 0.f) atomic_max_nonneg(edge_max + 2 * b + 1, m_bot);
}

// ---------------------------------------------------------------------------
// per-strip scales
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(512)
strip_scales_kernel(const bf16* __restrict__ y1, const float* __restrict__ edge_max,
                    float* __restrict__ sa, int S, int Cm, int sh) {
  const int si = blockIdx.x, nsi = gridDim.x, b = blockIdx.y, S2 = 2 * S;
  const int r0 = max(2 * si * sh - 2, 0), r1 = min(2 * (si + 1) * sh + 2, S2);
  const uint4* base = reinterpret_cast<const uint4*>(y1 + ((long)b * S2 + r0) * S2 * Cm);
  const long nvec = (long)(r1 - r0) * S2 * Cm / 8;
  float m = 0.f;
  for (long k = threadIdx.x; k < nvec; k += blockDim.x) {
    uint4 v = base[k];
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(bf(lanes(v)[e])));
  }
  if (si == 0) m = fmaxf(m, edge_max[2 * b]);
  if (si == nsi - 1) m = fmaxf(m, edge_max[2 * b + 1]);
  m = block_max(m);
  if (threadIdx.x == 0) sa[b * nsi + si] = q_scale(m);
}

// ---------------------------------------------------------------------------
// conv2 + head
// ---------------------------------------------------------------------------

constexpr int C2_CM = 64;
constexpr int C2_TR = 2, C2_TC = 128;
constexpr int C2_HC = C2_TC + 2, C2_HR = C2_TR + 2;
constexpr int C2_XP = C2_CM + 16;          // bytes per halo pixel
constexpr int C2_K = 9 * C2_CM;            // 576
constexpr int C2_WP = C2_K + 16;           // bytes per weight row
constexpr int C2_SMEM = C2_HR * C2_HC * C2_XP + C2_CM * C2_WP;

// Y2: also store conv2's activated output y2 [B, S2, S2, 64] (for checks).
template <bool Y2>
__global__ void __launch_bounds__(256)
conv2_i8_head_kernel(const bf16* __restrict__ y1, const float* __restrict__ sa,
                     const int8_t* __restrict__ w2q, const float* __restrict__ sw2,
                     const float* __restrict__ t2, const float* __restrict__ hw,
                     const float* __restrict__ hb, bf16* __restrict__ pred,
                     bf16* __restrict__ y2, int S2, int sh, int nsi) {
  extern __shared__ __align__(16) unsigned char smem_c2[];
  unsigned char* Xs = smem_c2;                          // [HR * HC][XP]
  unsigned char* Ws = smem_c2 + C2_HR * C2_HC * C2_XP;  // [CM][WP]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ox0 = blockIdx.x * C2_TC, oy0 = blockIdx.y * C2_TR, b = blockIdx.z;
  const float s_a = sa[b * nsi + oy0 / (2 * sh)];
  const float ra = __fdiv_rn(1.0f, s_a);
  const int wr = warp / 4, wc = (warp % 4) * 32;

  for (int idx = tid; idx < C2_CM * (C2_K / 16); idx += 256) {
    const int row = idx / (C2_K / 16), v = idx % (C2_K / 16);
    cp_async16(Ws + row * C2_WP + v * 16, w2q + (long)row * C2_K + v * 16, 16);
  }
  cp_async_commit();
  const bf16* yb = y1 + (long)b * S2 * S2 * C2_CM;
  for (int idx = tid; idx < C2_HR * C2_HC * (C2_CM / 8); idx += 256) {
    const int px = idx / (C2_CM / 8), cv = idx % (C2_CM / 8);
    const int Y = oy0 - 1 + px / C2_HC, X = ox0 - 1 + px % C2_HC;
    uint32_t w[2] = {0u, 0u};
    if (Y >= 0 && Y < S2 && X >= 0 && X < S2) {
      uint4 v = *reinterpret_cast<const uint4*>(yb + ((long)Y * S2 + X) * C2_CM + cv * 8);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fmul_rn(bf(lanes(v)[e]), ra))
                    << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(Xs + px * C2_XP + cv * 8) = make_uint2(w[0], w[1]);
  }
  cp_async_wait<0>();
  __syncthreads();

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int ks = 0; ks < C2_CM / 32; ++ks) {
      uint32_t af[2][4], bfr[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], Xs + ((wr + dy) * C2_HC + wc + mi * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8 + dx) * C2_XP + ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Ws + (np * 16 + (lane & 7) + (lane >> 4) * 8) * C2_WP + tap * C2_CM +
                           ks * 32 + ((lane >> 3) & 1) * 16);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }

  const int oy = oy0 + wr;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ox = ox0 + wc + mi * 16 + g + 8 * hh;
      float part = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int co = ni * 8 + 2 * t;
        const float v0 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hh]),
                                                   __fmul_rn(s_a, sw2[co])), t2[co]), 0.f);
        const float v1 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hh + 1]),
                                                   __fmul_rn(s_a, sw2[co + 1])), t2[co + 1]), 0.f);
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        if (Y2 && ox < S2)
          *reinterpret_cast<__nv_bfloat162*>(y2 + (((long)b * S2 + oy) * S2 + ox) * C2_CM + co) = o;
        part = __fadd_rn(part, __fadd_rn(__fmul_rn(__low2float(o), hw[co]),
                                         __fmul_rn(__high2float(o), hw[co + 1])));
      }
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 2));
      if (t == 0 && ox < S2) pred[((long)b * S2 + oy) * S2 + ox] = to_bf(__fadd_rn(part, hb[0]));
    }
  }
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

// x [B, per_image] bf16 -> codes int8 (same shape), sx [B]; amax [B] is
// scratch, zeroed here.
int sp_quant_image_i8(const void* x, void* q, void* sx, void* amax, int B, long per_image,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(amax, 0, sizeof(float) * B, st);
  const long nvec = per_image / 8;
  const long blocks = (nvec + 255) / 256;
  const dim3 grid((unsigned)(blocks < 1024 ? blocks : 1024), B);
  spk::image_absmax_kernel<<<grid, 256, 0, st>>>((const bf16*)x, (float*)amax, nvec);
  spk::image_quant_kernel<<<grid, 256, 0, st>>>((const bf16*)x, (const float*)amax, (int8_t*)q,
                                                (float*)sx, nvec);
  return (int)cudaGetLastError();
}

// xq [B, S, S, Cin] int8, w1t [4 Cm, 9 Cin] int8, strips [4, B, 2S, Cm] bf16
// -> y1 [B, 2S, 2S, Cm] bf16, edge_max [B, 2] f32 (zeroed here).
int sp_polyconv1_i8(const void* xq, const void* sx, const void* w1t, const void* sw1,
                    const void* t1, const void* strips, void* y1, void* edge_max, int B, int S,
                    int Cin, int Cm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(edge_max, 0, sizeof(float) * 2 * B, st);
  cudaFuncSetAttribute(spk::polyconv1_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       spk::C1_SMEM);
  const dim3 grid(B * S, (S + spk::C1_TC - 1) / spk::C1_TC, 4 * Cm / spk::C1_NT);
  spk::polyconv1_i8_kernel<<<grid, 256, spk::C1_SMEM, st>>>(
      (const int8_t*)xq, (const float*)sx, (const int8_t*)w1t, (const float*)sw1,
      (const float*)t1, (const bf16*)strips, (bf16*)y1, (float*)edge_max, B, S, Cin, Cm);
  return (int)cudaGetLastError();
}

// y1 [B, 2S, 2S, Cm], edge_max [B, 2] -> sa [B, S / sh].
int sp_strip_scales_i8(const void* y1, const void* edge_max, void* sa, int B, int S, int Cm,
                       int sh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  spk::strip_scales_kernel<<<dim3(S / sh, B), 512, 0, st>>>(
      (const bf16*)y1, (const float*)edge_max, (float*)sa, S, Cm, sh);
  return (int)cudaGetLastError();
}

// y1 [B, S2, S2, 64], sa [B, S2 / (2 sh)], w2q [64, 576] int8 -> pred [B, S2, S2],
// and y2 [B, S2, S2, 64] unless y2 is null.
int sp_conv2_i8_head(const void* y1, const void* sa, const void* w2q, const void* sw2,
                     const void* t2, const void* hw, const void* hb, void* pred, void* y2,
                     int B, int S2, int sh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = y2 ? spk::conv2_i8_head_kernel<true> : spk::conv2_i8_head_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, spk::C2_SMEM);
  const dim3 grid((S2 + spk::C2_TC - 1) / spk::C2_TC, S2 / spk::C2_TR, B);
  kernel<<<grid, 256, spk::C2_SMEM, st>>>(
      (const bf16*)y1, (const float*)sa, (const int8_t*)w2q, (const float*)sw2,
      (const float*)t2, (const float*)hw, (const float*)hb, (bf16*)pred, (bf16*)y2, S2, sh,
      S2 / (2 * sh));
  return (int)cudaGetLastError();
}

}  // extern "C"
