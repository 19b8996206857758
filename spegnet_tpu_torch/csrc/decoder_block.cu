// PED decoder blocks on Hopper, bf16:
//
//   y1   = relu(conv3x3(up2(x)) * s1 + t1)            sp_dec_upconv (Cm 64)
//   pred = relu(conv3x3(y1) * s2 + t2) . w_head + b   sp_dec_conv_head (Cm 64)
//   y1   = relu(conv3x3(up2(x) + up4(ef)) * s1 + t1)  sp_upconv3x3_edge_bn_relu (Cm 128)
//   pred = relu(conv3x3(y1) * s2 + t2) . w_head + b   sp_conv3x3_bn_relu_head (Cm 128)
//   y2   = relu(conv3x3(y1) * s2 + t2)                sp_conv3x3_bn_relu (Cm 128)
//
// Replaces spegnet_tpu/ops/fused_decoder.py `_dec_kernel` (:338) with
// int8=False: block 2 (Cm 64, no edge branch, with its head) and the edge
// branch (block 1's geometry, Cm 128, x [B, S, S, Cin] with edge features
// ef [B, S/2, S/2, Ce], with or without a head; no model route sends a block
// there, as in the JAX package).  conv1 reads the 2x bilinear sample of the
// low-resolution input directly (torch align_corners=False: source
// (o + 0.5) / 2 - 0.5 clamped at 0, neighbour clamped at S - 1, weights
// 0.25 / 0.75), rounded to bf16 as F.interpolate would, with zero padding at
// the 2S border; the edge branch's 4x sample of ef (source (o + 0.5) / 4 -
// 0.5) is built the same way and its 9 Ce taps go into the same f32 sums.
// That is exact everywhere, so the TPU kernel's polyphase packing, its
// composed edge phase kernels (`pack_we`) and its separately computed
// border strips are not needed.  BN is folded (s, t include the conv bias)
// and applied with the ReLU in the epilogue.  y1 [B, 2S, 2S, Cm] goes
// through device memory; with a head y2 never does: the second kernel
// applies BN + ReLU, rounds to bf16 and contracts the Cm channels with the
// 1x1 head in its epilogue.
//
// Block 2, on the main path, runs on the frame of decoder_conv.cuh: TMA
// (conv2) or producer-built (conv1's bilinear sample) halos in a ring of
// mbarrier stages, the output channels on the M of m64n128k16 wgmma, the
// weights resident in shared memory (DC_UP, DC_HEAD).  Bound on the H100:
// 2 * 64 * 9 * Cin FLOPs per output pixel for conv1 and 2 * 64 * 576 for
// conv2, at the bf16 tensor-core rate; the bytes (x, y1 written and read,
// pred) are ~0.2 ms at 512^2 batch 8.
//
// The Cm 128 forms (the edge branch; no model path) keep the one-tile
// kernel below: 9 (Cin + Ce) x 128 bf16 weights do not fit beside a halo
// ring in shared memory, so the frame's resident weights do not carry over.
// It is an implicit GEMM on mma.sync.m16n8k16: a CTA owns a 2-row x 64-pixel
// output tile times all 128 output channels (8 warps of 16 pixels x 128
// channels).  Per chunk of 32 input channels it stages the tile's input halo
// (4 x 66 pixels; for conv1 each halo pixel's bilinear sample is built once,
// not once per tap) and the chunk's 9 x 32 x 128 weights in shared memory;
// the 9 taps are then shifted ldmatrix reads of the same halo.
#include "decoder_conv.cuh"

namespace spk {
namespace {

constexpr int TR = 2;                      // output tile rows
constexpr int CK = 32;                     // input channels per chunk
constexpr int XP = CK + 8;                 // halo pixel pitch (elements)
constexpr int CONV_THREADS = 256;

template <int CM>
struct ConvTile {
  static_assert(CM == 128, "Cm 64 runs on decoder_conv.cuh");
  static constexpr int MI = 1;                  // 16-pixel m-tiles per warp
  static constexpr int TC = 4 * 16 * MI;        // output pixels per tile row
  static constexpr int HR = TR + 2, HC = TC + 2;
  static constexpr int WP = CM + 8;             // weight row pitch (elements)
  static constexpr int SMEM = (HR * HC * XP + 9 * CK * WP) * 2;
};

// 8 channels [c, c + 8) of the bilinear sample (align_corners=False,
// clamped taps) of src [Hs, Ws, C] at pixel (Y, X) of the grid 1/f larger.
__device__ __forceinline__ uint4 bilinear8(const bf16* __restrict__ src, int Hs, int Ws,
                                           int C, int c, int Y, int X, float f) {
  const float sy = fmaxf((Y + 0.5f) * f - 0.5f, 0.f);
  const float sx = fmaxf((X + 0.5f) * f - 0.5f, 0.f);
  const int y0 = (int)sy, x0 = (int)sx;
  const int y1 = y0 + (y0 < Hs - 1 ? 1 : 0), x1 = x0 + (x0 < Ws - 1 ? 1 : 0);
  const float ly1 = sy - y0, ly0 = 1.f - ly1, lx1 = sx - x0, lx0 = 1.f - lx1;
  uint4 v00 = *reinterpret_cast<const uint4*>(src + ((long)y0 * Ws + x0) * C + c);
  uint4 v01 = *reinterpret_cast<const uint4*>(src + ((long)y0 * Ws + x1) * C + c);
  uint4 v10 = *reinterpret_cast<const uint4*>(src + ((long)y1 * Ws + x0) * C + c);
  uint4 v11 = *reinterpret_cast<const uint4*>(src + ((long)y1 * Ws + x1) * C + c);
  uint4 a;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float u = ly0 * (lx0 * bf(lanes(v00)[e]) + lx1 * bf(lanes(v01)[e])) +
                    ly1 * (lx0 * bf(lanes(v10)[e]) + lx1 * bf(lanes(v11)[e]));
    lanes(a)[e] = to_bf(u);
  }
  return a;
}

// x: UP ? [B, H/2, W/2, Cin] : [B, H, W, Cin]; w: [9 * Cin, CM] (tap-major
// rows (dy, dx, ci)); EDGE: ef [B, H/4, W/4, Ce] and we [9 * Ce, CM];
// out: HEAD ? pred [B, H, W] : y [B, H, W, CM].
template <bool UP, bool HEAD, int CM, bool EDGE>
__global__ void __launch_bounds__(CONV_THREADS, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ s, const float* __restrict__ t,
               const float* __restrict__ hw, const float* __restrict__ hb,
               bf16* __restrict__ out, int H, int W, int Cin,
               const bf16* __restrict__ ef, const bf16* __restrict__ we, int Ce) {
  using T = ConvTile<CM>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [HR * HC][XP]
  bf16* Ws = Xs + T::HR * T::HC * XP;             // [9 * CK][WP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ox0 = blockIdx.x * T::TC, oy0 = blockIdx.y * TR, b = blockIdx.z;
  const int Hl = UP ? H / 2 : H, Wl = UP ? W / 2 : W;  // input grid
  const int He = H / 4, We = W / 4;                    // edge grid
  const bf16* xb = x + (long)b * Hl * Wl * Cin;
  const bf16* eb = EDGE ? ef + (long)b * He * We * Ce : nullptr;
  const int wr = warp / 4, wc = (warp % 4) * 16 * T::MI;  // warp's output row, first pixel

  float acc[T::MI][CM / 8][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int n = 0; n < CM / 8; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  const int nx = Cin / CK, nchunks = nx + (EDGE ? Ce / CK : 0);
  for (int ch = 0; ch < nchunks; ++ch) {
    const bool edge = EDGE && ch >= nx;
    const int c0 = edge ? (ch - nx) * CK : ch * CK, ctot = edge ? Ce : Cin;
    const bf16* wsrc = edge ? we : w;
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < 9 * CK * (CM / 8); idx += CONV_THREADS) {
      const int r = idx / (CM / 8), cv = idx % (CM / 8);
      const int tap = r / CK, ci = r % CK;
      cp_async16(Ws + r * T::WP + cv * 8, wsrc + ((long)tap * ctot + c0 + ci) * CM + cv * 8, 16);
    }
    for (int idx = tid; idx < T::HR * T::HC * (CK / 8); idx += CONV_THREADS) {
      const int px = idx / (CK / 8), cv = idx % (CK / 8);
      const int Y = oy0 - 1 + px / T::HC, X = ox0 - 1 + px % T::HC;
      const bool in = Y >= 0 && Y < H && X >= 0 && X < W;
      bf16* dst = Xs + px * XP + cv * 8;
      const int c = c0 + cv * 8;
      if (!UP) {
        cp_async16(dst, in ? xb + ((long)Y * W + X) * Cin + c : x, in ? 16 : 0);
        continue;
      }
      uint4 a = zero_vec8();
      if (in)
        a = edge ? bilinear8(eb, He, We, Ce, c, Y, X, 0.25f)
                 : bilinear8(xb, Hl, Wl, Cin, c, Y, X, 0.5f);
      *reinterpret_cast<uint4*>(dst) = a;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        uint32_t af[T::MI][4];
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
          const int m = wc + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(af[i], Xs + ((wr + dy) * T::HC + m + dx) * XP + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < CM / 16; ++np) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, Ws + (tap * CK + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                          T::WP + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < T::MI; ++i) {
            mma_bf16(acc[i][2 * np], af[i], bfr[0], bfr[1]);
            mma_bf16(acc[i][2 * np + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
  }

  // Epilogue: folded BN + ReLU on the f32 sums, rounded to bf16; the head
  // contracts each pixel's CM channels across the 4 lanes that hold them.
  const int oy = oy0 + wr;
  if (oy >= H) return;
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ox = ox0 + wc + i * 16 + g + 8 * hh;
      const long pix = ((long)b * H + oy) * W + ox;
      float part = 0.f;
#pragma unroll
      for (int n = 0; n < CM / 8; ++n) {
        const int co = n * 8 + 2 * tq;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            fmaxf(acc[i][n][2 * hh] * s[co] + t[co], 0.f),
            fmaxf(acc[i][n][2 * hh + 1] * s[co + 1] + t[co + 1], 0.f));
        if (HEAD)
          part += __low2float(v) * hw[co] + __high2float(v) * hw[co + 1];
        else if (ox < W)
          *reinterpret_cast<__nv_bfloat162*>(out + pix * CM + co) = v;
      }
      if (HEAD) {
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (tq == 0 && ox < W) out[pix] = to_bf(part + hb[0]);
      }
    }
  }
}

template <bool UP, bool HEAD, int CM, bool EDGE>
cudaError_t launch_conv(const bf16* x, const bf16* w, const float* s, const float* t,
                        const float* hw, const float* hb, bf16* out, int B, int H, int W,
                        int Cin, const bf16* ef, const bf16* we, int Ce, cudaStream_t stream) {
  using T = ConvTile<CM>;
  cudaFuncSetAttribute(conv3x3_kernel<UP, HEAD, CM, EDGE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  const dim3 grid((W + T::TC - 1) / T::TC, (H + TR - 1) / TR, B);
  conv3x3_kernel<UP, HEAD, CM, EDGE><<<grid, CONV_THREADS, T::SMEM, stream>>>(
      x, w, s, t, hw, hb, out, H, W, Cin, ef, we, Ce);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

// x [B, S, S, Cin] (Cin 64 or 128), wt [64, 9 Cin]
// (rows: output channels, K (dy, dx, ci)) -> y [B, 2S, 2S, 64].
int sp_dec_upconv(const void* x, const void* wt, const void* s, const void* t, void* y, int B,
                  int S, int Cin, int grid, void* stream) {
  spk::DcArgs a{};
  a.x = x;
  a.w = wt;
  a.s = (const float*)s;
  a.t = (const float*)t;
  a.out = y;
  a.B = B;
  a.H = a.W = 2 * S;
  a.Cin = Cin;
  return (int)spk::dc_launch<spk::DC_UP>(a, grid, (cudaStream_t)stream);
}

// y [B, H, W, 64] (H even), wt [64, 576] -> pred [B, H, W].
int sp_dec_conv_head(const void* y, const void* wt, const void* s, const void* t,
                     const void* hw, const void* hb, void* pred, int B, int H, int W, int grid,
                     void* stream) {
  spk::DcArgs a{};
  a.x = y;
  a.w = wt;
  a.s = (const float*)s;
  a.t = (const float*)t;
  a.hw = (const float*)hw;
  a.hb = (const float*)hb;
  a.out = pred;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = 64;
  return (int)spk::dc_launch<spk::DC_HEAD>(a, grid, (cudaStream_t)stream);
}

// x [B, S, S, Cin], ef [B, S/2, S/2, Ce] -> y [B, 2S, 2S, 128].
int sp_upconv3x3_edge_bn_relu(const void* x, const void* w, const void* ef, const void* we,
                              const void* s, const void* t, void* y, int B, int S, int Cin,
                              int Ce, void* stream) {
  return (int)spk::launch_conv<true, false, 128, true>(
      (const bf16*)x, (const bf16*)w, (const float*)s, (const float*)t, nullptr, nullptr,
      (bf16*)y, B, 2 * S, 2 * S, Cin, (const bf16*)ef, (const bf16*)we, Ce,
      (cudaStream_t)stream);
}

// y [B, H, W, 128] -> pred [B, H, W].
int sp_conv3x3_bn_relu_head(const void* y, const void* w, const void* s, const void* t,
                            const void* hw, const void* hb, void* pred, int B, int H, int W,
                            void* stream) {
  return (int)spk::launch_conv<false, true, 128, false>(
      (const bf16*)y, (const bf16*)w, (const float*)s, (const float*)t, (const float*)hw,
      (const float*)hb, (bf16*)pred, B, H, W, 128, nullptr, nullptr, 0, (cudaStream_t)stream);
}

// y [B, H, W, 128] -> y2 [B, H, W, 128].
int sp_conv3x3_bn_relu(const void* y, const void* w, const void* s, const void* t, void* out,
                       int B, int H, int W, void* stream) {
  return (int)spk::launch_conv<false, false, 128, false>(
      (const bf16*)y, (const bf16*)w, (const float*)s, (const float*)t, nullptr, nullptr,
      (bf16*)out, B, H, W, 128, nullptr, nullptr, 0, (cudaStream_t)stream);
}

}  // extern "C"
