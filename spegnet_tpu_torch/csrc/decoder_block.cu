// PED decoder block 2 on Hopper (no edge branch, bf16):
//
//   y1   = relu(conv3x3(up2(x)) * s1 + t1)           sp_upconv3x3_bn_relu
//   pred = relu(conv3x3(y1) * s2 + t2) . w_head + b  sp_conv3x3_bn_relu_head
//
// Replaces spegnet_tpu/ops/fused_decoder.py `_dec_kernel` (:338) with
// int8=False and no edge branch.  conv1 reads the 2x bilinear sample of the
// low-resolution input directly (torch align_corners=False: source
// (o + 0.5) / 2 - 0.5 clamped at 0, neighbour clamped at S - 1, weights
// 0.25 / 0.75), rounded to bf16 as F.interpolate would, with zero padding at
// the 2S border.  That is exact everywhere, so the TPU kernel's polyphase
// packing and its separately computed border strips are not needed.  BN is
// folded (s, t include the conv bias) and applied with the ReLU in the
// epilogue.  y1 [B, 2S, 2S, 64] goes through device memory; y2 never does:
// the second kernel applies BN + ReLU, rounds to bf16 and contracts the 64
// channels with the 1x1 head in its epilogue.
//
// Both convolutions are implicit GEMMs on mma.sync.m16n8k16: a CTA owns a
// 2-row x 128-pixel output tile times all 64 output channels (8 warps of
// 32 pixels x 64 channels).  Per chunk of 32 input channels it stages the
// tile's input halo (4 x 130 pixels; for conv1 each halo pixel's bilinear
// sample is built once, not once per tap) and the chunk's 9 x 32 x 64
// weights in shared memory; the 9 taps are then shifted ldmatrix reads of
// the same halo.  Bound on the H100: conv1 is 2 * 64 * 9 * Cin FLOPs per
// output pixel, tensor-core bound once the halo is staged.
#include "common.cuh"

namespace spk {
namespace {

constexpr int CM = 64;                     // output channels
constexpr int TR = 2, TC = 128;            // output tile: rows x pixels
constexpr int HR = TR + 2, HC = TC + 2;    // input halo
constexpr int CK = 32;                     // input channels per chunk
constexpr int XP = CK + 8;                 // halo pixel pitch (elements)
constexpr int WP = CM + 8;                 // weight row pitch (elements)
constexpr int CONV_THREADS = 256;
constexpr int CONV_SMEM = (HR * HC * XP + 9 * CK * WP) * 2;

// x: UP ? [B, H/2, W/2, Cin] : [B, H, W, Cin]; w: [9 * Cin, 64] (tap-major
// rows (dy, dx, ci)); out: HEAD ? pred [B, H, W] : y [B, H, W, 64].
template <bool UP, bool HEAD>
__global__ void __launch_bounds__(CONV_THREADS, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ s, const float* __restrict__ t,
               const float* __restrict__ hw, const float* __restrict__ hb,
               bf16* __restrict__ out, int H, int W, int Cin) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [HR * HC][XP]
  bf16* Ws = Xs + HR * HC * XP;                   // [9 * CK][WP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ox0 = blockIdx.x * TC, oy0 = blockIdx.y * TR, b = blockIdx.z;
  const int Hl = UP ? H / 2 : H, Wl = UP ? W / 2 : W;  // input grid
  const bf16* xb = x + (long)b * Hl * Wl * Cin;
  const int wr = warp / 4, wc = (warp % 4) * 32;  // warp's output row, first pixel

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < 9 * CK * (CM / 8); idx += CONV_THREADS) {
      const int r = idx / (CM / 8), cv = idx % (CM / 8);
      const int tap = r / CK, ci = r % CK;
      cp_async16(Ws + r * WP + cv * 8, w + ((long)tap * Cin + c0 + ci) * CM + cv * 8, 16);
    }
    for (int idx = tid; idx < HR * HC * (CK / 8); idx += CONV_THREADS) {
      const int px = idx / (CK / 8), cv = idx % (CK / 8);
      const int Y = oy0 - 1 + px / HC, X = ox0 - 1 + px % HC;
      const bool in = Y >= 0 && Y < H && X >= 0 && X < W;
      bf16* dst = Xs + px * XP + cv * 8;
      const int c = c0 + cv * 8;
      if (!UP) {
        cp_async16(dst, in ? xb + ((long)Y * W + X) * Cin + c : x, in ? 16 : 0);
        continue;
      }
      uint4 a = zero_vec8();
      if (in) {
        const float sy = fmaxf((Y + 0.5f) * 0.5f - 0.5f, 0.f);
        const float sx = fmaxf((X + 0.5f) * 0.5f - 0.5f, 0.f);
        const int y0 = (int)sy, x0 = (int)sx;
        const int y1 = y0 + (y0 < Hl - 1 ? 1 : 0), x1 = x0 + (x0 < Wl - 1 ? 1 : 0);
        const float ly1 = sy - y0, ly0 = 1.f - ly1, lx1 = sx - x0, lx0 = 1.f - lx1;
        uint4 v00 = *reinterpret_cast<const uint4*>(xb + ((long)y0 * Wl + x0) * Cin + c);
        uint4 v01 = *reinterpret_cast<const uint4*>(xb + ((long)y0 * Wl + x1) * Cin + c);
        uint4 v10 = *reinterpret_cast<const uint4*>(xb + ((long)y1 * Wl + x0) * Cin + c);
        uint4 v11 = *reinterpret_cast<const uint4*>(xb + ((long)y1 * Wl + x1) * Cin + c);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float u = ly0 * (lx0 * bf(lanes(v00)[e]) + lx1 * bf(lanes(v01)[e])) +
                          ly1 * (lx0 * bf(lanes(v10)[e]) + lx1 * bf(lanes(v11)[e]));
          lanes(a)[e] = to_bf(u);
        }
      }
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
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = wc + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(af[i], Xs + ((wr + dy) * HC + m + dx) * XP + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < CM / 16; ++np) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, Ws + (tap * CK + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                          WP + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * np], af[i], bfr[0], bfr[1]);
            mma_bf16(acc[i][2 * np + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
  }

  // Epilogue: folded BN + ReLU on the f32 sums, rounded to bf16; the head
  // contracts each pixel's 64 channels across the 4 lanes that hold them.
  const int oy = oy0 + wr;
  if (oy >= H) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ox = ox0 + wc + i * 16 + g + 8 * hh;
      const long pix = ((long)b * H + oy) * W + ox;
      float part = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
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

template <bool UP, bool HEAD>
cudaError_t launch_conv(const bf16* x, const bf16* w, const float* s, const float* t,
                        const float* hw, const float* hb, bf16* out, int B, int H, int W,
                        int Cin, cudaStream_t stream) {
  cudaFuncSetAttribute(conv3x3_kernel<UP, HEAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       CONV_SMEM);
  const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  conv3x3_kernel<UP, HEAD><<<grid, CONV_THREADS, CONV_SMEM, stream>>>(x, w, s, t, hw, hb, out,
                                                                     H, W, Cin);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

// x [B, S, S, Cin] -> y [B, 2S, 2S, 64].
int sp_upconv3x3_bn_relu(const void* x, const void* w, const void* s, const void* t,
                         void* y, int B, int S, int Cin, void* stream) {
  return (int)spk::launch_conv<true, false>((const bf16*)x, (const bf16*)w, (const float*)s,
                                            (const float*)t, nullptr, nullptr, (bf16*)y, B,
                                            2 * S, 2 * S, Cin, (cudaStream_t)stream);
}

// y [B, H, W, 64] -> pred [B, H, W].
int sp_conv3x3_bn_relu_head(const void* y, const void* w, const void* s, const void* t,
                            const void* hw, const void* hb, void* pred, int B, int H, int W,
                            void* stream) {
  return (int)spk::launch_conv<false, true>((const bf16*)y, (const bf16*)w, (const float*)s,
                                            (const float*)t, (const float*)hw,
                                            (const float*)hb, (bf16*)pred, B, H, W, spk::CM,
                                            (cudaStream_t)stream);
}

}  // extern "C"
