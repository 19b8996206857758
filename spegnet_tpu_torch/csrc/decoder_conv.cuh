// The 3x3 convolution frame of the PED decoder kernels (decoder_block.cu,
// decoder_i8.cu) on Hopper: TMA / producer-built halos, s8 or bf16 wgmma.
//
// A work tile is TR output rows (2; 1 for DC_STRIP) of DC_TC = 128 pixels
// times all 64 output channels.  The output channels sit on wgmma's M and
// the pixels on its N (D^T = W X^T: m64n128k16 bf16, m64n128k32 s8), so a
// k-step reads 2 KB of weights and 4 KB of pixels from shared memory per 64
// tensor clocks instead of 4 + 4 KB per 32 with the pixels on M (Cm 64 is
// too narrow an N).  Both operands are K-major with no swizzle: a core
// matrix is 8 rows of 16 contiguous bytes, so any pixel is a legal start and
// the nine taps are shifted descriptors into one halo (a 128-byte swizzled
// tile takes starts only at multiples of 8 rows).
//
// Shared memory, in 16-byte "planes" (16 bytes of channels per pixel: 8
// bf16 or 16 int8):
// * the weights, resident for the block's whole walk: bf16 as [9 Cin * 2 /
//   128 blocks][64 channels][128 B], 128-byte swizzled (SBO 1 KB); int8 as
//   [9 Cin / 16 planes][64 channels][16 B] (a plane is one 1 KB block of 64
//   rows; LBO 1 KB between the two planes of a k-step, SBO 128 B);
// * for DC_UP and DC_Q8 a TMA landing ring of two slots (below);
// * a ring of ST stages, each NP planes of the halo of one tile: [NP][HR =
//   TR + 2 rows][DC_HC = 130 pixels][16 B] (LBO the plane size, SBO 128 B);
//   output row r's tap (dy, dx) starts at pixel (r + dy) * 130 + dx;
// * the two consumers' epilogue staging, [64 pixels][72] bf16 each.
//
// Warpgroup 0 produces, warpgroups 1 and 2 consume, taking the block's tiles
// in turn (tile k of its walk to consumer k % 2), so that one consumer's
// epilogue overlaps the other's MMAs.  Per stage a consumer issues TR x 9
// taps x NP / 2 k-steps of wgmma into TR sets of f32 / s32 sums, keeps one
// stage's MMAs in flight and releases a stage once the MMAs that read it
// have retired.  The producer fills the stages in walk order, running ahead
// across tiles, by mode:
// * DC_UP     conv1 of decoder block 2 (bf16): one thread loads x's 3 x 66
//             source pixels of 16 channels around the tile into a landing
//             slot by TMA; warps 1-3 build the 2x bilinear sample from it
//             (align_corners=False, clamped taps, rounded once to bf16 as
//             F.interpolate does, zero outside [0, 2S)), a 2 x 2 block of
//             output pixels from the same four source pixels;
// * DC_STRIP  the border strips of the int8 mode: the outermost rows (top,
//             bottom) and, on the transposed image, columns (left, right) of
//             conv3x3(up2(x)), one strip row a tile; the producer builds the
//             sample from x in device memory as
//             ops/fused_upsample_conv.border_strips does (the pair of source
//             rows across the strip lerped in f32 and rounded to bf16, then
//             the lerp along it rounded again);
// * DC_HEAD   conv2 + head of block 2 (bf16): one thread issues one 4-D
//             TMA box a tile, y1's 4 x 130 halo pixels at (b, y - 1, x - 1)
//             as 128-byte rows with the 128-byte swizzle (any row is a legal
//             start: the swizzle is of the address), out-of-bound elements
//             zero: conv2's SAME padding;
// * DC_Q8     conv2 + head of the int8 mode: y1's halo lands by TMA (32
//             channels a slot, 64-byte swizzled rows), and warps 1-3 write
//             its codes round(y1 * (1 / sa)) with the tile's strip scale
//             into the stage.
// The f32 (s32) sum of every output runs over (stage, tap, k-step) in that
// order, with no atomics: two calls give the same bits.
//
// Epilogue, per consumer and output row, in two halves of 64 pixels: folded
// BN + ReLU (or the int8 dequant, or the raw bf16 sum for DC_STRIP), rounded
// to bf16 into the staging buffer as [pixel][channel], then either 16-byte
// stores of whole pixels (y1, the strips, y2) or, for the head, one thread
// per pixel contracting its 64 channels in a fixed order: for c = 8k + 2t +
// e the products of each pair e, the pairs over k in turn, then the four
// sums over t as a tree, + hb (no FMA; ops/fused_decoder._head_i8).
#pragma once

#include <cstring>
#include <type_traits>

#include "wgmma_attn.cuh"

namespace spk {

constexpr int DC_TC = 128;            // output pixels of a consumer's row (wgmma N)
constexpr int DC_HC = DC_TC + 2;      // halo pixels of a row
constexpr int DC_CM = 64;             // output channels (wgmma M)
constexpr int DC_THREADS = 384;       // producer + two consumer warpgroups
constexpr int DC_HALF = 64;           // pixels per epilogue half
constexpr int DC_SP = 72;             // staging pitch (bf16) of a pixel's 64 channels
constexpr int DC_STAGING = 2 * DC_HALF * DC_SP * 2;
constexpr int DC_SMEM_MAX = 232448;

enum DcMode { DC_UP = 0, DC_STRIP = 1, DC_HEAD = 2, DC_Q8 = 3, DC_Q8Y2 = 4 };

template <int MODE>
struct DcCfg {
  static constexpr bool INT8 = MODE >= DC_Q8;
  static constexpr bool HEAD = MODE == DC_HEAD || MODE >= DC_Q8;
  // a TMA landing ring that producer warps 1-3 turn into the stages
  static constexpr bool LANDED = MODE == DC_UP || INT8;
  static constexpr int TR = MODE == DC_STRIP ? 1 : 2;           // output rows a tile
  static constexpr int HR = TR + 2;                              // halo rows
  // DC_HEAD's stage is all 64 channels of the halo, 128-byte swizzled rows
  // as TMA writes them; the others' 2 planes of 16 bytes
  static constexpr bool SW = MODE == DC_HEAD;
  static constexpr int NP = SW ? 8 : 2;                          // 16 bytes of channels a stage
  static constexpr int KP_MAX = INT8 ? 36 : (MODE == DC_HEAD ? 72 : 144);  // weight planes
  static constexpr int PLANE = HR * DC_HC * 16;
  static constexpr int STAGE = NP * PLANE;
  static constexpr int WBYTES = KP_MAX * DC_CM * 16;
  // landing slot: DC_UP the 3 x 66 source pixels of 16 channels of x (padded
  // to 128 bytes), DC_Q8 the 4 x 130 halo of 32 channels of y1 (bf16, rows of
  // 64 bytes, 64-byte swizzled; padded to 1024 bytes)
  static constexpr int LAND = MODE == DC_UP ? 6400 : (INT8 ? 33792 : 0);
  static constexpr int LST = LANDED ? 2 : 0;
  static constexpr int FIXED = 1024 + WBYTES + LST * LAND + DC_STAGING + 128;
  static constexpr int FIT = (DC_SMEM_MAX - FIXED) / STAGE;
  static constexpr int ST = FIT > 6 ? 6 : FIT;
  static constexpr int BYTES = FIXED + ST * STAGE;
  // registers: a producer that only issues TMA keeps few; the warpgroups
  // share the 168 a thread of the 384 gets at launch
  static constexpr int PRODUCER_REGS = MODE == DC_HEAD ? 40 : 96;
  static constexpr int CONSUMER_REGS = MODE == DC_HEAD ? 232 : 200;
  static_assert(ST >= 2 && BYTES <= DC_SMEM_MAX, "shared memory");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= DC_THREADS * 168, "registers");
  // 16-byte aligned planes (descriptors); 128-byte for TMA's boxes
  // 16-byte aligned planes (descriptors); 1024-byte aligned swizzled boxes
  static_assert(PLANE % 16 == 0 && STAGE % 16 == 0 && WBYTES % 1024 == 0 &&
                    (!SW || STAGE % 1024 == 0) && LAND % 128 == 0 && (!INT8 || LAND % 1024 == 0),
                "aligned planes");
};

// Arguments of dec_conv_kernel (by mode: see the entry points).
struct DcArgs {
  const void* x;        // UP / STRIP: x [B, S, S, Cin] bf16; Q8: y1 [B, H, W, 64] bf16
  const void* w;        // [64][9 Cin] (bf16) or [64][576] (int8), K (dy, dx, ci) contiguous
  const float* s;       // UP / HEAD: folded BN scale [64]; Q8: sw2 [64]
  const float* t;       // folded BN shift [64]
  const float* hw;      // head weights [64]
  const float* hb;      // head bias [1]
  const float* amax;    // Q8: strip maxima [B, nsi]
  const float* sa_in;   // Q8: given strip scales [B, nsi], or null (from amax)
  float* sa_out;        // Q8: the strip scales, written by block 0, or null
  void* out;            // UP: y [B, H, W, 64]; STRIP: [4, B, W, 64]; HEAD / Q8: pred [B, H, W]
  void* y2;             // Q8Y2: conv2's activated map [B, H, W, 64]
  int B, H, W, Cin, sh, nsi;  // H, W: the 2S grid; sh: strip height in cell rows
};

constexpr float DC_INV127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float dc_q_scale(float amax) {
  return fmaxf(__fmul_rn(amax, DC_INV127), 1e-12f);
}

// Descriptor of a K-major operand with no swizzle: core matrices of 8 rows
// x 16 contiguous bytes, 8-row groups 128 B apart, the next 16 bytes of K
// `lbo` further.  Any 16-byte aligned start is legal.
__device__ __forceinline__ uint64_t dc_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(128 >> 4) << 32);
}

// mbar_wait that traps instead of hanging when a barrier never completes
// (a fault in the protocol), so that the launch fails with an error.
__device__ __forceinline__ void dc_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (long n = 0; !done; ++n) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (n > (1L << 24)) __trap();
  }
}

__device__ __forceinline__ void dc_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// D[64 x 128] (+)= A B, both operands K-major in shared memory, the sum
// taken from zero where scale_d is 0: bf16 m64n128k16 (f32 sums) and s8
// m64n128k32 (s32 sums).  Accumulators as common.cuh's wgmma_m64k16.
__device__ __forceinline__ void dc_mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void dc_mma(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Copies rows [r0, r0 + rows) of a row-major [*, kbytes] operand into
// shared memory as [kbytes / 16 planes][rows][16 B] (cp.async, not waited).
__device__ __forceinline__ void dc_load_planes(unsigned char* dst, const void* src, int r0,
                                               int rows, int kbytes, int tid, int nthreads) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  const int kp = kbytes / 16;
  for (int idx = tid; idx < kp * rows; idx += nthreads) {
    const int r = idx % rows, p = idx / rows;
    cp_async16(dst + (p * rows + r) * 16, s + (long)(r0 + r) * kbytes + p * 16, 16);
  }
  cp_async_commit();
}

// Copies rows [r0, r0 + rows) of a row-major [*, kbytes] operand into
// shared memory 128-byte swizzled, K-major: [kbytes / 128 blocks][rows][128
// B], 16-byte chunk c of row r at chunk c ^ (r % 8) (cp.async, not waited).
__device__ __forceinline__ void dc_load_sw128(unsigned char* dst, const void* src, int r0,
                                              int rows, int kbytes, int tid, int nthreads) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  for (int idx = tid; idx < kbytes / 16 * rows; idx += nthreads) {
    const int r = idx % rows, k = idx / rows, kb = k / 8, c = k % 8;
    cp_async16(dst + (kb * rows + r) * 128 + ((c ^ (r & 7)) << 4),
               s + (long)(r0 + r) * kbytes + k * 16, 16);
  }
  cp_async_commit();
}

// Byte offset, in dc_load_sw128's layout of `rows` rows, of K byte k (a
// multiple of 16 inside one 128-byte block).
__device__ __forceinline__ uint32_t dc_sw128_off(int k, int rows) {
  return (k / 128) * rows * 128 + k % 128;
}

// 8 lerped bf16 values of the 2-tap rows (l0 a + l1 b) of two bf16 vectors,
// each rounded once from f32.
__device__ __forceinline__ uint4 dc_lerp8(const uint4& a, const uint4& b, float l0, float l1) {
  uint4 a_ = a, b_ = b, r;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    lanes(r)[e] = to_bf(__fadd_rn(__fmul_rn(l0, bf(lanes(a_)[e])), __fmul_rn(l1, bf(lanes(b_)[e]))));
  return r;
}

// The source index and upper weight of 2x bilinear output coordinate X
// (align_corners=False, clamped at 0).
__device__ __forceinline__ float dc_src(int X, int& x0) {
  const float sx = fmaxf((X + 0.5f) * 0.5f - 0.5f, 0.f);
  x0 = (int)sx;
  return sx - x0;
}

// Tile `tile` of the walk: image b, first output row y0 (DC_STRIP: the
// strip's row, 0 or W - 1, of orientation o: 0 rows, 1 the transposed
// image's, i.e. columns), first output column x0; DC_STRIP's strip index
// 2 o + (y0 > 0) is its place in [top, bottom, left, right].
struct DcTile {
  int b, y0, x0, o;
};

template <int MODE>
__device__ __forceinline__ DcTile dc_tile(long tile, int ct, int H, int W) {
  const int c = (int)(tile % ct);
  const long rest = tile / ct;
  if (MODE == DC_STRIP) {
    const int k = (int)(rest % 4);
    return DcTile{(int)(rest / 4), k % 2 ? W - 1 : 0, c * DC_TC, k / 2};
  }
  const int r = (int)(rest % (H / 2));
  return DcTile{(int)(rest / (H / 2)), 2 * r, c * DC_TC, 0};
}

// DC_UP: the 2x bilinear sample of the chunk's 16 channels at the tile's
// 4 x 130 halo pixels, from the landing slot `land` (x's 3 x 66 source
// pixels around the tile: rows y0 / 2 - 1 .., columns x0 / 2 - 1 ..), by
// producer thread ptid of nthr.  A 2 x 2 block of output pixels (2k - 1,
// 2k) x (2m - 1, 2m) reads the same four source pixels; each output is
// ly0 (lx0 f00 + lx1 f01) + ly1 (lx0 f10 + lx1 f11), the row sums shared.
__device__ __forceinline__ void dc_build_up(unsigned char* st, const unsigned char* land,
                                            const DcArgs& a, const DcTile& tl, int ptid,
                                            int nthr) {
  constexpr int PLANE = DcCfg<DC_UP>::PLANE;
  const int S = a.H / 2, rbase = tl.y0 / 2 - 1, cbase = tl.x0 / 2 - 1;
  const uint4* L = reinterpret_cast<const uint4*>(land);
  for (int u = ptid; u < 2 * 65 * 2; u += nthr) {
    const int p = u & 1, m = (u >> 1) % 65, hp = (u >> 1) / 65;
    const int Y0 = tl.y0 - 1 + 2 * hp, X0 = tl.x0 - 1 + 2 * m;  // = 2 mr + 1, 2 mc + 1
    const int mr = (Y0 - 1) / 2, mc = (X0 - 1) / 2;
    const int rA = max(mr, 0) - rbase, rB = min(mr + 1, S - 1) - rbase;
    const int cA = max(mc, 0) - cbase, cB = min(mc + 1, S - 1) - cbase;
    uint4 v[2][2] = {{L[(rA * 66 + cA) * 2 + p], L[(rA * 66 + cB) * 2 + p]},
                     {L[(rB * 66 + cA) * 2 + p], L[(rB * 66 + cB) * 2 + p]}};
    float ly[2][2], lx[2][2];
    bool rin[2], cin[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int r0;
      ly[i][1] = dc_src(Y0 + i, r0);
      ly[i][0] = 1.f - ly[i][1];
      lx[i][1] = dc_src(X0 + i, r0);
      lx[i][0] = 1.f - lx[i][1];
      rin[i] = Y0 + i >= 0 && Y0 + i < a.H;
      cin[i] = X0 + i >= 0 && X0 + i < a.W;
    }
    uint4 o[2][2];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float2 f[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) f[r][c] = __bfloat1622float2(pairs(v[r][c])[e / 2]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // the two source rows lerped along x for output column j
        const float h0x = lx[j][0] * f[0][0].x + lx[j][1] * f[0][1].x;
        const float h0y = lx[j][0] * f[0][0].y + lx[j][1] * f[0][1].y;
        const float h1x = lx[j][0] * f[1][0].x + lx[j][1] * f[1][1].x;
        const float h1y = lx[j][0] * f[1][0].y + lx[j][1] * f[1][1].y;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          pairs(o[i][j])[e / 2] = rin[i] && cin[j]
                                      ? __floats2bfloat162_rn(ly[i][0] * h0x + ly[i][1] * h1x,
                                                              ly[i][0] * h0y + ly[i][1] * h1y)
                                      : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4* dst = reinterpret_cast<uint4*>(st + p * PLANE + ((2 * hp + i) * DC_HC + 2 * m) * 16);
      dst[0] = o[i][0];
      dst[1] = o[i][1];
    }
  }
}

// DC_STRIP: the strip row's halo (the 3 rows around it in the orientation's
// image) for the chunk's 16 channels, as border_strips builds the sample.
__device__ __forceinline__ void dc_fill_strip(unsigned char* st, const DcArgs& a,
                                              const DcTile& tl, int ch, int ptid) {
  constexpr int PLANE = DcCfg<DC_STRIP>::PLANE;
  const int S = a.H / 2, Cin = a.Cin, W = a.W;
  const bf16* xb = reinterpret_cast<const bf16*>(a.x) + (long)tl.b * S * S * Cin + ch * 16;
  for (int u = ptid; u < 3 * 65 * 2; u += 128) {
    const int p = u & 1, m = (u >> 1) % 65, h = (u >> 1) / 65;
    const int A = tl.y0 - 1 + h;  // the coordinate across the strip
    const int Xa = tl.x0 - 1 + 2 * m, Xb = Xa + 1;
    uint4 va = zero_vec8(), vb = zero_vec8();
    if (A >= 0 && A < W && Xa < W) {
      int a0, ia, ib;
      const float l1 = dc_src(A, a0), l0 = 1.f - l1;
      const int a1 = a0 + (a0 < S - 1 ? 1 : 0);
      const int mm = (Xa - 1) / 2;
      const int cA = max(mm, 0), cB = min(mm + 1, S - 1);
      // source (row, column) of (across, along) in the orientation's image
      auto at = [&](int across, int along) {
        const long pix = tl.o ? (long)along * S + across : (long)across * S + along;
        return __ldg(reinterpret_cast<const uint4*>(xb + pix * Cin) + p);
      };
      const uint4 pA = dc_lerp8(at(a0, cA), at(a1, cA), l0, l1);
      const uint4 pB = dc_lerp8(at(a0, cB), at(a1, cB), l0, l1);
      const float la1 = dc_src(Xa, ia), la0 = 1.f - la1;
      const float lb1 = dc_src(Xb, ib), lb0 = 1.f - lb1;
      if (Xa >= 0) va = dc_lerp8(pA, pB, la0, la1);
      if (Xb < W) vb = dc_lerp8(pA, pB, lb0, lb1);
    }
    uint4* dst = reinterpret_cast<uint4*>(st + p * PLANE + (h * DC_HC + 2 * m) * 16);
    dst[0] = va;
    dst[1] = vb;
  }
}

// DC_Q8: the codes of 32 channels of y1 at the tile's 4 x 130 halo pixels,
// with reciprocal scale ra, from the landing slot: a row of 64 bytes a
// pixel, TMA's 64-byte swizzle (16-byte chunk c of row p at chunk c ^ ((p
// >> 1) & 3)), zeros outside the grid.
__device__ __forceinline__ void dc_build_q8(unsigned char* st, const unsigned char* land,
                                            float ra, int ptid, int nthr) {
  constexpr int PLANE = DcCfg<DC_Q8>::PLANE;
  for (int u = ptid; u < 4 * DC_HC * 2; u += nthr) {
    const int q = u & 1, px = u >> 1;  // px: the halo pixel h * 130 + x
    const unsigned char* row = land + px * 64;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      uint4 v = *reinterpret_cast<const uint4*>(row + (((2 * q + hv) ^ ((px >> 1) & 3)) << 4));
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[2 * hv + e / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(
                                 __fmul_rn(bf(lanes(v)[e]), ra)) << (8 * (e % 4));
    }
    *reinterpret_cast<uint4*>(st + q * PLANE + px * 16) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The head of one pixel's 64 staged channels (see the header).
__device__ __forceinline__ float dc_head(const bf16* row, const float* hw, float hb) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint4 v = reinterpret_cast<const uint4*>(row)[k];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
      part[tt] = __fadd_rn(part[tt],
                           __fadd_rn(__fmul_rn(bf(lanes(v)[2 * tt]), hw[8 * k + 2 * tt]),
                                     __fmul_rn(bf(lanes(v)[2 * tt + 1]), hw[8 * k + 2 * tt + 1])));
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3])), hb);
}

template <int MODE>
__global__ void __launch_bounds__(DC_THREADS, 1)
dec_conv_kernel(const __grid_constant__ CUtensorMap tmap, const DcArgs a) {
  using C = DcCfg<MODE>;
  using Acc = typename std::conditional<C::INT8, int, float>::type;
  constexpr int ST = C::ST, PLANE = C::PLANE, STAGE = C::STAGE, NP = C::NP, TR = C::TR;
  constexpr int LST = C::LST, LAND = C::LAND;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ws = base;
  unsigned char* landing = base + C::WBYTES;
  unsigned char* ring = landing + LST * LAND;
  bf16* staging = reinterpret_cast<bf16*>(ring + ST * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(staging) +
                                               DC_STAGING);
  uint64_t* empty = full + ST;
  uint64_t* lfull = empty + ST;
  uint64_t* lempty = lfull + LST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int cbytes = a.Cin * (C::INT8 ? 1 : 2);  // bytes of channels per pixel
  const int kpt = cbytes / 16;                   // weight planes per tap
  const int nch = cbytes / (16 * NP);            // stages per tile
  const int ct = (a.W + DC_TC - 1) / DC_TC;
  const long tiles = (long)a.B * (MODE == DC_STRIP ? 4 : a.H / 2) * ct;

  if (C::INT8) dc_load_planes(Ws, a.w, 0, DC_CM, 9 * cbytes, tid, DC_THREADS);
  else dc_load_sw128(Ws, a.w, 0, DC_CM, 9 * cbytes, tid, DC_THREADS);
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], MODE == DC_HEAD ? 1 : (C::LANDED ? 96 : 128));
      mbar_init(&empty[s], 256);
    }
    for (int l = 0; l < LST; ++l) {
      mbar_init(&lfull[l], 1);
      mbar_init(&lempty[l], 96);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (C::INT8 && a.sa_out && blockIdx.x == 0)
      for (int i = tid; i < a.B * a.nsi; i += 128) a.sa_out[i] = dc_q_scale(a.amax[i]);
    if constexpr (MODE == DC_HEAD) {
      // one thread: the TMA load of every stage of the block's walk
      if (tid != 0) return;
      long it = 0;
      for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        const DcTile tl = dc_tile<MODE>(tile, ct, a.H, a.W);
        const int s = (int)(it % ST);
        if (it >= ST) dc_wait(&empty[s], (int)((it / ST - 1) & 1));
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_4d(ring + s * STAGE, &tmap, &full[s], 0, tl.x0 - 1, tl.y0 - 1, tl.b);
      }
      return;
    }
    if constexpr (C::LANDED) {
      if (tid < 32) {
        // warp 0, one thread: the TMA load of every landing slot of the
        // block's walk, running up to LST slots ahead of the build
        if (tid != 0) return;
        long it = 0;
        for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const DcTile tl = dc_tile<MODE>(tile, ct, a.H, a.W);
          for (int ch = 0; ch < nch; ++ch, ++it) {
            const int l = (int)(it % LST);
            if (it >= LST) dc_wait(&lempty[l], (int)((it / LST - 1) & 1));
            unsigned char* ld = landing + l * LAND;
            if constexpr (MODE == DC_UP) {
              mbar_arrive_expect_tx(&lfull[l], 3 * 66 * 32);
              tma_load_4d(ld, &tmap, &lfull[l], ch * 16, tl.x0 / 2 - 1, tl.y0 / 2 - 1, tl.b);
            } else {
              mbar_arrive_expect_tx(&lfull[l], 4 * DC_HC * 64);
              tma_load_4d(ld, &tmap, &lfull[l], ch * 32, tl.x0 - 1, tl.y0 - 1, tl.b);
            }
          }
        }
        return;
      }
      // warps 1-3: each landing slot into its stage
      const int ptid = tid - 32;
      long it = 0;
      for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const DcTile tl = dc_tile<MODE>(tile, ct, a.H, a.W);
        float ra = 0.f;
        if (C::INT8) {
          const int k = tl.b * a.nsi + tl.y0 / (2 * a.sh);
          ra = __fdiv_rn(1.0f, a.sa_in ? a.sa_in[k] : dc_q_scale(a.amax[k]));
        }
        for (int ch = 0; ch < nch; ++ch, ++it) {
          const int l = (int)(it % LST), s = (int)(it % ST);
          dc_wait(&lfull[l], (int)((it / LST) & 1));
          if (it >= ST) dc_wait(&empty[s], (int)((it / ST - 1) & 1));
          if constexpr (MODE == DC_UP)
            dc_build_up(ring + s * STAGE, landing + l * LAND, a, tl, ptid, 96);
          if constexpr (C::INT8) dc_build_q8(ring + s * STAGE, landing + l * LAND, ra, ptid, 96);
          fence_proxy_async();
          mbar_arrive(&full[s]);
          mbar_arrive(&lempty[l]);
        }
      }
      return;
    }
    // DC_STRIP: all 128 threads build the stages from x in device memory
    long it = 0;
    for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const DcTile tl = dc_tile<MODE>(tile, ct, a.H, a.W);
      for (int ch = 0; ch < nch; ++ch, ++it) {
        const int s = (int)(it % ST);
        if (it >= ST) dc_wait(&empty[s], (int)((it / ST - 1) & 1));
        dc_fill_strip(ring + s * STAGE, a, tl, ch, tid);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = wg - 1, ctid = tid - 128 * wg, w = ctid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* stg = staging + cw * DC_HALF * DC_SP;
  // tile k of the block's walk (k = 0, 1, ...) goes to consumer k % 2; its
  // stages are k * nch .. k * nch + nch - 1 of the producer's order.  Both
  // consumers wait for every fill of the ring in order and release it (the
  // other's tiles at once), so that no wait reaches two phases ahead.
  long k = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    if (k % 2 != cw) {
      for (int ch = 0; ch < nch; ++ch) {
        const long it = k * nch + ch;
        dc_wait(&full[(int)(it % ST)], (int)((it / ST) & 1));
        mbar_arrive(&empty[(int)(it % ST)]);
      }
      continue;
    }
    const DcTile tl = dc_tile<MODE>(tile, ct, a.H, a.W);
    // each row's sums start from zero at its first k-step (scale-d 0)
    Acc d[TR][64];
    if constexpr (MODE == DC_STRIP) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[0][i] = 0.f;
    }
    for (int ch = 0; ch < nch; ++ch) {
      const long it = k * nch + ch;
      const int s = (int)(it % ST);
      dc_wait(&full[s], (int)((it / ST) & 1));
      const unsigned char* st = ring + s * STAGE;
      if constexpr (MODE == DC_STRIP) {
        // each tap's k-step summed from zero on the tensor cores and added
        // here in f32: their own accumulation truncates, which over the
        // whole K moved strips with cancellation by several bf16 steps
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const int wtap = tl.o ? dx * 3 + dy : tap;  // the transposed image's taps
          float f[64];
          wgmma_fence();
          dc_mma(f, wgmma_desc_sw128(Ws + dc_sw128_off((wtap * kpt + ch * NP) * 16, DC_CM)),
                 dc_desc(st + (dy * DC_HC + dx) * 16, PLANE), 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(f);
#pragma unroll
          for (int i = 0; i < 64; ++i) d[0][i] += f[i];
        }
        mbar_arrive(&empty[s]);
        continue;
      }
      // descriptors as offsets (16-byte units) from the stage's and the
      // chunk's weights'; the halo from pixel (r + dy) * 130 + dx: a 128-byte
      // swizzled row a pixel (DC_HEAD; any row is a legal start, the swizzle
      // being of the address) or 16-byte planes
      const uint64_t da0 = C::INT8 ? dc_desc(Ws + ch * NP * (DC_CM * 16), DC_CM * 16)
                                   : wgmma_desc_sw128(Ws);
      const uint64_t db0 = C::SW ? wgmma_desc_sw128(st) : dc_desc(st, PLANE);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int ks = 0; ks < NP / 2; ++ks) {
            const int px = (r + dy) * DC_HC + dx;
            const uint32_t boff = C::SW ? px * 128 + ks * 32 : 2 * ks * PLANE + px * 16;
            // the weights: 16-byte planes (int8) or 128-byte swizzled rows
            const uint32_t aoff =
                C::INT8 ? (tap * kpt + 2 * ks) * (DC_CM * 16)
                        : dc_sw128_off((tap * kpt + ch * NP + 2 * ks) * 16, DC_CM);
            dc_mma(d[r], da0 + (aoff >> 4), db0 + (boff >> 4), ch > 0 || tap > 0 || ks > 0);
          }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (ch > 0) mbar_arrive(&empty[(int)((it - 1) % ST)]);
    }
    if constexpr (MODE != DC_STRIP) {
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < TR; ++r) fence_acc(d[r]);
      mbar_arrive(&empty[(int)((k * nch + nch - 1) % ST)]);
    }

    // Epilogue.  This thread holds channels co = 16 w + g + 8 hh of row r at
    // pixels 8 j + 2 t + e: d[r][4 j + 2 hh + e].
    float sc[2] = {0.f, 0.f}, sh[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int co = 16 * w + g + 8 * hh;
      if (C::INT8) {
        const int kk = tl.b * a.nsi + tl.y0 / (2 * a.sh);
        const float s_a = a.sa_in ? a.sa_in[kk] : dc_q_scale(a.amax[kk]);
        sc[hh] = __fmul_rn(s_a, a.s[co]);
        sh[hh] = a.t[co];
      } else if (MODE != DC_STRIP) {
        sc[hh] = a.s[co];
        sh[hh] = a.t[co];
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int oy = tl.y0 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        dc_bar(1 + cw);  // the previous half's readers are done
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const Acc v = d[r][4 * (8 * half + jj) + 2 * hh + e];
              float f;
              if constexpr (MODE == DC_STRIP) f = (float)v;
              else if constexpr (C::INT8)
                f = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn((int)v), sc[hh]), sh[hh]), 0.f);
              else f = fmaxf((float)v * sc[hh] + sh[hh], 0.f);
              stg[(8 * jj + 2 * t + e) * DC_SP + 16 * w + g + 8 * hh] = to_bf(f);
            }
        dc_bar(1 + cw);
        const int xh = tl.x0 + DC_HALF * half;
        if (MODE == DC_UP || MODE == DC_STRIP || MODE == DC_Q8Y2) {
          bf16* dst = MODE == DC_STRIP
                          ? reinterpret_cast<bf16*>(a.out) +
                                ((long)(2 * tl.o + (tl.y0 > 0)) * a.B + tl.b) * a.W * DC_CM
                          : reinterpret_cast<bf16*>(MODE == DC_UP ? a.out : a.y2) +
                                ((long)tl.b * a.H + oy) * a.W * DC_CM;
          for (int idx = ctid; idx < DC_HALF * 8; idx += 128) {
            const int px = idx >> 3, v = idx & 7;
            if (xh + px < a.W)
              *reinterpret_cast<uint4*>(dst + (long)(xh + px) * DC_CM + 8 * v) =
                  *reinterpret_cast<const uint4*>(stg + px * DC_SP + 8 * v);
          }
        }
        if (C::HEAD && ctid < DC_HALF && xh + ctid < a.W)
          reinterpret_cast<bf16*>(a.out)[((long)tl.b * a.H + oy) * a.W + xh + ctid] =
              to_bf(dc_head(stg + ctid * DC_SP, a.hw, a.hb[0]));
      }
    }
  }
}

// Tensor map of an NHWC tensor [B, H, W, C] (elements of `esize` bytes)
// read in boxes of bc channels x bw pixels x bh rows x 1 image, written
// with `swizzle`, out-of-bound elements zero.
inline cudaError_t dc_tmap(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize,
                           int B, int H, int W, int C, int bc, int bw, int bh,
                           CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * esize, (cuuint64_t)W * C * esize,
                                 (cuuint64_t)H * W * C * esize};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches dec_conv_kernel<MODE> on `grid` blocks with its tensor map: x's
// source pixels (DC_UP) or y1's halo (DC_HEAD, DC_Q8); none for DC_STRIP.
template <int MODE>
cudaError_t dc_launch(const DcArgs& a, int grid, cudaStream_t stream) {
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  cudaError_t e = cudaSuccess;
  if (MODE == DC_UP)
    e = dc_tmap(&map, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.H / 2, a.W / 2, a.Cin, 16,
                66, 3);
  else if (MODE == DC_HEAD)
    e = dc_tmap(&map, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.H, a.W, DC_CM, DC_CM, DC_HC,
                4, CU_TENSOR_MAP_SWIZZLE_128B);
  else if (MODE != DC_STRIP)
    e = dc_tmap(&map, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.H, a.W, DC_CM, 32, DC_HC,
                4, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  constexpr int smem = DcCfg<MODE>::BYTES;
  e = cudaFuncSetAttribute(dec_conv_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  dec_conv_kernel<MODE><<<grid, DC_THREADS, smem, stream>>>(map, a);
  return cudaGetLastError();
}

}  // namespace spk
