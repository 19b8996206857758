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
// Both run on the frame of decoder_conv.cuh and its Cm 128 form below: TMA
// (conv2) or producer-built (conv1's bilinear samples) halos in a ring of
// mbarrier stages, the output channels on the M of wgmma and the pixels on
// its N.  Bound on the H100: 2 * Cm * 9 * Cin FLOPs per output pixel for
// conv1 and 2 * Cm * 9 * Cm for conv2, at the bf16 tensor-core rate; the
// bytes (x, ef, y1 written and read, pred or y2) are ~0.2 ms at 512^2
// batch 8 for block 2 and ~0.08 ms of the edge branch's ~0.55.
//
// Block 2 (Cm 64, on the main path): dec_conv_kernel<DC_UP>, <DC_HEAD>, the
// 64 x 9 Cin weights resident in shared memory.
//
// The Cm 128 forms (the edge branch; no model path): dec128_kernel.  Their
// weights (conv1 9 (Cin + Ce) x 128 bf16 = 737 KB at block 1's geometry,
// conv2 295 KB) do not fit in shared memory, so they are streamed through
// the ring beside the halo: a stage is one chunk of 16 input channels, its
// 9 taps x 128 output channels of weights (36 KB, one bulk copy of a
// block the wrapper packs as the stage holds it: [chunk][tap][2 planes of 8
// channels][128 outputs][16 B]) and the tile's halo of those channels (2
// planes of 4 x (TC + 2) pixels).  A tile is 2 rows of TC (128, or 96 where
// the width is a multiple of 96) pixels times all 128 outputs; both
// consumer warpgroups take every tile, consumer h the output channels 64 h
// .. 64 h + 63 on wgmma's M (m64nTCk16, the frame's orientation), so each
// weight staged serves the tile's 2 TC pixels once and each halo both
// halves of the outputs: 2 TC flops a weight byte from L2 (256 at TC 128),
// ~1.3 TB/s of L2 reads at half the tensor-core peak.  Splitting the
// outputs between CTAs instead would stage the halo twice and give each
// consumer its own tile, reading the weights once per consumer; a 2-CTA
// multicast of the weights measured slower for the GEMMs (PERF.md).  The
// producer, by mode:
// * E_UP   conv1: one thread loads x's 3 x (TC/2 + 2) source pixels of 16
//          channels (or, for the edge chunks, ef's 3 x (TC/4 + 2)) into a
//          landing slot by TMA; warps 1-3 build the 2x sample (source (o +
//          0.5) / 2 - 0.5) or the 4x sample (source (o + 0.5) / 4 - 0.5)
//          from it, clamped taps, rounded once to bf16 as F.interpolate
//          does, zero outside [0, 2S); builder thread 0 issues the stage's
//          weight copy once the stage is free.  ef's 9 Ce taps go into the
//          same f32 sums as x's, after them.  The build is what holds conv1
//          back on an H100 (with no sample built it ran near conv2's share
//          of its bound): the 4x build works in 2 x 2 blocks, as the 2x
//          one does; building with the fourth warp too, each stage waiting
//          on the slowest builder, measured slower.
// * E_HEAD / E_Y2  conv2: one thread issues the stage's weight copy and
//          two TMA boxes of y1's 4 x (TC + 2) halo pixels of 8 channels
//          (each box one 16-byte plane, out-of-bound pixels zero: SAME).
// The f32 sum of every output runs over (stage, tap, k-step) in that order,
// with no atomics: two calls give the same bits.  Epilogue, per consumer,
// row and chunk of 32 pixels: folded BN + ReLU rounded to bf16 into the
// consumer's staging, then 16-byte stores of its 64 channels of each pixel
// (y1, y2) or, for the head, each consumer's dot of its 64 channels (the
// frame's dc_head order), the two halves added in shared memory, + hb.
#include "decoder_conv.cuh"

namespace spk {
namespace {

enum E128Mode { E_UP = 0, E_HEAD = 1, E_Y2 = 2 };

constexpr int E_CM = 128;                          // output channels
constexpr int E_WST = 9 * 2 * E_CM * 16;           // a stage's weights (bytes)
constexpr int E_CHUNK = 32;                        // pixels a staging chunk
constexpr int E_SP = 72;                           // staging pitch (bf16)
constexpr int E_STAGING = 2 * E_CHUNK * E_SP * 2;  // both consumers

template <int MODE, int TC>
struct ECfg {
  static_assert(TC == 96 || TC == 128, "tile width");
  static constexpr int HC = TC + 2;
  static constexpr int PLANE = 4 * HC * 16;        // one plane of the halo
  static constexpr int STAGE = E_WST + 2 * PLANE;
  // landing slot: x's 3 x (TC/2 + 2) source pixels of 16 channels (ef's
  // 3 x (TC/4 + 2) fit too), padded to 128 bytes
  static constexpr int LAND = MODE == E_UP ? (3 * (TC / 2 + 2) * 32 + 127) / 128 * 128 : 0;
  static constexpr int LST = MODE == E_UP ? 2 : 0;
  static constexpr int HPART = 2 * 2 * E_CHUNK * 4;  // head partials [parity][consumer][32]
  static constexpr int FIXED = 128 + LST * LAND + E_STAGING + HPART + 128;
  static constexpr int FIT = (DC_SMEM_MAX - FIXED) / STAGE;
  static constexpr int ST = FIT > 6 ? 6 : FIT;
  static constexpr int BYTES = FIXED + ST * STAGE;
  static constexpr int PRODUCER_REGS = MODE == E_UP ? 96 : 40;
  static constexpr int CONSUMER_REGS = MODE == E_UP ? 200 : 232;
  static_assert(ST >= 2 && BYTES <= DC_SMEM_MAX, "shared memory");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= DC_THREADS * 168, "registers");
  // 128-byte aligned TMA boxes and bulk copies
  static_assert(PLANE % 128 == 0 && STAGE % 128 == 0 && E_WST % 128 == 0, "aligned planes");
};

struct EArgs {
  const void* x;    // E_UP: x [B, S, S, Cin]; conv2: y1 [B, H, W, 128]
  const void* w;    // packed weights of x's (y1's) chunks [Cin / 16][9][2][128][8]
  const void* ef;   // E_UP: edge features [B, S/2, S/2, Ce]
  const void* we;   // E_UP: packed weights of ef's chunks [Ce / 16][9][2][128][8]
  const float* s;   // folded BN scale [128]
  const float* t;   // folded BN shift [128]
  const float* hw;  // head weights [128]
  const float* hb;  // head bias [1]
  void* out;        // E_UP: y1 [B, H, W, 128]; E_HEAD: pred [B, H, W]; E_Y2: y2 [B, H, W, 128]
  int B, H, W, Cin, Ce;  // H, W: the output grid (2S for E_UP)
};

// 1-D bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing them on the barrier.
__device__ __forceinline__ void e_bulk_load(void* dst, const void* src, uint32_t bytes,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// D[64 x 96] (+)= A B: bf16 m64n96k16, f32 sums (the TC 96 tile; TC 128 is
// the frame's dc_mma).
__device__ __forceinline__ void e_mma(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The 2x bilinear sample of the chunk's 16 channels at the tile's 4 x (TC +
// 2) halo pixels (output rows y0 - 1 .., columns x0 - 1 ..), from the
// landing slot of x's 3 x (TC/2 + 2) source pixels (rows y0/2 - 1 ..,
// columns x0/2 - 1 ..), as dc_build_up builds it: a 2 x 2 block of output
// pixels reads the same four source pixels.
template <int TC>
__device__ __forceinline__ void e_build_up2(unsigned char* st, const unsigned char* land,
                                            const EArgs& a, int b_y0, int b_x0, int ptid) {
  constexpr int HC = TC + 2, LW = TC / 2 + 2, PLANE = 4 * HC * 16;
  const int S = a.H / 2, rbase = b_y0 / 2 - 1, cbase = b_x0 / 2 - 1;
  const uint4* L = reinterpret_cast<const uint4*>(land);
  for (int u = ptid; u < 2 * (TC / 2 + 1) * 2; u += 96) {
    const int p = u & 1, m = (u >> 1) % (TC / 2 + 1), hp = (u >> 1) / (TC / 2 + 1);
    const int Y0 = b_y0 - 1 + 2 * hp, X0 = b_x0 - 1 + 2 * m;  // = 2 mr + 1, 2 mc + 1
    const int mr = (Y0 - 1) / 2, mc = (X0 - 1) / 2;
    const int rA = max(mr, 0) - rbase, rB = min(mr + 1, S - 1) - rbase;
    const int cA = max(mc, 0) - cbase, cB = min(mc + 1, S - 1) - cbase;
    uint4 v[2][2] = {{L[(rA * LW + cA) * 2 + p], L[(rA * LW + cB) * 2 + p]},
                     {L[(rB * LW + cA) * 2 + p], L[(rB * LW + cB) * 2 + p]}};
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
      for (int jx = 0; jx < 2; ++jx) {
        const float h0x = lx[jx][0] * f[0][0].x + lx[jx][1] * f[0][1].x;
        const float h0y = lx[jx][0] * f[0][0].y + lx[jx][1] * f[0][1].y;
        const float h1x = lx[jx][0] * f[1][0].x + lx[jx][1] * f[1][1].x;
        const float h1y = lx[jx][0] * f[1][0].y + lx[jx][1] * f[1][1].y;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          pairs(o[i][jx])[e / 2] = rin[i] && cin[jx]
                                       ? __floats2bfloat162_rn(ly[i][0] * h0x + ly[i][1] * h1x,
                                                               ly[i][0] * h0y + ly[i][1] * h1y)
                                       : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4* dst = reinterpret_cast<uint4*>(st + p * PLANE + ((2 * hp + i) * HC + 2 * m) * 16);
      dst[0] = o[i][0];
      dst[1] = o[i][1];
    }
  }
}

// The 4x bilinear sample of ef's chunk of 16 channels at the tile's halo
// pixels, from the landing slot of ef's 3 x (TC/4 + 2) source pixels (rows
// y0/4 - 1 .., columns x0/4 - 1 ..): source (o + 0.5) / 4 - 0.5 clamped at
// 0, the neighbour clamped at S/2 - 1, each output ly0 (lx0 f00 + lx1 f01)
// + ly1 (lx0 f10 + lx1 f11) rounded once.  At 4x an even-aligned pair of
// outputs (2k, 2k + 1) reads the same two source pixels, so a unit is the
// 2 x 2 block of pixels (Y0, Y0 + 1) x (X0, X0 + 1), Y0 and X0 even, from
// one set of four source pixels; the halo's rows y0 - 1 .. y0 + 2 and
// columns x0 - 1 .. x0 + TC lie in 3 row pairs and TC/2 + 2 column pairs,
// and each unit writes those of its pixels that are in the halo.
template <int TC>
__device__ __forceinline__ void e_build_up4(unsigned char* st, const unsigned char* land,
                                            const EArgs& a, int b_y0, int b_x0, int ptid) {
  constexpr int HC = TC + 2, LW = TC / 4 + 2, PLANE = 4 * HC * 16, NCP = TC / 2 + 2;
  const int Se = a.H / 4, rbase = b_y0 / 4 - 1, cbase = b_x0 / 4 - 1;
  const uint4* L = reinterpret_cast<const uint4*>(land);
  for (int u = ptid; u < 2 * 3 * NCP; u += 96) {
    const int p = u & 1, m = (u >> 1) % NCP, hp = (u >> 1) / NCP;
    const int Y0 = b_y0 - 2 + 2 * hp, X0 = b_x0 - 2 + 2 * m;
    // the pair's shared source pixels (Y0 + 1 and X0 + 1 give the same)
    const int ys = (int)fmaxf((Y0 + 0.5f) * 0.25f - 0.5f, 0.f);
    const int xs = (int)fmaxf((X0 + 0.5f) * 0.25f - 0.5f, 0.f);
    const int rA = ys - rbase, rB = min(ys + 1, Se - 1) - rbase;
    const int cA = xs - cbase, cB = min(xs + 1, Se - 1) - cbase;
    uint4 v[2][2] = {{L[(rA * LW + cA) * 2 + p], L[(rA * LW + cB) * 2 + p]},
                     {L[(rB * LW + cA) * 2 + p], L[(rB * LW + cB) * 2 + p]}};
    float ly[2][2], lx[2][2];
    bool rin[2], cin[2], rh[2], ch[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sy = fmaxf((Y0 + i + 0.5f) * 0.25f - 0.5f, 0.f);
      const float sx = fmaxf((X0 + i + 0.5f) * 0.25f - 0.5f, 0.f);
      ly[i][1] = sy - ys;
      ly[i][0] = 1.f - ly[i][1];
      lx[i][1] = sx - xs;
      lx[i][0] = 1.f - lx[i][1];
      rin[i] = Y0 + i >= 0 && Y0 + i < a.H;
      cin[i] = X0 + i >= 0 && X0 + i < a.W;
      rh[i] = Y0 + i >= b_y0 - 1 && Y0 + i <= b_y0 + 2;   // a halo row
      ch[i] = X0 + i >= b_x0 - 1 && X0 + i <= b_x0 + TC;  // a halo column
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
      for (int jx = 0; jx < 2; ++jx) {
        const float h0x = lx[jx][0] * f[0][0].x + lx[jx][1] * f[0][1].x;
        const float h0y = lx[jx][0] * f[0][0].y + lx[jx][1] * f[0][1].y;
        const float h1x = lx[jx][0] * f[1][0].x + lx[jx][1] * f[1][1].x;
        const float h1y = lx[jx][0] * f[1][0].y + lx[jx][1] * f[1][1].y;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          pairs(o[i][jx])[e / 2] = rin[i] && cin[jx]
                                       ? __floats2bfloat162_rn(ly[i][0] * h0x + ly[i][1] * h1x,
                                                               ly[i][0] * h0y + ly[i][1] * h1y)
                                       : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jx = 0; jx < 2; ++jx)
        if (rh[i] && ch[jx])
          *reinterpret_cast<uint4*>(
              st + p * PLANE + ((Y0 + i - (b_y0 - 1)) * HC + X0 + jx - (b_x0 - 1)) * 16) = o[i][jx];
  }
}

template <int MODE, int TC>
__global__ void __launch_bounds__(DC_THREADS, 1)
dec128_kernel(const __grid_constant__ CUtensorMap tm0, const __grid_constant__ CUtensorMap tm1,
              const EArgs a) {
  using C = ECfg<MODE, TC>;
  constexpr int ST = C::ST, PLANE = C::PLANE, STAGE = C::STAGE, HC = C::HC;
  constexpr int LST = C::LST, LAND = C::LAND, NA = TC / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  unsigned char* ring = base;
  unsigned char* landing = ring + ST * STAGE;
  bf16* staging = reinterpret_cast<bf16*>(landing + LST * LAND);
  float* hpart = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(staging) + E_STAGING);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(hpart) +
                                               C::HPART);
  uint64_t* empty = full + ST;
  uint64_t* lfull = empty + ST;
  uint64_t* lempty = lfull + LST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int nx = a.Cin / 16, nch = nx + (MODE == E_UP ? a.Ce / 16 : 0);  // stages a tile
  const int ct = (a.W + TC - 1) / TC;
  const long tiles = (long)a.B * (a.H / 2) * ct;
  auto tile_of = [&](long tile, int& b, int& y0, int& x0) {
    x0 = (int)(tile % ct) * TC;
    const long rest = tile / ct;
    y0 = 2 * (int)(rest % (a.H / 2));
    b = (int)(rest / (a.H / 2));
  };
  auto weights = [&](int ch) -> const unsigned char* {
    return ch < nx ? reinterpret_cast<const unsigned char*>(a.w) + (long)ch * E_WST
                   : reinterpret_cast<const unsigned char*>(a.we) + (long)(ch - nx) * E_WST;
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], MODE == E_UP ? 97 : 1);
      mbar_init(&empty[s], 256);
    }
    for (int l = 0; l < LST; ++l) {
      mbar_init(&lfull[l], 1);
      mbar_init(&lempty[l], 96);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if constexpr (MODE != E_UP) {
      // one thread: each stage's weights and y1's two planes of halo
      if (tid != 0) return;
      long it = 0;
      for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, y0, x0;
        tile_of(tile, b, y0, x0);
        for (int ch = 0; ch < nch; ++ch, ++it) {
          const int s = (int)(it % ST);
          if (it >= ST) dc_wait(&empty[s], (int)((it / ST - 1) & 1));
          unsigned char* st = ring + s * STAGE;
          mbar_arrive_expect_tx(&full[s], STAGE);
          e_bulk_load(st, weights(ch), E_WST, &full[s]);
          tma_load_4d(st + E_WST, &tm0, &full[s], 16 * ch, x0 - 1, y0 - 1, b);
          tma_load_4d(st + E_WST + PLANE, &tm0, &full[s], 16 * ch + 8, x0 - 1, y0 - 1, b);
        }
      }
      return;
    } else {
      if (tid < 32) {
        // warp 0, one thread: the landing slots, up to LST ahead of the build
        if (tid != 0) return;
        long it = 0;
        for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          int b, y0, x0;
          tile_of(tile, b, y0, x0);
          for (int ch = 0; ch < nch; ++ch, ++it) {
            const int l = (int)(it % LST);
            if (it >= LST) dc_wait(&lempty[l], (int)((it / LST - 1) & 1));
            unsigned char* ld = landing + l * LAND;
            if (ch < nx) {
              mbar_arrive_expect_tx(&lfull[l], 3 * (TC / 2 + 2) * 32);
              tma_load_4d(ld, &tm0, &lfull[l], 16 * ch, x0 / 2 - 1, y0 / 2 - 1, b);
            } else {
              mbar_arrive_expect_tx(&lfull[l], 3 * (TC / 4 + 2) * 32);
              tma_load_4d(ld, &tm1, &lfull[l], 16 * (ch - nx), x0 / 4 - 1, y0 / 4 - 1, b);
            }
          }
        }
        return;
      }
      // warps 1-3: each landing slot into its stage; builder thread 0 also
      // issues the stage's weight copy once the stage is free
      const int ptid = tid - 32;
      long it = 0;
      for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, y0, x0;
        tile_of(tile, b, y0, x0);
        for (int ch = 0; ch < nch; ++ch, ++it) {
          const int l = (int)(it % LST), s = (int)(it % ST);
          unsigned char* st = ring + s * STAGE;
          if (it >= ST) dc_wait(&empty[s], (int)((it / ST - 1) & 1));
          if (ptid == 0) {
            mbar_arrive_expect_tx(&full[s], E_WST);
            e_bulk_load(st, weights(ch), E_WST, &full[s]);
          }
          dc_wait(&lfull[l], (int)((it / LST) & 1));
          if (ch < nx) e_build_up2<TC>(st + E_WST, landing + l * LAND, a, y0, x0, ptid);
          else e_build_up4<TC>(st + E_WST, landing + l * LAND, a, y0, x0, ptid);
          fence_proxy_async();
          mbar_arrive(&full[s]);
          mbar_arrive(&lempty[l]);
        }
      }
      return;
    }
  }

  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int h = wg - 1, ctid = tid - 128 * wg, w = ctid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* stg = staging + h * E_CHUNK * E_SP;
  float sc[2], sh[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int co = 64 * h + 16 * w + g + 8 * hh;
    sc[hh] = a.s[co];
    sh[hh] = a.t[co];
  }
  long it = 0, hq = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, y0, x0;
    tile_of(tile, b, y0, x0);
    float d[2][NA];
    for (int ch = 0; ch < nch; ++ch, ++it) {
      const int s = (int)(it % ST);
      dc_wait(&full[s], (int)((it / ST) & 1));
      const unsigned char* st = ring + s * STAGE;
      // the consumer's 64 rows of each tap's weights (LBO: the chunk's
      // second plane), the halo from pixel (r + dy) * HC + dx
      const uint64_t da0 = dc_desc(st + h * 1024, 2048);
      const uint64_t db0 = dc_desc(st + E_WST, PLANE);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t boff = ((r + dy) * HC + dx) * 16;
          if constexpr (TC == 128)
            dc_mma(d[r], da0 + ((tap * 4096) >> 4), db0 + (boff >> 4), ch > 0 || tap > 0);
          else
            e_mma(d[r], da0 + ((tap * 4096) >> 4), db0 + (boff >> 4), ch > 0 || tap > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (ch > 0) mbar_arrive(&empty[(int)((it - 1) % ST)]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r) fence_acc(d[r]);
    mbar_arrive(&empty[(int)((it - 1) % ST)]);

    // Epilogue.  This thread holds channels co = 64 h + 16 w + g + 8 hh of
    // row r at pixels 8 j + 2 t + e: d[r][4 j + 2 hh + e].
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long prow = ((long)b * a.H + y0 + r) * a.W;
#pragma unroll
      for (int q = 0; q < TC / E_CHUNK; ++q, ++hq) {
        dc_bar(1 + h);  // the previous chunk's readers are done
#pragma unroll
        for (int jj = 0; jj < E_CHUNK / 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = d[r][4 * (E_CHUNK / 8 * q + jj) + 2 * hh + e];
              stg[(8 * jj + 2 * t + e) * E_SP + 16 * w + g + 8 * hh] =
                  to_bf(fmaxf(v * sc[hh] + sh[hh], 0.f));
            }
        dc_bar(1 + h);
        const int xq = x0 + E_CHUNK * q;
        if constexpr (MODE == E_HEAD) {
          float* hp = hpart + (hq & 1) * 2 * E_CHUNK;
          if (ctid < E_CHUNK) hp[h * E_CHUNK + ctid] = dc_head(stg + ctid * E_SP, a.hw + 64 * h, 0.f);
          asm volatile("bar.sync 3, 256;\n" ::: "memory");
          if (h == 0 && ctid < E_CHUNK && xq + ctid < a.W)
            reinterpret_cast<bf16*>(a.out)[prow + xq + ctid] =
                to_bf(__fadd_rn(__fadd_rn(hp[ctid], hp[E_CHUNK + ctid]), a.hb[0]));
        } else {
          bf16* dst = reinterpret_cast<bf16*>(a.out) + prow * E_CM + 64 * h;
          for (int idx = ctid; idx < E_CHUNK * 8; idx += 128) {
            const int px = idx >> 3, v = idx & 7;
            if (xq + px < a.W)
              *reinterpret_cast<uint4*>(dst + (long)(xq + px) * E_CM + 8 * v) =
                  *reinterpret_cast<const uint4*>(stg + px * E_SP + 8 * v);
          }
        }
      }
    }
  }
}

// Launches dec128_kernel<MODE, tc> on `grid` blocks with its tensor maps:
// x's and ef's source pixels (E_UP) or y1's halo planes.
template <int MODE, int TC>
cudaError_t e_launch_tc(const EArgs& a, int grid, cudaStream_t stream) {
  CUtensorMap m0, m1;
  memset(&m0, 0, sizeof(m0));
  memset(&m1, 0, sizeof(m1));
  cudaError_t e;
  if (MODE == E_UP) {
    const int S = a.H / 2;
    e = dc_tmap(&m0, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, S, S, a.Cin, 16, TC / 2 + 2, 3);
    if (e == cudaSuccess)
      e = dc_tmap(&m1, a.ef, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, S / 2, S / 2, a.Ce, 16,
                  TC / 4 + 2, 3);
  } else {
    e = dc_tmap(&m0, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.B, a.H, a.W, E_CM, 8, TC + 2, 4);
  }
  if (e != cudaSuccess) return e;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  constexpr int smem = ECfg<MODE, TC>::BYTES;
  e = cudaFuncSetAttribute(dec128_kernel<MODE, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  dec128_kernel<MODE, TC><<<grid, DC_THREADS, smem, stream>>>(m0, m1, a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t e_launch(const EArgs& a, int tc, int grid, cudaStream_t stream) {
  if (a.H % 2 || a.Cin % 16 || a.Ce % 16 || (MODE == E_UP && (a.H % 4 || a.Ce < 16)))
    return cudaErrorInvalidValue;
  if (tc == 128) return e_launch_tc<MODE, 128>(a, grid, stream);
  if (tc == 96) return e_launch_tc<MODE, 96>(a, grid, stream);
  return cudaErrorInvalidValue;
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

// x [B, S, S, Cin], ef [B, S/2, S/2, Ce] -> y [B, 2S, 2S, 128]; w, we:
// the packed weights of x's and ef's chunks ([C / 16][9][2][128][8]); tiles
// of 2 rows x tc (128 or 96) pixels on `grid` blocks (kernels.dec128_plan).
int sp_upconv3x3_edge_bn_relu(const void* x, const void* w, const void* ef, const void* we,
                              const void* s, const void* t, void* y, int B, int S, int Cin,
                              int Ce, int tc, int grid, void* stream) {
  spk::EArgs a{};
  a.x = x;
  a.w = w;
  a.ef = ef;
  a.we = we;
  a.s = (const float*)s;
  a.t = (const float*)t;
  a.out = y;
  a.B = B;
  a.H = a.W = 2 * S;
  a.Cin = Cin;
  a.Ce = Ce;
  return (int)spk::e_launch<spk::E_UP>(a, tc, grid, (cudaStream_t)stream);
}

// y [B, H, W, 128] -> y2 (E_Y2: [B, H, W, 128]) or pred (E_HEAD: [B, H,
// W], with head weights hw [128] and bias hb [1], f32); w: the packed
// weights [8][9][2][128][8].
static int dec128_conv2(int mode, const void* y, const void* w, const void* s, const void* t,
                        const void* hw, const void* hb, void* out, int B, int H, int W, int tc,
                        int grid, void* stream) {
  spk::EArgs a{};
  a.x = y;
  a.w = w;
  a.s = (const float*)s;
  a.t = (const float*)t;
  a.hw = (const float*)hw;
  a.hb = (const float*)hb;
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = 128;
  return (int)(mode == spk::E_HEAD ? spk::e_launch<spk::E_HEAD>(a, tc, grid, (cudaStream_t)stream)
                                   : spk::e_launch<spk::E_Y2>(a, tc, grid, (cudaStream_t)stream));
}

// y [B, H, W, 128] -> pred [B, H, W].
int sp_conv3x3_bn_relu_head(const void* y, const void* w, const void* s, const void* t,
                            const void* hw, const void* hb, void* pred, int B, int H, int W,
                            int tc, int grid, void* stream) {
  return dec128_conv2(spk::E_HEAD, y, w, s, t, hw, hb, pred, B, H, W, tc, grid, stream);
}

// y [B, H, W, 128] -> y2 [B, H, W, 128].
int sp_conv3x3_bn_relu(const void* y, const void* w, const void* s, const void* t, void* out,
                       int B, int H, int W, int tc, int grid, void* stream) {
  return dec128_conv2(spk::E_Y2, y, w, s, t, nullptr, nullptr, out, B, H, W, tc, grid, stream);
}

}  // extern "C"
