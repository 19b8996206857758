// bf16 self-attention over independent problems of L tokens, any L, on Hopper:
// TMA, wgmma for both products, warp specialisation and a persistent grid.
//
// Replaces spegnet_tpu/ops/pallas_attention.py `_lanes_kernel` (:199) and
// `_lanes_qblock_kernel` (:220) of `fused_attention_lanes` (#9), and
// `_attn_kernel` (:43) and `_qblock_kernel` (:68) of `fused_attention` (#8):
// per (problem, head), softmax(q k^T * scale) v with the scores and the
// softmax in f32, the row sums taken from the unrounded f32 probabilities,
// the probabilities rounded to bf16 for the product with v, and the [rows, D]
// output normalised after that product, as `_lanes_kernel` computes.
// Problems are the windows of Hiera's decomposed blocks (L = window^2, the
// zero-padded windows of a grid the window does not divide included, whose
// padded tokens are real keys) or a whole stage grid (the global blocks; L
// 484, 576, 1600, 2304 at 352^2, 384^2, 640^2, 768^2).
//
// What bounds it on the H100: 4 L^2 D FLOPs per (problem, head) against 8 L D
// bytes (q, k, v read once, o written once): bytes below L ~ 300 at the bf16
// tensor-core peak (989 TFLOP/s against 3.35 TB/s), operations above.  At
// D 72 the softmax's exp2 (one per score, on the SFU's 16 a clock per SM)
// costs nearly as much as the two products, and every K/V tile is re-read
// from L2 once per item.  The design:
//
// * Both products run on wgmma: S = Q K^T as m64n64k16 with Q and K K-major
//   in shared memory, O += P V as m64nDVk16 with P from registers and V
//   MN-major ("transposed") in shared memory.  The scores, the online
//   softmax (exp2 of one FFMA with the scaled running max) and the output
//   accumulator stay in registers: P's bf16 pairs are the wgmma A
//   fragments, so no [L, L] tensor and no shuffle of P exist.
// * Warp specialisation: one producer warpgroup (one thread issues every
//   load) fills a ring of K/V stages and the Q buffers through TMA, with one
//   full and one empty mbarrier per buffer; the consumers never load, and
//   `setmaxnreg` moves registers from the producer to them.  Two consumer
//   warpgroups each own one or two 64-row m-tiles of an item, so every
//   64-key K/V tile feeds 128 or 256 query rows (with two, half the L2
//   reads and TMA work per FLOP; 64 keys a tile keep two m-tiles' scores
//   and accumulators in 232 registers).
// * Per tile, a consumer issues S_j, then P_{j-1} V_{j-1}, and runs the
//   softmax of S_j while P.V is on the tensor cores.  The key tiles run
//   last (partial) tile first, so the mask of keys past L is applied to the
//   first tile of an item and no other.
// * A persistent grid of about one block per SM walks a list of items: the
//   producer loads the next item's Q and first K/V tiles while the
//   consumers finish the current one.  An item is 128 or 256 query rows
//   of one (problem, head); at L <= 64 each consumer takes a (problem, head)
//   of its own over its own half of the stage, so no warpgroup computes
//   rows past L (Hiera's stage-4 windows).
//
// TMA geometry: each operand is a 4-D tensor map over its strided view, D
// innermost with extent D (the head dim, a multiple of 8), then heads, L and
// problems, in boxes of 64 columns x 1 head x 64 rows x 1 problem with the
// 128-byte swizzle.  Global strides are multiples of 16 bytes because D and
// every stride are multiples of 8 elements.  A box that runs past column D,
// row L or the last problem is zero-filled, which pads the head dim to the
// wgmma width, fills the query and key tails, and never reads a neighbouring
// head's or problem's rows.  D 72 spans two 64-column atoms: k-steps 0-3 of
// Q K^T read the first, k-step 4 the second; V's MN-major descriptor steps
// from one atom to the next by its leading byte offset.
//
// Operands: q / k / v strided [problems, L, heads, D] views with D
// contiguous (the packed token-major qkv of an nn.Linear, or separate
// tensors); the output a contiguous [problems, L, heads, D].  The launcher
// (kernels.attention) zero-pads D to a multiple of 8 and computes the item
// list (kernels.attention_plan).
#include "wgmma_attn.cuh"

namespace spk {
namespace {

constexpr int AW_ROWS = 64;                    // rows of a box, an m-tile, a key tile
constexpr int AW_THREADS = 384;                // producer + two consumer warpgroups
constexpr uint32_t AW_BOX = AW_ROWS * 64 * 2;  // bytes of one 64 x 64 bf16 box
constexpr int AW_PRODUCER_REGS = 40, AW_CONSUMER_REGS = 232;
constexpr uint32_t AW_SMEM = 225 * 1024;       // of the 227 KB a block may take

// DV: the head width of the P.V product (D rounded up to an instantiated
// wgmma N).  MT: 64-row m-tiles a consumer computes per item (2: each K/V
// tile feeds 256 query rows; 1 where the accumulators of two would spill,
// head dims above 80, or where the launcher's plan finds that 128-row items
// fill the grid's rounds better).  SLOTS: 64-key slots of a stage
// (SOLO: one per consumer, each its own problem).  Shared memory: Q
// [QB][consumer][m-tile][atom] boxes, then K/V stages [ST][K | V][atom]
// [slot] boxes, each 1024-byte aligned; as many stages as fit beside the Q
// buffers (a consumer holds two at once, P.V of tile j-1 and S of tile j,
// so three let the load of tile j+1 run a whole tile ahead), two Q buffers
// where that still leaves three stages.
template <int DV, bool SOLO, int MT>
struct AwCfg {
  static_assert(MT == 1 || (MT == 2 && !SOLO && DV <= 80), "m-tiles");
  static constexpr int NA = (DV + 63) / 64;  // 64-column atoms
  static constexpr int KS = (DV + 15) / 16;  // k16 steps of Q K^T
  static constexpr int SLOTS = SOLO ? 2 : 1;
  static constexpr uint32_t kQ = 2 * MT * NA * AW_BOX;  // one Q buffer
  static constexpr uint32_t kKV = NA * SLOTS * AW_BOX;  // K or V of a stage
  static constexpr int QB = AW_SMEM >= 2 * kQ + 3 * 2 * kKV ? 2 : 1;
  static constexpr int ST_FIT = (AW_SMEM - QB * kQ) / (2 * kKV);
  static constexpr int ST = ST_FIT > 8 ? 8 : ST_FIT;
  static constexpr uint32_t kBars = 2 * (ST + QB) * 8;
  static constexpr int kBytes = QB * kQ + ST * 2 * kKV + kBars + 1024;
  // Two stages at least where an item has several key tiles (the loop below
  // holds two at once); SOLO items have one.
  static_assert((SOLO ? ST >= 1 : ST >= 2) && kBytes <= 232448, "shared memory");
};

// The (problem, head, first row) a consumer computes for one item, its rows
// [row0, row0 + 64 * MT); tests/test_torch_attention_tiles.py mirrors it.  An
// item is 2 * MT * 64 query rows of one (problem, head), or with SOLO one
// (problem, head) per consumer.  `active`: the consumer has rows to store.
struct Work {
  int prob, head, row0;
  bool active;
};

__device__ __forceinline__ Work decode(int item, int c, int problems, int heads, int L,
                                       bool solo, int mt) {
  Work w;
  if (solo) {
    const int i = 2 * item + c;
    w.active = i < problems * heads;
    w.prob = i / heads;
    w.head = i % heads;
    w.row0 = 0;
  } else {
    const int rows = 2 * mt * AW_ROWS, nqt = (L + rows - 1) / rows;
    const int ph = item / nqt;
    w.prob = ph / heads;
    w.head = ph % heads;
    w.row0 = (item % nqt) * rows + c * mt * AW_ROWS;
    w.active = w.row0 < L;
  }
  return w;
}

// No wgmma sits under a data-dependent branch (ptxas would serialise them
// all): an idle consumer computes on the zeros of its out-of-bound boxes
// and stores nothing, every box of a stage is loaded (zero-filled past L),
// and only the softmax of an item's first tile (its last, partial one)
// applies the mask, outside the loop over the other tiles.
template <int DV, bool SOLO, int MT>
__global__ void __launch_bounds__(AW_THREADS, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, long ob,
                       long ol, long oh, int problems, int heads, int L, int D, int items,
                       float scale) {
  using C = AwCfg<DV, SOLO, MT>;
  constexpr int NA = C::NA, ST = C::ST, QB = C::QB, SLOTS = C::SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;
  unsigned char* kvs = base + QB * C::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + ST * 2 * C::kKV);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + QB;
  const int tid = threadIdx.x, wg = tid / 128;
  const int ntiles = SOLO ? 1 : (L + AW_ROWS - 1) / AW_ROWS;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int b = 0; b < QB; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load, in the consumers' order.  An
    // idle consumer's boxes lie past row L or past the last problem: TMA
    // fills them with zeros.
    setmaxnreg_dec<AW_PRODUCER_REGS>();
    if (tid != 0) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const Work w0 = decode(item, 0, problems, heads, L, SOLO, MT);
      const Work w1 = decode(item, 1, problems, heads, L, SOLO, MT);
      const int b = n % QB;
      if (n >= QB) mbar_wait(&qempty[b], ((n / QB) - 1) & 1);
      mbar_arrive_expect_tx(&qfull[b], 2 * MT * NA * AW_BOX);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const Work& w = c ? w1 : w0;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int a = 0; a < NA; ++a)
            tma_load_4d(qs + b * C::kQ + ((c * MT + i) * NA + a) * AW_BOX, &tq, &qfull[b],
                        64 * a, w.head, w.row0 + i * AW_ROWS, w.prob);
      }
      for (int j = 0; j < ntiles; ++j, ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        unsigned char* ks = kvs + s * 2 * C::kKV;
        unsigned char* vs = ks + C::kKV;
        mbar_arrive_expect_tx(&full[s], 2 * NA * SLOTS * AW_BOX);
        // SOLO: slot c holds consumer c's problem; else one slot, 64 keys
        // of the item's problem, the last (partial) tile first.
        const int row = (ntiles - 1 - j) * AW_ROWS;
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          const Work& w = sl ? w1 : w0;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const uint32_t off = (a * SLOTS + sl) * AW_BOX;
            tma_load_4d(ks + off, &tk, &full[s], 64 * a, w.head, row, w.prob);
            tma_load_4d(vs + off, &tv, &full[s], 64 * a, w.head, row, w.prob);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns MT 64-row m-tiles of each item.  Per key
  // tile j: issue S_j = Q K_j^T, then O += P_{j-1} V_{j-1}; wait for S_j
  // only and run its softmax while P.V is still on the tensor cores; then
  // wait for P.V, release tile j-1's stage and round P_j.
  setmaxnreg_inc<AW_CONSUMER_REGS>();
  const int c = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  const uint32_t slot = SOLO ? c * AW_BOX : 0;     // this consumer's keys in a stage
  constexpr uint32_t kAtomKV = SLOTS * AW_BOX;      // atom stride in a K or V stage
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Work wk = decode(item, c, problems, heads, L, SOLO, MT);
    const int b = n % QB;
    mbar_wait(&qfull[b], (n / QB) & 1);
    const unsigned char* qa = qs + b * C::kQ + c * MT * NA * AW_BOX;
    float acc[MT][DV / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < DV / 2; ++e) acc[i][e] = 0.f;
    float m[MT][2], l[MT][2], al[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[i][r] = -INFINITY;
        l[i][r] = al[i][r] = 0.f;
      }
    float sc[MT][32];
    uint32_t pf[MT][4][4];

    auto issue_s = [&](int s) {
      const unsigned char* ks = kvs + s * 2 * C::kKV + slot;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          WgmmaSS<64>::run(sc[i],
                           wgmma_desc_sw128(qa + (i * NA + kk / 4) * AW_BOX + (kk % 4) * 32),
                           wgmma_desc_sw128(ks + (kk / 4) * kAtomKV + (kk % 4) * 32), kk > 0);
      wgmma_commit();
    };
    // O = a O + P V over stage s's tile (keys past L: P 0, V rows 0).
    auto issue_pv = [&](int s) {
      const unsigned char* vs = kvs + s * 2 * C::kKV + C::kKV + slot;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj) {
          acc[i][4 * jj] *= al[i][0];
          acc[i][4 * jj + 1] *= al[i][0];
          acc[i][4 * jj + 2] *= al[i][1];
          acc[i][4 * jj + 3] *= al[i][1];
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          WgmmaRS<DV>::run(acc[i], pf[i][kk], wgmma_desc_sw128_mn(vs + kk * 2048, kAtomKV));
      wgmma_commit();
    };
    // Online softmax of the scores in sc, in place: p = exp2(s * scale *
    // log2e - max * scale * log2e), one FFMA and one exp2; the row sums add
    // the f32 p; al rescales the rows' earlier sums and output.  `masked`
    // (the first tile an item processes, its last and only partial one):
    // keys from `nk` on are not the problem's.  Maxima and sums as trees.
    auto softmax = [&](bool masked, int nk) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (masked) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool in = jj * 8 + 2 * t + e < nk;
              sc[i][4 * jj + e] = in ? sc[i][4 * jj + e] : -INFINITY;
              sc[i][4 * jj + 2 + e] = in ? sc[i][4 * jj + 2 + e] : -INFINITY;
            }
          }
        }
        float x0[8], x1[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          x0[jj] = fmaxf(sc[i][4 * jj], sc[i][4 * jj + 1]);
          x1[jj] = fmaxf(sc[i][4 * jj + 2], sc[i][4 * jj + 3]);
        }
#pragma unroll
        for (int w_ = 4; w_ > 0; w_ >>= 1)
#pragma unroll
          for (int jj = 0; jj < w_; ++jj) {
            x0[jj] = fmaxf(x0[jj], x0[jj + w_]);
            x1[jj] = fmaxf(x1[jj], x1[jj + w_]);
          }
        float mx0 = x0[0], mx1 = x1[0];
#pragma unroll
        for (int o_ = 1; o_ < 4; o_ <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
        }
        // Every tile holds at least one key of the problem: the maxima are
        // finite.
        const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
        al[i][0] = fast_exp2((m[i][0] - mn0) * sl2);
        al[i][1] = fast_exp2((m[i][1] - mn1) * sl2);
        m[i][0] = mn0;
        m[i][1] = mn1;
        const float b0 = mn0 * sl2, b1 = mn1 * sl2;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          sc[i][4 * jj] = fast_exp2(fmaf(sc[i][4 * jj], sl2, -b0));
          sc[i][4 * jj + 1] = fast_exp2(fmaf(sc[i][4 * jj + 1], sl2, -b0));
          sc[i][4 * jj + 2] = fast_exp2(fmaf(sc[i][4 * jj + 2], sl2, -b1));
          sc[i][4 * jj + 3] = fast_exp2(fmaf(sc[i][4 * jj + 3], sl2, -b1));
          x0[jj] = sc[i][4 * jj] + sc[i][4 * jj + 1];
          x1[jj] = sc[i][4 * jj + 2] + sc[i][4 * jj + 3];
        }
#pragma unroll
        for (int w_ = 4; w_ > 0; w_ >>= 1)
#pragma unroll
          for (int jj = 0; jj < w_; ++jj) {
            x0[jj] += x0[jj + w_];
            x1[jj] += x1[jj + w_];
          }
        l[i][0] = l[i][0] * al[i][0] + x0[0];
        l[i][1] = l[i][1] * al[i][1] + x1[0];
      }
    };
    // P in bf16, in the wgmma A layout: k-step kk covers n8 blocks 2kk, 2kk+1.
    auto round_p = [&]() {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pf[i][kk][0] = pack_bf16(sc[i][8 * kk], sc[i][8 * kk + 1]);
          pf[i][kk][1] = pack_bf16(sc[i][8 * kk + 2], sc[i][8 * kk + 3]);
          pf[i][kk][2] = pack_bf16(sc[i][8 * kk + 4], sc[i][8 * kk + 5]);
          pf[i][kk][3] = pack_bf16(sc[i][8 * kk + 6], sc[i][8 * kk + 7]);
        }
    };

    int sp = it % ST;  // stage of the previous tile
    mbar_wait(&full[sp], (it / ST) & 1);
    issue_s(sp);
    wgmma_wait<0>();
    fence_acc(sc);
    if (ntiles == 1) mbar_arrive(&qempty[b]);  // Q read for the last time
    softmax(true, L - (ntiles - 1) * AW_ROWS);
    round_p();
    for (int j = 1; j < ntiles; ++j) {
      ++it;
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      issue_s(s);
      issue_pv(sp);
      wgmma_wait<1>();
      fence_acc(sc);
      if (j == ntiles - 1) mbar_arrive(&qempty[b]);
      softmax(false, AW_ROWS);
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(pf);
      mbar_arrive(&empty[sp]);
      round_p();
      sp = s;
    }
    issue_pv(sp);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pf);
    mbar_arrive(&empty[sp]);
    ++it;

#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float l0 = l[i][0], l1 = l[i][1];
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
      }
      if (!wk.active) continue;
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int q0 = wk.row0 + i * AW_ROWS + w * 16 + g, q1 = q0 + 8;
      bf16* d0 = o + wk.prob * ob + wk.head * oh + (long)q0 * ol;
      bf16* d1 = d0 + 8 * ol;
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj) {
        const int col = jj * 8 + 2 * t;
        if (col >= D) continue;
        if (q0 < L)
          *reinterpret_cast<uint32_t*>(d0 + col) = pack_bf16(acc[i][4 * jj] * inv0,
                                                              acc[i][4 * jj + 1] * inv0);
        if (q1 < L)
          *reinterpret_cast<uint32_t*>(d1 + col) = pack_bf16(acc[i][4 * jj + 2] * inv1,
                                                              acc[i][4 * jj + 3] * inv1);
      }
    }
  }
}

// Tensor map of a strided [problems, L, heads, D] bf16 view: dims (D, heads,
// L, problems), byte strides of a head, a token and a problem (multiples of
// 16), boxes of 64 x 1 x 64 x 1 with the 128-byte swizzle, out-of-bound
// elements read as zeros.
cudaError_t make_view_tmap(CUtensorMap* map, const void* ptr, int D, int heads, int L,
                           int problems, long sh, long sl, long sb) {
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)problems};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)AW_ROWS, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DV, bool SOLO, int MT>
cudaError_t launch_wgmma_attention(const CUtensorMap& tq, const CUtensorMap& tk,
                                   const CUtensorMap& tv, void* o, long ob, long ol, long oh,
                                   int problems, int heads, int L, int D, int items, int grid,
                                   float scale, cudaStream_t st) {
  constexpr int smem = AwCfg<DV, SOLO, MT>::kBytes;
  static bool attr = false;  // the shared-memory attribute, set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_wgmma_kernel<DV, SOLO, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  attention_wgmma_kernel<DV, SOLO, MT><<<grid, AW_THREADS, smem, st>>>(
      tq, tk, tv, (bf16*)o, ob, ol, oh, problems, heads, L, D, items, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spk

extern "C" {

// q / k / v: pointer and element strides (problem, token, head) of each
// [problems, L, heads, D] view (strides multiples of 8, 16-byte aligned); o a
// contiguous [problems, L, heads, D].  D a multiple of 8, at most 256; dv
// the instantiated width of the P.V product (>= D); items, solo, mt and grid
// from kernels.attention_plan.
int sp_lanes_attention(const void* q, long qb, long ql, long qh, const void* k, long kb,
                       long kl, long kh, const void* v, long vb, long vl, long vh, void* o,
                       long ob, long ol, long oh, int problems, int heads, int L, int D,
                       int dv, int items, int solo, int mt, int grid, float scale,
                       void* stream) {
  using namespace spk;
  if (D % 8 || D > dv || L < 1 || grid < 1 || items < 1 || (solo && (L > AW_ROWS || mt != 1)) ||
      (mt != 1 && (mt != 2 || dv > 80)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t e = make_view_tmap(&tq, q, D, heads, L, problems, qh, ql, qb);
  if (e == cudaSuccess) e = make_view_tmap(&tk, k, D, heads, L, problems, kh, kl, kb);
  if (e == cudaSuccess) e = make_view_tmap(&tv, v, D, heads, L, problems, vh, vl, vb);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
#define SPK_AW_ARGS tq, tk, tv, o, ob, ol, oh, problems, heads, L, D, items, grid, scale, st
#define SPK_AW_CASE(DVV)                                                  \
  case DVV:                                                               \
    return (int)(solo      ? launch_wgmma_attention<DVV, true, 1>(SPK_AW_ARGS)  \
                 : mt == 1 ? launch_wgmma_attention<DVV, false, 1>(SPK_AW_ARGS) \
                           : launch_wgmma_attention<DVV, false, (DVV <= 80 ? 2 : 1)>(SPK_AW_ARGS));
  switch (dv) {
    SPK_AW_CASE(16)
    SPK_AW_CASE(32)
    SPK_AW_CASE(48)
    SPK_AW_CASE(64)
    SPK_AW_CASE(72)
    SPK_AW_CASE(80)
    SPK_AW_CASE(96)
    SPK_AW_CASE(128)
    SPK_AW_CASE(144)
    SPK_AW_CASE(192)
    SPK_AW_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_AW_CASE
#undef SPK_AW_ARGS
}

}  // extern "C"
