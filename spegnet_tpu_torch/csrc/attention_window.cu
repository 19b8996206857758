// Window attention of the T-block, the Q-pool front and the gen-1 block on
// Hopper, reading q / k / v straight out of a qkv projection output: TMA,
// wgmma for both products, warp specialisation, a persistent grid, windows
// shorter than an m-tile packed under a block-diagonal mask.
//
// Replaces the attention inside spegnet_tpu/ops/fused_block_t.py `_kernel`
// (:349, its body `_fwd_math` :277-330, the T-block #1 / #2, and #10's
// `_kernel_i8`), `_qpool_kernel` (:634, the transition front #3 and #11)
// and spegnet_tpu/ops/fused_block.py `_kernel` (:99, gen-1 #7 and #12):
// per window and head, softmax(q k^T * scale) v with the scores, the max and
// the softmax in f32.
//
// Contract.  The matrix is token-major [k_rows, ld] with the nn.Linear
// column order of Hiera's qkv layer: q heads at [0, H*D), k heads at
// [H*D, 2*H*D), v heads at [2*H*D, 3*H*D) (the front's shortcut columns may
// follow).  Query window w is query rows [w*Lq, (w+1)*Lq) and attends to key
// rows [w*Lk, (w+1)*Lk).  The T-block and gen-1 block (sp_window_attention)
// read their queries from the same rows (Lq = Lk); the Q-pooling front
// (sp_qpool_attention) reads query row j as the elementwise max of q over
// token rows 4j..4j+3 (the 2x2 pool of a Morton-ordered grid, Lq = Lk / 4).
// The output is a contiguous [q_rows, H*D] bf16; with `lse`, each query
// row's log-sum-exp of its scaled scores in log2 units, [q_rows, H] f32:
// m * scale * log2(e) + log2(sum_j exp2((s_j - m) * scale * log2(e))), from
// which the backward (hiera_block_bwd.cu) rebuilds P = exp2(s * scale *
// log2 e - lse).
//
// Numerics: the row sums add the unrounded f32 probabilities, P is rounded
// to bf16 for the product with v, and the output is normalised after that
// product (the convention of attention_lanes.cu); exp2 is the SFU's.
//
// What bounds it on the H100: per query row and head, 4 Lk D FLOPs against
// the bytes of q, k, v read once and o written once.  Hiera-L's windows
// (Lk 16-1024 at D 72) are bytes-bound at the tensor-core rate except the
// global blocks (Lk 1024), which are near the balance point.  The design:
//
// * One tensor map over the matrix: (D, head slots, rows) with byte
//   strides 2 D and 2 ld and boxes of 64 columns x 1 head x 64 rows,
//   128-byte swizzle.  q, k, v of head h are head slots h, H + h and 2 H + h;
//   a box past column D, past the last row or past the last head slot reads
//   zeros, which pads the head dim to the wgmma width and never reads a
//   neighbouring head.  One box spans 64 consecutive rows, however many
//   windows they hold.  The maps of the last 16 calls are kept (host time
//   per call).
// * Two work modes (kernels.window_plan):
//   - shared (Lq a multiple of 128, Lk of 64, not pooled): an item is
//     128 * MT query rows of one (window, head); both consumer warpgroups
//     read each 64-key K/V tile of the window (MT = 2: 256 query rows per
//     tile).
//   - per consumer (every other geometry): each consumer takes one 64-row
//     m-tile of query rows of one head and its own slot of each stage, and
//     walks the keys of the windows its rows touch in 64-key tiles.  Where
//     a tile is not one window's (Lq or Lk not a multiple of 64: L 16, the
//     fronts), MASK applies the block-diagonal mask to every score: key k
//     counts for row r iff k / Lk == r / Lq.  So Hiera's L 16 windows run
//     four to an m-tile and one 64-key tile, instead of 48 zero rows of
//     every 64.  Keys of another window cost only tensor-core work, which
//     those geometries have to spare by more than 10x.
// * POOL (the fronts, per consumer): TMA cannot take a max, so warps 1-3
//   of the producer warpgroup build each Q box: 16-byte loads of the 4
//   token rows, __hmax2, stores into the 128-byte-swizzled layout TMA
//   would have written, then a proxy fence and an arrive on the Q buffer's
//   barrier.  The pooled q never goes through global memory, and the front
//   is one launch.  The producer warpgroup keeps 72 registers for it, the
//   consumers 216.
// * As attention_lanes.cu: one producer thread issues every TMA load into
//   a ring of K/V stages and two Q buffers (one where two stages would not
//   fit beside them) with full / empty mbarriers; `setmaxnreg` moves
//   registers to the two consumer warpgroups; per key tile a consumer
//   issues S_j = Q K_j^T, then P_{j-1} V_{j-1}, and runs the online softmax
//   of S_j while P.V is on the tensor cores (where only one stage fits,
//   per-consumer items at head dims above 128, the two products of each
//   tile run one after the other).  Scores, probabilities and the output
//   accumulator stay in registers.
//
// No wgmma sits under a data-dependent branch: an idle consumer computes
// on the zeros of its out-of-bound boxes and stores nothing, and the mask
// is a select on every score, compiled in or out.
#include "wgmma_attn.cuh"

namespace spk {
namespace {

constexpr int WA_ROWS = 64;                    // rows of a box, an m-tile, a key tile
constexpr int WA_THREADS = 384;                // producer + two consumer warpgroups
constexpr uint32_t WA_BOX = WA_ROWS * 64 * 2;  // bytes of one 64 x 64 bf16 box
constexpr int WA_POOLERS = 96;                 // producer warps 1-3 pool q (POOL)
constexpr uint32_t WA_SMEM = 225 * 1024;       // of the 227 KB a block may take

// DV: the head width of the P.V product (D rounded up to an instantiated
// wgmma N).  SHARED: one K/V slot a stage, read by both consumers; else one
// slot per consumer.  MT: 64-row m-tiles a consumer computes per item (2
// only shared, DV <= 80).  POOL: pooled queries, built by the producer
// warpgroup's warps 1-3 (per consumer only), which keep more registers.
// Shared memory: Q [QB][consumer][m-tile][atom] boxes, then K/V stages
// [ST][K | V][atom][slot] boxes, each 1024-byte aligned; two Q buffers
// where two stages still fit beside them, and as many stages as fit (at
// most 8).
template <int DV, bool SHARED, int MT, bool POOL>
struct WaCfg {
  static_assert(MT == 1 || (MT == 2 && SHARED && DV <= 80), "m-tiles");
  static_assert(!(POOL && SHARED), "pooled items are per consumer");
  // 168 registers a thread at launch (384 threads); the producer warpgroup
  // gives what the consumers take.
  static constexpr int PREGS = POOL ? 72 : 40, CREGS = POOL ? 216 : 232;
  static constexpr int NA = (DV + 63) / 64;  // 64-column atoms
  static constexpr int KS = (DV + 15) / 16;  // k16 steps of Q K^T
  static constexpr int SLOTS = SHARED ? 1 : 2;
  static constexpr uint32_t kQ = 2 * MT * NA * WA_BOX;  // one Q buffer
  static constexpr uint32_t kKV = NA * SLOTS * WA_BOX;  // K or V of a stage
  static constexpr int QB = WA_SMEM >= 2 * kQ + 2 * 2 * kKV ? 2 : 1;
  static constexpr int ST_FIT = (WA_SMEM - QB * kQ) / (2 * kKV);
  static constexpr int ST = ST_FIT > 8 ? 8 : ST_FIT;
  static constexpr uint32_t kBars = 2 * (ST + QB) * 8;
  static constexpr int kBytes = QB * kQ + ST * 2 * kKV + kBars + 1024;
  static_assert(ST >= 1 && kBytes <= 232448, "shared memory");
};

// What consumer c computes of one item: query rows [row0, row0 + 64 * MT)
// of head `head`, against `ntiles` 64-key tiles from key row kb.  `active`:
// it has rows to store.  tests/test_torch_window_attention.py mirrors it.
struct WinWork {
  int head, row0, kb, ntiles;
  bool active;
};

__device__ __forceinline__ WinWork win_decode(int item, int c, int q_rows, int heads, int lq,
                                              int lk, bool shared, int mt) {
  WinWork w;
  if (shared) {  // item = (window * heads + head) * chunks + chunk
    const int rows = 2 * mt * WA_ROWS, chunks = lq / rows;
    const int wh = item / chunks, win = wh / heads;
    w.head = wh % heads;
    w.row0 = win * lq + (item % chunks) * rows + c * mt * WA_ROWS;
    w.kb = win * lk;
    w.ntiles = lk / WA_ROWS;
    w.active = true;
  } else {  // item = pair * heads + head; consumer c takes m-tile 2 pair + c
    w.head = item % heads;
    w.row0 = (2 * (item / heads) + c) * WA_ROWS;
    w.active = w.row0 < q_rows;
    const int last = min(w.row0 + WA_ROWS, q_rows) - 1;
    w.kb = (w.row0 / lq) * lk;
    w.ntiles = w.active ? ((last / lq + 1) * lk - w.kb + WA_ROWS - 1) / WA_ROWS : 0;
  }
  return w;
}

template <int DV, bool SHARED, int MT, bool MASK, bool POOL>
__global__ void __launch_bounds__(WA_THREADS, 1)
window_attention_kernel(const __grid_constant__ CUtensorMap tqkv, const bf16* __restrict__ qkv,
                        int ld, bf16* __restrict__ o, float* __restrict__ lse, int q_rows,
                        int heads, int D, int lq, int lk, int items, float scale) {
  using C = WaCfg<DV, SHARED, MT, POOL>;
  static_assert(!(MASK && SHARED), "shared items never mask");
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

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int b = 0; b < QB; ++b) {
      mbar_init(&qfull[b], POOL ? WA_POOLERS : 1);
      mbar_init(&qempty[b], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<C::PREGS>();
    if constexpr (POOL) {
      if (tid >= 32) {
        // Warps 1-3 build each item's pooled Q boxes (consumer c's m-tile
        // in box c of the buffer), in the layout a 128-byte-swizzled TMA
        // load leaves: chunk ch (16 bytes) of box row r at ch ^ (r % 8).
        const int pt = tid - 32, nch = D / 8;
        // Columns past D are zero in every Q box of both buffers, once:
        // Q K^T reads them up to the k16 step holding D (K is zero there
        // too), and the pooled rows never write them.
        const int pad = NA * 8 - nch;
        for (int t = pt; t < QB * 2 * WA_ROWS * pad; t += WA_POOLERS) {
          const int ch = nch + t % pad, r = (t / pad) % WA_ROWS, box = t / (pad * WA_ROWS);
          *reinterpret_cast<uint4*>(qs + (box * NA + ch / 8) * WA_BOX + r * 128 +
                                    (((ch % 8) ^ (r % 8)) << 4)) = zero_vec8();
        }
        const int tasks = 2 * WA_ROWS * nch;  // (consumer, row, chunk), chunk fastest
        int n = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
          const WinWork w0 = win_decode(item, 0, q_rows, heads, lq, lk, false, 1);
          const WinWork w1 = win_decode(item, 1, q_rows, heads, lq, lk, false, 1);
          const int b = n % QB;
          if (n >= QB) mbar_wait(&qempty[b], ((n / QB) - 1) & 1);
          unsigned char* qb = qs + b * C::kQ;
          // Two chunks a thread in flight (8 loads): 72 registers hold them.
          for (int t0 = pt; t0 < tasks; t0 += 2 * WA_POOLERS) {
            uint4 v[2][4];
            int dst[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int t = t0 + u * WA_POOLERS;
              const int c = t / (WA_ROWS * nch), rc = t - c * (WA_ROWS * nch);
              const int r = rc / nch, ch = rc - r * nch;
              const WinWork& w = c ? w1 : w0;
              const int j = w.row0 + r;  // the pooled query row
              const bool in = t < tasks && w.active && j < q_rows;
              dst[u] = t < tasks
                           ? (c * NA + ch / 8) * WA_BOX + r * 128 + (((ch % 8) ^ (r % 8)) << 4)
                           : -1;
              const uint4* src = reinterpret_cast<const uint4*>(
                  qkv + 4 * (long)(in ? j : 0) * ld + w.head * D + ch * 8);
#pragma unroll
              for (int s = 0; s < 4; ++s)
                v[u][s] = in ? __ldg(src + s * (long)(ld / 8)) : zero_vec8();
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (dst[u] < 0) continue;
#pragma unroll
              for (int s = 1; s < 4; ++s)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  pairs(v[u][0])[e] = __hmax2(pairs(v[u][0])[e], pairs(v[u][s])[e]);
              *reinterpret_cast<uint4*>(qb + dst[u]) = v[u][0];
            }
          }
          fence_proxy_async();  // the boxes are read by wgmma (the async proxy)
          mbar_arrive(&qfull[b]);
        }
        return;
      }
    }
    // One thread issues every TMA load, in the consumers' order.
    if (tid != 0) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const WinWork w0 = win_decode(item, 0, q_rows, heads, lq, lk, SHARED, MT);
      const WinWork w1 = win_decode(item, 1, q_rows, heads, lq, lk, SHARED, MT);
      const int nt = max(w0.ntiles, w1.ntiles);
      if constexpr (!POOL) {
        const int b = n % QB;
        if (n >= QB) mbar_wait(&qempty[b], ((n / QB) - 1) & 1);
        mbar_arrive_expect_tx(&qfull[b], 2 * MT * NA * WA_BOX);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const WinWork& w = c ? w1 : w0;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int a = 0; a < NA; ++a)
              tma_load_3d(qs + b * C::kQ + ((c * MT + i) * NA + a) * WA_BOX, &tqkv, &qfull[b],
                          64 * a, w.head, w.row0 + i * WA_ROWS);
        }
      }
      for (int j = 0; j < nt; ++j, ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        unsigned char* ks = kvs + s * 2 * C::kKV;
        unsigned char* vs = ks + C::kKV;
        mbar_arrive_expect_tx(&full[s], 2 * NA * SLOTS * WA_BOX);
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          const WinWork& w = sl ? w1 : w0;
          const int row = w.kb + j * WA_ROWS;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const uint32_t off = (a * SLOTS + sl) * WA_BOX;
            tma_load_3d(ks + off, &tqkv, &full[s], 64 * a, heads + w.head, row);
            tma_load_3d(vs + off, &tqkv, &full[s], 64 * a, 2 * heads + w.head, row);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns MT 64-row m-tiles of each item.
  setmaxnreg_inc<C::CREGS>();
  const int c = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  const uint32_t slot = SHARED ? 0 : c * WA_BOX;   // this consumer's keys in a stage
  constexpr uint32_t kAtomKV = SLOTS * WA_BOX;      // atom stride in a K or V stage
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const WinWork wk = win_decode(item, c, q_rows, heads, lq, lk, SHARED, MT);
    const int nt = SHARED ? wk.ntiles
                          : max(wk.ntiles, win_decode(item, 1 - c, q_rows, heads, lq, lk,
                                                      SHARED, MT).ntiles);
    // MASK: the first key of this thread's two rows' windows (rows g and
    // g + 8 of its warp's 16), relative to the item's first key.
    int lo0 = 0, lo1 = 0;
    if (MASK) {
      const int r0 = wk.row0 + w * 16 + g;
      lo0 = (r0 / lq) * lk - wk.kb;
      lo1 = ((r0 + 8) / lq) * lk - wk.kb;
    }
    const int b = n % QB;
    mbar_wait(&qfull[b], (n / QB) & 1);
    const unsigned char* qa = qs + b * C::kQ + c * MT * NA * WA_BOX;
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
                           wgmma_desc_sw128(qa + (i * NA + kk / 4) * WA_BOX + (kk % 4) * 32),
                           wgmma_desc_sw128(ks + (kk / 4) * kAtomKV + (kk % 4) * 32), kk > 0);
      wgmma_commit();
    };
    // O = a O + P V over stage s's tile.
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
    // Online softmax of key tile j's scores in sc, in place: p = exp2(s *
    // scale * log2e - max * scale * log2e); the row sums add the f32 p; al
    // rescales the rows' earlier sums and output.  MASK: scores of keys
    // outside the row's window are -inf first, and a row with no key yet
    // (its max still -inf) keeps p, al and its sums at 0.
    auto softmax = [&](int j) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (MASK) {
          const int k0 = lo0 - j * WA_ROWS, k1 = lo1 - j * WA_ROWS;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = jj * 8 + 2 * t + e;
              const bool in0 = (unsigned)(col - k0) < (unsigned)lk;
              const bool in1 = (unsigned)(col - k1) < (unsigned)lk;
              sc[i][4 * jj + e] = in0 ? sc[i][4 * jj + e] : -INFINITY;
              sc[i][4 * jj + 2 + e] = in1 ? sc[i][4 * jj + 2 + e] : -INFINITY;
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
        const float mn0 = fmaxf(m[i][0], mx0), mn1 = fmaxf(m[i][1], mx1);
        // Without MASK every tile holds keys of every row: mn is finite.
        const float u0 = MASK && mn0 == -INFINITY ? 0.f : mn0;
        const float u1 = MASK && mn1 == -INFINITY ? 0.f : mn1;
        al[i][0] = fast_exp2((m[i][0] - u0) * sl2);
        al[i][1] = fast_exp2((m[i][1] - u1) * sl2);
        m[i][0] = mn0;
        m[i][1] = mn1;
        const float b0 = u0 * sl2, b1 = u1 * sl2;
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

    if constexpr (ST >= 2) {
      int sp = it % ST;  // stage of the previous tile
      mbar_wait(&full[sp], (it / ST) & 1);
      issue_s(sp);
      wgmma_wait<0>();
      fence_acc(sc);
      if (nt == 1) mbar_arrive(&qempty[b]);  // Q read for the last time
      softmax(0);
      round_p();
      for (int j = 1; j < nt; ++j) {
        ++it;
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        issue_s(s);
        issue_pv(sp);
        wgmma_wait<1>();
        fence_acc(sc);
        if (j == nt - 1) mbar_arrive(&qempty[b]);
        softmax(j);
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
    } else {  // one stage: each tile's two products in turn
      for (int j = 0; j < nt; ++j, ++it) {
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        issue_s(s);
        wgmma_wait<0>();
        fence_acc(sc);
        if (j == nt - 1) mbar_arrive(&qempty[b]);
        softmax(j);
        round_p();
        issue_pv(s);
        wgmma_wait<0>();
        fence_acc(acc);
        fence_frag(pf);
        mbar_arrive(&empty[s]);
      }
    }

#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float l0 = l[i][0], l1 = l[i][1];
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
      }
      if (!wk.active) continue;
      // Rows past the last query row (a partial last m-tile) have no keys.
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const int q0 = wk.row0 + i * WA_ROWS + w * 16 + g, q1 = q0 + 8;
      if (lse && t == 0) {
        if (q0 < q_rows) lse[(long)q0 * heads + wk.head] = m[i][0] * sl2 + log2f(l0);
        if (q1 < q_rows) lse[(long)q1 * heads + wk.head] = m[i][1] * sl2 + log2f(l1);
      }
      const long stride = (long)heads * D;
      bf16* d0 = o + q0 * stride + wk.head * D;
      bf16* d1 = d0 + 8 * stride;
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj) {
        const int col = jj * 8 + 2 * t;
        if (col >= D) continue;
        if (q0 < q_rows)
          *reinterpret_cast<uint32_t*>(d0 + col) = pack_bf16(acc[i][4 * jj] * inv0,
                                                              acc[i][4 * jj + 1] * inv0);
        if (q1 < q_rows)
          *reinterpret_cast<uint32_t*>(d1 + col) = pack_bf16(acc[i][4 * jj + 2] * inv1,
                                                              acc[i][4 * jj + 3] * inv1);
      }
    }
  }
}

// Tensor map of a token-major [rows, ld] bf16 matrix as (D, slots, rows):
// head slot h is columns [h * D, (h + 1) * D); byte strides 2 D and 2 ld
// (multiples of 16); boxes of 64 x 1 x 64 with the 128-byte swizzle,
// out-of-bound elements read as zeros (kernels.window_tmap mirrors it).
cudaError_t make_rows_tmap(CUtensorMap* map, const void* ptr, int D, int slots, int rows,
                           int ld) {
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)slots, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)ld * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)WA_ROWS};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// make_rows_tmap through a cache of the last 16 maps of this host thread:
// a forward hands the launcher the same few (pointer, shape) pairs again
// and again (the caching allocator reuses its blocks), and encoding a map
// is host time on every call.  A map depends on nothing but its key.
cudaError_t rows_tmap(CUtensorMap* map, const void* ptr, int D, int slots, int rows, int ld) {
  struct Key {
    const void* ptr;
    int D, slots, rows, ld;
  };
  constexpr int N = 16;
  thread_local Key keys[N] = {};
  thread_local CUtensorMap maps[N];
  thread_local int next = 0;
  for (int i = 0; i < N; ++i) {
    const Key& k = keys[i];
    if (k.ptr == ptr && k.D == D && k.slots == slots && k.rows == rows && k.ld == ld) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const cudaError_t e = make_rows_tmap(map, ptr, D, slots, rows, ld);
  if (e == cudaSuccess) {
    keys[next] = Key{ptr, D, slots, rows, ld};
    maps[next] = *map;
    next = (next + 1) % N;
  }
  return e;
}

template <int DV, bool SHARED, int MT, bool MASK, bool POOL>
cudaError_t launch_window(const CUtensorMap& tqkv, const void* qkv, int ld, void* o, float* lse,
                          int q_rows, int heads, int D, int lq, int lk, int items, int grid,
                          float scale, cudaStream_t st) {
  constexpr int smem = WaCfg<DV, SHARED, MT, POOL>::kBytes;
  static bool attr = false;  // the shared-memory attribute, set once per instantiation
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(window_attention_kernel<DV, SHARED, MT, MASK, POOL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  window_attention_kernel<DV, SHARED, MT, MASK, POOL><<<grid, WA_THREADS, smem, st>>>(
      tqkv, (const bf16*)qkv, ld, (bf16*)o, lse, q_rows, heads, D, lq, lk, items, scale);
  return cudaGetLastError();
}

// The launch behind both C entries.  qkv: [q_rows / lq * lk, ld] bf16 with
// the heads' q, k and v at head slots [0, heads), [heads, 2 heads),
// [2 heads, 3 heads); pool: query row j the max of q over rows 4j..4j+3
// (lq = lk / 4).  out [q_rows, heads * D]; lse (nullable) [q_rows, heads]
// f32.  D a multiple of 8 and at most dv.  `plan` from kernels.window_plan,
// one 64-bit word: mode | grid << 16 | items << 32, mode = dv | shared << 9
// | (mt - 1) << 10 | mask << 11 | pool << 12.
int run_window_attention(const void* qkv, int ld, void* out, void* lse, int q_rows, int heads,
                         int D, int lq, int lk, bool pool, long long plan, float scale,
                         cudaStream_t st) {
  const int mode = (int)(plan & 0xffff), grid = (int)((plan >> 16) & 0xffff);
  const int items = (int)(plan >> 32);
  const int dv = mode & 511, shared = (mode >> 9) & 1, mt = ((mode >> 10) & 1) + 1;
  const int mask = (mode >> 11) & 1;
  if (D % 8 || D > dv || lq < 1 || lk < 1 || q_rows % lq || grid < 1 || items < 1 ||
      ((mode >> 12) & 1) != (int)pool || (pool && (shared || lk != 4 * lq)) ||
      (shared && (mask || lq % (128 * mt) || lk % WA_ROWS)) ||
      (mt == 2 && (!shared || dv > 80)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tqkv;
  const cudaError_t e = rows_tmap(&tqkv, qkv, D, 3 * heads, q_rows / lq * lk, ld);
  if (e != cudaSuccess) return (int)e;
  float* ls = (float*)lse;
#define SPK_WA_ARGS tqkv, qkv, ld, out, ls, q_rows, heads, D, lq, lk, items, grid, scale, st
#define SPK_WA_PC(DVV, POOL)                                         \
  (mask ? launch_window<DVV, false, 1, true, POOL>(SPK_WA_ARGS)      \
        : launch_window<DVV, false, 1, false, POOL>(SPK_WA_ARGS))
#define SPK_WA_CASE(DVV)                                                                  \
  case DVV:                                                                               \
    return (int)(pool      ? SPK_WA_PC(DVV, true)                                         \
                 : !shared ? SPK_WA_PC(DVV, false)                                        \
                 : mt == 1 ? launch_window<DVV, true, 1, false, false>(SPK_WA_ARGS)      \
                           : launch_window<DVV, true, (DVV <= 80 ? 2 : 1), false, false>( \
                                 SPK_WA_ARGS));
  switch (dv) {
    SPK_WA_CASE(16)
    SPK_WA_CASE(32)
    SPK_WA_CASE(48)
    SPK_WA_CASE(64)
    SPK_WA_CASE(72)
    SPK_WA_CASE(80)
    SPK_WA_CASE(96)
    SPK_WA_CASE(128)
    SPK_WA_CASE(144)
    SPK_WA_CASE(192)
    SPK_WA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_WA_CASE
#undef SPK_WA_PC
#undef SPK_WA_ARGS
}

}  // namespace
}  // namespace spk

extern "C" {

// qkv [rows, ld] -> out [rows, heads * D] (lse nullable, [rows, heads] f32):
// windows of L rows, q, k and v read from qkv's head slots.
int sp_window_attention(const void* qkv, int ld, void* out, void* lse, int rows, int heads,
                        int D, int L, long long plan, float scale, void* stream) {
  return spk::run_window_attention(qkv, ld, out, lse, rows, heads, D, L, L, false, plan, scale,
                                   (cudaStream_t)stream);
}

// The Q-pooling front's attention: y [rows_in, ld] (q/k/v columns first,
// the shortcut's after) -> out [rows_in / 4, heads * D] (lse nullable,
// [rows_in / 4, heads] f32): key windows of L token rows, query windows of
// L / 4 pooled rows, q max-pooled over each 4 rows inside the kernel.
int sp_qpool_attention(const void* y, int ld, void* out, void* lse, int rows_in, int heads,
                       int D, int L, long long plan, float scale, void* stream) {
  return spk::run_window_attention(y, ld, out, lse, rows_in / 4, heads, D, L / 4, L, true, plan,
                                   scale, (cudaStream_t)stream);
}

}  // extern "C"
