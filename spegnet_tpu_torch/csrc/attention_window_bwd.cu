// Backward of the window attention (attention_window.cu) on Hopper: TMA,
// wgmma for every product, warp specialisation, a persistent grid, keys on
// the wgmma m-tile, windows shorter than a tile packed under a
// block-diagonal mask, and a dQ summed in a fixed order.
//
// Replaces the attention part of spegnet_tpu/ops/fused_block_t.py
// `_bwd_kernel` (:1165, entry `_backward` :1363; the T-block backward #5,
// #6 and gen-1's #7 bf16 backward) and of `_qpool_bwd_kernel` (entry
// `_qpool_backward` :935, the front's #4): per window and head, from the
// forward's output o, its log-sum-exp and the output gradient dO,
//
//   P   = exp2(s * scale * log2 e - lse),  s = q k^T   (P rebuilt from lse,
//         in log2 units as attention_window.cu writes it)
//   Di  = rowsum(dO o)                                  (f32)
//   dV  = P^T dO                                        (P rounded to bf16)
//   dS  = P (dO v^T - Di) scale                         (rounded to bf16)
//   dK  = dS^T q,  dQ = dS k
//
// JAX's TPU kernel rounds dS the same way (fused_block_t.py:1310-1311); it
// takes Di as rowsum(dP P), the same quantity.
//
// Contract (sp_attention_bwd).  q, k, v, o, dout, dq, dk, dv are column
// ranges of row-major bf16 matrices (each a pointer to head 0's first
// column and a row stride), heads * D columns each.  Query window w is query
// rows [w Lq, (w + 1) Lq) and attends to key rows [w Lk, (w + 1) Lk).  The
// T-block passes Lq = Lk; the Q-pool front passes its pooled q and Lq =
// Lk / 4, with k and v inside its projection output (row stride 3 H D +
// Cout).  Two calls on the same inputs give the same bits: every output
// element is written once, by one thread, from sums in a fixed order.
//
// Bound on the H100: per query row, head and key 10 D FLOPs (five
// products) against q, k, v, o, dO, lse read once and dq, dk, dv written
// once.  Hiera-L's windows (D 72) are bytes-bound except the global blocks
// (Lk 1024).  The design (kernels.window_bwd_plan picks the route):
//
// * Tensor maps over (D, heads, rows) of each operand, byte strides 2 D and
//   2 ld, 128-byte swizzle, boxes of 64 columns x 1 head x 64 rows (16 for
//   the fronts' packed query tiles); a box past column D or the last row
//   reads zeros.  The maps of the last 32 encodings are kept (host time).
// * Keys on the m-tile: a consumer warpgroup owns 64 keys of one head and
//   keeps their dK and dV in registers.  Per query tile it issues
//   S^T = K Q^T and dP^T = V dO^T (both operands K-major), builds P^T and
//   dS^T in registers with the tile's lse and Di (staged in shared memory,
//   read by column: a thread's accumulator columns are queries), then
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A operands
//   and dO, Q as MN-major B operands.  Q, dO, lse and Di are read once per
//   64 keys.
// * Packed route (Lk divides 64: Hiera's L 16 and L 64 windows, the fronts
//   t12 and t23): one unit holds every key of 64 / Lk windows and every
//   query of them, QT = 64 Lq / Lk rows (64, or 16 at the fronts), under
//   the block-diagonal mask where Lk < 64 (key k counts for query r iff
//   k / Lk == r / Lq, a select, so a key of another window gives P = 0
//   exactly).  dQ is then complete inside the unit: dS^T goes to shared
//   memory as bf16 and dQ = dS K runs with both operands MN-major (queries
//   on M: at QT 16 rows 16-63 of that product are never stored).  Five
//   products, one launch.  Units stream through a ring of slots (K, V, Q,
//   dO of one unit each) that the two consumers take in turn; producer
//   warps 1-3 compute each unit's Di from o and dO (16-byte loads, 16 lanes
//   a row) and stage lse beside it.
// * Split route (every other geometry: stage 3, the global blocks, t34):
//   dQ sums over key tiles that other consumers own, so it runs as its own
//   kernel first, FlashAttention-2's split: attn_bwd_dq_kernel puts 64
//   queries on the m-tile (shared items of 128 query rows of one window
//   where Lq % 128 == 0), walks the keys of their windows, recomputes S and
//   dP and sums dQ += dS K over the key tiles in order (seven products in
//   all, which costs only where the work is bound by operations: the global
//   blocks); its consumers compute their rows' Di and write it for the
//   second kernel, attn_bwd_dkdv_kernel, which walks the query tiles of each
//   key tile's windows (both consumers reading the same Q / dO stages where
//   Lk % 128 == 0).
// * As attention_window.cu: one producer thread issues every TMA load into
//   rings of full / empty mbarriers, setmaxnreg gives the consumers the
//   registers, the products of one tile overlap the softmax-like math of
//   the next where two stages fit, and no wgmma sits under a data-dependent
//   branch.
#include "wgmma_attn.cuh"

namespace spk {
namespace {

constexpr float AB_LOG2E = 1.4426950408889634f;
constexpr int AB_ROWS = 64;                    // rows of a key tile, of a split query tile
constexpr int AB_THREADS = 384;                // producer + two consumer warpgroups
constexpr uint32_t AB_BOX = AB_ROWS * 128;     // one 64-row x 64-column bf16 box
constexpr int AB_STAGERS = 96;                 // producer warps 1-3: lse / Di rows
constexpr uint32_t AB_SMEM = 225 * 1024;       // of the 227 KB a block may take
// Registers a thread after setmaxnreg (168 at launch; producer + 2
// consumers <= 504): the packed kernel's consumers hold dK, dV and dQ
// (216; its stagers 72), the dK / dV kernel's producer only issues TMA
// loads (24; consumers 240), the dQ kernel's consumers need the fewest (200)
// and its stagers keep 8 chunks a thread in flight (104).
constexpr int PK_PREGS = 72, PK_CREGS = 216;
constexpr int KV_PREGS = 24, KV_CREGS = 240;
constexpr int DQ_PREGS = 104, DQ_CREGS = 200;

// One consumer's copy of the thread's two accumulator rows r0 = 16 w + g and
// r0 + 8: element e of n8 block j sits at row r0 + 8 (e >> 1), column
// 8 j + 2 t + (e & 1).

// P^T (or P) and dS^T (or dS) in registers -> bf16 A fragments: k-step kk
// covers n8 blocks 2 kk and 2 kk + 1.
template <int K>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[K][4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    f[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    f[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Rows [row0, row0 + 64) of dK / dV (keys on M) or dQ (queries on M) from
// a consumer's accumulator, as bf16: rows below `limit`, columns below D.
// The four lanes of a quad (t = 0..3) hold columns 8 j + 2 t, +1 of each n8
// block j of a row; for every four blocks they trade pairs (three
// shuffles) so that lane t holds all 8 columns of block 4 q + t and stores
// them as one 16-byte vector: a quad writes 64 contiguous bytes of a row.
// The blocks past the last four store their pairs as they are.
template <int DV>
__device__ __forceinline__ void store_rows(bf16* dst, long ld, int row0, int limit, int D,
                                           const float (&acc)[DV / 2], int w, int g, int t) {
  constexpr int NB = DV / 8;
  const int lane = 4 * g + t;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 16 * w + g + 8 * hh;
    const bool ok = row < limit;
    bf16* d = dst + (long)row * ld;
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      uint32_t v[4], r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = pack_bf16(acc[4 * (4 * q + i) + 2 * hh], acc[4 * (4 * q + i) + 2 * hh + 1]);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)  // lane t receives lane ((t + rr) % 4)'s pair of block 4 q + t
        r[rr] = __shfl_sync(0xffffffffu, pick4(v, (t - rr) & 3), (lane & ~3) | ((t + rr) & 3));
      const int col = 8 * (4 * q + t);
      if (ok && col < D)
        *reinterpret_cast<uint4*>(d + col) =
            make_uint4(pick4(r, (0 - t) & 3), pick4(r, (1 - t) & 3), pick4(r, (2 - t) & 3),
                       pick4(r, (3 - t) & 3));
    }
#pragma unroll
    for (int jj = NB / 4 * 4; jj < NB; ++jj) {
      const int col = 8 * jj + 2 * t;
      if (ok && col < D)
        *reinterpret_cast<uint32_t*>(d + col) =
            pack_bf16(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
    }
  }
}

// sum_i a_i b_i over 8 bf16 pairs, in f32, in order.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(pairs(a)[e]), y = __bfloat1622float2(pairs(b)[e]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

constexpr int AB_BAR_STAGE = 3;  // named barrier of the 96 stagers (1, 2: the consumers)

__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(AB_BAR_STAGE), "n"(AB_STAGERS) : "memory");
}

// Where the dO tile of a stage lies in shared memory, as TMA wrote it: row
// r, 16-byte chunk ch at base + (r / 64) cstride + (ch / 8) atom + (r % 64)
// 128 + ((ch % 8) ^ (r % 8)) 16 (the 128-byte swizzle); `tma` completes
// when it has landed (phase parity `parity`).
struct DoTile {
  const unsigned char* base;
  uint32_t atom, cstride;
  uint64_t* tma;
  int parity;
};

// lse and Di = rowsum(dO o) of query rows [q0, q0 + n) of head h (n <= 192),
// by the 96 stager threads (pt), rows past q_rows 0: into ls[r] / di[r] and,
// where lse_t is non-null, lse_t[r] / di_t[r] (global).  Every 16-byte chunk
// of the rows is one task, (row, chunk) with the chunk fastest; a thread
// issues the loads of o for TASKS tasks at once (each row's lse before
// the first), waits for the stage's dO tile, writes each task's f32 sum (8
// products in order) to part [n][16], and after a barrier the thread of row
// r adds its chunks' sums in order.  o is the only operand read from global
// memory here: dO comes from the stage.
template <int TASKS>
__device__ __forceinline__ void stage_di(float* ls, float* di, float* lse_t, float* di_t,
                                         float* part, int n, int q0, int q_rows, int h,
                                         int heads, int D, const bf16* __restrict__ o, long ldo,
                                         const DoTile& dot, const float* __restrict__ lse,
                                         int pt) {
  const int nch = D / 8, tasks = n * nch;
  float lv[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = pt + k * AB_STAGERS, q = q0 + r;
    lv[k] = r < n && q < q_rows ? lse[(long)q * heads + h] : 0.f;
  }
  for (int b0 = 0; b0 < tasks; b0 += TASKS * AB_STAGERS) {
    uint4 a[TASKS];
#pragma unroll
    for (int i = 0; i < TASKS; ++i) {
      const int x = b0 + pt + i * AB_STAGERS, r = x / nch, ch = x - r * nch, q = q0 + r;
      const bool in = x < tasks && q < q_rows;
      a[i] = in ? __ldg(reinterpret_cast<const uint4*>(o + (long)q * ldo + (long)h * D + ch * 8))
                : zero_vec8();
    }
    mbar_wait(dot.tma, dot.parity);
#pragma unroll
    for (int i = 0; i < TASKS; ++i) {
      const int x = b0 + pt + i * AB_STAGERS, r = x / nch, ch = x - r * nch;
      if (x >= tasks) continue;
      const uint4 b = *reinterpret_cast<const uint4*>(
          dot.base + (r / 64) * dot.cstride + (ch / 8) * dot.atom + (r % 64) * 128 +
          (((ch % 8) ^ (r % 8)) << 4));
      part[r * 16 + ch] = dot8(a[i], b);
    }
  }
  stagers_sync();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = pt + k * AB_STAGERS;
    if (r >= n) continue;
    float s = 0.f;
    for (int ch = 0; ch < nch; ++ch) s += part[r * 16 + ch];
    di[r] = s;
    ls[r] = lv[k];
    if (lse_t && q0 + r < q_rows) {
      lse_t[r] = lv[k];
      di_t[r] = s;
    }
  }
  stagers_sync();  // part is free for the next rows
}

// ---------------------------------------------------------------------------
// Packed route: one kernel, dQ inside the unit.
// ---------------------------------------------------------------------------

// DV: the head width of the dK / dV / dQ products (D rounded up to a wgmma
// N); QT: query rows of a unit (64 Lq / Lk).  A slot holds one unit's K and
// V (64 rows) and Q and dO (QT rows), NA 64-column atoms each; then dS^T of
// each consumer, the stagers' partial sums, the slots' lse / Di rows, the
// barriers.
template <int DV, int QT>
struct PkCfg {
  static constexpr int NA = (DV + 63) / 64;
  static constexpr int KS = (DV + 15) / 16;  // k16 steps over the head dim
  static constexpr int QK = QT / 16;         // k16 steps over a unit's queries
  static constexpr uint32_t kK = NA * AB_BOX;
  static constexpr uint32_t kQ = NA * QT * 128;
  static constexpr uint32_t kSlot = 2 * kK + 2 * kQ;
  static constexpr uint32_t kDs = 2 * AB_BOX;
  static constexpr uint32_t kRows = 2 * QT * 4;
  static constexpr uint32_t kPart = QT * 16 * 4;
  static constexpr int S_FIT = (int)((AB_SMEM - kDs - kPart - 1024) / (kSlot + kRows + 32));
  static constexpr int S = S_FIT > 4 ? 4 : S_FIT;
  static constexpr int kBytes = S * (kSlot + kRows + 32) + kDs + kPart + 1024;
  // Units go to the consumers in turn and to the slots in turn: consumer
  // c's uses of slot s come every L units.
  static constexpr int L = S % 2 ? 2 * S : S;
  static_assert(QT == 16 || QT == 64, "query tile");
  static_assert(S >= 2 && kBytes <= 232448, "shared memory");
};

template <int DV, int QT, bool MASK>
__global__ void __launch_bounds__(AB_THREADS, 1)
attn_bwd_packed_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                       const bf16* __restrict__ o, long ldo, const float* __restrict__ lse,
                       bf16* __restrict__ dq, long lddq,
                       bf16* __restrict__ dk, long lddk, bf16* __restrict__ dv, long lddv,
                       int q_rows, int k_rows, int heads, int D, int lq, int lk, int units,
                       float scale) {
  using C = PkCfg<DV, QT>;
  constexpr int S = C::S, NA = C::NA, QK = C::QK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* slots = base;
  unsigned char* dsb = base + S * C::kSlot;
  float* part = reinterpret_cast<float*>(dsb + C::kDs);
  float* rows = part + QT * 16;
  // tma[s]: the slot's boxes landed; full[2 s + c]: its lse and Di staged
  // for consumer c (one barrier per consumer: a slot's uses alternate
  // between the consumers when S is odd, and a parity wait must see every
  // phase of its barrier); empty[s]: the slot's consumer is done with it.
  uint64_t* tma = reinterpret_cast<uint64_t*>(rows + S * 2 * QT);
  uint64_t* full = tma + S;
  uint64_t* empty = full + 2 * S;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&tma[s], 1);
      mbar_init(&full[2 * s], AB_STAGERS);
      mbar_init(&full[2 * s + 1], AB_STAGERS);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PK_PREGS>();
    if (tid >= 32) {  // stagers: each unit's lse and Di
      int j = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(&empty[s], ((j / S) - 1) & 1);
        const int h = u % heads, q0 = (u / heads) * AB_ROWS / lk * lq;
        float* ls = rows + s * 2 * QT;
        const DoTile dot{slots + s * C::kSlot + 2 * C::kK + C::kQ, QT * 128, 0, &tma[s],
                         (j / S) & 1};
        stage_di<6>(ls, ls + QT, nullptr, nullptr, part, QT, q0, q_rows, h, heads, D, o, ldo, dot,
                 lse, tid - 32);
        mbar_arrive(&full[2 * s + (j & 1)]);
      }
      return;
    }
    if (tid != 0) return;
    int j = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++j) {
      const int s = j % S;
      if (j >= S) mbar_wait(&empty[s], ((j / S) - 1) & 1);
      const int h = u % heads, k0 = (u / heads) * AB_ROWS, q0 = k0 / lk * lq;
      unsigned char* sl = slots + s * C::kSlot;
      mbar_arrive_expect_tx(&tma[s], C::kSlot);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_load_3d(sl + a * AB_BOX, &tk, &tma[s], 64 * a, h, k0);
        tma_load_3d(sl + C::kK + a * AB_BOX, &tv, &tma[s], 64 * a, h, k0);
        tma_load_3d(sl + 2 * C::kK + a * QT * 128, &tq, &tma[s], 64 * a, h, q0);
        tma_load_3d(sl + 2 * C::kK + C::kQ + a * QT * 128, &tdo, &tma[s], 64 * a, h, q0);
      }
    }
    return;
  }

  // Consumer c takes the block's units 2 i + c.
  setmaxnreg_inc<PK_CREGS>();
  const int c = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = scale * AB_LOG2E;
  unsigned char* ds_s = dsb + c * AB_BOX;
  int j = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++j) {
    if ((j & 1) != c) continue;
    const int s = j % S;
    const int h = u % heads, k0 = (u / heads) * AB_ROWS, q0 = k0 / lk * lq;
    // The first query (relative to q0) of the windows of this thread's keys.
    const int lo0 = (k0 + 16 * w + g) / lk * lq - q0;
    const int lo1 = (k0 + 16 * w + g + 8) / lk * lq - q0;
    const unsigned char* ks = slots + s * C::kSlot;
    const unsigned char* vs = ks + C::kK;
    const unsigned char* qs = ks + 2 * C::kK;
    const unsigned char* dos = qs + C::kQ;
    const float* ls = rows + s * 2 * QT;
    const float* di = ls + QT;
    float st[QT / 2], dpt[QT / 2], dka[DV / 2], dva[DV / 2], dqa[DV / 2];
    uint32_t pf[QK][4], df[QK][4];
    zero_acc(dka);
    zero_acc(dva);
    mbar_wait(&full[2 * s + c], (j / C::L) & 1);  // (after tma[s]: the stagers waited on it)

    // S^T = K Q^T and dP^T = V dO^T: [64 keys x QT queries].
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      const uint32_t off = (kk / 4) * AB_BOX + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * QT * 128 + (kk % 4) * 32;
      WgmmaSS<QT>::run(st, wgmma_desc_sw128(ks + off), wgmma_desc_sw128(qs + qoff), kk > 0);
      WgmmaSS<QT>::run(dpt, wgmma_desc_sw128(vs + off), wgmma_desc_sw128(dos + qoff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);
    // P^T and dS^T: a key of another window (mask) gives exactly 0.
#pragma unroll
    for (int jj = 0; jj < QT / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * t + (e & 1);
        const int lo = (e & 2) ? lo1 : lo0;
        const bool in = !MASK || (unsigned)(col - lo) < (unsigned)lq;
        const float p = in ? fast_exp2(fmaf(st[4 * jj + e], sl2, -ls[col])) : 0.f;
        dpt[4 * jj + e] = in ? p * (dpt[4 * jj + e] - di[col]) * scale : 0.f;
        st[4 * jj + e] = p;
      }
    pack_frags(pf, st);
    pack_frags(df, dpt);
    // dS^T as bf16 into the MN-major A of dQ = dS K: row = key, the 64
    // query columns of a row 128 bytes in the 128-byte swizzle.
#pragma unroll
    for (int kk = 0; kk < QK; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = 16 * w + g + 8 * (x & 1), blk = 2 * kk + (x >> 1);
        *reinterpret_cast<uint32_t*>(ds_s + r * 128 + ((blk ^ (r & 7)) << 4) + 4 * t) =
            df[kk][x];
      }
    fence_proxy_async();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      WgmmaRS<DV>::run(dva, pf[kk], wgmma_desc_sw128_mn(dos + kk * 2048, QT * 128));
      WgmmaRS<DV>::run(dka, df[kk], wgmma_desc_sw128_mn(qs + kk * 2048, QT * 128));
    }
    wgmma_commit();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // all of dS^T stored
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSSTT<DV>::run(dqa, wgmma_desc_sw128_mn(ds_s + kk * 2048, AB_BOX),
                         wgmma_desc_sw128_mn(ks + kk * 2048, AB_BOX), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dka);
    fence_acc(dva);
    fence_acc(dqa);
    fence_frag(pf);
    fence_frag(df);
    mbar_arrive(&empty[s]);
    const long hc = (long)h * D;
    store_rows<DV>(dk + hc, lddk, k0, k_rows, D, dka, w, g, t);
    store_rows<DV>(dv + hc, lddv, k0, k_rows, D, dva, w, g, t);
    store_rows<DV>(dq + hc, lddq, q0, min(q0 + QT, q_rows), D, dqa, w, g, t);
  }
}

// ---------------------------------------------------------------------------
// Split route, kernel 2: dK and dV.
// ---------------------------------------------------------------------------

// What consumer c computes of one item: keys [kr, kr + 64) of head `head`
// (key tile 2 (item / heads) + c), against `nq` 64-row query tiles from
// query row qb (the first of its windows).  tests/test_torch_window_attention_bwd.py
// mirrors it.
struct KvWork {
  int head, kr, qb, nq;
  bool active;
};

__device__ __forceinline__ KvWork kv_decode(int item, int c, int k_rows, int heads, int lq,
                                            int lk) {
  KvWork w;
  w.head = item % heads;
  w.kr = (2 * (item / heads) + c) * AB_ROWS;
  w.active = w.kr < k_rows;
  const int last = min(w.kr + AB_ROWS, k_rows) - 1;
  w.qb = w.kr / lk * lq;
  w.nq = w.active ? ((last / lk + 1) * lq - w.qb + AB_ROWS - 1) / AB_ROWS : 0;
  return w;
}

// SHARED (Lk % 128 == 0, Lq % 64 == 0): both consumers' keys lie in one
// window and read one Q / dO slot a stage.  Per item: K / V of both
// consumers in one buffer (KB); stages [ST][Q | dO][atom][slot], and each
// stage's lse and Di [ST][slot][lse | Di][64] f32, loaded by TMA from the
// dQ kernel's transposed copy.  One K / V buffer and four stages at D 72
// measured faster than two and two at stage 3 and the global blocks (an
// item walks 4-16 query tiles; PERF.md).
template <int DV, bool SHARED>
struct KvCfg {
  static constexpr int NA = (DV + 63) / 64, KS = (DV + 15) / 16;
  static constexpr int SLOTS = SHARED ? 1 : 2;
  static constexpr uint32_t kKV = 2 * 2 * NA * AB_BOX;        // K, V of both consumers
  static constexpr uint32_t kSt = 2 * SLOTS * NA * AB_BOX;    // Q, dO of a stage
  static constexpr uint32_t kRows = SLOTS * 2 * AB_ROWS * 4;  // lse, Di of a stage
  static constexpr int KB = 1;
  static constexpr int ST_FIT = (int)((AB_SMEM - KB * (kKV + 16) - 1024) / (kSt + kRows + 16));
  static constexpr int ST = ST_FIT > 8 ? 8 : ST_FIT;
  static constexpr int kBytes = KB * (kKV + 16) + ST * (kSt + kRows + 16) + 1024;
  static_assert(ST >= 1 && kBytes <= 232448, "shared memory");
};

template <int DV, bool SHARED>
__global__ void __launch_bounds__(AB_THREADS, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdd, bf16* __restrict__ dk, long lddk,
                     bf16* __restrict__ dv, long lddv, int q_rows, int k_rows, int heads, int D,
                     int lq, int lk, int items, int mask, float scale) {
  using C = KvCfg<DV, SHARED>;
  constexpr int NA = C::NA, ST = C::ST, KB = C::KB, SLOTS = C::SLOTS;
  constexpr uint32_t kAtom = SLOTS * AB_BOX;  // atom stride of Q / dO in a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* kvs = base;
  unsigned char* sts = base + KB * C::kKV;
  float* rows = reinterpret_cast<float*>(sts + ST * C::kSt);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + ST * SLOTS * 2 * AB_ROWS);
  uint64_t* empty = full + ST;
  uint64_t* kvfull = empty + ST;
  uint64_t* kvempty = kvfull + KB;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int b = 0; b < KB; ++b) {
      mbar_init(&kvfull[b], 1);
      mbar_init(&kvempty[b], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<KV_PREGS>();
    if (tid != 0) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const KvWork w0 = kv_decode(item, 0, k_rows, heads, lq, lk);
      const KvWork w1 = kv_decode(item, 1, k_rows, heads, lq, lk);
      const int nq = max(w0.nq, w1.nq);
      const int b = n % KB;
      if (n >= KB) mbar_wait(&kvempty[b], ((n / KB) - 1) & 1);
      mbar_arrive_expect_tx(&kvfull[b], C::kKV);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const KvWork& w = c ? w1 : w0;
        unsigned char* kb = kvs + b * C::kKV + c * 2 * NA * AB_BOX;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_3d(kb + a * AB_BOX, &tk, &kvfull[b], 64 * a, w.head, w.kr);
          tma_load_3d(kb + (NA + a) * AB_BOX, &tv, &kvfull[b], 64 * a, w.head, w.kr);
        }
      }
      for (int jq = 0; jq < nq; ++jq, ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        unsigned char* st = sts + s * C::kSt;
        mbar_arrive_expect_tx(&full[s], C::kSt + C::kRows);
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          const KvWork& w = sl ? w1 : w0;
          const int row = w.qb + jq * AB_ROWS;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const uint32_t off = (a * SLOTS + sl) * AB_BOX;
            tma_load_3d(st + off, &tq, &full[s], 64 * a, w.head, row);
            tma_load_3d(st + NA * kAtom + off, &tdo, &full[s], 64 * a, w.head, row);
          }
          float* ls = rows + (s * SLOTS + sl) * 2 * AB_ROWS;
          tma_load_2d(ls, &tdd, &full[s], row, w.head);
          tma_load_2d(ls + AB_ROWS, &tdd, &full[s], row, heads + w.head);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<KV_CREGS>();
  const int c = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = scale * AB_LOG2E;
  const uint32_t slot = SHARED ? 0 : c * AB_BOX;  // this consumer's queries in a stage
  const int slot_i = SHARED ? 0 : c;
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const KvWork wk = kv_decode(item, c, k_rows, heads, lq, lk);
    const int nq = max(wk.nq, kv_decode(item, 1 - c, k_rows, heads, lq, lk).nq);
    const int lo0 = (wk.kr + 16 * w + g) / lk * lq - wk.qb;
    const int lo1 = (wk.kr + 16 * w + g + 8) / lk * lq - wk.qb;
    const int b = n % KB;
    const unsigned char* ks = kvs + b * C::kKV + c * 2 * NA * AB_BOX;
    const unsigned char* vs = ks + NA * AB_BOX;
    float st[32], dpt[32], dka[DV / 2], dva[DV / 2];
    uint32_t pf[4][4], df[4][4];
    zero_acc(dka);
    zero_acc(dva);
    mbar_wait(&kvfull[b], (n / KB) & 1);

    auto issue_sdp = [&](int s) {
      const unsigned char* qs = sts + s * C::kSt + slot;
      const unsigned char* dos = qs + NA * kAtom;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        const uint32_t a = (kk / 4) * AB_BOX + (kk % 4) * 32;
        const uint32_t bq = (kk / 4) * kAtom + (kk % 4) * 32;
        WgmmaSS<64>::run(st, wgmma_desc_sw128(ks + a), wgmma_desc_sw128(qs + bq), kk > 0);
        WgmmaSS<64>::run(dpt, wgmma_desc_sw128(vs + a), wgmma_desc_sw128(dos + bq), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_dvdk = [&](int s) {
      const unsigned char* qs = sts + s * C::kSt + slot;
      const unsigned char* dos = qs + NA * kAtom;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        WgmmaRS<DV>::run(dva, pf[kk], wgmma_desc_sw128_mn(dos + kk * 2048, kAtom));
        WgmmaRS<DV>::run(dka, df[kk], wgmma_desc_sw128_mn(qs + kk * 2048, kAtom));
      }
      wgmma_commit();
    };
    // P^T and dS^T of query tile jq (stage s) in place.
    auto grads = [&](int jq, int s) {
      const float* ls = rows + (s * SLOTS + slot_i) * 2 * AB_ROWS;
      const float* di = ls + AB_ROWS;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + (e & 1);
          const int rel = jq * AB_ROWS + col - ((e & 2) ? lo1 : lo0);
          const bool in = SHARED || !mask || (unsigned)rel < (unsigned)lq;  // shared: no mask
          const float p = in ? fast_exp2(fmaf(st[4 * jj + e], sl2, -ls[col])) : 0.f;
          dpt[4 * jj + e] = in ? p * (dpt[4 * jj + e] - di[col]) * scale : 0.f;
          st[4 * jj + e] = p;
          // with the mask, lse and Di of half the columns at a time: hoisting
          // all 32 loads above the math would cost the registers of a spill
          if (!SHARED && jj == 3 && e == 3) asm volatile("" ::: "memory");
        }
    };

    if constexpr (ST >= 2) {
      int sp = it % ST;  // stage of the previous query tile
      mbar_wait(&full[sp], (it / ST) & 1);
      issue_sdp(sp);
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      grads(0, sp);
      pack_frags(pf, st);
      pack_frags(df, dpt);
      for (int jq = 1; jq < nq; ++jq) {
        ++it;
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        issue_sdp(s);
        issue_dvdk(sp);
        wgmma_wait<1>();
        fence_acc(st);
        fence_acc(dpt);
        grads(jq, s);
        wgmma_wait<0>();
        fence_acc(dka);
        fence_acc(dva);
        fence_frag(pf);
        fence_frag(df);
        mbar_arrive(&empty[sp]);
        pack_frags(pf, st);
        pack_frags(df, dpt);
        sp = s;
      }
      issue_dvdk(sp);
      wgmma_wait<0>();
      fence_acc(dka);
      fence_acc(dva);
      fence_frag(pf);
      fence_frag(df);
      mbar_arrive(&empty[sp]);
      ++it;
    } else {  // one stage: each tile's products in turn
      for (int jq = 0; jq < nq; ++jq, ++it) {
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        issue_sdp(s);
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);
        grads(jq, s);
        pack_frags(pf, st);
        pack_frags(df, dpt);
        issue_dvdk(s);
        wgmma_wait<0>();
        fence_acc(dka);
        fence_acc(dva);
        fence_frag(pf);
        fence_frag(df);
        mbar_arrive(&empty[s]);
      }
    }
    mbar_arrive(&kvempty[b]);
    if (wk.active) {
      const long hc = (long)wk.head * D;
      store_rows<DV>(dk + hc, lddk, wk.kr, k_rows, D, dka, w, g, t);
      store_rows<DV>(dv + hc, lddv, wk.kr, k_rows, D, dva, w, g, t);
    }
  }
}

// ---------------------------------------------------------------------------
// Split route, kernel 1: dQ (and Di).
// ---------------------------------------------------------------------------

// What consumer c computes of one item, as attention_window.cu's
// win_decode with one m-tile: query rows [row0, row0 + 64) of head `head`
// against `ntiles` 64-key tiles from key row kb.
struct QWork {
  int head, row0, kb, ntiles;
  bool active;
};

__device__ __forceinline__ QWork q_decode(int item, int c, int q_rows, int heads, int lq,
                                          int lk, bool shared) {
  QWork w;
  if (shared) {  // item = (window * heads + head) * chunks + chunk, 128 rows a chunk
    const int chunks = lq / (2 * AB_ROWS);
    const int wh = item / chunks, win = wh / heads;
    w.head = wh % heads;
    w.row0 = win * lq + (item % chunks) * 2 * AB_ROWS + c * AB_ROWS;
    w.kb = win * lk;
    w.ntiles = lk / AB_ROWS;
    w.active = true;
  } else {  // item = pair * heads + head; consumer c takes m-tile 2 pair + c
    w.head = item % heads;
    w.row0 = (2 * (item / heads) + c) * AB_ROWS;
    w.active = w.row0 < q_rows;
    const int last = min(w.row0 + AB_ROWS, q_rows) - 1;
    w.kb = (w.row0 / lq) * lk;
    w.ntiles = w.active ? ((last / lq + 1) * lk - w.kb + AB_ROWS - 1) / AB_ROWS : 0;
  }
  return w;
}

// Q and dO of an item: [QB][consumer][Q | dO][atom], with the item's 128
// rows' lse and Di [QB][lse | Di][128] f32 (the stagers'); K / V stages
// [ST][K | V][atom][slot] (one slot, read by both consumers, where SHARED);
// the stagers' partial sums.  One Q buffer and four stages at D 72, as the
// dK / dV kernel.
template <int DV, bool SHARED>
struct QCfg {
  static constexpr int NA = (DV + 63) / 64, KS = (DV + 15) / 16;
  static constexpr int SLOTS = SHARED ? 1 : 2;
  static constexpr uint32_t kQ = 2 * 2 * NA * AB_BOX;
  static constexpr uint32_t kRows = 2 * 2 * AB_ROWS * 4;
  static constexpr uint32_t kPart = 2 * AB_ROWS * 16 * 4;
  static constexpr uint32_t kKV = NA * SLOTS * AB_BOX;  // K or V of a stage
  static constexpr uint32_t kFixed = kPart + 1024;
  static constexpr int QB = 1;
  static constexpr int ST_FIT =
      (int)((AB_SMEM - QB * (kQ + kRows + 24) - kFixed) / (2 * kKV + 16));
  static constexpr int ST = ST_FIT > 8 ? 8 : ST_FIT;
  static constexpr int kBytes = QB * (kQ + kRows + 24) + ST * (2 * kKV + 16) + kFixed;
  static_assert(ST >= 1 && kBytes <= 232448, "shared memory");
};

template <int DV, bool SHARED, bool MASK>
__global__ void __launch_bounds__(AB_THREADS, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const bf16* __restrict__ o, long ldo, const float* __restrict__ lse,
                   float* __restrict__ dd, bf16* __restrict__ dq, long lddq, int q_rows,
                   int heads, int D, int lq, int lk, int items, float scale) {
  static_assert(!(SHARED && MASK), "shared items never mask");
  using C = QCfg<DV, SHARED>;
  constexpr int NA = C::NA, ST = C::ST, QB = C::QB, SLOTS = C::SLOTS;
  constexpr uint32_t kAtom = SLOTS * AB_BOX;  // atom stride of K / V in a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;
  unsigned char* kvs = base + QB * C::kQ;
  float* part = reinterpret_cast<float*>(kvs + ST * 2 * C::kKV);
  float* rows = part + 2 * AB_ROWS * 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + QB * 4 * AB_ROWS);
  uint64_t* empty = full + ST;
  uint64_t* qtma = empty + ST;  // the item's Q and dO landed
  uint64_t* qfull = qtma + QB;  // ... and its rows' lse and Di staged
  uint64_t* qempty = qfull + QB;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    for (int b = 0; b < QB; ++b) {
      mbar_init(&qtma[b], 1);
      mbar_init(&qfull[b], AB_STAGERS);
      mbar_init(&qempty[b], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<DQ_PREGS>();
    if (tid >= 32) {  // stagers: lse and Di of each item's 128 query rows
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const QWork w0 = q_decode(item, 0, q_rows, heads, lq, lk, SHARED);
        const int b = n % QB;
        if (n >= QB) mbar_wait(&qempty[b], ((n / QB) - 1) & 1);
        float* ls = rows + b * 4 * AB_ROWS;
        const DoTile dot{qs + b * C::kQ + NA * AB_BOX, AB_BOX, 2 * NA * AB_BOX, &qtma[b],
                         (n / QB) & 1};
        stage_di<8>(ls, ls + 2 * AB_ROWS, dd + (long)w0.head * q_rows + w0.row0,
                 dd + (long)(heads + w0.head) * q_rows + w0.row0, part, 2 * AB_ROWS, w0.row0,
                 q_rows, w0.head, heads, D, o, ldo, dot, lse, tid - 32);
        mbar_arrive(&qfull[b]);
      }
      return;
    }
    if (tid != 0) return;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const QWork w0 = q_decode(item, 0, q_rows, heads, lq, lk, SHARED);
      const QWork w1 = q_decode(item, 1, q_rows, heads, lq, lk, SHARED);
      const int nt = max(w0.ntiles, w1.ntiles);
      const int b = n % QB;
      if (n >= QB) mbar_wait(&qempty[b], ((n / QB) - 1) & 1);
      mbar_arrive_expect_tx(&qtma[b], C::kQ);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const QWork& w = c ? w1 : w0;
        unsigned char* qb = qs + b * C::kQ + c * 2 * NA * AB_BOX;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_3d(qb + a * AB_BOX, &tq, &qtma[b], 64 * a, w.head, w.row0);
          tma_load_3d(qb + (NA + a) * AB_BOX, &tdo, &qtma[b], 64 * a, w.head, w.row0);
        }
      }
      for (int j = 0; j < nt; ++j, ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
        unsigned char* ks = kvs + s * 2 * C::kKV;
        mbar_arrive_expect_tx(&full[s], 2 * C::kKV);
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl) {
          const QWork& w = sl ? w1 : w0;
          const int row = w.kb + j * AB_ROWS;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const uint32_t off = (a * SLOTS + sl) * AB_BOX;
            tma_load_3d(ks + off, &tk, &full[s], 64 * a, w.head, row);
            tma_load_3d(ks + C::kKV + off, &tv, &full[s], 64 * a, w.head, row);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<DQ_CREGS>();
  const int c = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = scale * AB_LOG2E;
  const uint32_t slot = SHARED ? 0 : c * AB_BOX;  // this consumer's keys in a stage
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const QWork wk = q_decode(item, c, q_rows, heads, lq, lk, SHARED);
    const int nt = SHARED ? wk.ntiles
                          : max(wk.ntiles, q_decode(item, 1 - c, q_rows, heads, lq, lk,
                                                    SHARED).ntiles);
    const int r0 = wk.row0 + 16 * w + g, r1 = r0 + 8;
    const long hc = (long)wk.head * D;
    // The first key (relative to kb) of this thread's rows' windows.
    const int lo0 = (r0 / lq) * lk - wk.kb, lo1 = (r1 / lq) * lk - wk.kb;
    const int b = n % QB;
    const unsigned char* qa = qs + b * C::kQ + c * 2 * NA * AB_BOX;
    const unsigned char* oa = qa + NA * AB_BOX;
    float sc[32], dps[32], dqa[DV / 2];
    uint32_t df[4][4];
    zero_acc(dqa);
    mbar_wait(&qfull[b], (n / QB) & 1);
    // This thread's rows' lse and Di, from the stagers.
    const float* ls = rows + b * 4 * AB_ROWS + c * AB_ROWS + 16 * w + g;
    const float l0 = ls[0], l1 = ls[8], d0 = ls[2 * AB_ROWS], d1 = ls[2 * AB_ROWS + 8];

    auto issue_sdp = [&](int s) {
      const unsigned char* ks = kvs + s * 2 * C::kKV + slot;
      const unsigned char* vs = ks + C::kKV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        const uint32_t a = (kk / 4) * AB_BOX + (kk % 4) * 32;
        const uint32_t bk = (kk / 4) * kAtom + (kk % 4) * 32;
        WgmmaSS<64>::run(sc, wgmma_desc_sw128(qa + a), wgmma_desc_sw128(ks + bk), kk > 0);
        WgmmaSS<64>::run(dps, wgmma_desc_sw128(oa + a), wgmma_desc_sw128(vs + bk), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_dq = [&](int s) {
      const unsigned char* ks = kvs + s * 2 * C::kKV + slot;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<DV>::run(dqa, df[kk], wgmma_desc_sw128_mn(ks + kk * 2048, kAtom));
      wgmma_commit();
    };
    // dS of key tile j in place (in dps).
    auto grads = [&](int j) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + (e & 1);
          const int rel = j * AB_ROWS + col - ((e & 2) ? lo1 : lo0);
          const bool in = !MASK || (unsigned)rel < (unsigned)lk;
          const float l = (e & 2) ? l1 : l0, d = (e & 2) ? d1 : d0;
          const float p = in ? fast_exp2(fmaf(sc[4 * jj + e], sl2, -l)) : 0.f;
          dps[4 * jj + e] = in ? p * (dps[4 * jj + e] - d) * scale : 0.f;
        }
    };

    if constexpr (ST >= 2) {
      int sp = it % ST;
      mbar_wait(&full[sp], (it / ST) & 1);
      issue_sdp(sp);
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dps);
      if (nt == 1) mbar_arrive(&qempty[b]);  // Q and dO read for the last time
      grads(0);
      pack_frags(df, dps);
      for (int j = 1; j < nt; ++j) {
        ++it;
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        issue_sdp(s);
        issue_dq(sp);
        wgmma_wait<1>();
        fence_acc(sc);
        fence_acc(dps);
        if (j == nt - 1) mbar_arrive(&qempty[b]);
        grads(j);
        wgmma_wait<0>();
        fence_acc(dqa);
        fence_frag(df);
        mbar_arrive(&empty[sp]);
        pack_frags(df, dps);
        sp = s;
      }
      issue_dq(sp);
      wgmma_wait<0>();
      fence_acc(dqa);
      fence_frag(df);
      mbar_arrive(&empty[sp]);
      ++it;
    } else {
      for (int j = 0; j < nt; ++j, ++it) {
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        issue_sdp(s);
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dps);
        if (j == nt - 1) mbar_arrive(&qempty[b]);
        grads(j);
        pack_frags(df, dps);
        issue_dq(s);
        wgmma_wait<0>();
        fence_acc(dqa);
        fence_frag(df);
        mbar_arrive(&empty[s]);
      }
    }
    if (wk.active) store_rows<DV>(dq + hc, lddq, wk.row0, q_rows, D, dqa, w, g, t);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// The tensor maps of one call, through a cache of the last 32 encodings of
// this host thread: a training step hands the launcher the same (pointer,
// shape) pairs again and again, and encoding is host time.  A map depends
// on nothing but its key.
//
// bf16 (f32 == 0): heads x D columns of a row-major matrix as (D, heads,
// rows), byte strides 2 D and 2 ld (multiples of 16), boxes of 64 x 1 x
// box_rows, 128-byte swizzle, zeros past column D and the last row
// (kernels.window_bwd_tmap mirrors it).  f32 (f32 == 1): the dQ kernel's
// transposed lse and Di, [2 heads][rows] (ld = rows), as (rows, 2 heads),
// boxes of 64 x 1, no swizzle, zeros past the last row.
cudaError_t bwd_tmap(CUtensorMap* map, const void* ptr, int D, int heads, int rows, long ld,
                     int box_rows, int f32) {
  struct Key {
    const void* ptr;
    long ld;
    int D, heads, rows, box_rows, f32;
  };
  constexpr int N = 32;
  thread_local Key keys[N] = {};
  thread_local CUtensorMap maps[N];
  thread_local int next = 0;
  for (int i = 0; i < N; ++i) {
    const Key& k = keys[i];
    if (k.ptr == ptr && k.ld == ld && k.D == D && k.heads == heads && k.rows == rows &&
        k.box_rows == box_rows && k.f32 == f32) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
  CUresult r;
  if (f32) {
    const cuuint64_t dims[2] = {(cuuint64_t)rows, (cuuint64_t)(2 * heads)};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
    const cuuint32_t box[2] = {(cuuint32_t)AB_ROWS, 1};
    const cuuint32_t estr[2] = {1, 1};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
               box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)ld * 2};
    const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
    const cuuint32_t estr[3] = {1, 1, 1};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
               box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = Key{ptr, ld, D, heads, rows, box_rows, f32};
  maps[next] = *map;
  next = (next + 1) % N;
  return cudaSuccess;
}

// The dynamic shared-memory attribute of a kernel, set once per
// instantiation (host time on every call otherwise).
template <typename K>
cudaError_t smem_attr(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

struct BwdArgs {
  const bf16 *o, *dout;
  long ldo, lddo, lddq, lddk, lddv;
  const float* lse;
  float* dd;
  bf16 *dq, *dk, *dv;
  int q_rows, k_rows, heads, D, lq, lk, mask;
  float scale;
  cudaStream_t st;
};

template <int DV, int QT, bool MASK>
cudaError_t launch_packed(const CUtensorMap* m, const BwdArgs& a, int units, int grid) {
  static bool attr = false;
  const cudaError_t e =
      smem_attr(attn_bwd_packed_kernel<DV, QT, MASK>, PkCfg<DV, QT>::kBytes, attr);
  if (e != cudaSuccess) return e;
  attn_bwd_packed_kernel<DV, QT, MASK><<<grid, AB_THREADS, PkCfg<DV, QT>::kBytes, a.st>>>(
      m[0], m[1], m[2], m[3], a.o, a.ldo, a.lse, a.dq, a.lddq, a.dk, a.lddk,
      a.dv, a.lddv, a.q_rows, a.k_rows, a.heads, a.D, a.lq, a.lk, units, a.scale);
  return cudaGetLastError();
}

template <int DV, bool SQ, bool SKV, bool QMASK>
cudaError_t launch_split(const CUtensorMap* m, const BwdArgs& a, int items_q, int grid_q,
                         int items_kv, int grid_kv) {
  static bool attr_q = false, attr_kv = false;
  cudaError_t e = smem_attr(attn_bwd_dq_kernel<DV, SQ, QMASK>, QCfg<DV, SQ>::kBytes, attr_q);
  if (e == cudaSuccess) e = smem_attr(attn_bwd_dkdv_kernel<DV, SKV>, KvCfg<DV, SKV>::kBytes, attr_kv);
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<DV, SQ, QMASK><<<grid_q, AB_THREADS, QCfg<DV, SQ>::kBytes, a.st>>>(
      m[0], m[1], m[2], m[3], a.o, a.ldo, a.lse, a.dd, a.dq, a.lddq, a.q_rows,
      a.heads, a.D, a.lq, a.lk, items_q, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<DV, SKV><<<grid_kv, AB_THREADS, KvCfg<DV, SKV>::kBytes, a.st>>>(
      m[0], m[1], m[2], m[3], m[4], a.dk, a.lddk, a.dv, a.lddv, a.q_rows, a.k_rows, a.heads,
      a.D, a.lq, a.lk, items_kv, a.mask, a.scale);
  return cudaGetLastError();
}

// The launch behind sp_attention_bwd.  `plan` from kernels.window_bwd_plan,
// one 64-bit word: mode | grid_a << 16 | grid_b << 32, mode = dv | packed
// << 9 | (qt == 16) << 10 | mask << 11 | shared_kv << 12 | shared_q << 13;
// grid_a the blocks of the packed kernel or of the dK / dV kernel, grid_b
// the dQ kernel's.  The work-item counts follow from the shapes.
int run_attention_bwd(const void* q, long ldq, const void* k, long ldk, const void* v, long ldv,
                      const BwdArgs& a, long long plan) {
  const int mode = (int)(plan & 0xffff), grid_a = (int)((plan >> 16) & 0xffff);
  const int grid_b = (int)((plan >> 32) & 0xffff);
  const int dv = mode & 511, packed = (mode >> 9) & 1, qt = (mode >> 10) & 1 ? 16 : 64;
  const int skv = (mode >> 12) & 1, sq = (mode >> 13) & 1;
  const int D = a.D, lq = a.lq, lk = a.lk, heads = a.heads;
  const bool split = !packed;
  if (D % 8 || D > dv || dv > 128 || lq < 1 || lk < 16 || lk % 16 || a.q_rows < 1 ||
      a.q_rows % lq || heads < 1 || grid_a < 1 || a.mask != ((mode >> 11) & 1) ||
      (mode >> 14) ||
      (packed && (AB_ROWS % lk || AB_ROWS / lk * lq != qt || a.mask != (lk < AB_ROWS))) ||
      (split && (grid_b < 1 || !a.dd || a.q_rows % 4 ||
                 (skv && (lk % 128 || lq % AB_ROWS || a.mask)) ||
                 (sq && (lq % 128 || lk % AB_ROWS || a.mask)))))
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (a.k_rows + AB_ROWS - 1) / AB_ROWS;
  CUtensorMap m[5];
  const int box_q = packed ? qt : AB_ROWS;
  cudaError_t e = bwd_tmap(&m[0], q, D, heads, a.q_rows, ldq, box_q, 0);
  if (e == cudaSuccess) e = bwd_tmap(&m[1], k, D, heads, a.k_rows, ldk, AB_ROWS, 0);
  if (e == cudaSuccess) e = bwd_tmap(&m[2], v, D, heads, a.k_rows, ldv, AB_ROWS, 0);
  if (e == cudaSuccess) e = bwd_tmap(&m[3], a.dout, D, heads, a.q_rows, a.lddo, box_q, 0);
  if (e == cudaSuccess && split)
    e = bwd_tmap(&m[4], a.dd, 0, heads, a.q_rows, a.q_rows, AB_ROWS, 1);
  if (e != cudaSuccess) return (int)e;
  const int units = k_tiles * heads;
  const int items_kv = heads * ((k_tiles + 1) / 2);
  const int q_tiles = (a.q_rows + AB_ROWS - 1) / AB_ROWS;
  const int items_q = sq ? a.q_rows / lq * heads * (lq / 128) : heads * ((q_tiles + 1) / 2);
#define SPK_AB_SPLIT_ARGS m, a, items_q, grid_b, items_kv, grid_a
#define SPK_AB_PACKED_ARGS m, a, units, grid_a
#define SPK_AB_CASE(DVV)                                                                   \
  case DVV:                                                                                \
    if (packed)                                                                            \
      return (int)(qt == 16 ? (a.mask ? launch_packed<DVV, 16, true>(SPK_AB_PACKED_ARGS)   \
                                      : launch_packed<DVV, 16, false>(SPK_AB_PACKED_ARGS)) \
                   : a.mask ? launch_packed<DVV, 64, true>(SPK_AB_PACKED_ARGS)             \
                            : launch_packed<DVV, 64, false>(SPK_AB_PACKED_ARGS));          \
    return (int)(sq       ? (skv ? launch_split<DVV, true, true, false>(SPK_AB_SPLIT_ARGS)  \
                                 : launch_split<DVV, true, false, false>(SPK_AB_SPLIT_ARGS)) \
                 : skv    ? launch_split<DVV, false, true, false>(SPK_AB_SPLIT_ARGS)       \
                 : a.mask ? launch_split<DVV, false, false, true>(SPK_AB_SPLIT_ARGS)       \
                          : launch_split<DVV, false, false, false>(SPK_AB_SPLIT_ARGS));
  switch (dv) {
    SPK_AB_CASE(16)
    SPK_AB_CASE(32)
    SPK_AB_CASE(48)
    SPK_AB_CASE(64)
    SPK_AB_CASE(72)
    SPK_AB_CASE(80)
    SPK_AB_CASE(96)
    SPK_AB_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_AB_CASE
#undef SPK_AB_SPLIT_ARGS
#undef SPK_AB_PACKED_ARGS
}

}  // namespace
}  // namespace spk

extern "C" {

// Attention backward for query windows of Lq rows against key windows of Lk
// rows (Lk % 16 == 0).  q / k / v / o / dout / dq / dk / dv point at head
// 0's column of their buffers (row strides ld*, 16-byte aligned, multiples
// of 8); heads * D columns follow.  lse [q_rows, heads] f32 from the
// forward (log2 units); dd [2 heads, q_rows] f32 scratch (the split route
// only, else null): the dQ kernel's lse and Di by head, transposed, for the
// dK / dV kernel's TMA loads.  `plan` from kernels.window_bwd_plan.
int sp_attention_bwd(const void* q, long ldq, const void* k, long ldk, const void* v, long ldv,
                     const void* o, long ldo, const void* dout, long lddo, const void* lse,
                     void* dd, void* dq, long lddq, void* dk, long lddk, void* dv, long lddv,
                     int q_rows, int heads, int D, int Lq, int Lk, long long plan, float scale,
                     void* stream) {
  using spk::bf16;
  if (Lq < 1 || q_rows % Lq) return (int)cudaErrorInvalidValue;
  const int mode = (int)(plan & 0xffff);
  spk::BwdArgs a{(const bf16*)o, (const bf16*)dout, ldo, lddo, lddq, lddk, lddv,
                 (const float*)lse, (float*)dd, (bf16*)dq, (bf16*)dk, (bf16*)dv,
                 q_rows, q_rows / Lq * Lk, heads, D, Lq, Lk, (mode >> 11) & 1, scale,
                 (cudaStream_t)stream};
  return spk::run_attention_bwd(q, ldq, k, ldk, v, ldv, a, plan);
}

}  // extern "C"
