// f32 self-attention over independent problems of L tokens, any L, on Hopper.
//
// The f32 form of attention_lanes.cu, for Hiera's f32 compute (`use_amp:
// false`).  Per (problem, head), softmax(q k^T * scale) v with f32 operands,
// f32 scores and an f32 online softmax, the row sums taken from the
// unrounded probabilities and the output normalised after P.V, as the TPU
// kernels compute at dt = f32.  It replaces spegnet_tpu/ops/pallas_attention.py
// `_lanes_kernel` (:199) and `_lanes_qblock_kernel` (:220) of
// `fused_attention_lanes` (#9), and `_attn_kernel` (:43) and `_qblock_kernel`
// (:68) of `fused_attention` (#8), and it is the window attention of the f32
// gen-1 chain (spegnet_tpu/ops/fused_block.py `_kernel` :99, #7, and the int8
// gen-1 block spegnet_tpu/ops/fused_block_i8.py `_kernel_i8` :128, #12): each
// window of L 16 or 64 consecutive rows of the block's qkv is one problem.
//
// Operands are strided views [problems, L, heads, D] with D contiguous (the
// packed token-major qkv of an nn.Linear, or separate tensors), element
// strides multiples of 4 (16 bytes), D a multiple of 4 up to 256 (the
// launcher, kernels.attention, zero-pads any other head dim to one); the
// output is a contiguous [problems, L, heads, D].
//
// What bounds it on the H100: 4 L^2 D FLOPs per (problem, head) against 16 L
// D bytes (q, k, v read once, o written once): operations above L ~ 200 at
// 165 TFLOP/s (3xTF32, a third of the dense 495 TF32 rate, the card's
// fastest f32-accurate product), bytes below it (the gen-1 windows of 16 and
// 64).  Two kernels:
//
// attention_tf32_kernel (head dims up to 80, Hiera's 72 among them): the
// bf16 kernel's frame (TMA, warp specialisation, persistent grid) with both
// products 3xTF32 on wgmma (m64nNk8 .tf32: big*big + big*small + small*big,
// v = big + small with big = v rounded to tf32 and small = the rest rounded
// to tf32, common.cuh `split_tf32`).  Each operand is split once, not per
// fragment and warp:
// * Q once per work item, by the consumer that owns the rows, straight into
//   registers as wgmma A fragments (big and small: 2 * D registers), so the
//   Q box is free again at the item's start and S = Q K^T reads only K from
//   shared memory;
// * each K / V tile once, after its TMA lands, by the producer warpgroup's
//   warps 1-3: K's tf32 big part in place of the f32 tile and its small part
//   beside it (K-major, the swizzled layout TMA wrote), V transposed into
//   [D, keys] big and small parts, keys contiguous (tf32 wgmma reads its
//   shared-memory operands K-major only), with the keys of each 8 permuted so
//   that the score fragment of keys 2t, 2t+1 (S accumulator, row g) is P's A
//   fragment of columns t, t+4 (P needs no shuffle);
// * P in registers, split as it is rounded from the softmax.
// The tensor cores' own accumulation truncates (common.cuh `mma_3xtf32`), so
// no sum runs long in them: S is fresh per 32-key tile (contraction <= 80),
// and each tile's P.V goes to a fresh accumulator that is added to O on the
// FP32 pipe in the online softmax's O * alpha rescale.
// One producer thread issues every TMA load (4-D tensor maps over the
// strided views, boxes of 32 f32 columns with the 128-byte swizzle,
// zero-filled past D, L and the last problem); two consumer warpgroups own 64
// query rows each and share every K / V tile (so a tile feeds 128 rows), with
// the key tiles run last (partial) tile first.  At L <= 64 each consumer
// takes its own (problem, head) over its own K / V tiles, and windows of L
// dividing 32 (Hiera's stage-2 windows of 16) are packed 64 / L to an m-tile
// under a block-diagonal mask, so an m-tile is not three quarters empty.
// Shared memory decides the tiles: 32-key tiles (K big / small, V raw, V^T
// big / small: 54 KB at D 72) in as many stages as fit beside the two Q
// boxes (three at D 72).  The launcher plans the work list
// (kernels.attention_f32_plan); tests/test_torch_attention_tiles.py emulates
// the whole dataflow on the CPU, bit for bit in the splits.
//
// attention_f32_kernel (head dims above 80, where 2 * D Q registers do not
// fit beside the accumulators): 3xTF32 on mma.sync.m16n8k8, a block of 4
// warps per 64 query rows, keys double-buffered with cp.async; every operand
// split per fragment.
#include "wgmma_attn.cuh"

namespace spk {
namespace {

constexpr int TF_ROWS = 64;       // query rows of an m-tile, a Q box
constexpr int TF_KT = 32;         // keys of a K / V tile
constexpr int TF_THREADS = 384;   // producer + two consumer warpgroups
constexpr int TF_SPLIT = 96;      // producer warps 1-3: the split pass
constexpr int TF_PRODUCER_REGS = 72, TF_CONSUMER_REGS = 216;
constexpr int TF_SMEM = 225 * 1024;
constexpr uint32_t TF_QATOM = TF_ROWS * 128;   // 64 rows x 32 f32 columns
constexpr uint32_t TF_KATOM = TF_KT * 128;     // 32 rows x 32 f32 columns

// DV: the head dim rounded up to an instantiated wgmma N (the P.V width;
// Q K^T contracts over DV too, its columns past D zero).  Shared memory: the
// two consumers' Q boxes [consumer][atom], then stages of [K big | K small |
// V raw | V^T big | V^T small], each part 1024-byte aligned.
template <int DV>
struct TfCfg {
  static constexpr int NA = (DV + 31) / 32;   // 32-column atoms of a row
  static constexpr int KS = DV / 8;           // k8 steps of Q K^T
  static constexpr uint32_t kQ = 2 * NA * TF_QATOM;
  static constexpr uint32_t kK = NA * TF_KATOM;  // K big, K small or V raw
  static constexpr uint32_t kVT = DV * 128;      // V^T big or small: DV rows of 32 keys
  static constexpr uint32_t kStage = 3 * kK + 2 * kVT;
  static constexpr int ST_FIT = (TF_SMEM - (int)kQ) / (int)kStage;
  static constexpr int ST = ST_FIT > 6 ? 6 : ST_FIT;
  static constexpr int kBytes = kQ + ST * kStage + (3 * ST + 2) * 8 + 1024;
  static_assert(DV % 8 == 0 && ST >= 2 && kBytes <= 232448, "shared memory");
};

// (problem, head, first row) of the rows a consumer computes for an item;
// tests/test_torch_attention_tiles.py mirrors it.  solo (L <= 64): group i
// = 2 * item + c of pb problems (pb = 64 / L when L divides 32, else 1) and
// one head; else 128 query rows of one (problem, head), 64 per consumer.
struct TfWork {
  int prob, head, row0;
  bool active;
};

__device__ __forceinline__ TfWork tf_decode(int item, int c, int problems, int heads, int L,
                                            bool solo, int pb) {
  TfWork w;
  if (solo) {
    const int i = 2 * item + c, groups = (problems + pb - 1) / pb;
    w.active = i < groups * heads;
    w.prob = (i / heads) * pb;
    w.head = i % heads;
    w.row0 = 0;
  } else {
    const int nqt = (L + 2 * TF_ROWS - 1) / (2 * TF_ROWS), ph = item / nqt;
    w.prob = ph / heads;
    w.head = ph % heads;
    w.row0 = (item % nqt) * 2 * TF_ROWS + c * TF_ROWS;
    w.active = w.row0 < L;
  }
  return w;
}

// Byte offset of element (row, col) of a tile of `atom` bytes per 32
// columns, as TMA writes it with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(uint32_t atom, int row, int col) {
  return (col >> 5) * atom + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// lg >= 0: windows of L = 2^lg packed 64 / L to an m-tile (L divides 32).
// No wgmma sits under a data-dependent branch: an idle consumer computes on
// the zeros of its out-of-bound boxes and stores nothing, and the mask is a
// select on every score.
template <int DV>
__global__ void __launch_bounds__(TF_THREADS, 1)
attention_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, float* __restrict__ o, long ob,
                      long ol, long oh, int problems, int heads, int L, int D, int items,
                      int solo_i, int lg, float scale) {
  using C = TfCfg<DV>;
  constexpr int NA = C::NA, KS = C::KS, ST = C::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;
  unsigned char* kvs = base + C::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + ST * C::kStage);
  uint64_t* ready = full + ST;
  uint64_t* empty = ready + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + 1;
  const int tid = threadIdx.x, wg = tid / 128;
  const bool solo = solo_i != 0, packed = lg >= 0;
  const int pb = packed ? 64 >> lg : 1;
  const int nt = packed ? 2 : (L + TF_KT - 1) / TF_KT;  // key tiles of a consumer's item
  const int per_item = solo ? 2 * nt : nt;               // stages of an item

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], TF_SPLIT);
      mbar_init(&empty[s], solo ? 128 : 256);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<TF_PRODUCER_REGS>();
    if (tid == 0) {
      // The loads, in the consumers' order: per item both Q boxes, then the
      // key tiles (solo: consumer 0's and 1's in turn), the last first.
      int it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const TfWork w0 = tf_decode(item, 0, problems, heads, L, solo, pb);
        const TfWork w1 = tf_decode(item, 1, problems, heads, L, solo, pb);
        if (n > 0) mbar_wait(qempty, (n - 1) & 1);
        mbar_arrive_expect_tx(qfull, 2 * NA * TF_QATOM);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const TfWork& w = c ? w1 : w0;
#pragma unroll
          for (int a = 0; a < NA; ++a)
            tma_load_4d(qs + (c * NA + a) * TF_QATOM, &tq, qfull, 32 * a, w.head, w.row0, w.prob);
        }
        for (int x = 0; x < per_item; ++x, ++it) {
          const int s = it % ST, kt = nt - 1 - (solo ? x / 2 : x);
          const TfWork& w = solo && (x & 1) ? w1 : w0;
          if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);
          unsigned char* st = kvs + s * C::kStage;
          mbar_arrive_expect_tx(&full[s], 2 * NA * TF_KATOM);
          const int row = packed ? 0 : kt * TF_KT;
          const int prob = packed ? w.prob + kt * (TF_KT >> lg) : w.prob;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            tma_load_4d(st + a * TF_KATOM, &tk, &full[s], 32 * a, w.head, row, prob);
            tma_load_4d(st + 2 * C::kK + a * TF_KATOM, &tv, &full[s], 32 * a, w.head, row, prob);
          }
        }
      }
    } else if (tid >= 32) {
      // The split pass of every stage, in order.
      const int sid = tid - 32;
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x)
        for (int x = 0; x < per_item; ++x, ++it) {
          const int s = it % ST;
          mbar_wait(&full[s], (it / ST) & 1);
          unsigned char* st = kvs + s * C::kStage;
          // K: 16-byte chunks of the columns Q K^T reads; big in place.
          for (int u = sid; u < NA * TF_KT * 8; u += TF_SPLIT) {
            const int a = u / (TF_KT * 8), r = (u >> 3) % TF_KT, pc = u & 7;
            if (32 * a + 4 * (pc ^ (r & 7)) >= DV) continue;
            const uint32_t off = a * TF_KATOM + r * 128 + pc * 16;
            const float4 v = *reinterpret_cast<const float4*>(st + off);
            uint4 big, small;
            split_tf32(v.x, big.x, small.x);
            split_tf32(v.y, big.y, small.y);
            split_tf32(v.z, big.z, small.z);
            split_tf32(v.w, big.w, small.w);
            *reinterpret_cast<uint4*>(st + off) = big;
            *reinterpret_cast<uint4*>(st + C::kK + off) = small;
          }
          // V [key][d] -> V^T [d][position], position p of each 8 holding
          // key 2p (p < 4) or 2(p - 4) + 1.
          const unsigned char* vr = st + 2 * C::kK;
          for (int u = sid; u < DV * (TF_KT / 8); u += TF_SPLIT) {
            const int kk = u / DV, d = u % DV;
            uint32_t big[8], small[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const float v = *reinterpret_cast<const float*>(vr + swz(TF_KATOM, 8 * kk + k, d));
              const int p = (k & 1) * 4 + (k >> 1);
              split_tf32(v, big[p], small[p]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t off = 3 * C::kK + d * 128 + (((2 * kk + h) ^ (d & 7)) << 4);
              *reinterpret_cast<uint4*>(st + off) =
                  make_uint4(big[4 * h], big[4 * h + 1], big[4 * h + 2], big[4 * h + 3]);
              *reinterpret_cast<uint4*>(st + C::kVT + off) =
                  make_uint4(small[4 * h], small[4 * h + 1], small[4 * h + 2], small[4 * h + 3]);
            }
          }
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
    }
    return;
  }

  // Consumers: per key tile, S = Q K^T (fresh), the online softmax, P split
  // in registers, F = P V (fresh), O = O * alpha + F.
  setmaxnreg_inc<TF_CONSUMER_REGS>();
  const int c = wg - 1, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g, r1 = r0 + 8;  // this thread's rows of the m-tile
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  int it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n, it += per_item) {
    const TfWork wk = tf_decode(item, c, problems, heads, L, solo, pb);
    mbar_wait(qfull, n & 1);
    uint32_t qb[KS][4], qsm[KS][4];
    const unsigned char* qa = qs + c * NA * TF_QATOM;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = *reinterpret_cast<const float*>(
            qa + swz(TF_QATOM, e & 1 ? r1 : r0, 8 * kk + t + (e >> 1) * 4));
        split_tf32(v, qb[kk][e], qsm[kk][e]);
      }
    fence_proxy_async();
    mbar_arrive(qempty);  // Q is in registers: the next item's may load

    float acc[DV / 2];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) acc[e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < nt; ++j) {
      const int my = it + (solo ? 2 * j + c : j);
      const int s = my % ST, kt = nt - 1 - j;
      mbar_wait(&ready[s], (my / ST) & 1);
      const unsigned char* st = kvs + s * C::kStage;
      float sc[16], f[DV / 2];  // fresh per tile: the first wgmma of each ignores them
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaTf32RS<TF_KT>::run(sc, qsm[kk],
                                wgmma_desc_sw128(st + (kk / 4) * TF_KATOM + (kk % 4) * 32),
                                kk > 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaTf32RS<TF_KT>::run(
            sc, qb[kk], wgmma_desc_sw128(st + C::kK + (kk / 4) * TF_KATOM + (kk % 4) * 32), 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaTf32RS<TF_KT>::run(sc, qb[kk],
                                wgmma_desc_sw128(st + (kk / 4) * TF_KATOM + (kk % 4) * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      // Mask (keys past L; packed: keys of another window), row maxima.
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kg = kt * TF_KT + 8 * jj + 2 * t + e;
          const bool v0 = packed ? (kg >> lg) == (r0 >> lg) : kg < L;
          const bool v1 = packed ? (kg >> lg) == (r1 >> lg) : kg < L;
          sc[4 * jj + e] = v0 ? sc[4 * jj + e] * sl2 : -INFINITY;
          sc[4 * jj + 2 + e] = v1 ? sc[4 * jj + 2 + e] * sl2 : -INFINITY;
          x0 = fmaxf(x0, sc[4 * jj + e]);
          x1 = fmaxf(x1, sc[4 * jj + 2 + e]);
        }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, o_));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o_));
      }
      // A row whose keys so far are all masked (packed windows, idle rows)
      // keeps m = -inf and subtracts 0: its p and alpha are 0, not NaN.
      const float mn0 = fmaxf(m0, x0), mn1 = fmaxf(m1, x1);
      const float b0 = mn0 == -INFINITY ? 0.f : mn0, b1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = exp2f(m0 - b0), a1 = exp2f(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * jj + e] = exp2f(sc[4 * jj + e] - b0);
          sc[4 * jj + 2 + e] = exp2f(sc[4 * jj + 2 + e] - b1);
          s0 += sc[4 * jj + e];
          s1 += sc[4 * jj + 2 + e];
        }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
      // P's A fragments of k-step kk (keys 8kk..8kk+7): columns t, t + 4 are
      // keys 2t, 2t + 1 (V^T's positions).
      uint32_t pb_[TF_KT / 8][4], ps_[TF_KT / 8][4];
#pragma unroll
      for (int kk = 0; kk < TF_KT / 8; ++kk) {
        split_tf32(sc[4 * kk], pb_[kk][0], ps_[kk][0]);
        split_tf32(sc[4 * kk + 2], pb_[kk][1], ps_[kk][1]);
        split_tf32(sc[4 * kk + 1], pb_[kk][2], ps_[kk][2]);
        split_tf32(sc[4 * kk + 3], pb_[kk][3], ps_[kk][3]);
      }
      const unsigned char* vtb = st + 3 * C::kK;
      const unsigned char* vts = vtb + C::kVT;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TF_KT / 8; ++kk)
        WgmmaTf32RS<DV>::run(f, ps_[kk], wgmma_desc_sw128(vtb + kk * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < TF_KT / 8; ++kk)
        WgmmaTf32RS<DV>::run(f, pb_[kk], wgmma_desc_sw128(vts + kk * 32), 1);
#pragma unroll
      for (int kk = 0; kk < TF_KT / 8; ++kk)
        WgmmaTf32RS<DV>::run(f, pb_[kk], wgmma_desc_sw128(vtb + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(f);
      fence_frag(pb_);
      fence_frag(ps_);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj) {
        acc[4 * jj] = fmaf(acc[4 * jj], a0, f[4 * jj]);
        acc[4 * jj + 1] = fmaf(acc[4 * jj + 1], a0, f[4 * jj + 1]);
        acc[4 * jj + 2] = fmaf(acc[4 * jj + 2], a1, f[4 * jj + 2]);
        acc[4 * jj + 3] = fmaf(acc[4 * jj + 3], a1, f[4 * jj + 3]);
      }
    }

#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    if (!wk.active) continue;
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // (problem, token) of rows r0 / r1: packed, window r >> lg of the group.
    const int p0 = packed ? wk.prob + (r0 >> lg) : wk.prob;
    const int p1 = packed ? wk.prob + (r1 >> lg) : wk.prob;
    const int q0 = packed ? r0 & ((1 << lg) - 1) : wk.row0 + r0;
    const int q1 = packed ? r1 & ((1 << lg) - 1) : wk.row0 + r1;
    const bool ok0 = packed ? p0 < problems : q0 < L, ok1 = packed ? p1 < problems : q1 < L;
    float* d0 = o + p0 * ob + wk.head * oh + (long)q0 * ol;
    float* d1 = o + p1 * ob + wk.head * oh + (long)q1 * ol;
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj) {
      const int col = jj * 8 + 2 * t;
      if (col >= D) continue;
      if (ok0)
        *reinterpret_cast<float2*>(d0 + col) =
            make_float2(acc[4 * jj] * inv0, acc[4 * jj + 1] * inv0);
      if (ok1)
        *reinterpret_cast<float2*>(d1 + col) =
            make_float2(acc[4 * jj + 2] * inv1, acc[4 * jj + 3] * inv1);
    }
  }
}

// Tensor map of a strided [problems, L, heads, D] f32 view: dims (D, heads,
// L, problems), byte strides of a head, a token and a problem (multiples of
// 16), boxes of 32 columns x 1 head x `rows` tokens x `probs` problems with
// the 128-byte swizzle, out-of-bound elements read as zeros.
cudaError_t make_f32_tmap(CUtensorMap* map, const void* ptr, int D, int heads, int L,
                          int problems, long sh, long sl, long sb, int rows, int probs) {
  const TmapEncodeFn encode = tmap_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)problems};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)sl * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, (cuuint32_t)probs};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DV>
cudaError_t launch_tf32_attention(const CUtensorMap& tq, const CUtensorMap& tk,
                                  const CUtensorMap& tv, void* o, long ob, long ol, long oh,
                                  int problems, int heads, int L, int D, int items, int solo,
                                  int lg, int grid, float scale, cudaStream_t st) {
  constexpr int smem = TfCfg<DV>::kBytes;
  static bool attr = false;  // the shared-memory attribute, set once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_tf32_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  attention_tf32_kernel<DV><<<grid, TF_THREADS, smem, st>>>(
      tq, tk, tv, (float*)o, ob, ol, oh, problems, heads, L, D, items, solo, lg, scale);
  return cudaGetLastError();
}

constexpr int AF_WARPS = 4;    // warps (16 query rows each) per block
constexpr int AF_ROWS = AF_WARPS * 16;

template <int DP>
struct AfSmem {
  static constexpr int kKT = DP <= 160 ? 64 : 32;  // keys per shared-memory tile
  static constexpr int kPitch = DP + 4;  // floats per row: rows on distinct banks
  static constexpr int kQ = AF_ROWS * kPitch;
  static constexpr int kKV = kKT * kPitch;
  static constexpr int kBytes = (kQ + 4 * kKV) * 4;  // Q + 2 buffers x (K, V)
};

struct ViewF {
  const float* p;
  long sb, sl, sh;
};

template <int DP>
__global__ void __launch_bounds__(AF_WARPS * 32)
attention_f32_kernel(ViewF q, ViewF k, ViewF v, float* __restrict__ o, long ob, long ol,
                     long oh, int L, int D, int nqb, float scale) {
  constexpr int P = AfSmem<DP>::kPitch;
  constexpr int KT = AfSmem<DP>::kKT;
  constexpr int NV = DP / 4;   // 16-byte vectors per padded row
  constexpr int NT = DP / 8;   // n8 tiles of the output accumulator
  constexpr int KD = DP / 8;   // k8 steps over head_dim
  constexpr int NC = KT / 8;   // 8-key chunks per tile
  extern __shared__ __align__(128) float smem_af[];
  float* Qs = smem_af;
  float* KVs = Qs + AfSmem<DP>::kQ;  // [buf][K | V][KT * P]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long prob = blockIdx.x / nqb;
  const int q0 = (int)(blockIdx.x % nqb) * AF_ROWS;
  const int wq0 = q0 + warp * 16;
  const bool active = wq0 < L;
  const int dvec = D / 4;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  const float* qp = q.p + prob * q.sb + h * q.sh;
  const float* kp = k.p + prob * k.sb + h * k.sh;
  const float* vp = v.p + prob * v.sb + h * v.sh;

  for (int idx = tid; idx < AF_ROWS * NV; idx += AF_WARPS * 32) {
    const int r = idx / NV, cv = idx % NV;
    const int row = q0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L && cv < dvec) val = *reinterpret_cast<const float4*>(qp + row * q.sl + cv * 4);
    *reinterpret_cast<float4*>(Qs + r * P + cv * 4) = val;
  }

  auto load_kv = [&](int buf, int kc) {
    float* Kd = KVs + buf * 2 * AfSmem<DP>::kKV;
    float* Vd = Kd + AfSmem<DP>::kKV;
    for (int idx = tid; idx < KT * NV; idx += AF_WARPS * 32) {
      const int r = idx / NV, cv = idx % NV;
      const bool in = kc + r < L && cv < dvec;
      const long off = (long)(kc + r) * k.sl + cv * 4;
      const long voff = (long)(kc + r) * v.sl + cv * 4;
      cp_async16(Kd + r * P + cv * 4, in ? kp + off : kp, in ? 16 : 0);
      cp_async16(Vd + r * P + cv * 4, in ? vp + voff : vp, in ? 16 : 0);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  load_kv(0, 0);
  cp_async_commit();

  int buf = 0;
  for (int kc = 0; kc < L; kc += KT, buf ^= 1) {
    if (kc + KT < L) load_kv(buf ^ 1, kc + KT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const int nk = min(KT, L - kc);
      const int c_hi = (nk + 7) / 8;
      const float* Kt = KVs + buf * 2 * AfSmem<DP>::kKV;
      const float* Vt = Kt + AfSmem<DP>::kKV;

      float s[NC][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qb[4], qs[4];
        const float* qa = Qs + (warp * 16 + g) * P + kk * 8 + t;
        split_tf32(qa[0], qb[0], qs[0]);
        split_tf32(qa[8 * P], qb[1], qs[1]);
        split_tf32(qa[4], qb[2], qs[2]);
        split_tf32(qa[8 * P + 4], qb[3], qs[3]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c >= c_hi) continue;
          uint32_t kb[2], ks[2];
          const float* ka = Kt + (c * 8 + g) * P + kk * 8 + t;
          split_tf32(ka[0], kb[0], ks[0]);
          split_tf32(ka[4], kb[1], ks[1]);
          mma_3xtf32(s[c], qb, qs, kb, ks);
        }
      }
      // Scale, mask the keys past L, row maxima (rows g and g + 8).
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = c * 8 + 2 * t;
        const bool k0 = key < nk, k1 = key + 1 < nk;
        s[c][0] = k0 ? s[c][0] * sl2 : -INFINITY;
        s[c][1] = k1 ? s[c][1] * sl2 : -INFINITY;
        s[c][2] = k0 ? s[c][2] * sl2 : -INFINITY;
        s[c][3] = k1 ? s[c][3] * sl2 : -INFINITY;
        mx0 = fmaxf(mx0, fmaxf(s[c][0], s[c][1]));
        mx1 = fmaxf(mx1, fmaxf(s[c][2], s[c][3]));
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      // Every tile holds at least one key, so the new maxima are finite.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= c_hi) continue;
        const float p0 = exp2f(s[c][0] - mn0), p1 = exp2f(s[c][1] - mn0);
        const float p2 = exp2f(s[c][2] - mn1), p3 = exp2f(s[c][3] - mn1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        // A column t <-> key 2t, column t + 4 <-> key 2t + 1 of the chunk.
        uint32_t pb[4], ps[4];
        split_tf32(p0, pb[0], ps[0]);
        split_tf32(p2, pb[1], ps[1]);
        split_tf32(p1, pb[2], ps[2]);
        split_tf32(p3, pb[3], ps[3]);
        const float* va = Vt + (c * 8 + 2 * t) * P + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t vb[2], vs[2];
          split_tf32(va[n * 8], vb[0], vs[0]);
          split_tf32(va[P + n * 8], vb[1], vs[1]);
          mma_3xtf32(acc[n], pb, ps, vb, vs);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = wq0 + g, r1 = r0 + 8;
  float* d0 = o + prob * ob + h * oh + (long)r0 * ol;
  float* d1 = d0 + 8 * ol;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < D) {
      if (r0 < L)
        *reinterpret_cast<float2*>(d0 + col) = make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
      if (r1 < L)
        *reinterpret_cast<float2*>(d1 + col) = make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

}  // namespace
}  // namespace spk

extern "C" {

// attention_f32_kernel for head dims above 80.  q / k / v / o: pointer and
// element strides (problem, token, head) of each [problems, L, heads, D] f32
// view; D a multiple of 4, 84 to 256.
int sp_attention_f32(const void* q, long qb, long ql, long qh, const void* k, long kb,
                     long kl, long kh, const void* v, long vb, long vl, long vh, void* o,
                     long ob, long ol, long oh, int problems, int heads, int L, int D,
                     float scale, void* stream) {
  using namespace spk;
  const int nqb = (L + AF_ROWS - 1) / AF_ROWS;
  const dim3 grid((unsigned)((long)problems * nqb), heads);
  const dim3 block(AF_WARPS * 32);
  const ViewF qv{(const float*)q, qb, ql, qh}, kv{(const float*)k, kb, kl, kh},
      vv{(const float*)v, vb, vl, vh};
  cudaStream_t st = (cudaStream_t)stream;
  // head_dim padded in shared memory to the next of these widths
  const int dp = D <= 96 ? 96 : D <= 112 ? 112 : D <= 128 ? 128 : D <= 144 ? 144
               : D <= 160 ? 160 : D <= 192 ? 192 : D <= 224 ? 224 : 256;
#define SPK_AF_CASE(DPV)                                                                \
  case DPV: {                                                                           \
    const int smem = AfSmem<DPV>::kBytes;                                               \
    static bool attr = false; /* set once per instantiation */                          \
    if (!attr) {                                                                        \
      const cudaError_t e = cudaFuncSetAttribute(                                       \
          attention_f32_kernel<DPV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
      if (e != cudaSuccess) return (int)e;                                              \
      attr = true;                                                                      \
    }                                                                                   \
    attention_f32_kernel<DPV><<<grid, block, smem, st>>>(qv, kv, vv, (float*)o, ob, ol, \
                                                         oh, L, D, nqb, scale);         \
    break;                                                                              \
  }
  if (D > 256 || D <= 80 || D % 4) return (int)cudaErrorInvalidValue;
  switch (dp) {
    SPK_AF_CASE(96)
    SPK_AF_CASE(112)
    SPK_AF_CASE(128)
    SPK_AF_CASE(144)
    SPK_AF_CASE(160)
    SPK_AF_CASE(192)
    SPK_AF_CASE(224)
    SPK_AF_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_AF_CASE
  return (int)cudaGetLastError();
}


// q / k / v: pointer and element strides (problem, token, head) of each
// [problems, L, heads, D] f32 view (strides multiples of 4, 16-byte
// aligned); o a contiguous [problems, L, heads, D].  D a multiple of 4, at
// most dv; dv (16, 32, 48, 64, 72 or 80), items, solo, lg (log2 L of packed
// windows, or -1) and grid from kernels.attention_f32_plan.
int sp_attention_tf32(const void* q, long qb, long ql, long qh, const void* k, long kb,
                      long kl, long kh, const void* v, long vb, long vl, long vh, void* o,
                      long ob, long ol, long oh, int problems, int heads, int L, int D, int dv,
                      int items, int solo, int lg, int grid, float scale, void* stream) {
  using namespace spk;
  const bool packed = lg >= 0;
  if (D % 4 || D > dv || L < 1 || grid < 1 || items < 1 || (!solo && L <= TF_ROWS) ||
      (solo && L > TF_ROWS) || (packed && (!solo || lg > 5 || (1 << lg) != L)))
    return (int)cudaErrorInvalidValue;
  // Boxes: packed, 64 / L windows of L rows for Q and 32 / L for K / V;
  // else 64 rows of one problem for Q and 32 for K / V.
  const int qr = packed ? L : TF_ROWS, qp = packed ? TF_ROWS / L : 1;
  const int kr = packed ? L : TF_KT, kp = packed ? TF_KT / L : 1;
  CUtensorMap tq, tk, tv;
  cudaError_t e = make_f32_tmap(&tq, q, D, heads, L, problems, qh, ql, qb, qr, qp);
  if (e == cudaSuccess) e = make_f32_tmap(&tk, k, D, heads, L, problems, kh, kl, kb, kr, kp);
  if (e == cudaSuccess) e = make_f32_tmap(&tv, v, D, heads, L, problems, vh, vl, vb, kr, kp);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
#define SPK_TF_CASE(DVV)                                                                  \
  case DVV:                                                                               \
    return (int)launch_tf32_attention<DVV>(tq, tk, tv, o, ob, ol, oh, problems, heads, L, \
                                           D, items, solo, lg, grid, scale, st);
  switch (dv) {
    SPK_TF_CASE(16)
    SPK_TF_CASE(32)
    SPK_TF_CASE(48)
    SPK_TF_CASE(64)
    SPK_TF_CASE(72)
    SPK_TF_CASE(80)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_TF_CASE
}

}  // extern "C"
