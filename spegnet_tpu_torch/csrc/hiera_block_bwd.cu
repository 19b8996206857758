// Backward of the whole non-pooling Hiera block on Hopper, as a chain of
// launches that recomputes the forward from the block input (the kernels of
// hiera_block.cu, with the attention's log-sum-exp and fc1's pre-activation
// kept) and then runs, on Morton token-major rows (M = B * N):
//
//   dW2 = dOut^T g, db2            sp_gemm_tn (split over M, column sums)
//   dz  = (dOut W2) * gelu'(z)     sp_gemm, ACT_GELU_GRAD epilogue
//   dW1 = dz^T h2, db1             sp_gemm_tn
//   dh2 = dz W1                    sp_gemm
//   du  = dOut + LN2'(dh2)         sp_layernorm_bwd (+ dln2 weight / bias)
//   dWproj = du^T a, dbproj        sp_gemm_tn
//   da  = du Wproj                 sp_gemm
//   dqkv = attention'(da)          sp_attention_bwd
//   dWqkv = dqkv^T h1, dbqkv       sp_gemm_tn
//   dh1 = dqkv Wqkv                sp_gemm
//   dx  = du + LN1'(dh1)           sp_layernorm_bwd (+ dln1 weight / bias)
//
// Replaces the TPU backward kernel spegnet_tpu/ops/fused_block_t.py
// `_bwd_kernel` (:1165, entry `_backward` :1363), which recomputed the
// forward and produced dx and the 12 weight gradients of one attention
// chunk inside VMEM, accumulating the weight gradients across the
// sequential grid.  Hopper's blocks run in parallel and in no order, so
// every cross-row sum here (weight, bias and LayerNorm-parameter gradients)
// is written as per-split f32 partials and summed by a second pass in a
// fixed order: the result does not change from run to run.  dX = dY W
// products reuse the forward's TMA + wgmma GEMM on weights transposed once
// per call by the caller.
//
// Bound on the H100: like the forward, the GEMMs carry most of the FLOPs
// (the backward runs ~2x the forward's GEMM work plus its recompute).  The
// weight-gradient GEMMs have small outputs (432 x 144 at stage 1) over
// contractions of up to 131072 rows, so they split M to fill the card.
#include "attention.cuh"

namespace spk {
namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Attention backward (FlashAttention-2 style, recomputing P from the
// forward's log-sum-exp).  Windows as in attention.cuh: query window w is
// rows [w*Lq, (w+1)*Lq), its keys rows [w*Lk, (w+1)*Lk); Lk % 16 == 0.
// Each warp works alone on one 16-row tile (no block-wide barrier), with
// its own two 16-row shared-memory tiles; head_dim is zero-padded to DP in
// shared memory only.
//   dkdv: a warp owns 16 keys of one head and walks the query rows of their
//         window in 16-row chunks (rows of other windows masked):
//         dV += P^T dO, dK += dS^T Q * scale.
//   dq:   a warp owns 16 query rows and walks the keys of their windows:
//         dQ += dS K * scale.
// with dS = P * (dP - D), dP = dO V^T, D = rowsum(dO * O) (attn_dot_kernel).
// No atomics: each output row is written by exactly one warp.
// ---------------------------------------------------------------------------

constexpr int BW_WARPS = 4;

template <int DP>
struct BwdSmem {
  static constexpr int kPitch = DP + 8;
  static constexpr int kTile = 16 * kPitch;
  static constexpr int kBytes = BW_WARPS * (2 * kTile * 2 + 32 * 4);
};

// 16 rows x D columns of src (row stride ld) -> tile, zero-padded to DP.
template <int DP>
__device__ __forceinline__ void load_tile16(bf16* tile, const bf16* src, long r0, long ld,
                                            int dvec, int lane) {
  constexpr int P = DP + 8, NV = DP / 8;
  for (int idx = lane; idx < 16 * NV; idx += 32) {
    const int r = idx / NV, cv = idx % NV;
    uint4 v = zero_vec8();
    if (cv < dvec) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + cv * 8);
    *reinterpret_cast<uint4*>(tile + r * P + cv * 8) = v;
  }
}

// A operand (16 x 16, row-major) at k offset 16 * kk of a tile.
template <int DP>
__device__ __forceinline__ void frag_a(uint32_t f[4], const bf16* tile, int kk, int lane) {
  ldmatrix_x4(f, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * (DP + 8) + kk * 16 +
                     (lane >> 4) * 8);
}

// B operand of two n8 tiles whose n index is the tile's row (rows 0-7 ->
// f[0], f[1]; rows 8-15 -> f[2], f[3]), k offset 16 * kk along the row.
template <int DP>
__device__ __forceinline__ void frag_b_rows(uint32_t f[4], const bf16* tile, int kk,
                                            int lane) {
  ldmatrix_x4(f, tile + ((lane & 7) + (lane >> 4) * 8) * (DP + 8) + kk * 16 +
                     ((lane >> 3) & 1) * 8);
}

// B operand of n8 tiles 2*np, 2*np+1 whose k index is the tile's row (the
// 16 rows) and n index the column.
template <int DP>
__device__ __forceinline__ void frag_b_cols(uint32_t f[4], const bf16* tile, int np,
                                            int lane) {
  ldmatrix_x4_trans(f, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * (DP + 8) + np * 16 +
                           (lane >> 4) * 8);
}

// D[row * heads + h] = sum_j dO[row, h*D + j] * O[row, h*D + j]; a warp per row.
__global__ void attn_dot_kernel(const bf16* __restrict__ o, long ldo,
                                const bf16* __restrict__ dout, long lddo,
                                float* __restrict__ dd, int rows, int heads, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * 8 + warp;
  if (row >= rows) return;
  for (int h = 0; h < heads; ++h) {
    float s = 0.f;
    for (int j = lane; j < D; j += 32)
      s += bf(o[row * ldo + h * D + j]) * bf(dout[row * lddo + h * D + j]);
    s = warp_sum(s);
    if (lane == 0) dd[row * heads + h] = s;
  }
}

template <int DP>
__global__ void __launch_bounds__(BW_WARPS * 32)
attn_dkdv_kernel(const bf16* __restrict__ q, long ldq, const bf16* __restrict__ k, long ldk,
                 const bf16* __restrict__ v, long ldv, const bf16* __restrict__ dout,
                 long lddo, const float* __restrict__ lse, const float* __restrict__ dd,
                 bf16* __restrict__ dk, long lddk, bf16* __restrict__ dv, long lddv,
                 int k_rows, int heads, int D, int Lq, int Lk, float scale) {
  constexpr int NT = DP / 8, KD = DP / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* T0 = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * BwdSmem<DP>::kTile;
  bf16* T1 = T0 + BwdSmem<DP>::kTile;
  float* sv = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem_raw) +
                                       BW_WARPS * 2 * BwdSmem<DP>::kTile) + warp * 32;
  const int h = blockIdx.y;
  const long kr0 = ((long)blockIdx.x * BW_WARPS + warp) * 16;
  if (kr0 >= k_rows) return;
  const int dvec = D / 8;
  const long hc = (long)h * D;
  const float sl2 = scale * LOG2E;

  load_tile16<DP>(T0, k + hc, kr0, ldk, dvec, lane);
  load_tile16<DP>(T1, v + hc, kr0, ldv, dvec, lane);
  __syncwarp();
  uint32_t kA[KD][4], vA[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    frag_a<DP>(kA[kk], T0, kk, lane);
    frag_a<DP>(vA[kk], T1, kk, lane);
  }
  __syncwarp();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const long w = kr0 / Lk;
  const long qb = w * Lq, qe = qb + Lq;
  for (long qc = qb & ~15L; qc < qe; qc += 16) {
    load_tile16<DP>(T0, q + hc, qc, ldq, dvec, lane);
    load_tile16<DP>(T1, dout + hc, qc, lddo, dvec, lane);
    if (lane < 16) {
      sv[lane] = lse[(qc + lane) * heads + h];
      sv[16 + lane] = dd[(qc + lane) * heads + h];
    }
    __syncwarp();
    // S^T = K Q^T and dP^T = V dO^T: [16 keys x 16 queries], n8 tile n holds
    // queries 8n..8n+7.
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t f[4];
      frag_b_rows<DP>(f, T0, kk, lane);
      mma_bf16(s[0], kA[kk], f[0], f[1]);
      mma_bf16(s[1], kA[kk], f[2], f[3]);
      frag_b_rows<DP>(f, T1, kk, lane);
      mma_bf16(dp[0], vA[kk], f[0], f[1]);
      mma_bf16(dp[1], vA[kk], f[2], f[3]);
    }
    // P^T and dS^T (scaled), packed as A operands over the 16 queries.
    uint32_t pa[4], da[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        const long qrow = qc + col;
        const bool ok = qrow >= qb && qrow < qe;
        const float l2 = sv[col], dv_ = sv[16 + col];
        p[j] = ok ? exp2f(s[n][j] * sl2 - l2) : 0.f;          // key g
        p[2 + j] = ok ? exp2f(s[n][2 + j] * sl2 - l2) : 0.f;  // key g + 8
        ds[j] = p[j] * (dp[n][j] - dv_) * scale;
        ds[2 + j] = p[2 + j] * (dp[n][2 + j] - dv_) * scale;
      }
      pa[2 * n] = pack_bf16(p[0], p[1]);
      pa[2 * n + 1] = pack_bf16(p[2], p[3]);
      da[2 * n] = pack_bf16(ds[0], ds[1]);
      da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t f[4];
      frag_b_cols<DP>(f, T1, np, lane);
      mma_bf16(dva[2 * np], pa, f[0], f[1]);
      mma_bf16(dva[2 * np + 1], pa, f[2], f[3]);
      frag_b_cols<DP>(f, T0, np, lane);
      mma_bf16(dka[2 * np], da, f[0], f[1]);
      mma_bf16(dka[2 * np + 1], da, f[2], f[3]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < D) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = kr0 + g + 8 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dk + row * lddk + hc + col) =
            __floats2bfloat162_rn(dka[n][2 * hh], dka[n][2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + row * lddv + hc + col) =
            __floats2bfloat162_rn(dva[n][2 * hh], dva[n][2 * hh + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(BW_WARPS * 32)
attn_dq_kernel(const bf16* __restrict__ q, long ldq, const bf16* __restrict__ k, long ldk,
               const bf16* __restrict__ v, long ldv, const bf16* __restrict__ dout, long lddo,
               const float* __restrict__ lse, const float* __restrict__ dd,
               bf16* __restrict__ dq, long lddq, int q_rows, int heads, int D, int Lq, int Lk,
               float scale) {
  constexpr int NT = DP / 8, KD = DP / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* T0 = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * BwdSmem<DP>::kTile;
  bf16* T1 = T0 + BwdSmem<DP>::kTile;
  const int h = blockIdx.y;
  const long qr0 = ((long)blockIdx.x * BW_WARPS + warp) * 16;
  if (qr0 >= q_rows) return;
  const int dvec = D / 8;
  const long hc = (long)h * D;
  const float sl2 = scale * LOG2E;

  load_tile16<DP>(T0, q + hc, qr0, ldq, dvec, lane);
  load_tile16<DP>(T1, dout + hc, qr0, lddo, dvec, lane);
  __syncwarp();
  uint32_t qA[KD][4], oA[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    frag_a<DP>(qA[kk], T0, kk, lane);
    frag_a<DP>(oA[kk], T1, kk, lane);
  }
  __syncwarp();
  const float l0 = lse[(qr0 + g) * heads + h], l1 = lse[(qr0 + g + 8) * heads + h];
  const float d0 = dd[(qr0 + g) * heads + h], d1 = dd[(qr0 + g + 8) * heads + h];
  const long kb = (qr0 / Lq) * Lk, ke = ((qr0 + 15) / Lq + 1) * Lk;
  const long lo0 = ((qr0 + g) / Lq) * Lk, lo1 = ((qr0 + g + 8) / Lq) * Lk;

  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (long kc = kb; kc < ke; kc += 16) {
    load_tile16<DP>(T0, k + hc, kc, ldk, dvec, lane);
    load_tile16<DP>(T1, v + hc, kc, ldv, dvec, lane);
    __syncwarp();
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t f[4];
      frag_b_rows<DP>(f, T0, kk, lane);
      mma_bf16(s[0], qA[kk], f[0], f[1]);
      mma_bf16(s[1], qA[kk], f[2], f[3]);
      frag_b_rows<DP>(f, T1, kk, lane);
      mma_bf16(dp[0], oA[kk], f[0], f[1]);
      mma_bf16(dp[1], oA[kk], f[2], f[3]);
    }
    // 16-key chunks lie inside one window (Lk % 16 == 0).
    const bool ok0 = kc >= lo0 && kc < lo0 + Lk, ok1 = kc >= lo1 && kc < lo1 + Lk;
    uint32_t da[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p0 = ok0 ? exp2f(s[n][j] * sl2 - l0) : 0.f;
        const float p1 = ok1 ? exp2f(s[n][2 + j] * sl2 - l1) : 0.f;
        ds[j] = p0 * (dp[n][j] - d0) * scale;
        ds[2 + j] = p1 * (dp[n][2 + j] - d1) * scale;
      }
      da[2 * n] = pack_bf16(ds[0], ds[1]);
      da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t f[4];
      frag_b_cols<DP>(f, T0, np, lane);
      mma_bf16(dqa[2 * np], da, f[0], f[1]);
      mma_bf16(dqa[2 * np + 1], da, f[2], f[3]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < D) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = qr0 + g + 8 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dq + row * lddq + hc + col) =
            __floats2bfloat162_rn(dqa[n][2 * hh], dqa[n][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Weight-gradient GEMM: part[s][n][k] = sum_{m in split s} A[m][n] B[m][k]
// (both operands M-major, the layout the forward GEMM does not take), with
// cspart[s][n] = sum_{m in split s} A[m][n] (the bias gradient) from the
// blocks of the first K tile.  128 threads, a 64 x 64 output tile, 32-row M steps
// double-buffered with cp.async; fragments through ldmatrix.trans and
// mma.m16n8k16 with f32 accumulation.  N % 8 == 0 and K % 8 == 0; tails
// zero-filled.
// ---------------------------------------------------------------------------

constexpr int TN_TILE = 64, TN_BM = 32, TN_P = TN_TILE + 8;

__global__ void __launch_bounds__(128)
gemm_tn_kernel(const bf16* __restrict__ A, long lda, const bf16* __restrict__ B, long ldb,
               long M, int N, int K, long m_split, float* __restrict__ part,
               float* __restrict__ cspart) {
  __shared__ __align__(128) bf16 As[2][TN_BM * TN_P];
  __shared__ __align__(128) bf16 Bs[2][TN_BM * TN_P];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TN_TILE, n0 = blockIdx.y * TN_TILE;
  const long mb = (long)blockIdx.z * m_split, me = lmin(M, mb + m_split);
  const int wn = (warp >> 1) * 32, wk = (warp & 1) * 32;
  const bool colsum = blockIdx.x == 0;

  auto load = [&](int buf, long m0) {
    for (int idx = tid; idx < TN_BM * (TN_TILE / 8); idx += 128) {
      const int r = idx / (TN_TILE / 8), cv = idx % (TN_TILE / 8);
      const long m = m0 + r;
      const int na = n0 + cv * 8, kb = k0 + cv * 8;
      const bool ina = m < me && na < N, inb = m < me && kb < K;
      cp_async16(&As[buf][r * TN_P + cv * 8], ina ? A + m * lda + na : A, ina ? 16 : 0);
      cp_async16(&Bs[buf][r * TN_P + cv * 8], inb ? B + m * ldb + kb : B, inb ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float csum = 0.f;

  if (mb < me) load(0, mb);
  cp_async_commit();
  int buf = 0;
  for (long m0 = mb; m0 < me; m0 += TN_BM, buf ^= 1) {
    if (m0 + TN_BM < me) load(buf ^ 1, m0 + TN_BM);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = As[buf];
    const bf16* bs = Bs[buf];
#pragma unroll
    for (int ks = 0; ks < TN_BM / 16; ++ks) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4_trans(af[i], as + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * TN_P + wn +
                                     i * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bfr[j], bs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * TN_P +
                                      wk + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
    if (colsum && tid < TN_TILE)
      for (int r = 0; r < TN_BM; ++r) csum += bf(as[r * TN_P + tid]);
    __syncthreads();
  }
  cp_async_wait<0>();

  float* out = part + (long)blockIdx.z * N * K;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + wk + j * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = n0 + wn + i * 16 + g + 8 * hh;
        if (n < N && k < K) {
          out[(long)n * K + k] = acc[i][j][2 * hh];
          out[(long)n * K + k + 1] = acc[i][j][2 * hh + 1];
        }
      }
    }
  if (colsum && tid < TN_TILE && n0 + tid < N) cspart[(long)blockIdx.z * N + n0 + tid] = csum;
}

// out[i] = sum_{s < splits} part[s * len + i], in order.
__global__ void reduce_splits_kernel(const float* __restrict__ part, int splits, long len,
                                     float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long)k * len + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// LayerNorm backward.  rows kernel (a warp per row): recompute the f32 row
// statistics from bf16 x as the forward does, dx = rstd * (dy*w - mean(dy*w)
// - xhat * mean(dy*w*xhat)) (+ dres), rounded to bf16; (mean, rstd) saved
// for the column kernel, which writes per-split partial sums of dy * xhat
// (dw) and dy (db) for reduce_splits_kernel.
// ---------------------------------------------------------------------------

__global__ void layernorm_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                                          const bf16* __restrict__ dy,
                                          const bf16* __restrict__ dres, bf16* __restrict__ dx,
                                          float2* __restrict__ stats, long rows, int C,
                                          float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * 8 + warp;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  const bf16* gr = dy + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += bf(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = bf(xr[c]) - mu;
    v += d * d;
  }
  const float r = rsqrtf(warp_sum(v) / C + eps);
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float gw = bf(gr[c]) * w[c];
    m1 += gw;
    m2 += gw * (bf(xr[c]) - mu) * r;
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
  bf16* dr = dx + row * C;
  for (int c = lane; c < C; c += 32) {
    const float xh = (bf(xr[c]) - mu) * r;
    float val = r * (bf(gr[c]) * w[c] - m1 - xh * m2);
    if (dres) val += bf(dres[row * C + c]);
    dr[c] = to_bf(val);
  }
  if (lane == 0) stats[row] = make_float2(mu, r);
}

__global__ void layernorm_bwd_cols_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                          const float2* __restrict__ stats, long rows, int C,
                                          long r_split, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long rb = (long)blockIdx.y * r_split, re = lmin(rows, rb + r_split);
  float dw = 0.f, db = 0.f;
  for (long r = rb; r < re; ++r) {
    const float2 st = stats[r];
    const float gv = bf(dy[r * C + c]);
    dw += gv * (bf(x[r * C + c]) - st.x) * st.y;
    db += gv;
  }
  float* out = part + (long)blockIdx.y * 2 * C;
  out[c] = dw;
  out[C + c] = db;
}

template <int DP>
cudaError_t launch_attn_bwd_dp(const bf16* q, long ldq, const bf16* k, long ldk, const bf16* v,
                               long ldv, const bf16* dout, long lddo, const float* lse,
                               const float* dd, bf16* dq, long lddq, bf16* dk, long lddk,
                               bf16* dv, long lddv, int q_rows, int k_rows, int heads, int D,
                               int Lq, int Lk, float scale, cudaStream_t st) {
  const int smem = BwdSmem<DP>::kBytes;
  cudaFuncSetAttribute(attn_dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(attn_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int rows_per_block = BW_WARPS * 16;
  attn_dkdv_kernel<DP><<<dim3((k_rows + rows_per_block - 1) / rows_per_block, heads),
                         BW_WARPS * 32, smem, st>>>(q, ldq, k, ldk, v, ldv, dout, lddo, lse, dd,
                                                    dk, lddk, dv, lddv, k_rows, heads, D, Lq,
                                                    Lk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_dq_kernel<DP><<<dim3((q_rows + rows_per_block - 1) / rows_per_block, heads),
                       BW_WARPS * 32, smem, st>>>(q, ldq, k, ldk, v, ldv, dout, lddo, lse, dd, dq,
                                                  lddq, q_rows, heads, D, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spk

using spk::bf16;

extern "C" {

// Attention backward for query windows of Lq rows against key windows of Lk
// rows (Lk % 16 == 0, q_rows % 16 == 0).  q/k/v/o/dout/dq/dk/dv point at
// head 0's column of their buffers (row strides ld*); heads * D columns
// follow.  lse [q_rows, heads] from the forward; dd [q_rows, heads] f32 is
// scratch.
int sp_attention_bwd(const void* q, long ldq, const void* k, long ldk, const void* v, long ldv,
                     const void* o, long ldo, const void* dout, long lddo, const void* lse,
                     void* dd, void* dq, long lddq, void* dk, long lddk, void* dv, long lddv,
                     int q_rows, int heads, int D, int Lq, int Lk, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int k_rows = q_rows / Lq * Lk;
  spk::attn_dot_kernel<<<(q_rows + 7) / 8, 256, 0, st>>>(
      (const bf16*)o, ldo, (const bf16*)dout, lddo, (float*)dd, q_rows, heads, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#define SPK_BWD_CASE(DPV)                                                                  \
  case DPV:                                                                                \
    return (int)spk::launch_attn_bwd_dp<DPV>(                                              \
        (const bf16*)q, ldq, (const bf16*)k, ldk, (const bf16*)v, ldv, (const bf16*)dout, \
        lddo, (const float*)lse, (const float*)dd, (bf16*)dq, lddq, (bf16*)dk, lddk,       \
        (bf16*)dv, lddv, q_rows, k_rows, heads, D, Lq, Lk, scale, st);
  switch ((D + 15) / 16 * 16) {
    SPK_BWD_CASE(16)
    SPK_BWD_CASE(32)
    SPK_BWD_CASE(48)
    SPK_BWD_CASE(64)
    SPK_BWD_CASE(80)
    SPK_BWD_CASE(96)
    SPK_BWD_CASE(112)
    SPK_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_BWD_CASE
}

// out [N, K] f32 = A[M, N]^T B[M, K] and colsum [N] f32 = the column sums
// of A.  part: [splits, N, K] f32 scratch, cspart: [splits, N] f32 scratch;
// M is cut into splits of m_split rows (a multiple of 32).
int sp_gemm_tn(const void* a, long lda, const void* b, long ldb, long M, int N, int K,
               long m_split, int splits, void* part, void* cspart, void* out, void* colsum,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((K + spk::TN_TILE - 1) / spk::TN_TILE, (N + spk::TN_TILE - 1) / spk::TN_TILE,
                  splits);
  spk::gemm_tn_kernel<<<grid, 128, 0, st>>>((const bf16*)a, lda, (const bf16*)b, ldb, M, N, K,
                                             m_split, (float*)part, (float*)cspart);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long len = (long)N * K;
  spk::reduce_splits_kernel<<<(unsigned)((len + 255) / 256), 256, 0, st>>>(
      (const float*)part, splits, len, (float*)out);
  spk::reduce_splits_kernel<<<(N + 255) / 256, 256, 0, st>>>((const float*)cspart, splits, N,
                                                              (float*)colsum);
  return (int)cudaGetLastError();
}

// LayerNorm backward over rows of C: dx (bf16, + dres when non-null), and
// dwb = [dw; db] (2C f32).  stats [rows] float2 and part [splits, 2C] f32
// are scratch; rows are cut into splits of r_split.
int sp_layernorm_bwd(const void* x, const void* w, const void* dy, const void* dres, void* dx,
                     void* stats, void* part, long r_split, int splits, void* dwb, long rows,
                     int C, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  spk::layernorm_bwd_rows_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const bf16*)x, (const float*)w, (const bf16*)dy, (const bf16*)dres, (bf16*)dx,
      (float2*)stats, rows, C, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  spk::layernorm_bwd_cols_kernel<<<dim3((C + 127) / 128, splits), 128, 0, st>>>(
      (const bf16*)x, (const bf16*)dy, (const float2*)stats, rows, C, r_split, (float*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  spk::reduce_splits_kernel<<<(2 * C + 255) / 256, 256, 0, st>>>((const float*)part, splits,
                                                                  2L * C, (float*)dwb);
  return (int)cudaGetLastError();
}

}  // extern "C"
