// Window attention that reads q/k/v straight out of a qkv projection output.
//
// qkv is token-major [rows, ld] with the nn.Linear column order of Hiera's
// qkv layer: q heads at [0, H*D), k heads at [H*D, 2*H*D), v heads at
// [2*H*D, 3*H*D) (the shortcut columns of the Q-pool front may follow).
// Windows are consecutive token rows: query window w holds query rows
// [w*Lq, (w+1)*Lq) and attends to key rows [w*Lk, (w+1)*Lk).  With POOL,
// query row j is the elementwise max of q over token rows 4j..4j+3 (the 2x2
// max-pool of a Morton-ordered grid), so Lq = Lk / 4.
//
// A block of 4 warps owns 64 query rows of one head; each warp 16 rows.
// The block walks the union of its rows' key windows in tiles of 64 keys,
// double-buffered into shared memory with cp.async; each warp computes only
// the 16-key chunks inside its own rows' windows.  Scores, the online
// softmax (exp2, running max and sum per row) and the output accumulator
// stay in registers as mma.m16n8k16 fragments (the score accumulator is
// re-packed in place as the A operand of P.V), so the [L, L] scores never
// leave the chip at any L (global blocks run L = 1024).  head_dim is
// zero-padded to DP (a multiple of 16, the k of a bf16 mma) in shared
// memory only.  With `lse` set, each query row's log-sum-exp of its scaled
// scores (log2 units, [q_rows, heads] f32) is written too: the backward
// (hiera_block_bwd.cu) rebuilds P = exp2(s * scale * log2 e - lse) from it.
#pragma once

#include "common.cuh"

namespace spk {

constexpr int ATTN_KT = 64;      // keys per shared-memory tile
constexpr int ATTN_WARPS = 4;    // warps (16 query rows each) per block

template <int DP>
struct AttnSmem {
  static constexpr int kPitch = DP + 8;  // row pitch (elements): conflict-free ldmatrix
  static constexpr int kQ = ATTN_WARPS * 16 * kPitch;
  static constexpr int kKV = ATTN_KT * kPitch;
  static constexpr int kBytes = (kQ + 4 * kKV) * 2;  // Q + 2 buffers x (K, V)
};

template <int DP, bool POOL>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                 float* __restrict__ lse, int q_rows, int ld, int heads, int D,
                 int Lq, int Lk, float scale) {
  constexpr int P = AttnSmem<DP>::kPitch;
  constexpr int KT = ATTN_KT;
  constexpr int NV = DP / 8;   // 16-byte vectors per padded row
  constexpr int NT = DP / 8;   // n8 tiles of the output accumulator
  constexpr int KD = DP / 16;  // k16 steps over head_dim
  constexpr int NC = KT / 16;  // 16-key chunks per tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + AttnSmem<DP>::kQ;  // [buf][K | V][KT * P]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long cq0 = (long)blockIdx.x * (ATTN_WARPS * 16);
  const long qr0 = cq0 + warp * 16;
  const bool active = qr0 < q_rows;  // q_rows is a multiple of 16
  const int dvec = D / 8;
  const int q_col = h * D, k_col = (heads + h) * D, v_col = (2 * heads + h) * D;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units

  // Q tile of the block (pooled over 4 token rows when POOL), pads zeroed.
  for (int idx = tid; idx < ATTN_WARPS * 16 * NV; idx += ATTN_WARPS * 32) {
    const int r = idx / NV, cv = idx % NV;
    const long row = cq0 + r;
    uint4 v = zero_vec8();
    if (row < q_rows && cv < dvec) {
      if (POOL) {
        const bf16* src = qkv + (4 * row) * (long)ld + q_col + cv * 8;
        v = *reinterpret_cast<const uint4*>(src);
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          uint4 w = *reinterpret_cast<const uint4*>(src + i * (long)ld);
#pragma unroll
          for (int e = 0; e < 4; ++e) pairs(v)[e] = __hmax2(pairs(v)[e], pairs(w)[e]);
        }
      } else {
        v = *reinterpret_cast<const uint4*>(qkv + row * ld + q_col + cv * 8);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * P + cv * 8) = v;
  }

  // Key rows the block needs, and the ones this warp needs.
  const long last = lmin(cq0 + ATTN_WARPS * 16, (long)q_rows) - 1;
  const long kb = (cq0 / Lq) * Lk, ke = (last / Lq + 1) * Lk;
  const long wkb = (qr0 / Lq) * Lk, wke = ((qr0 + 15) / Lq + 1) * Lk;
  // Key window of this thread's two rows (g and g + 8 of the warp tile).
  const long lo0 = ((qr0 + g) / Lq) * Lk, lo1 = ((qr0 + g + 8) / Lq) * Lk;

  auto load_kv = [&](int buf, long kc) {
    const int nk = (int)lmin(KT, ke - kc);
    bf16* Kd = KVs + buf * 2 * AttnSmem<DP>::kKV;
    bf16* Vd = Kd + AttnSmem<DP>::kKV;
    for (int idx = tid; idx < nk * NV; idx += ATTN_WARPS * 32) {
      const int r = idx / NV, cv = idx % NV;
      const bf16* src = qkv + (kc + r) * (long)ld + cv * 8;
      const bool in = cv < dvec;
      cp_async16(Kd + r * P + cv * 8, in ? src + k_col : qkv, in ? 16 : 0);
      cp_async16(Vd + r * P + cv * 8, in ? src + v_col : qkv, in ? 16 : 0);
    }
  };

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t qf[KD][4];

  load_kv(0, kb);
  cp_async_commit();
  __syncthreads();
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                              kk * 16 + (lane >> 4) * 8);
  }

  int buf = 0;
  for (long kc = kb; kc < ke; kc += KT, buf ^= 1) {
    if (kc + KT < ke) load_kv(buf ^ 1, kc + KT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const long lo = lmax(kc, wkb), hi = lmin(kc + KT, lmin(ke, wke));
    if (active && lo < hi) {
      const int c_lo = (int)((lo - kc) / 16), c_hi = (int)((hi - kc) / 16);
      const bf16* Kt = KVs + buf * 2 * AttnSmem<DP>::kKV;
      const bf16* Vt = Kt + AttnSmem<DP>::kKV;

      float s[NC][2][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int n = 0; n < 2; ++n) s[c][n][0] = s[c][n][1] = s[c][n][2] = s[c][n][3] = 0.f;
        if (c < c_lo || c >= c_hi) continue;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (c * 16 + (lane & 7) + (lane >> 4) * 8) * P + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[c][0], qf[kk], kf[0], kf[1]);
          mma_bf16(s[c][1], qf[kk], kf[2], kf[3]);
        }
      }
      // Scale, mask keys outside each row's window, row maxima.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const long k0 = kc + c * 16;
        const bool in_c = c >= c_lo && c < c_hi;
        const bool v0 = in_c && k0 >= lo0 && k0 < lo0 + Lk;
        const bool v1 = in_c && k0 >= lo1 && k0 < lo1 + Lk;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[c][n][0] = v0 ? s[c][n][0] * sl2 : -INFINITY;
          s[c][n][1] = v0 ? s[c][n][1] * sl2 : -INFINITY;
          s[c][n][2] = v1 ? s[c][n][2] * sl2 : -INFINITY;
          s[c][n][3] = v1 ? s[c][n][3] * sl2 : -INFINITY;
          mx0 = fmaxf(mx0, fmaxf(s[c][n][0], s[c][n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[c][n][2], s[c][n][3]));
        }
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = exp2f(m0 - base0), a1 = exp2f(m1 - base1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
      // P = exp2(s - max), rounded to bf16 for the P.V product; the row
      // sums add the rounded values.
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < c_lo || c >= c_hi) continue;
        uint32_t pa[4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const __nv_bfloat162 p01 =
              __floats2bfloat162_rn(exp2f(s[c][n][0] - base0), exp2f(s[c][n][1] - base0));
          const __nv_bfloat162 p23 =
              __floats2bfloat162_rn(exp2f(s[c][n][2] - base1), exp2f(s[c][n][3] - base1));
          l0 += __low2float(p01) + __high2float(p01);
          l1 += __low2float(p23) + __high2float(p23);
          pa[2 * n] = *reinterpret_cast<const uint32_t*>(&p01);
          pa[2 * n + 1] = *reinterpret_cast<const uint32_t*>(&p23);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vt + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                    np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
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
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (lse && t == 0) {
    lse[(qr0 + g) * heads + h] = m0 + log2f(l0);
    lse[(qr0 + g + 8) * heads + h] = m1 + log2f(l1);
  }
  const long stride = (long)heads * D;
  bf16* d0 = out + (qr0 + g) * stride + h * D;
  bf16* d1 = d0 + 8 * stride;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < D) {
      *reinterpret_cast<__nv_bfloat162*>(d0 + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(d1 + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

// Launches attention_kernel for a runtime head_dim D (a multiple of 8, at
// most 128), padding it to the next multiple of 16.
template <bool POOL>
cudaError_t launch_attention(const bf16* qkv, bf16* out, float* lse, int q_rows, int ld,
                             int heads, int D, int Lq, int Lk, float scale,
                             cudaStream_t stream) {
  const dim3 grid((q_rows + ATTN_WARPS * 16 - 1) / (ATTN_WARPS * 16), heads);
  const dim3 block(ATTN_WARPS * 32);
#define SPK_ATTN_CASE(DPV)                                                      \
  case DPV: {                                                                   \
    const int smem = AttnSmem<DPV>::kBytes;                                     \
    cudaFuncSetAttribute(attention_kernel<DPV, POOL>,                           \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);    \
    attention_kernel<DPV, POOL><<<grid, block, smem, stream>>>(                 \
        qkv, out, lse, q_rows, ld, heads, D, Lq, Lk, scale);                         \
    break;                                                                      \
  }
  switch ((D + 15) / 16 * 16) {
    SPK_ATTN_CASE(16)
    SPK_ATTN_CASE(32)
    SPK_ATTN_CASE(48)
    SPK_ATTN_CASE(64)
    SPK_ATTN_CASE(80)
    SPK_ATTN_CASE(96)
    SPK_ATTN_CASE(112)
    SPK_ATTN_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPK_ATTN_CASE
  return cudaGetLastError();
}

}  // namespace spk
