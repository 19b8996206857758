// Self-attention over independent problems of L tokens, any L, on Hopper.
//
// Replaces spegnet_tpu/ops/pallas_attention.py `_lanes_kernel` (:199) and
// `_lanes_qblock_kernel` (:220) of `fused_attention_lanes`, and
// `_attn_kernel` (:43) and `_qblock_kernel` (:68) of `fused_attention`: per
// (problem, head), softmax(q k^T * scale) v with the scores and the softmax
// in f32 and the probabilities rounded to bf16 for the product with v.
// Problems are the windows of Hiera's decomposed block (L = window^2, the
// zero-padded windows of a grid the window does not divide included, whose
// padded tokens are real keys) or a whole stage grid (global blocks; L 484,
// 576, 1600, 2304 at 352^2, 384^2, 640^2, 768^2).
//
// Every operand is a strided view [problems, L, heads, D] with D contiguous:
// the packed token-major qkv of an nn.Linear ([problems, L, 3*H*D]: q, k, v
// are column offsets 0, H*D, 2*H*D of one matrix) for fused_attention_lanes,
// separate [B, L, H, D] tensors for fused_attention; the output is written
// through the same kind of view.  Strides are in elements, multiples of 8.
//
// A block of 4 warps owns 64 query rows of one (problem, head); each warp 16
// rows.  Keys stream through shared memory in tiles of 64, double-buffered
// with cp.async; the scores, the online softmax (exp2, running max and sum
// per row) and the output accumulator stay in registers as mma.m16n8k16
// fragments, so no [L, L] tensor exists at any L.  The TPU kernels kept the
// whole [L, L] (or [BQ, L]) score tile in VMEM; here it would not fit, and
// the online softmax makes the key count a loop bound instead.  L need not
// be a multiple of 16: query rows past L are computed on zeros and not
// stored, key rows past L are zero-filled in shared memory and their scores
// masked to -inf, so the softmax runs over exactly the L keys of the problem.
// head_dim is zero-padded to DP (a multiple of 16) in shared memory only.
//
// Bound on the H100: 4 L^2 D FLOPs per (problem, head) against reading q, k,
// v and writing o once, 8 L D bytes: operations-bound above L ~ 300 at bf16
// peak; the mma.sync path reaches a fraction of the wgmma peak.
#include "common.cuh"

namespace spk {
namespace {

constexpr int LA_KT = 64;      // keys per shared-memory tile
constexpr int LA_WARPS = 4;    // warps (16 query rows each) per block
constexpr int LA_ROWS = LA_WARPS * 16;

template <int DP>
struct LanesSmem {
  static constexpr int kPitch = DP + 8;  // row pitch (elements): conflict-free ldmatrix
  static constexpr int kQ = LA_ROWS * kPitch;
  static constexpr int kKV = LA_KT * kPitch;
  static constexpr int kBytes = (kQ + 4 * kKV) * 2;  // Q + 2 buffers x (K, V)
};

// A strided [problems, L, heads, D] operand: element strides of one
// problem, one token and one head.
struct View {
  const bf16* p;
  long sb, sl, sh;
};

template <int DP>
__global__ void __launch_bounds__(LA_WARPS * 32)
lanes_attention_kernel(View q, View k, View v, bf16* __restrict__ o, long ob, long ol,
                       long oh, int L, int D, int nqb, float scale) {
  constexpr int P = LanesSmem<DP>::kPitch;
  constexpr int KT = LA_KT;
  constexpr int NV = DP / 8;   // 16-byte vectors per padded row
  constexpr int NT = DP / 8;   // n8 tiles of the output accumulator
  constexpr int KD = DP / 16;  // k16 steps over head_dim
  constexpr int NC = KT / 16;  // 16-key chunks per tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + LanesSmem<DP>::kQ;  // [buf][K | V][KT * P]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long prob = blockIdx.x / nqb;
  const int q0 = (int)(blockIdx.x % nqb) * LA_ROWS;
  const int wq0 = q0 + warp * 16;
  const bool active = wq0 < L;
  const int dvec = D / 8;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  const bf16* qp = q.p + prob * q.sb + h * q.sh;
  const bf16* kp = k.p + prob * k.sb + h * k.sh;
  const bf16* vp = v.p + prob * v.sb + h * v.sh;

  // Q tile of the block, rows past L and the head_dim pad zeroed.
  for (int idx = tid; idx < LA_ROWS * NV; idx += LA_WARPS * 32) {
    const int r = idx / NV, cv = idx % NV;
    const int row = q0 + r;
    uint4 val = zero_vec8();
    if (row < L && cv < dvec)
      val = *reinterpret_cast<const uint4*>(qp + row * q.sl + cv * 8);
    *reinterpret_cast<uint4*>(Qs + r * P + cv * 8) = val;
  }

  // Every row of the tile is written: rows past L (and the pad) as zeros.
  auto load_kv = [&](int buf, int kc) {
    bf16* Kd = KVs + buf * 2 * LanesSmem<DP>::kKV;
    bf16* Vd = Kd + LanesSmem<DP>::kKV;
    for (int idx = tid; idx < KT * NV; idx += LA_WARPS * 32) {
      const int r = idx / NV, cv = idx % NV;
      const bool in = kc + r < L && cv < dvec;
      const long off = (long)(kc + r) * k.sl + cv * 8;
      const long voff = (long)(kc + r) * v.sl + cv * 8;
      cp_async16(Kd + r * P + cv * 8, in ? kp + off : kp, in ? 16 : 0);
      cp_async16(Vd + r * P + cv * 8, in ? vp + voff : vp, in ? 16 : 0);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t qf[KD][4];

  load_kv(0, 0);
  cp_async_commit();
  __syncthreads();
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                              kk * 16 + (lane >> 4) * 8);
  }

  int buf = 0;
  for (int kc = 0; kc < L; kc += KT, buf ^= 1) {
    if (kc + KT < L) load_kv(buf ^ 1, kc + KT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const int nk = min(KT, L - kc);
      const int c_hi = (nk + 15) / 16;
      const bf16* Kt = KVs + buf * 2 * LanesSmem<DP>::kKV;
      const bf16* Vt = Kt + LanesSmem<DP>::kKV;

      float s[NC][2][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int n = 0; n < 2; ++n) s[c][n][0] = s[c][n][1] = s[c][n][2] = s[c][n][3] = 0.f;
        if (c >= c_hi) continue;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (c * 16 + (lane & 7) + (lane >> 4) * 8) * P + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[c][0], qf[kk], kf[0], kf[1]);
          mma_bf16(s[c][1], qf[kk], kf[2], kf[3]);
        }
      }
      // Scale, mask the keys past L, row maxima.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int key = c * 16 + n * 8 + 2 * t;
          const bool k0 = key < nk, k1 = key + 1 < nk;
          s[c][n][0] = k0 ? s[c][n][0] * sl2 : -INFINITY;
          s[c][n][1] = k1 ? s[c][n][1] * sl2 : -INFINITY;
          s[c][n][2] = k0 ? s[c][n][2] * sl2 : -INFINITY;
          s[c][n][3] = k1 ? s[c][n][3] * sl2 : -INFINITY;
          mx0 = fmaxf(mx0, fmaxf(s[c][n][0], s[c][n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[c][n][2], s[c][n][3]));
        }
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
      // P = exp2(s - max), rounded to bf16 for the P.V product; the row
      // sums add the rounded values.
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= c_hi) continue;
        uint32_t pa[4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const __nv_bfloat162 p01 =
              __floats2bfloat162_rn(exp2f(s[c][n][0] - mn0), exp2f(s[c][n][1] - mn0));
          const __nv_bfloat162 p23 =
              __floats2bfloat162_rn(exp2f(s[c][n][2] - mn1), exp2f(s[c][n][3] - mn1));
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
          mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
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
  bf16* d0 = o + prob * ob + h * oh + (long)r0 * ol;
  bf16* d1 = d0 + 8 * ol;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < D) {
      if (r0 < L)
        *reinterpret_cast<__nv_bfloat162*>(d0 + col) =
            __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
      if (r1 < L)
        *reinterpret_cast<__nv_bfloat162*>(d1 + col) =
            __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

}  // namespace
}  // namespace spk

extern "C" {

// q / k / v / o: pointer and element strides (problem, token, head) of each
// [problems, L, heads, D] view; D a multiple of 8, at most 128.
int sp_lanes_attention(const void* q, long qb, long ql, long qh, const void* k, long kb,
                       long kl, long kh, const void* v, long vb, long vl, long vh, void* o,
                       long ob, long ol, long oh, int problems, int heads, int L, int D,
                       float scale, void* stream) {
  using namespace spk;
  const int nqb = (L + LA_ROWS - 1) / LA_ROWS;
  const dim3 grid((unsigned)((long)problems * nqb), heads);
  const dim3 block(LA_WARPS * 32);
  const View qv{(const bf16*)q, qb, ql, qh}, kv{(const bf16*)k, kb, kl, kh},
      vv{(const bf16*)v, vb, vl, vh};
  cudaStream_t st = (cudaStream_t)stream;
#define SPK_LANES_CASE(DPV)                                                             \
  case DPV: {                                                                           \
    const int smem = LanesSmem<DPV>::kBytes;                                            \
    cudaFuncSetAttribute(lanes_attention_kernel<DPV>,                                   \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);            \
    lanes_attention_kernel<DPV><<<grid, block, smem, st>>>(qv, kv, vv, (bf16*)o, ob, ol, \
                                                           oh, L, D, nqb, scale);       \
    break;                                                                              \
  }
  switch ((D + 15) / 16 * 16) {
    SPK_LANES_CASE(16)
    SPK_LANES_CASE(32)
    SPK_LANES_CASE(48)
    SPK_LANES_CASE(64)
    SPK_LANES_CASE(80)
    SPK_LANES_CASE(96)
    SPK_LANES_CASE(112)
    SPK_LANES_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPK_LANES_CASE
  return (int)cudaGetLastError();
}

}  // extern "C"
