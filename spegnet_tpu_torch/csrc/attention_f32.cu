// f32 self-attention over independent problems of L tokens, any L, on Hopper.
//
// The f32 form of attention_lanes.cu, for Hiera's f32 compute (`use_amp:
// false`).  Per (problem, head), softmax(q k^T * scale) v with f32 operands,
// f32 scores and an f32 softmax, as the TPU kernels compute at dt = f32.  It
// replaces spegnet_tpu/ops/pallas_attention.py `_lanes_kernel` (:199) and
// `_lanes_qblock_kernel` (:220) of `fused_attention_lanes` (#9), and
// `_attn_kernel` (:43) and `_qblock_kernel` (:68) of `fused_attention`
// (#8), and it is the window attention of the f32 gen-1 chain
// (spegnet_tpu/ops/fused_block.py `_kernel` :99, #7, and the int8 gen-1
// block spegnet_tpu/ops/fused_block_i8.py `_kernel_i8` :128, #12): each
// window of L 16 or 64 consecutive rows of the block's qkv is one problem.
//
// Operands are strided views [problems, L, heads, D] with D contiguous (the
// packed token-major qkv of an nn.Linear, or separate tensors), element
// strides multiples of 4, D a multiple of 4 up to 256 (the launcher,
// kernels.attention, zero-pads any other head dim to one); the output is
// written through the same kind of view.
//
// A block of 4 warps owns 64 query rows of one (problem, head); each warp 16
// rows.  Keys stream through shared memory in tiles of KT (64; 32 above a
// padded head dim of 160, so that Q and two K/V buffers fit), double-buffered
// with cp.async; the scores, the online softmax (exp2, running max and sum
// per row, f32) and the output accumulator stay in registers as mma
// fragments.  Both products run 3xTF32 on mma.sync.m16n8k8 (common.cuh),
// ~f32 accuracy; P is split like any operand, not rounded.  P.V needs no
// shuffle: the key order inside each 8-key chunk is permuted so that the
// score fragment (keys 2t, 2t+1 of row g) is P's A fragment (columns t,
// t+4), and V is read in the same order.  Rows past L are computed on zeros
// and not stored; keys past L are zero-filled and masked to -inf.
//
// Bound on the H100: 4 L^2 D FLOPs per (problem, head) against 16 L D bytes
// (q, k, v read once, o written once, f32): operations-bound above L ~ 200 at
// 165 TFLOP/s (3xTF32, common.cuh), bytes-bound below it (the gen-1
// windows of 16 and 64).
#include "common.cuh"

namespace spk {
namespace {

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

// q / k / v / o: pointer and element strides (problem, token, head) of each
// [problems, L, heads, D] f32 view; D a multiple of 4, at most 256.
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
  const int dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 48 ? 48 : D <= 64 ? 64 : D <= 72 ? 72
               : D <= 80 ? 80 : D <= 96 ? 96 : D <= 112 ? 112 : D <= 128 ? 128
               : D <= 144 ? 144 : D <= 160 ? 160 : D <= 192 ? 192 : D <= 224 ? 224 : 256;
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
  if (D > 256 || D % 4) return (int)cudaErrorInvalidValue;
  switch (dp) {
    SPK_AF_CASE(16)
    SPK_AF_CASE(32)
    SPK_AF_CASE(48)
    SPK_AF_CASE(64)
    SPK_AF_CASE(72)
    SPK_AF_CASE(80)
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

}  // extern "C"
