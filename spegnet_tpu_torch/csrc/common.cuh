// Shared device helpers for the hand-written Hopper kernels of spegnet_tpu_torch.
//
// Every C entry point in this directory launches on the stream it is given,
// allocates nothing and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Activations and matmul weights are bf16, or f32
// under f32 compute; LayerNorm and folded-BN parameters are f32; products
// accumulate in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda.h>

#include <cstdint>

namespace spk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }

// 8 bf16 values packed in 16 bytes (a uint4) are the unit of every vector
// load and store; these views read and write its lanes.
__device__ __forceinline__ bf16* lanes(uint4& v) { return reinterpret_cast<bf16*>(&v); }

__device__ __forceinline__ __nv_bfloat162* pairs(uint4& v) {
  return reinterpret_cast<__nv_bfloat162*>(&v);
}

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

__device__ __forceinline__ long lmax(long a, long b) { return a > b ? a : b; }

__device__ __forceinline__ uint4 zero_vec8() { return make_uint4(0u, 0u, 0u, 0u); }

// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80+ PTX, used on sm_90a).
//
// mma.m16n8k16 bf16 -> f32 fragments, lane = 4 * g + t (g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..),
//                            a3 (g+8, 8+2t..)
//   B (16 x 8, "col"):       b0 (k 2t..2t+1, n g), b1 (k 8+2t.., n g)
//   C (16 x 8, f32):         c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l supplies the address of row l % 8 of
// matrix l / 8 and receives r[j] = its fragment of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.m16n8k32 s8 x s8 -> s32 fragments, lane = 4g + t: A (16 x 32 row-major)
// a0 (row g, k 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..), a3 (g+8, 16+4t..);
// B (32 x 8, "col") b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g); C as for bf16.
// With A rows and B columns (n) stored as rows of bytes, ldmatrix_x4 (b16
// units) loads both: A at row (lane & 7) + ((lane >> 3) & 1) * 8, byte
// (lane >> 4) * 16; B for n8 tiles 2p, 2p+1 at row (lane & 7) + (lane >> 4) * 8,
// byte ((lane >> 3) & 1) * 16, as {r0, r1} and {r2, r3}.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.m16n8k8 tf32 -> f32 fragments, lane = 4g + t: A (16 x 8 row-major)
// a0 (row g, k t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B (8 x 8, "col")
// b0 (k t, n g), b1 (k t+4, n g); C as for bf16.  The tensor cores read the
// top 19 bits of each operand (sign, exponent, 10 mantissa bits).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: v = big + small, big = v rounded to tf32 (low 13 bits cleared),
// small = (v - big) rounded to tf32.  Then a b = big_a big_b + big_a small_b
// + small_a big_b + small_a small_b, and the last term (~2^-22 of the
// product) is dropped: ~f32 accuracy on the TF32 tensor cores.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// The small part of v when its big part is v truncated to tf32 (low 13 bits
// cleared): the tensor cores read only an operand's top 19 bits, so v's own
// bits serve as its big part, and no big copy is written.  small = (v -
// trunc(v)) rounded to tf32; big + small is within 2^-22 of v.
__device__ __forceinline__ uint32_t tf32_small(float v) {
  return tf32_rna(v - __uint_as_float(__float_as_uint(v) & 0xffffe000u));
}

// c += a b with the 3xTF32 split of both operands.  The tensor cores sum
// the three products from zero (small ones first) and the result is added
// to c on the FP32 pipe: their own accumulation truncates, which over a
// long sum (K 4608, 4096 keys) biases c by ~1e-5 of it; added here it
// rounds to nearest.
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4],
                                           const uint32_t as[4], const uint32_t bb[2],
                                           const uint32_t bs[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb[0], bb[1]);
  mma_tf32(t, ab, bs[0], bs[1]);
  mma_tf32(t, ab, bb[0], bb[1]);
  c[0] += t[0];
  c[1] += t[1];
  c[2] += t[2];
  c[3] += t[3];
}

// Non-negative floats order as their bit patterns do, so an int atomicMax
// takes their maximum (the buffer starts at 0).
__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0
// zero-fills the destination (out-of-range tiles).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// Hopper warpgroup MMA (wgmma), operands from shared memory.
// ---------------------------------------------------------------------------

// Descriptor of a K-major bf16 tile stored with the 128-byte swizzle: rows of
// 64 elements (128 B), 8-row groups 1024 B apart, the 16-byte chunk c of row
// r stored at chunk c ^ (r % 8).  The tile base must be 1024-byte aligned;
// advancing k by 16 elements adds 32 B to the start address.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes generic-proxy writes to shared memory (cp.async, st.shared) visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x N] (f32, N/2 registers per thread) += A[64 x 16] B[16 x N], both
// K-major in shared memory; N = 2 * (length of d).  Thread (warp w of the
// warpgroup, lane 4g + t) holds, for n8 block j: d[4j], d[4j+1] at row
// 16w + g, columns 8j + 2t, +1 and d[4j+2], d[4j+3] at row 16w + g + 8.
__device__ __forceinline__ void wgmma_m64k16(float (&d)[64], uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA (sm_90).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The tensor-map encoder cuTensorMapEncodeTiled, looked up once (null
// where it is missing).
typedef CUresult (*TmapEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TmapEncodeFn tmap_encoder() {
  static TmapEncodeFn encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TmapEncodeFn>(fn)
               : nullptr;
  }();
  return encode;
}

// 2-D TMA load of the box at (x = inner coordinate, y = outer coordinate)
// into shared memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, uint64_t* bar, int x,
                                            int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// jax.nn.gelu(approximate=True): 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// gelu_tanh with its tanh on the SFU: 0.5 x (1 + tanh(u)) = x / (1 +
// exp(-2u)), the exponential by ex2.approx and the reciprocal by
// rcp.approx (relative error ~2^-21): the bf16 GEMM epilogues' GELU
// (hiera_block.cu), two MUFU instructions where tanhf takes ~20 on the FMA
// pipe.  About 0.004% of the outputs rounded to bf16 differ from
// gelu_tanh's, by one step.  tanh.approx.f32 (one MUFU instruction) is not
// used: its absolute error, ~2^-11, makes 1 + tanh(u) wrong for u below ~-2
// (0.13% of the outputs differed, and the 512^2 training gradient's cosine
// to f32 fell from 0.91 to 0.26 on an H100).
__device__ __forceinline__ float gelu_tanh_sfu(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(-2.8853900817779268f * u));  // exp(-2u)
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + e));
  return x * r;
}

// jax.nn.gelu(approximate=False), torch's F.gelu: 0.5 x (1 + erf(x / sqrt(2))).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// d/dx of gelu_tanh.
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k0 = 0.7978845608028654f;
  const float th = tanhf(k0 * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * k0 * (1.0f + 0.134145f * x * x);
}

}  // namespace spk
