// PTX helpers of the bfloat16 tensor-core kernels (conv3x3_tc.cuh,
// conv3x3_dw_tc.cuh, flash_attn_tc.cuh, hamilton_matmul.cu, stft_mag.cu and
// the smallcin kernel of conv3x3_bn_relu_fpool.cu): ldmatrix,
// mma.sync.m16n8k16 with float accumulators, cp.async 16-byte copies and
// bf16 packing. The fragment layouts are PTX's for m16n8k16: lane l holds
// rows l / 4 (+ 8) and columns 2 (l % 4) (+ 1, + 8). The float32 kernels of
// K4 (flash_attn_fwd.cu), K6 (flash_attn_bwd.cu), K7 (hamilton_matmul.cu),
// the dW tile of K9 and K5 (conv3x3_dw_tf32.cuh), the conv-pool GEMM tile
// of K2w and K10a (pool_gemm_tf32.cuh) and the float conv tiles
// (conv3x3_tf32.cuh; conv3x3_smallcin_tf32.cuh: K2, K5's F1, F2, g_z)
// multiply with the split-TF32 helpers (split_tf32, mma_3xtf32,
// mma_3xtf32_add).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

static __device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Two floats rounded to bf16 in one word: lo in the low half, as a fragment holds them.
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16, row-major fragment) * b (16 x 8, column fragment), float sums.
static __device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- float32 on the tensor cores: three TF32 products (3xTF32) ----------
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi) (cvt.rna's rounding: to
// nearest, ties away from zero, the low 13 bits zero); a b ~ a_lo b_hi + a_hi
// b_lo + a_hi b_hi, each on mma.sync.m16n8k8.tf32 with float accumulators
// (the a_lo b_lo term, ~2^-22 |a b|, is dropped), as CUTLASS's
// OpMultiplyAddFastF32. The m16n8k8 fragments: A a0 (row g, col t), a1 (g +
// 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n
// g); C as m16n8k16's, (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); g
// = lane / 4, t = lane % 4.
//
// hi is cvt.rna.tf32.f32's, which keeps a NaN a NaN and an infinity an
// infinity. lo takes the cheap form of the same rounding, half a TF32 ulp
// added to the bits and the low 13 bits cleared: x - hi is finite for finite
// x, and there it equals cvt.rna's result. On x itself that form would carry
// a NaN whose fraction's top ten bits are ones (0x7fffffff, the card's own
// NaN) into the sign and give a zero. For a non-finite x, lo is a NaN or a
// zero and a_hi b_hi is non-finite, so a product with a non-finite operand
// is never finite (an infinity times an operand whose lo is 0 gives NaN
// through a_hi b_lo, where float32 gives the infinity).
static __device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

static __device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d += a (16 x 8, row-major fragment) * b (8 x 8, column fragment), tf32 operands.
static __device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in float32 from split operands: the two small terms, then the large one.
static __device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                                  const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                                  const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// acc += a b in float32 in two levels: the three products summed on the
// tensor cores from zero, then added to acc in registers, rounded to nearest.
// The tensor cores' own additions truncate (an ulp of the largest addend, the
// accumulator among them, each time), so a long chain on them drifts from
// float32's sums; one k8 step a chain keeps their error to the step's partial.
static __device__ __forceinline__ void mma_3xtf32_add(float (&acc)[4], const uint32_t (&a_hi)[4],
                                                      const uint32_t (&a_lo)[4],
                                                      const uint32_t (&b_hi)[2],
                                                      const uint32_t (&b_lo)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(p, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[e];
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (an unaligned or ragged row); src_bytes 0 writes a zero.
static __device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed cp.async groups are pending.
template <int N>
static __device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
