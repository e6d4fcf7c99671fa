// The bfloat16 attention tiles of K6's backward (flash_attn_bwd.cu), whose
// row loader K4's forward (flash_attn_fwd.cu) shares: a block of 4 warps
// owns 64 rows of one (b, h), 16 per warp, and streams 64-row tiles of the
// other operand through shared memory. Rows are staged [64][D + 8]
// (16-byte units per row odd, so the eight row addresses of an ldmatrix
// phase hit distinct banks).
// The two products of FlashAttention on mma.sync.m16n8k16 (bf16 operands,
// float accumulators):
// - attn_mma_abt: S (16 x 64) = A (this warp's 16 rows x D) times the tile's
//   rows transposed (Q K^T, dO V^T, and the backward's K Q^T, V dO^T);
// - attn_mma_pv: O (16 x D) += P (16 x 64, an S-shaped accumulator rounded
//   to bf16 in registers: its fragment is already the A operand) times the
//   tile (P V, dS K, and the backward's P^T dO, dS^T Q).
// Past head dim 128 the bf16 kernels (flash_fwd_wide_tc_kernel,
// flash_dq_wide_tc_kernel, flash_dkv_wide_tc_kernel) use the wide_* helpers
// below, whose tiles take their row pitch and D at run time.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kAttnRows = 64;      // rows per block and per streamed tile
constexpr int kAttnThreads = 128;  // 4 warps x 16 rows

// rows [r0, r0 + kRows) of a (B, T, H, D) tensor at (b, h) -> dst
// [kRows][D + 8], rows past T zero-filled, by 16-byte cp.async copies of a
// block of kThreads threads.
template <int D, int kRows = kAttnRows, int kThreads = kAttnThreads>
static __device__ __forceinline__ void attn_load_rows(bf16* __restrict__ dst,
                                                      const bf16* __restrict__ src, size_t base,
                                                      size_t tstride, int r0, int t_dim) {
  constexpr int kVecs = D / 8;
  for (int e = threadIdx.x; e < kRows * kVecs; e += kThreads) {
    const int r = e / kVecs, c = e % kVecs;
    const bool ok = r0 + r < t_dim;
    cp_async16(dst + r * (D + 8) + 8 * c,
               ok ? src + base + static_cast<size_t>(r0 + r) * tstride + 8 * c : src,
               ok ? 16 : 0);
  }
}

// The float tiles of the split-TF32 kernels (K4's flash_fwd_tf32_kernel,
// K6's flash_dq_tf32_kernel and flash_dkv_tf32_kernel): rows [r0, r0 + 64)
// of a (B, T, H, D) float tensor at base -> dst [64][D + 4] (a pitch of 4
// mod 8 words), rows past T zero-filled, by 16-byte cp.async copies.
template <int D>
static __device__ __forceinline__ void tf32_load_rows(float* __restrict__ dst,
                                                      const float* __restrict__ src, size_t base,
                                                      size_t tstride, int r0, int t_dim) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kAttnRows * kVecs; e += kAttnThreads) {
    const int r = e / kVecs, c = e % kVecs;
    const bool ok = r0 + r < t_dim;
    cp_async16(dst + r * (D + 4) + 4 * c,
               ok ? src + base + static_cast<size_t>(r0 + r) * tstride + 4 * c : src,
               ok ? 16 : 0);
  }
}

// The A fragment (16 rows x 16 of D, step kd) of this warp's rows of a
// staged [64][D + 8] tile.
template <int D>
static __device__ __forceinline__ void attn_ldsm_a(const bf16* __restrict__ tile, int kd,
                                                   uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  ldsm_x4(tile + (warp * 16 + (lane / 8 % 2) * 8 + lane % 8) * (D + 8) + kd * 16 +
              (lane / 16) * 8,
          a);
}

// s = A B^T over D: afrag(kd, a) gives A's fragment of step kd, `rows` is a
// staged [64][D + 8] tile; s[nt] is columns (tile rows) 8 nt .. 8 nt + 7.
template <int D, typename AFrag>
static __device__ __forceinline__ void attn_mma_abt(float (&s)[kAttnRows / 8][4], AFrag&& afrag,
                                                    const bf16* __restrict__ rows) {
  const int lane = threadIdx.x % 32, jq = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4];
    afrag(kd, a);
#pragma unroll
    for (int np = 0; np < kAttnRows / 16; ++np) {
      uint32_t t4[4];   // rows (0-7, d 0-7), (0-7, d 8-15), (8-15, d 0-7), (8-15, d 8-15)
      ldsm_x4(rows + (np * 16 + (jq / 2) * 8 + r8) * (D + 8) + kd * 16 + (jq % 2) * 8, t4);
      mma_bf16(s[2 * np], a, t4[0], t4[1]);
      mma_bf16(s[2 * np + 1], a, t4[2], t4[3]);
    }
  }
}

// o += p `rows`: p (16 x 64, S-shaped) rounded to bf16 as the A operand,
// `rows` a staged [64][D + 8] tile read transposed by ldmatrix.trans.
template <int D>
static __device__ __forceinline__ void attn_mma_pv(float (&o)[D / 8][4],
                                                   const float (&p)[kAttnRows / 8][4],
                                                   const bf16* __restrict__ rows) {
  const int lane = threadIdx.x % 32, jq = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int kk = 0; kk < kAttnRows / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      // matrices (rows 0-7, d 0-7), (8-15, d 0-7), (0-7, d 8-15), (8-15, d 8-15)
      uint32_t t4[4];
      ldsm_x4_t(rows + (kk * 16 + (jq % 2) * 8 + r8) * (D + 8) + dp * 16 + (jq / 2) * 8, t4);
      mma_bf16(o[2 * dp], a, t4[0], t4[1]);
      mma_bf16(o[2 * dp + 1], a, t4[2], t4[3]);
    }
  }
}

// ---- head dims past 128 ------------------------------------------------
// float32 (the SIMT slice kernels, 256 threads; bfloat16 past the wide
// kernels' largest D too): D, a multiple of 128, is walked in 128-column
// slices, one output slice a block (grid z).
constexpr int kSliceD = 128;
constexpr int kSliceW = kSliceD + 1;   // padded row of a staged float slice

// rows [r0, r0 + 64) of a (B, T, H, d) tensor at base, columns [c0, c0 +
// 128) -> dst [64][kSliceW] floats, zeros past T.
template <typename T>
static __device__ __forceinline__ void stage_slice_f32(float* __restrict__ dst,
                                                       const T* __restrict__ src, size_t base,
                                                       size_t tstride, int r0, int c0,
                                                       int t_dim) {
  for (int e = threadIdx.x; e < kAttnRows * kSliceD; e += 256) {
    const int r = e / kSliceD, c = e % kSliceD;
    dst[r * kSliceW + c] =
        r0 + r < t_dim ? to_f(src[base + (r0 + r) * tstride + c0 + c]) : 0.f;
  }
}

// bfloat16 (the wide kernels): D a multiple of 32 (the wrapper zero-pads it,
// attention.head_dim_plan), output columns in groups of GW in {160, 192,
// 224, 256} (grid z). Tiles are staged with a row pitch of their width + 8
// (a multiple of 16 plus 8: 16-byte units per row odd, so the eight row
// addresses of an ldmatrix phase hit distinct banks).
constexpr int kWideStages = 2;   // units in a wide kernel's cp.async ring

// rows [r0, r0 + kRows) of a (B, T, H, d) tensor from base (its column 0),
// columns [0, width) -> dst [kRows][pitch], rows past T zero-filled, by
// 16-byte cp.async copies of a block of kThreads threads.
template <int kThreads, int kRows = kAttnRows>
static __device__ __forceinline__ void wide_load_rows(bf16* __restrict__ dst, int pitch,
                                                      const bf16* __restrict__ src,
                                                      size_t base, size_t tstride, int r0,
                                                      int t_dim, int width) {
  const int vecs = width / 8;
  for (int e = threadIdx.x; e < kRows * vecs; e += kThreads) {
    const int r = e / vecs, c = e - r * vecs;
    const bool ok = r0 + r < t_dim;
    cp_async16(dst + r * pitch + 8 * c,
               ok ? src + base + static_cast<size_t>(r0 + r) * tstride + 8 * c : src,
               ok ? 16 : 0);
  }
}

// s (16 x kN) += A B^T over `width` columns (a multiple of 16): A the 16 rows
// of a staged tile from `a` (its row 0, column 0; pitch pa), B kN rows from
// `b` (pitch pb); s[nt] is columns (B rows) 8 nt .. 8 nt + 7.
template <int kN>
static __device__ __forceinline__ void wide_mma_abt(float (&s)[kN / 8][4],
                                                    const bf16* __restrict__ a, int pa,
                                                    const bf16* __restrict__ b, int pb,
                                                    int width) {
  const int lane = threadIdx.x % 32, jq = lane / 8, r8 = lane % 8;
  const bf16* ap = a + ((lane / 8 % 2) * 8 + r8) * pa + (lane / 16) * 8;
  const bf16* bp = b + ((jq / 2) * 8 + r8) * pb + (jq % 2) * 8;
#pragma unroll 2
  for (int kd = 0; kd < width; kd += 16) {
    uint32_t af[4];
    ldsm_x4(ap + kd, af);
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      uint32_t t4[4];   // B rows (0-7, d 0-7), (0-7, d 8-15), (8-15, d 0-7), (8-15, d 8-15)
      ldsm_x4(bp + np * 16 * pb + kd, t4);
      mma_bf16(s[2 * np], af, t4[0], t4[1]);
      mma_bf16(s[2 * np + 1], af, t4[2], t4[3]);
    }
  }
}

// p (16 x 64, S-shaped accumulators) rounded to bf16 as four A fragments, one
// per 16 columns.
static __device__ __forceinline__ void wide_pack_a(const float (&p)[kAttnRows / 8][4],
                                                   uint32_t (&a)[kAttnRows / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kAttnRows / 16; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// The four A fragments of 16 rows x 64 columns of a staged bf16 tile (its
// row 0, column 0 at `x`, pitch px).
static __device__ __forceinline__ void wide_ldsm_a(const bf16* __restrict__ x, int px,
                                                   uint32_t (&a)[kAttnRows / 16][4]) {
  const int lane = threadIdx.x % 32;
  const bf16* xp = x + ((lane / 8 % 2) * 8 + lane % 8) * px + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kAttnRows / 16; ++kk) ldsm_x4(xp + kk * 16, a[kk]);
}

// o (16 x kW) += A (16 x 64, four fragments) times 64 rows x kW columns of a
// staged tile from `rows` (pitch pr), read transposed by ldmatrix.trans.
template <int kW>
static __device__ __forceinline__ void wide_mma_av(float (&o)[kW / 8][4],
                                                   const uint32_t (&a)[kAttnRows / 16][4],
                                                   const bf16* __restrict__ rows, int pr) {
  const int lane = threadIdx.x % 32, jq = lane / 8, r8 = lane % 8;
  const bf16* rp = rows + ((jq % 2) * 8 + r8) * pr + (jq / 2) * 8;
#pragma unroll
  for (int kk = 0; kk < kAttnRows / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < kW / 16; ++dp) {
      // matrices (rows 0-7, d 0-7), (8-15, d 0-7), (0-7, d 8-15), (8-15, d 8-15)
      uint32_t t4[4];
      ldsm_x4_t(rp + kk * 16 * pr + dp * 16, t4);
      mma_bf16(o[2 * dp], a[kk], t4[0], t4[1]);
      mma_bf16(o[2 * dp + 1], a[kk], t4[2], t4[3]);
    }
  }
}

// A barrier of the two warps w and w + 4 of an 8-warp block (named barrier
// 1 + w % 4, 64 threads).
static __device__ __forceinline__ void pair_barrier() {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + threadIdx.x / 32 % 4) : "memory");
}

// The largest dynamic shared memory a block of this device may opt in to.
static inline int max_smem_optin() {
  static int n = [] {
    int dev = 0, bytes = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return bytes;
  }();
  return n;
}

// The widest chunk of D (d split evenly, a multiple of 16) at which a wide
// kernel's shared memory, smem(kc) bytes, fits a block; 0 where none does.
template <typename Smem>
static inline int wide_chunk(int d, Smem smem) {
  for (int nc = 1; 16 * nc <= d; ++nc) {
    const int kc = ceil_div(ceil_div(d, nc), 16) * 16;
    if (smem(kc) <= static_cast<size_t>(max_smem_optin())) return kc;
  }
  return 0;
}

}  // namespace
