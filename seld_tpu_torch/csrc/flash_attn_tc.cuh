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
// flash_dq_wide_tc_kernel, flash_dkv_wide_tc_kernel) and their float32
// counterparts in split TF32 (flash_fwd_wide_tf32_kernel,
// flash_dq_wide_tf32_kernel, flash_dkv_wide_tf32_kernel) use the wide_*
// helpers below, whose tiles take their row pitch and D at run time.
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
// The wide kernels, bfloat16 and float32: D a multiple of 32 (the wrapper
// zero-pads it, attention.head_dim_plan), output columns in groups of GW in
// {160, 192, 224, 256} (grid z). bf16 tiles are staged with a row pitch of
// their width + 8 (a multiple of 16 plus 8: 16-byte units per row odd, so
// the eight row addresses of an ldmatrix phase hit distinct banks); float
// tiles with their width + 4 (4 mod 8 words, as tf32_load_rows').
constexpr int kWideStages = 2;   // units in a wide kernel's cp.async ring

// rows [r0, r0 + kRows) of a (B, T, H, d) bf16 or float tensor from base
// (its column 0), columns [0, width) -> dst [kRows][pitch], rows past T
// zero-filled, by 16-byte cp.async copies of a block of kThreads threads.
template <int kThreads, int kRows = kAttnRows, typename T>
static __device__ __forceinline__ void wide_load_rows(T* __restrict__ dst, int pitch,
                                                      const T* __restrict__ src, size_t base,
                                                      size_t tstride, int r0, int t_dim,
                                                      int width) {
  constexpr int kVec = 16 / sizeof(T);   // elements a copy
  const int vecs = width / kVec;
  for (int e = threadIdx.x; e < kRows * vecs; e += kThreads) {
    const int r = e / vecs, c = e - r * vecs;
    const bool ok = r0 + r < t_dim;
    cp_async16(dst + r * pitch + kVec * c,
               ok ? src + base + static_cast<size_t>(r0 + r) * tstride + kVec * c : src,
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

// ---- float32 past 128: the wide kernels' tiles in split TF32 -------------
// Every product is mma_3xtf32_add (mma.cuh): each k8 step's three products
// summed from zero and added in float. Operands are split into hi + lo as
// their fragments are read, or (kStaged: K4's streamed tiles where a plane
// fits beside them) once a unit lands, hi in place and lo into a plane at
// `lo` floats from it (wide_tf32_split_unit), so that the block splits each
// element once instead of once a warp. The P (dS) operand of a product over
// keys takes them permuted within each 8-group, slot t = key 2t, slot t + 4
// = key 2t + 1 (K6's float passes at D <= 128), and the B tile is read at
// rows 2t and 2t + 1, which a pitch of 4 mod 8 words keeps free of bank
// conflicts.

// hi + lo of n floats (a multiple of 4) from x, hi in place and lo at x + lo,
// by the block's kThreads threads.
template <int kThreads>
static __device__ __forceinline__ void wide_tf32_split_unit(float* __restrict__ x, int lo, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * kThreads) {
    const float4 v = *reinterpret_cast<const float4*>(x + e);
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(x + e) = h;
    *reinterpret_cast<uint4*>(x + e + lo) = l;
  }
}

// The B fragment (hi, lo) at p and p + step: split as it is read, or read
// from the split unit (hi in place, lo at p + lo).
template <bool kStaged>
static __device__ __forceinline__ void tf32_bfrag(const float* __restrict__ p, int step, int lo,
                                                  uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  if constexpr (kStaged) {
    bh[0] = __float_as_uint(p[0]);
    bh[1] = __float_as_uint(p[step]);
    bl[0] = __float_as_uint(p[lo]);
    bl[1] = __float_as_uint(p[lo + step]);
  } else {
    split_tf32(p[0], bh[0], bl[0]);
    split_tf32(p[step], bh[1], bl[1]);
  }
}

// s (16 x kN) += A B^T over `width` columns (a multiple of 8): A the 16 rows
// of a staged float tile from `a` (pitch pa), B kN rows from `b` (pitch pb;
// split at `lo` where kStaged); s[nt] is columns (B rows) 8 nt .. 8 nt + 7.
// One k8 step at a time (unrolled by 2, K4's 256-column group spilled).
template <int kN, bool kStaged = false>
static __device__ __forceinline__ void wide_tf32_abt(float (&s)[kN / 8][4],
                                                     const float* __restrict__ a, int pa,
                                                     const float* __restrict__ b, int pb,
                                                     int width, int lo = 0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* ar = a + g * pa + t;
  const float* br = b + g * pb + t;
#pragma unroll 1
  for (int kd = 0; kd < width; kd += 8) {
    uint32_t ah[4], al[4];
    split_tf32(ar[kd], ah[0], al[0]);
    split_tf32(ar[8 * pa + kd], ah[1], al[1]);
    split_tf32(ar[kd + 4], ah[2], al[2]);
    split_tf32(ar[8 * pa + kd + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      uint32_t bh[2], bl[2];
      tf32_bfrag<kStaged>(br + 8 * nt * pb + kd, 4, lo, bh, bl);
      mma_3xtf32_add(s[nt], ah, al, bh, bl);
    }
  }
}

// The permuted A fragment (hi, lo) of keys 8 kk .. 8 kk + 7 of a 16 x 64
// S-shaped accumulator p: slots t, t + 4 = keys 2t, 2t + 1, so c0, c2, c1, c3.
static __device__ __forceinline__ void tf32_pfrag(const float (&p)[kAttnRows / 8][4], int kk,
                                                  uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(p[kk][0], ah[0], al[0]);
  split_tf32(p[kk][2], ah[1], al[1]);
  split_tf32(p[kk][1], ah[2], al[2]);
  split_tf32(p[kk][3], ah[3], al[3]);
}

// The same fragment of 16 rows x 64 keys staged as floats at x (pitch px):
// rows g and g + 8, keys 8 kk + 2t and + 1 (one float2 each).
static __device__ __forceinline__ void tf32_xfrag(const float* __restrict__ x, int px, int kk,
                                                  uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int lane = threadIdx.x % 32;
  const float* xr = x + (lane / 4) * px + 8 * kk + 2 * (lane % 4);
  const float2 r0 = *reinterpret_cast<const float2*>(xr);
  const float2 r1 = *reinterpret_cast<const float2*>(xr + 8 * px);
  split_tf32(r0.x, ah[0], al[0]);
  split_tf32(r1.x, ah[1], al[1]);
  split_tf32(r0.y, ah[2], al[2]);
  split_tf32(r1.y, ah[3], al[3]);
}

// o (16 x kW) += A (16 x 64, afrag(kk, hi, lo) its permuted k8 fragments)
// times 64 rows x kW columns of a staged float tile from `rows` (pitch pr;
// split at `lo` where kStaged).
template <int kW, bool kStaged = false, typename AFrag>
static __device__ __forceinline__ void wide_tf32_av(float (&o)[kW / 8][4], AFrag&& afrag,
                                                    const float* __restrict__ rows, int pr,
                                                    int lo = 0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* rr = rows + 2 * t * pr + g;
#pragma unroll
  for (int kk = 0; kk < kAttnRows / 8; ++kk) {
    uint32_t ah[4], al[4];
    afrag(kk, ah, al);
#pragma unroll
    for (int dt = 0; dt < kW / 8; ++dt) {   // rows 8 kk + 2t, + 1, column 8 dt + g
      uint32_t bh[2], bl[2];
      tf32_bfrag<kStaged>(rr + 8 * kk * pr + 8 * dt, pr, lo, bh, bl);
      mma_3xtf32_add(o[dt], ah, al, bh, bl);
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
