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

// s += A B^T over D: afrag(kd, a) gives A's fragment of step kd, `rows` is a
// staged [64][D + 8] tile; s[nt] is columns (tile rows) 8 nt .. 8 nt + 7.
// The head dims past 128 sum S over 128-column slices of D with it.
template <int D, typename AFrag>
static __device__ __forceinline__ void attn_mma_abt_acc(float (&s)[kAttnRows / 8][4],
                                                        AFrag&& afrag,
                                                        const bf16* __restrict__ rows) {
  const int lane = threadIdx.x % 32, jq = lane / 8, r8 = lane % 8;
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

// s = A B^T over D (attn_mma_abt_acc from zero).
template <int D, typename AFrag>
static __device__ __forceinline__ void attn_mma_abt(float (&s)[kAttnRows / 8][4], AFrag&& afrag,
                                                    const bf16* __restrict__ rows) {
#pragma unroll
  for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  attn_mma_abt_acc<D>(s, afrag, rows);
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

// ---- head dims past 128 (flash_attn_fwd.cu, flash_attn_bwd.cu) -----------
// D, a multiple of 128 there (the wrapper zero-pads it), is walked in
// 128-column slices: a block owns one slice of its outputs (grid z) and sums
// every S (and dP) over all of D, slice by slice, so each product keeps the
// D = 128 tile's registers whatever D is. The (rows, slice) tiles stream
// through a two-stage cp.async ring of units of two [64][136] tiles.
constexpr int kSliceD = 128;
constexpr int kSliceP = kSliceD + 8;
constexpr int kSliceTile = kAttnRows * kSliceP;   // bf16 elements of one staged tile
constexpr size_t kSliceSmem = sizeof(bf16) * 2 * 2 * kSliceTile;

// float32 (the SIMT slice kernels, 256 threads): rows [r0, r0 + 64) of a
// (B, T, H, d) tensor at base, columns [c0, c0 + 128) -> dst [64][kSliceW]
// floats, zeros past T.
constexpr int kSliceW = kSliceD + 1;
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

// The A fragment of step kd of this warp's rows of a staged slice tile.
struct SliceFrag {
  const bf16* tile;
  __device__ __forceinline__ void operator()(int kd, uint32_t (&a)[4]) const {
    attn_ldsm_a<kSliceD>(tile, kd, a);
  }
};

}  // namespace
