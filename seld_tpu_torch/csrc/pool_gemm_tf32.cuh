// The float32 GEMM tile of K2w (conv3x3_smallcin_wide.cu) and K10a
// (conv3x3_im2col.cu): pool_gemm_tc.cuh's block (M = 64 output channels, N =
// 128 frames, 8 warps of 32 x 32, each 2 x 4 m16n8 fragments in float
// accumulators, PgAcc's layout, PgAffine's epilogue) on
// mma.sync.m16n8k8 TF32 products in split TF32 (mma.cuh): every k8 step is
// mma_3xtf32_add, three TF32 products summed on the tensor cores from zero,
// then added to the float accumulators rounded to nearest, so no chain on
// the tensor cores is longer than one k8 step (K10a's stage 2 is 216 steps
// deep). hi is cvt.rna's, so a NaN stays a NaN.
//
// The A operand is the weights, split once as they are staged into hi and
// lo planes of 32-bit words; the B operand is the pack rows (K2w: [k][frame])
// or the patch rows (K10a: [frame][k]), raw floats split as each warp reads
// them (split once at staging into a lo plane beside, K2w ran 1.25x and K10a
// 1.6-1.7x slower: the doubled shared memory leaves one block an SM). A
// fragment read (8 rows x 4 words) hits 32 banks where the row
// stride is 4 mod 8 words ([row][k]) or 8 mod 32 ([k][row]): each kernel
// pads its staged rows so. m16n8k8's C fragment is m16n8k16's, so pg_m /
// pg_n name an accumulator's channel and frame as in the bf16 tile.
#pragma once

#include "pool_gemm_tc.cuh"

namespace {

// hi and lo of one m16n8k8 A fragment per m16 tile of this warp, at k step
// k0: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// the planes [m][k] (ld words a row: kKMajor) or [k][m] (ld words a k).
template <bool kKMajor>
static __device__ __forceinline__ void pgf_load_a(const uint32_t* __restrict__ hi,
                                                  const uint32_t* __restrict__ lo, int ld, int k0,
                                                  uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = (threadIdx.x / 128) * 32 + mi * 16 + g + (r % 2) * 8;
      const int k = k0 + t + (r / 2) * 4;
      const int at = kKMajor ? m * ld + k : k * ld + m;
      ah[mi][r] = hi[at];
      al[mi][r] = lo[at];
    }
}

// acc += A B over one k8 step: ah / al this warp's A fragments, b[ni] the raw
// float B values (k t, n g) and (k t + 4, n g) of n8 tile ni, split here.
static __device__ __forceinline__ void pgf_mma(PgAcc& acc, const uint32_t (&ah)[2][4],
                                               const uint32_t (&al)[2][4],
                                               const float (&b)[4][2]) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    uint32_t bh[2], bl[2];
    split_tf32(b[ni][0], bh[0], bl[0]);
    split_tf32(b[ni][1], bh[1], bl[1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_3xtf32_add(acc[mi][ni], ah[mi], al[mi], bh, bl);
  }
}

// The pooled row (b, fo) of out (B, Cout, F / pf, T) in float: channels past
// Cout and frames past T skipped; two frames per store where T is even.
static __device__ __forceinline__ void pgf_store(float* __restrict__ out, const PgAcc& best,
                                                 int b, int fo, int f_out, int co0, int t0,
                                                 int cout, int t_dim) {
  const bool pairs = t_dim % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + pg_m(mi, 2 * h);
      if (co >= cout) continue;
      float* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int t = t0 + pg_n(ni, 0);
        const float* v = best[mi][ni] + 2 * h;
        if (pairs) {
          if (t < t_dim) *reinterpret_cast<float2*>(orow + t) = make_float2(v[0], v[1]);
        } else {
          if (t < t_dim) orow[t] = v[0];
          if (t + 1 < t_dim) orow[t + 1] = v[1];
        }
      }
    }
}

}  // namespace
