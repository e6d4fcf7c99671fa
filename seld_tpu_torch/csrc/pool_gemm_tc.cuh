// The bfloat16 GEMM tile of the two conv-pool stages whose conv row is one
// product over a packed operand: K10a (conv3x3_im2col.cu: the patches, K = 9
// Cin) and K2w (conv3x3_smallcin_wide.cu: the wide pack, K = 3 kg). Neither
// operand needs the tap shift of conv3x3_tc.cuh (the packs hold it), so the
// block is a plain GEMM tile on mma.sync.m16n8k16 (bf16 operands, float
// accumulators): M = 64 output channels, N = 128 frames, 8 warps of 32 x 32
// (2 x 4 m16n8 fragments). The C fragment is (channel, two adjacent
// frames), the output's layout, so the pooled row is stored as bf16 pairs.
// The epilogue folds each conv row into a running max of relu(acc * scale +
// bias) in registers: any pool_f, one row's accumulators live at a time.
#pragma once

#include "conv3x3_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kPgCo = 64;        // output channels (M) per block
constexpr int kPgT = 128;        // frames (N) per block
constexpr int kPgThreads = 256;  // 8 warps: 2 (M) x 4 (N) of 32 x 32

using PgAcc = float[2][4][4];    // [mi][ni][e] m16n8 fragments of a warp

// Channel (within the block's 64) and frame (within its 128) of fragment
// element [mi][ni][e]; warp w holds channels 32 (w / 4) .., frames 32 (w % 4) ..
static __device__ __forceinline__ int pg_m(int mi, int e) {
  return (threadIdx.x / 128) * 32 + mi * 16 + threadIdx.x % 32 / 4 + (e / 2) * 8;
}
static __device__ __forceinline__ int pg_n(int ni, int e) {
  return (threadIdx.x / 32 % 4) * 32 + ni * 8 + (threadIdx.x % 4) * 2 + (e % 2);
}

static __device__ __forceinline__ void pg_zero(PgAcc& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// acc += A B over one k16 step: a[mi] the A fragments of this warp's
// channels, b0 / b1 the B fragments of n8 tile ni (bb[ni][0..1]).
static __device__ __forceinline__ void pg_mma(PgAcc& acc, const uint32_t (&a)[2][4],
                                              const uint32_t (&bb)[4][2]) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], bb[ni][0], bb[ni][1]);
}

// The block's folded BN affine of this thread's four channels (clamped
// past Cout: those rows are never stored).
struct PgAffine {
  float sc[2][2], bi[2][2];
  __device__ __forceinline__ PgAffine(const float* __restrict__ scale,
                                      const float* __restrict__ bias, int co0, int cout) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = min(co0 + pg_m(mi, 2 * h), cout - 1);
        sc[mi][h] = __ldg(scale + co);
        bi[mi][h] = __ldg(bias + co);
      }
  }
  // best = max(best, relu(acc * scale + bias)); relu >= 0, so best starts at 0
  __device__ __forceinline__ void fold(PgAcc& best, const PgAcc& acc) const {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          best[mi][ni][e] =
              max_nan(best[mi][ni][e], bn_relu(acc[mi][ni][e], sc[mi][e / 2], bi[mi][e / 2]));
  }
};

// The pooled row (b, fo) of out (B, Cout, F / pf, T): channels past Cout
// and frames past T skipped; two frames per store where T is even.
static __device__ __forceinline__ void pg_store(bf16* __restrict__ out, const PgAcc& best,
                                                int b, int fo, int f_out, int co0, int t0,
                                                int cout, int t_dim) {
  const bool pairs = t_dim % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + pg_m(mi, 2 * h);
      if (co >= cout) continue;
      bf16* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int t = t0 + pg_n(ni, 0);
        const float* v = best[mi][ni] + 2 * h;
        if (pairs) {
          if (t < t_dim)
            *reinterpret_cast<__nv_bfloat162*>(orow + t) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (t < t_dim) orow[t] = __float2bfloat16(v[0]);
          if (t + 1 < t_dim) orow[t + 1] = __float2bfloat16(v[1]);
        }
      }
    }
}

}  // namespace
