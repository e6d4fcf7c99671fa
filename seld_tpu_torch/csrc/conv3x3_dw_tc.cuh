// The bfloat16 weight gradient of a 3x3 conv (zero pad 1) on the tensor
// cores: dW[dy][dx][ci][co] = sum over (b, f, t) of gz[b][co][f][t] *
// h[b][ci][f + dy - 1][t + dx - 1], h (B, Cin, F, T) and gz (B, Cout, F, T)
// in bf16, zero outside the input. Each block writes one float partial row
// [tap][ci][co] of its share of the depth, for a reduction in a fixed order
// (launch_reduce): no atomics, so a rerun is bitwise equal. K9's B2
// (conv3x3_ct_train.cu) launches it with a 32-channel Cin tile, K5's B2
// (conv3x3_train.cu) with a 16-channel one (Cin <= 16: stage 1's 8-10
// channels would leave three quarters of a 32-channel tile empty); it
// assumes nothing of either beyond these layouts.
//
// What bounds it on the H100: arithmetic, 2 * 9 * Cin * Cout operations per
// (b, f, t), against one read of h and gz. It is a GEMM whose depth is the
// frames: per (b, f) row, M = 9 taps x Cin (h rows f - 1, f, f + 1, shifted
// by dx - 1 frames), N = Cout (gz row f), K = t, walked in 64-frame steps
// (four k16 steps of mma.sync.m16n8k16, bf16 operands, float
// accumulators). Both operands are contiguous along the depth: gz tiles
// [co][t] are the col-major B operand, read by plain ldmatrix, and one B
// fragment serves the three dx taps of every 16-channel m16 of the warp.
// Block tile: 9 taps x CI Cin (32 or 16) x 64 Cout, 6 warps (192 threads);
// warp (dy, Cout half) holds 3 dx x CI / 16 m16 x 4 n8 fragments, 96 (48)
// floats per thread.
//
// The tap shift. The A operand of tap dx is h moved by dx - 1 frames along
// the depth: at an odd shift the two frames a fragment register holds
// straddle two aligned 32-bit words, and ldmatrix cannot start a row at a
// 2-byte offset. Three shifted copies of the h tile would triple its
// staging and shared memory; instead h is staged once, aligned ([3 rows][CI
// channels][frames t0 - 8 .. t0 + 71], 44-word rows: 12 mod 32 banks, so the
// 8 rows x 4 word offsets of one 32-bit load hit 32 banks), and each thread
// loads the six words around its fragment (offsets 3-5 and 7-9 past its
// k16 step) and builds all three taps' registers from them: dx = 1 takes
// words 4 and 8, dx = 0 and 2 splice neighbours with one byte permute each,
// as conv3x3_tc.cuh pairs channels. Both tiles come by 16-byte cp.async
// (T % 8 == 0 and aligned tensors; else 2-byte loads and stores) into a
// two-stage ring: the next step loads while this one multiplies.
//
// The depth is split over (b, f) rows, and over frames where B * F is
// small (grid.x = row splits x frame splits, from the wrapper's
// rows_per_split and frames_per_split, the latter a multiple of 64): block
// x takes rows [rs * rows_per_split, ...) and frames [fs *
// frames_per_split, ...) with rs = x / frame_splits, fs = x % frame_splits.
// gz is zero past the block's last frame, h keeps its real halo frames.
// Ragged edges: h rows outside [0, F), channels past Cin and Cout, and
// frames outside [0, T) stage as zeros; partial rows store only ci < Cin and
// co < Cout, so any Cin and Cout work.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kDwCi = 32;          // K9's input channels per block (two m16 tiles per tap)
constexpr int kDwCiStage1 = 16;    // K5's: one m16 tile per tap
constexpr int kDwCo = 64;          // output channels per block
constexpr int kDwT = 64;           // frames per depth step: four k16 steps
constexpr int kDwThreads = 192;    // 6 warps: 3 (dy) x 2 (halves of the 64 Cout)
constexpr int kDwHGroups = kDwT / 8 + 2;   // 8-frame groups of a staged h row: t0 - 8 .. t0 + 71
constexpr int kDwHW = 44;          // 32-bit words per staged h row (40 used); 44 = 12 mod 32
constexpr int kDwGP = kDwT + 8;    // padded gz row: 144 bytes, 9 16-byte units (odd)

// One stage of h ([3][CI][88] bf16), one stage of h and gz (+ [64][72]), and
// the two-stage ring's bytes.
template <int CI>
__host__ __device__ constexpr int dw_h_elems() { return 3 * CI * 2 * kDwHW; }
template <int CI>
__host__ __device__ constexpr int dw_stage_elems() { return dw_h_elems<CI>() + kDwCo * kDwGP; }
template <int CI>
__host__ __device__ constexpr size_t dw_tc_smem() {
  return 2 * sizeof(bf16) * dw_stage_elems<CI>();
}

// Stage depth step (b, f, frames [t0, t0 + 64)): h rows f - 1 .. f + 1 of
// channels [c0, c0 + CI) at frames t0 - 8 .. t0 + 71 into hs [3 * CI][88],
// and gz rows [co0, co0 + 64) of row f at frames t0 .. t0 + 63 (zero from
// t_end) into gs [64][72]; zeros outside the input and past Cin / Cout.
template <int CI>
static __device__ __forceinline__ void dw_stage(bf16* __restrict__ hs, bf16* __restrict__ gs,
                                                const bf16* __restrict__ hb,
                                                const bf16* __restrict__ gb, int f, int t0,
                                                int t_end, int c0, int co0, int cin, int cout,
                                                int f_dim, int t_dim, bool vec) {
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;
  const int g_len = vec ? kDwHGroups : 8 * kDwHGroups;   // units of 8 frames or of one
  for (int e = threadIdx.x; e < 3 * CI * g_len; e += kDwThreads) {
    const int u = e % g_len, rest = e / g_len;   // rest = dy * CI + ci
    const int ci = c0 + rest % CI, fr = f - 1 + rest / CI;
    const int t = t0 - 8 + (vec ? 8 * u : u);
    const bool ok = ci < cin && fr >= 0 && fr < f_dim && t >= 0 && t < t_dim;
    const bf16* src = hb + ci * plane + static_cast<size_t>(fr) * t_dim + t;
    bf16* dst = hs + rest * 2 * kDwHW + (vec ? 8 * u : u);
    if (vec)
      cp_async16(dst, ok ? src : hb, ok ? 16 : 0);
    else
      *dst = ok ? *src : __float2bfloat16(0.f);
  }
  const int z_len = vec ? kDwT / 8 : kDwT;
  for (int e = threadIdx.x; e < kDwCo * z_len; e += kDwThreads) {
    const int u = e % z_len, co = e / z_len;
    const int t = t0 + (vec ? 8 * u : u);
    const bool ok = co0 + co < cout && t < t_end;
    const bf16* src = gb + (co0 + co) * plane + static_cast<size_t>(f) * t_dim + t;
    bf16* dst = gs + co * kDwGP + (vec ? 8 * u : u);
    if (vec)
      cp_async16(dst, ok ? src : gb, ok ? 16 : 0);
    else
      *dst = ok ? *src : __float2bfloat16(0.f);
  }
}

// The A register of tap dx from the words at offsets +3, +4, +5 (or +7, +8,
// +9) around a fragment: frames 2q + dx - 1 and 2q + dx of the row.
template <int DX>
static __device__ __forceinline__ uint32_t dw_shifted(const uint32_t (&w)[3]) {
  if constexpr (DX == 1) return w[1];
  return __byte_perm(w[DX / 2], w[DX / 2 + 1], 0x5432);   // high half, then low half
}

// acc += one staged depth step (four k16 steps) of this warp's 3 dx x CI Cin
// x 32 Cout; acc[mi][dx][ni] is channels mi * 16 .. + 15 of tap (dy, dx),
// Cout ni * 8 .. + 7 of the warp's half.
template <int CI>
static __device__ __forceinline__ void dw_mma_step(const bf16* __restrict__ stage, int wdy,
                                                   int wn, float (&acc)[CI / 16][3][4][4]) {
  const int lane = threadIdx.x % 32, jq = lane / 8, r8 = lane % 8;
  const uint32_t* hw = reinterpret_cast<const uint32_t*>(stage) +
                       (wdy * CI + lane / 4) * kDwHW + lane % 4;
  const bf16* gs = stage + dw_h_elems<CI>() + wn * 32 * kDwGP;
#pragma unroll
  for (int ks = 0; ks < kDwT / 16; ++ks) {
    uint32_t bq[4][2];   // gz: Cout (0-7, t 0-7), (0-7, t 8-15), (8-15, t 0-7), (8-15, t 8-15)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t t4[4];
      ldsm_x4(gs + (np * 16 + (jq / 2) * 8 + r8) * kDwGP + ks * 16 + (jq % 2) * 8, t4);
      bq[2 * np][0] = t4[0];
      bq[2 * np][1] = t4[1];
      bq[2 * np + 1][0] = t4[2];
      bq[2 * np + 1][1] = t4[3];
    }
#pragma unroll
    for (int mi = 0; mi < CI / 16; ++mi) {
      // rows g and g + 8 (channels mi * 16 + g (+ 8)): words 3-5 and 7-9 past 8 ks + q
      const uint32_t* r0 = hw + mi * 16 * kDwHW + 8 * ks;
      const uint32_t* r1 = r0 + 8 * kDwHW;
      const uint32_t lo0[3] = {r0[3], r0[4], r0[5]}, hi0[3] = {r0[7], r0[8], r0[9]};
      const uint32_t lo1[3] = {r1[3], r1[4], r1[5]}, hi1[3] = {r1[7], r1[8], r1[9]};
      const uint32_t a0[4] = {dw_shifted<0>(lo0), dw_shifted<0>(lo1), dw_shifted<0>(hi0),
                              dw_shifted<0>(hi1)};
      const uint32_t a1[4] = {dw_shifted<1>(lo0), dw_shifted<1>(lo1), dw_shifted<1>(hi0),
                              dw_shifted<1>(hi1)};
      const uint32_t a2[4] = {dw_shifted<2>(lo0), dw_shifted<2>(lo1), dw_shifted<2>(hi0),
                              dw_shifted<2>(hi1)};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_bf16(acc[mi][0][ni], a0, bq[ni][0], bq[ni][1]);
        mma_bf16(acc[mi][1][ni], a1, bq[ni][0], bq[ni][1]);
        mma_bf16(acc[mi][2][ni], a2, bq[ni][0], bq[ni][1]);
      }
    }
  }
}

// Grid (row splits x frame splits, ceil(Cout / 64), ceil(Cin / CI)); block
// x writes partial row x of (grid.x, 9 * Cin * Cout) floats.
template <int CI>
__global__ void __launch_bounds__(kDwThreads, CI == 16 ? 3 : 2)
ct_dw_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ gz,
                float* __restrict__ partials, int batch, int cin, int f_dim, int t_dim, int cout,
                int rows_per_split, int frames_per_split) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dw_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wdy = warp / 2, wn = warp % 2;
  const int frame_splits = ceil_div(t_dim, frames_per_split);
  const int rs = blockIdx.x / frame_splits, fs = blockIdx.x % frame_splits;
  const int row0 = rs * rows_per_split, row1 = min(batch * f_dim, row0 + rows_per_split);
  const int t_lo = fs * frames_per_split, t_hi = min(t_dim, t_lo + frames_per_split);
  const int co0 = blockIdx.y * kDwCo, c0 = blockIdx.z * CI;
  const int steps = max(ceil_div(t_hi - t_lo, kDwT), 0);
  const int total = max(row1 - row0, 0) * steps;
  const bool vec = t_dim % 8 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const size_t h_item = static_cast<size_t>(cin) * f_dim * t_dim;
  const size_t g_item = static_cast<size_t>(cout) * f_dim * t_dim;
  const auto stage = [&](int it, bf16* buf) {
    const int row = row0 + it / steps, t0 = t_lo + (it % steps) * kDwT;
    const int b = row / f_dim;
    dw_stage<CI>(buf, buf + dw_h_elems<CI>(), h + b * h_item, gz + b * g_item, row % f_dim, t0,
                 t_hi, c0, co0, cin, cout, f_dim, t_dim, vec);
  };

  float acc[CI / 16][3][4][4];
#pragma unroll
  for (int mi = 0; mi < CI / 16; ++mi)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][dx][ni][e] = 0.f;

  if (total > 0) {
    stage(0, smem);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {   // the next step loads while this one multiplies
      stage(it + 1, smem + ((it + 1) & 1) * dw_stage_elems<CI>());
      cp_async_commit();
    }
    dw_mma_step<CI>(smem + (it & 1) * dw_stage_elems<CI>(), wdy, wn, acc);
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }

  // the partial row is dW in w's layout: [tap][ci][co]
  float* prow = partials + static_cast<size_t>(blockIdx.x) * 9 * cin * cout;
  const bool pairs = cout % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < CI / 16; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ci = c0 + mi * 16 + lane / 4 + 8 * hh;
      if (ci >= cin) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int co = co0 + wn * 32 + ni * 8 + 2 * (lane % 4);
          float* p = prow + (static_cast<size_t>(wdy * 3 + dx) * cin + ci) * cout + co;
          const float v0 = acc[mi][dx][ni][2 * hh], v1 = acc[mi][dx][ni][2 * hh + 1];
          if (pairs && co + 1 < cout) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (co < cout) p[0] = v0;
            if (co + 1 < cout) p[1] = v1;
          }
        }
    }
}

}  // namespace
