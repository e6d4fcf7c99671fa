// The float32 weight gradient of a 3x3 conv (zero pad 1) on the tensor cores
// in split TF32: dW[dy][dx][ci][co] = sum over (b, f, t) of gz[b][co][f][t] *
// h[b][ci][f + dy - 1][t + dx - 1], h (B, Cin, F, T) and gz (B, Cout, F, T)
// float, zero outside the input. The float counterpart of conv3x3_dw_tc.cuh's
// bf16 tile, with its grid, its depth split (the wrapper's
// conv2d_train.dw_split) and its partial rows [tap][ci][co] for
// launch_reduce's fixed order: no atomics, so a rerun is bitwise equal. One
// template over the block's Cin tile CI: K9's B2 in float32
// (conv3x3_ct_train.cu) takes CI = 32; K5's (conv3x3_train.cu, stage 1's
// Cin <= 10) CI = 16 for Cin 9-16 and CI = 8 for Cin <= 8.
//
// What bounds it on the H100: arithmetic, 2 * 9 * Cin * Cout operations per
// (b, f, t), against one read of h and gz. In float32 on the FMA pipes that
// is 3.0 ms at the flagship's stage 2 (batch 2) and 1.0 ms at its stage 1;
// here every product is mma_3xtf32 (mma.cuh): three mma.sync.m16n8k8 TF32
// products on operands split into hi + lo as they are read, at float32's
// accuracy. The GEMM: per (b, f) row, M = 9 taps x Cin (h rows f - 1, f, f
// + 1, shifted by dx - 1 frames), N = Cout (gz row f), K = t in 64-frame
// steps of eight k8 steps. Both operands are read straight from their
// [channel][frame] tiles: the A operand of tap dx is h one word to the left
// or right (a 32-bit word holds one frame, so the bf16 tile's byte permutes
// go), and the B operand (k slot t, n g) is gz[co g][frame t].
// Block tile: 9 taps x CI Cin x 64 Cout; warp (dy, 16-channel m16 of the
// Cin tile, 32-channel half of the Cout tile): 12 warps at CI = 32, 6 at CI
// = 16 and 8. A warp holds 3 dx x 4 n8 fragments (48 floats a thread), one
// m16 per dx. At CI = 8 one m16 per dx would be half zeros and double the
// TF32 work, so the three dx taps are stacked in M instead: m16 tile 0 holds
// dx 0 (rows 0-7) and dx 1 (rows 8-15) of the 8 channels, tile 1 dx 2 and 8
// zero rows, 24 of 32 rows used (2 x 4 fragments, 32 floats a thread).
// Staged per step: h [3 rows][CI channels][frames t0 - 4 .. t0 + 67] in
// 76-word rows and gz [64][frames t0 .. t0 + 63] in 68-word rows (12 and 4
// mod 32: the 8 rows x 4 words of a fragment read hit 32 banks), by 16-byte
// cp.async (T % 4 == 0 and aligned tensors; else 4-byte loads and stores)
// into a two-stage ring: the next step loads while this one multiplies.
// Each thread reads the six words around its fragment (offsets 3-5 and 7-9
// past its k8 step) of its rows and splits each once for all three taps.
// Rounding: the tensor cores add into their accumulators without rounding
// to nearest, and a block's depth runs to B * F * T / 64 frames (4800 at
// stage 2). So each 64-frame step is summed on the tensor cores into a
// zeroed fragment (24 additions), then added to the float accumulators in
// registers, rounded to nearest (ops/kernels/tf32.py::conv_dw_tf32_plain
// repeats this arithmetic on the CPU).
// Ragged edges as the bf16 tile: h rows outside [0, F), channels past Cin
// and Cout and frames outside [0, T) stage as zeros; partial rows store only
// ci < Cin and co < Cout.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kDwfCi = 32;          // K9's input channels per block (two m16 tiles per tap)
constexpr int kDwfCiStage1 = 16;    // K5's at Cin 9-16: one m16 tile per tap
constexpr int kDwfCiStacked = 8;    // K5's at Cin <= 8: the three dx taps stacked in M
constexpr int kDwfCo = 64;          // output channels per block
constexpr int kDwfT = 64;           // frames per depth step: eight k8 steps
constexpr int kDwfHUnits = kDwfT / 4 + 2;   // 4-frame units of a staged h row: t0 - 4 .. t0 + 67
constexpr int kDwfHW = 76;          // words per staged h row (72 used); 12 mod 32
constexpr int kDwfGW = kDwfT + 4;   // words per staged gz row; 4 mod 32

// Warps along the Cin tile (one m16 each), threads, floats of one staged h
// tile and of one ring stage, and the ring's bytes, of the CI instance.
template <int CI>
__host__ __device__ constexpr int dwf_warps_m() { return CI == kDwfCi ? 2 : 1; }
template <int CI>
__host__ __device__ constexpr int dwf_threads() { return 3 * dwf_warps_m<CI>() * 2 * 32; }
template <int CI>
__host__ __device__ constexpr int dwf_h_elems() { return 3 * CI * kDwfHW; }
template <int CI>
__host__ __device__ constexpr int dwf_stage() { return dwf_h_elems<CI>() + kDwfCo * kDwfGW; }
template <int CI>
__host__ __device__ constexpr size_t dwf_smem() { return 2 * sizeof(float) * dwf_stage<CI>(); }
// m16 tiles a warp holds: one per dx, or two with the dx taps stacked
template <int CI>
__host__ __device__ constexpr int dwf_m_tiles() { return CI == kDwfCiStacked ? 2 : 3; }
// blocks an SM: K9's 384 threads keep 155 registers; K5's 192 take two
template <int CI>
__host__ __device__ constexpr int dwf_min_blocks() { return CI == kDwfCi ? 1 : 2; }

// Stage depth step (b, f, frames [t0, t0 + 64)): h rows f - 1 .. f + 1 of
// channels [c0, c0 + CI) at frames t0 - 4 .. t0 + 67 into hs [3 * CI][76],
// and gz rows [co0, co0 + 64) of row f at frames t0 .. t0 + 63 (zero from
// t_end) into gs [64][68]; zeros outside the input and past Cin / Cout.
template <int CI>
static __device__ __forceinline__ void dwf_stage(float* __restrict__ hs, float* __restrict__ gs,
                                                 const float* __restrict__ hb,
                                                 const float* __restrict__ gb, int f, int t0,
                                                 int t_end, int c0, int co0, int cin, int cout,
                                                 int f_dim, int t_dim, bool vec) {
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;
  const int h_len = vec ? kDwfHUnits : 4 * kDwfHUnits;   // units of 4 frames or of one
  for (int e = threadIdx.x; e < 3 * CI * h_len; e += dwf_threads<CI>()) {
    const int u = e % h_len, rest = e / h_len;   // rest = dy * CI + ci
    const int ci = c0 + rest % CI, fr = f - 1 + rest / CI;
    const int t = t0 - 4 + (vec ? 4 * u : u);
    const bool ok = ci < cin && fr >= 0 && fr < f_dim && t >= 0 && t < t_dim;
    const float* src = hb + ci * plane + static_cast<size_t>(fr) * t_dim + t;
    float* dst = hs + rest * kDwfHW + (vec ? 4 * u : u);
    if (vec)
      cp_async16(dst, ok ? src : hb, ok ? 16 : 0);
    else
      *dst = ok ? *src : 0.f;
  }
  const int z_len = vec ? kDwfT / 4 : kDwfT;
  for (int e = threadIdx.x; e < kDwfCo * z_len; e += dwf_threads<CI>()) {
    const int u = e % z_len, co = e / z_len;
    const int t = t0 + (vec ? 4 * u : u);
    const bool ok = co0 + co < cout && t < t_end;
    const float* src = gb + (co0 + co) * plane + static_cast<size_t>(f) * t_dim + t;
    float* dst = gs + co * kDwfGW + (vec ? 4 * u : u);
    if (vec)
      cp_async16(dst, ok ? src : gb, ok ? 16 : 0);
    else
      *dst = ok ? *src : 0.f;
  }
}

// part = one staged depth step of this warp's taps (dy, all dx) x 16 Cin x
// 32 Cout. CI >= 16: part[dx][ni] is channels g (+ 8) of the warp's 16, tap
// (dy, dx), Cout ni * 8 .. + 7 of its 32. CI = 8 (dx stacked): part[0][ni]
// holds dx 0 (rows g) and dx 1 (rows g + 8) of channel g, part[1][ni] dx 2
// (rows g; rows g + 8 are zero).
template <int CI>
static __device__ __forceinline__ void dwf_mma_step(const float* __restrict__ stage, int wdy,
                                                    int wm, int wn,
                                                    float (&part)[dwf_m_tiles<CI>()][4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* hw = stage + (wdy * CI + wm * 16 + g) * kDwfHW + t;
  const float* gw = stage + dwf_h_elems<CI>() + (wn * 32 + g) * kDwfGW + t;
#pragma unroll
  for (int m = 0; m < dwf_m_tiles<CI>(); ++m)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][ni][e] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < kDwfT / 8; ++ks) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      split_tf32(gw[ni * 8 * kDwfGW + 8 * ks], bh[ni][0], bl[ni][0]);
      split_tf32(gw[ni * 8 * kDwfGW + 8 * ks + 4], bh[ni][1], bl[ni][1]);
    }
    if constexpr (CI == kDwfCiStacked) {
      // row g only: words 3-5 (slot t) and 7-9 (slot t + 4) past 8 ks + t are dx 0-2
      uint32_t wh[2][3], wl[2][3];   // [slot t, slot t + 4][dx]
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        split_tf32(hw[8 * ks + 3 + i], wh[0][i], wl[0][i]);
        split_tf32(hw[8 * ks + 7 + i], wh[1][i], wl[1][i]);
      }
      const uint32_t ah0[4] = {wh[0][0], wh[0][1], wh[1][0], wh[1][1]};
      const uint32_t al0[4] = {wl[0][0], wl[0][1], wl[1][0], wl[1][1]};
      const uint32_t ah1[4] = {wh[0][2], 0u, wh[1][2], 0u};
      const uint32_t al1[4] = {wl[0][2], 0u, wl[1][2], 0u};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_3xtf32(part[0][ni], ah0, al0, bh[ni], bl[ni]);
        mma_3xtf32(part[1][ni], ah1, al1, bh[ni], bl[ni]);
      }
    } else {
      // rows g and g + 8, words 3-5 (slot t) and 7-9 (slot t + 4) past 8 ks + t
      uint32_t wh[4][3], wl[4][3];   // [row g lo, row g + 8 lo, row g hi, row g + 8 hi][dx]
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        split_tf32(hw[8 * ks + 3 + i], wh[0][i], wl[0][i]);
        split_tf32(hw[8 * kDwfHW + 8 * ks + 3 + i], wh[1][i], wl[1][i]);
        split_tf32(hw[8 * ks + 7 + i], wh[2][i], wl[2][i]);
        split_tf32(hw[8 * kDwfHW + 8 * ks + 7 + i], wh[3][i], wl[3][i]);
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t ah[4] = {wh[0][dx], wh[1][dx], wh[2][dx], wh[3][dx]};
        const uint32_t al[4] = {wl[0][dx], wl[1][dx], wl[2][dx], wl[3][dx]};
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_3xtf32(part[dx][ni], ah, al, bh[ni], bl[ni]);
      }
    }
  }
}

// Grid (row splits x frame splits, ceil(Cout / 64), ceil(Cin / CI)); block x
// writes partial row x of (grid.x, 9 * Cin * Cout) floats. Depth shares as
// ct_dw_tc_kernel's.
template <int CI>
__global__ void __launch_bounds__(dwf_threads<CI>(), dwf_min_blocks<CI>())
ct_dw_tf32_kernel(const float* __restrict__ h, const float* __restrict__ gz,
                  float* __restrict__ partials, int batch, int cin, int f_dim, int t_dim,
                  int cout, int rows_per_split, int frames_per_split) {
  constexpr int kM = dwf_m_tiles<CI>(), kWm = dwf_warps_m<CI>();
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float* smem = reinterpret_cast<float*>(dw_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wdy = warp / (2 * kWm), wm = (warp / 2) % kWm, wn = warp % 2;
  const int frame_splits = ceil_div(t_dim, frames_per_split);
  const int rs = blockIdx.x / frame_splits, fs = blockIdx.x % frame_splits;
  const int row0 = rs * rows_per_split, row1 = min(batch * f_dim, row0 + rows_per_split);
  const int t_lo = fs * frames_per_split, t_hi = min(t_dim, t_lo + frames_per_split);
  const int co0 = blockIdx.y * kDwfCo, c0 = blockIdx.z * CI;
  const int steps = max(ceil_div(t_hi - t_lo, kDwfT), 0);
  const int total = max(row1 - row0, 0) * steps;
  const bool vec = t_dim % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const size_t h_item = static_cast<size_t>(cin) * f_dim * t_dim;
  const size_t g_item = static_cast<size_t>(cout) * f_dim * t_dim;
  const auto stage = [&](int it, float* buf) {
    const int row = row0 + it / steps, t0 = t_lo + (it % steps) * kDwfT;
    const int b = row / f_dim;
    dwf_stage<CI>(buf, buf + dwf_h_elems<CI>(), h + b * h_item, gz + b * g_item, row % f_dim, t0,
                  t_hi, c0, co0, cin, cout, f_dim, t_dim, vec);
  };

  float acc[kM][4][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][ni][e] = 0.f;

  if (total > 0) {
    stage(0, smem);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {   // the next step loads while this one multiplies
      stage(it + 1, smem + ((it + 1) & 1) * dwf_stage<CI>());
      cp_async_commit();
    }
    float part[kM][4][4];
    dwf_mma_step<CI>(smem + (it & 1) * dwf_stage<CI>(), wdy, wm, wn, part);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][ni][e] += part[m][ni][e];
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }

  // the partial row is dW in w's layout: [tap][ci][co]; fragment rows g (hh
  // 0) and g + 8 (hh 1) of m16 tile m are channel g (+ 8) of tap dx = m, or,
  // dx stacked, channel g of tap dx = 2 m + hh
  float* prow = partials + static_cast<size_t>(blockIdx.x) * 9 * cin * cout;
  const bool pairs = cout % 2 == 0;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bool stacked = CI == kDwfCiStacked;
      const int dx = stacked ? 2 * m + hh : m;
      const int ci = c0 + wm * 16 + lane / 4 + (stacked ? 0 : 8 * hh);
      if (dx > 2 || ci >= cin) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = co0 + wn * 32 + ni * 8 + 2 * (lane % 4);
        float* p = prow + (static_cast<size_t>(wdy * 3 + dx) * cin + ci) * cout + co;
        const float v0 = acc[m][ni][2 * hh], v1 = acc[m][ni][2 * hh + 1];
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
