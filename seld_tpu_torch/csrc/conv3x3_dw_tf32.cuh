// The float32 weight gradient of a 3x3 conv (zero pad 1) on the tensor cores
// in split TF32: dW[dy][dx][ci][co] = sum over (b, f, t) of gz[b][co][f][t] *
// h[b][ci][f + dy - 1][t + dx - 1], h (B, Cin, F, T) and gz (B, Cout, F, T)
// float, zero outside the input. K9's B2 in float32 (conv3x3_ct_train.cu);
// the float counterpart of conv3x3_dw_tc.cuh's bf16 tile, with its grid, its
// depth split (the wrapper's conv2d_train.dw_split) and its partial rows
// [tap][ci][co] for launch_reduce's fixed order: no atomics, so a rerun is
// bitwise equal.
//
// What bounds it on the H100: arithmetic, 2 * 9 * Cin * Cout operations per
// (b, f, t), against one read of h and gz. In float32 on the FMA pipes that
// is 3.0 ms at the flagship's stage 2 (batch 2); here every product is
// mma_3xtf32 (mma.cuh): three mma.sync.m16n8k8 TF32 products on operands
// split into hi + lo as they are read, at float32's accuracy. The GEMM:
// per (b, f) row, M = 9 taps x Cin (h rows f - 1, f, f + 1, shifted by dx -
// 1 frames), N = Cout (gz row f), K = t in 64-frame steps of eight k8
// steps. Both operands are read straight from their [channel][frame] tiles:
// the A operand of tap dx is h one word to the left or right (a 32-bit word
// holds one frame, so the bf16 tile's byte permutes go), and the B operand
// (k slot t, n g) is gz[co g][frame t].
// Block tile: 9 taps x 32 Cin x 64 Cout, 12 warps (384 threads); warp (dy,
// 16-channel half of the Cin tile, 32-channel half of the Cout tile) holds 3
// dx x 4 n8 fragments, 48 floats a thread. Staged per step: h [3 rows][32
// channels][frames t0 - 4 .. t0 + 67] in 76-word rows and gz [64][frames t0
// .. t0 + 63] in 68-word rows (12 and 4 mod 32: the 8 rows x 4 words of a
// fragment read hit 32 banks), by 16-byte cp.async (T % 4 == 0 and aligned
// tensors; else 4-byte loads and stores) into a two-stage ring: the next
// step loads while this one multiplies. Each thread reads the six words
// around its fragment (offsets 3-5 and 7-9 past its k8 step) of its two
// rows and splits each once for all three taps.
// Rounding: the tensor cores add into their accumulators without rounding
// to nearest, and a block's depth runs to B * F * T / 64 frames (4800 at
// stage 2). So each 64-frame step is summed on the tensor cores into a
// zeroed fragment (24 additions), then added to the float accumulators in
// registers, rounded to nearest.
// Ragged edges as the bf16 tile: h rows outside [0, F), channels past Cin
// and Cout and frames outside [0, T) stage as zeros; partial rows store only
// ci < Cin and co < Cout.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kDwfCi = 32;          // input channels per block (two m16 tiles per tap)
constexpr int kDwfCo = 64;          // output channels per block
constexpr int kDwfT = 64;           // frames per depth step: eight k8 steps
constexpr int kDwfThreads = 384;    // 12 warps: 3 (dy) x 2 (Cin halves) x 2 (Cout halves)
constexpr int kDwfHUnits = kDwfT / 4 + 2;   // 4-frame units of a staged h row: t0 - 4 .. t0 + 67
constexpr int kDwfHW = 76;          // words per staged h row (72 used); 12 mod 32
constexpr int kDwfGW = kDwfT + 4;   // words per staged gz row; 4 mod 32
constexpr int kDwfHElems = 3 * kDwfCi * kDwfHW;
constexpr int kDwfStage = kDwfHElems + kDwfCo * kDwfGW;   // floats a ring stage
constexpr size_t kDwfSmem = 2 * sizeof(float) * kDwfStage;

// Stage depth step (b, f, frames [t0, t0 + 64)): h rows f - 1 .. f + 1 of
// channels [c0, c0 + 32) at frames t0 - 4 .. t0 + 67 into hs [3 * 32][76],
// and gz rows [co0, co0 + 64) of row f at frames t0 .. t0 + 63 (zero from
// t_end) into gs [64][68]; zeros outside the input and past Cin / Cout.
static __device__ __forceinline__ void dwf_stage(float* __restrict__ hs, float* __restrict__ gs,
                                                 const float* __restrict__ hb,
                                                 const float* __restrict__ gb, int f, int t0,
                                                 int t_end, int c0, int co0, int cin, int cout,
                                                 int f_dim, int t_dim, bool vec) {
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;
  const int h_len = vec ? kDwfHUnits : 4 * kDwfHUnits;   // units of 4 frames or of one
  for (int e = threadIdx.x; e < 3 * kDwfCi * h_len; e += kDwfThreads) {
    const int u = e % h_len, rest = e / h_len;   // rest = dy * 32 + ci
    const int ci = c0 + rest % kDwfCi, fr = f - 1 + rest / kDwfCi;
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
  for (int e = threadIdx.x; e < kDwfCo * z_len; e += kDwfThreads) {
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

// part = one staged depth step of this warp's 3 dx x 16 Cin x 32 Cout;
// part[dx][ni] is channels g (+ 8) of the warp's 16, tap (dy, dx), Cout ni *
// 8 .. + 7 of its 32.
static __device__ __forceinline__ void dwf_mma_step(const float* __restrict__ stage, int wdy,
                                                    int wm, int wn, float (&part)[3][4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* hw = stage + (wdy * kDwfCi + wm * 16 + g) * kDwfHW + t;
  const float* gw = stage + kDwfHElems + (wn * 32 + g) * kDwfGW + t;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[dx][ni][e] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < kDwfT / 8; ++ks) {
    // rows g and g + 8, words 3-5 (slot t) and 7-9 (slot t + 4) past 8 ks + t
    uint32_t wh[4][3], wl[4][3];   // [row g lo, row g + 8 lo, row g hi, row g + 8 hi][dx]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      split_tf32(hw[8 * ks + 3 + i], wh[0][i], wl[0][i]);
      split_tf32(hw[8 * kDwfHW + 8 * ks + 3 + i], wh[1][i], wl[1][i]);
      split_tf32(hw[8 * ks + 7 + i], wh[2][i], wl[2][i]);
      split_tf32(hw[8 * kDwfHW + 8 * ks + 7 + i], wh[3][i], wl[3][i]);
    }
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      split_tf32(gw[ni * 8 * kDwfGW + 8 * ks], bh[ni][0], bl[ni][0]);
      split_tf32(gw[ni * 8 * kDwfGW + 8 * ks + 4], bh[ni][1], bl[ni][1]);
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

// Grid (row splits x frame splits, ceil(Cout / 64), ceil(Cin / 32)); block x
// writes partial row x of (grid.x, 9 * Cin * Cout) floats. Depth shares as
// ct_dw_tc_kernel's.
__global__ void __launch_bounds__(kDwfThreads, 1)
ct_dw_tf32_kernel(const float* __restrict__ h, const float* __restrict__ gz,
                  float* __restrict__ partials, int batch, int cin, int f_dim, int t_dim,
                  int cout, int rows_per_split, int frames_per_split) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float* smem = reinterpret_cast<float*>(dw_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wdy = warp / 4, wm = (warp / 2) % 2, wn = warp % 2;
  const int frame_splits = ceil_div(t_dim, frames_per_split);
  const int rs = blockIdx.x / frame_splits, fs = blockIdx.x % frame_splits;
  const int row0 = rs * rows_per_split, row1 = min(batch * f_dim, row0 + rows_per_split);
  const int t_lo = fs * frames_per_split, t_hi = min(t_dim, t_lo + frames_per_split);
  const int co0 = blockIdx.y * kDwfCo, c0 = blockIdx.z * kDwfCi;
  const int steps = max(ceil_div(t_hi - t_lo, kDwfT), 0);
  const int total = max(row1 - row0, 0) * steps;
  const bool vec = t_dim % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const size_t h_item = static_cast<size_t>(cin) * f_dim * t_dim;
  const size_t g_item = static_cast<size_t>(cout) * f_dim * t_dim;
  const auto stage = [&](int it, float* buf) {
    const int row = row0 + it / steps, t0 = t_lo + (it % steps) * kDwfT;
    const int b = row / f_dim;
    dwf_stage(buf, buf + kDwfHElems, h + b * h_item, gz + b * g_item, row % f_dim, t0, t_hi, c0,
              co0, cin, cout, f_dim, t_dim, vec);
  };

  float acc[3][4][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dx][ni][e] = 0.f;

  if (total > 0) {
    stage(0, smem);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {   // the next step loads while this one multiplies
      stage(it + 1, smem + ((it + 1) & 1) * kDwfStage);
      cp_async_commit();
    }
    float part[3][4][4];
    dwf_mma_step(smem + (it & 1) * kDwfStage, wdy, wm, wn, part);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dx][ni][e] += part[dx][ni][e];
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }

  // the partial row is dW in w's layout: [tap][ci][co]
  float* prow = partials + static_cast<size_t>(blockIdx.x) * 9 * cin * cout;
  const bool pairs = cout % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ci = c0 + wm * 16 + lane / 4 + 8 * hh;
    if (ci >= cin) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = co0 + wn * 32 + ni * 8 + 2 * (lane % 4);
        float* p = prow + (static_cast<size_t>(wdy * 3 + dx) * cin + ci) * cout + co;
        const float v0 = acc[dx][ni][2 * hh], v1 = acc[dx][ni][2 * hh + 1];
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
