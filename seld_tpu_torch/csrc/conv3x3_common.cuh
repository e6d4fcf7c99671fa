// The 3x3 conv tile shared by the CNN-frontend kernels: the serving stage
// (conv3x3_bn_relu_fpool.cu) and the train-mode stage 1 (conv3x3_train.cu).
//
// A block covers kBCO output channels x kBT frames of one conv row at a time
// with 256 threads; thread (tx = tid % 16, ty = tid / 16) holds channels
// co0 + ty + 16 i (i < 4) at frames t0 + tx + 16 j (j < 8). The train-mode
// backward recomputes the forward's conv rows and routes the pool gradient
// by comparing them, so both kernels must get bitwise the same values: they
// share conv_rows (one fixed fmaf order) and bn_relu below.
#pragma once

#include "common.cuh"

namespace {


constexpr int kBCO = 64;   // Cout per block
constexpr int kBT = 128;   // frames per block
constexpr int kCC = 8;     // input channels per shared-memory chunk
constexpr int kXW = kBT + 2;
constexpr int kThreads = 256;

// acc[i][j] += sum over (ci, dy, dx) of w[dy][dx][ci][co_i] * x[row0+dy][ci][t_j+dx]
// xs: [rows][kCC][kXW] with row0 the first of the 3 conv rows; ws: [9][kCC][kBCO].
static __device__ __forceinline__ void conv_rows(const float* __restrict__ xs,
                                                 const float* __restrict__ ws,
                                                 int row0, int tx, int ty,
                                                 float (&acc)[4][8]) {
#pragma unroll 1
  for (int ci = 0; ci < kCC; ++ci) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* xr = xs + ((row0 + dy) * kCC + ci) * kXW + tx;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float w4[4], x8[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) w4[i] = ws[((dy * 3 + dx) * kCC + ci) * kBCO + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) x8[j] = xr[16 * j + dx];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(w4[i], x8[j], acc[i][j]);
      }
    }
  }
}

// Stage `rows` conv rows (frequency f_first, f_first + 1, ...) of channels
// [c0, c0 + kCC) for frames [t0 - 1, t0 + kBT + 1); zeros outside the input.
template <typename T>
static __device__ __forceinline__ void stage_x(float* __restrict__ xs, const T* __restrict__ xb,
                                               int rows, int f_first, int c0, int t0,
                                               int cin, int f_dim, int t_dim) {
  const int total = rows * kCC * kXW;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int tl = e % kXW;
    const int rest = e / kXW;
    const int ci = c0 + rest % kCC;
    const int f = f_first + rest / kCC;
    const int t = t0 + tl - 1;
    float v = 0.f;
    if (ci < cin && f >= 0 && f < f_dim && t >= 0 && t < t_dim)
      v = to_f(xb[(static_cast<size_t>(ci) * f_dim + f) * t_dim + t]);
    xs[e] = v;
  }
}

// Stage w[:, :, c0:c0+kCC, co0:co0+kBCO] as ws[tap][ci][co]; zeros outside.
template <typename T>
static __device__ __forceinline__ void stage_w(float* __restrict__ ws, const T* __restrict__ w,
                                               int c0, int co0, int cin, int cout) {
  for (int e = threadIdx.x; e < 9 * kCC * kBCO; e += kThreads) {
    const int col = e % kBCO;
    const int rest = e / kBCO;
    const int ci = c0 + rest % kCC;
    const int tap = rest / kCC;
    const int co = co0 + col;
    ws[e] = (ci < cin && co < cout)
                ? to_f(w[(static_cast<size_t>(tap) * cin + ci) * cout + co])
                : 0.f;
  }
}

// relu(acc * scale + bias), the one expression every conv-pool kernel uses.
static __device__ __forceinline__ float bn_relu(float acc, float scale, float bias) {
  return fmaxf(fmaf(acc, scale, bias), 0.f);
}

}  // namespace
