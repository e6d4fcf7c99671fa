// The SIMT 3x3 conv tile that stays for one instance, K2's bfloat16 entry at
// Cin 9-10 (conv3x3_smallcin_kernel in conv3x3_bn_relu_fpool.cu, reached only
// by a direct call: the router sends Cin <= 8 to K2, and K5's bfloat16
// forward takes the block tile), and the helpers every conv-pool and
// train-mode kernel shares: max_nan, bn_relu and the fixed-order reduction
// of per-block partial sums. Every other conv runs a tensor-core tile: the
// block tiles (conv3x3_tc.cuh in bfloat16, conv3x3_tf32.cuh in float32), and
// in float32 at stage 1 the float smallcin tile (conv3x3_smallcin_tf32.cuh:
// K2, K5's F1, F2 and g_z pass).
//
// A block covers kBCO output channels x kBT frames of one conv row at a time
// with 256 threads; thread (tx = tid % 16, ty = tid / 16) holds channels
// co0 + ty + 16 i (i < 4) at frames t0 + tx + 16 j (j < 8). conv_rows,
// stage_x and stage_w take the staged channel count CC as a template
// argument (2 * kCC for Cin 9-10).
#pragma once

#include "common.cuh"

namespace {


constexpr int kBCO = 64;   // Cout per block
constexpr int kBT = 128;   // frames per block
constexpr int kCC = 8;     // input channels per shared-memory chunk
constexpr int kXW = kBT + 2;
constexpr int kThreads = 256;
// Widest Cin of the 2 * kCC staging (K5 and K2's smallcin entry): the
// reference's 3 * Cin <= 32; channels Cin..2 * kCC - 1 are staged as zeros.
constexpr int kMaxStagedCin = 10;
constexpr size_t kBlockSmem = 232448;   // shared memory one block may use on the H100

// acc[i][j] += sum over (ci, dy, dx) of w[dy][dx][ci][co_i] * x[row0+dy][ci][t_j+dx]
// xs: [rows][CC][kXW] with row0 the first of the 3 conv rows; ws: [9][CC][kBCO].
template <int CC = kCC>
static __device__ __forceinline__ void conv_rows(const float* __restrict__ xs,
                                                 const float* __restrict__ ws,
                                                 int row0, int tx, int ty,
                                                 float (&acc)[4][8]) {
#pragma unroll 1
  for (int ci = 0; ci < CC; ++ci) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* xr = xs + ((row0 + dy) * CC + ci) * kXW + tx;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float w4[4], x8[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) w4[i] = ws[((dy * 3 + dx) * CC + ci) * kBCO + ty + 16 * i];
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
// [c0, c0 + CC) for frames [t0 - 1, t0 + kBT + 1); zeros outside the input.
template <int CC = kCC, typename T>
static __device__ __forceinline__ void stage_x(float* __restrict__ xs, const T* __restrict__ xb,
                                               int rows, int f_first, int c0, int t0,
                                               int cin, int f_dim, int t_dim) {
  const int total = rows * CC * kXW;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int tl = e % kXW;
    const int rest = e / kXW;
    const int ci = c0 + rest % CC;
    const int f = f_first + rest / CC;
    const int t = t0 + tl - 1;
    float v = 0.f;
    if (ci < cin && f >= 0 && f < f_dim && t >= 0 && t < t_dim)
      v = to_f(xb[(static_cast<size_t>(ci) * f_dim + f) * t_dim + t]);
    xs[e] = v;
  }
}

// Stage w[:, :, c0:c0+CC, co0:co0+kBCO] as ws[tap][ci][co]; zeros outside.
template <int CC = kCC, typename T>
static __device__ __forceinline__ void stage_w(float* __restrict__ ws, const T* __restrict__ w,
                                               int c0, int co0, int cin, int cout) {
  for (int e = threadIdx.x; e < 9 * CC * kBCO; e += kThreads) {
    const int col = e % kBCO;
    const int rest = e / kBCO;
    const int ci = c0 + rest % CC;
    const int tap = rest / CC;
    const int co = co0 + col;
    ws[e] = (ci < cin && co < cout)
                ? to_f(w[(static_cast<size_t>(tap) * cin + ci) * cout + co])
                : 0.f;
  }
}

// max(a, b) keeping a NaN, as jnp.maximum / jnp.max and torch.relu /
// max_pool2d do (fmaxf returns the operand that is not NaN): PTX max.NaN,
// the canonical NaN where either operand is one, else fmaxf's result.
static __device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// relu(acc * scale + bias), the one expression every conv-pool kernel uses;
// a NaN stays a NaN. Each pool's running max takes max_nan too.
static __device__ __forceinline__ float bn_relu(float acc, float scale, float bias) {
  return max_nan(fmaf(acc, scale, bias), 0.f);
}

// out[m] = sum over p of partials[p][m], p in increasing order within each of
// 32 strands, strands summed in order: the same bits on every run.
__global__ void __launch_bounds__(1024)
reduce_kernel(const float* __restrict__ partials, float* __restrict__ out, int rows, int width) {
  __shared__ double part[32][33];
  const int m = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0;
  if (m < width)
    for (int p = threadIdx.y; p < rows; p += 32) s += partials[static_cast<size_t>(p) * width + m];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && m < width) {
    double total = 0.0;
    for (int k = 0; k < 32; ++k) total += part[k][threadIdx.x];
    out[m] = static_cast<float>(total);
  }
}

// Every train-mode pass writes one row of per-block partial sums; this sums
// the rows in a fixed order (double accumulators): no float atomics.
static inline cudaError_t launch_reduce(const float* partials, float* out, int rows, int width,
                                        cudaStream_t s) {
  reduce_kernel<<<ceil_div(width, 32), dim3(32, 32), 0, s>>>(partials, out, rows, width);
  return cudaGetLastError();
}

}  // namespace
