// Fused CNN-frontend stage: 3x3 conv (stride 1, zero pad 1) -> folded BN
// affine -> ReLU -> max over `pf` frequency rows, writing only the pooled row.
//
// Replaces seld_tpu/ops/pallas/conv2d_pool.py::
//   conv2d_smallcin_thin_bn_relu_fpool (_smallcin_thin_kernel), stage 1,
//   Cin <= 8: entry seld_conv3x3_smallcin;
//   conv2d_widecin_ct_bn_relu_fpool (_widecin_ct_kernel), stages 2-3,
//   Cin % 8 == 0: entry seld_conv3x3_widecin.
// Contract: x (B, Cin, F, T), w (3, 3, Cin, Cout), scale/bias (Cout,) float
// -> out (B, Cout, F/pf, T) with out = max_r relu(conv(x)[f*pf + r] * scale +
// bias). The max is taken after the affine and ReLU; T is not pooled.
//
// What bounds it on the H100: arithmetic (2*9*Cin*Cout FLOP per output
// pixel: stage 2 of the flagship is 102 GFLOP per clip), and, without the
// fusion, memory: stage 1's unpooled (B, 192, 256, T) activation is 1.9 GB
// per clip in bf16. Design: one block per (b, pooled row, 64-channel Cout
// tile, 128-frame T tile), 256 threads, each holding a 4-channel x 8-frame
// float accumulator. The input halo (conv rows x 8 channels x (T tile + 2))
// and the matching 9 x 8 x 64 weight slice are staged in shared memory with
// the conv's zero padding written at the F and T borders, so the inner loop
// never branches. The pool rows are computed one after another into the
// same accumulator and folded into a running max, so only one row of
// accumulators lives in registers whatever pf is.
// - smallcin: all taps and channels (K = 9 x 8 = 72) and all pf + 2 halo rows
//   are staged once per block.
// - widecin: Cin is walked in chunks of 8 for each pool row; each step stages
//   that row's 3-row halo and weight chunk.
// SIMT FMA: mma/wgmma tensor-core tiles are a later step.
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

template <typename T, bool kSmall>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ float smem[];
  const int rows = kSmall ? pf + 2 : 3;
  float* xs = smem;                    // [rows][kCC][kXW]
  float* ws = smem + rows * kCC * kXW; // [9][kCC][kBCO]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // frame lane: frames t0 + tx + 16 j
  const int ty = tid / 16;   // channel lane: channels co0 + ty + 16 i
  const int t0 = blockIdx.x * kBT;
  const int co0 = blockIdx.y * kBCO;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;
  const T* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  float sc[4], bi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    sc[i] = co < cout ? scale[co] : 0.f;
    bi[i] = co < cout ? bias[co] : 0.f;
  }
  // relu output is >= 0, so 0 is the identity of the running max
  float best[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) best[i][j] = 0.f;

  if (kSmall) {
    stage_w(ws, w, 0, co0, cin, cout);
    stage_x(xs, xb, rows, fo * pf - 1, 0, t0, cin, f_dim, t_dim);
    __syncthreads();
  }
  for (int r = 0; r < pf; ++r) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if (kSmall) {
      conv_rows(xs, ws, r, tx, ty, acc);
    } else {
      for (int c0 = 0; c0 < cin; c0 += kCC) {
        __syncthreads();   // the previous chunk's readers are done
        stage_w(ws, w, c0, co0, cin, cout);
        stage_x(xs, xb, 3, fo * pf + r - 1, c0, t0, cin, f_dim, t_dim);
        __syncthreads();
        conv_rows(xs, ws, 0, tx, ty, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        best[i][j] = fmaxf(best[i][j], fmaxf(fmaf(acc[i][j], sc[i], bi[i]), 0.f));
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    if (co >= cout) continue;
    T* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + tx + 16 * j;
      if (t < t_dim) store_f(orow + t, best[i][j]);
    }
  }
}

template <typename T, bool kSmall>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* bias,
                   void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                   cudaStream_t stream) {
  const int rows = kSmall ? pf + 2 : 3;
  const size_t smem = sizeof(float) * (rows * kCC * kXW + 9 * kCC * kBCO);
  cudaError_t err = set_smem(conv3x3_kernel<T, kSmall>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kBT), ceil_div(cout, kBCO), batch * (f_dim / pf));
  conv3x3_kernel<T, kSmall><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(out), cin, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

template <bool kSmall>
int dispatch(const void* x, const void* w, const void* scale, const void* bias, void* out,
             int batch, int cin, int f_dim, int t_dim, int cout, int pf, int dtype,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float, kSmall>(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout, pf, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16, kSmall>(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout,
                                        pf, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Cin <= 8: every tap and channel staged once (K = 72).
extern "C" int seld_conv3x3_smallcin(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int batch, int cin,
                                     int f_dim, int t_dim, int cout, int pf, int dtype,
                                     void* stream) {
  return dispatch<true>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, dtype,
                        stream);
}

// Cin % 8 == 0: Cin walked in chunks of 8.
extern "C" int seld_conv3x3_widecin(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int batch, int cin,
                                    int f_dim, int t_dim, int cout, int pf, int dtype,
                                    void* stream) {
  return dispatch<false>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, dtype,
                         stream);
}
