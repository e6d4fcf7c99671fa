// K10a: the CNN-frontend stage as one product over materialized patches.
//
// Replaces seld_tpu/ops/pallas/conv2d_pool.py:100
//   conv2d_im2col_bn_relu_fpool (kernel body _im2col_kernel, :90).
// Contract: patches (B, F, T, K = 9 Cin) from the wrapper
// (ops/kernels/conv2d_pool.py::im2col_patches: column (dy * 3 + dx) * Cin + c
// is the zero-padded x[c, f + dy - 1, t + dx - 1]), w (K, Cout) (the
// (3, 3, Cin, Cout) weights as they lie), scale/bias (Cout,) float -> out
// (B, Cout, F/pf, T) with out[b, co, fo, t] = max_r relu((patches[b, fo*pf +
// r, t, :] @ w)[co] * scale + bias). Any Cin and any T.
//
// What bounds it on the H100: the function is 2 * 9 * Cin * Cout operations
// per output pixel against x + w + out bytes (arithmetic-bound at the
// flagship's widths); the patches are 9x the input's bytes (354 MB at the
// flagship's stage 1 at batch 2 in bf16, 1.06 GB at stage 2), which the
// kernel reads once: the design's cost, not the function's.
// Design: one block per (b, pooled row, 64-channel Cout tile, 128-frame T
// tile), 256 threads, each holding a 4-channel x 8-frame float accumulator.
// The operands are K-contiguous, so K is walked in chunks of 32: each chunk
// stages a [32][128] patch tile, read as 32 consecutive columns per frame
// (coalesced) and stored transposed with a padded row (no bank conflicts),
// and the [32][64] weight slice; the ragged last chunk is zero-filled. Pool
// rows are computed one after another into the same accumulator and folded
// into a running max after the affine and ReLU. SIMT FMA: an mma.sync tile is
// a later step.
#include "conv3x3_common.cuh"

namespace {

constexpr int kKC = 32;          // K per shared-memory chunk
constexpr int kXS = kBT + 1;     // padded row of the transposed patch tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const T* __restrict__ patches, const T* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ out, int k_dim, int f_dim, int t_dim, int cout, int pf) {
  __shared__ float xs[kKC * kXS];     // [k][t]
  __shared__ float ws[kKC * kBCO];    // [k][co]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // frame lane: frames t0 + tx + 16 j
  const int ty = tid / 16;   // channel lane: channels co0 + ty + 16 i
  const int t0 = blockIdx.x * kBT;
  const int co0 = blockIdx.y * kBCO;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;

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

  for (int r = 0; r < pf; ++r) {
    const T* prow = patches + (static_cast<size_t>(b) * f_dim + fo * pf + r) * t_dim * k_dim;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += kKC) {
      __syncthreads();   // the previous chunk's readers are done
      for (int e = tid; e < kKC * kBT; e += kThreads) {
        const int k = e % kKC;
        const int tl = e / kKC;
        const int t = t0 + tl;
        xs[k * kXS + tl] = (t < t_dim && k0 + k < k_dim)
                               ? to_f(prow[static_cast<size_t>(t) * k_dim + k0 + k])
                               : 0.f;
      }
      for (int e = tid; e < kKC * kBCO; e += kThreads) {
        const int col = e % kBCO;
        const int k = e / kBCO;
        const int co = co0 + col;
        ws[e] = (k0 + k < k_dim && co < cout)
                    ? to_f(w[static_cast<size_t>(k0 + k) * cout + co])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float w4[4], x8[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) w4[i] = ws[k * kBCO + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) x8[j] = xs[k * kXS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(w4[i], x8[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        best[i][j] = fmaxf(best[i][j], bn_relu(acc[i][j], sc[i], bi[i]));
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

template <typename T>
cudaError_t launch(const void* patches, const void* w, const float* scale, const float* bias,
                   void* out, int batch, int k_dim, int f_dim, int t_dim, int cout, int pf,
                   cudaStream_t stream) {
  dim3 grid(ceil_div(t_dim, kBT), ceil_div(cout, kBCO), batch * (f_dim / pf));
  im2col_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(patches), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(out), k_dim, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

}  // namespace

// patches (B, F, T, K), w (K, Cout).
extern "C" int seld_conv3x3_im2col(const void* patches, const void* w, const void* scale,
                                   const void* bias, void* out, int batch, int k_dim, int f_dim,
                                   int t_dim, int cout, int pf, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float>(patches, w, sc, bi, out, batch, k_dim, f_dim, t_dim, cout, pf, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(patches, w, sc, bi, out, batch, k_dim, f_dim, t_dim, cout, pf,
                                s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
