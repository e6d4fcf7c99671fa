// int8 post-training-quantized matmul (K8): out = dequant(quant(x) @ w_q) + bias
// with per-row dynamic activation quantization.
//
// Replaces seld_tpu/ops/pallas/quant.py::int8_matmul (_int8_matmul_kernel).
// The arithmetic is the XLA-compiled form of quant.py:41-53, which is what
// the JAX kernel computes (the source's `amax / 127.0` is compiled to a
// multiplication by float32(1/127), and the epilogue to one fma):
//   xf  = float(x)                       amax = max_k |xf[k]|   (per row)
//   xs  = amax > 0 ? amax * float32(1/127) : 1
//   xq  = clamp(rint(xf / xs), -127, 127)       true IEEE division, ties to even
//   acc = sum_k xq[k] * w_q[k][col]             int32
//   out = fmaf(float(acc) * xs, w_scale[col], bias[col]), rounded once to x's dtype
// The division, the rounding and the fma are written as intrinsics
// (__fdiv_rn, __float2int_rn, __fmul_rn, fmaf), so that neither a fast-math
// flag nor nvcc's contraction rules decide them.
//
// What bounds it on the H100: at the flagship shapes ((B*4800, 384) bf16 x
// (384, 384) int8) the bytes, ~14.9 MB at batch 2, against 2.8 GOP that the
// int8 tensor cores would do in a third of that time. Design: one block per
// (64-row, 64-column) output tile, 256 threads with a 4 x 4 tile each. A
// first pass finds the tile's 64 row maxima (one warp per 8 rows, warp
// shuffles) into shared memory; then K is walked in chunks of 64: the x chunk
// is read, quantized with its row's scale and packed four k to an int32 in
// shared memory, the w_q chunk is packed the same way column by column, and
// __dp4a takes four int8 products per instruction into int32 accumulators.
// Shared memory is fixed (about 33 KB) whatever Cin. x is read twice (the
// maxima, then the chunks) and once per column tile, from L2 after the first.
// SIMT dp4a: mma.sync on s8 is a later step.
#include "common.cuh"

namespace {

constexpr int kBM = 64;    // rows per block
constexpr int kBN = 64;    // columns per block
constexpr int kBK = 64;    // k per shared-memory chunk
constexpr int kBK4 = kBK / 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInvQmax = 1.0f / 127.0f;   // float32(1/127), folded by the compiler

static __device__ __forceinline__ int quantize(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return max(-127, min(127, q));
}

static __device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const signed char* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ bias,
                   T* __restrict__ out, int m, int cin, int cout) {
  __shared__ float row_scale[kBM];
  __shared__ int xq[kBK4][kBM + 1];   // xq[k4][row]: 4 consecutive k packed; padded
                                      // so the chunk's stores spread over the banks
  __shared__ int wq[kBK4][kBN];   // wq[k4][col]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16;   // column lane
  const int ty = tid / 16;   // row lane
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // pass 1: the row scales
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    float amax = 0.f;
    if (row < m) {
      const T* xr = x + static_cast<size_t>(row) * cin;
      for (int k = lane; k < cin; k += 32) amax = fmaxf(amax, fabsf(to_f(xr[k])));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) row_scale[r] = amax > 0.f ? __fmul_rn(amax, kInvQmax) : 1.f;
  }
  __syncthreads();

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < cin; k0 += kBK) {
    // x chunk: 16 consecutive threads read 64 consecutive k of one row
    for (int e = tid; e < kBM * kBK4; e += kThreads) {
      const int k4 = e % kBK4, r = e / kBK4;
      const int row = m0 + r, k = k0 + 4 * k4;
      int q[4] = {0, 0, 0, 0};
      if (row < m) {
        const T* xr = x + static_cast<size_t>(row) * cin;
        const float xs = row_scale[r];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k + t < cin) q[t] = quantize(to_f(xr[k + t]), xs);
      }
      xq[k4][r] = pack4(q[0], q[1], q[2], q[3]);
    }
    // w chunk: consecutive threads read consecutive columns of 4 rows
    for (int e = tid; e < kBN * kBK4; e += kThreads) {
      const int c = e % kBN, k4 = e / kBN;
      const int col = n0 + c, k = k0 + 4 * k4;
      int q[4] = {0, 0, 0, 0};
      if (col < cout) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k + t < cin) q[t] = w[static_cast<size_t>(k + t) * cout + col];
      }
      wq[k4][c] = pack4(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int k4 = 0; k4 < kBK4; ++k4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xq[k4][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wq[k4][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= cout) continue;
    const float ws = w_scale[col], bs = bias[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (m0 + r >= m) continue;
      const float a = __fmul_rn(static_cast<float>(acc[i][j]), row_scale[r]);
      store_f(out + static_cast<size_t>(m0 + r) * cout + col, fmaf(a, ws, bs));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const signed char* w, const float* w_scale,
                   const float* bias, void* out, int m, int cin, int cout,
                   cudaStream_t stream) {
  dim3 grid(ceil_div(m, kBM), ceil_div(cout, kBN));
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, w_scale, bias, static_cast<T*>(out), m, cin, cout);
  return cudaGetLastError();
}

}  // namespace

// x (m, cin) in dtype; w (cin, cout) int8 row-major; w_scale, bias (cout,)
// float; out (m, cout) in dtype.
extern "C" int seld_int8_matmul(const void* x, const void* w, const void* w_scale,
                                const void* bias, void* out, int m, int cin, int cout,
                                int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wq = static_cast<const signed char*>(w);
  auto ws = static_cast<const float*>(w_scale);
  auto b = static_cast<const float*>(bias);
  cudaError_t err;
  if (m <= 0 || cin <= 0 || cout <= 0 || ceil_div(cout, kBN) > 65535)
    err = cudaErrorInvalidValue;
  else if (dtype == kF32)
    err = launch<float>(x, wq, ws, b, out, m, cin, cout, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(x, wq, ws, b, out, m, cin, cout, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
