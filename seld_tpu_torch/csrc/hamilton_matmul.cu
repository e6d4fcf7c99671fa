// Fused Hamilton-product matmul (K7): out = x @ assemble(comps) + bias, with
// the signed block weight assembled from its components inside the kernel.
//
// Replaces seld_tpu/ops/pallas/qmatmul.py::_hamilton_matmul (_matmul_kernel,
// _assemble_q, _assemble_dq), which pallas_q_linear and pallas_dq_linear
// call forward and, on the conjugate, for dx in their custom VJP. x is (M,
// n*cin_c), comps (n, cin_c, cout_c) with n = 4 (quaternion) or 8 (dual
// quaternion), out (M, n*cout_c). Weight element (r, c) lies in Hamilton
// block (a, b) = (r / cin_c, c / cout_c) and is sign * comps[idx][r % cin_c]
// [c % cout_c], with (idx, sign) = T[b][a] (conv table) or T[a][b] (linear
// table) of the 4 x 4 quaternion table, and for n = 8 the dual blocks: Q on
// both diagonal halves, Q_e (idx + 4) in one corner and zero in the other
// ((in >= 4, out < 4) zero for the conv table, (in < 4, out >= 4) for the
// linear one). At the flagship cin_c = cout_c = 48, so every 64-wide tile
// crosses block edges: the block is found per element, not per tile. The
// assembled weight is never written to device memory.
//
// Products are summed in float32 (no TF32: float32 stays full float32), the
// bias (rounded to x's dtype by the wrapper) is added in float32, and the
// result is rounded once to x's dtype.
//
// What bounds it on the H100: in float32, operations (2.8 GFLOP at
// (9600, 384) x (384, 384) against 67 TFLOP/s outside the tensor cores); in
// bfloat16, bytes (x and out, 14.7 MB at that shape). Design: one block per
// (64-row, 64-column) output tile, 256 threads with a 4 x 4 tile each, K in
// chunks of 32 staged through shared memory: the x chunk transposed, the
// weight chunk assembled from the components as it is staged (each thread
// stages one fixed column, so its Hamilton column block is found once).
// SIMT FMA: tensor cores (mma.sync / wgmma) are a later step.
#include "common.cuh"

namespace {

constexpr int kBM = 64;   // rows per block
constexpr int kBN = 64;   // columns per block
constexpr int kBK = 32;   // k per shared-memory chunk
constexpr int kThreads = 256;

// seld_tpu/ops/hamilton.py::Q_TABLE: T[i][j] = (component, sign)
__constant__ signed char kIdx[4][4] = {{0, 1, 2, 3}, {1, 0, 3, 2}, {2, 3, 0, 1}, {3, 2, 1, 0}};
__constant__ signed char kSgn[4][4] = {
    {1, -1, -1, -1}, {1, 1, -1, 1}, {1, 1, 1, -1}, {1, -1, 1, 1}};

template <typename T>
__global__ void __launch_bounds__(kThreads)
hamilton_matmul_kernel(const T* __restrict__ x, const T* __restrict__ comps,
                       const float* __restrict__ bias, T* __restrict__ out, int m,
                       int n_comp, int cin_c, int cout_c, int linear_table) {
  __shared__ float as[kBK][kBM + 1];   // x chunk, transposed: as[k][row]
  __shared__ float bs[kBK][kBN];       // assembled weight chunk

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column lane
  const int ty = tid / 16;   // row lane
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int cin = n_comp * cin_c, cout = n_comp * cout_c;

  // the weight column this thread stages, and its Hamilton column block
  const int sc = tid % kBN;
  const int col = n0 + sc;
  const bool col_ok = col < cout;
  const int b = col_ok ? col / cout_c : 0;
  const int cc = col - b * cout_c;
  const int qb = b & 3, db = b >> 2;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int kk = e % kBK, r = e / kBK;
      const int row = m0 + r, k = k0 + kk;
      as[kk][r] = (row < m && k < cin) ? to_f(x[static_cast<size_t>(row) * cin + k]) : 0.f;
    }
    for (int kk = tid / kBN; kk < kBK; kk += kThreads / kBN) {
      const int r = k0 + kk;
      float v = 0.f;
      if (col_ok && r < cin) {
        const int a = r / cin_c;
        const int rr = r - a * cin_c;
        const int qa = a & 3, da = a >> 2;
        int idx = linear_table ? kIdx[qa][qb] : kIdx[qb][qa];
        const int sgn = linear_table ? kSgn[qa][qb] : kSgn[qb][qa];
        bool zero = false;
        if (da != db) {   // n = 8: the off-diagonal dual blocks
          zero = linear_table ? (da == 0) : (da == 1);
          idx += 4;
        }
        if (!zero) {
          v = to_f(comps[(static_cast<size_t>(idx) * cin_c + rr) * cout_c + cc]);
          v = sgn < 0 ? -v : v;
        }
      }
      bs[kk][sc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + tx + 16 * j;
    if (c >= cout) continue;
    const float bc = bias[c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < m) store_f(out + static_cast<size_t>(row) * cout + c, acc[i][j] + bc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* comps, const float* bias, void* out, int m,
                   int n_comp, int cin_c, int cout_c, int linear_table, cudaStream_t stream) {
  dim3 grid(ceil_div(m, kBM), ceil_div(n_comp * cout_c, kBN));
  hamilton_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(comps), bias, static_cast<T*>(out), m,
      n_comp, cin_c, cout_c, linear_table);
  return cudaGetLastError();
}

}  // namespace

// x (m, n*cin_c) and comps (n, cin_c, cout_c) in dtype; bias (n*cout_c,)
// float; out (m, n*cout_c) in dtype; linear_table 0 (conv table) or 1.
extern "C" int seld_hamilton_matmul(const void* x, const void* comps, const void* bias,
                                    void* out, int m, int n_comp, int cin_c, int cout_c,
                                    int linear_table, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  cudaError_t err;
  if (m <= 0 || (n_comp != 4 && n_comp != 8) || cin_c <= 0 || cout_c <= 0 ||
      ceil_div(n_comp * cout_c, kBN) > 65535)
    err = cudaErrorInvalidValue;
  else if (dtype == kF32)
    err = launch<float>(x, comps, b, out, m, n_comp, cin_c, cout_c, linear_table, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(x, comps, b, out, m, n_comp, cin_c, cout_c, linear_table, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
