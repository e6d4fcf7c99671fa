// Train-mode CNN stage 1: 3x3 conv (Cin <= 10, zero pad 1) -> BatchNorm with
// batch statistics -> ReLU -> max over `pf` frequency rows, with the
// backward for the weights and the BN affine (stage 1's input is data, so
// there is no dx).
//
// Replaces seld_tpu/ops/pallas/conv2d_train.py::
// conv2d_smallcin_bn_relu_fpool_train: its passes _stats_kernel (F1),
// _sel_stats_kernel (B1) and _bwd_dw_kernel (B2); the forward pass F2 is the
// serving kernel seld_conv3x3_smallcin (conv3x3_bn_relu_fpool.cu), fed the
// batch-statistics affine. The reference takes 3 * Cin <= 32 (its wide
// pack); here every pass stages CC = 8 input channels for Cin <= 8 and
// CC = 16 for Cin 9-10 (a K dimension of 9 * CC, zero-filled past Cin), so
// F1, F2 and B2 share one conv_rows<CC> and its fmaf order whatever Cin is.
// Layout: x (B, Cin, F, T), w (3, 3, Cin, Cout), out and its cotangent g
// (B, Cout, F/pf, T); every pass reads only t < T.
//
// - F1  seld_conv3x3_train_stats: per-channel sum and sum of squares of the
//       conv output over (B, F, T), recomputed per tile.
// - B1  seld_conv3x3_train_sel_stats: S_g = sum g and S_gx = sum g * xhat
//       over the positions where out > 0, from (out, g) alone: there the
//       pool-selected pre-activation equals out, so xhat = out * p - q with
//       p = inv / scale, q = (bias / scale + mean) * inv (0 where scale == 0).
// - B2  seld_conv3x3_train_dw: recomputes each pool row's conv with the
//       forward's conv_rows, routes g to the FIRST row holding the max (a
//       strict > running argmax, reduce_window's first-match rule) where
//       that max is > 0, forms g_z = g_pre * scale - acc * A - Bc (the
//       batch-stats BN backward scale * (g_pre - S_g/N - xhat * S_gx/N) with
//       A = inv * scale * S_gx/N, Bc = scale * S_g/N - mean * A: the
//       subtraction happens before the dW product), rounds g_z to the input
//       dtype, and accumulates dW[co][tap][ci] += g_z * x in float (ci
//       padded to CC). It also
//       emits the exact routed sums S_g and sum g_pre * acc, from which the
//       caller forms dgamma and dbeta.
// - every pass writes one row of per-block partial sums; launch_reduce
//   (conv3x3_common.cuh) sums the rows in a fixed order (double
//   accumulators), so a run repeats bitwise (no float atomics).
//
// What bounds it on the H100: arithmetic. Each conv recompute is
// 2 * 72 * Cout FLOP per conv pixel (34 GFLOP per pass for a batch of 8
// one-minute clips) and B2 does three such products (two recomputes and the
// dW product) on 72-wide operands (144 for CC = 16); the bytes (x, out, g) are a few hundred
// MB. Design: the K2 tile (64 channels x 128 frames per block, 256
// threads, halo and weights in shared memory); a block walks kTilesPerBlock
// frame tiles so that the partial rows stay small. B2 keeps the argmax row
// index per output in registers (pass A), recomputes each row (pass B),
// stages that row's g_z tile in shared memory and forms the 64 x 72 dW
// tile from it, 18 outputs per thread (36 for CC = 16). SIMT FMA: tensor
// cores come later.
#include "conv3x3_common.cuh"

namespace {

constexpr int kGzW = kBT + 1;   // padded row of the g_z tile (no bank conflicts)

template <typename T, int CC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ partials,
             int cin, int f_dim, int t_dim, int cout, int pf, int tiles_per_block) {
  extern __shared__ float smem[];
  float* xs = smem;                         // [pf + 2][CC][kXW]
  float* ws = smem + (pf + 2) * CC * kXW;   // [9][CC][kBCO]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int co0 = blockIdx.y * kBCO;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const T* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  stage_w<CC>(ws, w, 0, co0, cin, cout);
  for (int tile = 0; tile < tiles_per_block; ++tile) {
    const int t0 = (blockIdx.x * tiles_per_block + tile) * kBT;
    if (t0 >= t_dim) break;
    __syncthreads();   // the previous tile's readers are done
    stage_x<CC>(xs, xb, pf + 2, fo * pf - 1, 0, t0, cin, f_dim, t_dim);
    __syncthreads();
    for (int r = 0; r < pf; ++r) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      conv_rows<CC>(xs, ws, r, tx, ty, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (t0 + tx + 16 * j >= t_dim) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s1[i] += acc[i][j];
          s2[i] = fmaf(acc[i][j], acc[i][j], s2[i]);
        }
      }
    }
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = sum_tx(s1[i]), q = sum_tx(s2[i]);
    const int co = co0 + ty + 16 * i;
    if (tx == 0 && co < cout) {
      row[co] = a;
      row[cout + co] = q;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sel_stats_kernel(const T* __restrict__ out, const T* __restrict__ g,
                 const float* __restrict__ p_col, const float* __restrict__ q_col,
                 float* __restrict__ partials, int cout, int f_out, int t_dim) {
  __shared__ float red[2][kThreads];
  const int co = blockIdx.x;
  const int b = blockIdx.y / f_out, fo = blockIdx.y % f_out;
  const size_t base = ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
  const float p = p_col[co], q = q_col[co];
  float sg = 0.f, sgx = 0.f;
  for (int t = threadIdx.x; t < t_dim; t += kThreads) {
    const float o = to_f(out[base + t]);
    if (o > 0.f) {
      const float gv = to_f(g[base + t]);
      sg += gv;
      sgx = fmaf(gv, __fsub_rn(__fmul_rn(o, p), q), sgx);
    }
  }
  red[0][threadIdx.x] = sg;
  red[1][threadIdx.x] = sgx;
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
    }
  }
  if (threadIdx.x == 0) {
    float* row = partials + static_cast<size_t>(blockIdx.y) * 2 * cout;
    row[co] = red[0][0];
    row[cout + co] = red[1][0];
  }
}

template <typename T, int CC>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ scale,
          const float* __restrict__ bias, const float* __restrict__ a_col,
          const float* __restrict__ b_col, const T* __restrict__ g,
          float* __restrict__ partials, int cin, int f_dim, int t_dim, int cout, int pf,
          int tiles_per_block) {
  constexpr int kK = 9 * CC;                 // the dW row per output channel
  extern __shared__ float smem[];
  float* xs = smem;                          // [pf + 2][CC][kXW]
  float* ws = xs + (pf + 2) * CC * kXW;      // [9][CC][kBCO]
  float* gz = ws + 9 * CC * kBCO;            // [kBCO][kGzW]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int co0 = blockIdx.y * kBCO;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const T* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  float sc[4], bi[4], ac[4], bc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    const bool ok = co < cout;
    sc[i] = ok ? scale[co] : 0.f;
    bi[i] = ok ? bias[co] : 0.f;
    ac[i] = ok ? a_col[co] : 0.f;
    bc[i] = ok ? b_col[co] : 0.f;
  }
  // dW outputs of this thread: channel co0 + dw_co, k = dw_k0 + 4 j (k = tap * CC + ci)
  const int dw_co = tid % kBCO, dw_k0 = tid / kBCO;
  int x_off[kK / 4];   // offset of (dy, ci, dx) in xs relative to the conv row
#pragma unroll
  for (int j = 0; j < kK / 4; ++j) {
    const int k = dw_k0 + 4 * j, tap = k / CC, ci = k % CC;
    x_off[j] = ((tap / 3) * CC + ci) * kXW + tap % 3;
  }
  float dw[kK / 4];
#pragma unroll
  for (int j = 0; j < kK / 4; ++j) dw[j] = 0.f;
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, sga[4] = {0.f, 0.f, 0.f, 0.f};

  stage_w<CC>(ws, w, 0, co0, cin, cout);
  for (int tile = 0; tile < tiles_per_block; ++tile) {
    const int t0 = (blockIdx.x * tiles_per_block + tile) * kBT;
    if (t0 >= t_dim) break;
    __syncthreads();
    stage_x<CC>(xs, xb, pf + 2, fo * pf - 1, 0, t0, cin, f_dim, t_dim);
    __syncthreads();

    // pass A: the first row holding each output's max
    float m[4][8];
    unsigned char sel[4][8];
    for (int r = 0; r < pf; ++r) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      conv_rows<CC>(xs, ws, r, tx, ty, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = bn_relu(acc[i][j], sc[i], bi[i]);
          if (r == 0 || y > m[i][j]) {
            m[i][j] = y;
            sel[i][j] = static_cast<unsigned char>(r);
          }
        }
    }
    // the routed cotangent: nonzero only where the selected row's ReLU passes
    float gv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + ty + 16 * i;
      const T* grow = g + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + tx + 16 * j;
        gv[i][j] = (co < cout && t < t_dim && m[i][j] > 0.f) ? to_f(grow[t]) : 0.f;
      }
    }

    // pass B: per row, g_z into shared memory, then the dW tile
    for (int r = 0; r < pf; ++r) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      conv_rows<CC>(xs, ws, r, tx, ty, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool valid = t0 + tx + 16 * j < t_dim;
          const float gp = sel[i][j] == r ? gv[i][j] : 0.f;
          sg[i] += gp;
          sga[i] = fmaf(gp, acc[i][j], sga[i]);
          float z = valid ? gp * sc[i] - acc[i][j] * ac[i] - bc[i] : 0.f;
          if (sizeof(T) == 2) z = to_f(__float2bfloat16(z));   // the dW product's operand dtype
          gz[(ty + 16 * i) * kGzW + tx + 16 * j] = z;
        }
      __syncthreads();
      const float* xr = xs + r * CC * kXW;
      const float* gr = gz + dw_co * kGzW;
#pragma unroll 2
      for (int t = 0; t < kBT; ++t) {
        const float zv = gr[t];
#pragma unroll
        for (int j = 0; j < kK / 4; ++j) dw[j] = fmaf(zv, xr[x_off[j] + t], dw[j]);
      }
      __syncthreads();   // gz is rewritten by the next row
    }
  }

  const size_t width = static_cast<size_t>(cout) * (kK + 2);
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * width;
  if (co0 + dw_co < cout) {
#pragma unroll
    for (int j = 0; j < kK / 4; ++j) row[(co0 + dw_co) * kK + dw_k0 + 4 * j] = dw[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = sum_tx(sg[i]), q = sum_tx(sga[i]);
    const int co = co0 + ty + 16 * i;
    if (tx == 0 && co < cout) {
      row[static_cast<size_t>(cout) * kK + co] = a;
      row[static_cast<size_t>(cout) * (kK + 1) + co] = q;
    }
  }
}

int n_split(int t_dim, int tiles_per_block) {
  return ceil_div(ceil_div(t_dim, kBT), tiles_per_block);
}

// The staged channels of a Cin: 8, or 16 for Cin 9-10.
int staged_channels(int cin) { return cin <= kCC ? kCC : 2 * kCC; }

template <typename T, int CC>
cudaError_t launch_stats_cc(const void* x, const void* w, float* partials, int batch, int cin,
                            int f_dim, int t_dim, int cout, int pf, int tpb, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((pf + 2) * CC * kXW + 9 * CC * kBCO);
  cudaError_t err = set_smem(stats_kernel<T, CC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split(t_dim, tpb), ceil_div(cout, kBCO), batch * (f_dim / pf));
  stats_kernel<T, CC><<<grid, kThreads, smem, s>>>(static_cast<const T*>(x),
                                                   static_cast<const T*>(w), partials, cin,
                                                   f_dim, t_dim, cout, pf, tpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stats(const void* x, const void* w, float* partials, int batch, int cin,
                         int f_dim, int t_dim, int cout, int pf, int tpb, cudaStream_t s) {
  if (staged_channels(cin) == kCC)
    return launch_stats_cc<T, kCC>(x, w, partials, batch, cin, f_dim, t_dim, cout, pf, tpb, s);
  return launch_stats_cc<T, 2 * kCC>(x, w, partials, batch, cin, f_dim, t_dim, cout, pf, tpb,
                                     s);
}

template <typename T, int CC>
cudaError_t launch_dw_cc(const void* x, const void* w, const float* scale, const float* bias,
                         const float* a_col, const float* b_col, const void* g,
                         float* partials, int batch, int cin, int f_dim, int t_dim, int cout,
                         int pf, int tpb, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((pf + 2) * CC * kXW + 9 * CC * kBCO + kBCO * kGzW);
  cudaError_t err = set_smem(dw_kernel<T, CC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split(t_dim, tpb), ceil_div(cout, kBCO), batch * (f_dim / pf));
  dw_kernel<T, CC><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias, a_col, b_col,
      static_cast<const T*>(g), partials, cin, f_dim, t_dim, cout, pf, tpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* w, const float* scale, const float* bias,
                      const float* a_col, const float* b_col, const void* g, float* partials,
                      int batch, int cin, int f_dim, int t_dim, int cout, int pf, int tpb,
                      cudaStream_t s) {
  if (staged_channels(cin) == kCC)
    return launch_dw_cc<T, kCC>(x, w, scale, bias, a_col, b_col, g, partials, batch, cin,
                                f_dim, t_dim, cout, pf, tpb, s);
  return launch_dw_cc<T, 2 * kCC>(x, w, scale, bias, a_col, b_col, g, partials, batch, cin,
                                  f_dim, t_dim, cout, pf, tpb, s);
}

bool bad_shape(int cin, int cout, int pf) {
  return cin < 1 || cin > kMaxStagedCin || cout < 1 || pf < 1 || pf > 255;
}


}  // namespace

// F1 + its reduction: sums (2 * Cout,) = [sum | sum of squares] of the conv
// output over (B, F, T). partials: (B * F/pf * n_split, 2 * Cout) float.
extern "C" int seld_conv3x3_train_stats(const void* x, const void* w, void* partials, void* sums,
                                        int batch, int cin, int f_dim, int t_dim, int cout,
                                        int pf, int tiles_per_block, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (bad_shape(cin, cout, pf) || tiles_per_block < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == kF32)
    err = launch_stats<float>(x, w, part, batch, cin, f_dim, t_dim, cout, pf, tiles_per_block, s);
  else if (dtype == kBF16)
    err = launch_stats<__nv_bfloat16>(x, w, part, batch, cin, f_dim, t_dim, cout, pf,
                                      tiles_per_block, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * (f_dim / pf) * n_split(t_dim, tiles_per_block);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), rows, 2 * cout, s));
}

// B1 + its reduction: sums (2 * Cout,) = [S_g | S_gx] over out > 0.
// out, g: (B, Cout, F', T); p, q: (Cout,) float; partials: (B * F', 2 * Cout).
extern "C" int seld_conv3x3_train_sel_stats(const void* out, const void* g, const void* p,
                                            const void* q, void* partials, void* sums,
                                            int batch, int cout, int f_out, int t_dim,
                                            int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  auto pc = static_cast<const float*>(p);
  auto qc = static_cast<const float*>(q);
  if (cout < 1 || cout > 65535 || batch * f_out > 65535) return cudaErrorInvalidValue;
  dim3 grid(cout, batch * f_out);
  if (dtype == kF32)
    sel_stats_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(g), pc, qc, part, cout,
        f_out, t_dim);
  else if (dtype == kBF16)
    sel_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(g), pc, qc,
        part, cout, f_out, t_dim);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), batch * f_out,
                                        2 * cout, s));
}

// B2 + its reduction: sums (Cout * (9 CC + 2),) = [dW (Cout, 9 taps, CC ci) |
// S_g | sum g_pre * acc], CC = 8 for Cin <= 8, else 16. scale, bias, a, b:
// (Cout,) float; g: (B, Cout, F/pf, T); partials: (B * F/pf * n_split,
// Cout * (9 CC + 2)).
extern "C" int seld_conv3x3_train_dw(const void* x, const void* w, const void* scale,
                                     const void* bias, const void* a, const void* b,
                                     const void* g, void* partials, void* sums, int batch,
                                     int cin, int f_dim, int t_dim, int cout, int pf,
                                     int tiles_per_block, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  auto ac = static_cast<const float*>(a);
  auto bc = static_cast<const float*>(b);
  if (bad_shape(cin, cout, pf) || tiles_per_block < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == kF32)
    err = launch_dw<float>(x, w, sc, bi, ac, bc, g, part, batch, cin, f_dim, t_dim, cout, pf,
                           tiles_per_block, s);
  else if (dtype == kBF16)
    err = launch_dw<__nv_bfloat16>(x, w, sc, bi, ac, bc, g, part, batch, cin, f_dim, t_dim,
                                   cout, pf, tiles_per_block, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * (f_dim / pf) * n_split(t_dim, tiles_per_block);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), rows,
                                        cout * (9 * staged_channels(cin) + 2), s));
}
