// Train-mode CNN stages 2-3: 3x3 conv (Cin % 8 == 0, zero pad 1) ->
// BatchNorm with batch statistics -> ReLU -> max over `pf` frequency rows,
// with the backward for the input (stage 2 passes gradient to stage 1), the
// weights and the BN affine.
//
// Replaces seld_tpu/ops/pallas/conv2d_ct_train.py::
// conv2d_widecin_ct_bn_relu_fpool_train: its passes _ct_stats_kernel (F1),
// _ct_bwd_stats_kernel (B1), _ct_dw_kernel (B2) and _ct_dx_kernel (B3); the
// forward pass F2 (_ct_fwd_kernel) is the serving kernel seld_conv3x3_widecin
// (conv3x3_bn_relu_fpool.cu) fed the batch-statistics affine. Layout: h
// (B, Cin, F, T), w (3, 3, Cin, Cout), out and its cotangent g
// (B, Cout, F/pf, T); every pass reads only t < T.
//
// - F1  seld_ct_train_stats: the conv rows on the serving kernel's block
//       tile (FtPipe, split TF32, in float32; TbPipe in bfloat16: same Cin
//       chunk order, same products, so bitwise the values F2 pools), written
//       once as pre (B, Cout, F, T) float, and per-channel partial sums and
//       sums of squares.
// - B1  seld_ct_train_sel_stats: routes g to the FIRST row of each pool
//       window holding the max of relu(pre * scale + bias) (a strict >
//       running argmax, reduce_window's first-match rule) where that max is
//       > 0 (a window holding a NaN routes nothing, as JAX's), and sums S_g
//       = sum g_pre and S_gx = sum g_pre * xhat with xhat = (pre - mean) *
//       inv.
// - B2  seld_ct_train_gz: the same routing, then the batch-stats BN backward
//       g_z = scale * (g_pre - S_g/N - xhat * S_gx/N) (the subtraction before
//       any product), rounded to the input dtype and written once as
//       gz (B, Cout, F, T); seld_ct_train_dw: dW[dy][dx][ci][co] = sum over
//       (b, f, t) of gz[b][co][f][t] * h[b][ci][f + dy - 1][t + dx - 1].
// - B3  seld_ct_train_dx: dh = the transposed conv of gz with w (taps
//       flipped, Cin and Cout swapped) on the block tile with transposed
//       weights: FtPipe<true> (split TF32) in float32, TbPipe<true> (the
//       weights staged [tap][co][ci]) in bfloat16; no affine, ReLU or pool.
// - the sums (F1, B1, dW) go through per-block partial rows and
//   launch_reduce: a fixed order in double, no atomics, so a run repeats
//   bitwise.
//
// What bounds it on the H100: arithmetic. The function needs three
// conv-sized products (the forward conv, dW and dh: 2 * 9 * Cin * Cout
// operations per conv pixel each, 0.8 TFLOP for a flagship stage 2 at
// batch 8). F1 and F2 each run the forward conv (F2 is the serving kernel,
// which pools on the fly and keeps no pre-activation), B2 and B3 one product
// each; the TPU kernel's recomputes in B1, B2 and B3 become reads of pre and
// gz, which an 80 GB card holds (944 MB of pre and 472 MB of bf16 gz for
// that stage). Design: F1 is K3's block tile (64 channels x 64 frames x 4
// rows a pass, 256 threads: conv3x3_tc.cuh's in bfloat16, its split-TF32
// counterpart conv3x3_tf32.cuh in float32), and so is B3 on the
// transposed weights; B1 and B2's gz pass
// stream one (b, channel, pooled row) per block; the dW pass gives each
// block a share of the depth, split over the (b, f) rows and, where B * F
// is small (stage 3: 8 rows at batch 2), over frames, so that every SM
// has blocks. In bfloat16 the dW pass is the tensor-core GEMM of
// conv3x3_dw_tc.cuh (ct_dw_tc_kernel: 9 taps x 32 Cin x 64 Cout per
// block, the frames as the depth, the tap shift built from aligned words by
// byte permutes); in float32 the same GEMM in split TF32 (ct_dw_tf32_kernel<32>
// of conv3x3_dw_tf32.cuh: three TF32 products a product, the A operand's
// tap shift a one-word offset, each 64-frame step summed apart and added to
// the accumulators rounded to nearest).
#include "conv3x3_dw_tc.cuh"
#include "conv3x3_dw_tf32.cuh"
#include "conv3x3_tf32.cuh"

namespace {

constexpr int kCols = 6;        // rows of the per-channel columns: scale, bias, mean, inv, c1, c2

// The window's max of relu(pre * scale + bias) over its pf rows, and `sel`,
// the first row holding it (strict >, so ties keep the earlier row). The max
// is taken with max_nan: a NaN in any row makes it NaN, so the caller's
// `> 0.f` routes nothing for that window. That is JAX's _route_group
// (seld_tpu/ops/pallas/conv2d_ct_train.py:97-112): jnp.maximum over the
// rows, then the first row equal to the max (none equals a NaN), where its
// pre-activation is > 0. Finite windows route as the strict > alone does.
static __device__ __forceinline__ float route_first_max(const float* __restrict__ prow,
                                                        size_t row_stride, int pf, int t,
                                                        float sc, float bi, int& sel) {
  float best = 0.f, m = 0.f;
  sel = 0;
  for (int r = 0; r < pf; ++r) {
    const float y = bn_relu(prow[r * row_stride + t], sc, bi);
    if (r == 0 || y > best) {
      best = y;
      sel = r;
    }
    m = max_nan(m, y);
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ct_sel_stats_kernel(const float* __restrict__ pre, const T* __restrict__ g,
                    const float* __restrict__ cols, float* __restrict__ partials, int cout,
                    int f_dim, int t_dim, int pf) {
  __shared__ float red[2][kThreads];
  const int co = blockIdx.x;
  const int f_out = f_dim / pf;
  const int b = blockIdx.y / f_out, fo = blockIdx.y % f_out;
  const float* prow = pre + ((static_cast<size_t>(b) * cout + co) * f_dim + fo * pf) * t_dim;
  const T* grow = g + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
  const float sc = cols[co], bi = cols[cout + co];
  const float mu = cols[2 * cout + co], iv = cols[3 * cout + co];
  float sg = 0.f, sgx = 0.f;
  for (int t = threadIdx.x; t < t_dim; t += kThreads) {
    int sel;
    const float m = route_first_max(prow, t_dim, pf, t, sc, bi, sel);
    if (m > 0.f) {
      const float gv = to_f(grow[t]);
      sg += gv;
      sgx = fmaf(gv, (prow[static_cast<size_t>(sel) * t_dim + t] - mu) * iv, sgx);
    } else if (m != m) {
      sgx += m;   // a NaN window routes nothing, but JAX's sum of g_pre * xhat is NaN
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ct_gz_kernel(const float* __restrict__ pre, const T* __restrict__ g,
             const float* __restrict__ cols, T* __restrict__ gz, int cout, int f_dim,
             int t_dim, int pf) {
  const int co = blockIdx.x;
  const int f_out = f_dim / pf;
  const int b = blockIdx.y / f_out, fo = blockIdx.y % f_out;
  const size_t base = ((static_cast<size_t>(b) * cout + co) * f_dim + fo * pf) * t_dim;
  const float* prow = pre + base;
  T* zrow = gz + base;
  const T* grow = g + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
  const float sc = cols[co], bi = cols[cout + co];
  const float mu = cols[2 * cout + co], iv = cols[3 * cout + co];
  const float c1 = cols[4 * cout + co], c2 = cols[5 * cout + co];
  for (int t = threadIdx.x; t < t_dim; t += kThreads) {
    int sel;
    const float gv = route_first_max(prow, t_dim, pf, t, sc, bi, sel) > 0.f ? to_f(grow[t]) : 0.f;
    for (int r = 0; r < pf; ++r) {
      const size_t at = static_cast<size_t>(r) * t_dim + t;
      const float xhat = (prow[at] - mu) * iv;
      store_f(zrow + at, sc * ((r == sel ? gv : 0.f) - c1 - xhat * c2));
    }
  }
}

// F1's epilogue of one pass on either block tile: this warp's conv row f of
// acc (64 channels x 32 frames) written once to pre, its per-channel sums
// added to red (tb_add_sums) in a fixed order.
static __device__ __forceinline__ void tb_stats_row(float* __restrict__ pre,
                                                    float* __restrict__ red, const TbAcc& acc,
                                                    int b, int f, int co0, int t0, int cout,
                                                    int f_dim, int t_dim) {
  const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2;
  float s1[4][2] = {}, s2[4][2] = {};
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int co = co0 + tb_m(lane, mi, 2 * hh);
      if (co >= cout) continue;
      float* prow = pre + ((static_cast<size_t>(b) * cout + co) * f_dim + f) * t_dim;
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni) {
        const int t = t0 + tb_n(half, lane, ni, 0);
        const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
        if (t + 1 < t_dim && reinterpret_cast<uintptr_t>(prow + t) % 8 == 0) {
          *reinterpret_cast<float2*>(prow + t) = make_float2(v0, v1);
        } else {
          if (t < t_dim) prow[t] = v0;
          if (t + 1 < t_dim) prow[t + 1] = v1;
        }
        if (t < t_dim) {
          s1[mi][hh] += v0;
          s2[mi][hh] = fmaf(v0, v0, s2[mi][hh]);
        }
        if (t + 1 < t_dim) {
          s1[mi][hh] += v1;
          s2[mi][hh] = fmaf(v1, v1, s2[mi][hh]);
        }
      }
    }
  tb_add_sums(red, s1, s2);
}

// F1's bfloat16 body: K3's block tile (TbPipe, the same rows of a
// block, chunks and fragments as conv3x3_tc_kernel, so pre equals F2's conv
// rows bitwise), written once as pre, with per-channel sums over the
// block's rows and frames in a fixed order (tb_add_sums, tb_channel_sums).
__global__ void __launch_bounds__(kTcThreads, 1)
ct_stats_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w, float* __restrict__ pre,
                   float* __restrict__ partials, int cin, int f_dim, int t_dim, int cout,
                   int pf) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* red = reinterpret_cast<float*>(tc_smem + tb_ring_bytes<false>());
  const int t0 = blockIdx.x * kTbT;
  const int co0 = blockIdx.y * kTcCo;
  const int rows = tb_block_rows(pf);
  const int blocks_f = ceil_div(f_dim, rows);
  const int b = blockIdx.z / blocks_f, f_first = (blockIdx.z % blocks_f) * rows;
  const bf16* hb = h + static_cast<size_t>(b) * cin * f_dim * t_dim;

  const int n_rows = min(rows, f_dim - f_first);
  tb_zero_sums(red);
  TbPipe<false> pipe(reinterpret_cast<bf16*>(tc_smem), hb, w, f_first, n_rows, co0, t0, cin,
                     f_dim, t_dim, cout);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    tb_stats_row(pre, red, acc, b, f_first + pipe.row, co0, t0, cout, f_dim, t_dim);
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  tb_channel_sums(red, co0, cout, row);
}

// F1's float32 body: the same on the split-TF32 tile (FtPipe of
// conv3x3_tf32.cuh), whose rows equal conv3x3_tf32_kernel's (K3's float32
// body, F2) bitwise.
__global__ void __launch_bounds__(kTcThreads, 1)
ct_stats_tf32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     float* __restrict__ pre, float* __restrict__ partials, int cin, int f_dim,
                     int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  float* red = reinterpret_cast<float*>(ft_smem + ft_ring_bytes());
  const int t0 = blockIdx.x * kTbT;
  const int co0 = blockIdx.y * kTcCo;
  const int rows = tb_block_rows(pf);
  const int blocks_f = ceil_div(f_dim, rows);
  const int b = blockIdx.z / blocks_f, f_first = (blockIdx.z % blocks_f) * rows;
  const float* hb = h + static_cast<size_t>(b) * cin * f_dim * t_dim;

  const int n_rows = min(rows, f_dim - f_first);
  tb_zero_sums(red);
  FtPipe<false> pipe(reinterpret_cast<float*>(ft_smem), hb, w, f_first, n_rows, co0, t0, cin,
                     f_dim, t_dim, cout);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    tb_stats_row(pre, red, acc, b, f_first + pipe.row, co0, t0, cout, f_dim, t_dim);
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  tb_channel_sums(red, co0, cout, row);
}

// dh's bfloat16 body: conv rows f0 .. f0 + 3 of gz (K = Cout channels) with
// the transposed, flipped weights on the block tile, stored in bf16.
__global__ void __launch_bounds__(kTcThreads, 1)
ct_dx_tc_kernel(const bf16* __restrict__ gz, const bf16* __restrict__ w, bf16* __restrict__ dh,
                int cin, int f_dim, int t_dim, int cout) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2;
  const int t0 = blockIdx.x * kTbT;
  const int c0 = blockIdx.y * kTcCo;
  const int blocks_f = ceil_div(f_dim, kTbSlots);
  const int b = blockIdx.z / blocks_f, f0 = (blockIdx.z % blocks_f) * kTbSlots;
  const bf16* gb = gz + static_cast<size_t>(b) * cout * f_dim * t_dim;
  const bool pairs = t_dim % 2 == 0;
  const int n_rows = min(kTbSlots, f_dim - f0);
  TbPipe<true> pipe(reinterpret_cast<bf16*>(tc_smem), gb, w, f0, n_rows, c0, t0, cout, f_dim,
                    t_dim, cin);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c0 + tb_m(lane, mi, 2 * hh);
        if (c >= cin) continue;
        bf16* drow = dh + ((static_cast<size_t>(b) * cin + c) * f_dim + f0 + pipe.row) * t_dim;
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          const int t = t0 + tb_n(half, lane, ni, 0);
          const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
          if (pairs && t + 1 < t_dim) {
            *reinterpret_cast<__nv_bfloat162*>(drow + t) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (t < t_dim) drow[t] = __float2bfloat16(v0);
            if (t + 1 < t_dim) drow[t + 1] = __float2bfloat16(v1);
          }
        }
      }
  }
}

// dh's float32 body: the same rows on the split-TF32 tile (FtPipe<true>:
// the weights w[8 - tap][c][co] split once at staging, gz's rows split as
// read), each warp's 64 x 32 tile of row f0 + pipe.row stored in float32
// (pairs of frames where aligned), masked to c < Cin and t < T. At 255
// registers a thread: the row taken once a pass (fr); with f0 + pipe.row in
// each row's address ptxas spilled 8 bytes (PERF.md §6).
__global__ void __launch_bounds__(kTcThreads, 1)
ct_dx_tf32_kernel(const float* __restrict__ gz, const float* __restrict__ w,
                  float* __restrict__ dh, int cin, int f_dim, int t_dim, int cout) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  const int t0 = blockIdx.x * kTbT;
  const int c0 = blockIdx.y * kTcCo;
  const int blocks_f = ceil_div(f_dim, kTbSlots);
  const int b = blockIdx.z / blocks_f, f0 = (blockIdx.z % blocks_f) * kTbSlots;
  const float* gb = gz + static_cast<size_t>(b) * cout * f_dim * t_dim;
  const int n_rows = min(kTbSlots, f_dim - f0);
  FtPipe<true> pipe(reinterpret_cast<float*>(ft_smem), gb, w, f0, n_rows, c0, t0, cout, f_dim,
                    t_dim, cin);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2, fr = f0 + pipe.row;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c0 + tb_m(lane, mi, 2 * hh);
        if (c >= cin) continue;
        float* drow = dh + ((static_cast<size_t>(b) * cin + c) * f_dim + fr) * t_dim;
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          const int t = t0 + tb_n(half, lane, ni, 0);
          const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
          if (t + 1 < t_dim && reinterpret_cast<uintptr_t>(drow + t) % 8 == 0) {
            *reinterpret_cast<float2*>(drow + t) = make_float2(v0, v1);
          } else {
            if (t < t_dim) drow[t] = v0;
            if (t + 1 < t_dim) drow[t + 1] = v1;
          }
        }
      }
  }
}

// Run f(T{}) with T the storage type of `dtype`.
template <typename F>
cudaError_t by_dtype(int dtype, F&& f) {
  if (dtype == kF32) return f(float{});
  if (dtype == kBF16) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// F1 + its reduction: pre (B, Cout, F, T) float = conv(h, w); sums
// (2 * Cout,) = [sum | sum of squares] of pre over (B, F, T). partials:
// (B * ceil(F / tb_block_rows(pf)) * ceil(T / 64), 2 * Cout) float, the
// block tiles' grid (both dtypes).
extern "C" int seld_ct_train_stats(const void* h, const void* w, void* pre, void* partials,
                                   void* sums, int batch, int cin, int f_dim, int t_dim,
                                   int cout, int pf, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (cin < 1 || cin % kCC || cout < 1 || pf < 1 || f_dim % pf) return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(t_dim, kTbT), ceil_div(cout, kTcCo),
                  batch * ceil_div(f_dim, tb_block_rows(pf)));
  cudaError_t err = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem = tb_ring_bytes<false>() + sizeof(float) * kTbRed;
      cudaError_t e = set_smem(ct_stats_tc_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_stats_tc_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<float*>(pre),
          part, cin, f_dim, t_dim, cout, pf);
    } else {
      constexpr size_t smem = ft_ring_bytes() + sizeof(float) * kTbRed;
      cudaError_t e = set_smem(ct_stats_tf32_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_stats_tf32_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const float*>(h), static_cast<const float*>(w), static_cast<float*>(pre),
          part, cin, f_dim, t_dim, cout, pf);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums),
                                        static_cast<int>(grid.x * grid.z), 2 * cout, s));
}

// B1 + its reduction: sums (2 * Cout,) = [S_g | S_gx]. pre (B, Cout, F, T)
// float, g (B, Cout, F/pf, T), cols (6, Cout) float (rows scale, bias, mean,
// inv used), partials (B * F/pf, 2 * Cout).
extern "C" int seld_ct_train_sel_stats(const void* pre, const void* g, const void* cols,
                                       void* partials, void* sums, int batch, int cout,
                                       int f_dim, int t_dim, int pf, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (cout < 1 || cout > 65535 || pf < 1 || f_dim % pf || batch * (f_dim / pf) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(cout, batch * (f_dim / pf));
  cudaError_t err = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    ct_sel_stats_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(pre), static_cast<const T*>(g),
        static_cast<const float*>(cols), part, cout, f_dim, t_dim, pf);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums),
                                        static_cast<int>(grid.y), 2 * cout, s));
}

// B2, g_z: gz (B, Cout, F, T) in the input dtype. pre, g as for B1; cols
// (6, Cout) float: scale, bias, mean, inv, c1 = S_g / N, c2 = S_gx / N.
extern "C" int seld_ct_train_gz(const void* pre, const void* g, const void* cols, void* gz,
                                int batch, int cout, int f_dim, int t_dim, int pf, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cout < 1 || cout > 65535 || pf < 1 || f_dim % pf || batch * (f_dim / pf) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(cout, batch * (f_dim / pf));
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    ct_gz_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(pre), static_cast<const T*>(g),
        static_cast<const float*>(cols), static_cast<T*>(gz), cout, f_dim, t_dim, pf);
    return cudaGetLastError();
  }));
}

// B2, dW + its reduction: sums (3, 3, Cin, Cout) float. h (B, Cin, F, T), gz
// (B, Cout, F, T); the depth split into ceil(B * F / rows_per_split) x
// ceil(T / frames_per_split) shares (frames_per_split a multiple of 64 or
// at least T); partials (that many shares, 9 * Cin * Cout).
extern "C" int seld_ct_train_dw(const void* h, const void* gz, void* partials, void* sums,
                                int batch, int cin, int f_dim, int t_dim, int cout,
                                int rows_per_split, int frames_per_split, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (cin < 1 || cin % kCC || cout < 1 || rows_per_split < 1 || frames_per_split < 1 ||
      (frames_per_split < t_dim && frames_per_split % kDwT))
    return cudaErrorInvalidValue;
  const int splits = ceil_div(batch * f_dim, rows_per_split) * ceil_div(t_dim, frames_per_split);
  cudaError_t err = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem = dw_tc_smem<kDwCi>();
      cudaError_t e = set_smem(ct_dw_tc_kernel<kDwCi>, smem);
      if (e != cudaSuccess) return e;
      const dim3 grid(splits, ceil_div(cout, kDwCo), ceil_div(cin, kDwCi));
      ct_dw_tc_kernel<kDwCi><<<grid, kDwThreads, smem, s>>>(
          static_cast<const bf16*>(h), static_cast<const bf16*>(gz), part, batch, cin, f_dim,
          t_dim, cout, rows_per_split, frames_per_split);
    } else {
      constexpr size_t smem = dwf_smem<kDwfCi>();
      cudaError_t e = set_smem(ct_dw_tf32_kernel<kDwfCi>, smem);
      if (e != cudaSuccess) return e;
      const dim3 grid(splits, ceil_div(cout, kDwfCo), ceil_div(cin, kDwfCi));
      ct_dw_tf32_kernel<kDwfCi><<<grid, dwf_threads<kDwfCi>(), smem, s>>>(
          static_cast<const float*>(h), static_cast<const float*>(gz), part, batch, cin, f_dim,
          t_dim, cout, rows_per_split, frames_per_split);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), splits,
                                        9 * cin * cout, s));
}

// B3: dh (B, Cin, F, T) in the input dtype from gz (B, Cout, F, T) and w,
// on the block tiles' grid (64 frames x 64 channels x 4 rows a block).
extern "C" int seld_ct_train_dx(const void* gz, const void* w, void* dh, int batch, int cin,
                                int f_dim, int t_dim, int cout, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cout < 1 || batch * ceil_div(f_dim, kTbSlots) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(t_dim, kTbT), ceil_div(cin, kTcCo), batch * ceil_div(f_dim, kTbSlots));
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem = tb_ring_bytes<true>();
      cudaError_t e = set_smem(ct_dx_tc_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_dx_tc_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const bf16*>(gz), static_cast<const bf16*>(w), static_cast<bf16*>(dh),
          cin, f_dim, t_dim, cout);
    } else {
      constexpr size_t smem = ft_ring_bytes();
      cudaError_t e = set_smem(ct_dx_tf32_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_dx_tf32_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const float*>(gz), static_cast<const float*>(w), static_cast<float*>(dh),
          cin, f_dim, t_dim, cout);
    }
    return cudaGetLastError();
  }));
}
