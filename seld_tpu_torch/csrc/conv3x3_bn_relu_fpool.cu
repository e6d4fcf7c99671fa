// Fused CNN-frontend stage: 3x3 conv (stride 1, zero pad 1) -> folded BN
// affine -> ReLU -> max over `pf` frequency rows, writing only the pooled row.
//
// Replaces seld_tpu/ops/pallas/conv2d_pool.py::
//   conv2d_smallcin_thin_bn_relu_fpool (_smallcin_thin_kernel), stage 1,
//   Cin <= 8: entry seld_conv3x3_smallcin (which also takes Cin 9-10 with
//   16 staged channels, for K5's float32 forward at the reference's
//   3 * Cin <= 32);
//   conv2d_widecin_ct_bn_relu_fpool (_widecin_ct_kernel), stages 2-3,
//   Cin % 8 == 0: entry seld_conv3x3_widecin (which conv3x3_windows.cu's
//   K10b entry also launches, for any Cin).
// Contract: x (B, Cin, F, T), w (3, 3, Cin, Cout), scale/bias (Cout,) float
// -> out (B, Cout, F/pf, T) with out = max_r relu(conv(x)[f*pf + r] * scale +
// bias). The max is taken after the affine and ReLU; T is not pooled.
//
// What bounds it on the H100: arithmetic (2*9*Cin*Cout FLOP per output
// pixel: stage 2 of the flagship is 102 GFLOP per clip), and, without the
// fusion, memory: stage 1's unpooled (B, 192, 256, T) activation is 1.9 GB
// per clip in bf16. Design: one block per (b, pooled row, 64-channel Cout
// tile, 128-frame T tile), 256 threads. float32: each thread holds a
// 4-channel x 8-frame float accumulator (SIMT FMA, TF32 off); bfloat16
// widecin: the tensor-core tile of conv3x3_tc.cuh (mma.sync, bf16 operands
// staged through a two-stage ring, float accumulators in the m16n8
// fragment layout), its epilogue folding each row into the running max.
// The input halo (conv rows x 8 channels x (T tile + 2)) and the matching
// 9 x 8 x 64 weight slice are staged in shared memory with
// the conv's zero padding written at the F and T borders, so the inner loop
// never branches. The pool rows are computed one after another into the
// same accumulator and folded into a running max, so only one row of
// accumulators lives in registers whatever pf is.
// - smallcin: all taps and channels (K = 9 x 8 = 72, or 9 x 16 for Cin
//   9-10) and all pf + 2 halo rows are staged once per block; SIMT in both
//   dtypes.
// - widecin: Cin is walked in chunks (8 in float32, conv_row_widecin; 16 in
//   bfloat16, conv_rows_tc) for each pool row; each step stages that row's
//   3-row halo and weight chunk. The train-mode stages 2-3 share both rows,
//   so that their conv rows equal these bitwise. The staging zero-fills
//   channels >= Cin, so a ragged last chunk is exact and any Cin works; the
//   Python router sends only Cin % 8 == 0 here as K3.
#include "conv3x3_tc.cuh"

namespace {

// CC: the channels staged at once (kCC, or 2 * kCC for the smallcin entry's
// Cin 9-10; the widecin path walks chunks of kCC).
template <typename T, bool kSmall, int CC = kCC>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ float smem[];
  const int rows = kSmall ? pf + 2 : 3;
  float* xs = smem;                   // [rows][CC][kXW]
  float* ws = smem + rows * CC * kXW; // [9][CC][kBCO]

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
    stage_w<CC>(ws, w, 0, co0, cin, cout);
    stage_x<CC>(xs, xb, rows, fo * pf - 1, 0, t0, cin, f_dim, t_dim);
    __syncthreads();
  }
  for (int r = 0; r < pf; ++r) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if (kSmall) {
      conv_rows<CC>(xs, ws, r, tx, ty, acc);
    } else {
      conv_row_widecin(xs, ws, xb, w, fo * pf + r, co0, t0, cin, f_dim, t_dim, cout, tx, ty,
                       acc);
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

// K3's bfloat16 body: conv rows fo * pf .. + pf - 1 on the tensor-core tile,
// each folded into the running max of relu(acc * scale + bias).
__global__ void __launch_bounds__(kTcThreads, 2)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  bf16* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int t0 = blockIdx.x * kTcT;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;
  const bf16* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  // relu output is >= 0, so 0 is the identity of the running max
  float best[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[mi][ni][e] = 0.f;

  conv_rows_tc<false>(reinterpret_cast<bf16*>(tc_smem), xb, w, fo * pf, pf, co0, t0, cin,
                      f_dim, t_dim, cout, [&](int, const float (&acc)[2][4][4]) {
#pragma unroll
                        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                          for (int h = 0; h < 2; ++h) {
                            // read here, not held in registers across the pipeline
                            const int co = min(co0 + tc_m(warp_m, lane, mi, 2 * h), cout - 1);
                            const float sc = __ldg(scale + co), bi = __ldg(bias + co);
#pragma unroll
                            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                              for (int e2 = 0; e2 < 2; ++e2)
                                best[mi][ni][2 * h + e2] = fmaxf(
                                    best[mi][ni][2 * h + e2],
                                    bn_relu(acc[mi][ni][2 * h + e2], sc, bi));
                          }
                      });

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + tc_m(warp_m, lane, mi, 2 * h);
      if (co >= cout) continue;
      bf16* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int t = t0 + tc_n(warp_n, lane, ni, e2);
          if (t < t_dim) orow[t] = __float2bfloat16(best[mi][ni][2 * h + e2]);
        }
    }
}

template <typename T, bool kSmall, int CC>
cudaError_t launch_cc(const void* x, const void* w, const float* scale, const float* bias,
                      void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                      cudaStream_t stream) {
  const int rows = kSmall ? pf + 2 : 3;
  const size_t smem = sizeof(float) * (rows * CC * kXW + 9 * CC * kBCO);
  cudaError_t err = set_smem(conv3x3_kernel<T, kSmall, CC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kBT), ceil_div(cout, kBCO), batch * (f_dim / pf));
  conv3x3_kernel<T, kSmall, CC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(out), cin, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* x, const void* w, const float* scale, const float* bias,
                      void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<false>();
  cudaError_t err = set_smem(conv3x3_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kTcT), ceil_div(cout, kTcCo), batch * (f_dim / pf));
  conv3x3_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias,
      static_cast<bf16*>(out), cin, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

template <typename T, bool kSmall>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* bias,
                   void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                   cudaStream_t stream) {
  if constexpr (!kSmall && sizeof(T) == 2) {
    return launch_tc(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, stream);
  } else {
    if (kSmall && cin > kCC)
      return launch_cc<T, true, 2 * kCC>(x, w, scale, bias, out, batch, cin, f_dim, t_dim,
                                         cout, pf, stream);
    return launch_cc<T, kSmall, kCC>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout,
                                     pf, stream);
  }
}

template <bool kSmall>
int dispatch(const void* x, const void* w, const void* scale, const void* bias, void* out,
             int batch, int cin, int f_dim, int t_dim, int cout, int pf, int dtype,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (cin < 1 || cout < 1 || pf < 1 || f_dim % pf || (kSmall && cin > kMaxStagedCin))
    return static_cast<int>(cudaErrorInvalidValue);
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

// Cin <= 10: every tap and channel staged once (K = 72, or 144 past Cin 8).
extern "C" int seld_conv3x3_smallcin(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int batch, int cin,
                                     int f_dim, int t_dim, int cout, int pf, int dtype,
                                     void* stream) {
  return dispatch<true>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, dtype,
                        stream);
}

// Cin walked in chunks (8 in float32, 16 on bfloat16's tensor cores), the
// last one ragged (K3 routes Cin % 8 == 0).
extern "C" int seld_conv3x3_widecin(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int batch, int cin,
                                    int f_dim, int t_dim, int cout, int pf, int dtype,
                                    void* stream) {
  return dispatch<false>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, dtype,
                         stream);
}
