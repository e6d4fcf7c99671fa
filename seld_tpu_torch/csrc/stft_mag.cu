// |STFT| of multichannel audio as a windowed real-DFT GEMM with the
// magnitude and the output cast fused.
//
// Replaces seld_tpu/ops/pallas/stft.py::stft_mag_pallas (_stft_kernel,
// _stft_kernel_padless). Semantics are scipy.signal.stft's as the reference
// featurizer uses them: periodic Hamming window, zero boundary of nperseg/2,
// tail zero-padded to whole hops, 1/sum(win) scaling, DC bin and last frame
// dropped. Frame t of row r reads samples [t*hop - nperseg/2, +nperseg) of
// x[r]; samples outside [0, n) are the zero padding.
//
// What bounds it on the H100: arithmetic. Each frame is a 512-tap dot with
// 512 table columns (256 cos, 256 sin), 0.5 MFLOP per frame, against 1.6 KB
// of audio read; the (512, 512) table stays in L2. The TPU kernel's frame
// groups and shifted tables only existed to keep lane reads 128-aligned; here
// each block simply gathers its frames (hop-strided, overlapping) into
// shared memory. Design: one block per (row, 64-frame tile, 64-bin tile),
// 256 threads, each holding a 4-frame x 4-bin tile of cos and sin sums in
// float registers; 32-tap slices of the frames and of the table are staged
// through shared memory. Ragged frame and bin tails are masked at the store.
// SIMT FMA: tensor cores (mma/wgmma on a bf16 table) are a later step.
#include "common.cuh"

namespace {

constexpr int kBM = 64;   // frames per block
constexpr int kBN = 64;   // bins per block (64 cos + 64 sin table columns)
constexpr int kBK = 32;   // taps per shared-memory slice
constexpr int kThreads = 256;

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
stft_mag_kernel(const TI* __restrict__ x, const float* __restrict__ table,
                TO* __restrict__ out, int n, int n_frames, int nperseg, int hop,
                int n_bins) {
  __shared__ float as[kBK][kBM + 1];   // frames, transposed: as[tap][frame]
  __shared__ float bc[kBK][kBN];       // cos columns
  __shared__ float bs[kBK][kBN];       // sin columns

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // bin lane
  const int ty = tid / 16;   // frame lane
  const int t0 = blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBN;
  const int row = blockIdx.z;
  const TI* xr = x + static_cast<size_t>(row) * n;
  const int half = nperseg / 2;
  const int tcols = 2 * n_bins;

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < nperseg; k0 += kBK) {
    // frames: consecutive threads read consecutive samples of one frame
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int kk = e % kBK, m = e / kBK;
      const int s = (t0 + m) * hop - half + k0 + kk;
      as[kk][m] = (t0 + m < n_frames && s >= 0 && s < n) ? to_f(xr[s]) : 0.f;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int c = e % kBN, kk = e / kBN;
      const bool ok = f0 + c < n_bins;
      const float* tr = table + static_cast<size_t>(k0 + kk) * tcols + f0 + c;
      bc[kk][c] = ok ? tr[0] : 0.f;
      bs[kk][c] = ok ? tr[n_bins] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], c[4], s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = bc[kk][tx + 16 * j];
        s[j] = bs[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(a[i], c[j], re[i][j]);
          im[i][j] = fmaf(a[i], s[j], im[i][j]);
        }
    }
    __syncthreads();
  }

  TO* orow = out + static_cast<size_t>(row) * n_frames * n_bins;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f < n_bins)
        store_f(orow + static_cast<size_t>(t) * n_bins + f,
                sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]));
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const float* table, void* out, int rows, int n,
                   int n_frames, int nperseg, int hop, cudaStream_t stream) {
  const int n_bins = nperseg / 2;
  dim3 grid(ceil_div(n_frames, kBM), ceil_div(n_bins, kBN), rows);
  stft_mag_kernel<TI, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TI*>(x), table, static_cast<TO*>(out), n, n_frames,
      nperseg, hop, n_bins);
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) in x_dtype; table (nperseg, nperseg) float, columns
// [cos bins 1..nperseg/2 | sin bins 1..nperseg/2] with the window and
// 1/sum(win) folded in; out (rows, n_frames, nperseg/2) in out_dtype.
extern "C" int seld_stft_mag(const void* x, const void* table, void* out, int rows,
                             int n, int n_frames, int nperseg, int hop, int x_dtype,
                             int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const float*>(table);
  cudaError_t err;
  if (x_dtype == kF32 && out_dtype == kF32)
    err = launch<float, float>(x, tb, out, rows, n, n_frames, nperseg, hop, s);
  else if (x_dtype == kF32 && out_dtype == kBF16)
    err = launch<float, __nv_bfloat16>(x, tb, out, rows, n, n_frames, nperseg, hop, s);
  else if (x_dtype == kBF16 && out_dtype == kF32)
    err = launch<__nv_bfloat16, float>(x, tb, out, rows, n, n_frames, nperseg, hop, s);
  else if (x_dtype == kBF16 && out_dtype == kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, tb, out, rows, n, n_frames, nperseg,
                                               hop, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
