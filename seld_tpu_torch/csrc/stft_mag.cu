// |STFT| of multichannel audio as a windowed real-DFT GEMM with the
// magnitude and the output cast fused.
//
// Replaces seld_tpu/ops/pallas/stft.py::stft_mag_pallas (_stft_kernel,
// _stft_kernel_padless). Semantics are scipy.signal.stft's as the reference
// featurizer uses them: periodic Hamming window, zero boundary of nperseg/2,
// tail zero-padded to whole hops, 1/sum(win) scaling, DC bin and last frame
// dropped. Frame t of row r reads samples [t*hop - nperseg/2, +nperseg) of
// x[r]; samples outside [0, n) are the zero padding. The TPU kernel's frame
// groups and shifted tables only existed to keep lane reads 128-aligned;
// here each block gathers its frames (hop-strided, overlapping) itself.
//
// Three kernels, picked by the output type, as the TPU kernel picks its
// compute type (stft.py:389), and for float32 by nperseg:
//
// - bfloat16 output: stft_mag_tc_kernel, a GEMM on the tensor cores
//   (mma.sync.m16n8k16, bf16 operands, float sums): M = frames, N = table
//   columns, K = taps. A block owns one 64-bin tile of one row: it loads
//   that tile's whole bf16 table (k_pad taps x [64 cos | 64 sin] columns,
//   139 KB at nperseg 512) into shared memory once, by cp.async from a
//   host-built tiled copy (zero past nperseg and past the last bin, so any
//   even nperseg up to 704 runs unmasked), then walks a share of the row's
//   frames in 256-frame tiles, one block per SM, so the grid is split
//   along frames until it fills the card. 16 warps, 8 along frames x 2
//   along bins, each a 32-frame x 32-bin tile held twice (the cos and the
//   sin sums of a bin in one thread), so the magnitude and the bf16 cast
//   fuse into the epilogue. The taps go in 32-tap chunks with the audio
//   double-buffered: the next chunk is gathered from x in registers (16-byte
//   loads where hop, nperseg/2 and n allow it; element by element at the
//   edges and otherwise) while this chunk's products run, then rounded to
//   bf16 and stored for ldmatrix. The magnitudes are staged in shared
//   memory and written with 16-byte stores. What bounds it on the H100:
//   bytes (123 MB of f32 audio read and 39 MB written at the flagship's
//   batch 2, 0.048 ms, against 0.041 ms of bf16 tensor work at the dense
//   peak); in this design the audio reaches the SMs once per bin tile (4x,
//   plus the frames' 1.28x overlap), from L2.
// - float32 output at a power-of-two nperseg (64-2048): stft_mag_fft_kernel,
//   a real FFT in float. The TPU needed the DFT as a GEMM to use its MXU; in
//   float32 a GEMM's operations (0.601 ms at the flagship's batch 2 at the
//   f32 peak) outweigh its bytes, while an FFT needs ~40x fewer operations
//   and leaves the kernel bound by bytes (123 MB of f32 audio read and 78.6
//   MB written, 0.060 ms). Frame t's N windowed samples become M = N/2
//   complex points z[m] = xw[2m] + i xw[2m+1] (one 8-byte load a pair,
//   consecutive threads on consecutive pairs, each frame's pairs from global
//   memory: staging the block's overlapping span once through shared memory
//   ran ~5% slower, PERF.md §6); an M-point Stockham FFT
//   (radix 8 stages, then one of 4 or 2: 8 x 8 x 4 at N = 512) runs with
//   8 points a thread, M / 8 threads a frame, 256 threads a block, each
//   stage's outputs exchanged through padded shared memory (two buffers,
//   one barrier a stage); the split X[k] = (Z[k] + Z*[M-k]) / 2 - i W^k
//   (Z[k] - Z*[M-k]) / 2 (W = e^{-2 pi i / N}; X[M] = Re Z[0] - Im Z[0])
//   gives bins 1..M, written as |X| with 16-byte stores. Window (with
//   1/sum(win)) and twiddles are float64-built tables rounded once to float.
// - float32 output at other nperseg (% 32 == 0): stft_mag_kernel, the DFT as
//   SIMT FMA in float (TF32 off): one block per (row, 64 frames, 64 bins),
//   256 threads, each holding a 4-frame x 4-bin tile of cos and sin sums;
//   32-tap slices of the frames and of the float32 table staged through
//   shared memory. Ragged frame and bin tails are masked at the store.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---- float32 output: SIMT ----------------------------------------------------

constexpr int kBM = 64;   // frames per block
constexpr int kBN = 64;   // bins per block (64 cos + 64 sin table columns)
constexpr int kBK = 32;   // taps per shared-memory slice
constexpr int kThreads = 256;

template <typename TI>
__global__ void __launch_bounds__(kThreads)
stft_mag_kernel(const TI* __restrict__ x, const float* __restrict__ table,
                float* __restrict__ out, int n, int n_frames, int nperseg, int hop,
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

  float* orow = out + static_cast<size_t>(row) * n_frames * n_bins;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f < n_bins)
        orow[static_cast<size_t>(t) * n_bins + f] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    }
  }
}

template <typename TI>
cudaError_t launch_f32(const void* x, const float* table, float* out, int rows, int n,
                       int n_frames, int nperseg, int hop, cudaStream_t stream) {
  const int n_bins = nperseg / 2;
  dim3 grid(ceil_div(n_frames, kBM), ceil_div(n_bins, kBN), rows);
  stft_mag_kernel<TI><<<grid, kThreads, 0, stream>>>(static_cast<const TI*>(x), table, out,
                                                     n, n_frames, nperseg, hop, n_bins);
  return cudaGetLastError();
}

// ---- float32 output at a power-of-two nperseg: a shared-memory FFT ----------

constexpr int kFftThreads = 256;
constexpr int kFftPts = 8;   // complex points a thread holds

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
static __device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-place R-point DFTs, v[o + s] = sum_r v[o + r] e^{-2 pi i r s / R}.
template <int R>
static __device__ __forceinline__ void dft(float2 (&v)[kFftPts], int o);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[kFftPts], int o) {
  const float2 a = v[o], b = v[o + 1];
  v[o] = cadd(a, b);
  v[o + 1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[kFftPts], int o) {
  const float2 t0 = cadd(v[o], v[o + 2]), t1 = csub(v[o], v[o + 2]);
  const float2 t2 = cadd(v[o + 1], v[o + 3]), t3 = mul_neg_i(csub(v[o + 1], v[o + 3]));
  v[o] = cadd(t0, t2);
  v[o + 1] = cadd(t1, t3);
  v[o + 2] = csub(t0, t2);
  v[o + 3] = csub(t1, t3);
}

// radix 8 as two radix-4 DFTs (even and odd points) and a radix-2 layer
template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[kFftPts], int o) {
  constexpr float c = 0.70710678118654752440f;   // sqrt(1/2)
  float2 e[kFftPts] = {v[o], v[o + 2], v[o + 4], v[o + 6]};
  float2 d[kFftPts] = {v[o + 1], v[o + 3], v[o + 5], v[o + 7]};
  dft<4>(e, 0);
  dft<4>(d, 0);
  d[1] = make_float2(c * (d[1].x + d[1].y), c * (d[1].y - d[1].x));    // x W8 = (1 - i) c
  d[2] = mul_neg_i(d[2]);                                              // x W8^2 = -i
  d[3] = make_float2(c * (d[3].y - d[3].x), -c * (d[3].x + d[3].y));   // x W8^3 = (-1 - i) c
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    v[o + s] = cadd(e[s], d[s]);
    v[o + s + 4] = csub(e[s], d[s]);
  }
}

// Index of point i of a frame in its padded shared-memory row: one pad word
// every 8 spreads the radix-8 strides over the banks.
static __device__ __forceinline__ int fpad(int i) { return i + (i >> 3); }

// Stage kS of the M = 2^kLogM-point plan: radix 8 while 8 divides what is
// left, the last stage radix 4 or 2; Ns, the product of the earlier radices.
template <int kLogM, int kS>
struct FftStage {
  static constexpr int kM = 1 << kLogM;
  static constexpr int kCount = (kLogM + 2) / 3;
  static constexpr int kR = (kS < kCount - 1 || kLogM % 3 == 0) ? 8 : (1 << (kLogM % 3));
  static constexpr int kNs = 1 << (3 * kS);
};

// Stockham stages kS.. of one frame (Govindaraju et al., 2008): butterfly jj
// of a radix-R stage takes in[jj + r M / R] (r < R), twiddles them by
// W_M^{r (jj % Ns) M / (Ns R)} = tw[2 r (jj % Ns) M / (Ns R)], takes their
// R-point DFT and writes it to out[(jj / Ns) Ns R + jj % Ns + s Ns] (s <
// R): natural order after the last stage, no digit reversal. A thread owns
// 8 / R butterflies, jj = j + q M / 8. Stage kS writes buffer kS % 2 and
// reads buffer (kS - 1) % 2; stage 0 takes its points from v, as loaded.
template <int kLogM, int kS>
static __device__ __forceinline__ void fft_stages(float2 (&v)[kFftPts], int j, float* const (&re)[2],
                                                  float* const (&im)[2],
                                                  const float2* __restrict__ tw) {
  using St = FftStage<kLogM, kS>;
  if constexpr (kS < St::kCount) {
    constexpr int kM = St::kM, kR = St::kR, kNs = St::kNs, kTf = kM / 8;
    if constexpr (kS > 0) {
      const float* ire = re[(kS - 1) % 2];
      const float* iim = im[(kS - 1) % 2];
#pragma unroll
      for (int q = 0; q < 8 / kR; ++q)
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = fpad(j + q * kTf + r * (kM / kR));
          v[q * kR + r] = make_float2(ire[i], iim[i]);
        }
    }
    float* ore = re[kS % 2];
    float* oim = im[kS % 2];
#pragma unroll
    for (int q = 0; q < 8 / kR; ++q) {
      const int jj = j + q * kTf, k = jj % kNs;
      if constexpr (kS > 0) {
#pragma unroll
        for (int r = 1; r < kR; ++r)
          v[q * kR + r] = cmul(v[q * kR + r], __ldg(tw + 2 * r * k * (kM / (kNs * kR))));
      }
      dft<kR>(v, q * kR);
      const int base = (jj / kNs) * kNs * kR + k;
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        const int i = fpad(base + s * kNs);
        ore[i] = v[q * kR + s].x;
        oim[i] = v[q * kR + s].y;
      }
    }
    __syncthreads();
    fft_stages<kLogM, kS + 1>(v, j, re, im, tw);
  }
}

static __device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  a = u.x;
  b = u.y;
}
static __device__ __forceinline__ void load_pair(const bf16* p, float& a, float& b) {
  const __nv_bfloat162 u = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(u);
  b = __high2float(u);
}

// x (rows, n) in TI; win (M,) float2: the periodic Hamming window over
// 1/sum(win), pairs (w[2m], w[2m + 1]); tw (N,) float2: e^{-2 pi i q / N};
// out (rows, n_frames, M) float. vec: 8-byte (float) / 4-byte (bf16) pair
// loads allowed (hop and n even, x 8-byte aligned). Block (frame group, row):
// 256 / (M / 8) frames, M / 8 threads each.
template <typename TI, int kLogM>
__global__ void __launch_bounds__(kFftThreads)
stft_mag_fft_kernel(const TI* __restrict__ x, const float2* __restrict__ win,
                    const float2* __restrict__ tw, float* __restrict__ out, int n, int n_frames,
                    int hop, bool vec) {
  constexpr int kM = 1 << kLogM, kTf = kM / 8, kFpb = kFftThreads / kTf;
  constexpr int kMp = kM + kM / 8;   // a frame's padded row
  constexpr int kLast = (FftStage<kLogM, 0>::kCount - 1) % 2;
  __shared__ float sbuf[4][kFpb * kMp];   // re 0, im 0, re 1, im 1
  const int f = threadIdx.x / kTf, j = threadIdx.x % kTf;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kFpb, t = t0 + f;
  const TI* xr = x + static_cast<size_t>(row) * n;
  const int s0 = t * hop - kM;   // the frame's first sample: nperseg / 2 = M before t * hop

  float2 v[kFftPts];
#pragma unroll
  for (int r = 0; r < kFftPts; ++r) {   // stage 0's points: z[j + r M / 8]
    const int mm = j + r * kTf, s = s0 + 2 * mm;
    float a = 0.f, b = 0.f;
    if (t < n_frames) {
      if (vec && s >= 0 && s + 1 < n) {
        load_pair(xr + s, a, b);
      } else {
        if (s >= 0 && s < n) a = to_f(xr[s]);
        if (s + 1 >= 0 && s + 1 < n) b = to_f(xr[s + 1]);
      }
    }
    const float2 w = __ldg(win + mm);
    v[r] = make_float2(a * w.x, b * w.y);
  }
  float* const re[2] = {sbuf[0] + f * kMp, sbuf[2] + f * kMp};
  float* const im[2] = {sbuf[1] + f * kMp, sbuf[3] + f * kMp};
  fft_stages<kLogM, 0>(v, j, re, im, tw);

  // the split and |X| of bins 1..M, four a thread-step, 16-byte stores
  float* orow = out + static_cast<size_t>(row) * n_frames * kM;
  for (int e = threadIdx.x; e < kFpb * kM / 4; e += kFftThreads) {
    const int ff = 4 * e / kM, k0 = 4 * e % kM + 1;
    if (t0 + ff >= n_frames) continue;
    const float* zr = sbuf[2 * kLast] + ff * kMp;
    const float* zi = sbuf[2 * kLast + 1] + ff * kMp;
    float mag[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i;
      if (k == kM) {
        mag[i] = fabsf(zr[0] - zi[0]);
      } else {
        const float ar = zr[fpad(k)], ai = zi[fpad(k)];
        const float cr = zr[fpad(kM - k)], ci = zi[fpad(kM - k)];
        const float er = 0.5f * (ar + cr), ei = 0.5f * (ai - ci);   // (Z[k] + Z*[M-k]) / 2
        const float dr = 0.5f * (ar - cr), di = 0.5f * (ai + ci);   // (Z[k] - Z*[M-k]) / 2
        const float2 w = __ldg(tw + k);
        const float xr_ = er + w.x * di + w.y * dr;   // E - i W D
        const float xi_ = ei - w.x * dr + w.y * di;
        mag[i] = sqrtf(xr_ * xr_ + xi_ * xi_);
      }
    }
    *reinterpret_cast<float4*>(orow + static_cast<size_t>(t0 + ff) * kM + k0 - 1) =
        make_float4(mag[0], mag[1], mag[2], mag[3]);
  }
}

template <typename TI, int kLogM>
cudaError_t launch_fft_m(const void* x, const float* win, const float* tw, float* out, int rows,
                         int n, int n_frames, int hop, cudaStream_t stream) {
  constexpr int kFpb = kFftThreads / ((1 << kLogM) / 8);
  const bool vec = hop % 2 == 0 && n % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  dim3 grid(ceil_div(n_frames, kFpb), rows);
  stft_mag_fft_kernel<TI, kLogM><<<grid, kFftThreads, 0, stream>>>(
      static_cast<const TI*>(x), reinterpret_cast<const float2*>(win),
      reinterpret_cast<const float2*>(tw), out, n, n_frames, hop, vec);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_fft(const void* x, const float* win, const float* tw, float* out, int rows,
                       int n, int n_frames, int nperseg, int hop, cudaStream_t stream) {
  switch (nperseg) {
    case 64: return launch_fft_m<TI, 5>(x, win, tw, out, rows, n, n_frames, hop, stream);
    case 128: return launch_fft_m<TI, 6>(x, win, tw, out, rows, n, n_frames, hop, stream);
    case 256: return launch_fft_m<TI, 7>(x, win, tw, out, rows, n, n_frames, hop, stream);
    case 512: return launch_fft_m<TI, 8>(x, win, tw, out, rows, n, n_frames, hop, stream);
    case 1024: return launch_fft_m<TI, 9>(x, win, tw, out, rows, n, n_frames, hop, stream);
    case 2048: return launch_fft_m<TI, 10>(x, win, tw, out, rows, n, n_frames, hop, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bfloat16 output: the tensor-core GEMM --------------------------------------

constexpr int kStWarpsM = 8;                // warps along frames, 32 frames each
constexpr int kStM = 32 * kStWarpsM;        // frames per tile (M)
constexpr int kStThreads = 64 * kStWarpsM;  // two warps along bins
constexpr int kStBins = 64;                 // bins per block
constexpr int kStN = 2 * kStBins;           // table columns per block: 64 cos | 64 sin
constexpr int kStK = 32;                    // taps per chunk: two k16 steps
constexpr int kStAP = kStK + 8;             // padded frame row of A (80 B: ldmatrix conflict-free)
constexpr int kStBP = kStN + 8;             // padded tap row of the table (272 B: the same)
constexpr int kStOP = kStBins + 8;          // padded frame row of the staged magnitudes
constexpr int kStAElems = kStM * kStAP;     // one A buffer, bf16
constexpr size_t kMaxSmem = 232448;         // shared memory one block may use on the H100
static_assert(kStM * kStOP <= 2 * kStAElems, "the magnitude tile reuses the A buffers");

// Shared memory: the block's whole table tile (k_pad taps) and two A buffers.
__host__ __device__ constexpr size_t st_smem_bytes(int k_pad) {
  return sizeof(bf16) * (static_cast<size_t>(k_pad) * kStBP + 2 * kStAElems);
}

// A sample's bits, in the low half of the word for bf16.
static __device__ __forceinline__ uint32_t raw_bits(float v) { return __float_as_uint(v); }
static __device__ __forceinline__ uint32_t raw_bits(bf16 v) { return __bfloat16_as_ushort(v); }

// The chunk's audio in registers: item j of this thread is kVec samples
// (16 bytes) of frame t0 + m at taps k0 + seg * kVec ..; zero outside the
// row, past nperseg and past the last frame. vec: a whole item is one
// 16-byte load where it lies inside all three.
template <typename TI>
struct StAudio {
  static constexpr int kVec = 16 / sizeof(TI);
  static constexpr int kSegs = kStK / kVec;                  // items per frame and chunk
  static constexpr int kItems = kStM * kSegs / kStThreads;   // items per thread
  uint4 v[kItems];
};

template <typename TI>
static __device__ __forceinline__ void st_load_audio(StAudio<TI>& a, const TI* __restrict__ xr,
                                                     int t0, int k0, int n, int n_frames,
                                                     int nperseg, int hop, bool vec) {
  constexpr int kVec = StAudio<TI>::kVec, kSegs = StAudio<TI>::kSegs;
  const int half = nperseg / 2;
#pragma unroll
  for (int j = 0; j < StAudio<TI>::kItems; ++j) {
    const int e = threadIdx.x + j * kStThreads;
    const int t = t0 + e / kSegs;
    const int tap = k0 + (e % kSegs) * kVec;
    const int s = t * hop - half + tap;
    if (vec && t < n_frames && s >= 0 && s + kVec <= n && tap + kVec <= nperseg) {
      a.v[j] = __ldg(reinterpret_cast<const uint4*>(xr + s));
    } else {
      // the item's 16 bytes as four words, each of 4 / sizeof(TI) samples
      uint32_t w[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        w[p] = 0u;
#pragma unroll
        for (int i = 0; i < kVec / 4; ++i) {
          const int k = p * (kVec / 4) + i;
          if (t < n_frames && tap + k < nperseg && s + k >= 0 && s + k < n)
            w[p] |= raw_bits(xr[s + k]) << (16 * i);
        }
      }
      a.v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// As[m][tap] in bf16 from st_load_audio's registers.
template <typename TI>
static __device__ __forceinline__ void st_store_audio(bf16* __restrict__ as,
                                                      const StAudio<TI>& a) {
  constexpr int kVec = StAudio<TI>::kVec, kSegs = StAudio<TI>::kSegs;
#pragma unroll
  for (int j = 0; j < StAudio<TI>::kItems; ++j) {
    const int e = threadIdx.x + j * kStThreads;
    bf16* dst = as + (e / kSegs) * kStAP + (e % kSegs) * kVec;
    if constexpr (sizeof(TI) == 2) {
      *reinterpret_cast<uint4*>(dst) = a.v[j];
    } else {
      const uint4 u = a.v[j];
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(__uint_as_float(u.x), __uint_as_float(u.y)),
                     pack_bf16(__uint_as_float(u.z), __uint_as_float(u.w)));
    }
  }
}

// x (rows, n) in TI; tiles (n_bins / 64 rounded up, k_pad, 128) bf16: tile
// j's row k holds the table's cos columns of bins 64 j .. 64 j + 63, then
// their sin columns, at tap k, zero past nperseg and past the last bin;
// out (rows, n_frames, n_bins) bf16. vec: 16-byte audio loads allowed (hop,
// nperseg / 2 and n multiples of 16 / sizeof(TI), x 16-byte aligned); ovec:
// 16-byte output stores allowed (n_bins % 8 == 0).
//
// Block (bin tile, row, split): it loads its bin tile's whole table (k_pad x
// 128 bf16) into shared memory once, then walks the split's frame tiles,
// each through the taps in 32-tap chunks with the audio double-buffered:
// the next chunk's audio is loaded into registers while this chunk's
// products run, then rounded to bf16 and stored for ldmatrix.
template <typename TI>
__global__ void __launch_bounds__(kStThreads, 1)
stft_mag_tc_kernel(const TI* __restrict__ x, const bf16* __restrict__ tiles,
                   bf16* __restrict__ out, int n, int n_frames, int nperseg, int hop,
                   int n_bins, int k_pad, int tiles_per_split, bool vec, bool ovec) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  bf16* bs = reinterpret_cast<bf16*>(st_smem);     // [k_pad][kStBP]
  bf16* as = bs + static_cast<size_t>(k_pad) * kStBP;   // [2][kStM][kStAP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int f0 = blockIdx.x * kStBins;
  const int row = blockIdx.y;
  const TI* xr = x + static_cast<size_t>(row) * n;
  bf16* orow = out + static_cast<size_t>(row) * n_frames * n_bins;
  const bf16* tile = tiles + static_cast<size_t>(blockIdx.x) * k_pad * kStN;
  const int n_chunks = k_pad / kStK;
  const int q = lane / 8, r = lane % 8;

  for (int e = threadIdx.x; e < k_pad * (kStN / 8); e += kStThreads) {
    const int k = e / (kStN / 8), c = 8 * (e % (kStN / 8));
    cp_async16(bs + k * kStBP + c, tile + static_cast<size_t>(k) * kStN + c, 16);
  }
  cp_async_commit();

  const int tile_first = blockIdx.z * tiles_per_split;
  const int tile_end = min(tile_first + tiles_per_split, ceil_div(n_frames, kStM));
  StAudio<TI> audio;
  for (int ti = tile_first; ti < tile_end; ++ti) {
    const int t0 = ti * kStM;
    // re / im: cos and sin sums of frame warp_m * 32 + 16 mi + lane / 4 (+ 8)
    // at bin warp_n * 32 + 8 ni + 2 (lane % 4) (+ 1): the m16n8 layout
    float re[2][4][4], im[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) re[mi][ni][e] = im[mi][ni][e] = 0.f;

    st_load_audio(audio, xr, t0, 0, n, n_frames, nperseg, hop, vec);
    st_store_audio(as, audio);
    cp_async_wait_all();
    __syncthreads();   // the table (first tile) and chunk 0 are in place
    for (int c = 0; c < n_chunks; ++c) {
      const bf16* a_buf = as + (c & 1) * kStAElems;
      const bool more = c + 1 < n_chunks;
      if (more)   // the next chunk's audio into registers
        st_load_audio(audio, xr, t0, (c + 1) * kStK, n, n_frames, nperseg, hop, vec);
      const bf16* b_buf = bs + c * kStK * kStBP;
#pragma unroll
      for (int kk = 0; kk < kStK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a_buf + (warp_m * 32 + mi * 16 + lane % 16) * kStAP + kk + (lane / 16) * 8,
                  a[mi]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          // the four 8 x 8 matrices: (taps 0-7, cos), (taps 8-15, cos),
          // (taps 0-7, sin), (taps 8-15, sin) of bins warp_n * 32 + 8 ni ..
          uint32_t b[4];
          ldsm_x4_t(b_buf + (kk + (q % 2) * 8 + r) * kStBP + (q / 2) * kStBins + warp_n * 32 +
                        ni * 8,
                    b);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(re[mi][ni], a[mi], b[0], b[1]);
            mma_bf16(im[mi][ni], a[mi], b[2], b[3]);
          }
        }
      }
      if (more) st_store_audio(as + ((c + 1) & 1) * kStAElems, audio);
      __syncthreads();   // the next chunk is in place; this chunk's readers are done
    }

    // magnitudes -> os[frame][bin] in bf16, then 16-byte rows out
    bf16* os = as;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = warp_m * 32 + mi * 16 + lane / 4 + 8 * h;
          const int j = warp_n * 32 + ni * 8 + (lane % 4) * 2;
          const float* c2 = re[mi][ni] + 2 * h;
          const float* s2 = im[mi][ni] + 2 * h;
          *reinterpret_cast<uint32_t*>(os + m * kStOP + j) = pack_bf16(
              sqrtf(c2[0] * c2[0] + s2[0] * s2[0]), sqrtf(c2[1] * c2[1] + s2[1] * s2[1]));
        }
    __syncthreads();
    for (int e = threadIdx.x; e < kStM * kStBins / 8; e += kStThreads) {
      const int m = e / (kStBins / 8), j = 8 * (e % (kStBins / 8));
      const int t = t0 + m, f = f0 + j;
      if (t >= n_frames || f >= n_bins) continue;
      bf16* dst = orow + static_cast<size_t>(t) * n_bins + f;
      const bf16* src = os + m * kStOP + j;
      if (ovec) {   // n_bins % 8 == 0: the 8 bins are all in or all out
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < 8 && f + i < n_bins; ++i) dst[i] = src[i];
      }
    }
    __syncthreads();   // os is read out before the next tile's chunk 0 lands
  }
  cp_async_wait_all();
}

template <typename TI>
cudaError_t launch_tc(const void* x, const void* tiles, void* out, int rows, int n,
                      int n_frames, int nperseg, int hop, int k_pad, cudaStream_t stream) {
  constexpr int kVec = StAudio<TI>::kVec;
  const size_t smem = st_smem_bytes(k_pad);
  const int n_bins = nperseg / 2;
  const bool vec = hop % kVec == 0 && (nperseg / 2) % kVec == 0 && n % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool ovec = n_bins % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err = set_smem(stft_mag_tc_kernel<TI>, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one block per SM: split each (bin tile, row)'s frame tiles so the grid fills the card
  const int n_tiles = ceil_div(n_bins, kStBins), frame_tiles = ceil_div(n_frames, kStM);
  const int splits = min(frame_tiles, max(1, sms / (n_tiles * rows)));
  const int per_split = ceil_div(frame_tiles, splits);
  dim3 grid(n_tiles, rows, ceil_div(frame_tiles, per_split));
  stft_mag_tc_kernel<TI><<<grid, kStThreads, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const bf16*>(tiles), static_cast<bf16*>(out), n,
      n_frames, nperseg, hop, n_bins, k_pad, per_split, vec, ovec);
  return cudaGetLastError();
}

}  // namespace

// float32 output. x (rows, n) in x_dtype; table (nperseg, nperseg) float,
// columns [cos bins 1..nperseg/2 | sin bins 1..nperseg/2] with the window
// and 1/sum(win) folded in; out (rows, n_frames, nperseg/2) float;
// nperseg % 32 == 0.
extern "C" int seld_stft_mag(const void* x, const void* table, void* out, int rows, int n,
                             int n_frames, int nperseg, int hop, int x_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const float*>(table);
  auto o = static_cast<float*>(out);
  if (nperseg % kBK) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == kF32)
    err = launch_f32<float>(x, tb, o, rows, n, n_frames, nperseg, hop, s);
  else if (x_dtype == kBF16)
    err = launch_f32<__nv_bfloat16>(x, tb, o, rows, n, n_frames, nperseg, hop, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// float32 output at a power-of-two nperseg (64-2048), by the FFT. x as
// above; win (nperseg,) float: the window over sum(win); tw (nperseg, 2)
// float: cos and -sin of 2 pi q / nperseg; out (rows, n_frames, nperseg/2)
// float.
extern "C" int seld_stft_mag_fft(const void* x, const void* win, const void* tw, void* out,
                                 int rows, int n, int n_frames, int nperseg, int hop,
                                 int x_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(win);
  auto t = static_cast<const float*>(tw);
  auto o = static_cast<float*>(out);
  cudaError_t err;
  if (rows <= 0 || rows > 65535 || n_frames <= 0 || hop <= 0)
    err = cudaErrorInvalidValue;
  else if (x_dtype == kF32)
    err = launch_fft<float>(x, w, t, o, rows, n, n_frames, nperseg, hop, s);
  else if (x_dtype == kBF16)
    err = launch_fft<__nv_bfloat16>(x, w, t, o, rows, n, n_frames, nperseg, hop, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// bfloat16 output on the tensor cores. x as above; tiles the bf16 table laid
// out as stft_mag_tc_kernel reads it, k_pad = nperseg rounded up to 32;
// out (rows, n_frames, nperseg/2) bf16.
extern "C" int seld_stft_mag_tc(const void* x, const void* tiles, void* out, int rows, int n,
                                int n_frames, int nperseg, int hop, int k_pad, int x_dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k_pad % kStK || k_pad < nperseg || st_smem_bytes(k_pad) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == kF32)
    err = launch_tc<float>(x, tiles, out, rows, n, n_frames, nperseg, hop, k_pad, s);
  else if (x_dtype == kBF16)
    err = launch_tc<__nv_bfloat16>(x, tiles, out, rows, n, n_frames, nperseg, hop, k_pad, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
