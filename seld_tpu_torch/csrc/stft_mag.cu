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
// Two kernels, picked by the output type, as the TPU kernel picks its
// compute type (stft.py:389):
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
// - float32 output: stft_mag_kernel, SIMT FMA in float (TF32 off): one
//   block per (row, 64 frames, 64 bins), 256 threads, each holding a
//   4-frame x 4-bin tile of cos and sin sums; 32-tap slices of the frames
//   and of the float32 table staged through shared memory. nperseg % 32 ==
//   0. Ragged frame and bin tails are masked at the store.
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
