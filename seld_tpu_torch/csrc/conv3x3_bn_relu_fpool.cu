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
// per clip in bf16. Every kernel keeps float accumulators in the m16n8
// fragment layout of mma.sync, except the SIMT kernel of bfloat16 at Cin
// 9-10, and folds each conv row into a running max, so only one row of
// accumulators lives in registers whatever pf is.
// - smallcin, Cin <= 10, one block per (b, pooled row, 64-channel Cout
//   tile, frame tiles): all taps and channels of a tile (K = 9 x 8 = 72, or
//   9 x 16 past Cin 8) and the window's rows + 2 halo rows staged in shared
//   memory with the conv's zero padding, in chunks of rows: kScChunkRows
//   (80) in bfloat16 at Cin <= 8, scf_chunk_rows (42, or 16 for 16 staged
//   channels) in float32, kSimtChunkRows (21) for the rest: what one
//   staging of chunk + 2 rows fits in shared memory beside the weights.
//   The running max is carried in registers from chunk to chunk, so any pf
//   dividing F runs; a window that fits one chunk is staged once.
//   - bfloat16, Cin <= 8 (K2 on the serving path): smallcin_tc_kernel
//     below, K = 72 padded to 80 (five k16 steps of two taps x 8 channels)
//     with the weights' A fragments held in registers across the pf rows.
//     What bounds it: operations (0.0687 ms at the flagship's batch 2,
//     against 0.047 ms of bytes).
//   - float32, Cin <= 10 (K2, and K5's float32 F2): smallcin_tf32_kernel
//     on the float smallcin tile of conv3x3_smallcin_tf32.cuh, split TF32
//     (K = 72 is nine m16n8k8 steps; the split weights stay in shared
//     memory for the block's life), on the float block tile's K walk: its
//     rows equal K10b's in float32 bit for bit. K5's float32 F1 and g_z
//     pass share its row function, so F2 pools their rows.
//   - bfloat16 at Cin 9-10 (reached only by a direct call: the router sends
//     Cin <= 8 here, and K5's bf16 forward takes the block tile) stays SIMT
//     (conv3x3_smallcin_kernel on conv_rows<16>, conv3x3_common.cuh).
// - widecin: Cin is walked in chunks, 4 conv rows at once, 64 channels x 64
//   frames a block. bfloat16: the block tile (TbPipe of conv3x3_tc.cuh), 16
//   channels a chunk. float32: its split-TF32 counterpart (FtPipe of
//   conv3x3_tf32.cuh), 8 channels a chunk, three TF32 products a float32
//   product. The train-mode stages 2-3 (K9's F1) share both tiles, so that
//   their conv rows equal these bitwise. The staging zero-fills channels >=
//   Cin, so a ragged last chunk is exact and any Cin works; the Python
//   router sends only Cin % 8 == 0 here as K3.
#include "conv3x3_smallcin_tf32.cuh"

namespace {

// The smallcin SIMT kernel, bfloat16 at Cin 9-10 (reached only by a direct
// call of the entry: the router sends Cin <= 8 here, and K5's bfloat16
// forward takes the block tile): every tap and channel staged once, the
// window's rows `chunk` at a time, 2 * kCC staged channels.
template <typename T, int CC>
__global__ void __launch_bounds__(kThreads)
conv3x3_smallcin_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf,
                        int chunk) {
  extern __shared__ float smem[];
  const int rows = min(pf, chunk) + 2;
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

  stage_w<CC>(ws, w, 0, co0, cin, cout);
  for (int r = 0; r < pf; ++r) {
    if (r % chunk == 0) {             // the next chunk's rows and their halo
      if (r > 0) __syncthreads();     // the previous chunk's readers are done
      stage_x<CC>(xs, xb, min(chunk, pf - r) + 2, fo * pf + r - 1, 0, t0, cin, f_dim, t_dim);
      __syncthreads();
    }
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    conv_rows<CC>(xs, ws, r % chunk, tx, ty, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        best[i][j] = max_nan(best[i][j], bn_relu(acc[i][j], sc[i], bi[i]));
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

// K2 in float32 (also K5's float32 F2): the float smallcin tile of
// conv3x3_smallcin_tf32.cuh, scf_window's rows folded into the running max
// of relu(acc * scale + bias) (max_nan: a NaN stays a NaN), carried across
// the window's stagings; the pooled row stored along the frames. A block
// walks kScfTiles frame tiles of one window and one Cout tile, its weights
// split once.
constexpr int kScfTiles = 2;

template <int CC>
__global__ void __launch_bounds__(kScfThreads, 2)
smallcin_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf,
                     int chunk) {
  extern __shared__ __align__(16) float scf_smem[];
  uint32_t* w_hi = reinterpret_cast<uint32_t*>(scf_smem);
  float4* cols = reinterpret_cast<float4*>(scf_smem + 2 * scf_w_words<CC>());
  float* xs = scf_smem + 2 * scf_w_words<CC>() + kScfCols;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const float* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;
  const bool vec = t_dim % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  const bool pairs = t_dim % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;

  scf_load_w<CC>(w_hi, w, co0, cin, cout);
  scf_stage_cols(cols, scale, bias, nullptr, nullptr, co0, cout);
  bool split_w = true;
  for (int tile = 0; tile < kScfTiles; ++tile) {
    const int t0 = (blockIdx.x * kScfTiles + tile) * kScfT;
    if (t0 >= t_dim) break;
    // relu output is >= 0, so 0 is the identity of the running max
    float best[4][kTbNi][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) best[mi][ni][e] = 0.f;
    scf_window<CC, 1>(xs, w_hi, xb, fo * pf, pf, chunk, t0, cin, f_dim, t_dim, vec, split_w,
                      [&](int, int, const TbAcc& acc) {
#pragma unroll
                     for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                       for (int h = 0; h < 2; ++h) {
                         const float4 c = cols[scf_m(mi, 2 * h)];
#pragma unroll
                         for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
                           for (int e2 = 0; e2 < 2; ++e2) {
                             float& m = best[mi][ni][2 * h + e2];
                             m = max_nan(m, bn_relu(acc[mi][ni][2 * h + e2], c.x, c.y));
                           }
                       }
                   });
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + scf_m(mi, 2 * h);
        if (co >= cout) continue;
        float* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          const int t = t0 + scf_n(ni, 0);
          const float v0 = best[mi][ni][2 * h], v1 = best[mi][ni][2 * h + 1];
          if (pairs && t + 1 < t_dim) {
            *reinterpret_cast<float2*>(orow + t) = make_float2(v0, v1);
          } else {
            if (t < t_dim) orow[t] = v0;
            if (t + 1 < t_dim) orow[t + 1] = v1;
          }
        }
      }
  }
}

// K3's bfloat16 body on the block tile (TbPipe): a block takes
// tb_block_rows(pf) conv rows (one pool window, or 4 / pf windows where pf
// is 1 or 2) of 64 channels x 64 frames. Each warp keeps the running max of
// relu(acc * scale + bias) over its rows in shared memory, rounded to bf16
// (rounding is monotone, so the max of the rounded rows is the rounded max
// of the rows: bit for bit what one rounding at the end gives); the block
// then takes the max over the row slots of each window and stores it along
// the frames.
__global__ void __launch_bounds__(kTcThreads, 1)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  bf16* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // per row slot, [64][kTbBP] bf16 maxima, after the ring
  bf16* best = reinterpret_cast<bf16*>(tc_smem + tb_ring_bytes<false>());
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slot = warp / 2, half = warp % 2;
  const int t0 = blockIdx.x * kTbT;
  const int co0 = blockIdx.y * kTcCo;
  const int rows = tb_block_rows(pf);
  const int blocks_f = ceil_div(f_dim, rows);
  const int b = blockIdx.z / blocks_f;
  const int f_first = (blockIdx.z % blocks_f) * rows;
  const int n_rows = min(rows, f_dim - f_first);
  const bf16* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  TbPipe<false> pipe(reinterpret_cast<bf16*>(tc_smem), xb, w, f_first, n_rows, co0, t0, cin,
                     f_dim, t_dim, cout);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    bf16* bs = best + slot * kTcCo * kTbBP;
    const bool first = pipe.row < kTbSlots;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = tb_m(lane, mi, 2 * h);
        // read here, not held in registers across the pipeline
        const int co = min(co0 + m, cout - 1);
        const float sc = __ldg(scale + co), bi = __ldg(bias + co);
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          auto* p = reinterpret_cast<__nv_bfloat162*>(bs + m * kTbBP + tb_n(half, lane, ni, 0));
          const __nv_bfloat162 v = __floats2bfloat162_rn(bn_relu(acc[mi][ni][2 * h], sc, bi),
                                                         bn_relu(acc[mi][ni][2 * h + 1], sc, bi));
          *p = first ? v : __hmax2_nan(*p, v);
        }
      }
  }

  __syncthreads();   // every slot's maxima are in place
  // slot s holds rows of window s / spw (its rows s, s + 4, ... for pf >= 4)
  const int spw = min(pf, kTbSlots), windows = n_rows / pf;
  const int f_out = f_dim / pf, fo0 = f_first / pf;
  const bool pairs = t_dim % 2 == 0;
  for (int e = threadIdx.x; e < windows * kTcCo * (kTbT / 2); e += kTcThreads) {
    const int n = 2 * (e % (kTbT / 2)), rest = e / (kTbT / 2);
    const int m = rest % kTcCo, wd = rest / kTcCo;
    const int co = co0 + m, t = t0 + n;
    if (co >= cout || t >= t_dim) continue;
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        best + (wd * spw * kTcCo + m) * kTbBP + n);
    for (int s2 = 1; s2 < spw; ++s2)
      v = __hmax2_nan(v, *reinterpret_cast<const __nv_bfloat162*>(
                         best + ((wd * spw + s2) * kTcCo + m) * kTbBP + n));
    bf16* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo0 + wd) * t_dim;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(orow + t) = v;
    } else {
      orow[t] = v.x;
      if (t + 1 < t_dim) orow[t + 1] = v.y;
    }
  }
}

// K3's float32 body on the float block tile (FtPipe, conv3x3_tf32.cuh):
// the bfloat16 body's rows, slots and epilogue with float maxima. Each warp
// keeps the running max of relu(acc * scale + bias) over its rows in shared
// memory; the block then takes the max over the row slots of each window
// and stores it along the frames.
__global__ void __launch_bounds__(kTcThreads, 1)
conv3x3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    float* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  const int t0 = blockIdx.x * kTbT;
  const int co0 = blockIdx.y * kTcCo;
  const int rows = tb_block_rows(pf);
  const int blocks_f = ceil_div(f_dim, rows);
  const int b = blockIdx.z / blocks_f;
  const int f_first = (blockIdx.z % blocks_f) * rows;
  const int n_rows = min(rows, f_dim - f_first);
  const float* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  FtPipe<false> pipe(reinterpret_cast<float*>(ft_smem), xb, w, f_first, n_rows, co0, t0, cin,
                     f_dim, t_dim, cout);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    // per row slot, [64][kFtBP] float maxima, after the ring; this thread's
    // place in it taken here, not held across the pipeline
    const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2;
    float* bs = reinterpret_cast<float*>(ft_smem + ft_ring_bytes()) +
                (threadIdx.x / 64) * kTcCo * kFtBP;
    const bool first = pipe.row < kTbSlots;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = tb_m(lane, mi, 2 * h);
        const int co = min(co0 + m, cout - 1);
        const float sc = __ldg(scale + co), bi = __ldg(bias + co);
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          float2* p = reinterpret_cast<float2*>(bs + m * kFtBP + tb_n(half, lane, ni, 0));
          float2 v = make_float2(bn_relu(acc[mi][ni][2 * h], sc, bi),
                                 bn_relu(acc[mi][ni][2 * h + 1], sc, bi));
          if (!first) {
            const float2 o = *p;
            v = make_float2(max_nan(o.x, v.x), max_nan(o.y, v.y));
          }
          *p = v;
        }
      }
  }

  __syncthreads();   // every slot's maxima are in place
  // slot s holds rows of window s / spw (its rows s, s + 4, ... for pf >= 4)
  const float* best = reinterpret_cast<const float*>(ft_smem + ft_ring_bytes());
  const int spw = min(pf, kTbSlots), windows = n_rows / pf;
  const int f_out = f_dim / pf, fo0 = f_first / pf;
  const bool pairs = t_dim % 2 == 0;
  for (int e = threadIdx.x; e < windows * kTcCo * (kTbT / 2); e += kTcThreads) {
    const int n = 2 * (e % (kTbT / 2)), rest = e / (kTbT / 2);
    const int m = rest % kTcCo, wd = rest / kTcCo;
    const int co = co0 + m, t = t0 + n;
    if (co >= cout || t >= t_dim) continue;
    float2 v = *reinterpret_cast<const float2*>(best + (wd * spw * kTcCo + m) * kFtBP + n);
    for (int s2 = 1; s2 < spw; ++s2) {
      const float2 o =
          *reinterpret_cast<const float2*>(best + ((wd * spw + s2) * kTcCo + m) * kFtBP + n);
      v = make_float2(max_nan(v.x, o.x), max_nan(v.y, o.y));
    }
    float* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo0 + wd) * t_dim;
    if (pairs) {
      *reinterpret_cast<float2*>(orow + t) = v;
    } else {
      orow[t] = v.x;
      if (t + 1 < t_dim) orow[t + 1] = v.y;
    }
  }
}

// ---- K2 in bfloat16, Cin <= 8: the smallcin tensor-core kernel ----------------
//
// A conv row is an implicit GEMM with M = 64 output channels, N = 128 frames
// and K = 9 taps x 8 channels = 72, padded to 80: five k16 steps, step s
// taking taps 2s and 2s + 1 (the last one's second tap zero weights). The
// block stages its pf + 2 halo rows once, as channel-pair words
// xs[row][pair][frame] (conv3x3_tc.cuh's layout with 4 pairs: any dx shift
// is one 32-bit load, 168-word pair rows keep the lanes on 32 banks), and
// its 80 x 64 weights once; each warp then holds the A fragments of all
// five steps in registers (40 words) for all pf rows, so a row costs only
// the B loads (two per n8 tile and step) and the products. Warps as the
// tile's: 2 along Cout x 4 along frames, 32 x 32 each. At stage 1 the
// products take about a third of the time and the staging's latency more,
// so the weights come by 16-byte cp.async and each thread keeps four halo
// items' loads in flight before it stores them.
constexpr int kScPairs = 4;                 // channel pairs staged: Cin <= 8
constexpr int kScSteps = 5;                 // k16 steps: taps (0, 1) .. (8, zeros)
constexpr int kScK = 16 * kScSteps;         // weight rows (tap, ci), rows 72-79 zero
constexpr int kScWP = kTcCo + 8;            // padded weight row (144 B: ldmatrix conflict-free)
constexpr int kScRowWords = kScPairs * kTcXS;   // words per staged conv row
constexpr int kScInFlight = 4;              // halo items a thread loads before storing

__host__ __device__ constexpr size_t smallcin_tc_smem_bytes(int rows) {
  return sizeof(uint32_t) * (rows + 2) * kScRowWords + sizeof(bf16) * kScK * kScWP;
}

// Pool rows per halo staging: the most whose rows + 2 staged rows and the
// weights fit one block. The tensor-core kernel: 80; the SIMT kernel (16
// staged channels): 21. Python's conv2d_pool.smallcin_max_pool_f gives the
// same numbers, and scf_chunk_rows's for float32.
constexpr int kScChunkRows =
    static_cast<int>((kBlockSmem - sizeof(bf16) * kScK * kScWP) /
                     (sizeof(uint32_t) * kScRowWords)) - 2;
constexpr int kSimtChunkRows =
    static_cast<int>((kBlockSmem - sizeof(float) * 9 * 2 * kCC * kBCO) /
                     (sizeof(float) * 2 * kCC * kXW)) - 2;

// The window's pf rows go in stagings of `chunk` rows (one where pf <= chunk).
__global__ void __launch_bounds__(kTcThreads, 2)
smallcin_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   bf16* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf,
                   int chunk) {
  extern __shared__ __align__(16) unsigned char sc_smem[];
  const int rows = min(pf, chunk) + 2;
  uint32_t* xs = reinterpret_cast<uint32_t*>(sc_smem);                // [rows][4][kTcXS]
  bf16* ws = reinterpret_cast<bf16*>(xs + rows * kScRowWords);      // [kScK][kScWP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int t0 = blockIdx.x * kTcT;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + b * cin * plane;

  // weights: ws[tap * 8 + ci][co], zero past Cin, Cout and tap 8; by
  // 16-byte cp.async where Cout % 8 == 0 and w is aligned
  if (cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    for (int e = threadIdx.x; e < kScK * kTcCo / 8; e += kTcThreads) {
      const int m = 8 * (e % (kTcCo / 8)), k = e / (kTcCo / 8);
      const int tap = k / 8, ci = k % 8, co = co0 + m;
      const bool ok = tap < 9 && ci < cin && co < cout;
      const bf16* src = ok ? w + (static_cast<size_t>(tap) * cin + ci) * cout + co : w;
      cp_async16(ws + k * kScWP + m, src, ok ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < kScK * kTcCo; e += kTcThreads) {
      const int m = e % kTcCo, k = e / kTcCo;
      const int tap = k / 8, ci = k % 8, co = co0 + m;
      ws[k * kScWP + m] = (tap < 9 && ci < cin && co < cout)
                              ? w[(static_cast<size_t>(tap) * cin + ci) * cout + co]
                              : __float2bfloat16(0.f);
    }
  }
  // relu output is >= 0, so 0 is the identity of the running max
  float best[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[mi][ni][e] = 0.f;

  // B of tap (dy, dx) at n8 tile ni: channels (2q, 2q + 1) at frame
  // t0 + n + dx - 1 of conv row r's input row r + dy (q = lane % 4, n = lane / 4)
  const uint32_t* xq = xs + (lane % 4) * kTcXS + warp_n * 32 + lane / 4 + 7;
  uint32_t a[kScSteps][2][4];
  for (int r0 = 0;; r0 += chunk) {   // the window's rows in chunks, best carried
    const int rows_c = min(chunk, pf - r0);
    const int f_first = fo * pf + r0 - 1;
    if (r0 > 0) __syncthreads();   // the previous chunk's B loads are done
    // halo: xs[rr][p][s] holds channels (2p, 2p + 1) of input row f_first + rr
    // at frame t0 - 8 + s, zero outside the input and past Cin
    if (t_dim % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      // kScInFlight items a thread in flight: all loads, then all stores
      const int items = (rows_c + 2) * kScPairs * kTcGroups;
      for (int e0 = threadIdx.x; e0 < items; e0 += kScInFlight * kTcThreads) {
        uint4 lo[kScInFlight], hi[kScInFlight];
#pragma unroll
        for (int j = 0; j < kScInFlight; ++j) {
          const int e = e0 + j * kTcThreads;
          const int g = e % kTcGroups, rest = e / kTcGroups;
          const int ci = 2 * (rest % kScPairs), f = f_first + rest / kScPairs;
          const int t = t0 - 8 + 8 * g;
          lo[j] = hi[j] = make_uint4(0u, 0u, 0u, 0u);
          if (e < items && f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
            const uint16_t* src = xb + ci * plane + static_cast<size_t>(f) * t_dim + t;
            lo[j] = __ldg(reinterpret_cast<const uint4*>(src));
            if (ci + 1 < cin) hi[j] = __ldg(reinterpret_cast<const uint4*>(src + plane));
          }
        }
#pragma unroll
        for (int j = 0; j < kScInFlight; ++j) {
          const int e = e0 + j * kTcThreads;
          if (e >= items) break;
          const int g = e % kTcGroups, rest = e / kTcGroups;
          uint4* dst = reinterpret_cast<uint4*>(xs + rest * kTcXS + 8 * g);
          const uint4 l = lo[j], h = hi[j];
          dst[0] = make_uint4(__byte_perm(l.x, h.x, 0x5410), __byte_perm(l.x, h.x, 0x7632),
                              __byte_perm(l.y, h.y, 0x5410), __byte_perm(l.y, h.y, 0x7632));
          dst[1] = make_uint4(__byte_perm(l.z, h.z, 0x5410), __byte_perm(l.z, h.z, 0x7632),
                              __byte_perm(l.w, h.w, 0x5410), __byte_perm(l.w, h.w, 0x7632));
        }
      }
    } else {   // frames t0 - 1 .. t0 + kTcT one word at a time
      for (int e = threadIdx.x; e < (rows_c + 2) * kScPairs * kTcXT; e += kTcThreads) {
        const int s = e % kTcXT, rest = e / kTcXT;
        const int ci = 2 * (rest % kScPairs), f = f_first + rest / kScPairs;
        const int t = t0 - 1 + s;
        uint32_t v = 0;
        if (f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
          const uint16_t* src = xb + ci * plane + static_cast<size_t>(f) * t_dim + t;
          v = __ldg(src);
          if (ci + 1 < cin) v |= static_cast<uint32_t>(__ldg(src + plane)) << 16;
        }
        xs[rest * kTcXS + s + 7] = v;
      }
    }

    cp_async_wait_all();
    __syncthreads();
    if (r0 == 0) {
      // A fragments of the five steps: a[s][mi] covers Cout warp_m * 32 + 16 mi ..
      // and weight rows 16 s .. 16 s + 15 (ldmatrix.trans of ws[k][co])
      const int q = lane / 8, r = lane % 8;
#pragma unroll
      for (int st = 0; st < kScSteps; ++st)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4_t(ws + (st * 16 + (q / 2) * 8 + r) * kScWP + warp_m * 32 + mi * 16 +
                        (q % 2) * 8,
                    a[st][mi]);
    }
#pragma unroll 1
    for (int r = 0; r < rows_c; ++r) {
      float acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      const uint32_t* xr = xq + r * kScRowWords;
#pragma unroll
      for (int st = 0; st < kScSteps; ++st) {
        const int tap0 = 2 * st, tap1 = min(2 * st + 1, 8);   // tap 9: zero weights
        const uint32_t* x0 = xr + (tap0 / 3) * kScRowWords + tap0 % 3;
        const uint32_t* x1 = xr + (tap1 / 3) * kScRowWords + tap1 % 3;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint32_t b0 = x0[ni * 8], b1 = x1[ni * 8];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[st][mi], b0, b1);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = min(co0 + tc_m(warp_m, lane, mi, 2 * h), cout - 1);
          const float sc = __ldg(scale + co), bi = __ldg(bias + co);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2)
              best[mi][ni][2 * h + e2] =
                  max_nan(best[mi][ni][2 * h + e2], bn_relu(acc[mi][ni][2 * h + e2], sc, bi));
        }
    }
    if (r0 + chunk >= pf) break;
  }

  // out (B, Cout, F / pf, T): two frames per store where T is even
  const bool pairs = t_dim % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + tc_m(warp_m, lane, mi, 2 * h);
      if (co >= cout) continue;
      bf16* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int t = t0 + tc_n(warp_n, lane, ni, 0);
        const float* v = best[mi][ni] + 2 * h;
        if (pairs) {
          if (t < t_dim)
            *reinterpret_cast<__nv_bfloat162*>(orow + t) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (t < t_dim) orow[t] = __float2bfloat16(v[0]);
          if (t + 1 < t_dim) orow[t + 1] = __float2bfloat16(v[1]);
        }
      }
    }
}

cudaError_t launch_smallcin_tc(const void* x, const void* w, const float* scale,
                               const float* bias, void* out, int batch, int cin, int f_dim,
                               int t_dim, int cout, int pf, int chunk, cudaStream_t stream) {
  if (chunk > kScChunkRows) return cudaErrorInvalidValue;
  const size_t smem = smallcin_tc_smem_bytes(min(pf, chunk));
  cudaError_t err = set_smem(smallcin_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kTcT), ceil_div(cout, kTcCo), batch * (f_dim / pf));
  smallcin_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias,
      static_cast<bf16*>(out), cin, f_dim, t_dim, cout, pf, chunk);
  return cudaGetLastError();
}

// bfloat16 at Cin 9-10: the SIMT kernel with 2 * kCC staged channels.
cudaError_t launch_smallcin_simt(const void* x, const void* w, const float* scale,
                                 const float* bias, void* out, int batch, int cin, int f_dim,
                                 int t_dim, int cout, int pf, int chunk, cudaStream_t stream) {
  constexpr int CC = 2 * kCC;
  if (chunk > kSimtChunkRows) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((min(pf, chunk) + 2) * CC * kXW + 9 * CC * kBCO);
  cudaError_t err = set_smem(conv3x3_smallcin_kernel<bf16, CC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kBT), ceil_div(cout, kBCO), batch * (f_dim / pf));
  conv3x3_smallcin_kernel<bf16, CC><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias,
      static_cast<bf16*>(out), cin, f_dim, t_dim, cout, pf, chunk);
  return cudaGetLastError();
}

// float32: the float smallcin tile, kScfTiles frame tiles a block.
template <int CC>
cudaError_t launch_smallcin_tf32(const void* x, const void* w, const float* scale,
                                 const float* bias, void* out, int batch, int cin, int f_dim,
                                 int t_dim, int cout, int pf, int chunk, cudaStream_t stream) {
  if (chunk > scf_chunk_rows<CC>()) return cudaErrorInvalidValue;
  const size_t smem = scf_smem_bytes<CC>(min(pf, chunk));
  cudaError_t err = set_smem(smallcin_tf32_kernel<CC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(ceil_div(t_dim, kScfT), kScfTiles), ceil_div(cout, kTcCo),
            batch * (f_dim / pf));
  smallcin_tf32_kernel<CC><<<grid, kScfThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale, bias,
      static_cast<float*>(out), cin, f_dim, t_dim, cout, pf, chunk);
  return cudaGetLastError();
}

// The block tiles' grid: 64 frames, 64 channels, tb_block_rows(pf) rows a block.
dim3 block_tile_grid(int batch, int f_dim, int t_dim, int cout, int pf) {
  return dim3(ceil_div(t_dim, kTbT), ceil_div(cout, kTcCo),
              batch * ceil_div(f_dim, tb_block_rows(pf)));
}

cudaError_t launch_tc(const void* x, const void* w, const float* scale, const float* bias,
                      void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                      cudaStream_t stream) {
  constexpr size_t smem = tb_ring_bytes<false>() + sizeof(bf16) * kTbSlots * kTcCo * kTbBP;
  cudaError_t err = set_smem(conv3x3_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  conv3x3_tc_kernel<<<block_tile_grid(batch, f_dim, t_dim, cout, pf), kTcThreads, smem,
                      stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale,
                                bias, static_cast<bf16*>(out), cin, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

cudaError_t launch_tf32(const void* x, const void* w, const float* scale, const float* bias,
                        void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                        cudaStream_t stream) {
  constexpr size_t smem = ft_ring_bytes() + sizeof(float) * kTbSlots * kTcCo * kFtBP;
  cudaError_t err = set_smem(conv3x3_tf32_kernel, smem);
  if (err != cudaSuccess) return err;
  conv3x3_tf32_kernel<<<block_tile_grid(batch, f_dim, t_dim, cout, pf), kTcThreads, smem,
                        stream>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                  scale, bias, static_cast<float*>(out), cin, f_dim, t_dim,
                                  cout, pf);
  return cudaGetLastError();
}

}  // namespace

// Cin <= 10: every tap and channel staged once (K = 72, or 144 past Cin 8);
// a pool window's rows staged `chunk` at a time (conv2d_pool.smallcin_pool_chunks:
// at most kScChunkRows, scf_chunk_rows or kSimtChunkRows, else
// cudaErrorInvalidValue). float32 runs the float smallcin tile, bfloat16
// the tensor-core kernel at Cin <= 8 and the SIMT one past it.
extern "C" int seld_conv3x3_smallcin(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int batch, int cin,
                                     int f_dim, int t_dim, int cout, int pf, int chunk,
                                     int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (cin < 1 || cin > kMaxStagedCin || cout < 1 || pf < 1 || f_dim % pf || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32)
    err = cin <= kCC ? launch_smallcin_tf32<kCC>(x, w, sc, bi, out, batch, cin, f_dim, t_dim,
                                                 cout, pf, chunk, s)
                     : launch_smallcin_tf32<2 * kCC>(x, w, sc, bi, out, batch, cin, f_dim,
                                                     t_dim, cout, pf, chunk, s);
  else if (dtype == kBF16)
    err = cin <= kCC ? launch_smallcin_tc(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout, pf,
                                          chunk, s)
                     : launch_smallcin_simt(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout,
                                            pf, chunk, s);
  return static_cast<int>(err);
}

// Any Cin, walked in chunks (8 channels on float32's split-TF32 tile, 16 on
// bfloat16's), the last one ragged (K3 routes Cin % 8 == 0).
extern "C" int seld_conv3x3_widecin(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int batch, int cin,
                                    int f_dim, int t_dim, int cout, int pf, int dtype,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (cin < 1 || cout < 1 || pf < 1 || f_dim % pf) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32)
    err = launch_tf32(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout, pf, s);
  else if (dtype == kBF16)
    err = launch_tc(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout, pf, s);
  return static_cast<int>(err);
}
