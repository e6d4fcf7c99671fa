// The tensor-core 3x3 conv tiles of the bfloat16 CNN stages. In float32 the
// block tile has a split-TF32 counterpart (conv3x3_tf32.cuh: K3, K10b, K9's
// F1, F2 and dh), and stage 1 the float smallcin tile
// (conv3x3_smallcin_tf32.cuh: K2, K5's F1, F2 and g_z pass).
//
// Two tiles share one K walk (below). TbPipe, the block tile, serves
// K3 and K10b (conv3x3_bn_relu_fpool.cu: the serving stage, K9's F2 and
// K5's F2), K9's F1 and dh passes (conv3x3_ct_train.cu) and K5's F1
// (conv3x3_train.cu). conv_rows_tc, the row tile it replaced, stays for
// K5's g_z pass alone, whose running max, routing and staged g_z rows hold
// every conv row of a pool window in one thread's registers.
//
// A conv row is an implicit GEMM: M = 64 output channels, N = frames, K = 9
// taps x Cin, walked in chunks of 16 input channels (one k16 step of
// mma.sync.m16n8k16 per tap, bf16 operands, float accumulators). mma.sync,
// not wgmma: the tap shift below moves the B operand by one frame per dx,
// which a 32-bit shared load takes at any frame, where a wgmma descriptor
// needs one aligned, swizzled matrix per shift.
//
// The K walk, which both tiles keep: chunks in increasing channel order,
// within a chunk the taps (dy, dx) in row-major order, and in a k16 step
// channel c0 + k at k; each accumulator starts at zero. F1, F2 and K5's g_z
// pass therefore give every conv row bit for bit alike (K9's backward
// routes the pool gradient on F1's rows, K5's on the g_z pass's recompute),
// whichever tile computes it.
//
// The tap shift. x is (B, Cin, F, T) with frames contiguous, and the B
// operand of tap (dy, dx) is x shifted by dx frames: a 2-byte shift breaks
// the 16-byte rows that ldmatrix reads. So each chunk stages x as 32-bit
// words [row][8 channel pairs][frames], each word the two channels of a
// pair at one frame: a B fragment is then two 32-bit loads (channels 2q,
// 2q + 1 and 2q + 8, 2q + 9 at one frame), aligned at every shift, and the
// pair rows' stride (8 or 24 mod 32 words) keeps the 32 lanes on 32 banks.
// The pairing happens in registers (16-byte loads of 8 frames of each
// channel, byte permutes, two 16-byte stores; a 2-byte path where T % 8 !=
// 0), so x cannot come by cp.async: the next chunk's loads are issued before
// the current chunk's products and stored after them. The weights come by
// cp.async (16-byte copies, zero-filled past Cin and Cout) into
// [tap][ci][co] (ldmatrix.trans gives the row-major A fragment), or for dh's
// transposed weights into [tap][co][ci]. Two stages of (x, w) form the
// ring: the next chunk loads while this one multiplies.
//
// The block tile (TbPipe): 64 output channels x 64 frames x 4 conv rows
// a pass, 256 threads: warp w takes row slot w / 2 and 32 frames (w % 2),
// a 64 x 32 warp tile (4 x 4 m16n8 fragments: each B word feeds four
// products, each A fragment four; 1.5 shared-memory wavefronts a product,
// where the row tile's 32 x 32 warps took two). A pass stages its 6 input
// rows once per chunk (pf + 2 row stagings per pool window of pf % 4 == 0
// rows, where the row tile staged 3 pf) and the chunk's weights once for
// its 4 rows, and runs 144 products per warp between two barriers (the row
// tile: 72). One block an SM (__launch_bounds__(256, 1)): with the nine
// taps unrolled the compiler hoists their loads into up to 255 registers;
// held to 128 (two blocks an SM) it spills. The caller's epilogue runs on
// the accumulators between passes (TbPipe::pass), not as a callback.
//
// The row tile (conv_rows_tc): 64 output channels x 128 frames of one conv
// row at a time, 8 warps of 32 x 32 (2 x 4 fragments).
//
// Invariants of both: a ragged last Cin chunk is zero-filled, so any Cin
// works; ragged Cout and T are masked by the epilogues; only t < T is read;
// any number of rows runs through one pipeline.
#pragma once

#include "conv3x3_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTcCo = 64;                 // output channels (M) per block
constexpr int kTcT = 128;                 // frames (N) per block
constexpr int kTcCc = 16;                 // input channels per K chunk: one k16 step per tap
constexpr int kTcPairs = kTcCc / 2;       // channel pairs: one 32-bit word per frame
constexpr int kTcXT = kTcT + 2;           // frames a conv row reads: t0 - 1 .. t0 + kTcT
constexpr int kTcGroups = kTcT / 8 + 2;   // 8-frame groups staged: t0 - 8 .. t0 + kTcT + 7
constexpr int kTcXS = 168;                // words per staged (row, pair): 144 used; 168 = 8 mod 32
constexpr int kTcXP = kTcCc + 8;          // padded ci row of a transposed weight slice
constexpr int kTcWP = kTcCo + 8;          // padded Cout row of a staged weight slice
constexpr int kTcThreads = 256;
constexpr int kTcXWords = 3 * kTcPairs * kTcXS;         // one stage of x
constexpr int kTcXElems = 2 * kTcXWords;                // the same in bf16 elements
constexpr int kTcVItems = 3 * kTcPairs * kTcGroups;     // (row, pair, group) vector items
constexpr int kTcSItems = 3 * kTcPairs * kTcXT;         // (row, pair, frame) scalar items
constexpr int kTcVPerThread = (kTcVItems + kTcThreads - 1) / kTcThreads;
constexpr int kTcSPerThread = (kTcSItems + kTcThreads - 1) / kTcThreads;
constexpr int kTcXRegs = 8 * kTcVPerThread > kTcSPerThread ? 8 * kTcVPerThread : kTcSPerThread;

// One stage of staged weights: [9][kTcCc][kTcWP], or [9][kTcCo][kTcXP] transposed.
template <bool kT>
__host__ __device__ constexpr int tc_w_elems() {
  return kT ? 9 * kTcCo * kTcXP : 9 * kTcCc * kTcWP;
}

template <bool kT>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return 2 * sizeof(bf16) * (kTcXElems + tc_w_elems<kT>());
}

// The chunk's x in registers, channels (c0 + 2p, c0 + 2p + 1) of input row
// f_row - 1 + dy, zero outside the input and past Cin. vec (T % 8 == 0 and
// x 16-byte aligned): item j is frames t0 - 8 + 8g .. + 7 of both channels,
// two 16-byte loads (xr[8j .. 8j + 7]); else word j is one frame t0 - 1 + s
// of both channels.
static __device__ __forceinline__ void tc_load_x(uint32_t (&xr)[kTcXRegs],
                                                 const uint16_t* __restrict__ xb, int f_row,
                                                 int c0, int t0, int cin, int f_dim, int t_dim,
                                                 bool vec) {
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kTcVPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (e < kTcVItems) {
        const int g = e % kTcGroups, rest = e / kTcGroups;
        const int ci = c0 + 2 * (rest % kTcPairs);
        const int f = f_row - 1 + rest / kTcPairs;
        const int t = t0 - 8 + 8 * g;
        if (f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
          const uint16_t* src = xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t;
          lo = __ldg(reinterpret_cast<const uint4*>(src));
          if (ci + 1 < cin) hi = __ldg(reinterpret_cast<const uint4*>(src + plane));
        }
      }
      const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) xr[8 * j + k] = words[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTcSPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      uint32_t v = 0;
      if (e < kTcSItems) {
        const int s = e % kTcXT, rest = e / kTcXT;
        const int ci = c0 + 2 * (rest % kTcPairs);
        const int f = f_row - 1 + rest / kTcPairs;
        const int t = t0 - 1 + s;
        if (f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
          const uint16_t* src = xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t;
          v = __ldg(src);
          if (ci + 1 < cin) v |= static_cast<uint32_t>(__ldg(src + plane)) << 16;
        }
      }
      xr[j] = v;
    }
  }
}

// xs[dy][p][s] (words: channel 2p in the low half, 2p + 1 in the high half
// of frame t0 - 8 + s) from tc_load_x's registers; the vector path pairs the
// two channels' frames with byte permutes and stores 32 bytes per item.
static __device__ __forceinline__ void tc_store_x(uint32_t* __restrict__ xs,
                                                  const uint32_t (&xr)[kTcXRegs], bool vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < kTcVPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      if (e < kTcVItems) {
        const int g = e % kTcGroups, rest = e / kTcGroups;
        uint4* dst = reinterpret_cast<uint4*>(xs + rest * kTcXS + 8 * g);
        const uint32_t* lo = xr + 8 * j;
        const uint32_t* hi = lo + 4;
        dst[0] = make_uint4(__byte_perm(lo[0], hi[0], 0x5410), __byte_perm(lo[0], hi[0], 0x7632),
                            __byte_perm(lo[1], hi[1], 0x5410), __byte_perm(lo[1], hi[1], 0x7632));
        dst[1] = make_uint4(__byte_perm(lo[2], hi[2], 0x5410), __byte_perm(lo[2], hi[2], 0x7632),
                            __byte_perm(lo[3], hi[3], 0x5410), __byte_perm(lo[3], hi[3], 0x7632));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTcSPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      if (e < kTcSItems) xs[(e / kTcXT) * kTcXS + e % kTcXT + 7] = xr[j];
    }
  }
}

// Stage the weights of channels [c0, c0 + kTcCc) and outputs [co0, co0 +
// kTcCo). Forward (kT false): w (3, 3, K, M), staged ws[tap][ci][co].
// Transposed (kT true, dh): element (tap, k, m) is w[8 - tap][m][k] of w
// stored (3, 3, M, K), staged ws[tap][co][ci]. `vec`: 16-byte copies by
// cp.async (the contiguous dimension is a multiple of 8 and w is aligned);
// else element by element through registers.
template <bool kT>
static __device__ __forceinline__ void tc_load_w(bf16* __restrict__ ws,
                                                 const bf16* __restrict__ w, int c0, int co0,
                                                 int k_dim, int m_dim, bool vec) {
  if (vec) {
    // copy e = threadIdx.x + 256 i holds tap e / 128, so a thread's (k, m)
    // is fixed and its taps step by two: (k, m) = ((e / 8) % 16, 8 (e % 8)),
    // or (m, k) = ((e / 2) % 64, 8 (e % 2)) transposed
    static_assert(2 * (kTcCc * kTcCo / 8) == kTcThreads, "a round of copies takes two taps");
    const int k = kT ? 8 * (threadIdx.x % 2) : (threadIdx.x / 8) % kTcCc;
    const int m = kT ? (threadIdx.x / 2) % kTcCo : 8 * (threadIdx.x % 8);
    const bool ok = c0 + k < k_dim && co0 + m < m_dim;
    bf16* dst = ws + (kT ? m * kTcXP + k : k * kTcWP + m);
    const bf16* src = kT ? w + (static_cast<size_t>(8) * m_dim + co0 + m) * k_dim + c0 + k
                         : w + static_cast<size_t>(c0 + k) * m_dim + co0 + m;
    const ptrdiff_t tap_src = static_cast<ptrdiff_t>(k_dim) * m_dim;   // one tap of w
    for (int tap = threadIdx.x / 128; tap < 9; tap += 2)
      cp_async16(dst + tap * (kT ? kTcCo * kTcXP : kTcCc * kTcWP),
                 ok ? src + (kT ? -tap : tap) * tap_src : w, ok ? 16 : 0);
  } else {
    for (int e = threadIdx.x; e < 9 * kTcCc * kTcCo; e += kTcThreads) {
      const int m = e % kTcCo, rest = e / kTcCo;
      const int k = rest % kTcCc, tap = rest / kTcCc;
      const int kk = c0 + k, mm = co0 + m;
      bf16 v = __float2bfloat16(0.f);
      if (kk < k_dim && mm < m_dim)
        v = kT ? w[(static_cast<size_t>(8 - tap) * m_dim + mm) * k_dim + kk]
               : w[(static_cast<size_t>(tap) * k_dim + kk) * m_dim + mm];
      ws[kT ? (tap * kTcCo + m) * kTcXP + k : (tap * kTcCc + k) * kTcWP + m] = v;
    }
  }
}

// acc += one chunk: nine taps, one k16 step each, on this warp's 32 x 32
// tile. A (weights) by ldmatrix; B (x) by two 32-bit loads per m16n8k16:
// b0b1 = channels (2q, 2q + 1), b2b3 = (2q + 8, 2q + 9) at frame n + dx - 1
// (q = lane % 4, n = lane / 4), conflict-free since kTcXS = 8 mod 32.
template <bool kT>
static __device__ __forceinline__ void tc_mma_chunk(const uint32_t* __restrict__ xs,
                                                    const bf16* __restrict__ ws, int warp_m,
                                                    int warp_n, int lane,
                                                    float (&acc)[2][4][4]) {
  const int q = lane / 8, r = lane % 8;
  const uint32_t* xq = xs + (lane % 4) * kTcXS + warp_n * 32 + lane / 4 + 7;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m0 = warp_m * 32 + mi * 16;
      // the four 8 x 8 matrices of a[mi]: (m 0-7, k 0-7), (m 8-15, k 0-7),
      // (m 0-7, k 8-15), (m 8-15, k 8-15), from [k][m] transposed or [m][k]
      if (!kT)
        ldsm_x4_t(ws + (tap * kTcCc + (q / 2) * 8 + r) * kTcWP + m0 + (q % 2) * 8, a[mi]);
      else
        ldsm_x4(ws + (tap * kTcCo + m0 + (q % 2) * 8 + r) * kTcXP + (q / 2) * 8, a[mi]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint32_t* xb = xq + dy * kTcPairs * kTcXS + ni * 8 + dx;
      const uint32_t b0 = xb[0], b1 = xb[4 * kTcXS];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// Output channel and frame (within the block's tile) of accumulator element
// acc[mi][ni][e]: the m16n8 fragment layout.
static __device__ __forceinline__ int tc_m(int warp_m, int lane, int mi, int e) {
  return warp_m * 32 + mi * 16 + lane / 4 + (e / 2) * 8;
}
static __device__ __forceinline__ int tc_n(int warp_n, int lane, int ni, int e) {
  return warp_n * 32 + ni * 8 + (lane % 4) * 2 + (e % 2);
}

// Conv rows f_first .. f_first + n_rows - 1 of the block's tile (outputs
// [co0, co0 + 64) x frames [t0, t0 + 64)), x (K, F, T) of one batch item;
// after each row, epi(r, acc) with acc that row's conv (then zeroed). One
// pipeline runs over every (row, chunk): chunk i + 1 loads while chunk i
// multiplies. Every thread of the block must call it; it ends synchronised,
// so the caller may reuse the shared memory afterwards.
template <bool kT, typename Epi>
static __device__ __forceinline__ void conv_rows_tc(bf16* __restrict__ smem,
                                                    const bf16* __restrict__ xb,
                                                    const bf16* __restrict__ w, int f_first,
                                                    int n_rows, int co0, int t0, int k_dim,
                                                    int f_dim, int t_dim, int m_dim, Epi&& epi) {
  constexpr int kStage = kTcXElems + tc_w_elems<kT>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const bool vec = (kT ? k_dim : m_dim) % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = t_dim % 8 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  const uint16_t* xu = reinterpret_cast<const uint16_t*>(xb);
  const int n_chunks = ceil_div(k_dim, kTcCc);
  const int total = n_rows * n_chunks;
  uint32_t xr[kTcXRegs];
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  tc_load_w<kT>(smem + kTcXElems, w, 0, co0, k_dim, m_dim, vec);
  cp_async_commit();
  tc_load_x(xr, xu, f_first, 0, t0, k_dim, f_dim, t_dim, xvec);
  tc_store_x(reinterpret_cast<uint32_t*>(smem), xr, xvec);
  cp_async_wait_all();
  __syncthreads();
  for (int it = 0; it < total; ++it) {
    bf16* cur = smem + (it & 1) * kStage;
    bf16* nxt = smem + ((it + 1) & 1) * kStage;
    const bool more = it + 1 < total;
    if (more) {   // the next chunk: weights by cp.async, x into registers
      const int row = f_first + (it + 1) / n_chunks, c0 = ((it + 1) % n_chunks) * kTcCc;
      tc_load_w<kT>(nxt + kTcXElems, w, c0, co0, k_dim, m_dim, vec);
      cp_async_commit();
      tc_load_x(xr, xu, row, c0, t0, k_dim, f_dim, t_dim, xvec);
    }
    tc_mma_chunk<kT>(reinterpret_cast<const uint32_t*>(cur), cur + kTcXElems, warp_m, warp_n,
                     lane, acc);
    if ((it + 1) % n_chunks == 0) {
      epi(it / n_chunks, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    if (more) {
      tc_store_x(reinterpret_cast<uint32_t*>(nxt), xr, xvec);
      cp_async_wait_all();
    }
    __syncthreads();   // nxt is complete; cur's readers are done
  }
}

// The per-channel sums of a block's tile: s1[mi][hh], s2[mi][hh] are this
// thread's for channel co0 + tc_m(warp_m, lane, mi, 2 hh). They are summed
// over the quad (the lanes that share a channel), then over the four frame
// warps in order through `red` (shared memory for 4 x kTcCo x 2 floats that
// no thread still reads, e.g. after conv_rows_tc), and written to row[co]
// and row[cout + co] for co < cout: one partial row, in a fixed order.
// Every thread of the block must call it.
static __device__ __forceinline__ void tc_channel_sums(float* __restrict__ red,
                                                       const float (&s1)[2][2],
                                                       const float (&s2)[2][2], int co0,
                                                       int cout, float* __restrict__ row) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float a = s1[mi][hh], q = s2[mi][hh];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if (lane % 4 == 0) {
        const int m = tc_m(warp_m, lane, mi, 2 * hh);
        red[(warp_n * kTcCo + m) * 2] = a;
        red[(warp_n * kTcCo + m) * 2 + 1] = q;
      }
    }
  __syncthreads();
  const int co = co0 + threadIdx.x;
  if (threadIdx.x < kTcCo && co < cout) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int wn = 0; wn < 4; ++wn) {
      a += red[(wn * kTcCo + threadIdx.x) * 2];
      q += red[(wn * kTcCo + threadIdx.x) * 2 + 1];
    }
    row[co] = a;
    row[cout + co] = q;
  }
}

// ---- The block tile: 64 channels x 64 frames x 4 conv rows a pass ---------

constexpr int kTbNi = 4;                    // n8 tiles of a warp: 32 frames
constexpr int kTbT = 2 * 8 * kTbNi;         // frames (N) per block: two warps a row slot
constexpr int kTbSlots = 4;                 // conv rows per pass: warp w takes slot w / 2
constexpr int kTbRows = kTbSlots + 2;       // input rows a pass stages
constexpr int kTbXT = kTbT + 2;             // frames a conv row reads: t0 - 1 .. t0 + kTbT
constexpr int kTbGroups = kTbT / 8 + 2;     // 8-frame groups staged: t0 - 8 .. t0 + kTbT + 7
constexpr int kTbXS = 8 * kTbGroups + 8;    // words per staged (row, pair): 24 mod 32
constexpr int kTbXWords = kTbRows * kTcPairs * kTbXS;       // one stage of x
constexpr int kTbXElems = 2 * kTbXWords;                    // the same in bf16 elements
constexpr int kTbVItems = kTbRows * kTcPairs * kTbGroups;   // (row, pair, group) vector items
constexpr int kTbSItems = kTbRows * kTcPairs * kTbXT;       // (row, pair, frame) scalar items
constexpr int kTbVPerThread = (kTbVItems + kTcThreads - 1) / kTcThreads;
constexpr int kTbSPerThread = (kTbSItems + kTcThreads - 1) / kTcThreads;
constexpr int kTbBP = kTbT + 8;             // padded row of a bf16 [64][kTbT] epilogue buffer
using TbAcc = float[4][kTbNi][4];           // a warp's 64 x 32 accumulator fragments
constexpr int kTbRed = 8 * kTcCo * 2;       // floats of tb_channel_sums' per-warp sums

template <bool kT>
__host__ __device__ constexpr size_t tb_ring_bytes() {
  return 2 * sizeof(bf16) * (kTbXElems + tc_w_elems<kT>());
}

// Conv rows of a block: pf rows (one pool window), or 4 where pf is 1 or 2
// (4 / pf windows), so that a pass fills its 4 row slots.
__host__ __device__ constexpr int tb_block_rows(int pf) { return pf <= 2 ? kTbSlots : pf; }

constexpr int kTbXRegs = 8 * kTbVPerThread > kTbSPerThread ? 8 * kTbVPerThread : kTbSPerThread;

// The pass's x in registers: channels (c0 + 2p, c0 + 2p + 1) of input rows
// f_row0 .. f_row0 + 5, zero outside the input and past Cin, as
// tc_load_x's (vec: 8-frame groups t0 - 8 + 8g; else frames t0 - 1 + s).
static __device__ __forceinline__ void tb_load_x(uint32_t (&xr)[kTbXRegs],
                                                 const uint16_t* __restrict__ xb, int f_row0,
                                                 int c0, int t0, int cin, int f_dim, int t_dim,
                                                 bool vec) {
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kTbVPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (e < kTbVItems) {
        const int g = e % kTbGroups, rest = e / kTbGroups;
        const int ci = c0 + 2 * (rest % kTcPairs);
        const int f = f_row0 + rest / kTcPairs;
        const int t = t0 - 8 + 8 * g;
        if (f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
          const uint16_t* src = xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t;
          lo = __ldg(reinterpret_cast<const uint4*>(src));
          if (ci + 1 < cin) hi = __ldg(reinterpret_cast<const uint4*>(src + plane));
        }
      }
      const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) xr[8 * j + k] = words[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTbSPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      uint32_t v = 0;
      if (e < kTbSItems) {
        const int s = e % kTbXT, rest = e / kTbXT;
        const int ci = c0 + 2 * (rest % kTcPairs);
        const int f = f_row0 + rest / kTcPairs;
        const int t = t0 - 1 + s;
        if (f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
          const uint16_t* src = xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t;
          v = __ldg(src);
          if (ci + 1 < cin) v |= static_cast<uint32_t>(__ldg(src + plane)) << 16;
        }
      }
      xr[j] = v;
    }
  }
}

// xs[row][p][s] (channel 2p low, 2p + 1 high, frame t0 - 8 + s) from
// tb_load_x's registers.
static __device__ __forceinline__ void tb_store_x(uint32_t* __restrict__ xs,
                                                  const uint32_t (&xr)[kTbXRegs], bool vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < kTbVPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      if (e < kTbVItems) {
        const int g = e % kTbGroups, rest = e / kTbGroups;
        uint4* dst = reinterpret_cast<uint4*>(xs + rest * kTbXS + 8 * g);
        const uint32_t* lo = xr + 8 * j;
        const uint32_t* hi = lo + 4;
        dst[0] = make_uint4(__byte_perm(lo[0], hi[0], 0x5410), __byte_perm(lo[0], hi[0], 0x7632),
                            __byte_perm(lo[1], hi[1], 0x5410), __byte_perm(lo[1], hi[1], 0x7632));
        dst[1] = make_uint4(__byte_perm(lo[2], hi[2], 0x5410), __byte_perm(lo[2], hi[2], 0x7632),
                            __byte_perm(lo[3], hi[3], 0x5410), __byte_perm(lo[3], hi[3], 0x7632));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTbSPerThread; ++j) {
      const int e = threadIdx.x + j * kTcThreads;
      if (e < kTbSItems) xs[(e / kTbXT) * kTbXS + e % kTbXT + 7] = xr[j];
    }
  }
}

// acc += one chunk on this warp's 64 x 32 tile of conv row `slot` of the
// pass: nine taps, one k16 step each, in order; per tap the four B
// fragments (two 32-bit loads each, b0b1 = channels (2q, 2q + 1), b2b3 =
// (2q + 8, 2q + 9) at frame n + dx - 1) feed all four A fragments
// (ldmatrix): 16 products for 16 shared-memory wavefronts of A and 8 of B.
template <bool kT>
static __device__ __forceinline__ void tb_mma_chunk(const uint32_t* __restrict__ xs,
                                                    const bf16* __restrict__ ws, int slot,
                                                    int half, int lane, TbAcc& acc) {
  const int q = lane / 8, r = lane % 8;
  const uint32_t* xq =
      xs + (slot * kTcPairs + lane % 4) * kTbXS + half * 8 * kTbNi + lane / 4 + 7;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t b0[kTbNi], b1[kTbNi];
#pragma unroll
    for (int ni = 0; ni < kTbNi; ++ni) {
      const uint32_t* xb = xq + dy * kTcPairs * kTbXS + ni * 8 + dx;
      b0[ni] = xb[0];
      b1[ni] = xb[4 * kTbXS];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      uint32_t a[4];
      if (!kT)
        ldsm_x4_t(ws + (tap * kTcCc + (q / 2) * 8 + r) * kTcWP + mi * 16 + (q % 2) * 8, a);
      else
        ldsm_x4(ws + (tap * kTcCo + mi * 16 + (q % 2) * 8 + r) * kTcXP + (q / 2) * 8, a);
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni) mma_bf16(acc[mi][ni], a, b0[ni], b1[ni]);
    }
  }
}

// Output channel and frame (within the block's tile) of acc[mi][ni][e].
static __device__ __forceinline__ int tb_m(int lane, int mi, int e) {
  return mi * 16 + lane / 4 + (e / 2) * 8;
}
static __device__ __forceinline__ int tb_n(int half, int lane, int ni, int e) {
  return half * 8 * kTbNi + ni * 8 + (lane % 4) * 2 + (e % 2);
}

// The block tile's pipeline over conv rows f_first .. f_first + n_rows - 1
// of the block's tile (outputs [co0, co0 + 64) x frames [t0, t0 + kTbT)), x
// (K, F, T) of one batch item. The rows go in passes of 4: pass(acc) runs
// the next pass's chunks into acc, warp w computing row `row` = 4 p + w / 2
// of pass p (if < n_rows) on frames t0 + 32 (w % 2) .. + 31, and returns
// false once every pass has run. The caller's epilogue then reads acc (a
// struct, not a callback: the accumulators stay in registers). One
// pipeline runs over every (pass, chunk): chunk i + 1 loads while chunk i
// multiplies, the next pass's first chunk during this pass's last. Every
// thread of the block must construct it and call pass() until it returns
// false. Each pass ends in a barrier, before its epilogue: the ring is free
// once pass() has returned false, but what the last epilogue wrote to
// shared memory needs the caller's own barrier before another warp reads it.
template <bool kT>
struct TbPipe {
  static constexpr int kStage = kTbXElems + tc_w_elems<kT>();
  bf16* smem;
  const bf16* w;
  const uint16_t* xu;
  int f_first, n_rows, co0, t0, k_dim, f_dim, t_dim, m_dim;
  int slot, half, lane, n_chunks, total, it, next_pass, row;
  bool vec, xvec;
  uint32_t xr[kTbXRegs];

  __device__ __forceinline__ TbPipe(bf16* smem_, const bf16* xb, const bf16* w_, int f_first_,
                                    int n_rows_, int co0_, int t0_, int k_dim_, int f_dim_,
                                    int t_dim_, int m_dim_)
      : smem(smem_), w(w_), xu(reinterpret_cast<const uint16_t*>(xb)), f_first(f_first_),
        n_rows(n_rows_), co0(co0_), t0(t0_), k_dim(k_dim_), f_dim(f_dim_), t_dim(t_dim_),
        m_dim(m_dim_) {
    lane = threadIdx.x % 32;
    slot = threadIdx.x / 64;
    half = (threadIdx.x / 32) % 2;
    vec = (kT ? k_dim : m_dim) % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    xvec = t_dim % 8 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
    n_chunks = ceil_div(k_dim, kTcCc);
    total = ceil_div(n_rows, kTbSlots) * n_chunks;
    it = 0;
    next_pass = 0;
    row = slot;
    tc_load_w<kT>(smem + kTbXElems, w, 0, co0, k_dim, m_dim, vec);
    cp_async_commit();
    tb_load_x(xr, xu, f_first - 1, 0, t0, k_dim, f_dim, t_dim, xvec);
    tb_store_x(reinterpret_cast<uint32_t*>(smem), xr, xvec);
    cp_async_wait_all();
    __syncthreads();
  }

  __device__ __forceinline__ bool pass(TbAcc& acc) {
    if (it >= total) return false;
    row = next_pass * kTbSlots + slot;
    ++next_pass;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int chunk = 0; chunk < n_chunks; ++chunk, ++it) {
      const bf16* cur = smem + (it & 1) * kStage;
      bf16* nxt = smem + ((it + 1) & 1) * kStage;
      const bool more = it + 1 < total;
      const bool last = chunk + 1 == n_chunks;
      if (more) {   // the next (pass, chunk): weights by cp.async, x into registers
        const int nf = f_first + (last ? next_pass : next_pass - 1) * kTbSlots - 1;
        const int nc = (last ? 0 : chunk + 1) * kTcCc;
        tc_load_w<kT>(nxt + kTbXElems, w, nc, co0, k_dim, m_dim, vec);
        cp_async_commit();
        tb_load_x(xr, xu, nf, nc, t0, k_dim, f_dim, t_dim, xvec);
      }
      if (row < n_rows)   // warp-uniform
        tb_mma_chunk<kT>(reinterpret_cast<const uint32_t*>(cur), cur + kTbXElems, slot, half,
                         lane, acc);
      if (more) {
        tb_store_x(reinterpret_cast<uint32_t*>(nxt), xr, xvec);
        cp_async_wait_all();
      }
      __syncthreads();   // nxt is complete; cur's readers are done
    }
    return true;
  }
};

// Per-channel sums over a block tile's rows, in a fixed order: each warp
// adds its rows' sums to its own row of `red` (tb_add_sums, after each
// pass), then tb_channel_sums adds the 8 warps' rows in order. `red`:
// kTbRed floats outside the ring, zeroed by tb_zero_sums before the
// TbPipe is constructed (its first barrier orders the two).
static __device__ __forceinline__ void tb_zero_sums(float* __restrict__ red) {
  for (int e = threadIdx.x; e < kTbRed; e += kTcThreads) red[e] = 0.f;
}

// s1[mi][hh], s2[mi][hh]: this thread's sums for channel tb_m(lane, mi, 2 hh)
// of one row; summed over the quad, then added to the warp's row of red.
static __device__ __forceinline__ void tb_add_sums(float* __restrict__ red,
                                                   const float (&s1)[4][2],
                                                   const float (&s2)[4][2]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float a = s1[mi][hh], q = s2[mi][hh];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if (lane % 4 == 0) {
        float* p = red + (warp * kTcCo + tb_m(lane, mi, 2 * hh)) * 2;
        p[0] += a;
        p[1] += q;
      }
    }
}

// row[co] and row[cout + co] for co < cout: the 8 warps' sums in order.
// Every thread of the block must call it (after the TbPipe's last pass).
static __device__ __forceinline__ void tb_channel_sums(const float* __restrict__ red, int co0,
                                                       int cout, float* __restrict__ row) {
  __syncthreads();
  const int co = co0 + threadIdx.x;
  if (threadIdx.x < kTcCo && co < cout) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int wp = 0; wp < 8; ++wp) {
      a += red[(wp * kTcCo + threadIdx.x) * 2];
      q += red[(wp * kTcCo + threadIdx.x) * 2 + 1];
    }
    row[co] = a;
    row[cout + co] = q;
  }
}

}  // namespace
