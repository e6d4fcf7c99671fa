// The tensor-core 3x3 conv tile of the bfloat16 CNN stages, shared by K3
// and K10b (conv3x3_bn_relu_fpool.cu: the serving stage, K9's F2 and K5's
// F2), by K9's F1 and dh passes (conv3x3_ct_train.cu) and by K5's F1 and
// g_z passes (conv3x3_train.cu). float32 keeps the SIMT tile of
// conv3x3_common.cuh (TF32 stays off).
//
// A conv row is an implicit GEMM: M = 64 output channels, N = 128 frames,
// K = 9 taps x Cin, walked in chunks of 16 input channels (one k16 step of
// mma.sync.m16n8k16 per tap, bf16 operands, float accumulators). 256
// threads: 8 warps, 2 along Cout x 4 along frames, each a 32 x 32 tile of
// 2 x 4 m16n8 fragments. mma.sync, not wgmma: the tap shift below moves the
// B operand by one frame per dx, which a 32-bit shared load takes at any
// frame, where a wgmma descriptor needs one aligned, swizzled matrix per
// shift.
//
// The tap shift. x is (B, Cin, F, T) with frames contiguous, and the B
// operand of tap (dy, dx) is x shifted by dx frames: a 2-byte shift breaks
// the 16-byte rows that ldmatrix reads. So each chunk stages x as 32-bit
// words [3 rows][8 channel pairs][frames], each word the two channels of a
// pair at one frame: a B fragment is then two 32-bit loads (channels 2q,
// 2q + 1 and 2q + 8, 2q + 9 at one frame), aligned at every shift, and the
// 168-word pair rows (8 mod 32 banks) keep the 32 lanes on 32 banks. The
// pairing happens in registers (16-byte loads of 8 frames of each channel,
// byte permutes, two 16-byte stores; a 2-byte path where T % 8 != 0), so
// x cannot come by cp.async: the next chunk's loads are issued before the
// current chunk's products and stored after them. The weights come by
// cp.async (16-byte copies, zero-filled past Cin and Cout) into
// [tap][ci][co] (ldmatrix.trans gives the row-major A fragment), or for dh's
// transposed weights into [tap][co][ci]. Two stages of (x, w) form the
// ring: the next chunk loads while this one multiplies.
//
// Invariants: F1, F2 and K5's g_z pass call conv_rows_tc with the same
// rows, chunks and fragments, so their conv rows are bitwise equal (K9's
// backward routes the pool gradient on F1's rows, K5's on the g_z pass's
// recompute); a ragged last Cin chunk is zero-filled, so
// any Cin works; ragged Cout and T are masked by the epilogues; only
// t < T is read; any number of rows (pf) runs through one pipeline.
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
constexpr int kTcWVecs = 9 * kTcCc * kTcCo / 8;        // 16-byte copies of one w stage

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
    for (int e = threadIdx.x; e < kTcWVecs; e += kTcThreads) {
      int k, m, tap;
      bf16* dst;
      if (!kT) {
        const int v = e % (kTcCo / 8), rest = e / (kTcCo / 8);
        k = rest % kTcCc;
        tap = rest / kTcCc;
        m = 8 * v;
        dst = ws + (tap * kTcCc + k) * kTcWP + m;
      } else {
        const int h = e % (kTcCc / 8), rest = e / (kTcCc / 8);
        m = rest % kTcCo;
        tap = rest / kTcCo;
        k = 8 * h;
        dst = ws + (tap * kTcCo + m) * kTcXP + k;
      }
      const bool ok = c0 + k < k_dim && co0 + m < m_dim;
      const bf16* src =
          !ok ? w
              : kT ? w + (static_cast<size_t>(8 - tap) * m_dim + co0 + m) * k_dim + c0 + k
                   : w + (static_cast<size_t>(tap) * k_dim + c0 + k) * m_dim + co0 + m;
      cp_async16(dst, src, ok ? 16 : 0);
    }
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
// [co0, co0 + 64) x frames [t0, t0 + 128)), x (K, F, T) of one batch item;
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

}  // namespace
