// The float32 smallcin tile: stage 1's 3x3 conv (Cin <= 10) in split TF32,
// the float32 counterpart of bfloat16's smallcin_tc_kernel
// (conv3x3_bn_relu_fpool.cu). One row function, scf_window, serves three
// epilogues: K2's pool (smallcin_tf32_kernel, conv3x3_bn_relu_fpool.cu, also
// K5's float32 F2), K5's F1 sums (train_stats_tf32_kernel) and K5's g_z pass
// (train_gz_tf32_kernel, both conv3x3_train.cu), so the three get every
// conv row bit for bit alike, and K5's backward routes the pool gradient on
// the rows F2 pooled.
//
// A conv row is an implicit GEMM: M = 64 output channels, N = frames, K = 9
// taps x CC staged channels (CC = 8 for Cin <= 8, 16 for Cin 9-10, zero
// past Cin). The K walk is FtPipe's (conv3x3_tf32.cuh) exactly: chunks of 8
// channels in increasing order, within a chunk the taps (dy, dx) in
// row-major order, channel c0 + k at k of the k8 step, each step
// mma_3xtf32_add (mma.cuh: hi by cvt.rna, three TF32 products summed on the
// tensor cores from zero, then added to the float accumulator). So at every
// Cin <= 10 these rows equal the float block tile's (K10b's) bit for bit,
// and ops/kernels/tf32.py::conv_rows_tf32_plain is their arithmetic.
//
// Weights resident. At Cin 8 the whole K of a 64-channel Cout tile is 72 x
// 64 floats: a block copies its tile's 9 x CC x 64 weights once by 4-byte
// cp.async into the lo plane and splits them in place into hi and lo
// planes, in fragment order (item (chunk, tap, m16 tile, lane), its four
// words a0 (m g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), so a
// warp reads an A fragment as one 16-byte load a plane. The planes stay for
// all of the block's frame tiles and pool rows (the block tile restages and
// re-splits its one chunk of weights every 4-row pass at Cin 8).
//
// x in halo chunks. The window's rows and 2 halo rows are staged in chunks
// of at most `chunk` rows (scf_chunk_rows: what fits one block's shared
// memory beside the weights), as [row][ci][frame t0 - 4 + s], by cp.async
// (16-byte copies where T % 4 == 0 and x is aligned, else 4-byte ones of
// frames t0 - 1 .. t0 + 128), zero outside the input and past Cin; the
// epilogues carry their running max, sums or routing state across chunks,
// so any pool_f runs. x is split as each warp reads it (split at staging, the
// block tile ran 1.15x slower). The row stride of 136 words (8 mod 32) puts
// a B fragment's 32 lanes (g along frames, t along channels) on 32 banks.
//
// Geometry. 128 threads, 4 warps; warp w takes frames t0 + 32 w .. + 31 of
// a 128-frame tile, all 64 channels: a 64 x 32 warp tile (4 x 4 m16n8
// fragments, TbAcc), every row of the window in turn, so an epilogue's
// running state sits in the thread's registers beside the accumulators.
// Two blocks an SM (__launch_bounds__(128, 2): at most 255 registers, and at
// pool 8 a block's 81 KB of shared memory leaves room for two), so one
// block's staging and barriers overlap the other's products; the tap loop
// stays rolled, as FtPipe's. A block walks `tiles` frame tiles of one pool
// window and one Cout tile.
#pragma once

#include "conv3x3_tf32.cuh"

namespace {

constexpr int kScfThreads = 128;          // 4 warps of 64 channels x 32 frames
constexpr int kScfT = 4 * 32;             // frames of a tile
constexpr int kScfXS = kScfT + 8;         // words a staged (row, ci): t0 - 4 .. t0 + 131
constexpr int kScfXGroups = kScfXS / 4;   // 16-byte groups of a staged (row, ci)
constexpr int kScfXFrames = kScfT + 2;    // frames a conv row reads: t0 - 1 .. t0 + kScfT
constexpr int kScfCols = 4 * kTcCo;       // floats of the per-channel columns (sc, bi, a, b)
constexpr int kScfZRow = kTcCo * 32;      // floats of one staged g_z row of a warp

// Words of one weight plane (hi or lo): CC / 8 chunks of kFtWItems fragments.
template <int CC>
__host__ __device__ constexpr int scf_w_words() { return CC / 8 * 4 * kFtWItems; }

// Bytes of one staged input row (CC channels) and of the fixed part of the
// shared memory: the two weight planes and the columns.
template <int CC>
__host__ __device__ constexpr size_t scf_row_bytes() { return sizeof(float) * CC * kScfXS; }
template <int CC>
__host__ __device__ constexpr size_t scf_fixed_bytes() {
  return sizeof(float) * (2 * scf_w_words<CC>() + kScfCols);
}

// The most conv rows one staging takes: chunk + 2 input rows beside the
// weights and the columns in one block's shared memory (42 at CC 8, 16 at
// CC 16; conv2d_pool.smallcin_max_pool_f gives the same numbers).
template <int CC>
__host__ __device__ constexpr int scf_chunk_rows() {
  return static_cast<int>((kBlockSmem - scf_fixed_bytes<CC>()) / scf_row_bytes<CC>()) - 2;
}

// Shared memory of a launch staging `chunk` rows.
template <int CC>
__host__ __device__ constexpr size_t scf_smem_bytes(int chunk) {
  return scf_fixed_bytes<CC>() + (chunk + 2) * scf_row_bytes<CC>();
}

// This block's weight items, w (3, 3, Cin, Cout) at output channels co0 ..
// co0 + 63, by 4-byte cp.async into the lo plane (raw), zero past Cin and
// Cout: item e of chunk c is the A fragment of tap (e / 128), m16 tile
// (e / 32) % 4 and lane e % 32 (g = lane / 4, t = lane % 4), its word r the
// weight (k = 8 c + t + 4 (r / 2), m = 16 tile + g + 8 (r % 2)).
template <int CC>
static __device__ __forceinline__ void scf_load_w(uint32_t* __restrict__ w_hi,
                                                  const float* __restrict__ w, int co0, int cin,
                                                  int cout) {
  uint32_t* raw = w_hi + scf_w_words<CC>();
  for (int e = threadIdx.x; e < CC / 8 * kFtWItems; e += kScfThreads) {
    const int i = e % kFtWItems, lane = i % 32, tap = i / 128;
    const int co = co0 + (i / 32) % 4 * 16 + lane / 4, ci = e / kFtWItems * 8 + lane % 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = co + (r % 2) * 8, k = ci + (r / 2) * 4;
      const bool ok = k < cin && m < cout;
      cp_async4(raw + 4 * e + r, ok ? w + (static_cast<size_t>(tap) * cin + k) * cout + m : w,
                ok ? 4 : 0);
    }
  }
}

// This thread's items of scf_load_w, once its copies have landed, split into
// the hi and lo planes (lo over the raw words).
template <int CC>
static __device__ __forceinline__ void scf_split_w(uint32_t* __restrict__ w_hi) {
  uint4* hi = reinterpret_cast<uint4*>(w_hi);
  uint4* lo = reinterpret_cast<uint4*>(w_hi + scf_w_words<CC>());
  for (int e = threadIdx.x; e < CC / 8 * kFtWItems; e += kScfThreads) {
    const uint4 v = lo[e];
    uint4 h, l;
    split_tf32(__uint_as_float(v.x), h.x, l.x);
    split_tf32(__uint_as_float(v.y), h.y, l.y);
    split_tf32(__uint_as_float(v.z), h.z, l.z);
    split_tf32(__uint_as_float(v.w), h.w, l.w);
    hi[e] = h;
    lo[e] = l;
  }
}

// Input rows f_first .. f_first + n_in - 1, channels 0 .. CC - 1, of x (Cin,
// F, T) of one batch item into xs [row][ci][s] (frame t0 - 4 + s) by
// cp.async, zero outside the input and past Cin; vec: 16-byte copies of
// frames t0 - 4 .. t0 + 131, else 4-byte ones of t0 - 1 .. t0 + 128.
template <int CC>
static __device__ __forceinline__ void scf_stage_x(float* __restrict__ xs,
                                                   const float* __restrict__ xb, int n_in,
                                                   int f_first, int t0, int cin, int f_dim,
                                                   int t_dim, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < n_in * CC * kScfXGroups; e += kScfThreads) {
      const int g = e % kScfXGroups, rest = e / kScfXGroups;
      const int ci = rest % CC, f = f_first + rest / CC, t = t0 - 4 + 4 * g;
      const bool ok = f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin;
      cp_async16(xs + rest * kScfXS + 4 * g,
                 ok ? xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t : xb, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < n_in * CC * kScfXFrames; e += kScfThreads) {
      const int s = e % kScfXFrames, rest = e / kScfXFrames;
      const int ci = rest % CC, f = f_first + rest / CC, t = t0 - 1 + s;
      const bool ok = f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin;
      cp_async4(xs + rest * kScfXS + s + 3,
                ok ? xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t : xb, ok ? 4 : 0);
    }
  }
}

// acc = conv row r of the staged chunk on NMI m16 tiles from mi0 of this
// warp's 64 x 32 tile: per 8-channel chunk, the nine taps in order, one k8
// step each; per tap the four B fragments (b0 channel t, b1 channel t + 4,
// at frame n + dx - 1 of staged input row r + dy) split as read feed the
// NMI A fragments (16-byte loads of the hi and lo planes). Every output
// element sees the same K walk whatever NMI is.
template <int CC, int NMI>
static __device__ __forceinline__ void scf_mma_row(const float* __restrict__ xs,
                                                   const uint32_t* __restrict__ w_hi, int r,
                                                   int mi0, float (&acc)[NMI][kTbNi][4]) {
  const int lane = threadIdx.x % 32;
  const float* xq = xs + (r * CC + lane % 4) * kScfXS + threadIdx.x / 32 * 32 + lane / 4 + 3;
  const uint4* a4 = reinterpret_cast<const uint4*>(w_hi) + lane;   // hi; lo scf_w_words / 4 on
#pragma unroll
  for (int mi = 0; mi < NMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
  for (int c = 0; c < CC / 8; ++c) {
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t bh[kTbNi][2], bl[kTbNi][2];
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni) {
        const float* xb = xq + (dy * CC + 8 * c) * kScfXS + ni * 8 + dx;
        split_tf32(xb[0], bh[ni][0], bl[ni][0]);
        split_tf32(xb[4 * kScfXS], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < NMI; ++mi) {
        const int item = ((c * 9 + tap) * 4 + mi0 + mi) * 32;
        const uint4 h = a4[item], l = a4[item + scf_w_words<CC>() / 4];
        const uint32_t a_hi[4] = {h.x, h.y, h.z, h.w}, a_lo[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) mma_3xtf32_add(acc[mi][ni], a_hi, a_lo, bh[ni], bl[ni]);
      }
    }
  }
}

// Output channel (within the Cout tile) and frame (within the frame tile) of
// acc[mi][ni][e] in warp threadIdx.x / 32.
static __device__ __forceinline__ int scf_m(int mi, int e) {
  return mi * 16 + threadIdx.x % 32 / 4 + (e / 2) * 8;
}
static __device__ __forceinline__ int scf_n(int ni, int e) {
  return threadIdx.x / 32 * 32 + ni * 8 + threadIdx.x % 4 * 2 + e % 2;
}

// The conv rows f0 .. f0 + pf - 1 of one frame tile (t0) of x (Cin, F, T),
// one pool window: staged `chunk` rows (+ 2 halo) at a time into xs, each
// row's accumulators handed to epi(r, part, acc), r the row within the
// window: in kParts parts of 4 / kParts m16 tiles each (part p: tiles 4 p /
// kParts ..), each part a pass of the K walk over the row (kParts 2 halves
// the accumulators an epilogue holds beside its own state, for the price of
// splitting the B fragments twice). Every thread of the block must call it.
// split_w: the weights' copies were issued (scf_load_w) and are split after
// the first staging has landed, then cleared. The first barrier of each
// staging orders it after the last readers of the previous one and after
// anything the caller wrote to shared memory before the call.
template <int CC, int kParts, typename Epi>
static __device__ __forceinline__ void scf_window(float* __restrict__ xs, uint32_t* __restrict__ w_hi,
                                                  const float* __restrict__ xb, int f0, int pf,
                                                  int chunk, int t0, int cin, int f_dim, int t_dim,
                                                  bool vec, bool& split_w, Epi&& epi) {
  constexpr int kNmi = 4 / kParts;
  for (int r0 = 0; r0 < pf; r0 += chunk) {
    const int rows = min(chunk, pf - r0);
    __syncthreads();
    scf_stage_x<CC>(xs, xb, rows + 2, f0 + r0 - 1, t0, cin, f_dim, t_dim, vec);
    cp_async_commit();
    cp_async_wait_all();
    if (split_w) {
      scf_split_w<CC>(w_hi);
      split_w = false;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        float acc[kNmi][kTbNi][4];
        scf_mma_row<CC, kNmi>(xs, w_hi, r, part * kNmi, acc);
        epi(r0 + r, part, acc);
      }
    }
  }
}

// The block's per-channel sums, s1[mi][h] and s2[mi][h] for channel
// scf_m(mi, 2 h): over the quad, then the 4 warps' in order through red
// (4 x 64 x 2 floats that no thread reads any more), into row[co] and
// row[cout + co] for co < cout. Every thread of the block must call it.
static __device__ __forceinline__ void scf_channel_sums(float* __restrict__ red,
                                                        const float (&s1)[4][2],
                                                        const float (&s2)[4][2], int co0,
                                                        int cout, float* __restrict__ row) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = s1[mi][h], q = s2[mi][h];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if (lane % 4 == 0) {
        red[(warp * kTcCo + scf_m(mi, 2 * h)) * 2] = a;
        red[(warp * kTcCo + scf_m(mi, 2 * h)) * 2 + 1] = q;
      }
    }
  __syncthreads();
  const int co = co0 + threadIdx.x;
  if (threadIdx.x < kTcCo && co < cout) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int wp = 0; wp < 4; ++wp) {
      a += red[(wp * kTcCo + threadIdx.x) * 2];
      q += red[(wp * kTcCo + threadIdx.x) * 2 + 1];
    }
    row[co] = a;
    row[cout + co] = q;
  }
}

// The columns of this block's 64 channels, cols[m] = (v0[co], v1[co], v2[co],
// v3[co]) for co = co0 + m < cout, else zeros; a null pointer gives zeros.
static __device__ __forceinline__ void scf_stage_cols(float4* __restrict__ cols,
                                                      const float* __restrict__ v0,
                                                      const float* __restrict__ v1,
                                                      const float* __restrict__ v2,
                                                      const float* __restrict__ v3, int co0,
                                                      int cout) {
  const int m = threadIdx.x, co = co0 + m;
  if (m >= kTcCo) return;
  const bool ok = co < cout;
  cols[m] = make_float4(ok && v0 ? v0[co] : 0.f, ok && v1 ? v1[co] : 0.f,
                        ok && v2 ? v2[co] : 0.f, ok && v3 ? v3[co] : 0.f);
}

}  // namespace
