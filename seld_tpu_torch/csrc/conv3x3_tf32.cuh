// The float32 block tile of the CNN stages 2-3: TbPipe's geometry
// (conv3x3_tc.cuh) in split TF32. It serves K3 and K10b
// (conv3x3_bn_relu_fpool.cu: the serving stage and K9's F2) and K9's F1 and
// dh (conv3x3_ct_train.cu; dh on the transposed weights, FtPipe<true>) in
// float32.
//
// A conv row is an implicit GEMM: M = 64 output channels, N = frames, K = 9
// taps x Cin, walked in chunks of 8 input channels, one m16n8k8 TF32 step per
// tap. Every k8 step is mma_3xtf32_add (mma.cuh): x and w split into hi + lo
// (hi by cvt.rna, so a NaN stays a NaN), three TF32 products summed on the
// tensor cores from zero, then added to the float accumulators rounded to
// nearest, so no chain on the tensor cores is longer than one step.
//
// The K walk: chunks in increasing channel order, within a chunk the taps
// (dy, dx) in row-major order, in a k8 step channel c0 + k at k; each
// accumulator starts at zero. F1 and F2 therefore give every conv row bit
// for bit alike (K9's backward routes the pool gradient on F1's rows).
//
// The tap shift. A float32 frame is one 32-bit word, so x staged as
// [row][ci][frames] gives an aligned B fragment at every dx shift: b0 (k t,
// n g) and b1 (k t + 4, n g) are single words at frame n + dx - 1, and the
// (ci) row stride of 72 words (8 mod 32) puts the 32 lanes (g along frames,
// t along ci) on 32 banks. x comes by cp.async straight into the ring (16-
// byte copies from frame t0 - 4 where T % 4 == 0 and x is aligned, else
// 4-byte ones, zero-filled outside the input and past Cin) and is split as
// each warp reads it (split once at staging into hi and lo planes, stage 2
// ran 1.15x slower, PERF.md §6). The weights (the A operand, shared by all 8
// warps) are split once as they are staged: each thread copies the four
// values of its (tap, m16 tile, lane) fragment items by cp.async into the lo
// plane before the chunk's products and, once they have landed, splits them
// into the hi and lo planes (no registers held across the products), in
// fragment order, so a warp reads an A fragment as one 16-byte load a plane.
//
// Geometry (TbPipe's): 64 output channels x 64 frames x 4 conv rows a pass,
// 256 threads; warp w takes row slot w / 2 and 32 frames (w % 2), a 64 x 32
// warp tile (4 x 4 m16n8 fragments). A pass stages its 6 input rows once per
// chunk and the chunk's weights once for its 4 rows. Two stages of (x, w hi,
// w lo) form the ring: the next chunk loads while this one multiplies. One
// block an SM (__launch_bounds__(256, 1)): the accumulators, fragments and
// the products' partials take up to 255 registers, so the pipeline keeps
// few scalars live (the warp's slot and lane are taken from threadIdx where
// used, the chunk counts recomputed; held, they spilled). 32 x 32 warp
// tiles at two blocks an SM (32 channels a block, 128 registers) ran no
// faster and spilled (PERF.md §6).
//
// Invariants, as TbPipe's: a ragged last Cin chunk is zero-filled (x and w),
// so any Cin works; ragged Cout and T are masked by the epilogues; only t <
// T is read; any number of rows runs through one pipeline.
#pragma once

#include "conv3x3_tc.cuh"

namespace {

constexpr int kFtCc = 8;                          // input channels per K chunk: one k8 step per tap
constexpr int kFtXS = kTbT + 8;                   // words a staged (row, ci): t0 - 4 .. t0 + 67
constexpr int kFtXGroups = kFtXS / 4;             // 16-byte groups of a staged (row, ci)
constexpr int kFtXFrames = kTbT + 2;              // frames a conv row reads: t0 - 1 .. t0 + kTbT
constexpr int kFtXWords = kTbRows * kFtCc * kFtXS;        // one stage of x
constexpr int kFtWItems = 9 * 4 * 32;             // (tap, m16 tile, lane) A fragments a chunk
constexpr int kFtWWords = 4 * kFtWItems;          // one plane (hi or lo) of a chunk's weights
constexpr int kFtStage = kFtXWords + 2 * kFtWWords;       // words: x, w hi, w lo
constexpr int kFtWPer = (kFtWItems + kTcThreads - 1) / kTcThreads;   // items a thread stages
constexpr int kFtBP = kTbT + 8;                   // padded row of the float epilogue buffer

__host__ __device__ constexpr size_t ft_ring_bytes() { return 2 * sizeof(float) * kFtStage; }

// x of channels [c0, c0 + 8) and input rows f_row0 .. f_row0 + 5 into xs
// [row][ci][s] (frame t0 - 4 + s) by cp.async, zero outside the input and
// past Cin; vec: 16-byte copies of frames t0 - 4 .. t0 + 67 (T % 4 == 0, x
// aligned), else 4-byte copies of frames t0 - 1 .. t0 + kTbT.
static __device__ __forceinline__ void ft_stage_x(float* __restrict__ xs,
                                                  const float* __restrict__ xb, int f_row0,
                                                  int c0, int t0, int cin, int f_dim, int t_dim,
                                                  bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < kTbRows * kFtCc * kFtXGroups; e += kTcThreads) {
      const int g = e % kFtXGroups, rest = e / kFtXGroups;
      const int ci = c0 + rest % kFtCc, f = f_row0 + rest / kFtCc;
      const int t = t0 - 4 + 4 * g;
      const bool ok = f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin;
      cp_async16(xs + rest * kFtXS + 4 * g,
                 ok ? xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t : xb, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTbRows * kFtCc * kFtXFrames; e += kTcThreads) {
      const int s = e % kFtXFrames, rest = e / kFtXFrames;
      const int ci = c0 + rest % kFtCc, f = f_row0 + rest / kFtCc;
      const int t = t0 - 1 + s;
      const bool ok = f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin;
      cp_async4(xs + rest * kFtXS + s + 3,
                ok ? xb + (static_cast<size_t>(ci) * f_dim + f) * t_dim + t : xb, ok ? 4 : 0);
    }
  }
}

// This thread's weight items of the chunk at channel c0, by 4-byte
// cp.async into the stage's lo plane, where ft_split_w splits them: item e =
// threadIdx.x + 256 j is the A fragment of tap e / 128, m16 tile (e / 32) % 4
// and lane e % 32 (g = lane / 4, t = lane % 4), its four words a0 (m g, k
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) at e * 4, zero past K
// (cin) and M (cout). Forward (kT false): (tap, k, m) is w[tap][k][m] of w
// (3, 3, K, M). Transposed (kT true, dh): it is w[8 - tap][m][k] of w stored
// (3, 3, M, K), the flipped taps with the channels swapped.
template <bool kT>
static __device__ __forceinline__ void ft_load_w(uint32_t* __restrict__ w_hi,
                                                 const float* __restrict__ w, int c0, int co0,
                                                 int cin, int cout) {
  uint32_t* raw = w_hi + kFtWWords;
#pragma unroll
  for (int j = 0; j < kFtWPer; ++j) {
    const int e = threadIdx.x + j * kTcThreads;
    if (e >= kFtWItems) break;
    const int lane = e % 32, tap = e / 128;
    const int co = co0 + (e / 32) % 4 * 16 + lane / 4, ci = c0 + lane % 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = co + (r % 2) * 8, k = ci + (r / 2) * 4;
      const bool ok = k < cin && m < cout;
      const float* src = kT ? w + (static_cast<size_t>(8 - tap) * cout + m) * cin + k
                            : w + (static_cast<size_t>(tap) * cin + k) * cout + m;
      cp_async4(raw + 4 * e + r, ok ? src : w, ok ? 4 : 0);
    }
  }
}

// This thread's items of ft_load_w, once its copies have landed, split into
// the hi and lo planes (lo over the raw words): no other thread reads or
// writes them before the next barrier.
static __device__ __forceinline__ void ft_split_w(uint32_t* __restrict__ w_hi) {
  uint4* hi = reinterpret_cast<uint4*>(w_hi);
  uint4* lo = reinterpret_cast<uint4*>(w_hi + kFtWWords);
#pragma unroll
  for (int j = 0; j < kFtWPer; ++j) {
    const int e = threadIdx.x + j * kTcThreads;
    if (e >= kFtWItems) break;
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

// acc += one chunk on this warp's 64 x 32 tile of its conv row slot (warp w:
// slot w / 2, frames 32 (w % 2) ..) of the pass: nine taps, one k8 step
// each, in order. Per tap the four B fragments (b0 channel t, b1 channel t +
// 4, at frame n + dx - 1 of input row slot + dy) are split as read and feed
// all four A fragments (16-byte loads of the hi and lo planes). The tap loop
// stays rolled: unrolled, the compiler hoists the next taps' loads and
// spills at 255 registers (and ran 3% slower at stage 2, PERF.md).
static __device__ __forceinline__ void ft_mma_chunk(const float* __restrict__ xs,
                                                    const uint32_t* __restrict__ w_hi,
                                                    TbAcc& acc) {
  const int lane = threadIdx.x % 32, slot = threadIdx.x / 64, half = (threadIdx.x / 32) % 2;
  const float* xq = xs + (slot * kFtCc + lane % 4) * kFtXS + half * 8 * kTbNi + lane / 4 + 3;
  const uint4* a4 = reinterpret_cast<const uint4*>(w_hi) + lane;   // hi; lo kFtWItems on
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t bh[kTbNi][2], bl[kTbNi][2];
#pragma unroll
    for (int ni = 0; ni < kTbNi; ++ni) {
      const float* xb = xq + dy * kFtCc * kFtXS + ni * 8 + dx;
      split_tf32(xb[0], bh[ni][0], bl[ni][0]);
      split_tf32(xb[4 * kFtXS], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const uint4 h = a4[(tap * 4 + mi) * 32], l = a4[(tap * 4 + mi) * 32 + kFtWItems];
      const uint32_t a_hi[4] = {h.x, h.y, h.z, h.w}, a_lo[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni) mma_3xtf32_add(acc[mi][ni], a_hi, a_lo, bh[ni], bl[ni]);
    }
  }
}

// The float tile's pipeline over conv rows f_first .. f_first + n_rows - 1
// of the block's tile (outputs [co0, co0 + 64) x frames [t0, t0 + kTbT)), x
// (Cin, F, T) of one batch item: TbPipe's contract. The rows go in passes
// of 4: pass(acc) runs the next pass's chunks into acc, warp w computing row
// `row` = 4 p + w / 2 of pass p (if < n_rows) on frames t0 + 32 (w % 2) ..
// + 31, and returns false once every pass has run. One pipeline runs over
// every (pass, chunk): chunk i + 1 loads while chunk i multiplies, the next
// pass's first chunk during this pass's last. Every thread of the block must
// construct it and call pass() until it returns false. Each pass ends in a
// barrier, before its epilogue. kT: the weights as ft_load_w<kT> reads them
// (true: dh's transposed conv, x = gz with K its channels, M dh's).
template <bool kT>
struct FtPipe {
  float* smem;
  const float* xb;
  const float* w;
  int f_first, n_rows, co0, t0, cin, f_dim, t_dim, cout;
  int it, next_pass, row;
  bool xvec;

  __device__ __forceinline__ FtPipe(float* smem_, const float* xb_, const float* w_,
                                    int f_first_, int n_rows_, int co0_, int t0_, int cin_,
                                    int f_dim_, int t_dim_, int cout_)
      : smem(smem_), xb(xb_), w(w_), f_first(f_first_), n_rows(n_rows_), co0(co0_), t0(t0_),
        cin(cin_), f_dim(f_dim_), t_dim(t_dim_), cout(cout_) {
    xvec = t_dim % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
    it = 0;
    next_pass = 0;
    row = threadIdx.x / 64;
    ft_load_w<kT>(reinterpret_cast<uint32_t*>(smem + kFtXWords), w, 0, co0, cin, cout);
    ft_stage_x(smem, xb, f_first - 1, 0, t0, cin, f_dim, t_dim, xvec);
    cp_async_commit();
    cp_async_wait_all();
    ft_split_w(reinterpret_cast<uint32_t*>(smem + kFtXWords));
    __syncthreads();
  }

  __device__ __forceinline__ bool pass(TbAcc& acc) {
    const int n_chunks = ceil_div(cin, kFtCc);
    const int total = ceil_div(n_rows, kTbSlots) * n_chunks;
    if (it >= total) return false;
    row = next_pass * kTbSlots + threadIdx.x / 64;
    ++next_pass;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int chunk = 0; chunk < n_chunks; ++chunk, ++it) {
      const float* cur = smem + (it & 1) * kFtStage;
      float* nxt = smem + ((it + 1) & 1) * kFtStage;
      const bool more = it + 1 < total;
      const bool last = chunk + 1 == n_chunks;
      if (more) {   // the next (pass, chunk) by cp.async: weights raw, x
        const int nf = f_first + (last ? next_pass : next_pass - 1) * kTbSlots - 1;
        const int nc = (last ? 0 : chunk + 1) * kFtCc;
        ft_load_w<kT>(reinterpret_cast<uint32_t*>(nxt + kFtXWords), w, nc, co0, cin, cout);
        ft_stage_x(nxt, xb, nf, nc, t0, cin, f_dim, t_dim, xvec);
        cp_async_commit();
      }
      if (row < n_rows)   // warp-uniform
        ft_mma_chunk(cur, reinterpret_cast<const uint32_t*>(cur + kFtXWords), acc);
      if (more) {   // this thread's copies have landed: split its weights
        cp_async_wait_all();
        ft_split_w(reinterpret_cast<uint32_t*>(nxt + kFtXWords));
      }
      __syncthreads();   // nxt is complete; cur's readers are done
    }
    return true;
  }
};

}  // namespace
