// K10a: the CNN-frontend stage as one product over materialized patches.
//
// Replaces seld_tpu/ops/pallas/conv2d_pool.py:100
//   conv2d_im2col_bn_relu_fpool (kernel body _im2col_kernel, :90).
// Contract: patches (B, F, T, K) from the wrapper
// (ops/kernels/conv2d_pool.py::im2col_patches: column (dy * 3 + dx) * Cin + c
// is the zero-padded x[c, f + dy - 1, t + dx - 1], K = 9 Cin; in bfloat16
// zero columns pad K to a multiple of 8), w (K, Cout) (the (3, 3, Cin, Cout)
// weights as they lie; in bfloat16 (K, Cout rounded up to 8), zero past
// 9 Cin and Cout), scale/bias (Cout,) float -> out (B, Cout, F/pf, T) with
// out[b, co, fo, t] = max_r relu((patches[b, fo*pf + r, t, :] @ w)[co] *
// scale + bias). Any Cin and any T.
//
// What bounds it on the H100: the function is 2 * 9 * Cin * Cout operations
// per output pixel against x + w + out bytes (arithmetic-bound at the
// flagship's widths); the patches are 9x the input's bytes (354 MB at the
// flagship's stage 1 at batch 2 in bf16, 1.06 GB at stage 2), which the
// kernel reads once from device memory: the design's cost, not the
// function's (at stage 2 their bytes alone, written and read, outlast
// cuDNN's conv).
//
// bfloat16: im2col_tc_kernel, the GEMM tile of pool_gemm_tc.cuh (64
// channels x 128 frames, mma.sync.m16n8k16, float sums). The patches' rows
// are K-contiguous, which is mma's column-major B: a [128 frames][80 k]
// patch tile is read by plain ldmatrix, and the [80 k][64 channels] weight
// tile by ldmatrix.trans gives A = w^T. K is walked in 80-deep chunks (the
// last one short; 72, padded to 80, is one chunk) through a three-stage
// cp.async ring of 16-byte copies, one barrier a chunk; each pool row's chunks run in
// order into the same accumulators, folded into the running max after the
// last. A block's three Cout tiles of one patch tile are neighbours in the
// grid (x), so the patches come from device memory about once.
//
// The patches: im2col_patches_kernel (entry seld_im2col_patches), one pass
// that reads x once (each input row from device memory about once: the
// three blocks that read it are neighbours) and writes the patches K-padded
// with zero columns, in place of the torch passes (pad, permute, nine
// slices, cat) that took longer than the product at both flagship stages.
// A block takes 32 frames of one (b, f) row: per 64-channel chunk it stages
// rows f - 1 .. f + 1, frames t0 - 1 .. t0 + 32 transposed to [row][frame]
// [channel] (reads coalesced along the frames), then writes each frame's
// nine (tap, chunk) runs of the patch row as 16-byte vectors where Cin
// keeps them aligned, else element by element.
//
// float32: im2col_tf32_kernel, the same block on the float tile of
// pool_gemm_tf32.cuh (split TF32: three m16n8k8 TF32 products a float32
// product, each k8 step summed from zero, then added in float; stage 2's K
// 1728 is 216 such steps into the float accumulators). K = 9 Cin as it
// comes, walked in 32-deep chunks (four k8 steps; the last one short, its
// ragged k zero-filled) through a three-stage ring, one barrier a chunk, the
// (pool row, chunk) units in one loop, each pool row's chunks into the same
// accumulators as in bfloat16. A stage holds the [128 frames][32 k] patch
// tile in rows of 36 words (4 mod 8: a B fragment's 8 frames x 4 k hit 32
// banks), by 16-byte cp.async where K % 4 == 0 and the patches are aligned,
// else by 4-byte cp.async, and the [32 k][64 channels] weight tile split
// once into hi and lo planes of 72-word rows (8 mod 32): after a chunk's
// products each thread loads, splits and stores its 8 weights of the chunk
// two ahead. 108 KB of shared memory and 128 registers: two blocks an SM
// (the tile's accumulators and fragments take ~125 registers, so the loop
// keeps few scalars live: per-thread offsets are recomputed where used; at
// one block an SM, 152 registers, it ran 1.2-1.3x slower).
#include "pool_gemm_tf32.cuh"

namespace {

// ---- the patches ------------------------------------------------------------

constexpr int kPbT = 32;     // frames per block
constexpr int kPbC = 64;     // channels per staged chunk

// x (B, Cin, F, T) -> patches (B, F, T, k_pad): column (dy * 3 + dx) * Cin +
// c = x[c, f + dy - 1, t + dx - 1] (zero outside x), zeros from 9 Cin on.
// grid: x b * F + f, y frame tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
im2col_patches_kernel(const T* __restrict__ x, T* __restrict__ patches, int cin, int f_dim,
                      int t_dim, int k_pad) {
  constexpr int kVec = 16 / sizeof(T);   // elements of a 16-byte vector
  constexpr int kCP = kPbC + kVec;       // padded channel row, 16-byte aligned
  constexpr int kRows = kPbT + 2;        // frames t0 - 1 .. t0 + kPbT
  __shared__ __align__(16) unsigned char xs_raw[sizeof(T) * 3 * kRows * kCP];
  T* xs = reinterpret_cast<T*>(xs_raw);   // [dy][frame][channel]
  const int b = blockIdx.x / f_dim, f = blockIdx.x % f_dim;
  const int t0 = blockIdx.y * kPbT, nt = min(kPbT, t_dim - t0);
  T* prow = patches + (static_cast<size_t>(blockIdx.x) * t_dim + t0) * k_pad;
  const bool vec = cin % kVec == 0 && k_pad % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(patches) % 16 == 0;
  for (int c0 = 0; c0 < cin; c0 += kPbC) {
    const int cc = min(kPbC, cin - c0);
    if (c0 > 0) __syncthreads();   // the previous chunk's readers are done
    for (int e = threadIdx.x; e < 3 * cc * kRows; e += kThreads) {
      const int s = e % kRows, rest = e / kRows, c = rest % cc, dy = rest / cc;
      const int fr = f + dy - 1, t = t0 + s - 1;
      float v = 0.f;
      if (fr >= 0 && fr < f_dim && t >= 0 && t < t_dim)
        v = to_f(x[((static_cast<size_t>(b) * cin + c0 + c) * f_dim + fr) * t_dim + t]);
      store_f(xs + (dy * kRows + s) * kCP + c, v);
    }
    __syncthreads();
    if (vec) {
      const int nv = cc / kVec;   // vectors of one (frame, tap) run
      for (int e = threadIdx.x; e < nt * 9 * nv; e += kThreads) {
        const int j = e % nv, rest = e / nv, tap = rest % 9, tl = rest / 9;
        *reinterpret_cast<uint4*>(prow + static_cast<size_t>(tl) * k_pad + tap * cin + c0 +
                                  j * kVec) =
            *reinterpret_cast<const uint4*>(
                xs + ((tap / 3) * kRows + tl + tap % 3) * kCP + j * kVec);
      }
    } else {
      for (int e = threadIdx.x; e < nt * 9 * cc; e += kThreads) {
        const int c = e % cc, rest = e / cc, tap = rest % 9, tl = rest / 9;
        prow[static_cast<size_t>(tl) * k_pad + tap * cin + c0 + c] =
            xs[((tap / 3) * kRows + tl + tap % 3) * kCP + c];
      }
    }
  }
  const int tail = k_pad - 9 * cin;
  for (int e = threadIdx.x; e < nt * tail; e += kThreads)
    store_f(prow + static_cast<size_t>(e / tail) * k_pad + 9 * cin + e % tail, 0.f);
}

template <typename T>
cudaError_t launch_patches(const void* x, void* patches, int batch, int cin, int f_dim,
                           int t_dim, int k_pad, cudaStream_t stream) {
  if (k_pad < 9 * cin || ceil_div(t_dim, kPbT) > 65535) return cudaErrorInvalidValue;
  dim3 grid(batch * f_dim, ceil_div(t_dim, kPbT));
  im2col_patches_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(patches), cin, f_dim, t_dim, k_pad);
  return cudaGetLastError();
}

// ---- bfloat16: the GEMM tile ------------------------------------------------

constexpr int kIcK = 80;                 // K per ring stage: five k16 steps (stage 1's 72 in one)
constexpr int kIcBP = kIcK + 8;          // padded frame row of a patch tile (11 16-byte units)
constexpr int kIcWP = kPgCo + 8;         // padded k row of a weight tile
constexpr int kIcStages = 3;
constexpr int kIcStage = kPgT * kIcBP + kIcK * kIcWP;   // bf16 elements of one stage
constexpr size_t kIcSmem = sizeof(bf16) * kIcStages * kIcStage;

// grid: x Cout tile, y T tile, z b * (F / pf) + pooled row
__global__ void __launch_bounds__(kPgThreads, 2)
im2col_tc_kernel(const bf16* __restrict__ patches, const bf16* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 bf16* __restrict__ out, int k_dim, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char ic_smem[];
  bf16* ring = reinterpret_cast<bf16*>(ic_smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int co0 = blockIdx.x * kPgCo, t0 = blockIdx.y * kPgT;
  const int f_out = f_dim / pf, b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const int ld_w = (cout + 7) / 8 * 8;           // w's row: Cout rounded up to 8
  const int k16 = (k_dim + 15) / 16 * 16;        // K in whole k16 steps, zeros past k_dim
  const int n_chunks = ceil_div(k16, kIcK), units = pf * n_chunks;
  const bf16* rows = patches + (static_cast<size_t>(b) * f_dim + fo * pf) * t_dim * k_dim;

  // unit u: pool row u / n_chunks, K chunk u % n_chunks; one commit group each
  const auto load_unit = [&](int u) {
    if (u < units) {
      bf16* bs = ring + (u % kIcStages) * kIcStage;
      bf16* ws = bs + kPgT * kIcBP;
      const int k0 = (u % n_chunks) * kIcK;
      const bf16* prow = rows + static_cast<size_t>(u / n_chunks) * t_dim * k_dim;
      for (int e = threadIdx.x; e < kPgT * (kIcK / 8); e += kPgThreads) {
        const int tl = e / (kIcK / 8), k = k0 + 8 * (e % (kIcK / 8)), t = t0 + tl;
        const bool ok = t < t_dim && k < k_dim;
        cp_async16(bs + tl * kIcBP + k - k0,
                   ok ? prow + static_cast<size_t>(t) * k_dim + k : patches, ok ? 16 : 0);
      }
      for (int e = threadIdx.x; e < kIcK * (kPgCo / 8); e += kPgThreads) {
        const int kk = e / (kPgCo / 8), m = 8 * (e % (kPgCo / 8));
        const bool ok = k0 + kk < k_dim && co0 + m < ld_w;
        cp_async16(ws + kk * kIcWP + m, ok ? w + static_cast<size_t>(k0 + kk) * ld_w + co0 + m : w,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const PgAffine affine(scale, bias, co0, cout);
  PgAcc acc, best;
  pg_zero(best);
  const int q = lane / 8, r8 = lane % 8;
  load_unit(0);
  load_unit(1);
  for (int u = 0; u < units; ++u) {
    cp_async_wait_group<1>();   // unit u has landed
    __syncthreads();            // and every warp is done with unit u - 1's stage
    load_unit(u + 2);
    const int kc = u % n_chunks;
    if (kc == 0) pg_zero(acc);
    const bf16* bs = ring + (u % kIcStages) * kIcStage;
    const bf16* ws = bs + kPgT * kIcBP;
    const int steps = min(kIcK, k16 - kc * kIcK) / 16;
#pragma unroll
    for (int st = 0; st < kIcK / 16; ++st) {
      if (st >= steps) break;
      uint32_t a[2][4], bb[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)   // A = w^T: [k][co] read transposed
        ldsm_x4_t(ws + (st * 16 + (q / 2) * 8 + r8) * kIcWP + warp_m * 32 + mi * 16 +
                      (q % 2) * 8,
                  a[mi]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {   // B: [frame][k], k contiguous
        uint32_t t4[4];
        ldsm_x4(bs + (warp_n * 32 + np * 16 + (q / 2) * 8 + r8) * kIcBP + st * 16 + (q % 2) * 8,
                t4);
        bb[2 * np][0] = t4[0];
        bb[2 * np][1] = t4[1];
        bb[2 * np + 1][0] = t4[2];
        bb[2 * np + 1][1] = t4[3];
      }
      pg_mma(acc, a, bb);
    }
    if (kc == n_chunks - 1) affine.fold(best, acc);
  }
  pg_store(out, best, b, fo, f_out, co0, t0, cout, t_dim);
}

cudaError_t launch_tc(const void* patches, const void* w, const float* scale, const float* bias,
                      void* out, int batch, int k_dim, int f_dim, int t_dim, int cout, int pf,
                      cudaStream_t stream) {
  // 16-byte copies: K a multiple of 8 (the wrapper's zero columns), aligned rows
  if (k_dim % 8 || reinterpret_cast<uintptr_t>(patches) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(im2col_tc_kernel, kIcSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(cout, kPgCo), ceil_div(t_dim, kPgT), batch * (f_dim / pf));
  im2col_tc_kernel<<<grid, kPgThreads, kIcSmem, stream>>>(
      static_cast<const bf16*>(patches), static_cast<const bf16*>(w), scale, bias,
      static_cast<bf16*>(out), k_dim, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

// ---- float32: the split-TF32 tile -------------------------------------------

constexpr int kIfK = 32;                  // K per ring stage: four k8 steps
constexpr int kIfBP = kIfK + 4;           // words per staged patch row (4 mod 8)
constexpr int kIfWP = kPgCo + 8;          // words per staged weight k row (8 mod 32)
constexpr int kIfStages = 3;
constexpr int kIfWPer = kIfK * kPgCo / kPgThreads;          // weights a thread stages a chunk
constexpr int kIfStage = kPgT * kIfBP + 2 * kIfK * kIfWP;   // words: patches, w hi, w lo
constexpr size_t kIfSmem = sizeof(float) * kIfStages * kIfStage;

// grid: x Cout tile, y T tile, z b * (F / pf) + pooled row. kVec: 16-byte
// copies of the patch rows (K % 4 == 0, aligned patches), else 4-byte ones
template <bool kVec>
__global__ void __launch_bounds__(kPgThreads, 2)
im2col_tf32_kernel(const float* __restrict__ patches, const float* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ out, int k_dim, int f_dim, int t_dim, int cout, int pf) {
  constexpr int kPer = kVec ? kIfK / 4 : kIfK;   // copies of a frame's chunk
  constexpr int kCopyRows = kPgThreads / kPer;   // frames one pass of the block copies
  extern __shared__ __align__(16) unsigned char if_smem[];
  float* ring = reinterpret_cast<float*>(if_smem);
  // This thread's patch copies: frames t0 + tl + i * kCopyRows (i <
  // kPgT / kCopyRows) of a unit's rows, at k offset kk of its chunk; and
  // its weights: k rows kw + 4 i (i < kIfWPer) of a chunk, channel co. (Each
  // taken from threadIdx where it is used: held, they took the registers
  // that kept the tile from spilling at two blocks an SM.)
  const auto tl = [] { return static_cast<int>(threadIdx.x) / kPer; };
  const auto kk = [] { return (kVec ? 4 : 1) * static_cast<int>(threadIdx.x % kPer); };
  const auto t_first = [&] { return static_cast<int>(blockIdx.y) * kPgT + tl(); };

  // Units (pool row, K chunk) in order, into the stages in turn. The next
  // one to load: its first patch copy's source, its chunk's k and its
  // stage; its patch tile goes by cp.async, one commit group a unit, zeros
  // past T and K, and its weight tile split into its stage's planes, zeros
  // past K and Cout.
  const int f_out = f_dim / pf;
  const float* ld_src = patches + ((static_cast<size_t>(blockIdx.z / f_out) * f_dim +
                                    blockIdx.z % f_out * pf) * t_dim + t_first()) * k_dim + kk();
  int ld_k = 0, ld_stage = 0;
  const auto load_next = [&](bool any) {
    if (any) {
      float* dst = ring + ld_stage * kIfStage + tl() * kIfBP + kk();
#pragma unroll
      for (int i = 0; i < kPgT / kCopyRows; ++i) {
        const bool ok = t_first() + i * kCopyRows < t_dim && ld_k + kk() < k_dim;
        const float* from = ok ? ld_src + static_cast<size_t>(i * kCopyRows) * k_dim : patches;
        if constexpr (kVec)
          cp_async16(dst + i * kCopyRows * kIfBP, from, ok ? 16 : 0);
        else
          cp_async4(dst + i * kCopyRows * kIfBP, from, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  const auto put_w = [&]() {
    const int kw = threadIdx.x / kPgCo, co = blockIdx.x * kPgCo + threadIdx.x % kPgCo;
    float wv[kIfWPer];
#pragma unroll
    for (int i = 0; i < kIfWPer; ++i) {
      const int k = ld_k + kw + 4 * i;
      wv[i] = k < k_dim && co < cout ? __ldg(w + static_cast<size_t>(k) * cout + co) : 0.f;
    }
    uint32_t* hi = reinterpret_cast<uint32_t*>(ring + ld_stage * kIfStage + kPgT * kIfBP) +
                   kw * kIfWP + threadIdx.x % kPgCo;
#pragma unroll
    for (int i = 0; i < kIfWPer; ++i)
      split_tf32(wv[i], hi[4 * i * kIfWP], hi[kIfK * kIfWP + 4 * i * kIfWP]);
  };
  const auto advance = [&]() {
    ld_k += kIfK;
    ld_src += kIfK;
    if (ld_k >= k_dim) {   // the next pool row
      ld_src += static_cast<size_t>(t_dim) * k_dim - ld_k;
      ld_k = 0;
    }
    ld_stage = ld_stage == kIfStages - 1 ? 0 : ld_stage + 1;
  };

  int left = pf * ceil_div(k_dim, kIfK);   // units to multiply, the next one included
  load_next(true);   // units 0 and 1, their weights stored at once
  put_w();
  advance();
  load_next(left > 1);
  if (left > 1) put_w();
  advance();
  PgAcc acc, best;
  pg_zero(best);
  pg_zero(acc);
  for (int k0 = 0; left > 0; --left) {
    cp_async_wait_group<1>();   // this unit's patches have landed
    __syncthreads();            // its weights are stored; every warp is done with the last
    // this unit's stage: the one after the stage of the unit two ahead
    const float* bs = ring + (ld_stage == kIfStages - 1 ? 0 : ld_stage + 1) * kIfStage;
    load_next(left > 2);        // two units ahead, into the last unit's stage
    const uint32_t* w_hi = reinterpret_cast<const uint32_t*>(bs + kPgT * kIfBP);
    const uint32_t* w_lo = w_hi + kIfK * kIfWP;
    // B (k t, n g): frame warp_n * 32 + ni * 8 + g of the tile, k t of the step
    const float* xr = bs + (threadIdx.x / 32 % 4 * 32 + threadIdx.x % 32 / 4) * kIfBP +
                      threadIdx.x % 4;
    const int steps = min(kIfK, k_dim - k0 + 7) / 8;
#pragma unroll
    for (int st = 0; st < kIfK / 8; ++st) {
      if (st >= steps) break;
      uint32_t ah[2][4], al[2][4];
      pgf_load_a<false>(w_hi, w_lo, kIfWP, 8 * st, ah, al);
      float bv[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        bv[ni][0] = xr[ni * 8 * kIfBP + 8 * st];
        bv[ni][1] = xr[ni * 8 * kIfBP + 8 * st + 4];
      }
      pgf_mma(acc, ah, al, bv);
    }
    if (left > 2) put_w();      // the loaded unit's weights, its stage free since the barrier
    advance();
    k0 += kIfK;
    if (k0 >= k_dim) {   // the pool row's last chunk
      PgAffine(scale, bias, blockIdx.x * kPgCo, cout).fold(best, acc);
      pg_zero(acc);
      k0 = 0;
    }
  }
  pgf_store(out, best, blockIdx.z / f_out, blockIdx.z % f_out, f_out, blockIdx.x * kPgCo,
            blockIdx.y * kPgT, cout, t_dim);
}

cudaError_t launch_tf32(const void* patches, const void* w, const float* scale,
                        const float* bias, void* out, int batch, int k_dim, int f_dim, int t_dim,
                        int cout, int pf, cudaStream_t stream) {
  const bool vec = k_dim % 4 == 0 && reinterpret_cast<uintptr_t>(patches) % 16 == 0;
  const auto kernel = vec ? im2col_tf32_kernel<true> : im2col_tf32_kernel<false>;
  cudaError_t err = set_smem(kernel, kIfSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(cout, kPgCo), ceil_div(t_dim, kPgT), batch * (f_dim / pf));
  kernel<<<grid, kPgThreads, kIfSmem, stream>>>(
      static_cast<const float*>(patches), static_cast<const float*>(w), scale, bias,
      static_cast<float*>(out), k_dim, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

}  // namespace

// patches (B, F, T, K), w (K, Cout); bfloat16: K % 8 == 0 and w (K, Cout
// rounded up to 8).
extern "C" int seld_conv3x3_im2col(const void* patches, const void* w, const void* scale,
                                   const void* bias, void* out, int batch, int k_dim, int f_dim,
                                   int t_dim, int cout, int pf, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == kF32)
    err = launch_tf32(patches, w, sc, bi, out, batch, k_dim, f_dim, t_dim, cout, pf, s);
  else if (dtype == kBF16)
    err = launch_tc(patches, w, sc, bi, out, batch, k_dim, f_dim, t_dim, cout, pf, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// x (B, Cin, F, T) -> patches (B, F, T, k_pad), k_pad >= 9 Cin.
extern "C" int seld_im2col_patches(const void* x, void* patches, int batch, int cin, int f_dim,
                                   int t_dim, int k_pad, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = launch_patches<float>(x, patches, batch, cin, f_dim, t_dim, k_pad, s);
  else if (dtype == kBF16)
    err = launch_patches<__nv_bfloat16>(x, patches, batch, cin, f_dim, t_dim, k_pad, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
