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
// float32: im2col_kernel, SIMT, TF32 off: one block per (b, pooled row,
// 64-channel Cout tile, 128-frame T tile), 256 threads, each holding a
// 4-channel x 8-frame float accumulator. K is walked in chunks of 32: each
// chunk stages a [32][128] patch tile, read as 32 consecutive columns per
// frame (coalesced) and stored transposed with a padded row (no bank
// conflicts), and the [32][64] weight slice; the ragged last chunk is
// zero-filled. Pool rows are computed one after another into the same
// accumulator and folded into a running max after the affine and ReLU.
#include "pool_gemm_tc.cuh"

namespace {

constexpr int kKC = 32;          // K per shared-memory chunk
constexpr int kXS = kBT + 1;     // padded row of the transposed patch tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const T* __restrict__ patches, const T* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ out, int k_dim, int f_dim, int t_dim, int cout, int pf) {
  __shared__ float xs[kKC * kXS];     // [k][t]
  __shared__ float ws[kKC * kBCO];    // [k][co]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // frame lane: frames t0 + tx + 16 j
  const int ty = tid / 16;   // channel lane: channels co0 + ty + 16 i
  const int t0 = blockIdx.x * kBT;
  const int co0 = blockIdx.y * kBCO;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;

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

  for (int r = 0; r < pf; ++r) {
    const T* prow = patches + (static_cast<size_t>(b) * f_dim + fo * pf + r) * t_dim * k_dim;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += kKC) {
      __syncthreads();   // the previous chunk's readers are done
      for (int e = tid; e < kKC * kBT; e += kThreads) {
        const int k = e % kKC;
        const int tl = e / kKC;
        const int t = t0 + tl;
        xs[k * kXS + tl] = (t < t_dim && k0 + k < k_dim)
                               ? to_f(prow[static_cast<size_t>(t) * k_dim + k0 + k])
                               : 0.f;
      }
      for (int e = tid; e < kKC * kBCO; e += kThreads) {
        const int col = e % kBCO;
        const int k = e / kBCO;
        const int co = co0 + col;
        ws[e] = (k0 + k < k_dim && co < cout)
                    ? to_f(w[static_cast<size_t>(k0 + k) * cout + co])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float w4[4], x8[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) w4[i] = ws[k * kBCO + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) x8[j] = xs[k * kXS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(w4[i], x8[j], acc[i][j]);
      }
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

template <typename T>
cudaError_t launch(const void* patches, const void* w, const float* scale, const float* bias,
                   void* out, int batch, int k_dim, int f_dim, int t_dim, int cout, int pf,
                   cudaStream_t stream) {
  dim3 grid(ceil_div(t_dim, kBT), ceil_div(cout, kBCO), batch * (f_dim / pf));
  im2col_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(patches), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(out), k_dim, f_dim, t_dim, cout, pf);
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
    err = launch<float>(patches, w, sc, bi, out, batch, k_dim, f_dim, t_dim, cout, pf, s);
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
