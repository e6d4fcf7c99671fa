// K2w: the CNN-frontend stage through the wide pack, 3 * Cin <= 32.
//
// Replaces seld_tpu/ops/pallas/conv2d_pool.py:363
//   conv2d_smallcin_bn_relu_fpool (kernel body _smallcin_kernel_win, :240).
// Contract: p0 (B, F + 2, kg, tpad) and wk (Cout, 3 * kg) from the wrapper's
// pack (ops/kernels/conv2d_pool.py::smallcin_pack: row dx * Cin + c of a kg
// group is x[c] shifted by dx - 1 frames, the F halo rows and the zero
// padding already in place), scale/bias (Cout,) float -> out (B, Cout, F/pf,
// T) with out[b, co, fo, t] = max_r relu((wk @ p0[b, fo*pf + r : +3]
// flattened to (3 kg, tpad))[co, t] * scale + bias), for t < T.
//
// What bounds it on the H100: the function (a 3x3 conv of Cin channels) is
// 2 * 9 * Cin * Cout operations per output pixel against x + w + out bytes;
// at the flagship's stage 1 (Cin 8, Cout 192) that is arithmetic-bound in
// float32 SIMT and memory-bound on the bf16 tensor cores. The pack costs
// (3 kg / Cin) x the input bytes (kg 32: 12x at Cin 8; 161 MB against x's
// 39 MB at batch 2 in bf16) and 3 kg / (9 Cin) x the operations (96 / 72 at
// Cin 8): the design's cost, not the function's.
//
// bfloat16: smallcin_wide_tc_kernel, the GEMM tile of pool_gemm_tc.cuh (64
// channels x 128 frames, mma.sync.m16n8k16, float sums). A = the block's
// [64][3 kg] slice of wk, K-contiguous, staged once in shared memory and
// read by plain ldmatrix. B = the pack rows, [kg][128 frames] with
// frames contiguous, read by ldmatrix.trans out of a four-slot cp.async
// ring: conv row r reads rows r .. r + 2 while row r + 3 loads, one barrier
// a row, each of the pf + 2 rows read from device memory once per block.
// A conv row is 3 kg / 16 k16 steps (6 at kg 32, 3 at kg 16), folded into
// the running max. A block's Cout tiles of one pack tile are neighbours in
// the grid (x).
//
// float32: smallcin_wide_kernel, SIMT, TF32 off: one block per (b, pooled
// row, 64-channel Cout tile, 128-frame T tile), 256 threads, each holding a
// 4-channel x 8-frame float accumulator (the thread layout of
// conv3x3_common.cuh). The block stages wk's Cout slice once, transposed to
// [3 kg][64]; the pack's rows are staged into a ring of three [kg][128] row
// buffers, one new row per pool row. Per pool row one K = 3 kg product,
// then affine, ReLU and a running max.
#include "pool_gemm_tc.cuh"

namespace {

// Stage p0 row `row` (of the block's b) into its ring slot: [kg][kBT]
// frames [t0, t0 + kBT), zeros at frames >= tpad.
template <typename T>
static __device__ __forceinline__ void stage_pack_row(float* __restrict__ slot,
                                                      const T* __restrict__ src, int kg,
                                                      int t0, int tpad) {
  for (int e = threadIdx.x; e < kg * kBT; e += kThreads) {
    const int tl = e % kBT;
    const int k = e / kBT;
    const int t = t0 + tl;
    slot[e] = t < tpad ? to_f(src[static_cast<size_t>(k) * tpad + t]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
smallcin_wide_kernel(const T* __restrict__ p0, const T* __restrict__ wk,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     T* __restrict__ out, int kg, int f_dim, int t_dim, int tpad, int cout,
                     int pf) {
  extern __shared__ float smem[];
  const int kk = 3 * kg;
  float* ws = smem;                    // [3 kg][kBCO]
  float* xs = smem + kk * kBCO;        // ring: [3][kg][kBT]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // frame lane: frames t0 + tx + 16 j
  const int ty = tid / 16;   // channel lane: channels co0 + ty + 16 i
  const int t0 = blockIdx.x * kBT;
  const int co0 = blockIdx.y * kBCO;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;
  const size_t row_elems = static_cast<size_t>(kg) * tpad;
  const T* rows = p0 + (static_cast<size_t>(b) * (f_dim + 2) + fo * pf) * row_elems;

  for (int e = tid; e < kk * kBCO; e += kThreads) {
    const int col = e % kBCO;
    const int k = e / kBCO;
    const int co = co0 + col;
    ws[e] = co < cout ? to_f(wk[static_cast<size_t>(co) * kk + k]) : 0.f;
  }
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

  stage_pack_row(xs, rows, kg, t0, tpad);
  stage_pack_row(xs + kg * kBT, rows + row_elems, kg, t0, tpad);
  for (int r = 0; r < pf; ++r) {
    // row r + 2 takes the slot of row r - 1, which the previous step is done with
    stage_pack_row(xs + ((r + 2) % 3) * kg * kBT, rows + (r + 2) * row_elems, kg, t0, tpad);
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* xr = xs + ((r + dy) % 3) * kg * kBT + tx;
      const float* wr = ws + dy * kg * kBCO + ty;
#pragma unroll 4
      for (int k = 0; k < kg; ++k) {
        float w4[4], x8[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) w4[i] = wr[k * kBCO + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) x8[j] = xr[k * kBT + 16 * j];
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
    __syncthreads();   // every reader of row r's slot is done before it is refilled
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

// ---- bfloat16: the GEMM tile ------------------------------------------------

constexpr int kWdXP = kPgT + 8;   // padded k row of a staged pack row (17 16-byte units)
constexpr int kWdSlots = 4;       // pack rows in the ring: r .. r + 2 in use, r + 3 loading

template <int KG>
constexpr size_t wide_tc_smem_bytes() {   // wk slice [64][3 KG + 8], then the ring
  return sizeof(bf16) * (kPgCo * (3 * KG + 8) + kWdSlots * KG * kWdXP);
}

// grid: x Cout tile, y T tile, z b * (F / pf) + pooled row
template <int KG>
__global__ void __launch_bounds__(kPgThreads, 2)
smallcin_wide_tc_kernel(const bf16* __restrict__ p0, const bf16* __restrict__ wk,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        bf16* __restrict__ out, int f_dim, int t_dim, int tpad, int cout,
                        int pf) {
  constexpr int kK = 3 * KG, kWP = kK + 8, kRow = KG * kWdXP;
  extern __shared__ __align__(16) unsigned char wd_smem[];
  bf16* ws = reinterpret_cast<bf16*>(wd_smem);   // [64][kWP]
  bf16* ring = ws + kPgCo * kWP;                  // [kWdSlots][KG][kWdXP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int co0 = blockIdx.x * kPgCo, t0 = blockIdx.y * kPgT;
  const int f_out = f_dim / pf, b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const bf16* rows = p0 + (static_cast<size_t>(b) * (f_dim + 2) + fo * pf) * KG * tpad;

  // pack row i (of the window's pf + 2) into slot i % kWdSlots: [KG][128]
  // frames t0 .., zeros past tpad
  const auto load_row = [&](int i) {
    if (i < pf + 2) {
      bf16* dst = ring + (i % kWdSlots) * kRow;
      for (int e = threadIdx.x; e < KG * (kPgT / 8); e += kPgThreads) {
        const int k = e / (kPgT / 8), t = t0 + 8 * (e % (kPgT / 8));
        const bool ok = t < tpad;
        cp_async16(dst + k * kWdXP + t - t0,
                   ok ? rows + (static_cast<size_t>(i) * KG + k) * tpad + t : p0, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  for (int e = threadIdx.x; e < kPgCo * (kK / 8); e += kPgThreads) {
    const int m = e / (kK / 8), c = 8 * (e % (kK / 8));
    const bool ok = co0 + m < cout;
    cp_async16(ws + m * kWP + c, ok ? wk + static_cast<size_t>(co0 + m) * kK + c : wk,
               ok ? 16 : 0);
  }
  load_row(0);   // with the weights
  load_row(1);
  load_row(2);

  const PgAffine affine(scale, bias, co0, cout);
  PgAcc acc, best;
  pg_zero(best);
  const int q = lane / 8, r8 = lane % 8;
  // A fragments of k16 step st (dy * KG / 16 + kk) from [co][k], k contiguous
  const bf16* wa = ws + (warp_m * 32 + (q % 2) * 8 + r8) * kWP + (q / 2) * 8;
  for (int r = 0; r < pf; ++r) {
    cp_async_wait_group<0>();   // rows r .. r + 2 have landed
    __syncthreads();            // and every warp is done with row r - 1's slot
    load_row(r + 3);
    pg_zero(acc);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const bf16* xr = ring + ((r + dy) % kWdSlots) * kRow + warp_n * 32;
#pragma unroll
      for (int kk = 0; kk < KG / 16; ++kk) {
        uint32_t a[2][4], bb[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(wa + mi * 16 * kWP + (dy * (KG / 16) + kk) * 16, a[mi]);
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {   // B: [k][frame], frames contiguous
          uint32_t t4[4];
          ldsm_x4_t(xr + (kk * 16 + (q % 2) * 8 + r8) * kWdXP + dp * 16 + (q / 2) * 8, t4);
          bb[2 * dp][0] = t4[0];
          bb[2 * dp][1] = t4[1];
          bb[2 * dp + 1][0] = t4[2];
          bb[2 * dp + 1][1] = t4[3];
        }
        pg_mma(acc, a, bb);
      }
    }
    affine.fold(best, acc);
  }
  pg_store(out, best, b, fo, f_out, co0, t0, cout, t_dim);
}

template <int KG>
cudaError_t launch_tc(const void* p0, const void* wk, const float* scale, const float* bias,
                      void* out, int batch, int f_dim, int t_dim, int tpad, int cout, int pf,
                      cudaStream_t stream) {
  if (tpad % 8 || reinterpret_cast<uintptr_t>(p0) % 16 ||
      reinterpret_cast<uintptr_t>(wk) % 16)
    return cudaErrorInvalidValue;
  constexpr size_t smem = wide_tc_smem_bytes<KG>();
  cudaError_t err = set_smem(smallcin_wide_tc_kernel<KG>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(cout, kPgCo), ceil_div(t_dim, kPgT), batch * (f_dim / pf));
  smallcin_wide_tc_kernel<KG><<<grid, kPgThreads, smem, stream>>>(
      static_cast<const bf16*>(p0), static_cast<const bf16*>(wk), scale, bias,
      static_cast<bf16*>(out), f_dim, t_dim, tpad, cout, pf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* p0, const void* wk, const float* scale, const float* bias,
                   void* out, int batch, int kg, int f_dim, int t_dim, int tpad, int cout,
                   int pf, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * kg * (kBCO + kBT);
  cudaError_t err = set_smem(smallcin_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kBT), ceil_div(cout, kBCO), batch * (f_dim / pf));
  smallcin_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(p0), static_cast<const T*>(wk), scale, bias, static_cast<T*>(out),
      kg, f_dim, t_dim, tpad, cout, pf);
  return cudaGetLastError();
}

}  // namespace

// p0 (B, F + 2, kg, tpad), wk (Cout, 3 kg); kg is 16 or 32.
extern "C" int seld_conv3x3_smallcin_wide(const void* p0, const void* wk, const void* scale,
                                          const void* bias, void* out, int batch, int kg,
                                          int f_dim, int t_dim, int tpad, int cout, int pf,
                                          int dtype, void* stream) {
  if ((kg != 16 && kg != 32) || tpad <= t_dim) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float>(p0, wk, sc, bi, out, batch, kg, f_dim, t_dim, tpad, cout, pf, s);
  else if (dtype == kBF16)
    err = kg == 16 ? launch_tc<16>(p0, wk, sc, bi, out, batch, f_dim, t_dim, tpad, cout, pf, s)
                   : launch_tc<32>(p0, wk, sc, bi, out, batch, f_dim, t_dim, tpad, cout, pf, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
