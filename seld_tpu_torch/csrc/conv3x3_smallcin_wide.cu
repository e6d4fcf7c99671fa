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
// at the flagship's stage 1 (Cin 8, Cout 192, batch 2) that is
// arithmetic-bound in float32 (1.01 ms at 67 TFLOP/s; 0.41 ms as three TF32
// products at 495) and memory-bound on the bf16 tensor cores. The pack costs
// (3 kg / Cin) x the input bytes (kg 32: 12x at Cin 8; 161 MB against x's
// 39 MB at batch 2 in bf16, 321 MB in float32) and 3 kg / (9 Cin) x the
// operations (96 / 72 at Cin 8, which float32 does not pay: it skips the
// zero rows): the design's cost, not the function's.
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
// float32: smallcin_wide_tf32_kernel<ROWS>, the same block on the float
// tile of pool_gemm_tf32.cuh (split TF32: three m16n8k8 TF32 products a
// float32 product, each k8 step summed from zero, then added in float). It
// walks only the pack's non-zero rows, ROWS = 3 Cin rounded up to 8 of
// each kg group (24 of 32 at Cin 8: 72 of K 96; all 32 at Cin 10), as the
// wrapper passes them: the rows past 3 Cin are zero by the pack's contract
// and are never read. A = the block's [64][3 ROWS] weight columns, split
// once as they are staged into hi and lo planes of [64][3 ROWS + 4] words
// (4 mod 8: a fragment's 8 rows x 4 words hit 32 banks); B = the ROWS rows
// of each pack row, [ROWS][128 frames] floats in rows of 136 words (8 mod
// 32: a fragment's 4 k x 8 frames hit 32 banks), split as each warp reads
// them, through the four-slot cp.async ring of 16-byte copies of the bf16
// kernel (split once as each row landed, into a lo ring beside, it ran
// 1.25x slower at the flagship's stage 1: the ring's doubled shared memory
// leaves one block an SM). Shared memory: 89 KB at ROWS 24 (two blocks an
// SM), 118 KB at 32; 128 registers.
#include "pool_gemm_tf32.cuh"

namespace {

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

// ---- float32: the split-TF32 tile -------------------------------------------

constexpr int kWfXP = kPgT + 8;   // words per staged pack row (8 mod 32)

template <int ROWS>
__host__ __device__ constexpr int wide_tf32_wp() { return 3 * ROWS + 4; }   // 4 mod 8

template <int ROWS>
constexpr size_t wide_tf32_smem_bytes() {   // w hi and lo [64][kWP], then the ring
  return sizeof(float) * (2 * kPgCo * wide_tf32_wp<ROWS>() + kWdSlots * ROWS * kWfXP);
}

// grid: x Cout tile, y T tile, z b * (F / pf) + pooled row; p0's groups
// hold kg rows, of which the first ROWS are walked
template <int ROWS>
__global__ void __launch_bounds__(kPgThreads, 2)
smallcin_wide_tf32_kernel(const float* __restrict__ p0, const float* __restrict__ wk,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          float* __restrict__ out, int kg, int f_dim, int t_dim, int tpad,
                          int cout, int pf) {
  constexpr int kWP = wide_tf32_wp<ROWS>(), kRow = ROWS * kWfXP;   // words a weight row
  extern __shared__ __align__(16) unsigned char wf_smem[];
  uint32_t* w_hi = reinterpret_cast<uint32_t*>(wf_smem);   // [64][kWP]
  uint32_t* w_lo = w_hi + kPgCo * kWP;
  float* ring = reinterpret_cast<float*>(w_lo + kPgCo * kWP);   // [kWdSlots][ROWS][kWfXP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int co0 = blockIdx.x * kPgCo, t0 = blockIdx.y * kPgT;
  const int f_out = f_dim / pf, b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const float* rows = p0 + (static_cast<size_t>(b) * (f_dim + 2) + fo * pf) * kg * tpad;

  // the first ROWS rows of pack row i (of the window's pf + 2) into slot i %
  // kWdSlots: [ROWS][128] frames t0 .., zeros past tpad
  const auto load_row = [&](int i) {
    if (i < pf + 2) {
      float* dst = ring + (i % kWdSlots) * kRow;
      for (int e = threadIdx.x; e < ROWS * (kPgT / 4); e += kPgThreads) {
        const int k = e / (kPgT / 4), t = t0 + 4 * (e % (kPgT / 4));
        const bool ok = t < tpad;
        cp_async16(dst + k * kWfXP + t - t0,
                   ok ? rows + (static_cast<size_t>(i) * kg + k) * tpad + t : p0, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  load_row(0);
  load_row(1);
  load_row(2);
  // the weight columns dy * kg + j (j < ROWS) of the block's channels, split
  for (int e = threadIdx.x; e < kPgCo * 3 * ROWS; e += kPgThreads) {
    const int m = e / (3 * ROWS), c = e % (3 * ROWS), co = co0 + m;
    const float v = co < cout ? wk[static_cast<size_t>(co) * 3 * kg + (c / ROWS) * kg + c % ROWS]
                              : 0.f;
    split_tf32(v, w_hi[m * kWP + c], w_lo[m * kWP + c]);
  }

  PgAcc acc, best;
  pg_zero(best);
  for (int r = 0; r < pf; ++r) {
    cp_async_wait_group<0>();   // rows r .. r + 2 have landed
    __syncthreads();            // and every warp is done with row r - 1's slot
    load_row(r + 3);
    pg_zero(acc);
#pragma unroll (ROWS == 8 ? 1 : 3)   // unrolled at ROWS 8, it spilled
    for (int dy = 0; dy < 3; ++dy) {
      // B (k t, n g): frame warp_n * 32 + ni * 8 + g of pack row r + dy's row k
      const float* xr = ring + ((r + dy) % kWdSlots) * kRow + t4 * kWfXP + (warp % 4) * 32 + g;
#pragma unroll
      for (int ks = 0; ks < ROWS / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
        pgf_load_a<true>(w_hi, w_lo, kWP, dy * ROWS + 8 * ks, ah, al);
        float bv[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          bv[ni][0] = xr[8 * ks * kWfXP + ni * 8];
          bv[ni][1] = xr[(8 * ks + 4) * kWfXP + ni * 8];
        }
        pgf_mma(acc, ah, al, bv);
      }
    }
    PgAffine(scale, bias, co0, cout).fold(best, acc);
  }
  pgf_store(out, best, b, fo, f_out, co0, t0, cout, t_dim);
}

template <int ROWS>
cudaError_t launch_tf32(const void* p0, const void* wk, const float* scale, const float* bias,
                        void* out, int batch, int kg, int f_dim, int t_dim, int tpad, int cout,
                        int pf, cudaStream_t stream) {
  if (ROWS > kg || tpad % 4 || reinterpret_cast<uintptr_t>(p0) % 16)
    return cudaErrorInvalidValue;
  constexpr size_t smem = wide_tf32_smem_bytes<ROWS>();
  cudaError_t err = set_smem(smallcin_wide_tf32_kernel<ROWS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(cout, kPgCo), ceil_div(t_dim, kPgT), batch * (f_dim / pf));
  smallcin_wide_tf32_kernel<ROWS><<<grid, kPgThreads, smem, stream>>>(
      static_cast<const float*>(p0), static_cast<const float*>(wk), scale, bias,
      static_cast<float*>(out), kg, f_dim, t_dim, tpad, cout, pf);
  return cudaGetLastError();
}

}  // namespace

// p0 (B, F + 2, kg, tpad), wk (Cout, 3 kg); kg is 16 or 32. rows: the
// non-zero rows of each kg group, 3 Cin rounded up to 8 (float32 walks only
// those; bfloat16 walks all kg).
extern "C" int seld_conv3x3_smallcin_wide(const void* p0, const void* wk, const void* scale,
                                          const void* bias, void* out, int batch, int kg,
                                          int rows, int f_dim, int t_dim, int tpad, int cout,
                                          int pf, int dtype, void* stream) {
  if ((kg != 16 && kg != 32) || rows < 8 || rows > kg || rows % 8 || tpad <= t_dim)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  cudaError_t err;
  if (dtype == kF32) {
    const auto run = rows == 8    ? launch_tf32<8>
                     : rows == 16 ? launch_tf32<16>
                     : rows == 24 ? launch_tf32<24>
                                  : launch_tf32<32>;
    err = run(p0, wk, sc, bi, out, batch, kg, f_dim, t_dim, tpad, cout, pf, s);
  } else if (dtype == kBF16) {
    err = kg == 16 ? launch_tc<16>(p0, wk, sc, bi, out, batch, f_dim, t_dim, tpad, cout, pf, s)
                   : launch_tc<32>(p0, wk, sc, bi, out, batch, f_dim, t_dim, tpad, cout, pf, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
