// Train-mode CNN stage 1: 3x3 conv (Cin <= 10, zero pad 1) -> BatchNorm with
// batch statistics -> ReLU -> max over `pf` frequency rows, with the
// backward for the weights and the BN affine (stage 1's input is data, so
// there is no dx).
//
// Replaces seld_tpu/ops/pallas/conv2d_train.py::
// conv2d_smallcin_bn_relu_fpool_train: its passes _stats_kernel (F1),
// _sel_stats_kernel (B1) and _bwd_dw_kernel (B2); the forward pass F2 is a
// serving kernel fed the batch-statistics affine. Layout: x (B, Cin, F, T),
// w (3, 3, Cin, Cout), out and its cotangent g (B, Cout, F/pf, T); every
// pass reads only t < T. B2 routes g by recomputing the conv rows that F2
// pooled, so F1, F2 and B2 run one K walk per dtype and get its rows bit
// for bit:
//
// float32 (split TF32 on the tensor cores): the float smallcin tile of
// conv3x3_smallcin_tf32.cuh, whose row function scf_window (CC = 8 staged
// channels for Cin <= 8, 16 for Cin 9-10, zero-filled past Cin; the
// window's rows staged in chunks, so any pf <= 255 runs) serves all three;
// its rows are also the float block tile's (K10b's) bit for bit.
// - F1  seld_conv3x3_train_stats (train_stats_tf32_kernel): per-channel sum
//       and sum of squares of the conv over (B, F, T).
// - F2  K2's seld_conv3x3_smallcin (smallcin_tf32_kernel,
//       conv3x3_bn_relu_fpool.cu).
// - B2  split as bfloat16's and K9's: seld_conv3x3_train_gz
//       (train_gz_tf32_kernel), one recompute of each pool row's conv on F1's
//       and F2's rows that routes g to the FIRST row holding the max (a strict
//       > running argmax, reduce_window's first-match rule) where that max
//       is > 0, writes g_z = g_pre * scale - acc * A - Bc in float32 (the
//       batch-stats BN backward scale * (g_pre - S_g/N - xhat * S_gx/N) with
//       A = inv * scale * S_gx/N, Bc = scale * S_g/N - mean * A: the
//       subtraction happens before the dW product) and the exact routed sums
//       S_g and sum g_pre * acc, from which the caller forms dgamma and
//       dbeta; then seld_conv3x3_train_dw_tc, dW[dy][dx][ci][co] = sum g_z *
//       x on the split-TF32 dW tile of conv3x3_dw_tf32.cuh (CI 8 with the
//       dx taps stacked in M for Cin <= 8, CI 16 for Cin 9-10).
// bfloat16 (mma.sync.m16n8k16, bf16 operands, float accumulators): the
// tiles of conv3x3_tc.cuh, Cin <= 16 in one zero-filled 16-channel chunk,
// on one K walk (so their conv rows are bitwise alike).
// - F1  seld_conv3x3_train_stats (train_stats_tc_kernel, the block tile
//       TbPipe): the same sums, no pre written (float pre would be
//       1.9 GB at batch 2).
// - F2  K3's tile through K10b's entry seld_conv3x3_windows.
// - B2  the same split: seld_conv3x3_train_gz (train_gz_tc_kernel), one
//       recompute on the row tile conv_rows_tc that writes g_z in bf16 with
//       the same routing and the exact routed sums, then
//       seld_conv3x3_train_dw_tc, the dW GEMM over the frames of
//       conv3x3_dw_tc.cuh with a 16-channel Cin tile.
// - B1  seld_conv3x3_train_sel_stats (both dtypes): S_g = sum g and S_gx =
//       sum g * xhat over the positions where out > 0, from (out, g) alone:
//       there the pool-selected pre-activation equals out, so xhat = out * p
//       - q with p = inv / scale, q = (bias / scale + mean) * inv (0 where
//       scale == 0).
// Every pass writes one row of per-block partial sums; launch_reduce
// (conv3x3_common.cuh) sums the rows in a fixed order (double
// accumulators), so a run repeats bitwise (no float atomics).
//
// What bounds it on the H100. Each conv is 2 * 9 * Cin * Cout operations
// per conv pixel (68 GFLOP at Cin 8 for a flagship stage 1 at batch 2: 0.07
// ms on the bf16 tensor cores, 1.0 ms at float32's 67 TFLOP/s, 0.41 ms as
// three TF32 products at 495). B2 moves g_z (B, Cout, F, T) through memory:
// 944 MB in bf16 and 1.89 GB in float32 at batch 2, written once by the g_z
// pass and read once by dW (0.28 ms each in bf16, 0.56 in float32, at 3.35
// TB/s). So float32's g_z pass is bound by g_z's bytes (0.56 ms) beside its
// recompute's three TF32 products (0.41 ms). The g_z passes keep each
// window's running best conv value and row in registers (one recompute);
// the float32 pass stages the window's last rows that fit beside the halo
// (each warp its own), and writes the earlier ones' off-route g_z, -acc * A
// - Bc, as it is computed, rewriting their routed elements at the window's
// end. The dW tiles read x and g_z once per 64-frame depth step.
#include "conv3x3_dw_tc.cuh"
#include "conv3x3_dw_tf32.cuh"
#include "conv3x3_smallcin_tf32.cuh"
#include "conv3x3_tc.cuh"

namespace {

// F1 in float32: the float smallcin tile's rows (scf_window, the rows K2's
// float32 kernel pools as F2), their per-channel sum and sum of squares over
// t < T in a fixed order; one partial row per block. A block walks
// tiles_per_block frame tiles of one pool window and one Cout tile.
template <int CC>
__global__ void __launch_bounds__(kScfThreads, 2)
train_stats_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ partials, int cin, int f_dim, int t_dim, int cout,
                        int pf, int chunk, int tiles_per_block) {
  extern __shared__ __align__(16) float scf_smem[];
  uint32_t* w_hi = reinterpret_cast<uint32_t*>(scf_smem);
  float* xs = scf_smem + 2 * scf_w_words<CC>() + kScfCols;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const float* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;
  const bool vec = t_dim % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;

  float s1[4][2] = {}, s2[4][2] = {};
  scf_load_w<CC>(w_hi, w, co0, cin, cout);
  bool split_w = true;
  for (int tile = 0; tile < tiles_per_block; ++tile) {
    const int t0 = (blockIdx.x * tiles_per_block + tile) * kScfT;
    if (t0 >= t_dim) break;
    scf_window<CC, 1>(xs, w_hi, xb, fo * pf, pf, chunk, t0, cin, f_dim, t_dim, vec, split_w,
                      [&](int, int, const TbAcc& acc) {
#pragma unroll
                     for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                       for (int h = 0; h < 2; ++h)
#pragma unroll
                         for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
                           for (int e2 = 0; e2 < 2; ++e2) {
                             const float v = acc[mi][ni][2 * h + e2];
                             if (t0 + scf_n(ni, e2) < t_dim) {
                               s1[mi][h] += v;
                               s2[mi][h] = fmaf(v, v, s2[mi][h]);
                             }
                           }
                   });
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  scf_channel_sums(xs, s1, s2, co0, cout, row);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sel_stats_kernel(const T* __restrict__ out, const T* __restrict__ g,
                 const float* __restrict__ p_col, const float* __restrict__ q_col,
                 float* __restrict__ partials, int cout, int f_out, int t_dim) {
  __shared__ float red[2][kThreads];
  const int co = blockIdx.x;
  const int b = blockIdx.y / f_out, fo = blockIdx.y % f_out;
  const size_t base = ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
  const float p = p_col[co], q = q_col[co];
  float sg = 0.f, sgx = 0.f;
  for (int t = threadIdx.x; t < t_dim; t += kThreads) {
    const float o = to_f(out[base + t]);
    if (o > 0.f) {
      const float gv = to_f(g[base + t]);
      sg += gv;
      sgx = fmaf(gv, __fsub_rn(__fmul_rn(o, p), q), sgx);
    }
  }
  red[0][threadIdx.x] = sg;
  red[1][threadIdx.x] = sgx;
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
    }
  }
  if (threadIdx.x == 0) {
    float* row = partials + static_cast<size_t>(blockIdx.y) * 2 * cout;
    row[co] = red[0][0];
    row[cout + co] = red[1][0];
  }
}

// The float32 g_z pass stages at most this many of a window's last rows in
// shared memory (each warp its own 64 channels x 32 frames of a row); the
// launch stages as many as fit beside the halo at two blocks an SM.
constexpr int kGzF32MaxStageRows = 8;
// The g_z pass takes each row's K walk in parts of the 64 channels, two of
// 32 (four of 16 at 16 staged channels, whose two K chunks take more
// registers): beside its running max and rows, a whole 64 x 32 tile's
// accumulators spilled (164-244 bytes; two parts at CC 16 still 4).
template <int CC>
__host__ __device__ constexpr int gz_parts() { return CC == 8 ? 2 : 4; }
constexpr size_t kTwoBlockSmem = 115712;   // shared memory a block may use at two blocks an SM

// A staged g_z element of a warp's row (channel m, frame n of the warp's 32):
// the frames rotated by 8 (m % 4), so a warp's fragment-order float2 stores
// and its 16-byte reads of 4 frames both land on 32 banks.
static __device__ __forceinline__ int gz_swz(int m, int n) {
  return m * 32 + ((n + 8 * (m % 4)) & 31);
}

// B2's g_z pass in float32 on the float smallcin tile: one recompute of the
// window's rows on scf_window, F1's and F2's rows bit for bit. Each row's
// g_z is first formed as if off the route, -acc * A - Bc (one fma), while
// each element keeps its window's running first max in registers (strict >
// on the relu values, recomputed from the kept conv value; row 0 taken as
// it is, so a NaN there stays and routes nothing): its conv value and its
// row, one byte per element. At the window's end the tile's g is loaded in
// bulk, then routed where the max is > 0: the element becomes g * scale -
// acc * A - Bc and the exact routed sums S_g and sum g_pre * acc are taken.
// The window's last `stage_rows` rows wait in shared memory, take their
// routed elements there and leave in 16-byte stores; its earlier rows are
// stored as they are computed (float2 stores along the frames) and their
// routed elements rewritten in place. gz (B, Cout, F, T) float; one partial
// row [S_g | sum g_pre * acc] per block.
template <int CC>
__global__ void __launch_bounds__(kScfThreads, 2)
train_gz_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ a_col, const float* __restrict__ b_col,
                     const float* __restrict__ g, float* __restrict__ gz,
                     float* __restrict__ partials, int cin, int f_dim, int t_dim, int cout, int pf,
                     int chunk, int tiles_per_block, int stage_rows) {
  extern __shared__ __align__(16) float scf_smem[];
  uint32_t* w_hi = reinterpret_cast<uint32_t*>(scf_smem);
  float4* cols = reinterpret_cast<float4*>(scf_smem + 2 * scf_w_words<CC>());
  float* xs = scf_smem + 2 * scf_w_words<CC>() + kScfCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // [stage_rows][4 warps][64][32], swizzled: this warp's rows
  float* zw = xs + (min(pf, chunk) + 2) * CC * kScfXS + warp * kScfZRow;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const int r_staged = pf - stage_rows;      // the first staged row
  const float* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;   // one channel of gz
  float* gzb = gz + static_cast<size_t>(b) * cout * plane + static_cast<size_t>(fo) * pf * t_dim;
  const float* gb = g + (static_cast<size_t>(b) * cout * f_out + fo) * t_dim;
  const bool vec = t_dim % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  const bool zvec = t_dim % 4 == 0 && reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const bool pairs = t_dim % 2 == 0 && reinterpret_cast<uintptr_t>(gz) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 8 == 0;

  float sg[4][2] = {}, sga[4][2] = {};
  scf_load_w<CC>(w_hi, w, co0, cin, cout);
  scf_stage_cols(cols, scale, bias, a_col, b_col, co0, cout);
  bool split_w = true;
  for (int tile = 0; tile < tiles_per_block; ++tile) {
    const int t0 = (blockIdx.x * tiles_per_block + tile) * kScfT;
    if (t0 >= t_dim) break;
    float best[4][kTbNi][4];   // each window's running first max: its conv value
    uint32_t sel[4][kTbNi];    // and its row, byte e of sel[mi][ni]
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni) {
        sel[mi][ni] = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) best[mi][ni][e] = 0.f;
      }
    constexpr int kGzParts = gz_parts<CC>();
    scf_window<CC, kGzParts>(
        xs, w_hi, xb, fo * pf, pf, chunk, t0, cin, f_dim, t_dim, vec, split_w,
        [&](int r, int part, const float (&acc)[4 / kGzParts][kTbNi][4]) {
          const bool staged = r >= r_staged;
          float* zr = zw + max(r - r_staged, 0) * 4 * kScfZRow;
#pragma unroll
          for (int i = 0; i < 4 / kGzParts; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int mi = part * (4 / kGzParts) + i;
              const int m = scf_m(mi, 2 * h), co = co0 + m;
              const float4 c = cols[m];
              float* zrow = gzb + min(co, cout - 1) * plane + static_cast<size_t>(r) * t_dim;
#pragma unroll
              for (int ni = 0; ni < kTbNi; ++ni) {
                const float v0 = acc[i][ni][2 * h], v1 = acc[i][ni][2 * h + 1];
                const float z0 = fmaf(-v0, c.z, -c.w), z1 = fmaf(-v1, c.z, -c.w);
                const int n = scf_n(ni, 0), t = t0 + n;
                if (staged) {
                  *reinterpret_cast<float2*>(zr + gz_swz(m, n % 32)) = make_float2(z0, z1);
                } else if (co < cout) {
                  if (pairs && t + 1 < t_dim) {
                    *reinterpret_cast<float2*>(zrow + t) = make_float2(z0, z1);
                  } else {
                    if (t < t_dim) zrow[t] = z0;
                    if (t + 1 < t_dim) zrow[t + 1] = z1;
                  }
                }
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2) {
                  const int e = 2 * h + e2;
                  const float v = acc[i][ni][e];
                  if (r == 0 || bn_relu(v, c.x, c.y) > bn_relu(best[mi][ni][e], c.x, c.y)) {
                    best[mi][ni][e] = v;
                    sel[mi][ni] = (sel[mi][ni] & ~(0xffu << (8 * e))) |
                                  (static_cast<uint32_t>(r) << (8 * e));
                  }
                }
              }
            }
        });
    // the window's end: the tile's g, every load in flight at once, then g
    // to the first max where that max is > 0
    float gv[4][kTbNi][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + scf_m(mi, 2 * h);
        const float* grow = gb + static_cast<size_t>(min(co, cout - 1)) * f_out * t_dim;
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          const int t = t0 + scf_n(ni, 0);
          float2 v = make_float2(0.f, 0.f);
          if (pairs && t + 1 < t_dim) {
            v = *reinterpret_cast<const float2*>(grow + t);
          } else {
            if (t < t_dim) v.x = grow[t];
            if (t + 1 < t_dim) v.y = grow[t + 1];
          }
          gv[mi][ni][2 * h] = v.x;
          gv[mi][ni][2 * h + 1] = v.y;
        }
      }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = scf_m(mi, 2 * h), co = co0 + m;
        if (co >= cout) continue;
        const float4 c = cols[m];
        float* zc = gzb + co * plane;
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int e = 2 * h + e2;
            const int n = scf_n(ni, e2), t = t0 + n;
            const float v = best[mi][ni][e];
            if (t >= t_dim || !(bn_relu(v, c.x, c.y) > 0.f)) continue;
            const float gp = gv[mi][ni][e];
            sg[mi][h] += gp;
            sga[mi][h] = fmaf(gp, v, sga[mi][h]);
            const int r = (sel[mi][ni] >> (8 * e)) & 0xff;
            const float z = gp * c.x - v * c.z - c.w;
            if (r >= r_staged)
              zw[(r - r_staged) * 4 * kScfZRow + gz_swz(m, n % 32)] = z;
            else
              zc[static_cast<size_t>(r) * t_dim + t] = z;
          }
      }
    // the staged rows out: each warp its own, 16-byte stores along the frames
    __syncwarp();
    for (int e = lane; e < stage_rows * kTcCo * 8; e += 32) {
      const int u = e % 8, rm = e / 8;   // rm = staged row * 64 + m
      const int m = rm % kTcCo, co = co0 + m, t = t0 + warp * 32 + 4 * u;
      if (co >= cout || t >= t_dim) continue;
      const float* src = zw + (rm / kTcCo) * 4 * kScfZRow + gz_swz(m, 4 * u);
      float* dst = gzb + co * plane + static_cast<size_t>(r_staged + rm / kTcCo) * t_dim + t;
      if (zvec) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int k = 0; k < 4 && t + k < t_dim; ++k) dst[k] = src[k];
      }
    }
    __syncwarp();   // this warp's staged rows are free for the next tile
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  scf_channel_sums(xs, sg, sga, co0, cout, row);
}

// ---- bfloat16: F1 and B2's g_z pass on the conv tile of conv3x3_tc.cuh ----

// F1 in bfloat16: the conv rows of K3's block tile (TbPipe over the
// block's tb_block_rows(pf) rows and tiles_per_block 128-frame tiles;
// Cin <= 16 is one zero-filled 16-channel chunk), summed per channel in a
// fixed order; no pre is written.
__global__ void __launch_bounds__(kTcThreads, 1)
train_stats_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      float* __restrict__ partials, int cin, int f_dim, int t_dim, int cout,
                      int pf, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* red = reinterpret_cast<float*>(tc_smem + tb_ring_bytes<false>());
  const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2;
  const int co0 = blockIdx.y * kTcCo;
  const int rows = tb_block_rows(pf);
  const int blocks_f = ceil_div(f_dim, rows);
  const int b = blockIdx.z / blocks_f, f_first = (blockIdx.z % blocks_f) * rows;
  const bf16* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  tb_zero_sums(red);
  const int tiles = tiles_per_block * (kBT / kTbT);   // the grid counts kBT-frame tiles
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = (blockIdx.x * tiles + tile) * kTbT;
    if (t0 >= t_dim) break;
    const int n_rows = min(rows, f_dim - f_first);
    TbPipe<false> pipe(reinterpret_cast<bf16*>(tc_smem), xb, w, f_first, n_rows, co0, t0, cin,
                       f_dim, t_dim, cout);
    TbAcc acc;
    while (pipe.pass(acc)) {
      if (pipe.row >= n_rows) continue;
      float s1[4][2] = {}, s2[4][2] = {};
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int ni = 0; ni < kTbNi; ++ni)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float v = acc[mi][ni][2 * hh + e2];
              if (t0 + tb_n(half, lane, ni, e2) < t_dim) {
                s1[mi][hh] += v;
                s2[mi][hh] = fmaf(v, v, s2[mi][hh]);
              }
            }
      tb_add_sums(red, s1, s2);
    }
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  tb_channel_sums(red, co0, cout, row);
}

// (t, t + 1) of a bf16 row; one 4-byte store where the row allows it.
static __device__ __forceinline__ void store_pair(bf16* __restrict__ row, int t, int t_dim,
                                                  bool pairs, float v0, float v1) {
  if (pairs && t + 1 < t_dim) {
    *reinterpret_cast<__nv_bfloat162*>(row + t) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (t < t_dim) row[t] = __float2bfloat16(v0);
    if (t + 1 < t_dim) row[t + 1] = __float2bfloat16(v1);
  }
}

constexpr int kGzStageRows = 8;           // the largest pool window staged in shared memory
constexpr int kGzZP = kTcT + 8;           // padded staged g_z row: 136 bf16 (68 words: 4 mod 32)
constexpr int kGzRowElems = kTcCo * kGzZP;   // one conv row of the block's tile

// Shared memory of the g_z pass: the conv tile's ring, then (kStaged) the
// pool window's g_z rows.
template <bool kStaged>
constexpr size_t gz_smem_bytes() {
  return tc_smem_bytes<false>() + (kStaged ? sizeof(bf16) * kGzStageRows * kGzRowElems : 0);
}

// B2's g_z pass in bfloat16: one recompute of the pool rows on the same tile
// as F1 and F2 (so its rows are theirs bit for bit). Each row's g_z is first
// formed as if off the route, -acc * A - Bc (one fma), while each element
// keeps its window's running first max (strict >: its relu value, conv
// value and row) in registers; at the window's end, where that max is > 0,
// g is routed to it: its g_z becomes g * scale - acc * A - Bc and the exact
// routed sums S_g and sum g_pre * acc are taken. kStaged (pf <= 8, the
// shipped configs' pool): the window's rows wait in shared memory, take the
// routed values there, and leave in 16-byte coalesced stores; else each row
// is stored at once and the routed values are rewritten in place (2-byte
// stores scattered over the window's rows). The staged instance is kept for
// its speed: at stage 1 (pf 8) it took 1.96 ms against the direct one's 2.68
// on an H100 80GB at 700 W (python -m seld_tpu_torch.ab_variants --sections
// train; PERF.md). gz (B, Cout, F, T) in bf16; one
// partial row [S_g | sum g_pre * acc] per block. One block per SM (255
// registers): the running max, the four per-channel columns and the tile's
// pipeline do not fit 128 without spills.
template <bool kStaged>
__global__ void __launch_bounds__(kTcThreads, 1)
train_gz_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ a_col, const float* __restrict__ b_col,
                   const bf16* __restrict__ g, bf16* __restrict__ gz,
                   float* __restrict__ partials, int cin, int f_dim, int t_dim, int cout,
                   int pf, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* zs = reinterpret_cast<bf16*>(tc_smem + tc_smem_bytes<false>());   // [pf][64][kGzZP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out, fo = blockIdx.z % f_out;
  const bf16* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;   // one channel of gz
  bf16* gzb = gz + static_cast<size_t>(b) * cout * plane + static_cast<size_t>(fo) * pf * t_dim;
  const bool pairs = t_dim % 2 == 0 && reinterpret_cast<uintptr_t>(gz) % 4 == 0;
  const bool vec = t_dim % 8 == 0 && reinterpret_cast<uintptr_t>(gz) % 16 == 0;

  // this thread's channels (clamped: the padding channels' rows are dropped)
  int co[2][2];
  float sc[2][2], bi[2][2], ac[2][2], bc[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      co[mi][hh] = co0 + tc_m(warp_m, lane, mi, 2 * hh);
      const int cc = min(co[mi][hh], cout - 1);
      sc[mi][hh] = scale[cc];
      bi[mi][hh] = bias[cc];
      ac[mi][hh] = a_col[cc];
      bc[mi][hh] = b_col[cc];
    }
  float sg[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, sga[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int tile = 0; tile < tiles_per_block; ++tile) {
    const int t0 = (blockIdx.x * tiles_per_block + tile) * kTcT;
    if (t0 >= t_dim) break;
    // each window's running first max: relu value, conv value, row
    float best_y[2][4][4], best[2][4][4];
    int sel[2][4][4];
    conv_rows_tc<false>(
        reinterpret_cast<bf16*>(tc_smem), xb, w, fo * pf, pf, co0, t0, cin, f_dim, t_dim, cout,
        [&](int r, const float (&acc)[2][4][4]) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int m = tc_m(warp_m, lane, mi, 2 * hh);
              bf16* zrow = gzb + min(co[mi][hh], cout - 1) * plane +
                           static_cast<size_t>(r) * t_dim;
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
                const float z0 = fmaf(-v0, ac[mi][hh], -bc[mi][hh]);
                const float z1 = fmaf(-v1, ac[mi][hh], -bc[mi][hh]);
                const int n = tc_n(warp_n, lane, ni, 0);
                if (kStaged)
                  *reinterpret_cast<__nv_bfloat162*>(zs + (r * kTcCo + m) * kGzZP + n) =
                      __floats2bfloat162_rn(z0, z1);
                else if (co[mi][hh] < cout)
                  store_pair(zrow, t0 + n, t_dim, pairs, z0, z1);
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2) {
                  const int e = 2 * hh + e2;
                  const float v = acc[mi][ni][e];
                  const float y = bn_relu(v, sc[mi][hh], bi[mi][hh]);
                  if (r == 0 || y > best_y[mi][ni][e]) {
                    best_y[mi][ni][e] = y;
                    best[mi][ni][e] = v;
                    sel[mi][ni][e] = r;
                  }
                }
              }
            }
        });
    // the windows' ends: g to the first max where that max is > 0
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (co[mi][hh] >= cout) continue;
        const int m = tc_m(warp_m, lane, mi, 2 * hh);
        const bf16* grow = g + ((static_cast<size_t>(b) * cout + co[mi][hh]) * f_out + fo) * t_dim;
        bf16* zc = gzb + co[mi][hh] * plane;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int e = 2 * hh + e2;
            const int n = tc_n(warp_n, lane, ni, e2);
            if (t0 + n >= t_dim || !(best_y[mi][ni][e] > 0.f)) continue;
            const float gp = __bfloat162float(grow[t0 + n]), v = best[mi][ni][e];
            sg[mi][hh] += gp;
            sga[mi][hh] = fmaf(gp, v, sga[mi][hh]);
            const bf16 z = __float2bfloat16(gp * sc[mi][hh] - v * ac[mi][hh] - bc[mi][hh]);
            if (kStaged)
              zs[(sel[mi][ni][e] * kTcCo + m) * kGzZP + n] = z;
            else
              zc[static_cast<size_t>(sel[mi][ni][e]) * t_dim + t0 + n] = z;
          }
      }
    if (kStaged) {   // the window's rows out: 16-byte stores along the frames
      __syncthreads();
      const int units = kTcT / 8;   // 16-byte units per staged row
      for (int e = threadIdx.x; e < pf * kTcCo * units; e += kTcThreads) {
        const int u = e % units, rm = e / units;   // rm = r * kTcCo + m
        const int c = co0 + rm % kTcCo, t = t0 + 8 * u;
        if (c >= cout || t >= t_dim) continue;
        const bf16* src = zs + rm * kGzZP + 8 * u;
        bf16* dst = gzb + c * plane + static_cast<size_t>(rm / kTcCo) * t_dim + t;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && t + k < t_dim; ++k) dst[k] = src[k];
        }
      }
      __syncthreads();   // zs is free for the next tile
    }
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  tc_channel_sums(reinterpret_cast<float*>(tc_smem), sg, sga, co0, cout, row);
}

int n_split(int t_dim, int tiles_per_block) {
  return ceil_div(ceil_div(t_dim, kBT), tiles_per_block);
}

template <bool kStaged>
cudaError_t launch_gz(const void* x, const void* w, const void* scale, const void* bias,
                      const void* a, const void* b, const void* g, void* gz, float* partials,
                      int batch, int cin, int f_dim, int t_dim, int cout, int pf, int tpb,
                      cudaStream_t s) {
  constexpr size_t smem = gz_smem_bytes<kStaged>();
  cudaError_t err = set_smem(train_gz_tc_kernel<kStaged>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split(t_dim, tpb), ceil_div(cout, kTcCo), batch * (f_dim / pf));
  train_gz_tc_kernel<kStaged><<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(g), static_cast<bf16*>(gz),
      partials, cin, f_dim, t_dim, cout, pf, tpb);
  return cudaGetLastError();
}

// float32 F1: the float smallcin tile, windows staged in chunks of at most
// scf_chunk_rows<CC> rows.
template <int CC>
cudaError_t launch_stats_tf32(const void* x, const void* w, float* partials, int batch, int cin,
                              int f_dim, int t_dim, int cout, int pf, int tpb, cudaStream_t s) {
  const int chunk = min(pf, scf_chunk_rows<CC>());
  const size_t smem = scf_smem_bytes<CC>(chunk);
  cudaError_t err = set_smem(train_stats_tf32_kernel<CC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split(t_dim, tpb), ceil_div(cout, kTcCo), batch * (f_dim / pf));
  train_stats_tf32_kernel<CC><<<grid, kScfThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), partials, cin, f_dim, t_dim,
      cout, pf, chunk, tpb);
  return cudaGetLastError();
}

cudaError_t launch_stats_tc(const void* x, const void* w, float* partials, int batch, int cin,
                            int f_dim, int t_dim, int cout, int pf, int tpb, cudaStream_t s) {
  // the block tile: tb_block_rows(pf) rows a block
  constexpr size_t smem = tb_ring_bytes<false>() + sizeof(float) * kTbRed;
  cudaError_t err = set_smem(train_stats_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_split(t_dim, tpb), ceil_div(cout, kTcCo),
            batch * ceil_div(f_dim, tb_block_rows(pf)));
  train_stats_tc_kernel<<<grid, kTcThreads, smem, s>>>(static_cast<const bf16*>(x),
                                                       static_cast<const bf16*>(w), partials,
                                                       cin, f_dim, t_dim, cout, pf, tpb);
  return cudaGetLastError();
}

// float32 g_z: the float smallcin tile, and as many of the window's last
// rows staged as fit beside the halo at two blocks an SM (none where the
// halo alone takes more).
template <int CC>
cudaError_t launch_gz_tf32(const void* x, const void* w, const void* scale, const void* bias,
                           const void* a, const void* b, const void* g, void* gz,
                           float* partials, int batch, int cin, int f_dim, int t_dim, int cout,
                           int pf, int tpb, cudaStream_t s) {
  const int chunk = min(pf, scf_chunk_rows<CC>());
  const size_t fixed = scf_smem_bytes<CC>(chunk);
  const size_t row_bytes = sizeof(float) * 4 * kScfZRow;
  const int stage_rows =
      fixed >= kTwoBlockSmem
          ? 0
          : min(min(pf, kGzF32MaxStageRows), static_cast<int>((kTwoBlockSmem - fixed) / row_bytes));
  const size_t smem = fixed + row_bytes * stage_rows;
  cudaError_t err = set_smem(train_gz_tf32_kernel<CC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split(t_dim, tpb), ceil_div(cout, kTcCo), batch * (f_dim / pf));
  train_gz_tf32_kernel<CC><<<grid, kScfThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(g),
      static_cast<float*>(gz), partials, cin, f_dim, t_dim, cout, pf, chunk, tpb, stage_rows);
  return cudaGetLastError();
}

// Cin at or below which K5's float32 dW takes the 8-channel tile with the dx
// taps stacked in M; above it, the 16-channel tile (one m16 per dx).
constexpr int kDwfStackMaxCin = kDwfCiStacked;

template <int CI>
cudaError_t launch_dw_tf32(const void* x, const void* gz, float* partials, int splits,
                           int batch, int cin, int f_dim, int t_dim, int cout,
                           int rows_per_split, int frames_per_split, cudaStream_t s) {
  constexpr size_t smem = dwf_smem<CI>();
  cudaError_t err = set_smem(ct_dw_tf32_kernel<CI>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, ceil_div(cout, kDwfCo), ceil_div(cin, CI));
  ct_dw_tf32_kernel<CI><<<grid, dwf_threads<CI>(), smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gz), partials, batch, cin, f_dim,
      t_dim, cout, rows_per_split, frames_per_split);
  return cudaGetLastError();
}

bool bad_shape(int cin, int cout, int pf) {
  return cin < 1 || cin > kMaxStagedCin || cout < 1 || pf < 1 || pf > 255;
}


}  // namespace

// F1 + its reduction: sums (2 * Cout,) = [sum | sum of squares] of the conv
// output over (B, F, T). partials: (B * F/pf * n_split, 2 * Cout) float in
// float32 (train_stats_tf32_kernel, one block a window), (B * ceil(F /
// tb_block_rows(pf)) * n_split, 2 * Cout) in bfloat16 (the block tile).
extern "C" int seld_conv3x3_train_stats(const void* x, const void* w, void* partials, void* sums,
                                        int batch, int cin, int f_dim, int t_dim, int cout,
                                        int pf, int tiles_per_block, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (bad_shape(cin, cout, pf) || f_dim % pf || tiles_per_block < 1)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == kF32)
    err = cin <= kCC ? launch_stats_tf32<kCC>(x, w, part, batch, cin, f_dim, t_dim, cout, pf,
                                              tiles_per_block, s)
                     : launch_stats_tf32<2 * kCC>(x, w, part, batch, cin, f_dim, t_dim, cout, pf,
                                                  tiles_per_block, s);
  else if (dtype == kBF16)
    err = launch_stats_tc(x, w, part, batch, cin, f_dim, t_dim, cout, pf, tiles_per_block, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * (f_dim / pf) * n_split(t_dim, tiles_per_block);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), rows, 2 * cout, s));
}

// B1 + its reduction: sums (2 * Cout,) = [S_g | S_gx] over out > 0.
// out, g: (B, Cout, F', T); p, q: (Cout,) float; partials: (B * F', 2 * Cout).
extern "C" int seld_conv3x3_train_sel_stats(const void* out, const void* g, const void* p,
                                            const void* q, void* partials, void* sums,
                                            int batch, int cout, int f_out, int t_dim,
                                            int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  auto pc = static_cast<const float*>(p);
  auto qc = static_cast<const float*>(q);
  if (cout < 1 || cout > 65535 || batch * f_out > 65535) return cudaErrorInvalidValue;
  dim3 grid(cout, batch * f_out);
  if (dtype == kF32)
    sel_stats_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(g), pc, qc, part, cout,
        f_out, t_dim);
  else if (dtype == kBF16)
    sel_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(g), pc, qc,
        part, cout, f_out, t_dim);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), batch * f_out,
                                        2 * cout, s));
}

// B2, g_z + its reduction: gz (B, Cout, F, T) in x's dtype and sums (2 *
// Cout,) = [S_g | sum g_pre * acc]. x (B, Cin, F, T), w (3, 3, Cin, Cout), g
// (B, Cout, F/pf, T) in one dtype; scale, bias, a, b: (Cout,) float;
// partials (B * F/pf * n_split, 2 * Cout). float32: train_gz_tf32_kernel on
// the float smallcin tile; bfloat16: train_gz_tc_kernel on the row tile.
extern "C" int seld_conv3x3_train_gz(const void* x, const void* w, const void* scale,
                                     const void* bias, const void* a, const void* b,
                                     const void* g, void* gz, void* partials, void* sums,
                                     int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                                     int tiles_per_block, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (bad_shape(cin, cout, pf) || f_dim % pf || tiles_per_block < 1)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == kF32)
    err = cin <= kCC ? launch_gz_tf32<kCC>(x, w, scale, bias, a, b, g, gz, part, batch, cin,
                                           f_dim, t_dim, cout, pf, tiles_per_block, s)
                     : launch_gz_tf32<2 * kCC>(x, w, scale, bias, a, b, g, gz, part, batch, cin,
                                               f_dim, t_dim, cout, pf, tiles_per_block, s);
  else if (dtype == kBF16)
    err = pf <= kGzStageRows
              ? launch_gz<true>(x, w, scale, bias, a, b, g, gz, part, batch, cin, f_dim, t_dim,
                                cout, pf, tiles_per_block, s)
              : launch_gz<false>(x, w, scale, bias, a, b, g, gz, part, batch, cin, f_dim, t_dim,
                                 cout, pf, tiles_per_block, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * (f_dim / pf) * n_split(t_dim, tiles_per_block);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), rows, 2 * cout, s));
}

// B2, dW + its reduction: sums (3, 3, Cin, Cout) float from x (B, Cin, F,
// T) and gz (B, Cout, F, T) of one dtype, Cin <= 16: in bfloat16 the dW
// tile of conv3x3_dw_tc.cuh with a 16-channel Cin tile, in float32 the
// split-TF32 tile of conv3x3_dw_tf32.cuh (8 channels with the dx taps
// stacked for Cin <= kDwfStackMaxCin, else 16); the depth split as
// seld_ct_train_dw's (conv2d_train.dw_split); partials (that many shares,
// 9 * Cin * Cout).
extern "C" int seld_conv3x3_train_dw_tc(const void* x, const void* gz, void* partials,
                                        void* sums, int batch, int cin, int f_dim, int t_dim,
                                        int cout, int rows_per_split, int frames_per_split,
                                        int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (cin < 1 || cin > kDwCiStage1 || cout < 1 || rows_per_split < 1 ||
      frames_per_split < 1 || (frames_per_split < t_dim && frames_per_split % kDwT))
    return cudaErrorInvalidValue;
  const int splits = ceil_div(batch * f_dim, rows_per_split) * ceil_div(t_dim, frames_per_split);
  cudaError_t err;
  if (dtype == kBF16) {
    constexpr size_t smem = dw_tc_smem<kDwCiStage1>();
    err = set_smem(ct_dw_tc_kernel<kDwCiStage1>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(splits, ceil_div(cout, kDwCo), 1);
    ct_dw_tc_kernel<kDwCiStage1><<<grid, kDwThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(gz), part, batch, cin, f_dim,
        t_dim, cout, rows_per_split, frames_per_split);
    err = cudaGetLastError();
  } else if (dtype == kF32) {
    err = cin <= kDwfStackMaxCin
              ? launch_dw_tf32<kDwfCiStacked>(x, gz, part, splits, batch, cin, f_dim, t_dim, cout,
                                              rows_per_split, frames_per_split, s)
              : launch_dw_tf32<kDwfCiStage1>(x, gz, part, splits, batch, cin, f_dim, t_dim, cout,
                                             rows_per_split, frames_per_split, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), splits,
                                        9 * cin * cout, s));
}
