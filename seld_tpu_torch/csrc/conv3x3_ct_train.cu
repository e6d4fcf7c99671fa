// Train-mode CNN stages 2-3: 3x3 conv (Cin % 8 == 0, zero pad 1) ->
// BatchNorm with batch statistics -> ReLU -> max over `pf` frequency rows,
// with the backward for the input (stage 2 passes gradient to stage 1), the
// weights and the BN affine.
//
// Replaces seld_tpu/ops/pallas/conv2d_ct_train.py::
// conv2d_widecin_ct_bn_relu_fpool_train: its passes _ct_stats_kernel (F1),
// _ct_bwd_stats_kernel (B1), _ct_dw_kernel (B2) and _ct_dx_kernel (B3); the
// forward pass F2 (_ct_fwd_kernel) is the serving kernel seld_conv3x3_widecin
// (conv3x3_bn_relu_fpool.cu) fed the batch-statistics affine. Layout: h
// (B, Cin, F, T), w (3, 3, Cin, Cout), out and its cotangent g
// (B, Cout, F/pf, T); every pass reads only t < T.
//
// - F1  seld_ct_train_stats: the conv rows on the serving kernel's block
//       tile (FtPipe, split TF32, in float32; TbPipe in bfloat16: same Cin
//       chunk order, same products, so bitwise the values F2 pools), written
//       once as pre (B, Cout, F, T) float, and per-channel partial sums and
//       sums of squares.
// - B1  seld_ct_train_sel_stats: routes g to the FIRST row of each pool
//       window holding the max of relu(pre * scale + bias) (a strict >
//       running argmax, reduce_window's first-match rule) where that max is
//       > 0 (a window holding a NaN routes nothing, as JAX's), and sums S_g
//       = sum g_pre and S_gx = sum g_pre * xhat with xhat = (pre - mean) *
//       inv.
// - B2  seld_ct_train_gz: the same routing, then the batch-stats BN backward
//       g_z = scale * (g_pre - S_g/N - xhat * S_gx/N) (the subtraction before
//       any product), rounded to the input dtype and written once as
//       gz (B, Cout, F, T); seld_ct_train_dw: dW[dy][dx][ci][co] = sum over
//       (b, f, t) of gz[b][co][f][t] * h[b][ci][f + dy - 1][t + dx - 1].
// - B3  seld_ct_train_dx: dh = the transposed conv of gz with w (taps
//       flipped, Cin and Cout swapped) on the block tile with transposed
//       weights: FtPipe<true> (split TF32) in float32, TbPipe<true> (the
//       weights staged [tap][co][ci]) in bfloat16; no affine, ReLU or pool.
// - the sums (F1, B1, dW) go through partial rows, one per block (B1: one
//   per work unit, in a slot fixed by the unit), and launch_reduce: a fixed order in double, no atomics, so a run repeats
//   bitwise.
//
// What bounds it on the H100: arithmetic. The function needs three
// conv-sized products (the forward conv, dW and dh: 2 * 9 * Cin * Cout
// operations per conv pixel each, 0.8 TFLOP for a flagship stage 2 at
// batch 8). F1 and F2 each run the forward conv (F2 is the serving kernel,
// which pools on the fly and keeps no pre-activation), B2 and B3 one product
// each; the TPU kernel's recomputes in B1, B2 and B3 become reads of pre and
// gz, which an 80 GB card holds (944 MB of pre and 472 MB of bf16 gz for
// that stage). Design: F1 is K3's block tile (64 channels x 64 frames x 4
// rows a pass, 256 threads: conv3x3_tc.cuh's in bfloat16, its split-TF32
// counterpart conv3x3_tf32.cuh in float32), and so is B3 on the
// transposed weights. B1 and B2's gz pass are bound by bytes (pre read,
// g read, gz written: 0.075 and 0.110 ms at the flagship's stage 2, batch 2,
// in bf16) and share one streaming walker, route_walk below: a lane owns 4
// frames of a pool window (16-byte loads of pre, a window's rows loaded
// before any is used, pre read once at pf <= 8), a warp walks (b, channel,
// pooled row, frame span) units on a persistent grid sized so that stage 3's
// few windows still fill every SM. The dW pass gives each
// block a share of the depth, split over the (b, f) rows and, where B * F
// is small (stage 3: 8 rows at batch 2), over frames, so that every SM
// has blocks. In bfloat16 the dW pass is the tensor-core GEMM of
// conv3x3_dw_tc.cuh (ct_dw_tc_kernel: 9 taps x 32 Cin x 64 Cout per
// block, the frames as the depth, the tap shift built from aligned words by
// byte permutes); in float32 the same GEMM in split TF32 (ct_dw_tf32_kernel<32>
// of conv3x3_dw_tf32.cuh: three TF32 products a product, the A operand's
// tap shift a one-word offset, each 64-frame step summed apart and added to
// the accumulators rounded to nearest).
#include <climits>

#include "conv3x3_dw_tc.cuh"
#include "conv3x3_dw_tf32.cuh"
#include "conv3x3_tf32.cuh"

namespace {

// ---- B1 and g_z: one streaming row walker ----------------------------------
//
// A lane owns a quad: 4 consecutive frames of one pool window, that is one
// 16-byte load of each of the window's pf rows of pre, one 8-byte (bf16) or
// 16-byte (float32) load of g and, in g_z, one 8- or 16-byte store of each
// row of gz. A warp is one walker: it takes work units (b, channel, pooled
// row, frame span) u = warp * gridDim.x + blockIdx.x, then u + 8 * gridDim.x,
// ..., and its lanes take the span's quads lane, lane + 32 kG, ... . The grid
// is persistent (route_split in ops/kernels/conv2d_ct_train.py: at most SMs x
// kRouteStatsBlocks or kRouteGzBlocks blocks, the span chosen so that the
// units' rounds come out whole), so stage 3's 768 windows at batch 2 fill the
// card as stage 2's do.
// Rows are loaded into registers in chunks of kRouteRows float4 a lane (kG
// quads of kRouteRows / kG rows) before any is used; pf > 8 takes several
// chunks with the running max, `sel` and the NaN state carried between them,
// and there g_z reads every chunk but the last again when it writes. At pf <= 8
// pre is read from device memory once.
constexpr int kRouteThreads = 256;   // 8 warps a block, each warp one walker
// Blocks an SM (route_split's persistent grid): B1 at <= 80 registers a
// thread; g_z holds a chunk's rows until `sel` is known and then every
// row's output, and at 80 it spilled (24-156 bytes), so <= 128.
constexpr int kRouteStatsBlocks = 3;
constexpr int kRouteGzBlocks = 2;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kRouteRows = 8;        // float4 rows of pre a lane holds at once
constexpr int kQuad = 4;             // frames a lane owns

static __device__ __forceinline__ float& quad_at(float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Frames t .. t + 3 of a row: one 16-byte load where `vec` (T % 4 == 0 and
// every base 16-byte aligned), else one frame at a time, frames >= T as 0.
// kStream loads evict-first (ld.global.cs): B1's pre, which B1 reads once
// (faster in bf16 at the flagship's stages 2 and 3 than the read-only path;
// g_z, which also writes, was slower at stage 2 with cs loads and stores:
// PERF.md §6).
template <bool kStream = false>
static __device__ __forceinline__ float4 load_quad(const float* __restrict__ row, int t,
                                                   int t_dim, bool vec) {
  if (vec) {
    const auto* q = reinterpret_cast<const float4*>(row + t);
    return kStream ? __ldcs(q) : __ldg(q);
  }
  float4 v = make_float4(__ldg(row + t), 0.f, 0.f, 0.f);
  if (t + 1 < t_dim) v.y = __ldg(row + t + 1);
  if (t + 2 < t_dim) v.z = __ldg(row + t + 2);
  if (t + 3 < t_dim) v.w = __ldg(row + t + 3);
  return v;
}

static __device__ __forceinline__ float4 load_quad(const bf16* __restrict__ row, int t,
                                                   int t_dim, bool vec) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + t));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  float4 v = make_float4(__bfloat162float(row[t]), 0.f, 0.f, 0.f);
  if (t + 1 < t_dim) v.y = __bfloat162float(row[t + 1]);
  if (t + 2 < t_dim) v.z = __bfloat162float(row[t + 2]);
  if (t + 3 < t_dim) v.w = __bfloat162float(row[t + 3]);
  return v;
}

static __device__ __forceinline__ void store_quad(float* __restrict__ row, int t, int t_dim,
                                                  bool vec, float4 v) {
  if (vec) {
    *reinterpret_cast<float4*>(row + t) = v;
    return;
  }
  row[t] = v.x;
  if (t + 1 < t_dim) row[t + 1] = v.y;
  if (t + 2 < t_dim) row[t + 2] = v.z;
  if (t + 3 < t_dim) row[t + 3] = v.w;
}

// Rounded to nearest as store_f, whether packed in pairs or one at a time.
static __device__ __forceinline__ void store_quad(bf16* __restrict__ row, int t, int t_dim,
                                                  bool vec, float4 v) {
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(row + t) =
        make_uint2(*reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
    return;
  }
  row[t] = __float2bfloat16(v.x);
  if (t + 1 < t_dim) row[t + 1] = __float2bfloat16(v.y);
  if (t + 2 < t_dim) row[t + 2] = __float2bfloat16(v.z);
  if (t + 3 < t_dim) row[t + 3] = __float2bfloat16(v.w);
}

// One chunk of rows r0 .. r0 + kR - 1 (those < pf) of the lane's kG quads;
// quads past the span read as 0.
template <bool kStream, int kG, int kR>
static __device__ __forceinline__ void load_rows(float4 (&p)[kG][kR],
                                                 const float* __restrict__ prow,
                                                 const int (&tq)[kG], const bool (&ok)[kG],
                                                 int r0, int pf, int t_dim, bool vec) {
#pragma unroll
  for (int gi = 0; gi < kG; ++gi)
#pragma unroll
    for (int r = 0; r < kR; ++r)
      p[gi][r] = ok[gi] && r0 + r < pf
                     ? load_quad<kStream>(prow + static_cast<size_t>(r0 + r) * t_dim, tq[gi],
                                          t_dim, vec)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
}

// B1 (kGz false) and g_z (kGz true) of every unit this warp walks. Routing,
// per frame: the window's max m of relu(pre * scale + bias) over its pf rows
// with max_nan, and `sel`, the first row holding it (strict >, so ties keep
// the earlier row); routed where m > 0, so a window holding a NaN (m NaN)
// routes nothing. That is JAX's _route_group (seld_tpu/ops/pallas/
// conv2d_ct_train.py:97-112): jnp.maximum over the rows, then the first row
// equal to the max (none equals a NaN), where its pre-activation is > 0. The
// running max stands in for the running best: for finite rows they are
// equal (every y >= 0), and once m is NaN nothing routes. B1 sums S_g = sum
// g_pre and S_gx = sum g_pre * xhat, xhat = (pre - mean) * inv, per lane in
// frame order, then down the warp's lanes in a fixed order, into the unit's
// partial row ((b * F' + fo) * spans + span, channel); a NaN window adds its
// NaN to S_gx, as JAX's sum of g_pre * xhat. g_z writes scale * (g_pre - c1
// - xhat * c2) with the product-sum fused and rounded once, then rounded to
// g's dtype.
template <bool kGz, int kG, typename T>
static __device__ __forceinline__ void route_walk(const float* __restrict__ pre,
                                                  const T* __restrict__ g,
                                                  const float* __restrict__ cols,
                                                  float* __restrict__ partials,
                                                  T* __restrict__ gz, int batch, int cout,
                                                  int f_dim, int t_dim, int pf,
                                                  int frames_per_span, bool vec) {
  constexpr int kR = kRouteRows / kG;
  const int lane = threadIdx.x % 32;
  const int f_out = f_dim / pf;
  const int spans = ceil_div(t_dim, frames_per_span);
  const int units = batch * cout * f_out * spans;
  const int chunks = ceil_div(pf, kR);
  for (int u = threadIdx.x / 32 * gridDim.x + blockIdx.x; u < units;
       u += kRouteWarps * gridDim.x) {
    const int span = u % spans, window = u / spans;   // window = (b * cout + co) * f_out + fo
    const int fo = window % f_out, bc = window / f_out, co = bc % cout;
    const float sc = cols[co], bi = cols[cout + co];
    const float mu = cols[2 * cout + co], iv = cols[3 * cout + co];
    const size_t base = (static_cast<size_t>(bc) * f_dim + static_cast<size_t>(fo) * pf) * t_dim;
    const float* prow = pre + base;
    const T* grow = g + static_cast<size_t>(window) * t_dim;
    const int t_first = span * frames_per_span;
    const int t_end = min(t_dim, t_first + frames_per_span);
    float sg = 0.f, sgx = 0.f;
    for (int t0 = t_first + kQuad * lane; t0 < t_end; t0 += kQuad * 32 * kG) {
      int tq[kG];
      bool ok[kG];
      float4 gv[kG];
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        tq[gi] = t0 + kQuad * 32 * gi;
        ok[gi] = tq[gi] < t_end;
        gv[gi] = ok[gi] ? load_quad(grow, tq[gi], t_dim, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float4 p[kG][kR];
      float m[kG][kQuad], xs[kG][kQuad];
      int sel[kG][kQuad];
      for (int c = 0; c < chunks; ++c) {
        const int r0 = c * kR;
        load_rows<!kGz>(p, prow, tq, ok, r0, pf, t_dim, vec);
#pragma unroll
        for (int gi = 0; gi < kG; ++gi)
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (r0 + r >= pf) continue;
#pragma unroll
            for (int j = 0; j < kQuad; ++j) {
              const float x = quad_at(p[gi][r], j);
              const float y = bn_relu(x, sc, bi);
              if (r0 + r == 0) {   // max_nan(0, y) = y: bn_relu's y is >= 0 or NaN
                m[gi][j] = y;
                sel[gi][j] = 0;
                xs[gi][j] = x;
              } else {
                if (y > m[gi][j]) {
                  sel[gi][j] = r0 + r;
                  xs[gi][j] = x;
                }
                m[gi][j] = max_nan(m[gi][j], y);
              }
            }
          }
      }
      if constexpr (!kGz) {
#pragma unroll
        for (int gi = 0; gi < kG; ++gi)
#pragma unroll
          for (int j = 0; j < kQuad; ++j) {
            if (!ok[gi] || tq[gi] + j >= t_dim) continue;
            if (m[gi][j] > 0.f) {
              const float gval = quad_at(gv[gi], j);
              sg += gval;
              sgx = __fmaf_rn(gval, __fmul_rn(__fsub_rn(xs[gi][j], mu), iv), sgx);
            } else if (m[gi][j] != m[gi][j]) {
              sgx += m[gi][j];
            }
          }
      } else {
        const float c1 = cols[4 * cout + co], c2 = cols[5 * cout + co];
#pragma unroll
        for (int gi = 0; gi < kG; ++gi)
#pragma unroll
          for (int j = 0; j < kQuad; ++j)
            if (!(m[gi][j] > 0.f)) quad_at(gv[gi], j) = 0.f;
        // the chunk still held first, then (pf > kR only) the others again
        for (int k = 0; k < chunks; ++k) {
          const int r0 = (k == 0 ? chunks - 1 : k - 1) * kR;
          if (k > 0) load_rows<!kGz>(p, prow, tq, ok, r0, pf, t_dim, vec);
#pragma unroll
          for (int gi = 0; gi < kG; ++gi)
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              if (!ok[gi] || r0 + r >= pf) continue;
              float4 z;
#pragma unroll
              for (int j = 0; j < kQuad; ++j) {
                const float xhat = __fmul_rn(__fsub_rn(quad_at(p[gi][r], j), mu), iv);
                const float gsel = sel[gi][j] == r0 + r ? quad_at(gv[gi], j) : 0.f;
                quad_at(z, j) = __fmul_rn(sc, __fmaf_rn(-xhat, c2, __fsub_rn(gsel, c1)));
              }
              store_quad(gz + base + static_cast<size_t>(r0 + r) * t_dim, tq[gi], t_dim, vec, z);
            }
        }
      }
    }
    if constexpr (!kGz) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sg += __shfl_down_sync(0xffffffffu, sg, off);
        sgx += __shfl_down_sync(0xffffffffu, sgx, off);
      }
      if (lane == 0) {
        float* row = partials + static_cast<size_t>((bc / cout * f_out + fo) * spans + span) *
                                    2 * cout;
        row[co] = sg;
        row[cout + co] = sgx;
      }
    }
  }
}

template <typename T, int kG>
__global__ void __launch_bounds__(kRouteThreads, kRouteStatsBlocks)
ct_route_stats_kernel(const float* __restrict__ pre, const T* __restrict__ g,
                      const float* __restrict__ cols, float* __restrict__ partials, int batch,
                      int cout, int f_dim, int t_dim, int pf, int frames_per_span, bool vec) {
  route_walk<false, kG, T>(pre, g, cols, partials, nullptr, batch, cout, f_dim, t_dim, pf,
                           frames_per_span, vec);
}

template <typename T, int kG>
__global__ void __launch_bounds__(kRouteThreads, kRouteGzBlocks)
ct_route_gz_kernel(const float* __restrict__ pre, const T* __restrict__ g,
                   const float* __restrict__ cols, T* __restrict__ gz, int batch, int cout,
                   int f_dim, int t_dim, int pf, int frames_per_span, bool vec) {
  route_walk<true, kG, T>(pre, g, cols, nullptr, gz, batch, cout, f_dim, t_dim, pf,
                          frames_per_span, vec);
}

// F1's epilogue of one pass on either block tile: this warp's conv row f of
// acc (64 channels x 32 frames) written once to pre, its per-channel sums
// added to red (tb_add_sums) in a fixed order.
static __device__ __forceinline__ void tb_stats_row(float* __restrict__ pre,
                                                    float* __restrict__ red, const TbAcc& acc,
                                                    int b, int f, int co0, int t0, int cout,
                                                    int f_dim, int t_dim) {
  const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2;
  float s1[4][2] = {}, s2[4][2] = {};
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int co = co0 + tb_m(lane, mi, 2 * hh);
      if (co >= cout) continue;
      float* prow = pre + ((static_cast<size_t>(b) * cout + co) * f_dim + f) * t_dim;
#pragma unroll
      for (int ni = 0; ni < kTbNi; ++ni) {
        const int t = t0 + tb_n(half, lane, ni, 0);
        const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
        if (t + 1 < t_dim && reinterpret_cast<uintptr_t>(prow + t) % 8 == 0) {
          *reinterpret_cast<float2*>(prow + t) = make_float2(v0, v1);
        } else {
          if (t < t_dim) prow[t] = v0;
          if (t + 1 < t_dim) prow[t + 1] = v1;
        }
        if (t < t_dim) {
          s1[mi][hh] += v0;
          s2[mi][hh] = fmaf(v0, v0, s2[mi][hh]);
        }
        if (t + 1 < t_dim) {
          s1[mi][hh] += v1;
          s2[mi][hh] = fmaf(v1, v1, s2[mi][hh]);
        }
      }
    }
  tb_add_sums(red, s1, s2);
}

// F1's bfloat16 body: K3's block tile (TbPipe, the same rows of a
// block, chunks and fragments as conv3x3_tc_kernel, so pre equals F2's conv
// rows bitwise), written once as pre, with per-channel sums over the
// block's rows and frames in a fixed order (tb_add_sums, tb_channel_sums).
__global__ void __launch_bounds__(kTcThreads, 1)
ct_stats_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w, float* __restrict__ pre,
                   float* __restrict__ partials, int cin, int f_dim, int t_dim, int cout,
                   int pf) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* red = reinterpret_cast<float*>(tc_smem + tb_ring_bytes<false>());
  const int t0 = blockIdx.x * kTbT;
  const int co0 = blockIdx.y * kTcCo;
  const int rows = tb_block_rows(pf);
  const int blocks_f = ceil_div(f_dim, rows);
  const int b = blockIdx.z / blocks_f, f_first = (blockIdx.z % blocks_f) * rows;
  const bf16* hb = h + static_cast<size_t>(b) * cin * f_dim * t_dim;

  const int n_rows = min(rows, f_dim - f_first);
  tb_zero_sums(red);
  TbPipe<false> pipe(reinterpret_cast<bf16*>(tc_smem), hb, w, f_first, n_rows, co0, t0, cin,
                     f_dim, t_dim, cout);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    tb_stats_row(pre, red, acc, b, f_first + pipe.row, co0, t0, cout, f_dim, t_dim);
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  tb_channel_sums(red, co0, cout, row);
}

// F1's float32 body: the same on the split-TF32 tile (FtPipe of
// conv3x3_tf32.cuh), whose rows equal conv3x3_tf32_kernel's (K3's float32
// body, F2) bitwise.
__global__ void __launch_bounds__(kTcThreads, 1)
ct_stats_tf32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     float* __restrict__ pre, float* __restrict__ partials, int cin, int f_dim,
                     int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  float* red = reinterpret_cast<float*>(ft_smem + ft_ring_bytes());
  const int t0 = blockIdx.x * kTbT;
  const int co0 = blockIdx.y * kTcCo;
  const int rows = tb_block_rows(pf);
  const int blocks_f = ceil_div(f_dim, rows);
  const int b = blockIdx.z / blocks_f, f_first = (blockIdx.z % blocks_f) * rows;
  const float* hb = h + static_cast<size_t>(b) * cin * f_dim * t_dim;

  const int n_rows = min(rows, f_dim - f_first);
  tb_zero_sums(red);
  FtPipe<false> pipe(reinterpret_cast<float*>(ft_smem), hb, w, f_first, n_rows, co0, t0, cin,
                     f_dim, t_dim, cout);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    tb_stats_row(pre, red, acc, b, f_first + pipe.row, co0, t0, cout, f_dim, t_dim);
  }
  float* row = partials + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * 2 * cout;
  tb_channel_sums(red, co0, cout, row);
}

// dh's bfloat16 body: conv rows f0 .. f0 + 3 of gz (K = Cout channels) with
// the transposed, flipped weights on the block tile, stored in bf16.
__global__ void __launch_bounds__(kTcThreads, 1)
ct_dx_tc_kernel(const bf16* __restrict__ gz, const bf16* __restrict__ w, bf16* __restrict__ dh,
                int cin, int f_dim, int t_dim, int cout) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2;
  const int t0 = blockIdx.x * kTbT;
  const int c0 = blockIdx.y * kTcCo;
  const int blocks_f = ceil_div(f_dim, kTbSlots);
  const int b = blockIdx.z / blocks_f, f0 = (blockIdx.z % blocks_f) * kTbSlots;
  const bf16* gb = gz + static_cast<size_t>(b) * cout * f_dim * t_dim;
  const bool pairs = t_dim % 2 == 0;
  const int n_rows = min(kTbSlots, f_dim - f0);
  TbPipe<true> pipe(reinterpret_cast<bf16*>(tc_smem), gb, w, f0, n_rows, c0, t0, cout, f_dim,
                    t_dim, cin);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c0 + tb_m(lane, mi, 2 * hh);
        if (c >= cin) continue;
        bf16* drow = dh + ((static_cast<size_t>(b) * cin + c) * f_dim + f0 + pipe.row) * t_dim;
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          const int t = t0 + tb_n(half, lane, ni, 0);
          const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
          if (pairs && t + 1 < t_dim) {
            *reinterpret_cast<__nv_bfloat162*>(drow + t) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (t < t_dim) drow[t] = __float2bfloat16(v0);
            if (t + 1 < t_dim) drow[t + 1] = __float2bfloat16(v1);
          }
        }
      }
  }
}

// dh's float32 body: the same rows on the split-TF32 tile (FtPipe<true>:
// the weights w[8 - tap][c][co] split once at staging, gz's rows split as
// read), each warp's 64 x 32 tile of row f0 + pipe.row stored in float32
// (pairs of frames where aligned), masked to c < Cin and t < T. At 255
// registers a thread: the row taken once a pass (fr); with f0 + pipe.row in
// each row's address ptxas spilled 8 bytes (PERF.md §6).
__global__ void __launch_bounds__(kTcThreads, 1)
ct_dx_tf32_kernel(const float* __restrict__ gz, const float* __restrict__ w,
                  float* __restrict__ dh, int cin, int f_dim, int t_dim, int cout) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  const int t0 = blockIdx.x * kTbT;
  const int c0 = blockIdx.y * kTcCo;
  const int blocks_f = ceil_div(f_dim, kTbSlots);
  const int b = blockIdx.z / blocks_f, f0 = (blockIdx.z % blocks_f) * kTbSlots;
  const float* gb = gz + static_cast<size_t>(b) * cout * f_dim * t_dim;
  const int n_rows = min(kTbSlots, f_dim - f0);
  FtPipe<true> pipe(reinterpret_cast<float*>(ft_smem), gb, w, f0, n_rows, c0, t0, cout, f_dim,
                    t_dim, cin);
  TbAcc acc;
  while (pipe.pass(acc)) {
    if (pipe.row >= n_rows) continue;
    const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2, fr = f0 + pipe.row;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c0 + tb_m(lane, mi, 2 * hh);
        if (c >= cin) continue;
        float* drow = dh + ((static_cast<size_t>(b) * cin + c) * f_dim + fr) * t_dim;
#pragma unroll
        for (int ni = 0; ni < kTbNi; ++ni) {
          const int t = t0 + tb_n(half, lane, ni, 0);
          const float v0 = acc[mi][ni][2 * hh], v1 = acc[mi][ni][2 * hh + 1];
          if (t + 1 < t_dim && reinterpret_cast<uintptr_t>(drow + t) % 8 == 0) {
            *reinterpret_cast<float2*>(drow + t) = make_float2(v0, v1);
          } else {
            if (t < t_dim) drow[t] = v0;
            if (t + 1 < t_dim) drow[t + 1] = v1;
          }
        }
      }
  }
}

// Run f(T{}) with T the storage type of `dtype`.
template <typename F>
cudaError_t by_dtype(int dtype, F&& f) {
  if (dtype == kF32) return f(float{});
  if (dtype == kBF16) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// F1 + its reduction: pre (B, Cout, F, T) float = conv(h, w); sums
// (2 * Cout,) = [sum | sum of squares] of pre over (B, F, T). partials:
// (B * ceil(F / tb_block_rows(pf)) * ceil(T / 64), 2 * Cout) float, the
// block tiles' grid (both dtypes).
extern "C" int seld_ct_train_stats(const void* h, const void* w, void* pre, void* partials,
                                   void* sums, int batch, int cin, int f_dim, int t_dim,
                                   int cout, int pf, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (cin < 1 || cin % kCC || cout < 1 || pf < 1 || f_dim % pf) return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(t_dim, kTbT), ceil_div(cout, kTcCo),
                  batch * ceil_div(f_dim, tb_block_rows(pf)));
  cudaError_t err = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem = tb_ring_bytes<false>() + sizeof(float) * kTbRed;
      cudaError_t e = set_smem(ct_stats_tc_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_stats_tc_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<float*>(pre),
          part, cin, f_dim, t_dim, cout, pf);
    } else {
      constexpr size_t smem = ft_ring_bytes() + sizeof(float) * kTbRed;
      cudaError_t e = set_smem(ct_stats_tf32_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_stats_tf32_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const float*>(h), static_cast<const float*>(w), static_cast<float*>(pre),
          part, cin, f_dim, t_dim, cout, pf);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums),
                                        static_cast<int>(grid.x * grid.z), 2 * cout, s));
}

// B1's and g_z's split (route_split in ops/kernels/conv2d_ct_train.py):
// frames_per_span a multiple of 4, spans = ceil(T / frames_per_span), the
// units B * Cout * (F / pf) * spans in an int, and `blocks` the persistent
// grid, at least one.
static bool route_split_ok(int batch, int cout, int f_dim, int t_dim, int pf,
                           int frames_per_span, int blocks) {
  if (batch < 1 || cout < 1 || t_dim < 1 || pf < 1 || f_dim < pf || f_dim % pf ||
      frames_per_span < kQuad || frames_per_span % kQuad || blocks < 1)
    return false;
  const long long units = static_cast<long long>(batch) * cout * (f_dim / pf) *
                          ceil_div(t_dim, frames_per_span);
  return units <= INT_MAX;
}

// True where every quad is one aligned 16-byte load of pre (and 8- or 16-byte
// load or store of g and gz): T % 4 == 0 and the bases aligned.
template <typename T>
static bool route_vec(const void* pre, const void* g, const void* gz, int t_dim) {
  const auto aligned = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return t_dim % kQuad == 0 && aligned(pre, 16) && aligned(g, kQuad * sizeof(T)) &&
         (gz == nullptr || aligned(gz, kQuad * sizeof(T)));
}

// B1 + its reduction: sums (2 * Cout,) = [S_g | S_gx]. pre (B, Cout, F, T)
// float, g (B, Cout, F/pf, T), cols (6, Cout) float (rows scale, bias, mean,
// inv used), partials (B * F/pf * ceil(T / frames_per_span), 2 * Cout): one
// row per (b, pooled row, span), one column pair per channel.
extern "C" int seld_ct_train_sel_stats(const void* pre, const void* g, const void* cols,
                                       void* partials, void* sums, int batch, int cout,
                                       int f_dim, int t_dim, int pf, int frames_per_span,
                                       int blocks, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (!route_split_ok(batch, cout, f_dim, t_dim, pf, frames_per_span, blocks))
    return cudaErrorInvalidValue;
  cudaError_t err = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const bool vec = route_vec<T>(pre, g, nullptr, t_dim);
    const auto* p = static_cast<const float*>(pre);
    const auto* gp = static_cast<const T*>(g);
    const auto* c = static_cast<const float*>(cols);
    if (pf <= kRouteRows / 2)   // two quads a lane in flight
      ct_route_stats_kernel<T, 2><<<blocks, kRouteThreads, 0, s>>>(
          p, gp, c, part, batch, cout, f_dim, t_dim, pf, frames_per_span, vec);
    else
      ct_route_stats_kernel<T, 1><<<blocks, kRouteThreads, 0, s>>>(
          p, gp, c, part, batch, cout, f_dim, t_dim, pf, frames_per_span, vec);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * (f_dim / pf) * ceil_div(t_dim, frames_per_span);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), rows, 2 * cout, s));
}

// B2, g_z: gz (B, Cout, F, T) in the input dtype. pre, g and the split as
// for B1; cols (6, Cout) float: scale, bias, mean, inv, c1 = S_g / N, c2 =
// S_gx / N.
extern "C" int seld_ct_train_gz(const void* pre, const void* g, const void* cols, void* gz,
                                int batch, int cout, int f_dim, int t_dim, int pf,
                                int frames_per_span, int blocks, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!route_split_ok(batch, cout, f_dim, t_dim, pf, frames_per_span, blocks))
    return cudaErrorInvalidValue;
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const bool vec = route_vec<T>(pre, g, gz, t_dim);
    const auto* p = static_cast<const float*>(pre);
    const auto* gp = static_cast<const T*>(g);
    const auto* c = static_cast<const float*>(cols);
    auto* z = static_cast<T*>(gz);
    if (pf <= kRouteRows / 2)
      ct_route_gz_kernel<T, 2><<<blocks, kRouteThreads, 0, s>>>(
          p, gp, c, z, batch, cout, f_dim, t_dim, pf, frames_per_span, vec);
    else
      ct_route_gz_kernel<T, 1><<<blocks, kRouteThreads, 0, s>>>(
          p, gp, c, z, batch, cout, f_dim, t_dim, pf, frames_per_span, vec);
    return cudaGetLastError();
  }));
}

// B2, dW + its reduction: sums (3, 3, Cin, Cout) float. h (B, Cin, F, T), gz
// (B, Cout, F, T); the depth split into ceil(B * F / rows_per_split) x
// ceil(T / frames_per_split) shares (frames_per_split a multiple of 64 or
// at least T); partials (that many shares, 9 * Cin * Cout).
extern "C" int seld_ct_train_dw(const void* h, const void* gz, void* partials, void* sums,
                                int batch, int cin, int f_dim, int t_dim, int cout,
                                int rows_per_split, int frames_per_split, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  if (cin < 1 || cin % kCC || cout < 1 || rows_per_split < 1 || frames_per_split < 1 ||
      (frames_per_split < t_dim && frames_per_split % kDwT))
    return cudaErrorInvalidValue;
  const int splits = ceil_div(batch * f_dim, rows_per_split) * ceil_div(t_dim, frames_per_split);
  cudaError_t err = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem = dw_tc_smem<kDwCi>();
      cudaError_t e = set_smem(ct_dw_tc_kernel<kDwCi>, smem);
      if (e != cudaSuccess) return e;
      const dim3 grid(splits, ceil_div(cout, kDwCo), ceil_div(cin, kDwCi));
      ct_dw_tc_kernel<kDwCi><<<grid, kDwThreads, smem, s>>>(
          static_cast<const bf16*>(h), static_cast<const bf16*>(gz), part, batch, cin, f_dim,
          t_dim, cout, rows_per_split, frames_per_split);
    } else {
      constexpr size_t smem = dwf_smem<kDwfCi>();
      cudaError_t e = set_smem(ct_dw_tf32_kernel<kDwfCi>, smem);
      if (e != cudaSuccess) return e;
      const dim3 grid(splits, ceil_div(cout, kDwfCo), ceil_div(cin, kDwfCi));
      ct_dw_tf32_kernel<kDwfCi><<<grid, dwf_threads<kDwfCi>(), smem, s>>>(
          static_cast<const float*>(h), static_cast<const float*>(gz), part, batch, cin, f_dim,
          t_dim, cout, rows_per_split, frames_per_split);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(part, static_cast<float*>(sums), splits,
                                        9 * cin * cout, s));
}

// B3: dh (B, Cin, F, T) in the input dtype from gz (B, Cout, F, T) and w,
// on the block tiles' grid (64 frames x 64 channels x 4 rows a block).
extern "C" int seld_ct_train_dx(const void* gz, const void* w, void* dh, int batch, int cin,
                                int f_dim, int t_dim, int cout, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cout < 1 || batch * ceil_div(f_dim, kTbSlots) > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(t_dim, kTbT), ceil_div(cin, kTcCo), batch * ceil_div(f_dim, kTbSlots));
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem = tb_ring_bytes<true>();
      cudaError_t e = set_smem(ct_dx_tc_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_dx_tc_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const bf16*>(gz), static_cast<const bf16*>(w), static_cast<bf16*>(dh),
          cin, f_dim, t_dim, cout);
    } else {
      constexpr size_t smem = ft_ring_bytes();
      cudaError_t e = set_smem(ct_dx_tf32_kernel, smem);
      if (e != cudaSuccess) return e;
      ct_dx_tf32_kernel<<<grid, kTcThreads, smem, s>>>(
          static_cast<const float*>(gz), static_cast<const float*>(w), static_cast<float*>(dh),
          cin, f_dim, t_dim, cout);
    }
    return cudaGetLastError();
  }));
}
