// Fused CNN-frontend stage: 3x3 conv (stride 1, zero pad 1) -> folded BN
// affine -> ReLU -> max over `pf` frequency rows, writing only the pooled row.
//
// Replaces seld_tpu/ops/pallas/conv2d_pool.py::
//   conv2d_smallcin_thin_bn_relu_fpool (_smallcin_thin_kernel), stage 1,
//   Cin <= 8: entry seld_conv3x3_smallcin (which also takes Cin 9-10 with
//   16 staged channels, for K5's float32 forward at the reference's
//   3 * Cin <= 32);
//   conv2d_widecin_ct_bn_relu_fpool (_widecin_ct_kernel), stages 2-3,
//   Cin % 8 == 0: entry seld_conv3x3_widecin (which conv3x3_windows.cu's
//   K10b entry also launches, for any Cin).
// Contract: x (B, Cin, F, T), w (3, 3, Cin, Cout), scale/bias (Cout,) float
// -> out (B, Cout, F/pf, T) with out = max_r relu(conv(x)[f*pf + r] * scale +
// bias). The max is taken after the affine and ReLU; T is not pooled.
//
// What bounds it on the H100: arithmetic (2*9*Cin*Cout FLOP per output
// pixel: stage 2 of the flagship is 102 GFLOP per clip), and, without the
// fusion, memory: stage 1's unpooled (B, 192, 256, T) activation is 1.9 GB
// per clip in bf16. Design: one block per (b, pooled row, 64-channel Cout
// tile, 128-frame T tile), 256 threads. float32: each thread holds a
// 4-channel x 8-frame float accumulator (SIMT FMA, TF32 off); bfloat16
// widecin: the tensor-core tile of conv3x3_tc.cuh (mma.sync, bf16 operands
// staged through a two-stage ring, float accumulators in the m16n8
// fragment layout), its epilogue folding each row into the running max.
// The input halo (conv rows x 8 channels x (T tile + 2)) and the matching
// 9 x 8 x 64 weight slice are staged in shared memory with
// the conv's zero padding written at the F and T borders, so the inner loop
// never branches. The pool rows are computed one after another into the
// same accumulator and folded into a running max, so only one row of
// accumulators lives in registers whatever pf is.
// - smallcin: all taps and channels (K = 9 x 8 = 72, or 9 x 16 for Cin
//   9-10) and all pf + 2 halo rows are staged once per block. bfloat16 at
//   Cin <= 8 (K2 on the serving path): smallcin_tc_kernel below, on the
//   tensor cores with K = 72 padded to 80 (five k16 steps of two taps x 8
//   channels; the tile would take nine steps of 16 channels) and the
//   weights' A fragments held in registers across the pf rows. What bounds
//   it: operations (0.0687 ms at the flagship's batch 2, against 0.047 ms of
//   bytes). float32, and bfloat16 at Cin 9-10 (reached only by a direct
//   call: the router sends Cin <= 8 here, and K5's bf16 forward takes the
//   tile), stay SIMT.
// - widecin: Cin is walked in chunks (8 in float32, conv_row_widecin; 16 in
//   bfloat16, conv_rows_tc) for each pool row; each step stages that row's
//   3-row halo and weight chunk. The train-mode stages 2-3 share both rows,
//   so that their conv rows equal these bitwise. The staging zero-fills
//   channels >= Cin, so a ragged last chunk is exact and any Cin works; the
//   Python router sends only Cin % 8 == 0 here as K3.
#include "conv3x3_tc.cuh"

namespace {

// CC: the channels staged at once (kCC, or 2 * kCC for the smallcin entry's
// Cin 9-10; the widecin path walks chunks of kCC).
template <typename T, bool kSmall, int CC = kCC>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ float smem[];
  const int rows = kSmall ? pf + 2 : 3;
  float* xs = smem;                   // [rows][CC][kXW]
  float* ws = smem + rows * CC * kXW; // [9][CC][kBCO]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // frame lane: frames t0 + tx + 16 j
  const int ty = tid / 16;   // channel lane: channels co0 + ty + 16 i
  const int t0 = blockIdx.x * kBT;
  const int co0 = blockIdx.y * kBCO;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;
  const T* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

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

  if (kSmall) {
    stage_w<CC>(ws, w, 0, co0, cin, cout);
    stage_x<CC>(xs, xb, rows, fo * pf - 1, 0, t0, cin, f_dim, t_dim);
    __syncthreads();
  }
  for (int r = 0; r < pf; ++r) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if (kSmall) {
      conv_rows<CC>(xs, ws, r, tx, ty, acc);
    } else {
      conv_row_widecin(xs, ws, xb, w, fo * pf + r, co0, t0, cin, f_dim, t_dim, cout, tx, ty,
                       acc);
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

// K3's bfloat16 body: conv rows fo * pf .. + pf - 1 on the tensor-core tile,
// each folded into the running max of relu(acc * scale + bias).
__global__ void __launch_bounds__(kTcThreads, 2)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  bf16* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int t0 = blockIdx.x * kTcT;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;
  const bf16* xb = x + static_cast<size_t>(b) * cin * f_dim * t_dim;

  // relu output is >= 0, so 0 is the identity of the running max
  float best[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[mi][ni][e] = 0.f;

  conv_rows_tc<false>(reinterpret_cast<bf16*>(tc_smem), xb, w, fo * pf, pf, co0, t0, cin,
                      f_dim, t_dim, cout, [&](int, const float (&acc)[2][4][4]) {
#pragma unroll
                        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                          for (int h = 0; h < 2; ++h) {
                            // read here, not held in registers across the pipeline
                            const int co = min(co0 + tc_m(warp_m, lane, mi, 2 * h), cout - 1);
                            const float sc = __ldg(scale + co), bi = __ldg(bias + co);
#pragma unroll
                            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                              for (int e2 = 0; e2 < 2; ++e2)
                                best[mi][ni][2 * h + e2] = fmaxf(
                                    best[mi][ni][2 * h + e2],
                                    bn_relu(acc[mi][ni][2 * h + e2], sc, bi));
                          }
                      });

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + tc_m(warp_m, lane, mi, 2 * h);
      if (co >= cout) continue;
      bf16* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int t = t0 + tc_n(warp_n, lane, ni, e2);
          if (t < t_dim) orow[t] = __float2bfloat16(best[mi][ni][2 * h + e2]);
        }
    }
}

// ---- K2 in bfloat16, Cin <= 8: the smallcin tensor-core kernel ----------------
//
// A conv row is an implicit GEMM with M = 64 output channels, N = 128 frames
// and K = 9 taps x 8 channels = 72, padded to 80: five k16 steps, step s
// taking taps 2s and 2s + 1 (the last one's second tap zero weights). The
// block stages its pf + 2 halo rows once, as channel-pair words
// xs[row][pair][frame] (conv3x3_tc.cuh's layout with 4 pairs: any dx shift
// is one 32-bit load, 168-word pair rows keep the lanes on 32 banks), and
// its 80 x 64 weights once; each warp then holds the A fragments of all
// five steps in registers (40 words) for all pf rows, so a row costs only
// the B loads (two per n8 tile and step) and the products. Warps as the
// tile's: 2 along Cout x 4 along frames, 32 x 32 each. At stage 1 the
// products take about a third of the time and the staging's latency more,
// so the weights come by 16-byte cp.async and each thread keeps four halo
// items' loads in flight before it stores them.
constexpr int kScPairs = 4;                 // channel pairs staged: Cin <= 8
constexpr int kScSteps = 5;                 // k16 steps: taps (0, 1) .. (8, zeros)
constexpr int kScK = 16 * kScSteps;         // weight rows (tap, ci), rows 72-79 zero
constexpr int kScWP = kTcCo + 8;            // padded weight row (144 B: ldmatrix conflict-free)
constexpr int kScRowWords = kScPairs * kTcXS;   // words per staged conv row
constexpr int kScInFlight = 4;              // halo items a thread loads before storing

__host__ __device__ constexpr size_t smallcin_tc_smem_bytes(int pf) {
  return sizeof(uint32_t) * (pf + 2) * kScRowWords + sizeof(bf16) * kScK * kScWP;
}

__global__ void __launch_bounds__(kTcThreads, 2)
smallcin_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   bf16* __restrict__ out, int cin, int f_dim, int t_dim, int cout, int pf) {
  extern __shared__ __align__(16) unsigned char sc_smem[];
  const int rows = pf + 2;
  uint32_t* xs = reinterpret_cast<uint32_t*>(sc_smem);                // [rows][4][kTcXS]
  bf16* ws = reinterpret_cast<bf16*>(xs + rows * kScRowWords);      // [kScK][kScWP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int t0 = blockIdx.x * kTcT;
  const int co0 = blockIdx.y * kTcCo;
  const int f_out = f_dim / pf;
  const int b = blockIdx.z / f_out;
  const int fo = blockIdx.z % f_out;
  const int f_first = fo * pf - 1;
  const size_t plane = static_cast<size_t>(f_dim) * t_dim;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + b * cin * plane;

  // weights: ws[tap * 8 + ci][co], zero past Cin, Cout and tap 8; by
  // 16-byte cp.async where Cout % 8 == 0 and w is aligned
  if (cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    for (int e = threadIdx.x; e < kScK * kTcCo / 8; e += kTcThreads) {
      const int m = 8 * (e % (kTcCo / 8)), k = e / (kTcCo / 8);
      const int tap = k / 8, ci = k % 8, co = co0 + m;
      const bool ok = tap < 9 && ci < cin && co < cout;
      const bf16* src = ok ? w + (static_cast<size_t>(tap) * cin + ci) * cout + co : w;
      cp_async16(ws + k * kScWP + m, src, ok ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < kScK * kTcCo; e += kTcThreads) {
      const int m = e % kTcCo, k = e / kTcCo;
      const int tap = k / 8, ci = k % 8, co = co0 + m;
      ws[k * kScWP + m] = (tap < 9 && ci < cin && co < cout)
                              ? w[(static_cast<size_t>(tap) * cin + ci) * cout + co]
                              : __float2bfloat16(0.f);
    }
  }
  // halo: xs[rr][p][s] holds channels (2p, 2p + 1) of input row f_first + rr
  // at frame t0 - 8 + s, zero outside the input and past Cin
  if (t_dim % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    // kScInFlight items a thread in flight: all loads, then all stores
    const int items = rows * kScPairs * kTcGroups;
    for (int e0 = threadIdx.x; e0 < items; e0 += kScInFlight * kTcThreads) {
      uint4 lo[kScInFlight], hi[kScInFlight];
#pragma unroll
      for (int j = 0; j < kScInFlight; ++j) {
        const int e = e0 + j * kTcThreads;
        const int g = e % kTcGroups, rest = e / kTcGroups;
        const int ci = 2 * (rest % kScPairs), f = f_first + rest / kScPairs;
        const int t = t0 - 8 + 8 * g;
        lo[j] = hi[j] = make_uint4(0u, 0u, 0u, 0u);
        if (e < items && f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
          const uint16_t* src = xb + ci * plane + static_cast<size_t>(f) * t_dim + t;
          lo[j] = __ldg(reinterpret_cast<const uint4*>(src));
          if (ci + 1 < cin) hi[j] = __ldg(reinterpret_cast<const uint4*>(src + plane));
        }
      }
#pragma unroll
      for (int j = 0; j < kScInFlight; ++j) {
        const int e = e0 + j * kTcThreads;
        if (e >= items) break;
        const int g = e % kTcGroups, rest = e / kTcGroups;
        uint4* dst = reinterpret_cast<uint4*>(xs + rest * kTcXS + 8 * g);
        const uint4 l = lo[j], h = hi[j];
        dst[0] = make_uint4(__byte_perm(l.x, h.x, 0x5410), __byte_perm(l.x, h.x, 0x7632),
                            __byte_perm(l.y, h.y, 0x5410), __byte_perm(l.y, h.y, 0x7632));
        dst[1] = make_uint4(__byte_perm(l.z, h.z, 0x5410), __byte_perm(l.z, h.z, 0x7632),
                            __byte_perm(l.w, h.w, 0x5410), __byte_perm(l.w, h.w, 0x7632));
      }
    }
  } else {   // frames t0 - 1 .. t0 + kTcT one word at a time
    for (int e = threadIdx.x; e < rows * kScPairs * kTcXT; e += kTcThreads) {
      const int s = e % kTcXT, rest = e / kTcXT;
      const int ci = 2 * (rest % kScPairs), f = f_first + rest / kScPairs;
      const int t = t0 - 1 + s;
      uint32_t v = 0;
      if (f >= 0 && f < f_dim && t >= 0 && t < t_dim && ci < cin) {
        const uint16_t* src = xb + ci * plane + static_cast<size_t>(f) * t_dim + t;
        v = __ldg(src);
        if (ci + 1 < cin) v |= static_cast<uint32_t>(__ldg(src + plane)) << 16;
      }
      xs[rest * kTcXS + s + 7] = v;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // A fragments of the five steps: a[s][mi] covers Cout warp_m * 32 + 16 mi ..
  // and weight rows 16 s .. 16 s + 15 (ldmatrix.trans of ws[k][co])
  uint32_t a[kScSteps][2][4];
  {
    const int q = lane / 8, r = lane % 8;
#pragma unroll
    for (int st = 0; st < kScSteps; ++st)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_t(ws + (st * 16 + (q / 2) * 8 + r) * kScWP + warp_m * 32 + mi * 16 + (q % 2) * 8,
                  a[st][mi]);
  }

  // relu output is >= 0, so 0 is the identity of the running max
  float best[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[mi][ni][e] = 0.f;

  // B of tap (dy, dx) at n8 tile ni: channels (2q, 2q + 1) at frame
  // t0 + n + dx - 1 of conv row r's input row r + dy (q = lane % 4, n = lane / 4)
  const uint32_t* xq = xs + (lane % 4) * kTcXS + warp_n * 32 + lane / 4 + 7;
#pragma unroll 1
  for (int r = 0; r < pf; ++r) {
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    const uint32_t* xr = xq + r * kScRowWords;
#pragma unroll
    for (int st = 0; st < kScSteps; ++st) {
      const int tap0 = 2 * st, tap1 = min(2 * st + 1, 8);   // tap 9: zero weights
      const uint32_t* x0 = xr + (tap0 / 3) * kScRowWords + tap0 % 3;
      const uint32_t* x1 = xr + (tap1 / 3) * kScRowWords + tap1 % 3;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t b0 = x0[ni * 8], b1 = x1[ni * 8];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[st][mi], b0, b1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = min(co0 + tc_m(warp_m, lane, mi, 2 * h), cout - 1);
        const float sc = __ldg(scale + co), bi = __ldg(bias + co);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
            best[mi][ni][2 * h + e2] =
                fmaxf(best[mi][ni][2 * h + e2], bn_relu(acc[mi][ni][2 * h + e2], sc, bi));
      }
  }

  // out (B, Cout, F / pf, T): two frames per store where T is even
  const bool pairs = t_dim % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + tc_m(warp_m, lane, mi, 2 * h);
      if (co >= cout) continue;
      bf16* orow = out + ((static_cast<size_t>(b) * cout + co) * f_out + fo) * t_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int t = t0 + tc_n(warp_n, lane, ni, 0);
        const float* v = best[mi][ni] + 2 * h;
        if (pairs) {
          if (t < t_dim)
            *reinterpret_cast<__nv_bfloat162*>(orow + t) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (t < t_dim) orow[t] = __float2bfloat16(v[0]);
          if (t + 1 < t_dim) orow[t + 1] = __float2bfloat16(v[1]);
        }
      }
    }
}

cudaError_t launch_smallcin_tc(const void* x, const void* w, const float* scale,
                               const float* bias, void* out, int batch, int cin, int f_dim,
                               int t_dim, int cout, int pf, cudaStream_t stream) {
  const size_t smem = smallcin_tc_smem_bytes(pf);
  cudaError_t err = set_smem(smallcin_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kTcT), ceil_div(cout, kTcCo), batch * (f_dim / pf));
  smallcin_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias,
      static_cast<bf16*>(out), cin, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

template <typename T, bool kSmall, int CC>
cudaError_t launch_cc(const void* x, const void* w, const float* scale, const float* bias,
                      void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                      cudaStream_t stream) {
  const int rows = kSmall ? pf + 2 : 3;
  const size_t smem = sizeof(float) * (rows * CC * kXW + 9 * CC * kBCO);
  cudaError_t err = set_smem(conv3x3_kernel<T, kSmall, CC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kBT), ceil_div(cout, kBCO), batch * (f_dim / pf));
  conv3x3_kernel<T, kSmall, CC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(out), cin, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* x, const void* w, const float* scale, const float* bias,
                      void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<false>();
  cudaError_t err = set_smem(conv3x3_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kTcT), ceil_div(cout, kTcCo), batch * (f_dim / pf));
  conv3x3_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias,
      static_cast<bf16*>(out), cin, f_dim, t_dim, cout, pf);
  return cudaGetLastError();
}

template <typename T, bool kSmall>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* bias,
                   void* out, int batch, int cin, int f_dim, int t_dim, int cout, int pf,
                   cudaStream_t stream) {
  if constexpr (!kSmall && sizeof(T) == 2) {
    return launch_tc(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, stream);
  } else {
    if (kSmall && sizeof(T) == 2 && cin <= kCC)
      return launch_smallcin_tc(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf,
                                stream);
    if (kSmall && cin > kCC)
      return launch_cc<T, true, 2 * kCC>(x, w, scale, bias, out, batch, cin, f_dim, t_dim,
                                         cout, pf, stream);
    return launch_cc<T, kSmall, kCC>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout,
                                     pf, stream);
  }
}

template <bool kSmall>
int dispatch(const void* x, const void* w, const void* scale, const void* bias, void* out,
             int batch, int cin, int f_dim, int t_dim, int cout, int pf, int dtype,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (cin < 1 || cout < 1 || pf < 1 || f_dim % pf || (kSmall && cin > kMaxStagedCin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float, kSmall>(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout, pf, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16, kSmall>(x, w, sc, bi, out, batch, cin, f_dim, t_dim, cout,
                                        pf, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Cin <= 10: every tap and channel staged once (K = 72, or 144 past Cin 8).
extern "C" int seld_conv3x3_smallcin(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int batch, int cin,
                                     int f_dim, int t_dim, int cout, int pf, int dtype,
                                     void* stream) {
  return dispatch<true>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, dtype,
                        stream);
}

// Cin walked in chunks (8 in float32, 16 on bfloat16's tensor cores), the
// last one ragged (K3 routes Cin % 8 == 0).
extern "C" int seld_conv3x3_widecin(const void* x, const void* w, const void* scale,
                                    const void* bias, void* out, int batch, int cin,
                                    int f_dim, int t_dim, int cout, int pf, int dtype,
                                    void* stream) {
  return dispatch<false>(x, w, scale, bias, out, batch, cin, f_dim, t_dim, cout, pf, dtype,
                         stream);
}
