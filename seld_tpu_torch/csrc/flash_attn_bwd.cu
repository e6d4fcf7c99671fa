// Unmasked multi-head self-attention backward (FlashAttention-2), from the
// forward's per-row logsumexp.
//
// Replaces seld_tpu/ops/pallas/attention.py::_flash_backward (the delta
// epilogue of _flash_core_bwd, _flash_dq_kernel and _flash_dkv_kernel).
// Contract: q, k, v, out, dout (B, T, H, D) and lse (B, H, T) float ->
// dq, dk, dv (B, T, H, D) in q's dtype, with P = exp(q k^T * scale - lse):
//   delta = rowsum(dout * out), dS = P * (dout v^T - delta),
//   dq = dS k * scale, dk = dS^T q * scale, dv = P^T dout.
// The scale enters the scores and is applied once more at the end of dq and
// dk (attention.py:102,139).
//
// What bounds it on the H100: arithmetic and the exp per score (each pass
// recomputes P: 14 * B * H * T^2 * D FLOP in all, 1.6 GFLOP per head at
// T = 2400, D = 48), not memory: no (T, T) tensor is written. Design, three
// launches on one stream:
// - delta: one thread per (b, t, h) row, float;
// - dq: one block per (b*h, 64-query tile), four threads per query row as
//   in the forward (csrc/flash_attn_fwd.cu); the block streams 64-key tiles
//   of K and V through shared memory, each thread scores 16 keys of its
//   row (s and dout . v), writes dS to a shared tile and accumulates its
//   D/4 lanes of dq in float;
// - dk/dv: one block per (b*h, 64-key tile), four threads per key row,
//   streaming 64-query tiles of q, dout, lse and delta; P^T and dS^T go
//   through shared tiles into the float dk and dv accumulators.
// T = 2400 is not a multiple of 64: keys (dq pass) and queries (dk/dv pass)
// past T get a score of -inf before the exp, so they add exactly nothing.
// SIMT FMA: mma/wgmma tiles are a later step.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kB = 64;          // queries or keys per block and per streamed tile
constexpr int kThreads = 256;   // four per row
constexpr int kPW = kB + 1;     // padded row of the shared P / dS tiles

template <typename T>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, int rows, int t_dim, int heads,
                             int d) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;   // row (b, t, h) of (B, T, H, D)
  if (r >= rows) return;
  const size_t off = static_cast<size_t>(r) * d;
  float s = 0.f;
  for (int e = 0; e < d; ++e) s = fmaf(to_f(dout[off + e]), to_f(out[off + e]), s);
  const int h = r % heads;
  const int t = (r / heads) % t_dim;
  const int b = r / (heads * t_dim);
  delta[(static_cast<size_t>(b) * heads + h) * t_dim + t] = s;
}

// rows [r0, r0 + kB) of a (B, T, H, D) tensor at (b, h) into dst[kB][ld]; zeros past T
template <typename T, int D>
static __device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                                  const T* __restrict__ src, size_t base,
                                                  size_t tstride, int r0, int t_dim) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * ld + c] = r0 + r < t_dim ? to_f(src[base + (r0 + r) * tstride + c]) : 0.f;
  }
}

template <int D>
static __device__ __forceinline__ float dot_row(const float* __restrict__ a,
                                                const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int t_dim, int heads,
          float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [kB][D + 1]
  float* dos = qs + kB * (D + 1);   // [kB][D + 1]
  float* ks = dos + kB * (D + 1);   // [kB][D + 1]
  float* vs = ks + kB * (D + 1);    // [kB][D + 1]
  float* dss = vs + kB * (D + 1);   // [kB][kPW]

  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int q0 = blockIdx.x * kB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int t = q0 + row;
  const float lse_r = t < t_dim ? lse[static_cast<size_t>(bh) * t_dim + t] : 0.f;
  const float delta_r = t < t_dim ? delta[static_cast<size_t>(bh) * t_dim + t] : 0.f;

  stage_rows<T, D>(qs, D + 1, q, base, tstride, q0, t_dim);
  stage_rows<T, D>(dos, D + 1, dout, base, tstride, q0, t_dim);

  constexpr int kE = D / 4;   // dq lanes per thread: d = sub + 4 e
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < t_dim; k0 += kB) {
    __syncthreads();   // the previous tile's readers are done (and q, dout are staged)
    stage_rows<T, D>(ks, D + 1, k, base, tstride, k0, t_dim);
    stage_rows<T, D>(vs, D + 1, v, base, tstride, k0, t_dim);
    __syncthreads();
    const float* qr = qs + row * (D + 1);
    const float* dr = dos + row * (D + 1);
#pragma unroll 4
    for (int j = 0; j < kB / 4; ++j) {
      const int c = sub + 4 * j;
      const float s = k0 + c < t_dim ? dot_row<D>(qr, ks + c * (D + 1)) * scale : -CUDART_INF_F;
      const float p = expf(s - lse_r);
      const float dp = dot_row<D>(dr, vs + c * (D + 1));
      dss[row * kPW + c] = p * (dp - delta_r);
    }
    __syncwarp();   // a row's four threads share one warp and one dS row
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      const float ds = dss[row * kPW + c];
      const float* kr = ks + c * (D + 1) + sub;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = fmaf(ds, kr[4 * e], acc[e]);
    }
  }
  if (t < t_dim) {
#pragma unroll
    for (int e = 0; e < kE; ++e) store_f(dq + base + t * tstride + sub + 4 * e, acc[e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int t_dim,
           int heads, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [kB][D + 1]
  float* vs = ks + kB * (D + 1);    // [kB][D + 1]
  float* qs = vs + kB * (D + 1);    // [kB][D + 1]
  float* dos = qs + kB * (D + 1);   // [kB][D + 1]
  float* ls = dos + kB * (D + 1);   // [kB] lse of the query tile
  float* dls = ls + kB;             // [kB] delta of the query tile
  float* pts = dls + kB;            // [kB keys][kPW queries]
  float* dsts = pts + kB * kPW;     // [kB keys][kPW queries]

  const int tid = threadIdx.x, row = tid / 4, sub = tid % 4;
  const int k0 = blockIdx.x * kB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;

  stage_rows<T, D>(ks, D + 1, k, base, tstride, k0, t_dim);
  stage_rows<T, D>(vs, D + 1, v, base, tstride, k0, t_dim);

  constexpr int kE = D / 4;
  float dk_acc[kE], dv_acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  for (int q0 = 0; q0 < t_dim; q0 += kB) {
    __syncthreads();
    stage_rows<T, D>(qs, D + 1, q, base, tstride, q0, t_dim);
    stage_rows<T, D>(dos, D + 1, dout, base, tstride, q0, t_dim);
    if (tid < kB) {
      const bool ok = q0 + tid < t_dim;
      ls[tid] = ok ? lse[static_cast<size_t>(bh) * t_dim + q0 + tid] : 0.f;
      dls[tid] = ok ? delta[static_cast<size_t>(bh) * t_dim + q0 + tid] : 0.f;
    }
    __syncthreads();
    const float* kr = ks + row * (D + 1);
    const float* vr = vs + row * (D + 1);
#pragma unroll 4
    for (int j = 0; j < kB / 4; ++j) {
      const int c = sub + 4 * j;
      const float s = q0 + c < t_dim ? dot_row<D>(kr, qs + c * (D + 1)) * scale : -CUDART_INF_F;
      const float p = expf(s - ls[c]);
      const float dp = dot_row<D>(vr, dos + c * (D + 1));
      pts[row * kPW + c] = p;
      dsts[row * kPW + c] = p * (dp - dls[c]);
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      const float p = pts[row * kPW + c];
      const float ds = dsts[row * kPW + c];
      const float* dr = dos + c * (D + 1) + sub;
      const float* qr = qs + c * (D + 1) + sub;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        dv_acc[e] = fmaf(p, dr[4 * e], dv_acc[e]);
        dk_acc[e] = fmaf(ds, qr[4 * e], dk_acc[e]);
      }
    }
  }
  const int t = k0 + row;
  if (t < t_dim) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      store_f(dk + base + t * tstride + sub + 4 * e, dk_acc[e] * scale);
      store_f(dv + base + t * tstride + sub + 4 * e, dv_acc[e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int batch, int t_dim, int heads, float scale, cudaStream_t s) {
  const int rows = batch * t_dim * heads;
  delta_kernel<T><<<ceil_div(rows, 256), 256, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows, t_dim, heads, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid(ceil_div(t_dim, kB), batch * heads);
  const size_t smem_dq = sizeof(float) * (4 * kB * (D + 1) + kB * kPW);
  err = set_smem(dq_kernel<T, D>, smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<grid, kThreads, smem_dq, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), t_dim, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkv = sizeof(float) * (4 * kB * (D + 1) + 2 * kB + 2 * kB * kPW);
  err = set_smem(dkv_kernel<T, D>, smem_dkv);
  if (err != cudaSuccess) return err;
  dkv_kernel<T, D><<<grid, kThreads, smem_dkv, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      t_dim, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int batch, int t_dim, int heads, int d, float scale,
                       cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 48: return launch<T, 48>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Head dims supported: 16, 32, 48, 64, 128. delta: (B, H, T) float scratch.
extern "C" int seld_flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int batch, int t_dim, int heads, int d,
                                   float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_d<float>(q, k, v, out, dout, l, dl, dq, dk, dv, batch, t_dim, heads, d,
                            scale, s);
  else if (dtype == kBF16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, batch, t_dim,
                                    heads, d, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
