// Unmasked multi-head self-attention forward with an online softmax, plus
// the per-row logsumexp.
//
// Replaces seld_tpu/ops/pallas/attention.py::flash_attention's forward
// (_flash_forward -> _flash_kernel). Contract: q, k, v (B, T, H, D) -> out
// (B, T, H, D) = softmax(q k^T * scale) v per (b, h), and lse (B, H, T) float
// = the row logsumexp of q k^T * scale (kept for a backward pass).
//
// What bounds it on the H100: arithmetic and the exp per score
// (4*B*H*T^2*D FLOP; at T = 2400, D = 48 that is 0.9 GFLOP per head), not
// memory: q, k, v and out are 4 * T * D elements per head and the (T, T)
// score matrix is never written. Design: one block per (b*h, 64-query tile),
// 256 threads, four per query row. The block streams 64-key tiles of K and V
// through shared memory; each thread scores 16 keys of its row, the row's
// max and sum are reduced across its four threads with warp shuffles, and
// the running max, sum and the D-wide output accumulator (D/4 floats per
// thread) are kept in float. D = 48 is handled natively: the TPU kernel's
// padding of D to 128 was a lane-width rule. The ragged last key tile is
// masked to -inf before the max; query rows past T are computed on zeros and
// not stored. SIMT FMA: mma/wgmma tiles are a later step.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;   // four per query row

template <int D>
constexpr size_t smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int t_dim, int heads,
                 float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);          // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);          // [kBK][D]
  float* ps = vs + kBK * D;                // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int row = tid / 4;
  const int sub = tid % 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  // element (b, t, h, d) of a (B, T, H, D) tensor
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qs[r * (D + 1) + d] = q0 + r < t_dim ? to_f(q[base + (q0 + r) * tstride + d]) : 0.f;
  }

  constexpr int kE = D / 4;   // output lanes per thread: d = sub + 4 e
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int k0 = 0; k0 < t_dim; k0 += kBK) {
    __syncthreads();   // previous tile's readers are done (and qs is staged)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < t_dim;
      const size_t off = base + (k0 + r) * tstride + d;
      ks[r * (D + 1) + d] = ok ? to_f(k[off]) : 0.f;
      vs[r * D + d] = ok ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
    float smax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int c = sub + 4 * j;
      const float* qr = qs + row * (D + 1);
      const float* kr = ks + c * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s[j] = k0 + c < t_dim ? dot * scale : -CUDART_INF_F;
      smax = fmaxf(smax, s[j]);
    }
    smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 1));
    smax = fmaxf(smax, __shfl_xor_sync(0xffffffffu, smax, 2));
    const float m_new = fmaxf(m, smax);   // finite: every tile holds a valid key
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      ps[row * (kBK + 1) + sub + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= alpha;
    __syncwarp();   // a row's four threads share one warp and one ps row
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[row * (kBK + 1) + c];
      const float* vr = vs + c * D + sub;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = fmaf(p, vr[4 * e], acc[e]);
    }
  }

  const int t = q0 + row;
  if (t < t_dim) {
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < kE; ++e) store_f(out + base + t * tstride + sub + 4 * e, acc[e] * inv);
    if (sub == 0) lse[static_cast<size_t>(bh) * t_dim + t] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int batch, int t_dim, int heads, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = set_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kBQ), batch * heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, t_dim, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse,
                       int batch, int t_dim, int heads, int d, float scale,
                       cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 48: return launch<T, 48>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Head dims supported: 16, 32, 48, 64, 128.
extern "C" int seld_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int batch, int t_dim, int heads, int d,
                                   float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_d<float>(q, k, v, out, l, batch, t_dim, heads, d, scale, s);
  else if (dtype == kBF16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, l, batch, t_dim, heads, d, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
