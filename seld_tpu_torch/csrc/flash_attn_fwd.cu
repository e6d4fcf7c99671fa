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
// score matrix is never written. D = 48 is handled natively: the TPU
// kernel's padding of D to 128 was a lane-width rule. The ragged last key
// tile is masked to -inf before the max; query rows past T are computed on
// zeros and not stored.
//
// bfloat16: FlashAttention-2 on the tensor cores (flash_fwd_tc_kernel, on
// the tiles of flash_attn_tc.cuh, which K6's backward shares). One
// block per (b*h, 64-query tile), 4 warps of 16 query rows each; Q's
// fragments stay in registers. 64-key tiles of K and V stream through a
// two-stage cp.async ring (the next tile loads while this one multiplies).
// S = Q K^T is mma.sync.m16n8k16 with float accumulators (D in {16, 32, 48,
// 64, 128}, all multiples of 16); the online softmax runs on the
// accumulator fragments (row max and sum across the four lanes of a quad,
// exp2f with scale * log2(e) folded in, each thread's share of the row sum
// reduced once at the end); P is rounded to bf16 in registers and fed
// straight back as the A operand of O += P V (no shared-memory round trip).
// Rounding P to bf16 departs from the JAX kernel, which multiplies a float p
// (seld_tpu/ops/pallas/attention.py:52-56); it stays within the bf16
// tolerance (2e-2 x max|ref|), as the plain version, which rounds the
// normalized probabilities to v's dtype, shows on the card.
//
// float32: the SIMT kernel (flash_fwd_kernel): 256 threads, four per query
// row; each thread scores 16 keys of its row, the row's max and sum are
// reduced across its four threads with warp shuffles, and the running max,
// sum and the D-wide output accumulator (D/4 floats per thread) are kept in
// float; TF32 stays off.
#include <math_constants.h>

#include "common.cuh"
#include "flash_attn_tc.cuh"

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

// ---- bfloat16: FlashAttention-2 on mma.sync.m16n8k16 ----------------------

constexpr int kTcQ = kAttnRows;   // queries per block: 4 warps x 16 rows
constexpr int kTcK = kAttnRows;   // keys per tile
constexpr int kTcThreads = kAttnThreads;

template <int D>
constexpr size_t tc_smem_bytes() {   // q, then two (k, v) stages, rows padded to D + 8
  return sizeof(bf16) * 5 * kTcQ * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int t_dim, int heads, float scale_log2) {
  constexpr int kP = D + 8;   // padded row: 16-byte units odd, so ldmatrix phases do not conflict
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [kTcQ][kP]
  bf16* kv = qs + kTcQ * kP;                     // per stage: k [kTcK][kP], v [kTcK][kP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, quad = lane % 4;
  const int q0 = blockIdx.x * kTcQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int n_tiles = ceil_div(t_dim, kTcK);

  attn_load_rows<D>(qs, q, base, tstride, q0, t_dim);
  attn_load_rows<D>(kv, k, base, tstride, 0, t_dim);
  attn_load_rows<D>(kv + kTcK * kP, v, base, tstride, 0, t_dim);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 of D
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) attn_ldsm_a<D>(qs, kd, qf[kd]);
  const auto qfrag = [&](int kd, uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
  };

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows g and g + 8, in log2 units
  float l_run[2] = {0.f, 0.f};                       // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const bf16* ks = kv + (j & 1) * 2 * kTcK * kP;
    const bf16* vs = ks + kTcK * kP;
    if (j + 1 < n_tiles) {   // the next tile loads while this one multiplies
      bf16* nk = kv + ((j + 1) & 1) * 2 * kTcK * kP;
      attn_load_rows<D>(nk, k, base, tstride, (j + 1) * kTcK, t_dim);
      attn_load_rows<D>(nk + kTcK * kP, v, base, tstride, (j + 1) * kTcK, t_dim);
      cp_async_commit();
    }
    // S = Q K^T for 64 keys: eight m16n8 fragments
    float s[kTcK / 8][4];
    attn_mma_abt<D>(s, qfrag, ks);
    // the online softmax on the fragments: keys past T masked to -inf
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kTcK + nt * 8 + 2 * quad + (e % 2);
        s[nt][e] = key < t_dim ? s[nt][e] * scale_log2 : -CUDART_INF_F;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);   // finite: every tile holds a key
      alpha[hh] = exp2f(m_run[hh] - m_new);
      m_run[hh] = m_new;
      l_run[hh] *= alpha[hh];
    }
#pragma unroll
    for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_run[e / 2]);
        l_run[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];
    // O += P V, P rounded to bf16 in registers as the A operand
    attn_mma_pv<D>(o, s, vs);
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= t_dim) continue;
    const float inv = 1.f / l;
    bf16* orow = out + base + static_cast<size_t>(t) * tstride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * quad) =
          __floats2bfloat162_rn(o[dt][2 * hh] * inv, o[dt][2 * hh + 1] * inv);
    if (quad == 0)
      lse[static_cast<size_t>(bh) * t_dim + t] = (m_run[hh] + log2f(l)) * 0.69314718055994531f;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int batch, int t_dim, int heads, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    const void* rows[] = {q, k, v, out};   // 16-byte copies and bf16x2 stores
    for (const void* p : rows)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
    constexpr size_t smem = tc_smem_bytes<D>();
    cudaError_t err = set_smem(flash_fwd_tc_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(ceil_div(t_dim, kTcQ), batch * heads);
    flash_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), lse, t_dim, heads, scale * 1.4426950408889634f);
  } else {
    const size_t smem = sizeof(float) * smem_floats<D>();
    cudaError_t err = set_smem(flash_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(ceil_div(t_dim, kBQ), batch * heads);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, t_dim, heads, scale);
  }
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
