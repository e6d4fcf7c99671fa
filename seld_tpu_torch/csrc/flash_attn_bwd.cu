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
// T = 2400, D = 48), not memory: no (T, T) tensor is written. Three launches
// on one stream, two passes and no atomics (as the JAX kernel), so a rerun
// is bitwise equal:
// - delta: one thread per (b, t, h) row, float, a pass over out and dout;
// - dq: one block per (b*h, 64-query tile), streaming 64-key tiles of K, V;
// - dk/dv: one block per (b*h, 64-key tile), streaming 64-query tiles of Q,
//   dO, lse and delta.
// T = 2400 is not a multiple of 64: keys (dq pass) and queries (dk/dv pass)
// past T get P = 0 (the exp of a -inf score), so they add exactly nothing;
// rows past T read lse and delta as 0 and are not stored.
//
// Head dims past 128 take the wide kernels below: D a multiple of 32, one
// column group of up to 256 gradient columns a block, S and dP once per
// group; in bfloat16 flash_dq_wide_tc_kernel and flash_dkv_wide_tc_kernel,
// in float32 flash_dq_wide_tf32_kernel and flash_dkv_wide_tf32_kernel (the
// same plan in split TF32).
//
// bfloat16: FlashAttention-2's backward on the tensor cores
// (flash_dq_tc_kernel, flash_dkv_tc_kernel), built on K4's tiles
// (flash_attn_tc.cuh): 4 warps of 16 rows, the block's own Q and dO (dq
// pass) or K and V (dk/dv pass) fragments in registers (reloaded from shared
// memory at D = 128, where the dk and dv accumulators take 128 floats a
// thread), the streamed tiles through a two-stage cp.async ring, every
// product on mma.sync.m16n8k16 with float accumulators. The dk/dv pass
// computes S^T = K Q^T and dP^T = V dO^T directly (as _flash_dkv_kernel,
// attention.py:121-133), so P^T and dS^T come out in the accumulator layout
// that is already the A operand of dV += P^T dO and dK += dS^T Q: no
// shared-memory round trip, as K4 reuses P. A departure from the reference:
// P and dS are rounded to bf16 before their products, where the JAX kernel
// multiplies a float p and ds (attention.py:95-98, :124-134); the result
// stays within the bf16 tolerance (2e-2 x max|ref|) of
// flash_attention_bwd_plain on the card, at every head dim and ragged T.
//
// float32: the same two passes on the tensor cores in split TF32
// (flash_dq_tf32_kernel, flash_dkv_tf32_kernel), see below.
#include <math_constants.h>

#include "flash_attn_tc.cuh"

namespace {


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

// delta of the wide kernels: one warp per (b, t, h) row, 16-byte loads of
// out and dout across the lanes (d a multiple of 8), float sums reduced by
// shuffles (delta_kernel's one thread per row reads each row's own
// addresses, which no two lanes of a warp share).
static __device__ __forceinline__ float dot16(const uint4& o, const uint4& g, float s,
                                              const bf16*) {
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 of = __bfloat1622float2(o2[i]), gf = __bfloat1622float2(g2[i]);
    s = fmaf(gf.x, of.x, fmaf(gf.y, of.y, s));
  }
  return s;
}

static __device__ __forceinline__ float dot16(const uint4& o, const uint4& g, float s,
                                              const float*) {
  const float4 of = *reinterpret_cast<const float4*>(&o), gf = *reinterpret_cast<const float4*>(&g);
  return fmaf(gf.x, of.x, fmaf(gf.y, of.y, fmaf(gf.z, of.z, fmaf(gf.w, of.w, s))));
}

template <typename T>
__global__ void delta_rows_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                  float* __restrict__ delta, int rows, int t_dim, int heads,
                                  int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t off = static_cast<size_t>(r) * d;
  float s = 0.f;
  for (int c = kVec * lane; c < d; c += 32 * kVec)
    s = dot16(*reinterpret_cast<const uint4*>(out + off + c),
              *reinterpret_cast<const uint4*>(dout + off + c), s, out);
#pragma unroll
  for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    const int h = r % heads, t = (r / heads) % t_dim, b = r / (heads * t_dim);
    delta[(static_cast<size_t>(b) * heads + h) * t_dim + t] = s;
  }
}

// ---- bfloat16: FlashAttention-2 backward on mma.sync.m16n8k16 ------------

constexpr int kTcB = kAttnRows;   // queries (dq pass) or keys (dk/dv pass) per block
constexpr float kLog2e = 1.4426950408889634f;

// q, dout [64][D + 8], then two stages of (k, v) [64][D + 8]
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return sizeof(bf16) * 6 * kTcB * (D + 8);
}

// k, v [64][D + 8], two stages of (q, dout) [64][D + 8], two of (lse, delta) [64] floats
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return sizeof(bf16) * 6 * kTcB * (D + 8) + sizeof(float) * 4 * kTcB;
}

// The A fragments of this warp's rows of a staged tile; (kd, a) hands out
// step kd. They stay in registers up to D = 64; at D = 128 they are
// reloaded from the tile for each product, which keeps the dk/dv pass's two
// D-wide accumulators in registers.
template <int D>
struct RowFrags {
  static constexpr bool kRegs = D <= 64;
  uint32_t f[kRegs ? D / 16 : 1][4];
  const bf16* tile;

  __device__ __forceinline__ explicit RowFrags(const bf16* t) : tile(t) {
    if constexpr (kRegs) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) attn_ldsm_a<D>(tile, kd, f[kd]);
    }
  }
  __device__ __forceinline__ void operator()(int kd, uint32_t (&a)[4]) const {
    if constexpr (kRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[kd][i];
    } else {
      attn_ldsm_a<D>(tile, kd, a);
    }
  }
};

// rows g and g + 8 of this warp's 16, bf16x2 stores of acc * mul, rows past T skipped
template <int D>
static __device__ __forceinline__ void store_rows(bf16* __restrict__ dst, size_t base,
                                                  size_t tstride, int r0, int t_dim,
                                                  const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r0 + warp * 16 + lane / 4 + 8 * hh;
    if (t >= t_dim) continue;
    bf16* row = dst + base + static_cast<size_t>(t) * tstride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[dt][2 * hh] * mul, acc[dt][2 * hh + 1] * mul);
  }
}

template <int D>
static __device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
}

// dq rows [q0, q0 + 64) of one (b, h): 4 warps x 16 query rows, Q and dO
// fragments kept, 64-key tiles of K and V through a two-stage cp.async ring.
// Per tile: S = Q K^T and dP = dO V^T (float accumulators), P = exp2(S *
// scale * log2 e - lse * log2 e) with keys past T at P = 0, dS = P (dP -
// delta), then dQ += dS K with dS rounded to bf16 as the A operand and K
// read transposed by ldmatrix.trans from its [key][d] tile.
template <int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int t_dim, int heads, float scale, float scale_log2) {
  constexpr int kP = D + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [64][kP]
  bf16* dos = qs + kTcB * kP;                    // [64][kP]
  bf16* kv = dos + kTcB * kP;                    // per stage: k [64][kP], v [64][kP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int q0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int n_tiles = ceil_div(t_dim, kTcB);

  attn_load_rows<D>(qs, q, base, tstride, q0, t_dim);
  attn_load_rows<D>(dos, dout, base, tstride, q0, t_dim);
  attn_load_rows<D>(kv, k, base, tstride, 0, t_dim);
  attn_load_rows<D>(kv + kTcB * kP, v, base, tstride, 0, t_dim);
  cp_async_commit();
  float lse2[2], dl[2];   // rows g and g + 8: lse in log2 units, delta; 0 past T
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + warp * 16 + lane / 4 + 8 * hh;
    const size_t at = static_cast<size_t>(bh) * t_dim + t;
    lse2[hh] = t < t_dim ? lse[at] * kLog2e : 0.f;
    dl[hh] = t < t_dim ? delta[at] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  const RowFrags<D> qf(qs), df(dos);

  float acc[D / 8][4];
  zero_acc<D>(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const bf16* ks = kv + (j & 1) * 2 * kTcB * kP;
    const bf16* vs = ks + kTcB * kP;
    if (j + 1 < n_tiles) {   // the next tile loads while this one multiplies
      bf16* nk = kv + ((j + 1) & 1) * 2 * kTcB * kP;
      attn_load_rows<D>(nk, k, base, tstride, (j + 1) * kTcB, t_dim);
      attn_load_rows<D>(nk + kTcB * kP, v, base, tstride, (j + 1) * kTcB, t_dim);
      cp_async_commit();
    }
    float s[kTcB / 8][4], dp[kTcB / 8][4];
    attn_mma_abt<D>(s, qf, ks);
    attn_mma_abt<D>(dp, df, vs);
#pragma unroll
    for (int nt = 0; nt < kTcB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kTcB + nt * 8 + 2 * quad + (e % 2);
        const float p = key < t_dim ? exp2f(s[nt][e] * scale_log2 - lse2[e / 2]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[e / 2]);   // dS
      }
    attn_mma_pv<D>(acc, s, ks);   // dQ += dS K
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }
  store_rows<D>(dq, base, tstride, q0, t_dim, acc, scale);
}

// dk, dv rows [k0, k0 + 64) of one (b, h): 4 warps x 16 key rows, K and V
// fragments kept, 64-query tiles of Q and dO (and their lse, delta) through
// a two-stage ring. Per tile the transposed products come straight out of
// the accumulators: S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T * scale *
// log2 e - lse * log2 e) (queries past T at P = 0), dS^T = P^T (dP^T -
// delta); P^T and dS^T are already the A operands of dV += P^T dO and dK +=
// dS^T Q (Q and dO read transposed by ldmatrix.trans).
template <int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int t_dim, int heads,
                    float scale, float scale_log2) {
  constexpr int kP = D + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);   // [64][kP]
  bf16* vs = ks + kTcB * kP;                     // [64][kP]
  bf16* qd = vs + kTcB * kP;                     // per stage: q [64][kP], dout [64][kP]
  float* stats = reinterpret_cast<float*>(qd + 4 * kTcB * kP);   // per stage: lse2, delta [64]
  const int lane = threadIdx.x % 32, quad = lane % 4;
  const int k0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int n_tiles = ceil_div(t_dim, kTcB);
  // threads 0-63 carry a query's lse (log2 units), 64-127 its delta; 0 past T
  const float* stat_src = threadIdx.x < kTcB ? lse : delta;
  const float stat_mul = threadIdx.x < kTcB ? kLog2e : 1.f;
  const auto stat = [&](int q0) {
    const int t = q0 + threadIdx.x % kTcB;
    return t < t_dim ? stat_src[static_cast<size_t>(bh) * t_dim + t] * stat_mul : 0.f;
  };

  attn_load_rows<D>(ks, k, base, tstride, k0, t_dim);
  attn_load_rows<D>(vs, v, base, tstride, k0, t_dim);
  attn_load_rows<D>(qd, q, base, tstride, 0, t_dim);
  attn_load_rows<D>(qd + kTcB * kP, dout, base, tstride, 0, t_dim);
  cp_async_commit();
  stats[threadIdx.x] = stat(0);
  cp_async_wait_all();
  __syncthreads();
  const RowFrags<D> kf(ks), vf(vs);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);
  for (int j = 0; j < n_tiles; ++j) {
    const bf16* qs = qd + (j & 1) * 2 * kTcB * kP;
    const bf16* dos = qs + kTcB * kP;
    const float* ls = stats + (j & 1) * 2 * kTcB;
    const float* dls = ls + kTcB;
    float next_stat = 0.f;
    if (j + 1 < n_tiles) {   // the next tile loads while this one multiplies
      bf16* nq = qd + ((j + 1) & 1) * 2 * kTcB * kP;
      attn_load_rows<D>(nq, q, base, tstride, (j + 1) * kTcB, t_dim);
      attn_load_rows<D>(nq + kTcB * kP, dout, base, tstride, (j + 1) * kTcB, t_dim);
      cp_async_commit();
      next_stat = stat((j + 1) * kTcB);
    }
    float s[kTcB / 8][4], dp[kTcB / 8][4];
    attn_mma_abt<D>(s, kf, qs);    // S^T: rows keys, columns queries
    attn_mma_abt<D>(dp, vf, dos);  // dP^T
#pragma unroll
    for (int nt = 0; nt < kTcB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * quad + (e % 2);
        const float p = j * kTcB + c < t_dim ? exp2f(s[nt][e] * scale_log2 - ls[c]) : 0.f;
        s[nt][e] = p;                       // P^T
        dp[nt][e] = p * (dp[nt][e] - dls[c]);   // dS^T
      }
    attn_mma_pv<D>(dv_acc, s, dos);   // dV += P^T dO
    attn_mma_pv<D>(dk_acc, dp, qs);   // dK += dS^T Q
    if (j + 1 < n_tiles) stats[((j + 1) & 1) * 2 * kTcB + threadIdx.x] = next_stat;
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }
  store_rows<D>(dk, base, tstride, k0, t_dim, dk_acc, scale);
  store_rows<D>(dv, base, tstride, k0, t_dim, dv_acc, 1.f);
}

// ---- float32: the same two passes on mma.sync.m16n8k8.tf32 in split TF32 ----
// flash_dq_tf32_kernel and flash_dkv_tf32_kernel have the bf16 kernels'
// shape: 4 warps of 16 rows, 64-row blocks, the block's own rows (Q and dO,
// or K and V) staged once, the streamed 64-row tiles through a two-stage
// cp.async ring; here every tile is float, [64][D + 4] (D % 4 == 0 at every
// instantiated dim, so rows take 16-byte copies), and every product is
// mma_3xtf32 (mma.cuh): operands split into hi + lo as the fragments are
// read, three TF32 products on float accumulators. TF32's dense rate (494
// TFLOP/s) over three products is ~2.5x the FMA pipes' 67, at float32's
// accuracy. What the design does about the three hazards:
// - Layout. The m16n8k8 accumulator holds columns 2t, 2t + 1 of a row, the
//   A operand columns t, t + 4. P and dS (P^T, dS^T) go straight from the
//   accumulators into the next product's A operand by permuting the keys
//   (queries) of each 8-group: k slot t is key 2t, slot t + 4 key 2t + 1,
//   and the B operand (K, or Q / dO, read as [row][d]) reads rows 2t and 2t
//   + 1 the same way. The sum over keys does not care about their order.
// - Bank conflicts. A row pitch of D + 4 floats is 4 mod 8 words, so the 8
//   rows x 4 columns of a fragment read (S = Q K^T: rows g, columns t) and
//   the 4 row pairs x 8 columns of the permuted one (dQ += dS K: rows 2t, 2t
//   + 1, columns g) each hit 32 distinct banks.
// - Rounding. The tensor cores add a product into its accumulator without
//   rounding to nearest (an ulp of the largest addend lost each time), so
//   every product, S and dP over D as well as dQ (dK, dV) over keys
//   (queries), is summed in two levels (mma_3xtf32_add): each k8 step's
//   three products on the tensor cores from zero, then added to the float
//   accumulator in registers, rounded to nearest (chains of 24 additions,
//   S over D 64 or a 64-row tile's share, strayed several times further
//   from float64 than float32's sums at T 65-200).
//   At D = 128 the dk/dv pass takes each query tile in eight slices of 8
//   (S^T and dP^T 8 floats a thread), which keeps its two 128-column
//   accumulators in registers.
// What bounds it: 14 B H T^2 D multiply-adds a pass pair (the dq pass
// recomputes S and dP), three TF32 products each, the four float additions
// of each k8 step's two-level sum, and the splits (an operand element as it
// is read: cvt.rna for hi, a subtraction, and an add and a mask for lo;
// mma.cuh).
template <int D>
constexpr size_t dq_tf32_smem_bytes() {   // q, dout [64][D + 4]; two stages of (k, v)
  return sizeof(float) * 6 * kTcB * (D + 4);
}

template <int D>
constexpr size_t dkv_tf32_smem_bytes() {   // k, v; two stages of (q, dout) and of (lse, delta)
  return sizeof(float) * (6 * kTcB * (D + 4) + 4 * kTcB);
}

// s (16 x kN) = A B^T over D: A this warp's 16 rows at `a`, B kN rows of a
// tile from `b`; both [row][D + 4]. s[nt] is columns (B rows) 8 nt .. 8 nt + 7.
template <int D, int kN = kTcB>
static __device__ __forceinline__ void tf32_abt(float (&s)[kN / 8][4], const float* __restrict__ a,
                                                const float* __restrict__ b) {
  constexpr int kP = D + 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const float* ar = a + g * kP + t;
  const float* br = b + g * kP + t;
#pragma unroll 2
  for (int kd = 0; kd < D / 8; ++kd) {
    uint32_t ah[4], al[4];
    split_tf32(ar[8 * kd], ah[0], al[0]);
    split_tf32(ar[8 * kP + 8 * kd], ah[1], al[1]);
    split_tf32(ar[8 * kd + 4], ah[2], al[2]);
    split_tf32(ar[8 * kP + 8 * kd + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(br[8 * nt * kP + 8 * kd], bh[0], bl[0]);
      split_tf32(br[8 * nt * kP + 8 * kd + 4], bh[1], bl[1]);
      mma_3xtf32_add(s[nt], ah, al, bh, bl);
    }
  }
}

// o (16 x D) += p (16 x kK, S-shaped accumulators) times kK rows x D of a
// tile from `rows` ([row][D + 4]), keys permuted as above; kC 8-column
// tiles of o at a time (all of D up to 64; at D 128 four, which keeps the
// dk/dv pass's registers from spilling).
template <int D, int kK = kTcB, int kC = (D / 8 <= 8 ? D / 8 : 4)>
static __device__ __forceinline__ void tf32_fold_pv(float (&o)[D / 8][4],
                                                    const float (&p)[kK / 8][4],
                                                    const float* __restrict__ rows) {
  constexpr int kP = D + 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* rr = rows + 2 * t * kP + g;
#pragma unroll
  for (int c0 = 0; c0 < D / 8; c0 += kC)
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk) {
      uint32_t ah[4], al[4];   // slots t, t + 4 = keys 2t, 2t + 1: c0, c2, c1, c3
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
#pragma unroll
      for (int dt = c0; dt < c0 + kC; ++dt) {
        const float* r = rr + 8 * kk * kP + 8 * dt;
        uint32_t bh[2], bl[2];
        split_tf32(r[0], bh[0], bl[0]);
        split_tf32(r[kP], bh[1], bl[1]);
        mma_3xtf32_add(o[dt], ah, al, bh, bl);
      }
    }
}

// rows g and g + 8 of this warp's 16, float2 stores of acc * mul, rows past T skipped
template <int D>
static __device__ __forceinline__ void store_rows_f32(float* __restrict__ dst, size_t base,
                                                      size_t tstride, int r0, int t_dim,
                                                      const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r0 + warp * 16 + lane / 4 + 8 * hh;
    if (t >= t_dim) continue;
    float* row = dst + base + static_cast<size_t>(t) * tstride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(row + dt * 8 + 2 * (lane % 4)) =
          make_float2(acc[dt][2 * hh] * mul, acc[dt][2 * hh + 1] * mul);
  }
}

// dq rows [q0, q0 + 64) of one (b, h). Per 64-key tile: S = Q K^T and dP =
// dO V^T, P = exp(S * scale - lse) with keys past T at P = 0, dS = P (dP -
// delta), then dQ += dS K (the fold above).
template <int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int t_dim, int heads, float scale) {
  constexpr int kP = D + 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* qs = reinterpret_cast<float*>(tc_smem);   // [64][kP]
  float* dos = qs + kTcB * kP;                     // [64][kP]
  float* kv = dos + kTcB * kP;                     // per stage: k [64][kP], v [64][kP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int q0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int n_tiles = ceil_div(t_dim, kTcB);

  tf32_load_rows<D>(qs, q, base, tstride, q0, t_dim);
  tf32_load_rows<D>(dos, dout, base, tstride, q0, t_dim);
  tf32_load_rows<D>(kv, k, base, tstride, 0, t_dim);
  tf32_load_rows<D>(kv + kTcB * kP, v, base, tstride, 0, t_dim);
  cp_async_commit();
  float ls[2], dl[2];   // rows g and g + 8: lse, delta; 0 past T
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + warp * 16 + lane / 4 + 8 * hh;
    const size_t at = static_cast<size_t>(bh) * t_dim + t;
    ls[hh] = t < t_dim ? lse[at] : 0.f;
    dl[hh] = t < t_dim ? delta[at] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  const float* qw = qs + warp * 16 * kP;
  const float* dw = dos + warp * 16 * kP;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const float* ks = kv + (j & 1) * 2 * kTcB * kP;
    const float* vs = ks + kTcB * kP;
    if (j + 1 < n_tiles) {   // the next tile loads while this one multiplies
      float* nk = kv + ((j + 1) & 1) * 2 * kTcB * kP;
      tf32_load_rows<D>(nk, k, base, tstride, (j + 1) * kTcB, t_dim);
      tf32_load_rows<D>(nk + kTcB * kP, v, base, tstride, (j + 1) * kTcB, t_dim);
      cp_async_commit();
    }
    float s[kTcB / 8][4], dp[kTcB / 8][4];
    tf32_abt<D>(s, qw, ks);
    tf32_abt<D>(dp, dw, vs);
#pragma unroll
    for (int nt = 0; nt < kTcB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kTcB + nt * 8 + 2 * quad + (e % 2);
        const float p = key < t_dim ? expf(s[nt][e] * scale - ls[e / 2]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[e / 2]);   // dS
      }
    tf32_fold_pv<D>(acc, s, ks);   // dQ += dS K
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }
  store_rows_f32<D>(dq, base, tstride, q0, t_dim, acc, scale);
}

// dk, dv rows [k0, k0 + 64) of one (b, h). Per 64-query tile: S^T = K Q^T
// and dP^T = V dO^T, P^T = exp(S^T * scale - lse) (queries past T at P =
// 0), dS^T = P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q (the
// fold above).
template <int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int t_dim, int heads,
                      float scale) {
  constexpr int kP = D + 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* ks = reinterpret_cast<float*>(tc_smem);   // [64][kP]
  float* vs = ks + kTcB * kP;                      // [64][kP]
  float* qd = vs + kTcB * kP;                      // per stage: q [64][kP], dout [64][kP]
  float* stats = qd + 4 * kTcB * kP;               // per stage: lse, delta [64]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int k0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int n_tiles = ceil_div(t_dim, kTcB);
  // threads 0-63 carry a query's lse, 64-127 its delta; 0 past T
  const float* stat_src = threadIdx.x < kTcB ? lse : delta;
  const auto stat = [&](int q0) {
    const int t = q0 + threadIdx.x % kTcB;
    return t < t_dim ? stat_src[static_cast<size_t>(bh) * t_dim + t] : 0.f;
  };

  tf32_load_rows<D>(ks, k, base, tstride, k0, t_dim);
  tf32_load_rows<D>(vs, v, base, tstride, k0, t_dim);
  tf32_load_rows<D>(qd, q, base, tstride, 0, t_dim);
  tf32_load_rows<D>(qd + kTcB * kP, dout, base, tstride, 0, t_dim);
  cp_async_commit();
  stats[threadIdx.x] = stat(0);
  cp_async_wait_all();
  __syncthreads();
  const float* kw = ks + warp * 16 * kP;
  const float* vw = vs + warp * 16 * kP;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const float* qs = qd + (j & 1) * 2 * kTcB * kP;
    const float* dos = qs + kTcB * kP;
    const float* lq = stats + (j & 1) * 2 * kTcB;
    const float* dlq = lq + kTcB;
    float next_stat = 0.f;
    if (j + 1 < n_tiles) {   // the next tile loads while this one multiplies
      float* nq = qd + ((j + 1) & 1) * 2 * kTcB * kP;
      tf32_load_rows<D>(nq, q, base, tstride, (j + 1) * kTcB, t_dim);
      tf32_load_rows<D>(nq + kTcB * kP, dout, base, tstride, (j + 1) * kTcB, t_dim);
      cp_async_commit();
      next_stat = stat((j + 1) * kTcB);
    }
    // at D 128 the tile's queries go in eight slices of 8, which keeps S^T
    // and dP^T to 8 registers beside dK's and dV's 128 (with the two-level
    // sums, quarters of 16 spilled)
    constexpr int kH = D < 128 ? kTcB : kTcB / 8;
#pragma unroll 1
    for (int h0 = 0; h0 < kTcB; h0 += kH) {
      float s[kH / 8][4], dp[kH / 8][4];
      tf32_abt<D, kH>(s, kw, qs + h0 * kP);    // S^T: rows keys, columns queries
      tf32_abt<D, kH>(dp, vw, dos + h0 * kP);  // dP^T
#pragma unroll
      for (int nt = 0; nt < kH / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = h0 + nt * 8 + 2 * quad + (e % 2);
          const float p = j * kTcB + c < t_dim ? expf(s[nt][e] * scale - lq[c]) : 0.f;
          s[nt][e] = p;                            // P^T
          dp[nt][e] = p * (dp[nt][e] - dlq[c]);    // dS^T
        }
      tf32_fold_pv<D, kH>(dv_acc, s, dos + h0 * kP);   // dV += P^T dO
      tf32_fold_pv<D, kH>(dk_acc, dp, qs + h0 * kP);   // dK += dS^T Q
    }
    if (j + 1 < n_tiles) stats[((j + 1) & 1) * 2 * kTcB + threadIdx.x] = next_stat;
    cp_async_wait_all();
    __syncthreads();   // the next stage is complete; this one's readers are done
  }
  store_rows_f32<D>(dk, base, tstride, k0, t_dim, dk_acc, scale);
  store_rows_f32<D>(dv, base, tstride, k0, t_dim, dv_acc, 1.f);
}

// ---- head dims past 128, bfloat16: S and dP once per tile pair -------------
// D a multiple of 32 (attention.head_dim_plan), the gradients' columns in
// ceil(D / 256) groups of GW (grid z; the last narrower where GW does not
// divide D). Both passes run 8 warps on 64 rows of one (b, h) and one
// group; warps w and w + 4 share 16 rows (16 (w % 4) ..). For the S-shaped
// products each of the pair takes 32 of the streamed tile's 64 rows
// (32 (w / 4) ..), over all of D, so S and dP of a (query tile, key tile)
// pair are computed once per column group, with no product repeated within
// it. For the accumulators each of the pair owns half of the group's
// columns (GW / 2 = 80-128: GW / 2 floats a thread for dk and dv together),
// which keeps every accumulator in registers where 4 warps would need 256
// floats a thread for the dk/dv pass at GW 256. The pair's P^T and dS^T (or
// dS) go through shared memory as bf16 (16 rows x 64, rounded as K6's D <=
// 128 kernels round them before their products) behind a 64-thread named
// barrier, as FlashAttention-2's head-dim-256 backward stages them. The
// block's own rows (Q and dO, or K and V) are staged once at the whole
// padded D and read by ldmatrix for every tile while they fit (up to D 576
// in the dk/dv pass, 608 in the dq pass); past that they stream with the
// tile, chunk by chunk. The streamed tiles go through a two-stage cp.async
// ring of units, one barrier a unit: per tile, the streamed pair (and the
// block's own rows where they are not resident) in nc chunks of kc columns
// (nc = 1 wherever the block's rows and two whole units fit shared memory:
// up to D 256), then, where nc > 1, the group's columns as units of their
// own (the dq pass's K; the dk/dv pass's dO, then Q). delta takes a warp a
// row (delta_rows_kernel: coalesced, where a thread a row is not). No
// atomics: a rerun is bitwise equal. Rows and columns past T or past the
// group are computed as at D <= 128 (P = 0 past T) or on stale shared
// memory and not stored. What bounds both passes: 14 B H T^2 D FLOP on
// mma.sync (the dq pass recomputes S and dP, as the D <= 128 kernels do).
constexpr int kWideThreads = 256;   // 8 warps
constexpr int kXP = kTcB + 8;       // pitch of the bf16 exchange tiles [64][kXP]

// bytes of either pass's shared memory at (d, kc, GW): the block's two row
// tiles where they are resident, `xtiles` exchange tiles and the ring of
// units (a chunk unit: two [64][kc + 8] tiles, four where the rows stream; a
// group unit: one [64][GW + 8])
static size_t wide_bwd_smem(int d, int kc, int gw, int xtiles, bool res) {
  const size_t chunk = (res ? 2 : 4) * static_cast<size_t>(kc + 8);
  const size_t unit = chunk > static_cast<size_t>(gw + 8) ? chunk : gw + 8;
  return sizeof(bf16) * kTcB *
         ((res ? 2 * static_cast<size_t>(d + 8) : 0) + xtiles * kXP + kWideStages * unit);
}

// dq rows [q0, q0 + 64) of one (b, h), group z. Per 64-key tile j: S = Q K^T
// and dP = dO V^T (16 query rows x the warp's 32 keys), P = exp2(S * scale *
// log2 e - lse * log2 e) with keys past T at P = 0, dS = P (dP - delta) into
// the exchange tile as bf16, then dQ[:, the warp's half] += dS K (K's group
// columns read transposed by ldmatrix.trans).
template <int GW>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_dq_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int t_dim, int heads, int d, int kc, bool res,
                        float scale, float scale_log2) {
  constexpr int kHW = GW / 2, kPg = GW + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int dp = d + 8, pc = kc + 8, nc = ceil_div(d, kc), rp = res ? dp : 0;
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [64][dp] where resident
  bf16* dos = qs + kTcB * rp;                    // [64][dp] where resident
  bf16* xs = dos + kTcB * rp;                    // dS [64][kXP]
  bf16* ring = xs + kTcB * kXP;
  const int unit = kTcB * max((res ? 2 : 4) * pc, kPg);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int rw = 16 * (warp % 4), half = warp / 4;
  const int q0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int g0 = blockIdx.z * GW, gw = min(GW, d - g0);
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * d;
  const size_t tstride = static_cast<size_t>(heads) * d;
  const int per_tile = nc > 1 ? nc + 1 : 1, units = ceil_div(t_dim, kTcB) * per_tile;
  const auto stage = [&](int u) { return ring + (u % kWideStages) * unit; };
  // unit (j, r): r < nc, K and V's chunk r (then Q's and dO's where they
  // stream); r == nc, K's group columns
  const auto load_unit = [&](int u) {
    if (u < units) {
      const int j = u / per_tile, r = u % per_tile;
      if (r < nc) {
        const int c0 = r * kc, w = min(kc, d - c0);
        wide_load_rows<kWideThreads>(stage(u), pc, k, base + c0, tstride, j * kTcB, t_dim, w);
        wide_load_rows<kWideThreads>(stage(u) + kTcB * pc, pc, v, base + c0, tstride,
                                     j * kTcB, t_dim, w);
        if (!res) {
          wide_load_rows<kWideThreads>(stage(u) + 2 * kTcB * pc, pc, q, base + c0, tstride, q0,
                                       t_dim, w);
          wide_load_rows<kWideThreads>(stage(u) + 3 * kTcB * pc, pc, dout, base + c0, tstride,
                                       q0, t_dim, w);
        }
      } else {
        wide_load_rows<kWideThreads>(stage(u), kPg, k, base + g0, tstride, j * kTcB, t_dim, gw);
      }
    }
    cp_async_commit();
  };
  float lse2[2], dl[2];   // rows g and g + 8: lse in log2 units, delta; 0 past T
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + rw + lane / 4 + 8 * hh;
    const size_t at = static_cast<size_t>(bh) * t_dim + t;
    lse2[hh] = t < t_dim ? lse[at] * kLog2e : 0.f;
    dl[hh] = t < t_dim ? delta[at] : 0.f;
  }

  if (res) {   // with unit 0
    wide_load_rows<kWideThreads>(qs, dp, q, base, tstride, q0, t_dim, d);
    wide_load_rows<kWideThreads>(dos, dp, dout, base, tstride, q0, t_dim, d);
  }
  for (int u = 0; u < kWideStages - 1; ++u) load_unit(u);

  float acc[kHW / 8][4];
  zero_acc<kHW>(acc);
  float s[4][4], dpp[4][4];   // 16 query rows x the warp's 32 keys
  for (int u = 0; u < units; ++u) {
    cp_async_wait_group<kWideStages - 2>();
    __syncthreads();   // unit u has landed; every warp is done with unit u - 1
    load_unit(u + kWideStages - 1);
    const int j = u / per_tile, r = u % per_tile;
    const bf16* tile = stage(u);
    if (r == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dpp[nt][e] = 0.f;
    }
    if (r < nc) {   // Q's and dO's rows resident, or in the unit
      const int c0 = r * kc, w = min(kc, d - c0), ap = res ? dp : pc;
      const bf16* qa = res ? qs + rw * dp + c0 : tile + (2 * kTcB + rw) * pc;
      const bf16* da = res ? dos + rw * dp + c0 : tile + (3 * kTcB + rw) * pc;
      wide_mma_abt<32>(s, qa, ap, tile + 32 * half * pc, pc, w);                  // S
      wide_mma_abt<32>(dpp, da, ap, tile + (kTcB + 32 * half) * pc, pc, w);       // dP
    }
    if (r != per_tile - 1) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int key = j * kTcB + 32 * half + nt * 8 + 2 * quad;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = key + e < t_dim
                              ? exp2f(s[nt][2 * hh + e] * scale_log2 - lse2[hh]) : 0.f;
          ds[e] = p * (dpp[nt][2 * hh + e] - dl[hh]);
        }
        *reinterpret_cast<uint32_t*>(xs + (rw + lane / 4 + 8 * hh) * kXP + 32 * half + nt * 8 +
                                     2 * quad) = pack_bf16(ds[0], ds[1]);
      }
    }
    pair_barrier();   // the pair's dS rows are whole
    uint32_t a[kTcB / 16][4];
    wide_ldsm_a(xs + rw * kXP, kXP, a);
    // dQ += dS K over the group's columns: in the chunk (nc = 1) or a unit of its own
    if (nc == 1) wide_mma_av<kHW>(acc, a, tile + g0 + half * kHW, pc);
    else wide_mma_av<kHW>(acc, a, tile + half * kHW, kPg);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + rw + lane / 4 + 8 * hh;
    if (t >= t_dim) continue;
    bf16* row = dq + base + static_cast<size_t>(t) * tstride + g0 + half * kHW;
#pragma unroll
    for (int dt = 0; dt < kHW / 8; ++dt)
      if (half * kHW + dt * 8 < gw)
        *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + 2 * quad) =
            __floats2bfloat162_rn(acc[dt][2 * hh] * scale, acc[dt][2 * hh + 1] * scale);
  }
}

// dk, dv rows [k0, k0 + 64) of one (b, h), group z. Per 64-query tile j: S^T
// = K Q^T and dP^T = V dO^T (16 key rows x the warp's 32 queries), P^T =
// exp2(S^T * scale * log2 e - lse * log2 e) (queries past T at P = 0), dS^T
// = P^T (dP^T - delta), both into exchange tiles as bf16; then dV[:, the
// warp's half] += P^T dO and dK[:, half] += dS^T Q over the group's columns.
template <int GW>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_dkv_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int t_dim, int heads,
                         int d, int kc, bool res, float scale, float scale_log2) {
  constexpr int kHW = GW / 2, kPg = GW + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int dp = d + 8, pc = kc + 8, nc = ceil_div(d, kc), rp = res ? dp : 0;
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);   // [64][dp] where resident
  bf16* vs = ks + kTcB * rp;                     // [64][dp] where resident
  bf16* pts = vs + kTcB * rp;                    // P^T [64 keys][kXP]
  bf16* dsts = pts + kTcB * kXP;                 // dS^T [64 keys][kXP]
  bf16* ring = dsts + kTcB * kXP;
  const int unit = kTcB * max((res ? 2 : 4) * pc, kPg);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int rw = 16 * (warp % 4), half = warp / 4;
  const int k0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int g0 = blockIdx.z * GW, gw = min(GW, d - g0);
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * d;
  const size_t tstride = static_cast<size_t>(heads) * d;
  const int per_tile = nc > 1 ? nc + 2 : 1, units = ceil_div(t_dim, kTcB) * per_tile;
  const auto stage = [&](int u) { return ring + (u % kWideStages) * unit; };
  // unit (j, r): r < nc, Q and dO's chunk r (then K's and V's where they
  // stream); r == nc, dO's group columns; r == nc + 1, Q's
  const auto load_unit = [&](int u) {
    if (u < units) {
      const int j = u / per_tile, r = u % per_tile;
      if (r < nc) {
        const int c0 = r * kc, w = min(kc, d - c0);
        wide_load_rows<kWideThreads>(stage(u), pc, q, base + c0, tstride, j * kTcB, t_dim, w);
        wide_load_rows<kWideThreads>(stage(u) + kTcB * pc, pc, dout, base + c0, tstride,
                                     j * kTcB, t_dim, w);
        if (!res) {
          wide_load_rows<kWideThreads>(stage(u) + 2 * kTcB * pc, pc, k, base + c0, tstride, k0,
                                       t_dim, w);
          wide_load_rows<kWideThreads>(stage(u) + 3 * kTcB * pc, pc, v, base + c0, tstride, k0,
                                       t_dim, w);
        }
      } else {
        wide_load_rows<kWideThreads>(stage(u), kPg, r == nc ? dout : q, base + g0, tstride,
                                     j * kTcB, t_dim, gw);
      }
    }
    cp_async_commit();
  };

  if (res) {   // with unit 0
    wide_load_rows<kWideThreads>(ks, dp, k, base, tstride, k0, t_dim, d);
    wide_load_rows<kWideThreads>(vs, dp, v, base, tstride, k0, t_dim, d);
  }
  for (int u = 0; u < kWideStages - 1; ++u) load_unit(u);

  float dk_acc[kHW / 8][4], dv_acc[kHW / 8][4];
  zero_acc<kHW>(dk_acc);
  zero_acc<kHW>(dv_acc);
  float s[4][4], dpp[4][4];        // 16 key rows x the warp's 32 queries
  float lq[4][2], dlq[4][2];       // the warp's queries' lse (log2 units) and delta
  for (int u = 0; u < units; ++u) {
    cp_async_wait_group<kWideStages - 2>();
    __syncthreads();   // unit u has landed; every warp is done with unit u - 1
    load_unit(u + kWideStages - 1);
    const int j = u / per_tile, r = u % per_tile;
    const bf16* tile = stage(u);
    if (r == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dpp[nt][e] = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {   // queries column 8 nt + 2 quad + e of the half; 0 past T
          const int t = j * kTcB + 32 * half + nt * 8 + 2 * quad + e;
          const size_t at = static_cast<size_t>(bh) * t_dim + t;
          lq[nt][e] = t < t_dim ? lse[at] * kLog2e : 0.f;
          dlq[nt][e] = t < t_dim ? delta[at] : 0.f;
        }
      }
    }
    if (r < nc) {   // K's and V's rows resident, or in the unit
      const int c0 = r * kc, w = min(kc, d - c0), ap = res ? dp : pc;
      const bf16* ka = res ? ks + rw * dp + c0 : tile + (2 * kTcB + rw) * pc;
      const bf16* va = res ? vs + rw * dp + c0 : tile + (3 * kTcB + rw) * pc;
      wide_mma_abt<32>(s, ka, ap, tile + 32 * half * pc, pc, w);                  // S^T
      wide_mma_abt<32>(dpp, va, ap, tile + (kTcB + 32 * half) * pc, pc, w);       // dP^T
    }
    if (r == nc - 1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * half + nt * 8 + 2 * quad;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = j * kTcB + c + e < t_dim
                       ? exp2f(s[nt][2 * hh + e] * scale_log2 - lq[nt][e]) : 0.f;
            ds[e] = p[e] * (dpp[nt][2 * hh + e] - dlq[nt][e]);
          }
          const int at = (rw + lane / 4 + 8 * hh) * kXP + c;
          *reinterpret_cast<uint32_t*>(pts + at) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(dsts + at) = pack_bf16(ds[0], ds[1]);
        }
      }
      pair_barrier();   // the pair's P^T and dS^T rows are whole
    }
    uint32_t a[kTcB / 16][4];
    if (nc == 1) {   // dO's and Q's group columns are in the chunk
      wide_ldsm_a(pts + rw * kXP, kXP, a);
      wide_mma_av<kHW>(dv_acc, a, tile + kTcB * pc + g0 + half * kHW, pc);   // dV += P^T dO
      wide_ldsm_a(dsts + rw * kXP, kXP, a);
      wide_mma_av<kHW>(dk_acc, a, tile + g0 + half * kHW, pc);               // dK += dS^T Q
    } else if (r == nc) {
      wide_ldsm_a(pts + rw * kXP, kXP, a);
      wide_mma_av<kHW>(dv_acc, a, tile + half * kHW, kPg);
    } else if (r == nc + 1) {
      wide_ldsm_a(dsts + rw * kXP, kXP, a);
      wide_mma_av<kHW>(dk_acc, a, tile + half * kHW, kPg);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + rw + lane / 4 + 8 * hh;
    if (t >= t_dim) continue;
    const size_t off = base + static_cast<size_t>(t) * tstride + g0 + half * kHW;
#pragma unroll
    for (int dt = 0; dt < kHW / 8; ++dt)
      if (half * kHW + dt * 8 < gw) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8 + 2 * quad) =
            __floats2bfloat162_rn(dk_acc[dt][2 * hh] * scale, dk_acc[dt][2 * hh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8 + 2 * quad) =
            __floats2bfloat162_rn(dv_acc[dt][2 * hh], dv_acc[dt][2 * hh + 1]);
      }
  }
}

// ---- head dims past 128, float32: the wide passes in split TF32 ----------
// flash_dq_wide_tc_kernel's and flash_dkv_wide_tc_kernel's plan in float
// tiles (pitch width + 4): 8 warps on 64 rows of one (b, h) and one column
// group, warps w and w + 4 sharing 16 rows and splitting the streamed tile's
// 64 rows for S and dP (32 each, over all of D) and the group's columns for
// the accumulators (GW / 2 each). Every product is split TF32 with the
// two-level sums (wide_tf32_abt, wide_tf32_av; each k8 step's three products
// from zero, then added in float), P = exp(S * scale - lse) in float (as
// flash_dq_tf32_kernel). The pair's dS (P^T and dS^T) go through shared
// memory as float, never rounded, behind the 64-thread named barrier
// ([64][kXPf] tiles, a pitch of 8 mod 32 words: the float2 stores from the
// accumulators and the float2 reads of the permuted A fragment, tf32_xfrag,
// are free of bank conflicts). Per streamed tile, two phases, each a unit
// of the two-stage ring at a time: the pair's nc chunks of kc columns (S and
// dP), then the group's columns, each a unit of its own (the dq pass's K;
// the dk/dv pass's dO, then Q), so S and dP are dead while the accumulators
// take their products (one loop over units, S and dP live across all of
// them, spilled the dk/dv pass at GW 160 and 192). Float tiles take twice
// bf16's bytes: the block's rows and two whole (K, V) units would need 252
// KB at D 160, so the pair goes in two chunks there, and the block's rows
// stream with the tile from D 192 in the dk/dv pass and from D 224 in the
// dq pass. delta takes a warp a row (delta_rows_kernel). No atomics: a
// rerun is bitwise equal.
// What bounds both passes: 14 B H T^2 D multiply-adds (the dq pass
// recomputes S and dP), three TF32 products each, with the splits and the
// two-level sums' adds beside them.
constexpr int kXPf = kTcB + 8;   // pitch of the float exchange tiles [64][kXPf]

// bytes of either float pass's shared memory at (d, kc, GW): the block's two
// row tiles where they are resident, `xtiles` exchange tiles and the ring of
// units (a chunk unit: two [64][kc + 4] tiles, four where the rows stream; a
// group unit: one [64][GW + 4])
static size_t wide_bwd_tf32_smem(int d, int kc, int gw, int xtiles, bool res) {
  const size_t chunk = (res ? 2 : 4) * static_cast<size_t>(kc + 4);
  const size_t unit = chunk > static_cast<size_t>(gw + 4) ? chunk : gw + 4;
  return sizeof(float) * kTcB *
         ((res ? 2 * static_cast<size_t>(d + 4) : 0) + xtiles * kXPf + kWideStages * unit);
}

// dq rows [q0, q0 + 64) of one (b, h), group z. Per 64-key tile j: S = Q K^T
// and dP = dO V^T (16 query rows x the warp's 32 keys), P = exp(S * scale -
// lse) with keys past T at P = 0, dS = P (dP - delta) into the exchange tile,
// then dQ[:, the warp's half] += dS K over K's group columns.
template <int GW>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_dq_wide_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int t_dim, int heads, int d, int kc, bool res,
                          float scale) {
  constexpr int kHW = GW / 2, kPg = GW + 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int dp = d + 4, pc = kc + 4, nc = ceil_div(d, kc), rp = res ? dp : 0;
  float* qs = reinterpret_cast<float*>(tc_smem);   // [64][dp] where resident
  float* dos = qs + kTcB * rp;                     // [64][dp] where resident
  float* xs = dos + kTcB * rp;                     // dS [64][kXPf]
  float* ring = xs + kTcB * kXPf;
  const int unit = kTcB * max((res ? 2 : 4) * pc, kPg);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int rw = 16 * (warp % 4), half = warp / 4;
  const int q0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int g0 = blockIdx.z * GW, gw = min(GW, d - g0);
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * d;
  const size_t tstride = static_cast<size_t>(heads) * d;
  const int n_tiles = ceil_div(t_dim, kTcB), per_tile = nc + 1, units = n_tiles * per_tile;
  const auto stage = [&](int u) { return ring + (u % kWideStages) * unit; };
  // unit (j, r): r < nc, K and V's chunk r (then Q's and dO's where they
  // stream); r == nc, K's group columns
  const auto load_unit = [&](int u) {
    if (u < units) {
      const int j = u / per_tile, r = u % per_tile;
      if (r < nc) {
        const int c0 = r * kc, w = min(kc, d - c0);
        wide_load_rows<kWideThreads>(stage(u), pc, k, base + c0, tstride, j * kTcB, t_dim, w);
        wide_load_rows<kWideThreads>(stage(u) + kTcB * pc, pc, v, base + c0, tstride,
                                     j * kTcB, t_dim, w);
        if (!res) {
          wide_load_rows<kWideThreads>(stage(u) + 2 * kTcB * pc, pc, q, base + c0, tstride, q0,
                                       t_dim, w);
          wide_load_rows<kWideThreads>(stage(u) + 3 * kTcB * pc, pc, dout, base + c0, tstride,
                                       q0, t_dim, w);
        }
      } else {
        wide_load_rows<kWideThreads>(stage(u), kPg, k, base + g0, tstride, j * kTcB, t_dim, gw);
      }
    }
    cp_async_commit();
  };
  int u = 0;
  const auto next_unit = [&]() {   // landed; every warp done with the one before
    cp_async_wait_group<kWideStages - 2>();
    __syncthreads();
    load_unit(u + kWideStages - 1);
    return static_cast<const float*>(stage(u++));
  };
  float ls[2], dl[2];   // rows g and g + 8: lse, delta; 0 past T
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + rw + lane / 4 + 8 * hh;
    const size_t at = static_cast<size_t>(bh) * t_dim + t;
    ls[hh] = t < t_dim ? lse[at] : 0.f;
    dl[hh] = t < t_dim ? delta[at] : 0.f;
  }

  if (res) {   // with unit 0
    wide_load_rows<kWideThreads>(qs, dp, q, base, tstride, q0, t_dim, d);
    wide_load_rows<kWideThreads>(dos, dp, dout, base, tstride, q0, t_dim, d);
  }
  for (int w = 0; w < kWideStages - 1; ++w) load_unit(w);

  float acc[kHW / 8][4];
  zero_acc<kHW>(acc);
  const auto xfrag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    tf32_xfrag(xs + rw * kXPf, kXPf, kk, ah, al);
  };
  for (int j = 0; j < n_tiles; ++j) {
    float s[4][4], dpp[4][4];   // 16 query rows x the warp's 32 keys
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dpp[nt][e] = 0.f;
    for (int r = 0; r < nc; ++r) {   // Q's and dO's rows resident, or in the unit
      const float* tile = next_unit();
      const int c0 = r * kc, w = min(kc, d - c0), ap = res ? dp : pc;
      const float* qa = res ? qs + rw * dp + c0 : tile + (2 * kTcB + rw) * pc;
      const float* da = res ? dos + rw * dp + c0 : tile + (3 * kTcB + rw) * pc;
      wide_tf32_abt<32>(s, qa, ap, tile + 32 * half * pc, pc, w);              // S
      wide_tf32_abt<32>(dpp, da, ap, tile + (kTcB + 32 * half) * pc, pc, w);   // dP
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int key = j * kTcB + 32 * half + nt * 8 + 2 * quad;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = key + e < t_dim ? expf(s[nt][2 * hh + e] * scale - ls[hh]) : 0.f;
          ds[e] = p * (dpp[nt][2 * hh + e] - dl[hh]);
        }
        *reinterpret_cast<float2*>(xs + (rw + lane / 4 + 8 * hh) * kXPf + 32 * half + nt * 8 +
                                   2 * quad) = make_float2(ds[0], ds[1]);
      }
    }
    pair_barrier();   // the pair's dS rows are whole
    // dQ += dS K over the group's columns, a unit of their own
    wide_tf32_av<kHW>(acc, xfrag, next_unit() + half * kHW, kPg);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + rw + lane / 4 + 8 * hh;
    if (t >= t_dim) continue;
    float* row = dq + base + static_cast<size_t>(t) * tstride + g0 + half * kHW;
#pragma unroll
    for (int dt = 0; dt < kHW / 8; ++dt)
      if (half * kHW + dt * 8 < gw)
        *reinterpret_cast<float2*>(row + dt * 8 + 2 * quad) =
            make_float2(acc[dt][2 * hh] * scale, acc[dt][2 * hh + 1] * scale);
  }
}

// dk, dv rows [k0, k0 + 64) of one (b, h), group z. Per 64-query tile j: S^T
// = K Q^T and dP^T = V dO^T (16 key rows x the warp's 32 queries), P^T =
// exp(S^T * scale - lse) (queries past T at P = 0), dS^T = P^T (dP^T -
// delta), both into exchange tiles; then dV[:, the warp's half] += P^T dO
// and dK[:, half] += dS^T Q over the group's columns.
template <int GW>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_dkv_wide_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int t_dim, int heads,
                           int d, int kc, bool res, float scale) {
  constexpr int kHW = GW / 2, kPg = GW + 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int dp = d + 4, pc = kc + 4, nc = ceil_div(d, kc), rp = res ? dp : 0;
  float* ks = reinterpret_cast<float*>(tc_smem);   // [64][dp] where resident
  float* vs = ks + kTcB * rp;                      // [64][dp] where resident
  float* pts = vs + kTcB * rp;                     // P^T [64 keys][kXPf]
  float* dsts = pts + kTcB * kXPf;                 // dS^T [64 keys][kXPf]
  float* ring = dsts + kTcB * kXPf;
  const int unit = kTcB * max((res ? 2 : 4) * pc, kPg);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, quad = lane % 4;
  const int rw = 16 * (warp % 4), half = warp / 4;
  const int k0 = blockIdx.x * kTcB;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int g0 = blockIdx.z * GW, gw = min(GW, d - g0);
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * d;
  const size_t tstride = static_cast<size_t>(heads) * d;
  const int n_tiles = ceil_div(t_dim, kTcB), per_tile = nc + 2, units = n_tiles * per_tile;
  const auto stage = [&](int u) { return ring + (u % kWideStages) * unit; };
  // unit (j, r): r < nc, Q and dO's chunk r (then K's and V's where they
  // stream); r == nc, dO's group columns; r == nc + 1, Q's
  const auto load_unit = [&](int u) {
    if (u < units) {
      const int j = u / per_tile, r = u % per_tile;
      if (r < nc) {
        const int c0 = r * kc, w = min(kc, d - c0);
        wide_load_rows<kWideThreads>(stage(u), pc, q, base + c0, tstride, j * kTcB, t_dim, w);
        wide_load_rows<kWideThreads>(stage(u) + kTcB * pc, pc, dout, base + c0, tstride,
                                     j * kTcB, t_dim, w);
        if (!res) {
          wide_load_rows<kWideThreads>(stage(u) + 2 * kTcB * pc, pc, k, base + c0, tstride, k0,
                                       t_dim, w);
          wide_load_rows<kWideThreads>(stage(u) + 3 * kTcB * pc, pc, v, base + c0, tstride, k0,
                                       t_dim, w);
        }
      } else {
        wide_load_rows<kWideThreads>(stage(u), kPg, r == nc ? dout : q, base + g0, tstride,
                                     j * kTcB, t_dim, gw);
      }
    }
    cp_async_commit();
  };
  int u = 0;
  const auto next_unit = [&]() {   // landed; every warp done with the one before
    cp_async_wait_group<kWideStages - 2>();
    __syncthreads();
    load_unit(u + kWideStages - 1);
    return static_cast<const float*>(stage(u++));
  };

  if (res) {   // with unit 0
    wide_load_rows<kWideThreads>(ks, dp, k, base, tstride, k0, t_dim, d);
    wide_load_rows<kWideThreads>(vs, dp, v, base, tstride, k0, t_dim, d);
  }
  for (int w = 0; w < kWideStages - 1; ++w) load_unit(w);

  float dk_acc[kHW / 8][4], dv_acc[kHW / 8][4];
  zero_acc<kHW>(dk_acc);
  zero_acc<kHW>(dv_acc);
  const auto pfrag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    tf32_xfrag(pts + rw * kXPf, kXPf, kk, ah, al);
  };
  const auto dsfrag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    tf32_xfrag(dsts + rw * kXPf, kXPf, kk, ah, al);
  };
  for (int j = 0; j < n_tiles; ++j) {
    float s[4][4], dpp[4][4];   // 16 key rows x the warp's 32 queries
    float lq[4][2], dlq[4][2];  // the warp's queries' lse and delta
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dpp[nt][e] = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // queries column 8 nt + 2 quad + e of the half; 0 past T
        const int t = j * kTcB + 32 * half + nt * 8 + 2 * quad + e;
        const size_t at = static_cast<size_t>(bh) * t_dim + t;
        lq[nt][e] = t < t_dim ? lse[at] : 0.f;
        dlq[nt][e] = t < t_dim ? delta[at] : 0.f;
      }
    }
    for (int r = 0; r < nc; ++r) {   // K's and V's rows resident, or in the unit
      const float* tile = next_unit();
      const int c0 = r * kc, w = min(kc, d - c0), ap = res ? dp : pc;
      const float* ka = res ? ks + rw * dp + c0 : tile + (2 * kTcB + rw) * pc;
      const float* va = res ? vs + rw * dp + c0 : tile + (3 * kTcB + rw) * pc;
      wide_tf32_abt<32>(s, ka, ap, tile + 32 * half * pc, pc, w);              // S^T
      wide_tf32_abt<32>(dpp, va, ap, tile + (kTcB + 32 * half) * pc, pc, w);   // dP^T
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = 32 * half + nt * 8 + 2 * quad;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = j * kTcB + c + e < t_dim ? expf(s[nt][2 * hh + e] * scale - lq[nt][e]) : 0.f;
          ds[e] = p[e] * (dpp[nt][2 * hh + e] - dlq[nt][e]);
        }
        const int at = (rw + lane / 4 + 8 * hh) * kXPf + c;
        *reinterpret_cast<float2*>(pts + at) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(dsts + at) = make_float2(ds[0], ds[1]);
      }
    }
    pair_barrier();   // the pair's P^T and dS^T rows are whole
    // the group's columns, each a unit of its own
    wide_tf32_av<kHW>(dv_acc, pfrag, next_unit() + half * kHW, kPg);   // dV += P^T dO
    wide_tf32_av<kHW>(dk_acc, dsfrag, next_unit() + half * kHW, kPg);  // dK += dS^T Q
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + rw + lane / 4 + 8 * hh;
    if (t >= t_dim) continue;
    const size_t off = base + static_cast<size_t>(t) * tstride + g0 + half * kHW;
#pragma unroll
    for (int dt = 0; dt < kHW / 8; ++dt)
      if (half * kHW + dt * 8 < gw) {
        *reinterpret_cast<float2*>(dk + off + dt * 8 + 2 * quad) =
            make_float2(dk_acc[dt][2 * hh] * scale, dk_acc[dt][2 * hh + 1] * scale);
        *reinterpret_cast<float2*>(dv + off + dt * 8 + 2 * quad) =
            make_float2(dv_acc[dt][2 * hh], dv_acc[dt][2 * hh + 1]);
      }
  }
}

// delta over all of D, then the float32 dq and dk / dv passes in column groups of GW.
template <int GW>
cudaError_t launch_wide_tf32(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int batch, int t_dim, int heads, int d,
                             float scale, cudaStream_t s) {
  const void* ptrs[] = {q, k, v, out, dout, dq, dk, dv};   // 16-byte copies, float2 stores
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  // the block's rows resident with the widest chunk that fits beside them, else streamed
  bool res_dq = true, res_dkv = true;
  int kc_dq = wide_chunk(d, [&](int c) { return wide_bwd_tf32_smem(d, c, GW, 1, true); });
  int kc_dkv = wide_chunk(d, [&](int c) { return wide_bwd_tf32_smem(d, c, GW, 2, true); });
  if (kc_dq == 0) {
    res_dq = false;
    kc_dq = wide_chunk(d, [&](int c) { return wide_bwd_tf32_smem(d, c, GW, 1, false); });
  }
  if (kc_dkv == 0) {
    res_dkv = false;
    kc_dkv = wide_chunk(d, [&](int c) { return wide_bwd_tf32_smem(d, c, GW, 2, false); });
  }
  if (kc_dq == 0 || kc_dkv == 0) return cudaErrorInvalidValue;
  const int rows = batch * t_dim * heads;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  delta_rows_kernel<float><<<ceil_div(rows, 8), 256, 0, s>>>(static_cast<const float*>(out), df,
                                                             delta, rows, t_dim, heads, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(t_dim, kTcB), batch * heads, ceil_div(d, GW));
  const size_t smem_dq = wide_bwd_tf32_smem(d, kc_dq, GW, 1, res_dq);
  err = set_smem(flash_dq_wide_tf32_kernel<GW>, smem_dq);
  if (err != cudaSuccess) return err;
  flash_dq_wide_tf32_kernel<GW><<<grid, kWideThreads, smem_dq, s>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), t_dim, heads, d, kc_dq, res_dq,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_dkv = wide_bwd_tf32_smem(d, kc_dkv, GW, 2, res_dkv);
  err = set_smem(flash_dkv_wide_tf32_kernel<GW>, smem_dkv);
  if (err != cudaSuccess) return err;
  flash_dkv_wide_tf32_kernel<GW><<<grid, kWideThreads, smem_dkv, s>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), t_dim, heads,
      d, kc_dkv, res_dkv, scale);
  return cudaGetLastError();
}

// delta over all of D, then the bf16 dq and dk / dv passes in column groups of GW.
template <int GW>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int batch, int t_dim, int heads, int d, float scale,
                        cudaStream_t s) {
  const void* ptrs[] = {q, k, v, dout, dq, dk, dv};   // 16-byte copies, bf16x2 stores
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  // the block's rows resident with the widest chunk that fits beside them, else streamed
  bool res_dq = true, res_dkv = true;
  int kc_dq = wide_chunk(d, [&](int c) { return wide_bwd_smem(d, c, GW, 1, true); });
  int kc_dkv = wide_chunk(d, [&](int c) { return wide_bwd_smem(d, c, GW, 2, true); });
  if (kc_dq == 0) {
    res_dq = false;
    kc_dq = wide_chunk(d, [&](int c) { return wide_bwd_smem(d, c, GW, 1, false); });
  }
  if (kc_dkv == 0) {
    res_dkv = false;
    kc_dkv = wide_chunk(d, [&](int c) { return wide_bwd_smem(d, c, GW, 2, false); });
  }
  if (kc_dq == 0 || kc_dkv == 0) return cudaErrorInvalidValue;
  const int rows = batch * t_dim * heads;
  if (reinterpret_cast<uintptr_t>(out) % 16) return cudaErrorMisalignedAddress;
  delta_rows_kernel<bf16><<<ceil_div(rows, 8), 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, rows, t_dim, heads,
      d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  const dim3 grid(ceil_div(t_dim, kTcB), batch * heads, ceil_div(d, GW));
  const size_t smem_dq = wide_bwd_smem(d, kc_dq, GW, 1, res_dq);
  err = set_smem(flash_dq_wide_tc_kernel<GW>, smem_dq);
  if (err != cudaSuccess) return err;
  flash_dq_wide_tc_kernel<GW><<<grid, kWideThreads, smem_dq, s>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dq), t_dim, heads, d, kc_dq, res_dq, scale,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_dkv = wide_bwd_smem(d, kc_dkv, GW, 2, res_dkv);
  err = set_smem(flash_dkv_wide_tc_kernel<GW>, smem_dkv);
  if (err != cudaSuccess) return err;
  flash_dkv_wide_tc_kernel<GW><<<grid, kWideThreads, smem_dkv, s>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_dim, heads,
      d, kc_dkv, res_dkv, scale, scale * kLog2e);
  return cudaGetLastError();
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
  dim3 grid(ceil_div(t_dim, kTcB), batch * heads);

  if constexpr (sizeof(T) == 2) {
    const void* ptrs[] = {q, k, v, dout, dq, dk, dv};   // 16-byte copies, bf16x2 stores
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
    const float scale_log2 = scale * kLog2e;
    constexpr size_t smem_dq = dq_tc_smem_bytes<D>();
    err = set_smem(flash_dq_tc_kernel<D>, smem_dq);
    if (err != cudaSuccess) return err;
    flash_dq_tc_kernel<D><<<grid, kAttnThreads, smem_dq, s>>>(
        qb, kb, vb, db, lse, delta, static_cast<bf16*>(dq), t_dim, heads, scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr size_t smem_dkv = dkv_tc_smem_bytes<D>();
    err = set_smem(flash_dkv_tc_kernel<D>, smem_dkv);
    if (err != cudaSuccess) return err;
    flash_dkv_tc_kernel<D><<<grid, kAttnThreads, smem_dkv, s>>>(
        qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_dim,
        heads, scale, scale_log2);
  } else {
    const void* ptrs[] = {q, k, v, dout, dq, dk, dv};   // 16-byte copies, float2 stores
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    constexpr size_t smem_dq = dq_tf32_smem_bytes<D>();
    err = set_smem(flash_dq_tf32_kernel<D>, smem_dq);
    if (err != cudaSuccess) return err;
    flash_dq_tf32_kernel<D><<<grid, kAttnThreads, smem_dq, s>>>(
        qf, kf, vf, df, lse, delta, static_cast<float*>(dq), t_dim, heads, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr size_t smem_dkv = dkv_tf32_smem_bytes<D>();
    err = set_smem(flash_dkv_tf32_kernel<D>, smem_dkv);
    if (err != cudaSuccess) return err;
    flash_dkv_tf32_kernel<D><<<grid, kAttnThreads, smem_dkv, s>>>(
        qf, kf, vf, df, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), t_dim,
        heads, scale);
  }
  return cudaGetLastError();
}

// d and the column-group width of attention.head_dim_plan, as the forward's
// dispatch_d takes them.
template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int batch, int t_dim, int heads, int d, int group, float scale,
                       cudaStream_t s) {
  if (d <= 128 && group != d) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 48: return launch<T, 48>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, scale, s);
    default: break;
  }
  if (d <= 128 || d % 32 != 0) return cudaErrorInvalidValue;
  constexpr bool kF = sizeof(T) == 4;
  switch (group) {
    case 160: return (kF ? launch_wide_tf32<160> : launch_wide<160>)(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, d, scale, s);
    case 192: return (kF ? launch_wide_tf32<192> : launch_wide<192>)(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, d, scale, s);
    case 224: return (kF ? launch_wide_tf32<224> : launch_wide<224>)(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, d, scale, s);
    case 256: return (kF ? launch_wide_tf32<256> : launch_wide<256>)(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t_dim, heads, d, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Head dims and column groups: attention.head_dim_plan's (dispatch_d).
// delta: (B, H, T) float scratch.
extern "C" int seld_flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int batch, int t_dim, int heads, int d,
                                   int group, float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_d<float>(q, k, v, out, dout, l, dl, dq, dk, dv, batch, t_dim, heads, d,
                            group, scale, s);
  else if (dtype == kBF16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, batch, t_dim,
                                    heads, d, group, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
