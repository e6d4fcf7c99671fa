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
// bfloat16: FlashAttention-2 on the tensor cores (flash_fwd_tc_kernel; the
// A/B tile helpers of flash_attn_tc.cuh, which K6's backward shares). One
// block per (b*h, query tile) of 4 or 8 warps, 16 query rows each (8
// warps, 128 queries, where the grid still fills two waves of two blocks
// an SM: every K and V tile then serves twice the queries); Q's fragments
// stay in registers. 64-key tiles of K and V stream through a three-stage
// cp.async ring with one barrier per tile: tile j + 2 loads while tile j is
// used. S = Q K^T is mma.sync.m16n8k16 with float accumulators (D in {16,
// 32, 48, 64, 128}, all multiples of 16; the wrapper zero-pads any other D
// up to one of them, and past 128 to a multiple of 32, which
// flash_fwd_wide_tc_kernel below takes in column groups). The next
// tile's S is issued before this tile's softmax, so the tensor cores and
// the exponentials (the MUFU's 16 a clock an SM, about as long as the
// products at D = 48) overlap within a warp.
// Only the last tile's keys past T are masked. The online
// softmax runs on the accumulator fragments (the row max across the four
// lanes of a quad, then one fma with scale * log2(e) and one ex2.approx a
// score); P is rounded to bf16 in registers and fed straight back as the A
// operand of O += P V (no shared-memory round trip) and of the row sums l
// += P 1 (a column of ones as B: four products a tile in place of 32 float
// adds a thread).
// Rounding P to bf16 departs from the JAX kernel, which multiplies a float p
// (seld_tpu/ops/pallas/attention.py:52-56); it stays within the bf16
// tolerance (2e-2 x max|ref|), as the plain version, which rounds the
// normalized probabilities to v's dtype, shows on the card.
//
// float32 at D <= 128: the same shape in split TF32 (flash_fwd_tf32_kernel,
// below): every product three mma.sync.m16n8k8 TF32 products on hi + lo
// splits of its operands (mma.cuh), each k8 step's three summed from zero
// on the tensor cores, then added to float accumulators rounded to nearest;
// the softmax in float with expf; held to float64 on the card (within 4x
// the float32 plain version's distance, TF32 off). What bounds it: 4 B H T^2
// D multiply-adds, three TF32 products each (0.107 ms at B 2, T 2400, 8
// heads of 48), and the issue slots of the splits, the two-level sums' adds
// and the exponentials beside them.
// Past 128, float32 takes flash_fwd_wide_tf32_kernel (the end of this
// file): the bf16 wide kernel's column groups, S once per key tile, in the
// same split-TF32 arithmetic.
#include <math_constants.h>

#include "common.cuh"
#include "flash_attn_tc.cuh"

namespace {

// 2^x on the MUFU alone (ex2.approx.ftz: results below 2^-126 flush to 0,
// -inf gives 0); exp2f adds a range fix-up around it.
static __device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keys past T to -inf in the accumulator fragments of the last tile
// (columns 8 nt + 2 quad + e % 2; `valid` keys of the tile are real).
template <int kNT>
static __device__ __forceinline__ void mask_keys(float (&s)[kNT][4], int valid) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (nt * 8 + 2 * quad + (e % 2) >= valid) s[nt][e] = -CUDART_INF_F;
}

// ---- float32 at D <= 128: split TF32 on mma.sync.m16n8k8 -------------------
// K and V are split into hi + lo once, as each tile lands, up to this D (the
// planes take two more tiles of shared memory: at D 128 the ring, Q and the
// planes would not fit), past it by each warp as it reads its fragments. At
// D 48 the split at staging ran 1-11% faster than on read, in turns
// (PERF.md section 6).
constexpr int kSplitAtStagingMaxD = 64;
constexpr int kTfStages = 2;   // (k, v) tiles in the ring

template <int D>
constexpr size_t fwd_tf32_smem_bytes() {   // the ring's (k, v) tiles, then K's and V's lo planes, or Q
  return sizeof(float) * (2 * kTfStages + (D <= kSplitAtStagingMaxD ? 2 : 1)) * kAttnRows *
         (D + 4);
}

// hi + lo of this thread's own copies of a landed [64][D + 4] tile
// (tf32_load_rows' pattern, so no other thread's copies are read): hi in
// place, lo into `lo` at the same offsets.
template <int D>
static __device__ __forceinline__ void tf32_split_rows(float* __restrict__ tile,
                                                       uint32_t* __restrict__ lo) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kAttnRows * kVecs; e += kAttnThreads) {
    const int at = (e / kVecs) * (D + 4) + 4 * (e % kVecs);
    const float4 x = *reinterpret_cast<const float4*>(tile + at);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// The B fragment (hi, lo) at word `at` of a tile and `at + step`: the staged
// planes (hi in place, lo beside) where kStaged, else split as it is read.
template <bool kStaged>
static __device__ __forceinline__ void tf32_b(const float* __restrict__ tile,
                                              const uint32_t* __restrict__ lo, int at, int step,
                                              uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  if constexpr (kStaged) {
    bh[0] = __float_as_uint(tile[at]);
    bh[1] = __float_as_uint(tile[at + step]);
    bl[0] = lo[at];
    bl[1] = lo[at + step];
  } else {
    split_tf32(tile[at], bh[0], bl[0]);
    split_tf32(tile[at + step], bh[1], bl[1]);
  }
}

// One block per (b*h, 64-query tile): 4 warps of 16 query rows, Q staged
// once (its split fragments kept in registers up to D 64, read and split
// again each tile at D 128), 64-key tiles of K and V through a two-stage
// cp.async ring, two barriers a tile: K and V split into their planes (where
// kStaged), then the products, then the tile's stage freed for tile j + 2.
// Per tile: S = Q K^T, each k8 step through mma_3xtf32_add; keys past T to
// -inf; the online softmax on the accumulator fragments in float (the row
// max across the quad, expf, a thread's share of the row sum l in float:
// a column of ones on the tensor cores would round P to TF32); O += P V
// with P split as it leaves the accumulators and fed as the A operand by
// permuting the keys of each 8-group (slot t is key 2t, slot t + 4 key 2t +
// 1; V read at rows 2t and 2t + 1, as K6's float passes do). Rows past T
// are computed on zeros and not stored.
template <int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int t_dim, int heads, float scale) {
  constexpr int kP = D + 4, kT = kAttnRows * kP;
  constexpr bool kStaged = D <= kSplitAtStagingMaxD, kQRegs = D <= 64;
  static_assert(!kStaged || kQRegs, "the lo planes take Q's place");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* ring = reinterpret_cast<float*>(tc_smem);   // per stage: k, v [64][kP]
  float* extra = ring + 2 * kTfStages * kT;          // K's, V's lo planes (Q first), or Q
  uint32_t* klo = reinterpret_cast<uint32_t*>(extra);
  uint32_t* vlo = klo + kT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kAttnRows;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int n_tiles = ceil_div(t_dim, kAttnRows);
  const int last_valid = t_dim - (n_tiles - 1) * kAttnRows;   // keys of the last tile
  const auto stage = [&](int j) { return ring + (j % kTfStages) * 2 * kT; };
  // tile j's k and v, one commit group (empty past the last tile)
  const auto load_tile = [&](int j) {
    if (j < n_tiles) {
      tf32_load_rows<D>(stage(j), k, base, tstride, j * kAttnRows, t_dim);
      tf32_load_rows<D>(stage(j) + kT, v, base, tstride, j * kAttnRows, t_dim);
    }
    cp_async_commit();
  };

  tf32_load_rows<D>(extra, q, base, tstride, q0, t_dim);   // with tile 0
  load_tile(0);
  load_tile(1);
  cp_async_wait_group<1>();
  __syncthreads();

  // this warp's 16 query rows: A fragments (rows g, g + 8 x d t, t + 4) of
  // each k8 step, split
  const float* qw = extra + warp * 16 * kP + g * kP + t;
  const auto qsplit = [&](int kd, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    split_tf32(qw[8 * kd], ah[0], al[0]);
    split_tf32(qw[8 * kP + 8 * kd], ah[1], al[1]);
    split_tf32(qw[8 * kd + 4], ah[2], al[2]);
    split_tf32(qw[8 * kP + 8 * kd + 4], ah[3], al[3]);
  };
  uint32_t qh[kQRegs ? D / 8 : 1][4], ql[kQRegs ? D / 8 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kd = 0; kd < D / 8; ++kd) qsplit(kd, qh[kd], ql[kd]);
  }
  if constexpr (kStaged) __syncthreads();   // Q is in registers before the planes take its place

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows g and g + 8, scaled scores
  float l_run[2] = {0.f, 0.f};   // this thread's share of the rows' sums

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_group<1>();   // tile j's copies by this thread have landed
    float* ks = stage(j);
    float* vs = ks + kT;
    if constexpr (kStaged) {
      tf32_split_rows<D>(ks, klo);
      tf32_split_rows<D>(vs, vlo);
    }
    __syncthreads();   // tile j (and its planes) complete

    float s[kAttnRows / 8][4];
#pragma unroll
    for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 8; ++kd) {
      uint32_t ah[4], al[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kd][i];
          al[i] = ql[kd][i];
        }
      } else {
        qsplit(kd, ah, al);
      }
#pragma unroll
      for (int nt = 0; nt < kAttnRows / 8; ++nt) {   // K rows (keys) 8 nt + g, d t, t + 4
        uint32_t bh_[2], bl_[2];
        tf32_b<kStaged>(ks, klo, (8 * nt + g) * kP + 8 * kd + t, 4, bh_, bl_);
        mma_3xtf32_add(s[nt], ah, al, bh_, bl_);
      }
    }
    if (j == n_tiles - 1 && last_valid < kAttnRows) mask_keys(s, last_valid);

    // the online softmax on the fragments, in float
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      // finite: every tile holds a key; scale > 0 keeps the max's place
      const float m_new = fmaxf(m_run[hh], mx[hh] * scale);
      alpha[hh] = expf(m_run[hh] - m_new);
      m_run[hh] = m_new;
      l_run[hh] *= alpha[hh];
    }
#pragma unroll
    for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(fmaf(s[nt][e], scale, -m_run[e / 2]));
        l_run[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];

    // O += P V: P split as the A operand, keys permuted within each 8-group
#pragma unroll
    for (int kk = 0; kk < kAttnRows / 8; ++kk) {
      uint32_t ah[4], al[4];   // slots t, t + 4 = keys 2t, 2t + 1: c0, c2, c1, c3
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {   // V rows 8 kk + 2t, + 1, column 8 dt + g
        uint32_t bh_[2], bl_[2];
        tf32_b<kStaged>(vs, vlo, (8 * kk + 2 * t) * kP + 8 * dt + g, kP, bh_, bl_);
        mma_3xtf32_add(o[dt], ah, al, bh_, bl_);
      }
    }
    __syncthreads();   // every warp is done with tile j's stage and planes
    load_tile(j + 2);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l_run[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= t_dim) continue;
    const float inv = 1.f / lr;
    float* orow = out + base + static_cast<size_t>(row) * tstride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8 + 2 * t) =
          make_float2(o[dt][2 * hh] * inv, o[dt][2 * hh + 1] * inv);
    if (t == 0) lse[static_cast<size_t>(bh) * t_dim + row] = m_run[hh] + logf(lr);
  }
}

template <int D>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, float* out, float* lse,
                        int batch, int t_dim, int heads, float scale, cudaStream_t stream) {
  const void* rows[] = {q, k, v, out};   // 16-byte copies and float2 stores
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  constexpr size_t smem = fwd_tf32_smem_bytes<D>();
  cudaError_t err = set_smem(flash_fwd_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kAttnRows), batch * heads);
  flash_fwd_tf32_kernel<D><<<grid, kAttnThreads, smem, stream>>>(q, k, v, out, lse, t_dim, heads,
                                                                  scale);
  return cudaGetLastError();
}

// ---- bfloat16: FlashAttention-2 on mma.sync.m16n8k16 ----------------------

constexpr int kTcK = kAttnRows;   // keys per tile
constexpr int kTcStages = 3;      // (k, v) tiles in the ring

// kQ queries a block (64 or 128): kQ / 16 warps of 16 query rows.
template <int D, int kQ>
constexpr size_t tc_smem_bytes() {   // q, then kTcStages (k, v) stages, rows padded to D + 8
  return sizeof(bf16) * (kQ + 2 * kTcStages * kTcK) * (D + 8);
}

template <int D, int kQ>
__global__ void __launch_bounds__(2 * kQ, D <= 48 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int t_dim, int heads, float scale_log2) {
  constexpr int kBlock = 2 * kQ;   // 32 threads a warp of 16 query rows
  constexpr int kP = D + 8;   // padded row: 16-byte units odd, so ldmatrix phases do not conflict
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [kQ][kP]
  bf16* kv = qs + kQ * kP;                       // per stage: k [kTcK][kP], v [kTcK][kP]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, quad = lane % 4;
  const int q0 = blockIdx.x * kQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * D;
  const size_t tstride = static_cast<size_t>(heads) * D;
  const int n_tiles = ceil_div(t_dim, kTcK);
  const int last_valid = t_dim - (n_tiles - 1) * kTcK;   // keys of the last tile
  const auto ks_of = [&](int j) { return kv + (j % kTcStages) * 2 * kTcK * kP; };
  // tile j's k and v, one commit group (empty past the last tile)
  const auto load_tile = [&](int j) {
    if (j < n_tiles) {
      attn_load_rows<D, kTcK, kBlock>(ks_of(j), k, base, tstride, j * kTcK, t_dim);
      attn_load_rows<D, kTcK, kBlock>(ks_of(j) + kTcK * kP, v, base, tstride, j * kTcK,
                                      t_dim);
    }
    cp_async_commit();
  };

  attn_load_rows<D, kQ, kBlock>(qs, q, base, tstride, q0, t_dim);
  load_tile(0);   // with q
  load_tile(1);
  cp_async_wait_group<1>();
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
  // the row sums of P on the tensor cores: P times a column of ones, so
  // l[0] (= l[1]) is row g's and l[2] row g + 8's, over the bf16 P that O
  // accumulates
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t ones = pack_bf16(1.f, 1.f);

  float s[kTcK / 8][4];   // S = Q K^T of the tile in hand
  attn_mma_abt<D>(s, qfrag, ks_of(0));
  for (int j = 0; j < n_tiles; ++j) {
    // tile j + 1 has landed, and every warp is done with tile j - 1, whose
    // stage tile j + 2 now takes: one barrier per tile
    cp_async_wait_all();
    __syncthreads();
    load_tile(j + 2);
    if (j == n_tiles - 1 && last_valid < kTcK) mask_keys(s, last_valid);
    // the next tile's S on the tensor cores while this tile's softmax runs
    // (the last iteration recomputes its own: one idle tile of products)
    float sn[kTcK / 8][4];
    attn_mma_abt<D>(sn, qfrag, ks_of(min(j + 1, n_tiles - 1)));
    // the online softmax on the fragments: the max of the raw scores, then
    // p = 2^(s * scale_log2 - m) in one fma and one ex2 a score
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      // finite: every tile holds a key; scale_log2 > 0 keeps the max's place
      const float m_new = fmaxf(m_run[hh], mx[hh] * scale_log2);
      alpha[hh] = fast_exp2(m_run[hh] - m_new);
      m_run[hh] = m_new;
      neg_m[hh] = -m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = fast_exp2(fmaf(s[nt][e], scale_log2, neg_m[e / 2]));
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e] *= alpha[e / 2];
    // O += P V and l += P 1, P rounded to bf16 in registers as the A operand
    attn_mma_pv<D>(o, s, ks_of(j) + kTcK * kP);
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_bf16(l, a, ones, ones);
    }
#pragma unroll
    for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = sn[nt][e];
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lr = l[2 * hh];
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= t_dim) continue;
    const float inv = 1.f / lr;
    bf16* orow = out + base + static_cast<size_t>(t) * tstride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * quad) =
          __floats2bfloat162_rn(o[dt][2 * hh] * inv, o[dt][2 * hh + 1] * inv);
    if (quad == 0)
      lse[static_cast<size_t>(bh) * t_dim + t] = (m_run[hh] + log2f(lr)) * 0.69314718055994531f;
  }
}

template <int D, int kQ>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int t_dim, int heads, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D, kQ>();
  cudaError_t err = set_smem(flash_fwd_tc_kernel<D, kQ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ceil_div(t_dim, kQ), batch * heads);
  flash_fwd_tc_kernel<D, kQ><<<grid, 2 * kQ, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, t_dim, heads, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---- head dims past 128, bfloat16: S once per key tile ---------------------
// The wrapper pads D to a multiple of 32 (attention.head_dim_plan); the
// output columns split into ceil(D / 256) groups of GW (grid z; the last
// group narrower where GW does not divide D), and a block owns kQ queries
// of one (b, h) and one group. Its Q rows are staged into shared memory
// once, at the whole padded D, and read by ldmatrix for every key tile (at
// D 256, 16 rows x 256 columns of O are 128 float registers a thread, so
// Q's fragments cannot stay in registers); past the D at which they fit
// (about 1200 at 64 queries) Q streams with K instead, chunk by chunk.
// Per 64-key tile the block computes S = Q K^T once over all of D, runs one
// online softmax (as flash_fwd_tc_kernel: ex2.approx on the fragments, P
// rounded to bf16 in registers as the A operand, row sums as a product with
// a column of ones, only the last tile masked) and O += P V over its group's
// columns of V. So S is computed once per column group, and no product runs
// on the padding of a 128-column rule. Units stream through a two-stage
// cp.async ring, one barrier a unit: per key tile, K in nc chunks of kc
// columns (nc = 1, the whole of K, wherever Q and two units fit shared
// memory: up to D 416 at 64 queries), each chunk with Q's where Q is not
// resident, the last chunk's unit carrying the group's columns of V. The
// group's last columns past D (a narrower last group) are computed on stale
// shared memory and not stored. What bounds it: the products (4 B H T^2 D
// FLOP) and the exponentials (B H T^2 ex2 per group), as at D <= 128.
static size_t wide_fwd_smem(int d, int kc, int gw, int kq, bool q_res) {
  const size_t rows = q_res ? static_cast<size_t>(kq) * (d + 8) : 0;
  const size_t unit = kTcK * static_cast<size_t>(kc + 8 + gw + 8) +
                      (q_res ? 0 : static_cast<size_t>(kq) * (kc + 8));
  return sizeof(bf16) * (rows + kWideStages * unit);
}

template <int GW, int kQ>
__global__ void __launch_bounds__(2 * kQ)
flash_fwd_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int t_dim, int heads, int d, int kc,
                         bool q_res, float scale_log2) {
  constexpr int kBlock = 2 * kQ;   // 32 threads a warp of 16 query rows
  constexpr int kPg = GW + 8;      // pitch of the V group tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int dp = d + 8, pc = kc + 8, nc = ceil_div(d, kc);
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);   // [kQ][dp] where Q is resident
  // per stage: K chunk [64][pc], V [64][kPg], and Q's chunk [kQ][pc] where Q streams
  bf16* ring = qs + (q_res ? kQ * dp : 0);
  const int unit = kTcK * (pc + kPg) + (q_res ? 0 : kQ * pc);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, quad = lane % 4;
  const int q0 = blockIdx.x * kQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int g0 = blockIdx.z * GW, gw = min(GW, d - g0);
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * d;
  const size_t tstride = static_cast<size_t>(heads) * d;
  const int n_tiles = ceil_div(t_dim, kTcK);
  const int last_valid = t_dim - (n_tiles - 1) * kTcK;
  const int units = n_tiles * nc;
  const auto stage = [&](int u) { return ring + (u % kWideStages) * unit; };
  // unit u: key tile u / nc, K's chunk u % nc, and V's group with the last chunk
  const auto load_unit = [&](int u) {
    if (u < units) {
      const int j = u / nc, c0 = (u % nc) * kc;
      wide_load_rows<kBlock>(stage(u), pc, k, base + c0, tstride, j * kTcK, t_dim,
                             min(kc, d - c0));
      if (!q_res)
        wide_load_rows<kBlock, kQ>(stage(u) + kTcK * (pc + kPg), pc, q, base + c0, tstride, q0,
                                   t_dim, min(kc, d - c0));
      if (u % nc == nc - 1)
        wide_load_rows<kBlock>(stage(u) + kTcK * pc, kPg, v, base + g0, tstride, j * kTcK,
                               t_dim, gw);
    }
    cp_async_commit();
  };

  if (q_res) wide_load_rows<kBlock, kQ>(qs, dp, q, base, tstride, q0, t_dim, d);   // with unit 0
  for (int u = 0; u < kWideStages - 1; ++u) load_unit(u);

  float o[GW / 8][4];
#pragma unroll
  for (int dt = 0; dt < GW / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // as flash_fwd_tc_kernel's
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t ones = pack_bf16(1.f, 1.f);
  float s[kTcK / 8][4];

  for (int u = 0; u < units; ++u) {
    // unit u has landed, and every warp is done with unit u - 1, whose stage
    // unit u + 1 now takes
    cp_async_wait_group<kWideStages - 2>();
    __syncthreads();
    load_unit(u + kWideStages - 1);
    const int j = u / nc, c0 = (u % nc) * kc;
    const bf16* tile = stage(u);
    if (c0 == 0) {
#pragma unroll
      for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    // this warp's 16 query rows, resident or in the unit
    if (q_res) wide_mma_abt<kTcK>(s, qs + warp * 16 * dp + c0, dp, tile, pc, min(kc, d - c0));
    else wide_mma_abt<kTcK>(s, tile + kTcK * (pc + kPg) + warp * 16 * pc, pc, tile, pc,
                            min(kc, d - c0));
    if (u % nc != nc - 1) continue;
    if (j == n_tiles - 1 && last_valid < kTcK) mask_keys(s, last_valid);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh] * scale_log2);
      alpha[hh] = fast_exp2(m_run[hh] - m_new);
      m_run[hh] = m_new;
      neg_m[hh] = -m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kTcK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = fast_exp2(fmaf(s[nt][e], scale_log2, neg_m[e / 2]));
#pragma unroll
    for (int dt = 0; dt < GW / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e] *= alpha[e / 2];
    // O += P V and l += P 1, P rounded to bf16 in registers as the A operand
    uint32_t pa[kTcK / 16][4];
    wide_pack_a(s, pa);
    wide_mma_av<GW>(o, pa, tile + kTcK * pc, kPg);
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) mma_bf16(l, pa[kk], ones, ones);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lr = l[2 * hh];
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= t_dim) continue;
    const float inv = 1.f / lr;
    bf16* orow = out + base + static_cast<size_t>(t) * tstride + g0;
#pragma unroll
    for (int dt = 0; dt < GW / 8; ++dt)
      if (dt * 8 < gw)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * quad) =
            __floats2bfloat162_rn(o[dt][2 * hh] * inv, o[dt][2 * hh + 1] * inv);
    if (quad == 0 && blockIdx.z == 0)
      lse[static_cast<size_t>(bh) * t_dim + t] = (m_run[hh] + log2f(lr)) * 0.69314718055994531f;
  }
}

int sm_count() {
  static int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// Q resident with the widest chunk of K that fits beside it, else Q streamed
template <int GW, int kQ>
cudaError_t launch_wide_rows(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                             int batch, int t_dim, int heads, int d, float scale,
                             cudaStream_t stream) {
  bool q_res = true;
  int kc = wide_chunk(d, [&](int c) { return wide_fwd_smem(d, c, GW, kQ, true); });
  if (kc == 0) {
    q_res = false;
    kc = wide_chunk(d, [&](int c) { return wide_fwd_smem(d, c, GW, kQ, false); });
  }
  if (kc == 0) return cudaErrorInvalidValue;
  const size_t smem = wide_fwd_smem(d, kc, GW, kQ, q_res);
  cudaError_t err = set_smem(flash_fwd_wide_tc_kernel<GW, kQ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(t_dim, kQ), batch * heads, ceil_div(d, GW));
  flash_fwd_wide_tc_kernel<GW, kQ><<<grid, 2 * kQ, smem, stream>>>(
      q, k, v, out, lse, t_dim, heads, d, kc, q_res, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// 128-query blocks (8 warps: each K and V tile serves twice the queries)
// where Q and the ring fit shared memory with K whole (nc = 1: up to D
// 320), else 64. (Measured at T 2400, 8 heads: 64-query blocks ran within
// 5% at D 160 and 1.34x slower at D 256 at B 2, 1.05x and 1.3x slower at B
// 1; warps of 32 rows x 32 keys, FlashAttention-2's tile at head dim 160,
// 1.14x slower at D 160; PERF.md section 6.)
template <int GW>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* out, float* lse,
                        int batch, int t_dim, int heads, int d, float scale,
                        cudaStream_t stream) {
  const void* rows[] = {q, k, v, out};   // 16-byte copies and bf16x2 stores
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const auto qb = static_cast<const bf16*>(q), kb = static_cast<const bf16*>(k),
             vb = static_cast<const bf16*>(v);
  const auto ob = static_cast<bf16*>(out);
  if (wide_fwd_smem(d, d, GW, 128, true) <= static_cast<size_t>(max_smem_optin()))
    return launch_wide_rows<GW, 128>(qb, kb, vb, ob, lse, batch, t_dim, heads, d, scale, stream);
  return launch_wide_rows<GW, 64>(qb, kb, vb, ob, lse, batch, t_dim, heads, d, scale, stream);
}

// ---- head dims past 128, float32: S once per key tile, in split TF32 ------
// flash_fwd_wide_tc_kernel's plan in float tiles (pitch width + 4): a block
// owns kQ queries of one (b, h), 16 a warp, and one column group of GW (grid
// z; the wrapper pads D to a multiple of 32, attention.head_dim_plan), its Q
// rows staged once at the whole padded D while they fit (else streamed with
// K, chunk by chunk). Per 64-key tile it computes S = Q K^T once over all of
// D (wide_tf32_abt: 20 k8 steps at D 160, each through the two-level sum),
// runs the online softmax in float with expf (flash_fwd_tf32_kernel's: no
// bf16 P, a thread's share of the row sums in float) and O += P V over the
// group's columns of V, P split as it leaves the accumulators (tf32_pfrag).
// Units stream through the two-stage cp.async ring, one barrier a unit:
// where Q, the whole of K and V's group fit twice beside Q, one unit a key
// tile; else V's group takes a unit of its own after K's nc chunks of kc
// columns (nc = 1 up to D 288), so float tiles, twice bf16's bytes, keep the
// chunks wide. A block takes 128 queries (8 warps: each unit serves twice
// the queries, and each scheduler has two warps to switch between) where Q
// and two whole K and V units fit (up to D 192), else 64; at D 160 a lo
// plane fits too (210 KB), and each unit is split once as it lands
// (kStaged: hi in place, a second barrier) instead of once a warp as it is
// read. At B 2, T 2400, 8 heads of 160 (NVIDIA H100 80GB HBM3, 700 W;
// `ab_variants --sections f32`, PERF.md section 6): 64 queries 4.06-4.08
// ms, 128 split as read 2.77-2.83, 128 split at staging 2.58-2.61. The
// group's last columns past D (a narrower last group) are computed on stale
// shared memory and not stored. What bounds it: 4 B H T^2 D multiply-adds,
// three TF32 products each, with the operands' splits and the two-level
// sums beside them, and B H T^2 expf per group.

// bytes of the float32 wide forward's shared memory at kq queries: Q where
// resident, the ring's units and, where staged, one unit's lo plane
static size_t wide_fwd_tf32_smem(int d, int kc, int gw, int kq, bool q_res, bool split_v,
                                 bool staged) {
  const size_t rows = q_res ? static_cast<size_t>(kq) * (d + 4) : 0;
  const size_t chunk = static_cast<size_t>(kAttnRows + (q_res ? 0 : kq)) * (kc + 4);
  const size_t group = static_cast<size_t>(kAttnRows) * (gw + 4);
  const size_t unit = split_v ? (chunk > group ? chunk : group) : chunk + group;
  return sizeof(float) * (rows + (kWideStages + staged) * unit);
}

template <int GW, int kQ, bool kStaged>
__global__ void __launch_bounds__(2 * kQ)
flash_fwd_wide_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int t_dim, int heads, int d, int kc,
                           bool q_res, bool split_v, float scale) {
  constexpr int kBlock = 2 * kQ;   // 32 threads a warp of 16 query rows
  constexpr int kPg = GW + 4;      // pitch of the V group tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int dp = d + 4, pc = kc + 4, nc = ceil_div(d, kc);
  float* qs = reinterpret_cast<float*>(tc_smem);   // [kQ][dp] where Q is resident
  // per stage: K's chunk [64][pc] (then Q's [kQ][pc] where Q streams) and,
  // where !split_v, V's group [64][kPg]; else V's group alone
  float* ring = qs + (q_res ? kQ * dp : 0);
  const int chunk = (kAttnRows + (q_res ? 0 : kQ)) * pc;
  const int unit = split_v ? max(chunk, kAttnRows * kPg) : chunk + kAttnRows * kPg;
  float* lo_plane = ring + kWideStages * unit;   // where kStaged (Q resident): a unit's lo
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int g0 = blockIdx.z * GW, gw = min(GW, d - g0);
  const size_t base = (static_cast<size_t>(b) * t_dim * heads + h) * d;
  const size_t tstride = static_cast<size_t>(heads) * d;
  const int n_tiles = ceil_div(t_dim, kAttnRows);
  const int last_valid = t_dim - (n_tiles - 1) * kAttnRows;
  const int per_tile = split_v ? nc + 1 : 1, units = n_tiles * per_tile;
  const auto stage = [&](int u) { return ring + (u % kWideStages) * unit; };
  // unit (j, r): r < nc, K's chunk r (with Q's where Q streams, and V's
  // group where !split_v); r == nc, V's group
  const auto load_unit = [&](int u) {
    if (u < units) {
      const int j = u / per_tile, r = u % per_tile;
      if (r < nc) {
        const int c0 = r * kc, w = min(kc, d - c0);
        wide_load_rows<kBlock>(stage(u), pc, k, base + c0, tstride, j * kAttnRows, t_dim, w);
        if (!q_res)
          wide_load_rows<kBlock, kQ>(stage(u) + kAttnRows * pc, pc, q, base + c0, tstride, q0,
                                     t_dim, w);
        if (!split_v)
          wide_load_rows<kBlock>(stage(u) + chunk, kPg, v, base + g0, tstride, j * kAttnRows,
                                 t_dim, gw);
      } else {
        wide_load_rows<kBlock>(stage(u), kPg, v, base + g0, tstride, j * kAttnRows, t_dim, gw);
      }
    }
    cp_async_commit();
  };

  if (q_res) wide_load_rows<kBlock, kQ>(qs, dp, q, base, tstride, q0, t_dim, d);
  for (int u = 0; u < kWideStages - 1; ++u) load_unit(u);   // with Q

  float o[GW / 8][4];
#pragma unroll
  for (int dt = 0; dt < GW / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows g and g + 8, scaled scores
  float l_run[2] = {0.f, 0.f};   // this thread's share of the rows' sums
  float s[kAttnRows / 8][4];

  for (int u = 0; u < units; ++u) {
    // unit u has landed, and every warp is done with unit u - 1, whose stage
    // unit u + 1 now takes
    cp_async_wait_group<kWideStages - 2>();
    __syncthreads();
    load_unit(u + kWideStages - 1);
    const int j = u / per_tile, r = u % per_tile;
    float* tile = stage(u);
    const int lo = static_cast<int>(lo_plane - tile);
    if constexpr (kStaged) {   // the unit split once, then read by every warp
      wide_tf32_split_unit<kBlock>(tile, lo, unit);
      __syncthreads();
    }
    if (r == 0) {
#pragma unroll
      for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    if (r < nc) {   // this warp's 16 query rows, resident or in the unit
      const int c0 = r * kc, w = min(kc, d - c0);
      if (q_res)
        wide_tf32_abt<kAttnRows, kStaged>(s, qs + warp * 16 * dp + c0, dp, tile, pc, w, lo);
      else
        wide_tf32_abt<kAttnRows>(s, tile + (kAttnRows + warp * 16) * pc, pc, tile, pc, w);
    }
    if (r == nc - 1) {   // S whole: the online softmax on the fragments, in float
      if (j == n_tiles - 1 && last_valid < kAttnRows) mask_keys(s, last_valid);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        // finite: every tile holds a key; scale > 0 keeps the max's place
        const float m_new = fmaxf(m_run[hh], mx[hh] * scale);
        alpha[hh] = expf(m_run[hh] - m_new);
        m_run[hh] = m_new;
        l_run[hh] *= alpha[hh];
      }
#pragma unroll
      for (int nt = 0; nt < kAttnRows / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(fmaf(s[nt][e], scale, -m_run[e / 2]));
          l_run[e / 2] += s[nt][e];
        }
#pragma unroll
      for (int dt = 0; dt < GW / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];
    }
    if (r != per_tile - 1) continue;
    // O += P V over the group's columns: V beside K's chunk, or a unit of its own
    const auto pfrag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
      tf32_pfrag(s, kk, ah, al);
    };
    wide_tf32_av<GW, kStaged>(o, pfrag, split_v ? tile : tile + chunk, kPg, lo);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l_run[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= t_dim) continue;
    const float inv = 1.f / lr;
    float* orow = out + base + static_cast<size_t>(row) * tstride + g0;
#pragma unroll
    for (int dt = 0; dt < GW / 8; ++dt)
      if (dt * 8 < gw)
        *reinterpret_cast<float2*>(orow + dt * 8 + 2 * t) =
            make_float2(o[dt][2 * hh] * inv, o[dt][2 * hh + 1] * inv);
    if (t == 0 && blockIdx.z == 0)
      lse[static_cast<size_t>(bh) * t_dim + row] = m_run[hh] + logf(lr);
  }
}

// Q resident with K whole and V's group in one unit where that fits; else V's
// group in a unit of its own, Q resident with the widest chunk of K that fits
// beside it, else Q streamed (never where kStaged: the caller has checked
// that Q, two whole K and V units and a lo plane fit).
template <int GW, int kQ, bool kStaged>
cudaError_t launch_wide_tf32_rows(const float* q, const float* k, const float* v, float* out,
                                  float* lse, int batch, int t_dim, int heads, int d,
                                  float scale, cudaStream_t stream) {
  const size_t limit = static_cast<size_t>(max_smem_optin());
  bool q_res = true, split_v = false;
  int kc = d;
  if (wide_fwd_tf32_smem(d, d, GW, kQ, true, false, kStaged) > limit) {
    split_v = true;
    kc = wide_chunk(d, [&](int c) {
      return wide_fwd_tf32_smem(d, c, GW, kQ, true, true, kStaged);
    });
    if (kc == 0 && !kStaged) {
      q_res = false;
      kc = wide_chunk(d, [&](int c) {
        return wide_fwd_tf32_smem(d, c, GW, kQ, false, true, false);
      });
    }
  }
  if (kc == 0) return cudaErrorInvalidValue;
  const size_t smem = wide_fwd_tf32_smem(d, kc, GW, kQ, q_res, split_v, kStaged);
  cudaError_t err = set_smem(flash_fwd_wide_tf32_kernel<GW, kQ, kStaged>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(t_dim, kQ), batch * heads, ceil_div(d, GW));
  flash_fwd_wide_tf32_kernel<GW, kQ, kStaged><<<grid, 2 * kQ, smem, stream>>>(
      q, k, v, out, lse, t_dim, heads, d, kc, q_res, split_v, scale);
  return cudaGetLastError();
}

template <int GW>
cudaError_t launch_wide_tf32(const void* q, const void* k, const void* v, void* out, float* lse,
                             int batch, int t_dim, int heads, int d, float scale,
                             cudaStream_t stream) {
  const void* rows[] = {q, k, v, out};   // 16-byte copies and float2 stores
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const auto qf = static_cast<const float*>(q), kf = static_cast<const float*>(k),
             vf = static_cast<const float*>(v);
  const auto of = static_cast<float*>(out);
  const size_t limit = static_cast<size_t>(max_smem_optin());
  // 128-query blocks where Q and two whole K and V units fit (never past GW
  // 192: 228 KB at D 224), K and V split at staging where a lo plane fits
  // too (only at D 160: 210 KB; 250 KB at 192), else 64 queries, split as read
  if constexpr (GW == 160) {
    if (wide_fwd_tf32_smem(d, d, GW, 128, true, true, true) <= limit)
      return launch_wide_tf32_rows<GW, 128, true>(qf, kf, vf, of, lse, batch, t_dim, heads, d,
                                                  scale, stream);
  }
  if constexpr (GW <= 192) {
    if (wide_fwd_tf32_smem(d, d, GW, 128, true, true, false) <= limit)
      return launch_wide_tf32_rows<GW, 128, false>(qf, kf, vf, of, lse, batch, t_dim, heads, d,
                                                   scale, stream);
  }
  return launch_wide_tf32_rows<GW, 64, false>(qf, kf, vf, of, lse, batch, t_dim, heads, d, scale,
                                              stream);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int batch, int t_dim, int heads, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    const void* rows[] = {q, k, v, out};   // 16-byte copies and bf16x2 stores
    for (const void* p : rows)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
    // 128-query blocks where they still make two waves of two blocks an SM
    if (ceil_div(t_dim, 128) * batch * heads >= 4 * sm_count())
      return launch_tc<D, 128>(q, k, v, out, lse, batch, t_dim, heads, scale, stream);
    return launch_tc<D, 64>(q, k, v, out, lse, batch, t_dim, heads, scale, stream);
  } else {
    return launch_tf32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<float*>(out), lse, batch,
                          t_dim, heads, scale, stream);
  }
}

// d and the column-group width of attention.head_dim_plan: d in {16, 32, 48,
// 64, 128} (one group of d); past 128, a multiple of 32 in groups of 160,
// 192, 224 or 256 (the wide kernels: bfloat16's, float32's in split TF32).
template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse,
                       int batch, int t_dim, int heads, int d, int group, float scale,
                       cudaStream_t s) {
  if (d <= 128 && group != d) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 48: return launch<T, 48>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, batch, t_dim, heads, scale, s);
    default: break;
  }
  if (d <= 128 || d % 32 != 0) return cudaErrorInvalidValue;
  constexpr bool kF = sizeof(T) == 4;
  switch (group) {
    case 160: return (kF ? launch_wide_tf32<160> : launch_wide<160>)(q, k, v, out, lse, batch, t_dim, heads, d, scale, s);
    case 192: return (kF ? launch_wide_tf32<192> : launch_wide<192>)(q, k, v, out, lse, batch, t_dim, heads, d, scale, s);
    case 224: return (kF ? launch_wide_tf32<224> : launch_wide<224>)(q, k, v, out, lse, batch, t_dim, heads, d, scale, s);
    case 256: return (kF ? launch_wide_tf32<256> : launch_wide<256>)(q, k, v, out, lse, batch, t_dim, heads, d, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Head dims and column groups: attention.head_dim_plan's (dispatch_d).
extern "C" int seld_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int batch, int t_dim, int heads, int d, int group,
                                   float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_d<float>(q, k, v, out, l, batch, t_dim, heads, d, group, scale, s);
  else if (dtype == kBF16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, l, batch, t_dim, heads, d, group, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
