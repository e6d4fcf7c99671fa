// Fused Hamilton-product matmul (K7): out = x @ assemble(comps) + bias, with
// the signed block weight assembled from its components inside the kernel.
//
// Replaces seld_tpu/ops/pallas/qmatmul.py::_hamilton_matmul (_matmul_kernel,
// _assemble_q, _assemble_dq), which pallas_q_linear and pallas_dq_linear
// call forward and, on the conjugate, for dx in their custom VJP. x is (M,
// n*cin_c), comps (n, cin_c, cout_c) with n = 4 (quaternion) or 8 (dual
// quaternion), out (M, n*cout_c). Weight element (r, c) lies in Hamilton
// block (a, b) = (r / cin_c, c / cout_c) and is sign * comps[idx][r % cin_c]
// [c % cout_c], with (idx, sign) = T[b][a] (conv table) or T[a][b] (linear
// table) of the 4 x 4 quaternion table, and for n = 8 the dual blocks: Q on
// both diagonal halves, Q_e (idx + 4) in one corner and zero in the other
// ((in >= 4, out < 4) zero for the conv table, (in < 4, out >= 4) for the
// linear one). At the flagship cin_c = cout_c = 48, so every 64-wide tile
// crosses block edges: the block is found per element (per 8 columns in
// bfloat16), not per tile. The assembled weight is never written to device
// memory.
//
// Products are summed in float32 (in float32, three TF32 products stand for
// each float32 product: float32's accuracy, held to float64 on the card),
// the bias (in x's dtype, or none) is added in float32, and the result is
// rounded once to x's dtype.
//
// What bounds it on the H100: in float32, operations (2.8 GFLOP at
// (9600, 384) x (384, 384): 0.042 ms against 67 TFLOP/s outside the tensor
// cores, 0.017 ms as three TF32 products at 495); in bfloat16, bytes (x and
// out, 14.7 MB at that shape, 4.4 us at 3.35 TB/s, against 2.9 us of
// tensor-core work).
//
// float32, hamilton_tf32_kernel: the bf16 kernel's tiles below (128 x 64
// blocks, 4 warps of 64 x 32, K in chunks of 32 through a two-stage ring)
// on float operands and mma.sync.m16n8k8 TF32 products in split TF32
// (mma.cuh: x = hi + lo, a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, each k8
// step's three products summed from zero on the tensor cores, then added to
// the float accumulators rounded to nearest, so no chain on the tensor
// cores is longer than one k8 step). x comes by 16-byte cp.async into
// [row][k] float rows of 36 words (4 mod 8: the 8 rows x 4 columns of an
// A fragment hit 32 banks; K = n cin_c is a multiple of 4, so only an
// unaligned x takes 4-byte loads); it is split into hi + lo as each warp
// reads its fragments (split once as its chunk landed, with a lo plane
// beside it, it ran 1.2-1.3x slower). The weight chunk is assembled and
// split once, as it is staged, into hi and lo planes [k][n]
// of 72 words (8 mod 32: a B fragment's 4 k rows x 8 columns hit 32 banks):
// where cout_c % 4 == 0, 4 columns never cross a Hamilton block, so each
// thread loads 4 components with one 16-byte load, negates them (exact) or
// zeroes them, and holds them in registers across the chunk's products,
// splitting them as it stores; else element by element. Every warp reads
// the weight's planes with no split of its own: each element is split once
// per block, not once per warp that reads it. Measured slower at M 9600,
// in turns (PERF.md section 6): three blocks an SM (registers capped at
// 168), 64-row blocks (kTfMI 2), a three-stage ring; the same time with
// each k8 step's products issued side by side (at 255 registers).
//
// bfloat16, hamilton_tc_kernel: mma.sync.m16n8k16 (bf16 operands, float
// accumulators). One block per (128-row, 64-column) output tile, 4 warps
// (2 along rows x 2 along columns), each a 64 x 32 tile of 4 x 4 m16n8
// fragments; K in chunks of 32 through a two-stage shared-memory ring: the
// next chunk loads while this one multiplies (kTcStages: a third stage
// measured no faster at the flagship, a fourth slower, its shared memory
// leaving too few blocks per SM). x comes by 16-byte cp.async
// into [row][k] (80-byte rows: the 8 rows of an ldmatrix hit 32 banks) and
// is read by plain ldmatrix as the A operand; a K that is not a multiple
// of 8 leaves the rows unaligned, so x then takes 2-byte loads. The weight
// chunk is assembled from comps into [k][n] (144-byte rows) and read by
// ldmatrix.trans as the B operand: where cout_c % 8 == 0, 8 columns never
// cross a Hamilton block, so each thread loads 8 components with one
// 16-byte load, flips their sign bits (exact) or zeroes them, and holds
// them in registers across the chunk's products; else element by element.
// Past K and past M or N the tiles are zero-filled, so any M, cin_c and
// cout_c work (a K % 16 != 0 ends in a zero-filled k16 step).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTcBM = 128;            // rows per block
constexpr int kTcBN = 64;             // columns per block
constexpr int kTcBK = 32;             // k per chunk: two k16 (four k8) steps
constexpr int kTcThreads = 128;       // 4 warps: 2 (rows) x 2 (columns)
constexpr int kTcXP = kTcBK + 8;      // padded x row: 40 bf16, 80 bytes
constexpr int kTcWP = kTcBN + 8;      // padded weight row: 72 bf16, 144 bytes
constexpr int kTcWVecs = kTcBK * kTcBN / 8 / kTcThreads;   // 8-column groups per thread
constexpr int kTcStages = 2;          // chunks in the ring: the next loads while one multiplies
constexpr int kTcStage = kTcBM * kTcXP + kTcBK * kTcWP;   // one chunk's x and weight (bf16)
constexpr size_t kTcSmem = sizeof(bf16) * kTcStages * kTcStage;

// float32 (split TF32): 4 warps (2 x 2) of kTfMI 16-row tiles x 32 columns,
// 32-bit words in shared memory
constexpr int kTfMI = 4;                    // 16-row tiles per warp
constexpr int kTfBM = 2 * 16 * kTfMI;       // rows per block
constexpr int kTfStages = 2;                // chunks in the ring
constexpr int kTfXP = kTcBK + 4;   // x row: 36 floats, 4 mod 8 words (A fragments hit 32 banks)
constexpr int kTfWP = kTcBN + 8;   // weight plane row: 72 words, 8 mod 32 (B fragments too)
constexpr int kTfWVecs = kTcBK * kTcBN / 4 / kTcThreads;   // 4-column groups per thread
constexpr int kTfStage = kTfBM * kTfXP + 2 * kTcBK * kTfWP;   // x, the weight's hi and lo
constexpr size_t kTfSmem = sizeof(float) * kTfStages * kTfStage;

// seld_tpu/ops/hamilton.py::Q_TABLE: T[i][j] = (component, sign)
__constant__ signed char kIdx[4][4] = {{0, 1, 2, 3}, {1, 0, 3, 2}, {2, 3, 0, 1}, {3, 2, 1, 0}};
__constant__ signed char kSgn[4][4] = {
    {1, -1, -1, -1}, {1, 1, -1, 1}, {1, 1, 1, -1}, {1, -1, 1, 1}};

// The component of Hamilton block (a, b) (input block a, output block b) and
// its sign; -1 for the dual-quaternion zero corner.
static __device__ __forceinline__ int hamilton_block(int a, int b, int linear_table, int& sgn) {
  const int qa = a & 3, da = a >> 2, qb = b & 3, db = b >> 2;
  int idx = linear_table ? kIdx[qa][qb] : kIdx[qb][qa];
  sgn = linear_table ? kSgn[qa][qb] : kSgn[qb][qa];
  if (da != db) {   // n = 8: the off-diagonal dual blocks
    if (linear_table ? da == 0 : da == 1) return -1;
    idx += 4;
  }
  return idx;
}

// ---- float32 on the tensor cores in split TF32 ------------------------------

// Stage the x chunk [m0, m0 + kTfBM) x [k0, k0 + 32) into xs [kTfBM][kTfXP]
// floats: 16-byte cp.async copies where rows are 16-byte aligned (zero-filled
// past M and K), else 4-byte loads.
static __device__ __forceinline__ void tf_stage_x(float* __restrict__ xs,
                                                  const float* __restrict__ x, int m0, int k0,
                                                  int m, int k_dim, bool xvec) {
  if (xvec) {
    for (int e = threadIdx.x; e < kTfBM * kTcBK / 4; e += kTcThreads) {
      const int r = e / (kTcBK / 4), u = e % (kTcBK / 4);
      const int row = m0 + r, k = k0 + 4 * u;
      const bool ok = row < m && k < k_dim;
      cp_async16(xs + r * kTfXP + 4 * u, ok ? x + static_cast<size_t>(row) * k_dim + k : x,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTfBM * kTcBK; e += kTcThreads) {
      const int r = e / kTcBK, kk = e % kTcBK;
      const int row = m0 + r, k = k0 + kk;
      xs[r * kTfXP + kk] = row < m && k < k_dim ? x[static_cast<size_t>(row) * k_dim + k] : 0.f;
    }
  }
}

// The weight chunk [k0, k0 + 32) x [n0, n0 + 64) in registers, 4 columns per
// 16-byte item (cout_c % 4 == 0: the 4 columns lie in one Hamilton block):
// the components with their sign bits flipped, zero in the DQ zero corner
// and past K and N.
static __device__ __forceinline__ void tf_load_w(float4 (&wr)[kTfWVecs],
                                                 const float* __restrict__ comps, int k0,
                                                 int n0, int k_dim, int n_dim, int cin_c,
                                                 int cout_c, int linear_table) {
#pragma unroll
  for (int j = 0; j < kTfWVecs; ++j) {
    const int e = threadIdx.x + j * kTcThreads;
    const int r = k0 + e / (kTcBN / 4), c = n0 + 4 * (e % (kTcBN / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < k_dim && c < n_dim) {
      const int a = r / cin_c, b = c / cout_c;
      int sgn;
      const int idx = hamilton_block(a, b, linear_table, sgn);
      if (idx >= 0) {
        v = __ldg(reinterpret_cast<const float4*>(
            comps + (static_cast<size_t>(idx) * cin_c + r - a * cin_c) * cout_c + c - b * cout_c));
        if (sgn < 0) v = make_float4(-v.x, -v.y, -v.z, -v.w);
      }
    }
    wr[j] = v;
  }
}

// The weight chunk split into its hi and lo planes [32][kTfWP] as it is stored.
static __device__ __forceinline__ void tf_store_w(uint32_t* __restrict__ whi,
                                                  uint32_t* __restrict__ wlo,
                                                  const float4 (&wr)[kTfWVecs]) {
#pragma unroll
  for (int j = 0; j < kTfWVecs; ++j) {
    const int e = threadIdx.x + j * kTcThreads;
    const int at = (e / (kTcBN / 4)) * kTfWP + 4 * (e % (kTcBN / 4));
    uint4 hi, lo;
    split_tf32(wr[j].x, hi.x, lo.x);
    split_tf32(wr[j].y, hi.y, lo.y);
    split_tf32(wr[j].z, hi.z, lo.z);
    split_tf32(wr[j].w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(whi + at) = hi;
    *reinterpret_cast<uint4*>(wlo + at) = lo;
  }
}

// The same chunk element by element (any cout_c), split and stored straight
// to the planes.
static __device__ __forceinline__ void tf_stage_w_scalar(uint32_t* __restrict__ whi,
                                                         uint32_t* __restrict__ wlo,
                                                         const float* __restrict__ comps,
                                                         int k0, int n0, int k_dim, int n_dim,
                                                         int cin_c, int cout_c,
                                                         int linear_table) {
  for (int e = threadIdx.x; e < kTcBK * kTcBN; e += kTcThreads) {
    const int kk = e / kTcBN, nn = e % kTcBN;
    const int r = k0 + kk, c = n0 + nn;
    float v = 0.f;
    if (r < k_dim && c < n_dim) {
      const int a = r / cin_c, b = c / cout_c;
      int sgn;
      const int idx = hamilton_block(a, b, linear_table, sgn);
      if (idx >= 0) {
        v = comps[(static_cast<size_t>(idx) * cin_c + r - a * cin_c) * cout_c + c - b * cout_c];
        if (sgn < 0) v = -v;
      }
    }
    split_tf32(v, whi[kk * kTfWP + nn], wlo[kk * kTfWP + nn]);
  }
}

__global__ void __launch_bounds__(kTcThreads)
hamilton_tf32_kernel(const float* __restrict__ x, const float* __restrict__ comps,
                     const float* __restrict__ bias, float* __restrict__ out, int m, int n_comp,
                     int cin_c, int cout_c, int linear_table) {
  extern __shared__ __align__(16) unsigned char hm_smem[];   // kTfStages chunks of kTfStage words
  const auto xs = [&](int c) {
    return reinterpret_cast<float*>(hm_smem) + (c % kTfStages) * kTfStage;
  };
  const auto whi = [&](int c) { return reinterpret_cast<uint32_t*>(xs(c) + kTfBM * kTfXP); };
  const auto wlo = [&](int c) { return whi(c) + kTcBK * kTfWP; };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int m0 = blockIdx.x * kTfBM, n0 = blockIdx.y * kTcBN;
  const int k_dim = n_comp * cin_c, n_dim = n_comp * cout_c;
  const int steps = ceil_div(k_dim, kTcBK);
  const bool xvec = k_dim % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = cout_c % 4 == 0 && reinterpret_cast<uintptr_t>(comps) % 16 == 0;

  float acc[kTfMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kTfMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // chunk c: x by cp.async (one commit group per chunk, empty past the last),
  // the weight into registers (wvec, split and stored after the products) or
  // split straight into its planes
  float4 wr[kTfWVecs];
  const auto load_chunk = [&](int c) {
    if (c < steps) {
      tf_stage_x(xs(c), x, m0, c * kTcBK, m, k_dim, xvec);
      if (wvec)
        tf_load_w(wr, comps, c * kTcBK, n0, k_dim, n_dim, cin_c, cout_c, linear_table);
      else
        tf_stage_w_scalar(whi(c), wlo(c), comps, c * kTcBK, n0, k_dim, n_dim, cin_c, cout_c,
                          linear_table);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kTfStages - 1; ++c) {
    load_chunk(c);
    if (wvec && c < steps) tf_store_w(whi(c), wlo(c), wr);
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_group<kTfStages - 2>();   // chunk s has landed (this thread's copies)
    __syncthreads();   // ... everyone's; chunk s - 1's readers are done with its buffer
    const int c = s + kTfStages - 1;   // into chunk s - 1's buffer
    load_chunk(c);
    const float* xr = xs(s) + (warp_m * 16 * kTfMI + g) * kTfXP + t;
    const uint32_t* bh_r = whi(s) + t * kTfWP + warp_n * 32 + g;
    const uint32_t* bl_r = wlo(s) + t * kTfWP + warp_n * 32 + g;
#pragma unroll
    for (int ks = 0; ks < kTcBK / 8; ++ks) {
      // A (rows g, g + 8 x k t, t + 4) of each 16-row tile, split into hi + lo
      uint32_t ah[kTfMI][4], al[kTfMI][4];
#pragma unroll
      for (int mi = 0; mi < kTfMI; ++mi) {
        const int at = mi * 16 * kTfXP + 8 * ks;
        split_tf32(xr[at], ah[mi][0], al[mi][0]);
        split_tf32(xr[at + 8 * kTfXP], ah[mi][1], al[mi][1]);
        split_tf32(xr[at + 4], ah[mi][2], al[mi][2]);
        split_tf32(xr[at + 8 * kTfXP + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {   // B (k t, t + 4 x n g), staged split
        const int at = 8 * ks * kTfWP + ni * 8;
        const uint32_t bh[2] = {bh_r[at], bh_r[at + 4 * kTfWP]};
        const uint32_t bl[2] = {bl_r[at], bl_r[at + 4 * kTfWP]};
#pragma unroll
        for (int mi = 0; mi < kTfMI; ++mi) mma_3xtf32_add(acc[mi][ni], ah[mi], al[mi], bh, bl);
      }
    }
    if (wvec && c < steps) tf_store_w(whi(c), wlo(c), wr);
  }

  const bool pairs = n_dim % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < kTfMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + warp_m * 16 * kTfMI + mi * 16 + g + 8 * hh;
      if (row >= m) continue;
      float* orow = out + static_cast<size_t>(row) * n_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + warp_n * 32 + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * hh] + (bias && c < n_dim ? bias[c] : 0.f);
        const float v1 = acc[mi][ni][2 * hh + 1] + (bias && c + 1 < n_dim ? bias[c + 1] : 0.f);
        if (pairs && c + 1 < n_dim) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else {
          if (c < n_dim) orow[c] = v0;
          if (c + 1 < n_dim) orow[c + 1] = v1;
        }
      }
    }
}

// ---- bfloat16 on the tensor cores ------------------------------------------

// Stage the x chunk [m0, m0 + 128) x [k0, k0 + 32) into xs [128][kTcXP]:
// 16-byte cp.async copies where rows are 16-byte aligned (zero-filled past M
// and K), else 2-byte loads.
static __device__ __forceinline__ void hm_stage_x(bf16* __restrict__ xs,
                                                  const bf16* __restrict__ x, int m0, int k0,
                                                  int m, int k_dim, bool xvec) {
  if (xvec) {
    for (int e = threadIdx.x; e < kTcBM * kTcBK / 8; e += kTcThreads) {
      const int r = e / (kTcBK / 8), u = e % (kTcBK / 8);
      const int row = m0 + r, k = k0 + 8 * u;
      const bool ok = row < m && k < k_dim;
      cp_async16(xs + r * kTcXP + 8 * u, ok ? x + static_cast<size_t>(row) * k_dim + k : x,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTcBM * kTcBK; e += kTcThreads) {
      const int r = e / kTcBK, kk = e % kTcBK;
      const int row = m0 + r, k = k0 + kk;
      xs[r * kTcXP + kk] = row < m && k < k_dim ? x[static_cast<size_t>(row) * k_dim + k]
                                                : __float2bfloat16(0.f);
    }
  }
}

// The weight chunk [k0, k0 + 32) x [n0, n0 + 64) in registers, 8 columns per
// 16-byte item (cout_c % 8 == 0: the 8 columns lie in one Hamilton block):
// the components with their sign bits flipped, zero in the DQ zero corner
// and past K and N.
static __device__ __forceinline__ void hm_load_w(uint4 (&wr)[kTcWVecs],
                                                 const bf16* __restrict__ comps, int k0, int n0,
                                                 int k_dim, int n_dim, int cin_c, int cout_c,
                                                 int linear_table) {
#pragma unroll
  for (int j = 0; j < kTcWVecs; ++j) {
    const int e = threadIdx.x + j * kTcThreads;
    const int r = k0 + e / (kTcBN / 8), c = n0 + 8 * (e % (kTcBN / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < k_dim && c < n_dim) {
      const int a = r / cin_c, b = c / cout_c;
      int sgn;
      const int idx = hamilton_block(a, b, linear_table, sgn);
      if (idx >= 0) {
        v = __ldg(reinterpret_cast<const uint4*>(
            comps + (static_cast<size_t>(idx) * cin_c + r - a * cin_c) * cout_c + c - b * cout_c));
        if (sgn < 0) {
          v.x ^= 0x80008000u;
          v.y ^= 0x80008000u;
          v.z ^= 0x80008000u;
          v.w ^= 0x80008000u;
        }
      }
    }
    wr[j] = v;
  }
}

static __device__ __forceinline__ void hm_store_w(bf16* __restrict__ ws,
                                                  const uint4 (&wr)[kTcWVecs]) {
#pragma unroll
  for (int j = 0; j < kTcWVecs; ++j) {
    const int e = threadIdx.x + j * kTcThreads;
    *reinterpret_cast<uint4*>(ws + (e / (kTcBN / 8)) * kTcWP + 8 * (e % (kTcBN / 8))) = wr[j];
  }
}

// The same chunk element by element (any cout_c), stored straight to ws.
static __device__ __forceinline__ void hm_stage_w_scalar(bf16* __restrict__ ws,
                                                         const bf16* __restrict__ comps, int k0,
                                                         int n0, int k_dim, int n_dim, int cin_c,
                                                         int cout_c, int linear_table) {
  for (int e = threadIdx.x; e < kTcBK * kTcBN; e += kTcThreads) {
    const int kk = e / kTcBN, nn = e % kTcBN;
    const int r = k0 + kk, c = n0 + nn;
    bf16 v = __float2bfloat16(0.f);
    if (r < k_dim && c < n_dim) {
      const int a = r / cin_c, b = c / cout_c;
      int sgn;
      const int idx = hamilton_block(a, b, linear_table, sgn);
      if (idx >= 0) {
        v = comps[(static_cast<size_t>(idx) * cin_c + r - a * cin_c) * cout_c + c - b * cout_c];
        if (sgn < 0) v = __hneg(v);
      }
    }
    ws[kk * kTcWP + nn] = v;
  }
}

__global__ void __launch_bounds__(kTcThreads, 4)
hamilton_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ comps,
                   const bf16* __restrict__ bias, bf16* __restrict__ out, int m, int n_comp,
                   int cin_c, int cout_c, int linear_table) {
  extern __shared__ __align__(16) unsigned char hm_smem[];   // kTcStages x (x, weight) chunks
  const auto xs = [&](int c) {
    return reinterpret_cast<bf16*>(hm_smem) + (c % kTcStages) * kTcStage;
  };
  const auto ws = [&](int c) { return xs(c) + kTcBM * kTcXP; };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int m0 = blockIdx.x * kTcBM, n0 = blockIdx.y * kTcBN;
  const int k_dim = n_comp * cin_c, n_dim = n_comp * cout_c;
  const int steps = ceil_div(k_dim, kTcBK);
  const bool xvec = k_dim % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = cout_c % 8 == 0 && reinterpret_cast<uintptr_t>(comps) % 16 == 0;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // chunk c: x by cp.async (one commit group per chunk, empty past the last),
  // the weight into registers (wvec, stored after the products) or straight
  // to shared memory
  uint4 wr[kTcWVecs];
  const auto load_chunk = [&](int c) {
    if (c < steps) {
      hm_stage_x(xs(c), x, m0, c * kTcBK, m, k_dim, xvec);
      if (wvec)
        hm_load_w(wr, comps, c * kTcBK, n0, k_dim, n_dim, cin_c, cout_c, linear_table);
      else
        hm_stage_w_scalar(ws(c), comps, c * kTcBK, n0, k_dim, n_dim, cin_c, cout_c,
                          linear_table);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kTcStages - 1; ++c) {
    load_chunk(c);
    if (wvec && c < steps) hm_store_w(ws(c), wr);
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_group<kTcStages - 2>();   // chunk s has landed (this thread's copies)
    __syncthreads();   // ... everyone's; chunk s - 1's readers are done with its buffer
    const int c = s + kTcStages - 1;   // into chunk s - 1's buffer
    load_chunk(c);
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)   // (m 0-7 | 8-15) x (k 0-7 | 8-15) by lane / 8
        ldsm_x4(xs(s) + (warp_m * 64 + mi * 16 + lane % 16) * kTcXP + ks * 16 + (lane / 16) * 8,
                a[mi]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {   // (k 0-7 | 8-15) x (n 0-7 | 8-15), transposed
        uint32_t t4[4];
        ldsm_x4_t(ws(s) + (ks * 16 + lane % 16) * kTcWP + warp_n * 32 + nj * 16 + (lane / 16) * 8,
                  t4);
        b[2 * nj][0] = t4[0];
        b[2 * nj][1] = t4[1];
        b[2 * nj + 1][0] = t4[2];
        b[2 * nj + 1][1] = t4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    if (wvec && c < steps) hm_store_w(ws(c), wr);
  }

  const bool pairs = n_dim % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + warp_m * 64 + mi * 16 + lane / 4 + 8 * hh;
      if (row >= m) continue;
      bf16* orow = out + static_cast<size_t>(row) * n_dim;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + warp_n * 32 + ni * 8 + 2 * (lane % 4);
        const float b0 = bias && c < n_dim ? to_f(bias[c]) : 0.f;
        const float b1 = bias && c + 1 < n_dim ? to_f(bias[c + 1]) : 0.f;
        const float v0 = acc[mi][ni][2 * hh] + b0, v1 = acc[mi][ni][2 * hh + 1] + b1;
        if (pairs && c + 1 < n_dim) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < n_dim) orow[c] = __float2bfloat16(v0);
          if (c + 1 < n_dim) orow[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* comps, const void* bias, void* out, int m,
                   int n_comp, int cin_c, int cout_c, int linear_table, cudaStream_t stream) {
  dim3 grid(ceil_div(m, sizeof(T) == 2 ? kTcBM : kTfBM), ceil_div(n_comp * cout_c, kTcBN));
  if constexpr (sizeof(T) == 2) {
    const cudaError_t err = set_smem(hamilton_tc_kernel, kTcSmem);
    if (err != cudaSuccess) return err;
    hamilton_tc_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(comps),
        static_cast<const bf16*>(bias),
        static_cast<bf16*>(out), m, n_comp, cin_c, cout_c, linear_table);
  } else {
    const cudaError_t err = set_smem(hamilton_tf32_kernel, kTfSmem);
    if (err != cudaSuccess) return err;
    hamilton_tf32_kernel<<<grid, kTcThreads, kTfSmem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(comps),
        static_cast<const float*>(bias), static_cast<float*>(out), m, n_comp, cin_c, cout_c,
        linear_table);
  }
  return cudaGetLastError();
}

}  // namespace

// x (m, n*cin_c), comps (n, cin_c, cout_c) and bias (n*cout_c,) in dtype
// (bias null: none); out (m, n*cout_c) in dtype; linear_table 0 (conv
// table) or 1.
// float32 runs the split-TF32 kernel, bfloat16 the bf16 one, both on the
// tensor cores.
extern "C" int seld_hamilton_matmul(const void* x, const void* comps, const void* bias,
                                    void* out, int m, int n_comp, int cin_c, int cout_c,
                                    int linear_table, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m <= 0 || (n_comp != 4 && n_comp != 8) || cin_c <= 0 || cout_c <= 0 ||
      ceil_div(n_comp * cout_c, kTcBN) > 65535)
    err = cudaErrorInvalidValue;
  else if (dtype == kF32)
    err = launch<float>(x, comps, bias, out, m, n_comp, cin_c, cout_c, linear_table, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(x, comps, bias, out, m, n_comp, cin_c, cout_c, linear_table,
                                s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
