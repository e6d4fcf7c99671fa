// int8 post-training-quantized matmul (K8): out = dequant(quant(x) @ w_q) + bias
// with per-row dynamic activation quantization, on the int8 tensor cores.
//
// Replaces seld_tpu/ops/pallas/quant.py::int8_matmul (_int8_matmul_kernel).
// The arithmetic is the XLA-compiled form of quant.py:41-53, which is what
// the JAX kernel computes (the source's `amax / 127.0` is compiled to a
// multiplication by float32(1/127), and the epilogue to one fma):
//   xf  = float(x)                       amax = max_k |xf[k]|   (per row)
//   xs  = amax > 0 ? amax * float32(1/127) : 1
//   xq  = clamp(rint(xf / xs), -127, 127)       true IEEE division, ties to even
//   acc = sum_k xq[k] * w_q[k][col]             int32, exact in any order
//   out = fmaf(float(acc) * xs, w_scale[col], bias[col]), rounded once to x's dtype
// The division, the rounding and the fma are written as intrinsics
// (__fdiv_rn, __float2int_rn, __fmul_rn, fmaf), so that neither a fast-math
// flag nor nvcc's contraction rules decide them; the sum is exact, so the
// output is bit-equal to the plain version's.
//
// What bounds it on the H100: at the flagship shapes ((B*4800, 384) bf16 x
// (384, 384) int8) the bytes, ~14.9 MB at batch 2 (0.0044 ms), against 2.8
// GOP that the int8 tensor cores do in a third of that time. Design:
// - The weight goes in as w_t (Cout, k_pad) int8, K contiguous and zero past
//   Cin, so that a B fragment of mma.m16n8k32.row.col is one ldmatrix of
//   16-byte rows; k_pad = Cin rounded up to 32 (zero k adds nothing to the
//   exact sum).
// - Two launches. int8_prepare_kernel quantizes each row once, writing xq
//   (M, k_pad) int8 and xs (M,) float, and writes w_t in blocks of its own.
//   The GEMM's grid is row tiles x 128-column passes, one pass a block.
// - A block owns kBM rows: 64, or 32 where 64-row blocks would not fill
//   the card or do not fit shared memory (Cin past 3008); the wrapper picks
//   (quant.py::row_tile). Its int8 x tile is staged by cp.async in the
//   layout the A fragments read (rows padded to an odd multiple of 16
//   bytes: ldmatrix is conflict-free). Warps are (kBM / 32) x 4, each a
//   32 x 32 tile of int32 sums (2 x 4 m16n8 fragments).
// - The weight streams through a double buffer of (128 columns x 128 k)
//   chunks by cp.async, so the next chunk lands while this one's products
//   run.
// - The epilogue stages the block's output tile in the weight buffers and
//   writes its rows in whole 16-byte pieces.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kInvQmax = 1.0f / 127.0f;   // float32(1/127), folded by the compiler
constexpr int kBN = 128;                    // output columns per pass
constexpr int kKC = 128;                    // k per weight chunk: four k32 steps
constexpr int kStages = 2;                  // weight chunks in shared memory: double buffer
constexpr int kBRow = kKC + 16;             // padded chunk row: 144 bytes
constexpr int kBChunk = kBN * kBRow;        // bytes per buffer
constexpr size_t kMaxSmem = 232448;         // shared memory one block may use on the H100
// A staged output row of the epilogue: kBN values and 16 bytes of
// pad (conflict-free pair stores); 64 rows fit the weight buffers.
template <typename T>
constexpr int kOutRow = kBN + 16 / sizeof(T);
static_assert(64 * kOutRow<float> * 4 <= kStages * kBChunk, "the staged tile fits the buffers");

static __device__ __forceinline__ int quantize(float v, float xs) {
  const int q = __float2int_rn(__fdiv_rn(v, xs));
  return max(-127, min(127, q));
}

static __device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (static_cast<uint32_t>(d) << 24);
}

static __device__ __forceinline__ float row_scale_of(float amax) {
  return amax > 0.f ? __fmul_rn(amax, kInvQmax) : 1.f;
}

// d += a (16 x 32 int8, row fragment) * b (32 x 8 int8, column fragment), int32 sums.
static __device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two outputs of one row, adjacent columns.
static __device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
static __device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

static __host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of a block: row scales, the int8 tile and the weight ring.
static __host__ __device__ constexpr size_t mm_smem_bytes(int bm, int k_pad) {
  return static_cast<size_t>(align16(bm * 4)) + static_cast<size_t>(bm) * (k_pad + 16) +
         static_cast<size_t>(kStages) * kBChunk;
}

constexpr int kQVecs = 4;   // 16-byte pieces of a row a lane holds: bf16 Cin <= 1024, float 512

// Element i of a 16-byte piece of T.
template <typename T>
static __device__ __forceinline__ float piece_elem(const uint4& v, int i) {
  return to_f(reinterpret_cast<const T*>(&v)[i]);
}

// The first launch. Blocks [0, w_blocks): w_q (cin, cout)
// int8 -> w_t (cout, k_pad), zero past cin, one word (4 k) a thread,
// consecutive threads on consecutive columns (coalesced reads). Blocks past
// them: x (m, cin) in T -> xq (m, k_pad) int8 (zero past cin) and xs (m,)
// float, one warp a row, 8 rows a block; a row of 16-byte pieces (xvec) is
// read once into registers, else element by element, twice.
template <typename T>
__global__ void __launch_bounds__(256)
int8_prepare_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                    const int8_t* __restrict__ w_q, int8_t* __restrict__ w_t, int m, int cin,
                    int k_pad, int cout, int w_blocks, bool xvec) {
  if (static_cast<int>(blockIdx.x) < w_blocks) {
    const int e = blockIdx.x * 256 + threadIdx.x;
    if (e >= cout * (k_pad / 4)) return;
    const int n = e % cout, k = 4 * (e / cout);
    int q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = k + i < cin ? w_q[static_cast<size_t>(k + i) * cout + n] : 0;
    *reinterpret_cast<uint32_t*>(w_t + static_cast<size_t>(n) * k_pad + k) =
        pack4(q[0], q[1], q[2], q[3]);
    return;
  }
  constexpr int kPer = 16 / sizeof(T);   // elements a piece
  const int lane = threadIdx.x % 32;
  const int row = (blockIdx.x - w_blocks) * 8 + threadIdx.x / 32;
  if (row >= m) return;
  const T* xr = x + static_cast<size_t>(row) * cin;
  uint32_t* dst = reinterpret_cast<uint32_t*>(xq + static_cast<size_t>(row) * k_pad);
  float amax = 0.f, s;
  if (xvec && cin <= 32 * kQVecs * kPer) {
    uint4 v[kQVecs];
#pragma unroll
    for (int j = 0; j < kQVecs; ++j) {
      const int k = (lane + 32 * j) * kPer;
      if (k < cin) {
        v[j] = *reinterpret_cast<const uint4*>(xr + k);
#pragma unroll
        for (int i = 0; i < kPer; ++i) amax = fmaxf(amax, fabsf(piece_elem<T>(v[j], i)));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    s = row_scale_of(amax);
#pragma unroll
    for (int j = 0; j < kQVecs; ++j) {
      const int k = (lane + 32 * j) * kPer;
      if (k < cin) {
#pragma unroll
        for (int w = 0; w < kPer / 4; ++w)
          dst[k / 4 + w] = pack4(quantize(piece_elem<T>(v[j], 4 * w), s),
                                 quantize(piece_elem<T>(v[j], 4 * w + 1), s),
                                 quantize(piece_elem<T>(v[j], 4 * w + 2), s),
                                 quantize(piece_elem<T>(v[j], 4 * w + 3), s));
      }
    }
    for (int k4 = cin / 4 + lane; k4 < k_pad / 4; k4 += 32) dst[k4] = 0u;   // cin % 4 == 0 here
  } else {
    for (int k = lane; k < cin; k += 32) amax = fmaxf(amax, fabsf(to_f(xr[k])));
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    s = row_scale_of(amax);
    for (int k4 = lane; k4 < k_pad / 4; k4 += 32) {
      int q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * k4 + i;
        q[i] = k < cin ? quantize(to_f(xr[k]), s) : 0;
      }
      dst[k4] = pack4(q[0], q[1], q[2], q[3]);
    }
  }
  if (lane == 0) xs[row] = s;
}

// Chunk c of the weight walk (pass c / n_kc, k chunk c % n_kc) into its
// buffer: 128 rows of w_t (output columns) x 128 k, zero past Cout and k_pad.
template <int kThreads>
static __device__ __forceinline__ void load_w_chunk(int8_t* ring, const int8_t* __restrict__ w_t,
                                                    int c, int n_kc, int cout, int k_pad) {
  const int n0 = (c / n_kc) * kBN, k0 = (c % n_kc) * kKC;
  int8_t* dst = ring + (c % kStages) * kBChunk;
  for (int e = threadIdx.x; e < kBN * (kKC / 16); e += kThreads) {
    const int r = e / (kKC / 16), k = k0 + 16 * (e % (kKC / 16));
    const bool in = n0 + r < cout && k < k_pad;
    cp_async16(dst + r * kBRow + (k - k0),
               w_t + (in ? static_cast<size_t>(n0 + r) * k_pad + k : 0), in ? 16 : 0);
  }
}

// The bias of a column: none, float or bf16 (the layers pass it in x's dtype).
static __device__ __forceinline__ float bias_at(const void* bias, int code, int col) {
  if (bias == nullptr) return 0.f;
  return code == kF32 ? static_cast<const float*>(bias)[col]
                      : to_f(static_cast<const __nv_bfloat16*>(bias)[col]);
}

// The GEMM, block (row tile, 128-column pass): xq (m, k_pad) int8 and xs
// (m,) from int8_prepare_kernel; w_t (cout, k_pad) int8; w_scale (cout,)
// float; bias (cout,) float or bf16 (bias_code) or null; out (m, cout) in T.
// ovec: out rows are whole 16-byte pieces (cout * sizeof(T) % 16 == 0, out
// 16-byte aligned).
template <typename T, int kBM>
__global__ void __launch_bounds__(kBM * 4)
int8_matmul_tc_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const int8_t* __restrict__ w_t, const float* __restrict__ w_scale,
                      const void* __restrict__ bias, int bias_code, T* __restrict__ out, int m,
                      int k_pad, int cout, bool ovec) {
  constexpr int kThreads = kBM * 4;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  float* row_scale = reinterpret_cast<float*>(mm_smem);
  int8_t* as = reinterpret_cast<int8_t*>(mm_smem + align16(kBM * 4));
  const int a_row = k_pad + 16;   // odd multiple of 16 bytes
  int8_t* ring = as + kBM * a_row;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int n_kc = ceil_div(k_pad, kKC);
  // the block's chunks: those of pass blockIdx.y
  const int c_first = blockIdx.y * n_kc;
  const int c_end = c_first + n_kc;

  // the int8 x tile: group 0
  for (int e = threadIdx.x; e < kBM * (k_pad / 16); e += kThreads) {
    const int r = e / (k_pad / 16), k = 16 * (e % (k_pad / 16));
    const bool in = m0 + r < m;
    cp_async16(as + r * a_row + k, xq + (in ? static_cast<size_t>(m0 + r) * k_pad + k : 0),
               in ? 16 : 0);
  }
  for (int r = threadIdx.x; r < kBM; r += kThreads) row_scale[r] = m0 + r < m ? xs[m0 + r] : 1.f;
  cp_async_commit();
  // the first weight chunks: groups 1 .. kStages - 1
#pragma unroll
  for (int c = c_first; c < c_first + kStages - 1; ++c) {
    if (c < c_end) load_w_chunk<kThreads>(ring, w_t, c, n_kc, cout, k_pad);
    cp_async_commit();
  }

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int c = c_first; c < c_end; ++c) {
    const int kc = c - c_first;
    cp_async_wait_group<kStages - 2>();   // chunk c (and the x tile) landed
    __syncthreads();                      // ... for every thread; chunk c - 1's stage is free
    if (c + kStages - 1 < c_end)
      load_w_chunk<kThreads>(ring, w_t, c + kStages - 1, n_kc, cout, k_pad);
    cp_async_commit();
    const int8_t* b_buf = ring + (c % kStages) * kBChunk;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 32) {
      const int k = kc * kKC + kk;
      if (k >= k_pad) break;   // k_pad % 128 != 0: the last chunk's tail
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(as + (warp_m * 32 + mi * 16 + lane % 16) * a_row + k + (lane / 16) * 16, a[mi]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
        uint32_t b[4];
        ldsm_x4(b_buf + (warp_n * 32 + nj * 16 + lane % 8 + 8 * (lane / 16)) * kBRow + kk +
                    16 * ((lane / 8) % 2),
                b);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_s8(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // the epilogue: rows warp_m * 32 + 16 mi + lane / 4 (+ 8), columns n0
  // + warp_n * 32 + 8 ni + 2 (lane % 4) (+ 1): the m16n8 layout
  float ws[4][2], bs[4][2];   // this thread's 8 columns' scale and bias
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + warp_n * 32 + ni * 8 + 2 * (lane % 4) + j;
      ws[ni][j] = col < cout ? w_scale[col] : 0.f;
      bs[ni][j] = col < cout ? bias_at(bias, bias_code, col) : 0.f;
    }
  // both weight buffers are free once every warp is past its products
  // (the last chunk's group waited for; none other in flight): the tile
  // is staged there and its rows written in whole 16-byte pieces
  T* os = reinterpret_cast<T*>(ring);   // [kBM][kOutRow]
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp_m * 32 + mi * 16 + lane / 4 + 8 * h;
      const float s = row_scale[r];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp_n * 32 + ni * 8 + 2 * (lane % 4);
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[j] = fmaf(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h + j]), s), ws[ni][j],
                      bs[ni][j]);
        store_pair(os + r * kOutRow<T> + col - n0, v[0], v[1]);
      }
    }
  __syncthreads();
  constexpr int kPer = 16 / sizeof(T), kPieces = kBN / kPer;
  for (int e = threadIdx.x; e < kBM * kPieces; e += kThreads) {
    const int r = e / kPieces, col = n0 + kPer * (e % kPieces);
    if (m0 + r >= m || col >= cout) continue;
    T* dst = out + static_cast<size_t>(m0 + r) * cout + col;
    const T* src = os + r * kOutRow<T> + col - n0;
    if (ovec && col + kPer <= cout) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < kPer && col + i < cout; ++i) dst[i] = src[i];
    }
  }
}

// The C entry's arguments.
struct MmArgs {
  const void* x;
  const int8_t* w_q;
  int8_t* w_t;
  const float* w_scale;
  const void* bias;
  void* out;
  int8_t* xq;
  float* xs;
  int m, cin, k_pad, cout, bias_code;
  cudaStream_t stream;
};

template <typename T, int kBM>
cudaError_t launch_gemm(const MmArgs& a) {
  const size_t smem = mm_smem_bytes(kBM, a.k_pad);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(int8_matmul_tc_kernel<T, kBM>, smem);
  if (err != cudaSuccess) return err;
  const bool ovec = (static_cast<size_t>(a.cout) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const dim3 grid(ceil_div(a.m, kBM), ceil_div(a.cout, kBN));
  int8_matmul_tc_kernel<T, kBM><<<grid, kBM * 4, smem, a.stream>>>(
      a.xq, a.xs, a.w_t, a.w_scale, a.bias, a.bias_code, static_cast<T*>(a.out), a.m, a.k_pad,
      a.cout, ovec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const MmArgs& a, int bm) {
  const int row_blocks = ceil_div(a.m, 8);
  const int w_blocks = ceil_div(a.cout * (a.k_pad / 4), 256);
  const bool xvec = (static_cast<size_t>(a.cin) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  int8_prepare_kernel<T><<<w_blocks + row_blocks, 256, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.xq, a.xs, a.w_q, a.w_t, a.m, a.cin, a.k_pad, a.cout,
      w_blocks, xvec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bm == 64 ? launch_gemm<T, 64>(a) : launch_gemm<T, 32>(a);
}

}  // namespace

// x (m, cin) in dtype; w_q (cin, cout) int8; w_scale (cout,) float; bias
// (cout,) in bias_dtype (float or bf16; null: none); out (m, cout) in dtype;
// k_pad = cin rounded up to 32; bm: rows a GEMM block, 64 or 32. The first
// launch writes w_t (cout, k_pad) int8, xq (m, k_pad) int8 and xs (m,)
// float, scratch the caller allocates.
extern "C" int seld_int8_matmul(const void* x, const void* w_q, void* w_t, const void* w_scale,
                                const void* bias, void* out, void* xq, void* xs, int m, int cin,
                                int k_pad, int cout, int bm, int dtype, int bias_dtype,
                                void* stream) {
  const MmArgs a{x, static_cast<const int8_t*>(w_q), static_cast<int8_t*>(w_t),
                 static_cast<const float*>(w_scale), bias, out, static_cast<int8_t*>(xq),
                 static_cast<float*>(xs), m, cin, k_pad, cout, bias_dtype,
                 static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (m <= 0 || cin <= 0 || cout <= 0 || k_pad % 32 || k_pad < cin || (bm != 64 && bm != 32) ||
      w_q == nullptr || w_t == nullptr || xq == nullptr || xs == nullptr ||
      (bias != nullptr && bias_dtype != kF32 && bias_dtype != kBF16))
    err = cudaErrorInvalidValue;
  else if (dtype == kF32)
    err = launch<float>(a, bm);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(a, bm);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
