// Shared helpers for the seld_tpu_torch Hopper kernels.
//
// Every kernel loads its operands in the storage dtype (float or bf16),
// computes and accumulates in float, and rounds once when it stores. The C
// entry points take a dtype code (kF32 / kBF16), return cudaGetLastError()
// as an int, and launch on the stream they are given.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum SeldDtype : int { kF32 = 0, kBF16 = 1 };

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

static __device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
static __device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

static inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Opt a kernel in to `bytes` of dynamic shared memory (needed above 48 KB)
// and report the first error, if any.
template <typename Kernel>
static inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
