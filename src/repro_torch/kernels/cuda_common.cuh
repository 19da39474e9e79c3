// Shared helpers for the repro_torch CUDA kernels (built for sm_90a).
//
// Tensors reach the kernels as untyped pointers plus a dtype code, so one
// compiled entry point serves every float type the wrappers accept.
// Every kernel accumulates in fp32 and casts back to the input dtype on
// exit, as the Pallas kernels it replaces do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// dtype codes, mirrored by DTYPE_CODES in kernels/build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

constexpr int kThreads = 256;

__device__ __forceinline__ float load_as_float(const void* p, int64_t i,
                                               int dtype) {
  if (dtype == kBFloat16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == kFloat16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_from_float(void* p, int64_t i, float v,
                                                 int dtype) {
  if (dtype == kBFloat16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if (dtype == kFloat16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// fp32 accumulator [n] -> output [n] in the input dtype (round to
// nearest even, as torch's .to() does)
__global__ void cast_from_fp32_kernel(const float* acc, void* out, int64_t n,
                                      int dtype) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i < n) store_from_float(out, i, acc[i], dtype);
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace repro_torch
