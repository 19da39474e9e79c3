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

// ---------------------------------------------------------------------------
// Segment reductions into an [N, D] fp32 accumulator (segment_pool.cu and
// segment_pool/runs.cu): sum by atomicAdd; max by atomicMax on an
// order-preserving int encoding of fp32 (CUDA has no fp32 atomicMax); min
// is -max(-x), negated on load and on store.  -1e30 is the reference's
// max identity, and a result <= -5e29 (an empty segment) reads 0.
// ---------------------------------------------------------------------------

// reduce codes of segment_pool/kernel.py: 0 sum, 1 max, 2 min
constexpr int kSum = 0;
constexpr int kMin = 2;
constexpr float kNegInf = -1e30f;

// Monotone float -> int map: a < b as floats iff enc(a) < enc(b) as ints.
__device__ __forceinline__ int float_to_ordered(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ordered_to_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// one value (already negated for min) folded into accumulator slot o
__device__ __forceinline__ void pool_accumulate(float* acc, int64_t o,
                                                float v, int reduce) {
  if (reduce == kSum)
    atomicAdd(acc + o, v);
  else
    atomicMax(reinterpret_cast<int*>(acc) + o, float_to_ordered(v));
}

__global__ void pool_init_kernel(float* acc, int64_t n, int reduce) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  if (reduce == kSum)
    acc[i] = 0.f;
  else
    reinterpret_cast<int*>(acc)[i] = float_to_ordered(kNegInf);
}

__global__ void pool_finalize_kernel(const float* acc, void* out, int64_t n,
                                     int dtype, int reduce) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  float v;
  if (reduce == kSum) {
    v = acc[i];
  } else {
    v = ordered_to_float(reinterpret_cast<const int*>(acc)[i]);
    if (v <= kNegInf * 0.5f) v = 0.f;  // empty segment
    if (reduce == kMin) v = -v;
  }
  store_from_float(out, i, v, dtype);
}

}  // namespace repro_torch
