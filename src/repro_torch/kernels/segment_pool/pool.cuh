// Shared pieces of the two segment-reduction kernels (segment_pool.cu and
// runs.cu): predicated vector loads, the atomics that fold a value into
// the [N, D] fp32 accumulator, and the launch sequence around the scatter.
//
// Launch sequence of one call (the C entry points, pool_launch below):
//   1. cudaMemsetAsync of the accumulator: 0 for sum, 0xFF bytes for
//      max/min (the bit pattern 0xFFFFFFFF, "no value yet");
//   2. the scatter kernel, adding or max-ing straight into it (runs.cu's
//      sum adds its carry fold, carry.cuh, a second kernel);
//   3. only for max/min, or for a bf16/fp16 output: one finalize pass.
// For an fp32 sum the accumulator IS the output (the wrapper passes one
// buffer twice), so segment_pool's call is the memset plus one kernel and
// segment_pool_runs' the memset plus two; max/min take two kernels, and a
// 16-bit output adds the finalize to the sum's.
//
// The kernels are templates over the reduction (sum or max; min is max of
// the negated values, negated again on store) and the input dtype, so a
// row's work is straight-line code: a serial fold over rows pays for every
// branch in it (runs.cu).
//
// max without an fp32 atomicMax: the raw fp32 bits, split by sign.
// Non-negative floats order like their bits as signed ints (atomicMax on
// int); negative floats order inversely to their bits as unsigned ints
// (atomicMin on unsigned).  The sentinel 0xFFFFFFFF is -1 as an int, below
// every non-negative value, and the largest unsigned, above every negative
// one, so the first value of either sign replaces it, and a positive value
// always replaces a negative one (whose bits are negative ints).  Each
// atomic is the max in float order, so any interleaving ends at the max.
// -0.0 (sign bit set) takes the unsigned branch, and +0.0 beats it, as in
// an order-preserving int encoding.  The finalize maps the sentinel and
// any result <= -5e29 to 0 (the reference's max identity -1e30 with its
// map, ref.py), negates for min and casts to the output dtype.
#pragma once

#include <type_traits>

#include "cuda_common.cuh"

namespace repro_torch {

// reduce codes of segment_pool/kernel.py
constexpr int kSum = 0;
constexpr int kMin = 2;
constexpr float kNegInf = -1e30f;             // the reference's max identity
constexpr unsigned int kEmpty = 0xFFFFFFFFu;  // max/min slot with no value

// identity of the fold in registers (max: -inf, below every value, so a
// run of valid rows folds to its exact max)
template <bool SUM>
__device__ __forceinline__ float fold_identity() {
  return SUM ? 0.f : __int_as_float(static_cast<int>(0xff800000u));
}

template <bool SUM>
__device__ __forceinline__ float fold(float run, float v) {
  return SUM ? run + v : fmaxf(run, v);
}

// VEC consecutive values of `p` from element i as fp32 (negated when
// `negate`), or `fill` where !pred.  One predicated load: 16 bytes for 4
// fp32, 8 bytes for 4 bf16/fp16 (the caller has checked the alignment).
// Inline PTX keeps it a predicated load issued where it is written: the
// compiler neither branches around it nor sinks it to its first use, so
// the loads of a row group are all in flight together.
template <int DT, int VEC>
__device__ __forceinline__ void load_if(bool pred, const void* p, int64_t i,
                                        bool negate, float fill,
                                        float (&v)[VEC]) {
  static_assert(VEC == 1 || VEC == 4, "1 or 4 columns per thread");
  const int q = pred;
  if constexpr (DT == kFloat32) {
    const float* a = static_cast<const float*>(p) + i;
    if constexpr (VEC == 4) {
      float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
      asm volatile(
          "{\n .reg .pred q;\n setp.ne.b32 q, %4, 0;\n"
          " @q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%5];\n}"
          : "+f"(x), "+f"(y), "+f"(z), "+f"(w)
          : "r"(q), "l"(a));
      v[0] = x; v[1] = y; v[2] = z; v[3] = w;
    } else {
      float x = 0.f;
      asm volatile(
          "{\n .reg .pred q;\n setp.ne.b32 q, %1, 0;\n"
          " @q ld.global.nc.f32 %0, [%2];\n}"
          : "+f"(x)
          : "r"(q), "l"(a));
      v[0] = x;
    }
  } else {
    const uint16_t* a = static_cast<const uint16_t*>(p) + i;
    unsigned short h[VEC];
    if constexpr (VEC == 4) {
      unsigned int lo = 0, hi = 0;
      asm volatile(
          "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
          " @q ld.global.nc.v2.b32 {%0, %1}, [%3];\n}"
          : "+r"(lo), "+r"(hi)
          : "r"(q), "l"(a));
      h[0] = lo & 0xffff; h[1] = lo >> 16;
      h[2] = hi & 0xffff; h[3] = hi >> 16;
    } else {
      unsigned short x = 0;
      asm volatile(
          "{\n .reg .pred q;\n setp.ne.b32 q, %1, 0;\n"
          " @q ld.global.nc.b16 %0, [%2];\n}"
          : "+h"(x)
          : "r"(q), "l"(a));
      h[0] = x;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = DT == kBFloat16 ? __bfloat162float(__ushort_as_bfloat16(h[j]))
                             : __half2float(__ushort_as_half(h[j]));
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    v[j] = pred ? (negate ? -v[j] : v[j]) : fill;
}

// fp32 max into slot p by the sign split above
__device__ __forceinline__ void atomic_max_bits(float* p, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0)
    atomicMax(reinterpret_cast<int*>(p), bits);
  else
    atomicMin(reinterpret_cast<unsigned int*>(p),
              static_cast<unsigned int>(bits));
}

// VEC values (already negated for min) folded into acc[0 .. VEC): one
// vector atomicAdd for a sum of 4 (REDG.E.ADD.F32x4 on sm_90), else one
// atomic per value
template <bool SUM, int VEC>
__device__ __forceinline__ void accumulate(float* acc, const float (&v)[VEC]) {
  if constexpr (SUM && VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(acc),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (SUM) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) atomicAdd(acc + j, v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) atomic_max_bits(acc + j, v[j]);
  }
}

// accumulator -> output: the max sentinel and results <= -5e29 read 0,
// min negates, then the cast (round to nearest even, as torch's .to()).
// In place for an fp32 max/min (acc and out are one buffer: each thread
// reads its element before it writes it).
__global__ void pool_finalize_kernel(const float* acc, void* out, int64_t n,
                                     int dtype, int reduce) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= n) return;
  float v = acc[i];
  if (reduce != kSum) {
    if (__float_as_uint(v) == kEmpty || v <= kNegInf * 0.5f) v = 0.f;
    if (reduce == kMin) v = -v;
  }
  store_from_float(out, i, v, dtype);
}

// Columns per thread: 4 when every row starts on a vector boundary of the
// values (16 bytes fp32, 8 bytes bf16/fp16) and of the accumulator, else 1.
inline int vector_width(const void* values, const float* acc, int d,
                        int dtype) {
  const uintptr_t align = dtype == kFloat32 ? 16 : 8;
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(values) % align == 0 &&
                 reinterpret_cast<uintptr_t>(acc) % 16 == 0
             ? 4
             : 1;
}

// Calls f(dtype, sum, vec), each a std::integral_constant, so the caller
// instantiates its kernel for exactly the combination a call needs.
template <typename F>
void dispatch(int dtype, int reduce, int vec, F f) {
  auto by_vec = [&](auto dt, auto sum) {
    if (vec == 4)
      f(dt, sum, std::integral_constant<int, 4>{});
    else
      f(dt, sum, std::integral_constant<int, 1>{});
  };
  auto by_sum = [&](auto dt) {
    if (reduce == kSum)
      by_vec(dt, std::true_type{});
    else
      by_vec(dt, std::false_type{});
  };
  if (dtype == kBFloat16)
    by_sum(std::integral_constant<int, kBFloat16>{});
  else if (dtype == kFloat16)
    by_sum(std::integral_constant<int, kFloat16>{});
  else
    by_sum(std::integral_constant<int, kFloat32>{});
}

// The most blocks a grid's x dimension takes.
constexpr int64_t kMaxBlocks = 2147483647LL;

// One call: fill, scatter (`scatter(stream, blocks)` launches the kernel on
// `scatter_blocks` blocks, skipped for e == 0), finalize where needed.
// acc == out exactly when the output is fp32.  Returns the cudaError_t of
// the calls (0 on success); cudaErrorInvalidValue, with nothing launched,
// when a grid would exceed kMaxBlocks.
template <typename Scatter>
int pool_launch(float* acc, void* out, long long e, int d, int n_segments,
                int dtype, int reduce, int64_t scatter_blocks, cudaStream_t s,
                Scatter scatter) {
  const int64_t n_out = static_cast<int64_t>(n_segments) * d;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  const bool finalize = reduce != kSum || static_cast<void*>(acc) != out;
  if (scatter_blocks > kMaxBlocks ||
      (finalize && (n_out + kThreads - 1) / kThreads > kMaxBlocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(acc, reduce == kSum ? 0 : 0xFF,
                                    n_out * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e > 0) scatter(s, static_cast<unsigned int>(scatter_blocks));
  if (finalize)
    pool_finalize_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
        acc, out, n_out, dtype, reduce);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
