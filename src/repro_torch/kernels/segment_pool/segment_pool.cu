// segment_pool for Hopper (sm_90a): [E, D] values reduced over seg_ids in
// any order into [N, D] — sum or max (min is -max(-x), done by negating
// on load and on store).
//
// Replaces the Pallas TPU kernel `segment_pool` in
// src/repro/kernels/segment_pool/kernel.py (_seg_sum_kernel and
// _seg_max_kernel).  On the TPU the scatter is a one-hot matmul into a
// VMEM-resident accumulator over a sequential grid; a GPU has no such
// order between blocks, so here the scatter is fp32 atomics into an
// [N, D] accumulator in device memory:
//   * sum: atomicAdd;
//   * max: atomicMax on an order-preserving int encoding of fp32, with
//     -1e30 (the reference's NEG_INF) as the identity; a result
//     <= -5e29 (an empty segment) is mapped to 0.
// Ids outside [0, N) mark padding rows and are dropped.  The result is
// cast back to the input dtype.
//
// Bound on this card: bytes.  One add per value element against ~2.5
// bytes moved per element (bf16) or 4 (fp32); the work is reading values
// once and writing [N, D] once.  One thread per (row, column): adjacent
// threads touch adjacent columns of one row, so loads are coalesced and
// the atomics of a warp land on one contiguous 128-byte line.  Atomic
// order varies between runs, so fp32 sums of non-integer data are not
// bit-reproducible; sums of integer-valued data are exact.
#include "cuda_common.cuh"

namespace {

using namespace repro_torch;

constexpr float kNegInf = -1e30f;
// reduce codes of kernel.py: 0 sum, 1 max, 2 min
constexpr int kSum = 0;
constexpr int kMin = 2;

// Monotone float -> int map: a < b as floats iff enc(a) < enc(b) as ints.
__device__ __forceinline__ int float_to_ordered(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float ordered_to_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__global__ void init_kernel(float* acc, int64_t n, int reduce) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  if (reduce == kSum)
    acc[i] = 0.f;
  else
    reinterpret_cast<int*>(acc)[i] = float_to_ordered(kNegInf);
}

__global__ void scatter_kernel(const void* values, const int* seg_ids,
                               float* acc, int64_t e, int d, int n_segments,
                               int dtype, int reduce) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= e * d) return;
  int64_t row = i / d;
  int col = static_cast<int>(i - row * d);
  int seg = seg_ids[row];
  if (seg < 0 || seg >= n_segments) return;  // padding row: dropped
  float v = load_as_float(values, i, dtype);
  int64_t o = static_cast<int64_t>(seg) * d + col;
  if (reduce == kSum) {
    atomicAdd(acc + o, v);
  } else {
    if (reduce == kMin) v = -v;
    atomicMax(reinterpret_cast<int*>(acc) + o, float_to_ordered(v));
  }
}

__global__ void finalize_kernel(const float* acc, void* out, int64_t n,
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

}  // namespace

// values [e, d] (dtype code), seg_ids [e] int32, acc [n_segments, d] fp32
// scratch, out [n_segments, d] (dtype code).  Launches on `stream`; returns
// the cudaError_t of the launches (0 on success).
extern "C" int segment_pool_launch(const void* values, const int* seg_ids,
                                   float* acc, void* out, long long e, int d,
                                   int n_segments, int dtype, int reduce,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_segments) * d;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  init_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(acc, n_out, reduce);
  if (e > 0) {
    scatter_kernel<<<blocks_for(e * d), kThreads, 0, s>>>(
        values, seg_ids, acc, e, d, n_segments, dtype, reduce);
  }
  finalize_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(acc, out, n_out,
                                                         dtype, reduce);
  return static_cast<int>(cudaGetLastError());
}
