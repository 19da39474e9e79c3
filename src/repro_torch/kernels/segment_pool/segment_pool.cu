// segment_pool for Hopper (sm_90a): [E, D] values reduced over seg_ids in
// any order into [N, D] — sum or max (min is -max(-x), negated on load and
// on store).
//
// Replaces the Pallas TPU kernel `segment_pool` in
// src/repro/kernels/segment_pool/kernel.py (_seg_sum_kernel and
// _seg_max_kernel).  On the TPU the scatter is a one-hot matmul into a
// VMEM-resident accumulator over a sequential grid; a GPU has no such
// order between blocks, so here the scatter is fp32 atomics into the
// [N, D] result in device memory.  Ids outside [0, N) mark padding rows
// and are dropped (their values are never read); empty segments read 0;
// the result is cast back to the input dtype.
//
// Bound on this card: bytes (one add per value element against 4 bytes
// read, fp32).  So the design moves each byte once, in as few
// transactions and launches as it can:
//   * one thread per 4 consecutive columns of one row: one 16-byte load
//     of the values, one read of the row's id (a broadcast across the
//     warp, which covers a whole 128-wide row), one vector fp32 atomicAdd
//     (REDG.E.ADD.F32x4) for a sum, four sign-split atomics for max/min;
//   * a width or pointer that does not allow the 16-byte vector (D % 4,
//     or a values pointer off the vector boundary) takes the scalar path
//     of the same kernel, one column per thread;
//   * an fp32 sum adds straight into the output, zeroed by a memset on
//     the stream: one kernel per call.  max/min and bf16/fp16 add one
//     finalize pass (pool.cuh).
// Atomic order varies between runs, so fp32 sums of non-integer data are
// bit-reproducible only where each segment receives at most two rows (two
// adds onto 0 commute); sums of integer-valued data are exact, and max/min
// are exact and order-free.
#include "pool.cuh"

namespace {

using namespace repro_torch;

template <int DT, bool SUM, int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const void* __restrict__ values,
               const int* __restrict__ seg_ids, float* __restrict__ acc,
               int64_t e, int d, int n_segments, bool negate) {
  const int dv = d / VEC;  // vectors per row
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= e * dv) return;
  const int64_t row = i / dv;
  const int col = static_cast<int>(i - row * dv) * VEC;
  const int seg = __ldg(seg_ids + row);
  if (seg < 0 || seg >= n_segments) return;  // padding row: dropped
  float v[VEC];
  load_if<DT, VEC>(true, values, row * d + col, negate, 0.f, v);
  accumulate<SUM, VEC>(acc + static_cast<int64_t>(seg) * d + col, v);
}

}  // namespace

// values [e, d] (dtype code), seg_ids [e] int32, acc [n_segments, d] fp32
// (the output itself when the dtype is fp32, else scratch), out
// [n_segments, d] (dtype code).  Launches on `stream`; returns the
// cudaError_t of the calls (0 on success).
extern "C" int segment_pool_launch(const void* values, const int* seg_ids,
                                   float* acc, void* out, long long e, int d,
                                   int n_segments, int dtype, int reduce,
                                   void* stream) {
  const int vec = vector_width(values, acc, d, dtype);
  const int64_t blocks = (e * (d / vec) + kThreads - 1) / kThreads;
  return pool_launch(
      acc, out, e, d, n_segments, dtype, reduce, blocks,
      static_cast<cudaStream_t>(stream), [&](cudaStream_t s, unsigned grid) {
        dispatch(dtype, reduce, vec, [&](auto dt, auto sum, auto v) {
          constexpr int kVec = decltype(v)::value;
          scatter_kernel<decltype(dt)::value, decltype(sum)::value, kVec>
              <<<grid, kThreads, 0, s>>>(
                  values, seg_ids, acc, e, d, n_segments, reduce == kMin);
        });
      });
}
