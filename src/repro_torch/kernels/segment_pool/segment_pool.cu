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
// cast back to the input dtype.  The encoding, init and finalize live in
// cuda_common.cuh, shared with the run variant (runs.cu).
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
  if (reduce == kMin) v = -v;
  pool_accumulate(acc, static_cast<int64_t>(seg) * d + col, v, reduce);
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
  pool_init_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(acc, n_out, reduce);
  if (e > 0) {
    scatter_kernel<<<blocks_for(e * d), kThreads, 0, s>>>(
        values, seg_ids, acc, e, d, n_segments, dtype, reduce);
  }
  pool_finalize_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      acc, out, n_out, dtype, reduce);
  return static_cast<int>(cudaGetLastError());
}
