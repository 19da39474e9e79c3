// segment_pool_runs for Hopper (sm_90a): [E, D] values reduced over runs
// of equal seg_ids into [N, D] — sum or max (min is -max(-x), negated on
// load and on store).  Same contract as segment_pool.cu.
//
// Replaces the Pallas TPU kernel `segment_pool_runs` in
// src/repro/kernels/segment_pool/kernel.py (_seg_runs_kernel with its
// segmented_run_scan).  There a Hillis-Steele scan folds each run of equal
// ids inside an edge block and one row update per run end lands it in a
// VMEM-resident accumulator.  Here:
//   * a CTA takes a tile of kTileRows rows and a slice of up to kMaxCols
//     columns, one thread per column; the tile's ids are staged in shared
//     memory;
//   * each thread walks the tile's rows in order and folds the current run
//     in a register (padding rows, ids outside [0, N), are never read);
//   * at each run end it makes one fp32 atomicAdd (sum), or one atomicMax
//     on the order-preserving int encoding of cuda_common.cuh (max/min),
//     into the [N, D] accumulator;
//   * a run that crosses a tile boundary meets its other half in the
//     accumulator, as the Pallas kernel's blocks do (kernel.py:121-123).
// Correct for any id order: unsorted, every run is one row long and this
// is segment_pool's scatter.  Sorted (the training batches), a segment of
// k rows inside one tile costs one atomic per column instead of k.  The
// run is folded in row order in fp32, so integer-valued sums are exact and
// max/min are exact.  Init (0 or -1e30) and finalize (<= -5e29 -> 0, cast
// back to the input dtype) are cuda_common.cuh's.
//
// Bound on this card: bytes, like segment_pool: each valid value is read
// once, the [N, D] result written once.  Adjacent threads read adjacent
// columns of one row, so every row of the walk is one coalesced load per
// warp.
#include "cuda_common.cuh"

namespace {

using namespace repro_torch;

constexpr int kTileRows = 32;   // rows per CTA
constexpr int kMaxCols = 256;   // columns per CTA (one thread each)

__global__ void __launch_bounds__(kMaxCols)
seg_runs_kernel(const void* values, const int* seg_ids, float* acc,
                int64_t e, int d, int n_segments, int dtype, int reduce) {
  __shared__ int s_ids[kTileRows];
  const int64_t row0 = blockIdx.x * static_cast<int64_t>(kTileRows);
  const int64_t left = e - row0;
  const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    s_ids[r] = seg_ids[row0 + r];
  __syncthreads();
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= d) return;

  const float identity = reduce == kSum ? 0.f : kNegInf;
  float run = identity;
  for (int r = 0; r < rows; ++r) {
    const int seg = s_ids[r];
    const bool valid = seg >= 0 && seg < n_segments;
    if (valid) {
      float v = load_as_float(values, (row0 + r) * d + col, dtype);
      if (reduce == kMin) v = -v;
      run = reduce == kSum ? run + v : fmaxf(run, v);
    }
    if (r + 1 == rows || s_ids[r + 1] != seg) {  // run end
      if (valid)
        pool_accumulate(acc, static_cast<int64_t>(seg) * d + col, run,
                        reduce);
      run = identity;
    }
  }
}

}  // namespace

// values [e, d] (dtype code), seg_ids [e] int32, acc [n_segments, d] fp32
// scratch, out [n_segments, d] (dtype code).  Launches on `stream`; returns
// the cudaError_t of the launches (0 on success).
extern "C" int segment_pool_runs_launch(const void* values,
                                        const int* seg_ids, float* acc,
                                        void* out, long long e, int d,
                                        int n_segments, int dtype,
                                        int reduce, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_segments) * d;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  pool_init_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(acc, n_out, reduce);
  if (e > 0) {
    const int threads = d < kMaxCols ? (d + 31) / 32 * 32 : kMaxCols;
    const int64_t row_tiles = (e + kTileRows - 1) / kTileRows;
    const int col_tiles = (d + threads - 1) / threads;
    if (row_tiles > 2147483647LL || col_tiles > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned int>(row_tiles), col_tiles);
    seg_runs_kernel<<<grid, threads, 0, s>>>(values, seg_ids, acc, e, d,
                                             n_segments, dtype, reduce);
  }
  pool_finalize_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      acc, out, n_out, dtype, reduce);
  return static_cast<int>(cudaGetLastError());
}
