// segment_pool_runs for Hopper (sm_90a): [E, D] values reduced over runs
// of equal seg_ids into [N, D] — sum or max (min is -max(-x), negated on
// load and on store).  Same contract as segment_pool.cu.
//
// Replaces the Pallas TPU kernel `segment_pool_runs` in
// src/repro/kernels/segment_pool/kernel.py (_seg_runs_kernel with its
// segmented_run_scan).  There a Hillis-Steele scan folds each run of equal
// ids inside an edge block and one row update per run end lands it in a
// VMEM-resident accumulator.  Here a warp folds each run in registers and
// makes one atomic per run end into the [N, D] result; a run that crosses
// a tile boundary meets its other half there, as the Pallas kernel's
// blocks do (kernel.py:121-123).  Correct for any id order: unsorted,
// most runs are one row long and this is segment_pool's scatter.  The
// layout bit is only a hint.
//
// Bound on this card: bytes, like segment_pool: each valid value read
// once, the [N, D] result written once.  Two shapes of warp:
//   * D >= 32 (the messages, D = 128): a warp owns a tile of 16 rows and a
//     slice of 32 x 4 columns, 4 per lane.  It reads the tile's ids with
//     one coalesced load, issues all 16 rows' 16-byte loads before it uses
//     any (predicated loads, pool.cuh), folds each run in registers and at
//     each run end issues one vector atomicAdd (sum) or four sign-split
//     atomics (max/min).  Padding rows are never read.  The tile is 16
//     rows, not longer: the fold is serial within a warp, so at E ~ 5000
//     a longer tile means fewer warps each with a longer chain, and on the
//     H100 tiles of 32 and 64 rows ran slower than 16; 16 rows already cut
//     the trained batch's 2697-row run into one atomic per tile, where an
//     any-order scatter contends 2697 times on one row.
//   * D < 32 (the attention scores [E, heads], D = 4): lanes take rows.
//     Each lane loads its row's D values (one 16-byte load at D = 4), and
//     a segmented inclusive scan across the warp's 32 rows with head flags
//     (__shfl_up_sync, 5 steps; the counterpart of segmented_run_scan)
//     folds the runs; the lane at each run end issues the atomic.
// A width or pointer that does not allow 16-byte vectors takes the scalar
// form of the same kernels (one column per lane).  Launches as in
// segment_pool.cu (pool.cuh): an fp32 sum is the memset plus one kernel,
// max/min and bf16/fp16 add one finalize pass.
//
// Determinism: within a tile the fold order is fixed (row order, or the
// scan's tree).  With sorted ids a segment whose rows touch at most two
// tiles gets at most two fp32 adds onto 0, and those commute, so its sum
// is bit-reproducible from run to run; a segment over three or more tiles
// is exact only for integer-valued data.  max/min are always exact.
#include "pool.cuh"

namespace {

using namespace repro_torch;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerCta = 4;
constexpr int kGroup = 16;  // rows whose loads a lane keeps in flight
constexpr int kTileRows = 16;

__device__ __forceinline__ bool is_valid(int seg, int n_segments) {
  return seg >= 0 && seg < n_segments;
}

// D >= 32: warp w folds rows [tile * kTileRows, +kTileRows) of column
// slice `slice`; lane l owns columns slice * 32 * VEC + l * VEC + [0, VEC).
template <int DT, bool SUM, int VEC>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
seg_runs_tile_kernel(const void* __restrict__ values,
                     const int* __restrict__ seg_ids, float* __restrict__ acc,
                     int64_t e, int d, int n_segments, bool negate,
                     int slices, int64_t n_warps) {
  static_assert(kTileRows <= 32 && kTileRows % kGroup == 0,
                "one id load per lane, whole row groups");
  const int lane = threadIdx.x & 31;
  const int64_t w = blockIdx.x * static_cast<int64_t>(kWarpsPerCta) +
                    (threadIdx.x >> 5);
  if (w >= n_warps) return;  // whole warp
  const int64_t tile = w / slices;
  const int col = static_cast<int>(w - tile * slices) * 32 * VEC + lane * VEC;
  const bool active = col < d;
  const int64_t row0 = tile * kTileRows;
  const int rows = static_cast<int>(
      e - row0 < kTileRows ? e - row0 : static_cast<int64_t>(kTileRows));

  // the tile's ids, one per lane, and the id after each row (-1, never
  // valid, past the tile's end, which ends every run)
  const int my_id = lane < rows ? __ldg(seg_ids + row0 + lane) : -1;
  int my_next = __shfl_down_sync(kFull, my_id, 1);
  if (lane >= rows - 1) my_next = -1;

  // every load of a group is issued before any is used; a row that is not
  // read (padding, or past the end) holds the fold's identity, so the fold
  // runs unconditionally
  const float identity = fold_identity<SUM>();
  float run[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) run[c] = identity;
#pragma unroll
  for (int g = 0; g < kTileRows; g += kGroup) {
    float v[kGroup][VEC];
    int seg[kGroup], next[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int j = g + k;
      seg[k] = __shfl_sync(kFull, my_id, j);
      next[k] = __shfl_sync(kFull, my_next, j);
      load_if<DT, VEC>(active && j < rows && is_valid(seg[k], n_segments),
                       values, (row0 + j) * d + col, negate, identity, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) run[c] = fold<SUM>(run[c], v[k][c]);
      if (next[k] != seg[k]) {  // run end (rows past the end: no-op)
        if (active && is_valid(seg[k], n_segments))
          accumulate<SUM, VEC>(acc + static_cast<int64_t>(seg[k]) * d + col,
                               run);
#pragma unroll
        for (int c = 0; c < VEC; ++c) run[c] = identity;
      }
    }
  }
}

// D < 32: each warp takes 32 consecutive rows, one per lane, and folds
// the runs among them with a segmented scan, VEC columns at a time.
template <int DT, bool SUM, int VEC>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
seg_runs_rows_kernel(const void* __restrict__ values,
                     const int* __restrict__ seg_ids, float* __restrict__ acc,
                     int64_t e, int d, int n_segments, bool negate) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (row - lane >= e) return;  // whole warp past the end
  const int seg = row < e ? __ldg(seg_ids + row) : -1;
  const bool valid = row < e && is_valid(seg, n_segments);
  const int prev = __shfl_up_sync(kFull, seg, 1);
  const int next = __shfl_down_sync(kFull, seg, 1);
  const bool head = lane == 0 || prev != seg;
  const bool tail = lane == 31 || next != seg;

  for (int c0 = 0; c0 < d; c0 += VEC) {
    float v[VEC];
    load_if<DT, VEC>(valid, values, row * d + c0, negate,
                     fold_identity<SUM>(), v);
    // inclusive scan within runs: a lane folds in the value `off` lanes
    // up unless a run head lies between (f: a head in my window so far)
    bool f = head;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float up[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) up[c] = __shfl_up_sync(kFull, v[c], off);
      const bool f_up = __shfl_up_sync(kFull, static_cast<int>(f), off) != 0;
      if (lane >= off) {
        if (!f) {
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[c] = fold<SUM>(up[c], v[c]);
        }
        f = f || f_up;
      }
    }
    if (tail && valid)
      accumulate<SUM, VEC>(acc + static_cast<int64_t>(seg) * d + c0, v);
  }
}

}  // namespace

// values [e, d] (dtype code), seg_ids [e] int32, acc [n_segments, d] fp32
// (the output itself when the dtype is fp32, else scratch), out
// [n_segments, d] (dtype code).  Launches on `stream`; returns the
// cudaError_t of the calls (0 on success).
extern "C" int segment_pool_runs_launch(const void* values,
                                        const int* seg_ids, float* acc,
                                        void* out, long long e, int d,
                                        int n_segments, int dtype,
                                        int reduce, void* stream) {
  const int vec = vector_width(values, acc, d, dtype);
  constexpr int threads = 32 * kWarpsPerCta;
  // D >= 32: one warp per (tile, column slice)
  const int slices = (d + 32 * vec - 1) / (32 * vec);
  const int64_t n_warps = (e + kTileRows - 1) / kTileRows * slices;
  const int64_t blocks = d < 32 ? (e + threads - 1) / threads
                                : (n_warps + kWarpsPerCta - 1) / kWarpsPerCta;
  return pool_launch(
      acc, out, e, d, n_segments, dtype, reduce, blocks,
      static_cast<cudaStream_t>(stream), [&](cudaStream_t s, unsigned grid) {
        dispatch(dtype, reduce, vec, [&](auto dt, auto sum, auto v) {
          constexpr int kDt = decltype(dt)::value;
          constexpr bool kSumOp = decltype(sum)::value;
          constexpr int kVec = decltype(v)::value;
          const bool negate = reduce == kMin;
          if (d < 32)
            seg_runs_rows_kernel<kDt, kSumOp, kVec>
                <<<grid, threads, 0, s>>>(values, seg_ids, acc, e, d,
                                          n_segments, negate);
          else
            seg_runs_tile_kernel<kDt, kSumOp, kVec>
                <<<grid, threads, 0, s>>>(values, seg_ids, acc, e, d,
                                          n_segments, negate, slices,
                                          n_warps);
        });
      });
}
