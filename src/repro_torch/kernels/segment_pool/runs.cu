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
//     atomics (max/min), or, for a sum's run that crosses the tile's
//     boundary, stores it to its carry slot.  Padding rows are never
//     read.  The tile is 16 rows by default, not longer: the fold is
//     serial within a warp, so at E ~ 5000 a longer tile means fewer
//     warps each with a longer chain, and on the H100 tiles of 32 and 64
//     rows ran slower than 16; 16 rows already cut the trained batch's
//     2697-row run into one partial per tile, where an any-order scatter
//     contends 2697 times on one row.  The entry also takes 32-row tiles
//     (half the carry partials and warps), which kernels/autotune.py
//     times per exact shape against 16.
//   * D < 32 (the attention scores [E, heads], D = 4): lanes take rows.
//     Each lane loads its row's D values (one 16-byte load at D = 4), and
//     a segmented inclusive scan across the warp's 32 rows with head flags
//     (__shfl_up_sync, 5 steps; the counterpart of segmented_run_scan)
//     folds the runs; the lane at each run end issues the atomic (or
//     stores its carry slot).  The piece is the warp's 32 rows, one a
//     lane, so this form has no tile height to choose.
// A width or pointer that does not allow 16-byte vectors takes the scalar
// form of the same kernels (one column per lane).  Launches as in
// segment_pool.cu (pool.cuh), plus the carry fold of a sum: an fp32 sum is
// the memset plus two kernels, max/min the memset plus two (the
// finalize), a bf16/fp16 sum the memset plus three.
//
// Determinism (carry.cuh): a sum writes a run that crosses a piece
// boundary (a 16-row tile, or a warp's 32 rows below D 32) to the scratch
// `carry` instead of adding it, and carry_fold_kernel then adds each chain
// of such partials in piece order, once.  On sorted ids every segment
// then gets exactly one fp32 add onto 0, so a sum is bit-identical from
// call to call whatever the run length; an fp32 sum is the memset plus
// two kernels.  max/min are exact in any order and keep one atomic per
// run end.
#include "carry.cuh"
#include "pool.cuh"

namespace {

using namespace repro_torch;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerCta = 4;
constexpr int kGroup = 16;  // rows whose loads a lane keeps in flight
constexpr int kTileRows = 16;  // D >= 32: the default tile; 32 is built too

__device__ __forceinline__ bool is_valid(int seg, int n_segments) {
  return seg >= 0 && seg < n_segments;
}

// VEC floats of a run's fold into its carry slot (16 bytes when VEC is 4:
// the entry checks the alignment)
template <int VEC>
__device__ __forceinline__ void store_part(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// A sum's run end: into the output, or into its carry slot of `piece`.
template <bool SUM, int VEC>
__device__ __forceinline__ void run_end(float* acc, float* parts, int slot,
                                        int64_t piece, int seg, int d,
                                        int col, const float (&run)[VEC]) {
  if (SUM && slot != kCarryAdd)
    store_part<VEC>(parts + (2 * piece + slot) * d + col, run);
  else
    accumulate<SUM, VEC>(acc + static_cast<int64_t>(seg) * d + col, run);
}

// D >= 32: warp w folds rows [tile * TILE, +TILE) of column slice
// `slice`; lane l owns columns slice * 32 * VEC + l * VEC + [0, VEC).
template <int DT, bool SUM, int VEC, int TILE>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
seg_runs_tile_kernel(const void* __restrict__ values,
                     const int* __restrict__ seg_ids, float* __restrict__ acc,
                     int4* __restrict__ meta, float* __restrict__ parts,
                     int64_t e, int d, int n_segments, bool negate,
                     int slices, int64_t n_warps) {
  static_assert(TILE <= 32 && TILE % kGroup == 0,
                "one id load per lane, whole row groups");
  const int lane = threadIdx.x & 31;
  const int64_t w = blockIdx.x * static_cast<int64_t>(kWarpsPerCta) +
                    (threadIdx.x >> 5);
  if (w >= n_warps) return;  // whole warp
  const int64_t tile = w / slices;
  const int col = static_cast<int>(w - tile * slices) * 32 * VEC + lane * VEC;
  const bool active = col < d;
  const int64_t row0 = tile * TILE;
  const int rows = static_cast<int>(
      e - row0 < TILE ? e - row0 : static_cast<int64_t>(TILE));

  // the tile's ids, one per lane, and the id after each row (-1, never
  // valid, past the tile's end, which ends every run)
  const int my_id = lane < rows ? __ldg(seg_ids + row0 + lane) : -1;
  int my_next = __shfl_down_sync(kFull, my_id, 1);
  if (lane >= rows - 1) my_next = -1;
  // a sum's runs that cross the tile's boundary go to its carry slots
  const int first_id = __shfl_sync(kFull, my_id, 0);
  const int last_id = __shfl_sync(kFull, my_id, rows - 1);
  const bool from_prev =
      SUM && row0 > 0 && is_valid(first_id, n_segments) &&
      __ldg(seg_ids + row0 - 1) == first_id;
  const bool into_next =
      SUM && row0 + rows < e && is_valid(last_id, n_segments) &&
      __ldg(seg_ids + row0 + rows) == last_id;
  const bool one_run =
      __all_sync(kFull, lane >= rows - 1 || my_id == my_next) != 0;
  if (SUM && lane == 0 && w % slices == 0)
    meta[tile] = carry_meta(first_id, last_id, one_run, from_prev,
                            into_next);

  // every load of a group is issued before any is used; a row that is not
  // read (padding, or past the end) holds the fold's identity, so the fold
  // runs unconditionally
  const float identity = fold_identity<SUM>();
  float run[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) run[c] = identity;
  bool first_run = true;
#pragma unroll
  for (int g = 0; g < TILE; g += kGroup) {
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
          run_end<SUM, VEC>(acc, parts,
                            carry_slot(first_run, g + k == rows - 1,
                                       from_prev, into_next),
                            tile, seg[k], d, col, run);
#pragma unroll
        for (int c = 0; c < VEC; ++c) run[c] = identity;
        first_run = false;
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
                     int4* __restrict__ meta, float* __restrict__ parts,
                     int64_t e, int d, int n_segments, bool negate) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  const int64_t row0 = row - lane;
  if (row0 >= e) return;  // whole warp past the end
  const int seg = row < e ? __ldg(seg_ids + row) : -1;
  const bool valid = row < e && is_valid(seg, n_segments);
  const int prev = __shfl_up_sync(kFull, seg, 1);
  const int next = __shfl_down_sync(kFull, seg, 1);
  const bool head = lane == 0 || prev != seg;
  const bool tail = lane == 31 || next != seg;
  // the warp's 32 rows are the piece: a sum's runs that cross its
  // boundary go to its carry slots
  const int64_t piece = row0 / 32;
  const int last = e - row0 < 32 ? static_cast<int>(e - row0) - 1 : 31;
  const int first_id = __shfl_sync(kFull, seg, 0);
  const int last_id = __shfl_sync(kFull, seg, last);
  const int first_end = __ffs(__ballot_sync(kFull, tail)) - 1;
  const bool from_prev = SUM && row0 > 0 &&
                         is_valid(first_id, n_segments) &&
                         __ldg(seg_ids + row0 - 1) == first_id;
  const bool into_next = SUM && row0 + 32 < e &&
                         is_valid(last_id, n_segments) &&
                         __ldg(seg_ids + row0 + 32) == last_id;
  if (SUM && lane == 0)
    meta[piece] = carry_meta(first_id, last_id, first_end >= last,
                             from_prev, into_next);
  const int slot = carry_slot(lane == first_end, lane == last, from_prev,
                              into_next);

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
      run_end<SUM, VEC>(acc, parts, slot, piece, seg, d, c0, v);
  }
}

}  // namespace

// values [e, d] (dtype code), seg_ids [e] int32, acc [n_segments, d] fp32
// (the output itself when the dtype is fp32, else scratch), out
// [n_segments, d] (dtype code); for a sum, carry: scratch of
// carry_floats(carry_pieces, d) floats (carry.cuh), carry_pieces at least
// the call's pieces (ceil(e / 16) covers every width and tile); tiles of
// `tile` rows at D >= 32 (16 or 32; 0 the default, kTileRows), and only
// 0 below D 32 (a warp's 32 rows).  Launches on `stream`; returns the
// cudaError_t of the calls (0 on success; cudaErrorInvalidValue, with
// nothing launched, for a tile that is not built).
extern "C" int segment_pool_runs_launch(const void* values,
                                        const int* seg_ids, float* acc,
                                        void* out, float* carry,
                                        long long carry_pieces, long long e,
                                        int d, int n_segments, int dtype,
                                        int reduce, int tile, void* stream) {
  const int tile_rows = tile == 0 ? kTileRows : tile;
  if (d < 32 ? tile != 0 : tile_rows != 16 && tile_rows != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  int vec = vector_width(values, acc, d, dtype);
  if (reinterpret_cast<uintptr_t>(carry) % 16 != 0) vec = 1;
  constexpr int threads = 32 * kWarpsPerCta;
  // D >= 32: one warp per (tile, column slice); below, one warp per 32 rows
  const int slices = (d + 32 * vec - 1) / (32 * vec);
  const int64_t pieces = d < 32 ? (e + 31) / 32
                                : (e + tile_rows - 1) / tile_rows;
  const int64_t n_warps = pieces * slices;
  const int64_t blocks = d < 32 ? (e + threads - 1) / threads
                                : (n_warps + kWarpsPerCta - 1) / kWarpsPerCta;
  const bool sum = reduce == kSum;
  if (sum && e > 0 && (carry == nullptr || carry_pieces < pieces))
    return static_cast<int>(cudaErrorInvalidValue);
  int4* meta = sum ? reinterpret_cast<int4*>(carry) : nullptr;
  float* parts = sum ? carry + 4 * pieces : nullptr;
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  return pool_launch(
      acc, out, e, d, n_segments, dtype, reduce, blocks, stream_,
      [&](cudaStream_t s, unsigned grid) {
        dispatch(dtype, reduce, vec, [&](auto dt, auto sum_op, auto v) {
          constexpr int kDt = decltype(dt)::value;
          constexpr bool kSumOp = decltype(sum_op)::value;
          constexpr int kVec = decltype(v)::value;
          const bool negate = reduce == kMin;
          if (d < 32)
            seg_runs_rows_kernel<kDt, kSumOp, kVec>
                <<<grid, threads, 0, s>>>(values, seg_ids, acc, meta, parts,
                                          e, d, n_segments, negate);
          else if (tile_rows == 32)
            seg_runs_tile_kernel<kDt, kSumOp, kVec, 32>
                <<<grid, threads, 0, s>>>(values, seg_ids, acc, meta, parts,
                                          e, d, n_segments, negate, slices,
                                          n_warps);
          else
            seg_runs_tile_kernel<kDt, kSumOp, kVec, kTileRows>
                <<<grid, threads, 0, s>>>(values, seg_ids, acc, meta, parts,
                                          e, d, n_segments, negate, slices,
                                          n_warps);
        });
        // then the chains of carried partials, in piece order (a refused
        // launch surfaces in pool_launch's cudaGetLastError)
        if (sum) (void)carry_fold(carry, acc, pieces, d, s);
      });
}
