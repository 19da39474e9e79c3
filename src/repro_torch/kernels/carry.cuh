// Fixed-order folding of the runs that cross a piece boundary, shared by
// the sorted-run kernels (segment_pool/runs.cu and
// edge_mpnn/edge_mpnn_runs.cu), so that on sorted ids their fp32 sums are
// bit-identical from call to call, for any run length.
//
// A run kernel cuts its rows into pieces (a 16-row tile or a 32-row warp
// in runs.cu, an edge tile in edge_mpnn_runs.cu) and folds each run of
// equal ids inside a piece in a fixed order.  Where the run goes then:
//   * a run whose id differs from the row before the piece (if it holds
//     the piece's first row) and from the row after it (if it holds the
//     last row) is, on sorted ids, its whole segment: its one atomicAdd
//     onto the zeroed output is the only add there, so it is exact;
//   * the piece's first run, when the row before the piece has its id
//     (it continues from the piece before), writes its partial to the
//     piece's head slot; the piece's last run, when the row after the
//     piece has its id and it is not also the first run, writes to the
//     tail slot.  Neither adds.
// Scratch, from the wrapper (torch.empty on the caller's stream):
//   meta  [pieces] int4 {head id or -1, tail id or -1, through, 0};
//         `through`: the head run covers the whole piece and continues
//         into the next one;
//   parts [pieces][2][d] fp32, the head (0) and tail (1) partials.
// Every piece writes its meta, so neither needs zeroing.
// carry_fold_kernel, launched after the run kernel on the same stream,
// starts at every piece with a tail run, adds the head partials of the
// pieces after it while the chain passes through, in an order fixed by
// the chain's length, and makes one atomicAdd of the chain's sum.  On
// sorted ids that chain is the whole segment, so its add is again the
// only one.
//
// Ids outside [0, n) never reach a slot (they add nothing), so meta ids
// are valid.  On unsorted ids a segment may get several adds (a run and a
// chain with the same id, or two chains), which the atomics keep correct
// but not repeatable.  The cost: one more small kernel a call, set by the
// longest chain (the trained batch's 2697-row run: 85 edge tiles, 169
// pool tiles).
#pragma once

#include "cuda_common.cuh"

namespace repro_torch {

// where a run's fold goes
constexpr int kCarryAdd = -1;  // atomicAdd into the output
constexpr int kCarryHead = 0;  // parts[piece][0]
constexpr int kCarryTail = 1;  // parts[piece][1]

// from_prev: the row before the piece has the first run's (valid) id;
// into_next: the row after the piece has the last run's (valid) id
__device__ __forceinline__ int carry_slot(bool first_run, bool last_run,
                                          bool from_prev, bool into_next) {
  if (first_run && from_prev) return kCarryHead;
  if (last_run && into_next) return kCarryTail;
  return kCarryAdd;
}

// the piece's meta; one_run: a single run covers the piece
__device__ __forceinline__ int4 carry_meta(int first_id, int last_id,
                                           bool one_run, bool from_prev,
                                           bool into_next) {
  const bool through = from_prev && one_run && into_next;
  return make_int4(from_prev ? first_id : -1,
                   into_next && !(from_prev && one_run) ? last_id : -1,
                   through ? 1 : 0, 0);
}

// The scratch of `pieces` pieces of width d: meta, then parts (16-byte
// aligned when `carry` is).
__host__ __device__ inline int64_t carry_floats(int64_t pieces, int64_t d) {
  return pieces * (4 + 2 * d);
}

constexpr int kFoldWarps = 16;  // warps of a fold CTA
constexpr int kFoldDepth = 8;   // flags a lane loads a round

// partials[k] of the chain from piece p: k = 0 the tail slot of p, k >= 1
// the head slot of p + k; VEC columns from c, added into sum
template <int VEC>
__device__ __forceinline__ void add_partial(float (&sum)[VEC],
                                            const float* parts, int64_t p,
                                            int64_t k, int d, int c) {
  const float* row = parts + (k == 0 ? 2 * p + 1 : 2 * (p + k)) * d + c;
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(row);
    sum[0] += x.x;
    sum[1] += x.y;
    sum[2] += x.z;
    sum[3] += x.w;
  } else {
    sum[0] += row[0];
  }
}

// One CTA per (piece, group of 32 x VEC columns); the pieces with a tail
// run start a chain, the rest return after their first load.  Lane l of
// every warp takes columns [VEC l, VEC l + VEC) of the group, and warp w
// sums the chain's partials w, w + 16, ... in order (each load is one
// 16-byte vector a lane when VEC is 4); warp 0 finds the chain's last
// piece (the first whose head run does not pass through) from the
// pieces' flags, 32 x kFoldDepth a round, and adds the 16 warp sums in
// warp order.  The order depends only on the chain's length, so the sum
// has the same bits on every call.  The piece's tail id, warp 0's first
// flags and each warp's first partial load in one round, so a chain of up
// to 16 pieces costs one load round; the trained batch's longest (169
// pool tiles) one more.
template <int VEC>
__global__ void __launch_bounds__(32 * kFoldWarps)
carry_fold_kernel(const int4* __restrict__ meta,
                  const float* __restrict__ parts, float* __restrict__ out,
                  int64_t pieces, int d) {
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ int64_t last_s;
  __shared__ float sums[kFoldWarps][32 * VEC];
  const int64_t p = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 * VEC + lane * VEC;
  const int* through = reinterpret_cast<const int*>(meta) + 2;
  const auto load_flags = [&](int (&t)[kFoldDepth], int64_t base) {
#pragma unroll
    for (int j = 0; j < kFoldDepth; ++j) {
      const int64_t q = base + 32 * j + lane;
      t[j] = q < pieces ? through[4 * q] : 0;
    }
  };
  // the first load round, issued before any of it is used
  const int id = meta[p].y;
  int t[kFoldDepth];
  if (warp == 0) load_flags(t, p + 1);
  float sum[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
  if (c < d && p + warp < pieces)
    add_partial<VEC>(sum, parts, p, warp, d, c);
  if (id < 0) return;  // whole CTA: no chain starts here
  if (warp == 0) {
    int64_t last = -1;
    for (int64_t base = p + 1;; base += 32 * kFoldDepth) {
      if (base != p + 1) load_flags(t, base);
#pragma unroll
      for (int j = 0; j < kFoldDepth; ++j) {
        const unsigned stop = __ballot_sync(kFull, t[j] == 0);
        if (last < 0 && stop != 0) last = base + 32 * j + __ffs(stop) - 1;
      }
      if (last >= 0) break;
    }
    if (lane == 0) last_s = last;
  }
  __syncthreads();
  const int64_t n = last_s - p + 1;  // partials in the chain
  if (warp >= n) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = 0.f;  // read past the chain
  }
  if (c < d) {
#pragma unroll 16
    for (int64_t k = warp + kFoldWarps; k < n; k += kFoldWarps)
      add_partial<VEC>(sum, parts, p, k, d, c);
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) sums[warp][lane * VEC + v] = sum[v];
  __syncthreads();
  if (warp == 0 && c < d) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float total = sums[0][lane * VEC + v];
#pragma unroll
      for (int w = 1; w < kFoldWarps; ++w) total += sums[w][lane * VEC + v];
      atomicAdd(out + static_cast<int64_t>(id) * d + c + v, total);
    }
  }
}

// Launch the fold of `pieces` pieces of width d over scratch `carry`
// (carry_floats(pieces, d) floats) into out [.., d] on stream s.
inline cudaError_t carry_fold(float* carry, float* out, int64_t pieces,
                              int d, cudaStream_t s) {
  if (pieces == 0 || d == 0) return cudaSuccess;
  // 16-byte vectors when every partial's row starts on one
  const bool vec =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(carry) % 16 == 0;
  const int width = vec ? 128 : 32;
  const int64_t groups = (d + width - 1) / width;
  if (pieces > 2147483647LL || groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(pieces),
                  static_cast<unsigned int>(groups));
  const int4* meta = reinterpret_cast<const int4*>(carry);
  if (vec)
    carry_fold_kernel<4><<<grid, 32 * kFoldWarps, 0, s>>>(
        meta, carry + 4 * pieces, out, pieces, d);
  else
    carry_fold_kernel<1><<<grid, 32 * kFoldWarps, 0, s>>>(
        meta, carry + 4 * pieces, out, pieces, d);
  return cudaGetLastError();
}

}  // namespace repro_torch
