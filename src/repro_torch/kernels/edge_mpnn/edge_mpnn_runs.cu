// edge_mpnn_runs for Hopper (sm_90a): the fused MPNN edge convolution
//
//     out[t] = sum_{e: tgt_e = t} act([h_src[src_e]; h_tgt[tgt_e]] @ W + b)
//
// with the scatter done once per run of equal targets.  Same contract as
// edge_mpnn.cu; correct for any edge order, fastest when tgt is sorted
// (the training batches sort every edge set by target).
//
// Replaces the Pallas TPU kernel `edge_mpnn_runs` in
// src/repro/kernels/edge_mpnn/kernel.py (_edge_mpnn_runs_kernel): per-row
// gathers, the message matmul, then a segmented run scan over tgt and one
// row update per run end into a VMEM-resident accumulator.  Here:
//   * the gather and the [16 x ROWS edges, 64 columns] tile product are
//     edge_mma.cuh's, as in edge_mpnn.cu (cp.async ring, W's column slice
//     in shared memory, fp32 FMA chain or bf16/fp16 mma.sync);
//   * bias and activation, then the tile's messages go to shared memory
//     (the ring, which the product no longer needs), as fp32;
//   * four threads a column each walk a quarter of the tile's rows in
//     order and fold the current run of equal targets in a register; a
//     run that starts and ends inside the quarter makes one fp32
//     atomicAdd into the [n_tgt, M] accumulator, which the C entry
//     zeroes with cudaMemsetAsync.  Each quarter's first and last run
//     then meet across the quarters, in order, in the column's first
//     thread.  Edges to drop (tgt outside [0, n_tgt), or past E) form
//     their own runs and add nothing, as kernel.py:106-124 does;
//   * a run that crosses the tile's boundary (the edge before or after
//     the tile has its target) instead stores its partial to the tile's
//     carry slot, and a second kernel adds each chain of such partials in
//     tile order (carry.cuh).  On target-sorted edges every row of the
//     output then gets exactly one fp32 add onto 0, so the result is
//     bit-identical from call to call whatever the run length.  An fp32
//     call is one memset and two kernels; a 16-bit output takes one cast
//     kernel more.
//
// Bound on this card: operations, as edge_mpnn.cu; the run scatter cuts
// the atomics, not the product.
#include "edge_mpnn/edge_mma.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::edge;

constexpr int kWalkers = edge::kThreads / kTileM;  // 4 a column
static_assert(kWalkers * kTileM == edge::kThreads, "one thread a walker");

template <int DT, int ROWS, bool VEC, bool WSTREAM>
__global__ void __launch_bounds__(edge::kThreads, 2)
edge_mpnn_runs_kernel(const __grid_constant__ EdgeArgs a) {
  using F = Frag<DT, ROWS>;
  edge_tiles<DT, ROWS, VEC, WSTREAM>(a, [&](float (&acc)[F::kRows][F::kCols],
                                      const Tile& t) {
    // the tile's neighbours across its boundary (as dst values), loaded
    // first so that their latency hides behind the message stores
    constexpr int kTileE = 16 * ROWS;
    const int64_t e0 = static_cast<int64_t>(t.index) * kTileE;
    const auto dst_of = [&](int64_t i) {
      const int v = a.tgt[i];
      return v >= 0 && v < a.n_tgt ? v : -1;
    };
    int before = -1, after = -1;
    if (threadIdx.x < kTileM) {
      if (e0 > 0) before = dst_of(e0 - 1);
      if (e0 + kTileE < a.e) after = dst_of(e0 + kTileE);
    }
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int i = 0; i < F::kRows; ++i) {
#pragma unroll
      for (int gi = 0; gi < F::kGroups; ++gi) {
        const int c = t.col0 + gi * F::kGroupStep;
        float v[F::kGroup];
#pragma unroll
        for (int h = 0; h < F::kGroup; ++h)
          v[h] = activate(acc[i][gi * F::kGroup + h] + t.bias[c + h], a.act);
        store_vec(t.msg + (t.row0 + i * F::kRowStep) * kMsgLd + c, v);
      }
    }
    __syncthreads();

    // Four walkers a column, each over a quarter of the tile's rows, in
    // order.  A run that starts and ends inside its quarter is, on sorted
    // targets, a whole segment: it adds at once.  A quarter's first run
    // (from its first row) and last run (to its last row) go to its
    // first two message rows, which only this walker reads, and after a
    // barrier the column's first walker joins them across the quarters in
    // order into the tile's runs.
    constexpr int kWalkRows = kTileE / kWalkers;  // 8 fp32, 16 16-bit
    const int c = threadIdx.x % kTileM;
    const int q = threadIdx.x / kTileM;
    const int col = t.m0 + c;
    const bool active = col < a.m;
    const int r0 = q * kWalkRows;
    if (active) {
      float first = 0.f, run = 0.f;
      bool in_first = true;
#pragma unroll
      for (int k = 0; k < kWalkRows; ++k) {
        const int dst = t.dst[r0 + k];
        run += t.msg[(r0 + k) * kMsgLd + c];
        if (k + 1 < kWalkRows && t.dst[r0 + k + 1] != dst) {
          if (in_first)
            first = run;
          else if (dst >= 0)
            atomicAdd(a.acc + static_cast<int64_t>(dst) * a.m + col, run);
          in_first = false;
          run = 0.f;
        }
      }
      t.msg[r0 * kMsgLd + c] = first;
      t.msg[(r0 + 1) * kMsgLd + c] = run;
    }
    __syncthreads();
    if (q != 0 || !active) return;

    const int last = a.e - e0 < kTileE ? static_cast<int>(a.e - e0) - 1
                                       : kTileE - 1;
    const bool from_prev = t.dst[0] >= 0 && before == t.dst[0];
    const bool into_next = t.dst[last] >= 0 && after == t.dst[last];
    const auto emit = [&](float sum, int dst, bool first_run,
                          bool last_run) {
      if (dst < 0) return;
      const int slot = carry_slot(first_run, last_run, from_prev, into_next);
      if (slot == kCarryAdd)
        atomicAdd(a.acc + static_cast<int64_t>(dst) * a.m + col, sum);
      else
        a.parts[(2 * static_cast<int64_t>(t.index) + slot) * a.m + col] =
            sum;
    };
    // cur: the run open at the end of the quarters joined so far; split:
    // a run ended before the tile's last row
    float cur = 0.f;
    int cur_id = -1;
    bool cur_first = false, split = false;
#pragma unroll
    for (int w = 0; w < kWalkers; ++w) {
      const int s0 = w * kWalkRows;
      bool one = true;  // one run covers the quarter
#pragma unroll
      for (int k = 0; k + 1 < kWalkRows; ++k)
        one = one && t.dst[s0 + k + 1] == t.dst[s0 + k];
      const float head = t.msg[s0 * kMsgLd + c];
      const float tail = t.msg[(s0 + 1) * kMsgLd + c];
      const int head_id = t.dst[s0];
      if (w > 0 && head_id == cur_id) {  // the open run goes on
        if (one) {
          cur += tail;
          continue;
        }
        emit(cur + head, cur_id, cur_first, false);
      } else {
        if (w > 0) {
          emit(cur, cur_id, cur_first, false);
          split = true;
        }
        if (one) {
          cur = tail;
          cur_id = head_id;
          cur_first = w == 0;
          continue;
        }
        emit(head, head_id, w == 0, false);
      }
      split = true;
      cur = tail;
      cur_id = t.dst[s0 + kWalkRows - 1];
      cur_first = false;
    }
    emit(cur, cur_id, cur_first, true);
    if (c == 0 && blockIdx.y == 0)
      a.meta[t.index] = carry_meta(t.dst[0], t.dst[last], !split,
                                   from_prev, into_next);
  });
}

}  // namespace

// Same arguments as edge_mpnn_launch (edge_mpnn.cu): h_src [n_src, ds],
// h_tgt [n_tgt, dt], w [ds+dt, m], b [m] (one dtype code for all four),
// src/tgt [e] int32, acc [n_tgt, m] fp32 (the output itself for fp32,
// else scratch), out [n_tgt, m] (dtype code); and carry, scratch of
// carry_floats(carry_pieces, m) floats (carry.cuh), carry_pieces at least
// the call's edge tiles (ceil(e / 32) covers every dtype and tile); tiles
// of `tile` edges as edge_mpnn_launch's.  Launches on `stream`; returns
// the cudaError_t of the calls (0 on success).
extern "C" int edge_mpnn_runs_launch(const void* h_src, const void* h_tgt,
                                     const int* src, const int* tgt,
                                     const void* w, const void* b,
                                     float* acc, void* out, float* carry,
                                     long long carry_pieces, int e,
                                     int n_src, int n_tgt, int ds, int dt,
                                     int m, int dtype, int act, int tile,
                                     void* stream) {
  if (e > 0 && carry == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return edge_call(h_src, h_tgt, src, tgt, w, b, acc, out, carry,
                   carry_pieces, e, n_src, n_tgt, ds, dt, m, dtype, act,
                   tile, stream,
                   [](auto dt_, auto rows, auto vec, auto stream_) {
                     return edge_mpnn_runs_kernel<decltype(dt_)::value,
                                                  decltype(rows)::value,
                                                  decltype(vec)::value,
                                                  decltype(stream_)::value>;
                   });
}
