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
//   * each thread owns one column of a quarter of the tile (4 x ROWS rows),
//     walks its rows in order, folds the current run of equal targets in
//     a register, and makes one fp32 atomicAdd per (run end, column).
//     Edges to drop (tgt outside [0, n_tgt), or past E) form their own
//     runs and add nothing, as kernel.py:106-124 does;
//   * a run that crosses a quarter or a tile boundary meets its other part
//     in the [n_tgt, M] accumulator, which the C entry zeroes with
//     cudaMemsetAsync: an fp32 call is one memset and one kernel, a 16-bit
//     output takes one cast kernel more.
// Four walkers a column, not one: the walk is a serial chain of
// shared-memory reads, and in the §8 batches a target's run is a few edges
// long, so the extra atomics at quarter boundaries are few.
//
// Bound on this card: operations, as edge_mpnn.cu; the run scatter cuts
// the atomics, not the product.
#include "edge_mpnn/edge_mma.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::edge;

constexpr int kWalkers = edge::kThreads / kTileM;  // 4 per column
static_assert(kWalkers * kTileM == edge::kThreads, "one thread per walker");

template <int DT, int ROWS, bool VEC, bool WSTREAM>
__global__ void __launch_bounds__(edge::kThreads, 2)
edge_mpnn_runs_kernel(const __grid_constant__ EdgeArgs a) {
  using F = Frag<DT, ROWS>;
  edge_tiles<DT, ROWS, VEC, WSTREAM>(a, [&](float (&acc)[F::kRows][F::kCols],
                                      const Tile& t) {
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

    constexpr int kWalkRows = 16 * ROWS / kWalkers;  // a quarter tile
    const int c = threadIdx.x % kTileM;
    const int r0 = threadIdx.x / kTileM * kWalkRows;
    const int col = t.m0 + c;
    if (col >= a.m) return;
    float run = 0.f;
    for (int r = r0; r < r0 + kWalkRows; ++r) {
      const int dst = t.dst[r];
      run += t.msg[r * kMsgLd + c];
      if (r + 1 == r0 + kWalkRows || t.dst[r + 1] != dst) {
        if (dst >= 0)
          atomicAdd(a.acc + static_cast<int64_t>(dst) * a.m + col, run);
        run = 0.f;
      }
    }
  });
}

}  // namespace

// Same arguments as edge_mpnn_launch (edge_mpnn.cu): h_src [n_src, ds],
// h_tgt [n_tgt, dt], w [ds+dt, m], b [m] (one dtype code for all four),
// src/tgt [e] int32, acc [n_tgt, m] fp32 (the output itself for fp32,
// else scratch), out [n_tgt, m] (dtype code).  Launches on `stream`;
// returns the cudaError_t of the calls (0 on success).
extern "C" int edge_mpnn_runs_launch(const void* h_src, const void* h_tgt,
                                     const int* src, const int* tgt,
                                     const void* w, const void* b,
                                     float* acc, void* out, int e,
                                     int n_src, int n_tgt, int ds, int dt,
                                     int m, int dtype, int act,
                                     void* stream) {
  return edge_call(h_src, h_tgt, src, tgt, w, b, acc, out, e, n_src, n_tgt,
                   ds, dt, m, dtype, act, stream,
                   [](auto dt_, auto rows, auto vec, auto stream_) {
                     return edge_mpnn_runs_kernel<decltype(dt_)::value,
                                                  decltype(rows)::value,
                                                  decltype(vec)::value,
                                                  decltype(stream_)::value>;
                   });
}
