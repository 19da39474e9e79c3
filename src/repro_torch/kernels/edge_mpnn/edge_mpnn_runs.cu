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
//   * the gather and the [kTileE, kTileM] fp32 product are edge_tile.cuh's,
//     unchanged from edge_mpnn.cu (one CTA per edge tile and column tile,
//     M walked in kTileM-column tiles over the grid's y axis);
//   * bias and activation, then each edge's message row goes to shared
//     memory, over the W slice the product no longer needs;
//   * each thread owns one column and walks the tile's kTileE rows in
//     order, folding the current run of equal targets in a register, and
//     makes one fp32 atomicAdd per (run end, column).  Padding edges
//     (tgt >= n_tgt, or past E) form their own runs and are dropped, as
//     kernel.py:106-124 does;
//   * a run that crosses a tile boundary meets its other half in the
//     [n_tgt, M] accumulator; a cast kernel writes the input dtype.
// The tile stays at 32 edges: the message tile then fits in the W slice's
// 32 KB, so the kernel keeps edge_mpnn.cu's static shared memory (under
// 48 KB) and register blocking, and in the §8 batches a target's run is a
// few edges long, so a longer tile would save few atomics.
//
// Bound on this card: operations, as edge_mpnn.cu (2*E*(Ds+Dt)*M fp32
// FLOPs against a few MB); the run scatter cuts the atomics, not the
// product.
#include "edge_mpnn/edge_tile.cuh"

namespace {

using namespace repro_torch;

static_assert(kTileE * kTileM <= kTileK * kTileM,
              "the message tile must fit in the W slice it reuses");
static_assert(kTileM == kThreads, "one thread per column in the run walk");

__global__ void __launch_bounds__(kThreads)
edge_mpnn_runs_kernel(const void* h_src, const void* h_tgt, const int* src,
                      const int* tgt, const void* w, const void* b,
                      float* acc, int e, int n_src, int n_tgt, int ds,
                      int dt, int m, int dtype, int act) {
  __shared__ EdgeTile t;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kTileM;   // this CTA's column tile
  const int mc = min(m - m0, kTileM);   // its width

  load_tile_ids(t, src, tgt, blockIdx.x * kTileE, e, n_src, n_tgt);
  float accum[kRowsPerThread][kColsPerThread];
  tile_product(t, accum, h_src, h_tgt, w, ds, dt, m, m0, mc, dtype);

  // messages -> shared memory (the W slice is free after tile_product)
  float (*msg)[kTileM] = t.ws;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = warp + i * kWarps;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = lane + 32 * j;
      if (c < mc)
        msg[r][c] = t.dst[r] < 0
            ? 0.f
            : activate(accum[i][j] + load_as_float(b, m0 + c, dtype), act);
    }
  }
  __syncthreads();

  // one thread per column: fold each run of equal targets, one atomic
  // per run end
  const int c = threadIdx.x;
  if (c >= mc) return;
  float run = 0.f;
  for (int r = 0; r < kTileE; ++r) {
    const int dst = t.dst[r];
    run += msg[r][c];
    if (r + 1 == kTileE || t.dst[r + 1] != dst) {
      if (dst >= 0)
        atomicAdd(acc + static_cast<int64_t>(dst) * m + m0 + c, run);
      run = 0.f;
    }
  }
}

}  // namespace

// Same arguments as edge_mpnn_launch (edge_mpnn.cu): h_src [n_src, ds],
// h_tgt [n_tgt, dt], w [ds+dt, m], b [m] (one dtype code for all four),
// src/tgt [e] int32, acc [n_tgt, m] fp32 scratch, out [n_tgt, m] (dtype
// code; may alias acc for fp32).  Launches on `stream`; returns the
// cudaError_t of the launches (0 on success).
extern "C" int edge_mpnn_runs_launch(const void* h_src, const void* h_tgt,
                                     const int* src, const int* tgt,
                                     const void* w, const void* b,
                                     float* acc, void* out, int e,
                                     int n_src, int n_tgt, int ds, int dt,
                                     int m, int dtype, int act,
                                     void* stream) {
  dim3 grid;
  if (!edge_grid(e, m, n_src, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_tgt) * m;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  zero_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(acc, n_out);
  if (e > 0)
    edge_mpnn_runs_kernel<<<grid, kThreads, 0, s>>>(
        h_src, h_tgt, src, tgt, w, b, acc, e, n_src, n_tgt, ds, dt, m,
        dtype, act);
  if (out != acc)
    cast_from_fp32_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
        acc, out, n_out, dtype);
  return static_cast<int>(cudaGetLastError());
}
