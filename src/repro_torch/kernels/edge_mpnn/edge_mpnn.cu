// edge_mpnn for Hopper (sm_90a): the fused MPNN edge convolution
//
//     out[t] = sum_{e: tgt_e = t} act([h_src[src_e]; h_tgt[tgt_e]] @ W + b)
//
// for edges in any order; act is relu, gelu (tanh form) or identity.
//
// Replaces the Pallas TPU kernel `edge_mpnn` in
// src/repro/kernels/edge_mpnn/kernel.py (_edge_mpnn_kernel).  There the
// gathers and the scatter are one-hot matmuls on the MXU into a
// VMEM-resident accumulator over a sequential grid.  Here:
//   * one CTA per tile of kTileE edges loads and clamps its own indices
//     (padding edges carry tgt >= n_tgt; clamping keeps every gather in
//     bounds, as kernel.py's run variant does);
//   * the grid's y axis walks M in tiles of kTileM columns, so any
//     message width runs on the kernel (at M <= kTileM, one tile);
//   * the [kTileE, kTileM] product is edge_tile.cuh's: gathered rows and
//     a W slice in shared memory, fp32 FMAs in the CTA's own body (no
//     tensor cores, no TF32, no library GEMM);
//   * bias, activation, then an fp32 atomicAdd of each valid row into
//     the [n_tgt, M] accumulator; a cast kernel writes the input dtype.
// edge_mpnn_runs.cu keeps the product and replaces the per-edge atomics
// with one atomic per run of equal targets.
//
// Bound on this card: operations.  At the served shape (E = n_tgt = 4896,
// Ds = Dt = M = 128, fp32) it is 2*E*(Ds+Dt)*M = 0.32 GFLOP against
// ~6 MB of traffic, so the fp32 FMA rate bounds it, not memory.  This
// first version stays on the CUDA cores in fp32; moving the product to
// wgmma (bf16/TF32 inputs) with TMA-fed tiles is later work.
#include "edge_mpnn/edge_tile.cuh"

namespace {

using namespace repro_torch;

__global__ void __launch_bounds__(kThreads)
edge_mpnn_kernel(const void* h_src, const void* h_tgt, const int* src,
                 const int* tgt, const void* w, const void* b, float* acc,
                 int e, int n_src, int n_tgt, int ds, int dt, int m,
                 int dtype, int act) {
  __shared__ EdgeTile t;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kTileM;   // this CTA's column tile
  const int mc = min(m - m0, kTileM);   // its width

  load_tile_ids(t, src, tgt, blockIdx.x * kTileE, e, n_src, n_tgt);
  float accum[kRowsPerThread][kColsPerThread];
  tile_product(t, accum, h_src, h_tgt, w, ds, dt, m, m0, mc, dtype);

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int dst = t.dst[warp + i * kWarps];
    if (dst < 0) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = lane + 32 * j;
      if (c < mc) {
        const float v = activate(
            accum[i][j] + load_as_float(b, m0 + c, dtype), act);
        atomicAdd(acc + static_cast<int64_t>(dst) * m + m0 + c, v);
      }
    }
  }
}

}  // namespace

// h_src [n_src, ds], h_tgt [n_tgt, dt], w [ds+dt, m], b [m] (one dtype
// code for all four), src/tgt [e] int32, acc [n_tgt, m] fp32 scratch,
// out [n_tgt, m] (dtype code; may alias acc for fp32).  Launches on
// `stream`; returns the cudaError_t of the launches (0 on success).
extern "C" int edge_mpnn_launch(const void* h_src, const void* h_tgt,
                                const int* src, const int* tgt,
                                const void* w, const void* b, float* acc,
                                void* out, int e, int n_src, int n_tgt,
                                int ds, int dt, int m, int dtype, int act,
                                void* stream) {
  dim3 grid;
  if (!edge_grid(e, m, n_src, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_tgt) * m;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  zero_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(acc, n_out);
  if (e > 0)
    edge_mpnn_kernel<<<grid, kThreads, 0, s>>>(h_src, h_tgt, src, tgt, w, b,
                                               acc, e, n_src, n_tgt, ds, dt,
                                               m, dtype, act);
  if (out != acc)
    cast_from_fp32_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
        acc, out, n_out, dtype);
  return static_cast<int>(cudaGetLastError());
}
