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
//   * the gather and the [16 x ROWS edges, 64 columns] tile product are
//     edge_mma.cuh's: ids clamped per tile, rows gathered by cp.async into
//     a 3-stage ring, W's column slice held in shared memory for all of a
//     CTA's edge tiles, an fp32 FMA chain in k order (fp32) or mma.sync on
//     the tensor cores (bf16, fp16) into fp32 registers;
//   * the epilogue works on the accumulators where they lie (fp32: 4
//     adjacent columns of 4 rows a thread; 16-bit, as mma.m16n8 lays them
//     out: pairs of adjacent columns of 2 rows): bias, activation, then
//     one float4 / float2 atomicAdd per row and column group into the
//     [n_tgt, M] fp32 accumulator (scalar atomics when M is not a multiple
//     of the group); edges to drop (tgt outside [0, n_tgt), or past E) add
//     nothing;
//   * the C entry zeroes the accumulator with cudaMemsetAsync, so an fp32
//     call (the accumulator is the output) is one memset and one kernel;
//     a 16-bit output takes one cast kernel more.
// edge_mpnn_runs.cu keeps the product and replaces the per-edge atomics
// with one atomic per run of equal targets.
//
// Bound on this card: operations (2*E*(Ds+Dt)*M against ~5 MB at the
// served shape; edge_mma.cuh has the arithmetic and the design).
#include "edge_mpnn/edge_mma.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::edge;

template <int DT, int ROWS, bool VEC, bool WSTREAM>
__global__ void __launch_bounds__(edge::kThreads, 2)
edge_mpnn_kernel(const __grid_constant__ EdgeArgs a) {
  using F = Frag<DT, ROWS>;
  edge_tiles<DT, ROWS, VEC, WSTREAM>(a, [&](float (&acc)[F::kRows][F::kCols],
                                      const Tile& t) {
    const bool vec = a.m % F::kGroup == 0;  // vector-aligned rows
#pragma unroll
    for (int i = 0; i < F::kRows; ++i) {
      const int dst = t.dst[t.row0 + i * F::kRowStep];
      if (dst < 0) continue;
#pragma unroll
      for (int gi = 0; gi < F::kGroups; ++gi) {
        const int c = t.col0 + gi * F::kGroupStep;
        const int col = t.m0 + c;
        if (col >= a.m) break;
        float v[F::kGroup];
#pragma unroll
        for (int h = 0; h < F::kGroup; ++h)
          v[h] = activate(acc[i][gi * F::kGroup + h] + t.bias[c + h], a.act);
        float* p = a.acc + static_cast<int64_t>(dst) * a.m + col;
        if (vec) {
          atomic_add_vec(p, v);
        } else {
#pragma unroll
          for (int h = 0; h < F::kGroup; ++h)
            if (col + h < a.m) atomicAdd(p + h, v[h]);
        }
      }
    }
  });
}

}  // namespace

// h_src [n_src, ds], h_tgt [n_tgt, dt], w [ds+dt, m], b [m] (one dtype
// code for all four), src/tgt [e] int32, acc [n_tgt, m] fp32 (the output
// itself for fp32, else scratch), out [n_tgt, m] (dtype code); tiles of
// `tile` edges (fp32 32, 64 or 128, 16-bit 64; 0 the default,
// edge_mma.cuh tile_rows).  Launches on `stream`; returns the
// cudaError_t of the calls (0 on success; cudaErrorInvalidValue, with
// nothing launched, for a tile that is not built).
extern "C" int edge_mpnn_launch(const void* h_src, const void* h_tgt,
                                const int* src, const int* tgt,
                                const void* w, const void* b, float* acc,
                                void* out, int e, int n_src, int n_tgt,
                                int ds, int dt, int m, int dtype, int act,
                                int tile, void* stream) {
  return edge_call(h_src, h_tgt, src, tgt, w, b, acc, out, nullptr, 0, e,
                   n_src, n_tgt, ds, dt, m, dtype, act, tile, stream,
                   [](auto dt_, auto rows, auto vec, auto stream_) {
                     return edge_mpnn_kernel<decltype(dt_)::value,
                                             decltype(rows)::value,
                                             decltype(vec)::value,
                                             decltype(stream_)::value>;
                   });
}
