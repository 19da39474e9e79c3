// The tile product shared by edge_mpnn.cu and edge_mpnn_runs.cu: for one
// CTA's tile of kTileE edges and kTileM message columns,
//
//     accum[e][c] = ([h_src[src_e]; h_tgt[tgt_e]] @ W)[e][m0 + c]
//
// in fp32 FMAs on the CUDA cores (no tensor cores, no TF32, no library
// GEMM).  The K = Ds + Dt axis is walked in chunks of kTileK: each chunk
// gathers the [kTileE, kTileK] slice of the concatenated rows and the
// [kTileK, kTileM] slice of W into shared memory.  Each warp owns
// kRowsPerThread edge rows (row = warp + i * kWarps), each lane one column
// in every 32, in registers.  Indices are clamped before the gather
// (padding edges carry tgt >= n_tgt, as in the Pallas kernels), and
// `dst` keeps the scatter row of each edge, or -1 for an edge to drop.
#pragma once

#include "cuda_common.cuh"

namespace repro_torch {

constexpr int kTileE = 32;                         // edges per CTA
constexpr int kTileK = 32;                         // K chunk per step
constexpr int kTileM = 256;                        // columns per CTA
constexpr int kWarps = kThreads / 32;              // 8
constexpr int kRowsPerThread = kTileE / kWarps;    // 4
constexpr int kColsPerThread = kTileM / 32;        // 8

// activation codes of kernel.py: 0 relu, 1 gelu, 2 identity
constexpr int kRelu = 0;
constexpr int kGelu = 1;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kGelu) {
    // tanh approximation, as jax.nn.gelu's default
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
  }
  return v;
}

__global__ void zero_kernel(float* acc, int64_t n) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i < n) acc[i] = 0.f;
}

struct EdgeTile {
  float xs[kTileE][kTileK + 1];  // +1: no bank conflicts
  float ws[kTileK][kTileM];
  int src[kTileE];
  int tgt[kTileE];
  int dst[kTileE];  // scatter row, or -1 to drop
};

// Stage the tile's clamped indices; ends in __syncthreads().
__device__ __forceinline__ void load_tile_ids(EdgeTile& t, const int* src,
                                              const int* tgt, int e0, int e,
                                              int n_src, int n_tgt) {
  const int tid = threadIdx.x;
  if (tid < kTileE) {
    const int ei = e0 + tid;
    int sv = 0, tv = 0, dst = -1;
    if (ei < e) {
      sv = src[ei];
      tv = tgt[ei];
      dst = (tv >= 0 && tv < n_tgt) ? tv : -1;
    }
    t.src[tid] = min(max(sv, 0), n_src - 1);
    t.tgt[tid] = min(max(tv, 0), n_tgt - 1);
    t.dst[tid] = dst;
  }
  __syncthreads();
}

// accum = the tile's [kTileE, mc] product (columns m0 .. m0 + mc); ends
// in __syncthreads(), after which t.xs and t.ws are free for reuse.
__device__ __forceinline__ void tile_product(
    EdgeTile& t, float (&accum)[kRowsPerThread][kColsPerThread],
    const void* h_src, const void* h_tgt, const void* w, int ds, int dt,
    int m, int m0, int mc, int dtype) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) accum[i][j] = 0.f;

  const int k_total = ds + dt;
  for (int k0 = 0; k0 < k_total; k0 += kTileK) {
    // gather this K chunk of [h_src[src]; h_tgt[tgt]]: adjacent threads
    // read adjacent features of one row (coalesced)
    for (int idx = tid; idx < kTileE * kTileK; idx += kThreads) {
      const int r = idx / kTileK;
      const int kk = idx - r * kTileK;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < ds)
        v = load_as_float(h_src, static_cast<int64_t>(t.src[r]) * ds + k,
                          dtype);
      else if (k < k_total)
        v = load_as_float(h_tgt,
                          static_cast<int64_t>(t.tgt[r]) * dt + (k - ds),
                          dtype);
      t.xs[r][kk] = v;
    }
    for (int idx = tid; idx < kTileK * mc; idx += kThreads) {
      const int kk = idx / mc;
      const int c = idx - kk * mc;
      const int k = k0 + kk;
      t.ws[kk][c] = k < k_total
          ? load_as_float(w, static_cast<int64_t>(k) * m + m0 + c, dtype)
          : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = t.xs[warp + i * kWarps][kk];  // one row per warp: broadcast
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = lane + 32 * j;
        if (c < mc) {
          const float bw = t.ws[kk][c];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            accum[i][j] = fmaf(a[i], bw, accum[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

// Host side: the grid of one launch ((edge tiles, column tiles)), or
// false when the shape cannot launch.
inline bool edge_grid(int e, int m, int n_src, dim3* grid) {
  const int m_tiles = (m + kTileM - 1) / kTileM;
  if (m <= 0 || m_tiles > 65535 || (e > 0 && n_src <= 0)) return false;
  *grid = dim3(static_cast<unsigned int>(
                   (static_cast<int64_t>(e) + kTileE - 1) / kTileE),
               m_tiles);
  return true;
}

}  // namespace repro_torch
