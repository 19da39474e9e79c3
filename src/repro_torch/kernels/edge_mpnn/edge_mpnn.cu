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
//   * the K = Ds + Dt axis is walked in chunks of kTileK: each chunk
//     gathers the [kTileE, kTileK] slice of the concatenated rows and the
//     [kTileK, kTileM] slice of W into shared memory;
//   * the grid's y axis walks M in tiles of kTileM columns, so any
//     message width runs on the kernel (at M <= kTileM, one tile);
//   * the [kTileE, kTileM] product is computed in the CTA's own body with
//     fp32 FMAs (no tensor cores, no TF32, no library GEMM): each warp
//     owns 4 edge rows, each lane 1 column in every 32, in registers;
//   * bias, activation, then an fp32 atomicAdd of each valid row into
//     the [n_tgt, M] accumulator; a cast kernel writes the input dtype.
//
// Bound on this card: operations.  At the served shape (E = n_tgt = 4896,
// Ds = Dt = M = 128, fp32) it is 2*E*(Ds+Dt)*M = 0.32 GFLOP against
// ~6 MB of traffic, so the fp32 FMA rate bounds it, not memory.  This
// first version stays on the CUDA cores in fp32; moving the product to
// wgmma (bf16/TF32 inputs) with TMA-fed tiles is later work.
#include "cuda_common.cuh"

namespace {

using namespace repro_torch;

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

__global__ void __launch_bounds__(kThreads)
edge_mpnn_kernel(const void* h_src, const void* h_tgt, const int* src,
                 const int* tgt, const void* w, const void* b, float* acc,
                 int e, int n_src, int n_tgt, int ds, int dt, int m,
                 int dtype, int act) {
  __shared__ float xs[kTileE][kTileK + 1];  // +1: no bank conflicts
  __shared__ float ws[kTileK][kTileM];
  __shared__ int s_src[kTileE];
  __shared__ int s_tgt[kTileE];
  __shared__ int s_dst[kTileE];  // scatter row, or -1 to drop

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e0 = blockIdx.x * kTileE;
  const int m0 = blockIdx.y * kTileM;   // this CTA's column tile
  const int mc = min(m - m0, kTileM);   // its width

  if (tid < kTileE) {
    const int ei = e0 + tid;
    int sv = 0, tv = 0, dst = -1;
    if (ei < e) {
      sv = src[ei];
      tv = tgt[ei];
      dst = (tv >= 0 && tv < n_tgt) ? tv : -1;
    }
    s_src[tid] = min(max(sv, 0), n_src - 1);
    s_tgt[tid] = min(max(tv, 0), n_tgt - 1);
    s_dst[tid] = dst;
  }
  __syncthreads();

  float accum[kRowsPerThread][kColsPerThread];
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
        v = load_as_float(h_src, static_cast<int64_t>(s_src[r]) * ds + k,
                          dtype);
      else if (k < k_total)
        v = load_as_float(h_tgt,
                          static_cast<int64_t>(s_tgt[r]) * dt + (k - ds),
                          dtype);
      xs[r][kk] = v;
    }
    for (int idx = tid; idx < kTileK * mc; idx += kThreads) {
      const int kk = idx / mc;
      const int c = idx - kk * mc;
      const int k = k0 + kk;
      ws[kk][c] = k < k_total
          ? load_as_float(w, static_cast<int64_t>(k) * m + m0 + c, dtype)
          : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = xs[warp + i * kWarps][kk];  // one row per warp: broadcast
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = lane + 32 * j;
        if (c < mc) {
          const float bw = ws[kk][c];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            accum[i][j] = fmaf(a[i], bw, accum[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int dst = s_dst[warp + i * kWarps];
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
  const int m_tiles = (m + kTileM - 1) / kTileM;
  if (m <= 0 || m_tiles > 65535 || (e > 0 && n_src <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_tgt) * m;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  zero_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(acc, n_out);
  if (e > 0) {
    const dim3 grid(static_cast<unsigned int>(
                        (static_cast<int64_t>(e) + kTileE - 1) / kTileE),
                    m_tiles);
    edge_mpnn_kernel<<<grid, kThreads, 0, s>>>(h_src, h_tgt, src, tgt, w, b,
                                               acc, e, n_src, n_tgt, ds, dt,
                                               m, dtype, act);
  }
  if (out != acc)
    cast_from_fp32_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
        acc, out, n_out, dtype);
  return static_cast<int>(cudaGetLastError());
}
