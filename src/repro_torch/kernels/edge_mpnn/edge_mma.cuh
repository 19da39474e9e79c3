// The tile product shared by edge_mpnn.cu and edge_mpnn_runs.cu, for
// Hopper (sm_90a): for one CTA's column tile of kTileM message columns
// and each of its tiles of 16 x ROWS edges,
//
//     acc[e][c] = ([h_src[src_e]; h_tgt[tgt_e]] @ W)[e][m0 + c]
//
// in registers, with no library GEMM; each kernel adds its own epilogue
// (bias, activation, scatter).
//
// Arithmetic.  bf16 and fp16 inputs run on the tensor cores, `mma.sync
// m16n8k16` through inline PTX into fp32 accumulators (their products are
// exact).  fp32 inputs run a register-blocked fp32 FMA chain on the CUDA
// cores, ROWS x 4 outputs a thread, each output summed over k = 0, 1, ...,
// K - 1 in order: the plain version's order, whose roundings it repeats.
// The tensor cores' fp32 form, 3xTF32 (x = hi + lo in TF32; lo*hi + hi*lo
// + hi*hi), was built first and dropped: on the H100 it was closer to an
// fp64 result than the plain version is, but chip_smoke.py's trained-shape
// check holds the kernel to the plain version with an absolute 1e-6 on
// rows whose messages nearly cancel, below the plain version's own error,
// and only a product that sums in its order meets that
// (tests/test_torch_edge_mma.py shows the exact result missing it).
//
// Why mma.sync and not wgmma for 16-bit: the product is small (0.32
// GFLOP at the served shape, E 4896 x K 256 x M 128) and the edge rows
// are gathered; mma.sync reads its fragments from any shared layout, so
// W is transposed once per CTA and the gathered rows stay row-major.
//
// Bound: 2*E*K*M operations against ~5 MB (fp32; the gathered rows read
// once), so operations for fp32 (4.55 us on the CUDA cores at the served
// shape) and bytes for bf16 (0.73 us).
// The design:
//   * fill: tiles of 16 x ROWS edges and 64 columns (M 128 is two full
//     column tiles), 256 threads, up to 2 CTAs per SM.  fp32 tiles are 32
//     edges by default (kFmaRows), 16-bit tiles 64 (kMmaRows).  The fp32
//     height was measured on an H100 at every edge launch of a served
//     batch and a training forward of the §8 model (E 64 .. 5175, M 128),
//     at heights 32 .. 128 (scripts/edge_tile_sweep.py): 32 everywhere
//     came within 0.6% of the best height per launch, and no rule that
//     picks a height per call did better.  (On uniformly random ids at E
//     4896, taller tiles win: 306 tiles of 32 edges take two rounds of
//     the 264 resident CTAs; the served batches' E 4896 launch, whose
//     padding edges share one row, does not.)  So the height is also an
//     argument of the C entries: fp32 takes 32, 64 or 128 edges and
//     16-bit 64 (tile_rows), and kernels/autotune.py records the fastest per
//     exact shape; 0 keeps the default.  Past 2 CTAs per SM the grid is
//     persistent: a CTA walks edge tiles blockIdx.x, + gridDim.x, ...;
//   * W on chip: each CTA loads its [K, kTileM] slice of W once and keeps
//     it in shared memory for all its edge tiles (above 48 KB after
//     cudaFuncSetAttribute); a K too large for that streams W in
//     kTileK-row chunks through the ring instead;
//   * in flight: each gathered row chunk (kTileK elements of a row of
//     h_src or h_tgt) moves with a 16-byte `cp.async` into a ring of
//     kStages stages, so later chunks load while one multiplies; copies
//     zero-fill past K, so chunks that straddle Ds or K need no branch in
//     the product.  Rows or bases not 16-byte aligned (Ds or Dt not a
//     multiple of 4 fp32 / 8 16-bit elements, or a storage offset) take
//     the scalar-copy form of the same kernel (template VEC = false);
//   * shared-memory traffic: the fp32 chain reads 16-byte vectors (4 k of
//     a row, 4 columns of W), ROWS + 4 loads per 16 x ROWS FMAs; one
//     mma.m16n8k16 takes 4 + 2 32-bit loads; paddings keep both free of
//     bank conflicts.
//     Counted, those vector loads keep the shared-memory port busier than
//     the FMAs keep the FMA pipes, so a CTA of one SM runs at its port's
//     pace whether or not a second CTA shares the SM;
//   * no division per element and no dtype switch in the loop: the
//     kernels are templates over dtype, tile height, copy form and W
//     mode.
// Indices are clamped before the gather (padding edges carry tgt >=
// n_tgt, as in the Pallas kernels), and `dst` keeps each edge's scatter
// row, or -1 for an edge to drop.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "carry.cuh"
#include "cuda_common.cuh"

namespace repro_torch {
namespace edge {

constexpr int kThreads = 256;   // 8 warps
constexpr int kMmaRows = 4;     // 16-bit tiles: 4 x 16 = 64 edges
constexpr int kFmaRows = 2;     // fp32 default: 2 x 16 = 32 edges
constexpr int kTileM = 64;      // columns per CTA
constexpr int kTileK = 32;      // K elements per ring stage
constexpr int kStages = 3;      // ring depth
constexpr int kWarpCols = 2;    // warps along columns (32 columns each)
constexpr int kNTiles = 4;      // n8 mma tiles per warp
constexpr int kMsgLd = kTileM + 8;  // message tile row stride (floats)
constexpr int kMaxSmem = 232448;    // a block's dynamic shared memory
constexpr int kSmSmem = 233472;     // an SM's, 1 KB of it per block
static_assert(kThreads / 32 == kMmaRows * kWarpCols, "warp grid");
static_assert(kWarpCols * kNTiles * 8 == kTileM, "warp columns");

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

// Shared-memory element of a dtype (16-bit values stay raw bits: the mma
// reads them as they are) and its sizes.
template <int DT>
struct Elem {
  using T = uint16_t;
  static constexpr int kVec = 8;                 // elements per 16 bytes
  static constexpr int kXLd = kTileK + 8;        // X row stride
};
template <>
struct Elem<kFloat32> {
  using T = float;
  static constexpr int kVec = 4;
  static constexpr int kXLd = kTileK + 4;
};

// The layout of the dynamic shared memory, the same on host and device,
// for tiles of 16 x `rows` edges:
//   [bias kTileM floats][src, tgt, dst 16 x rows ints][ring][W slice]
// A ring stage holds one X chunk [16 x rows][kXLd] (and, when W streams, a
// W chunk); the runs epilogue reuses the ring for its message tile.
// W resident: fp32 [k_pad][kTileM + 8] as W is laid out; 16-bit
// transposed, [kTileM][k_pad + 8].  Streaming, one chunk: k_pad = kTileK.
struct Layout {
  int64_t w_ld;         // W row stride in elements
  int64_t x_bytes;      // one X chunk
  int64_t w_bytes;      // the W region: whole slice, or one chunk
  int64_t stage_bytes;  // X chunk (+ W chunk when streaming)
  int64_t ring_bytes;
  int64_t total;        // bytes of dynamic shared memory
};

__host__ __device__ inline Layout layout(int dtype, int rows, int k_pad,
                                         bool stream) {
  const bool f32 = dtype == kFloat32;
  const int64_t tile_e = 16 * rows;
  const int64_t esize = f32 ? 4 : 2;
  const int64_t wk = stream ? kTileK : k_pad;
  Layout l;
  l.w_ld = f32 ? kTileM + 8 : wk + 8;
  l.x_bytes = tile_e * (f32 ? Elem<kFloat32>::kXLd : Elem<kBFloat16>::kXLd)
              * esize;
  l.w_bytes = (f32 ? wk : kTileM) * l.w_ld * esize;
  l.stage_bytes = l.x_bytes + (stream ? l.w_bytes : 0);
  const int64_t msg_bytes = tile_e * kMsgLd * 4;
  l.ring_bytes = kStages * l.stage_bytes > msg_bytes
                     ? kStages * l.stage_bytes : msg_bytes;
  l.total = kTileM * 4 + 3 * tile_e * 4 + l.ring_bytes
            + (stream ? 0 : l.w_bytes);
  return l;
}

inline int k_padded(int k) { return (k + kTileK - 1) / kTileK * kTileK; }

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (`src` must
// still be a valid address; nothing is read from it)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d (4 fp32 accumulators of mma.m16n8) += a (16 x 16) * b (16 x 8)
template <int DT>
__device__ __forceinline__ void mma_16bit(float& d0, float& d1, float& d2,
                                          float& d3, const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (DT == kBFloat16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// the CTA's work
// ---------------------------------------------------------------------------

struct EdgeArgs {
  const void* h_src;
  const void* h_tgt;
  const int* src;
  const int* tgt;
  const void* w;
  const void* b;
  float* acc;
  int4* meta;    // edge_mpnn_runs' carry (carry.cuh), one piece a tile
  float* parts;
  int e, n_src, n_tgt, ds, dt, m, act, k_pad;
  int w_vec;  // W rows 16-byte aligned (fp32 only): cp.async for W
};

// A thread's outputs of the [16 x ROWS, kTileM] tile: acc[i][j] is row
// row0 + i * kRowStep and column col0 + (j / kGroup) * kGroupStep +
// j % kGroup of the tile; each group of kGroup columns is adjacent
// (vector stores and atomics).  16-bit: mma.m16n8 fragments of the
// warp's 16 rows x 32 columns (n8 tile j / 2); fp32: ROWS rows x 4
// columns.
template <int DT, int ROWS>
struct Frag {
  static_assert(ROWS == kMmaRows, "16-bit tiles are 64 edges");
  static constexpr int kRows = 2, kRowStep = 8;
  static constexpr int kGroup = 2, kGroups = kNTiles, kGroupStep = 8;
  static constexpr int kCols = kGroup * kGroups;
};
template <int ROWS>
struct Frag<kFloat32, ROWS> {
  static constexpr int kRows = ROWS, kRowStep = 16;
  static constexpr int kGroup = 4, kGroups = 1, kGroupStep = 0;
  static constexpr int kCols = kGroup * kGroups;
};
constexpr int kFmaColThreads = kTileM / 4;  // 16
static_assert(kFmaColThreads * 16 == kThreads,
              "fp32: one thread per ROWS x 4 block of the tile");

// p[0 .. N) += v as one vector atomic (sm_90's float2 / float4 forms; p
// aligned to N floats)
template <int N>
__device__ __forceinline__ void atomic_add_vec(float* p, const float (&v)[N]) {
  static_assert(N == 2 || N == 4, "float2 or float4");
  if constexpr (N == 4)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  static_assert(N == 2 || N == 4, "float2 or float4");
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// What an epilogue sees of its tile.
struct Tile {
  int index;          // the edge tile: edges [index * 16 * ROWS, ...)
  int m0;             // the CTA's first column
  int row0, col0;     // this thread's first row and column in the tile
  const float* bias;  // [kTileM] fp32, 0 past M
  const int* dst;     // [16 x ROWS] scatter row or -1
  float* msg;         // [16 x ROWS][kMsgLd] fp32, free for the epilogue
};

// Copy rows [kb, kb + kn) of the CTA's W slice into `ws` (stride w_ld),
// zeros past K and M: fp32 as laid out ([k][n]), 16-bit transposed
// ([n][k - kb]).  cp.async when `vec` (fp32 with 16-byte rows).
template <int DT>
__device__ __forceinline__ void load_w(typename Elem<DT>::T* ws, int w_ld,
                                       const EdgeArgs& a, int m0, int kb,
                                       int kn, bool vec) {
  using T = typename Elem<DT>::T;
  const T* w = static_cast<const T*>(a.w);
  const int k_total = a.ds + a.dt;
  if constexpr (DT == kFloat32) {
    if (vec) {
      constexpr int kQuads = kTileM / 4;
      for (int i = threadIdx.x; i < kn * kQuads; i += kThreads) {
        const int kk = i / kQuads, c = (i % kQuads) * 4;
        const int k = kb + kk;
        const bool ok = k < k_total && m0 + c < a.m;
        cp_async16(ws + kk * w_ld + c,
                   ok ? w + static_cast<int64_t>(k) * a.m + m0 + c : w, ok);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < kn * kTileM; i += kThreads) {
    const int kk = i / kTileM, c = i % kTileM;
    const int k = kb + kk;
    T v = T(0);
    if (k < k_total && m0 + c < a.m)
      v = w[static_cast<int64_t>(k) * a.m + m0 + c];
    if constexpr (DT == kFloat32)
      ws[kk * w_ld + c] = v;
    else
      ws[c * w_ld + kk] = v;
  }
}

// Gather K chunk [k0, k0 + kTileK) of the tile's [h_src[src]; h_tgt[tgt]]
// rows into `xs` ([16 x ROWS][kXLd]), zeros past K.
template <int DT, int ROWS, bool VEC>
__device__ __forceinline__ void load_x(typename Elem<DT>::T* xs,
                                       const EdgeArgs& a, const int* src_s,
                                       const int* tgt_s, int k0) {
  using T = typename Elem<DT>::T;
  constexpr int kXLd = Elem<DT>::kXLd;
  const T* hs = static_cast<const T*>(a.h_src);
  const T* ht = static_cast<const T*>(a.h_tgt);
  const int k_total = a.ds + a.dt;
  if constexpr (VEC) {
    // Ds and Dt are multiples of kVec: a 16-byte copy never straddles Ds
    // or K
    constexpr int kV = Elem<DT>::kVec;
    constexpr int kPerRow = kTileK / kV;
    for (int i = threadIdx.x; i < 16 * ROWS * kPerRow; i += kThreads) {
      const int r = i / kPerRow, kk = (i % kPerRow) * kV;
      const int k = k0 + kk;
      const T* p = hs;
      if (k < a.ds)
        p = hs + static_cast<int64_t>(src_s[r]) * a.ds + k;
      else if (k < k_total)
        p = ht + static_cast<int64_t>(tgt_s[r]) * a.dt + (k - a.ds);
      cp_async16(xs + r * kXLd + kk, p, k < k_total);
    }
  } else {
    for (int i = threadIdx.x; i < 16 * ROWS * kTileK; i += kThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int k = k0 + kk;
      T v = T(0);
      if (k < a.ds)
        v = hs[static_cast<int64_t>(src_s[r]) * a.ds + k];
      else if (k < k_total)
        v = ht[static_cast<int64_t>(tgt_s[r]) * a.dt + (k - a.ds)];
      xs[r * kXLd + kk] = v;
    }
  }
}

// acc += one kTileK chunk: xs [16 x ROWS][kXLd] (the gathered rows); the
// chunk's W rows at `wk` (fp32: wk[kk * w_ld + n]; 16-bit, transposed:
// wk[n * w_ld + kk]).  16-bit: the warp's 16 rows from wrow and its
// n_active n8 tiles from wcol; fp32: rows ty + 16 i, columns 4 tx + j.
template <int DT, int ROWS>
__device__ __forceinline__ void chunk_product(
    float (&acc)[Frag<DT, ROWS>::kRows][Frag<DT, ROWS>::kCols],
    const typename Elem<DT>::T* xs, const typename Elem<DT>::T* wk,
    int w_ld, int wrow, int wcol, int n_active) {
  constexpr int kXLd = Elem<DT>::kXLd;
  if constexpr (DT == kFloat32) {
    const int ty = threadIdx.x / kFmaColThreads;
    const int tx = threadIdx.x % kFmaColThreads;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 4) {
      float a[ROWS][4], b[4][4];  // a[row][k], b[k][column]
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        *reinterpret_cast<float4*>(a[i]) = *reinterpret_cast<const float4*>(
            xs + (ty + 16 * i) * kXLd + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(b[q]) = *reinterpret_cast<const float4*>(
            wk + (kk + q) * w_ld + 4 * tx);
      // k in order, then rows and columns: each output's chain runs
      // k = 0, 1, ... as the plain version's
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
    }
  } else {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      const uint16_t* x0 = xs + (wrow + g) * kXLd + kk + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(x0);
      a[1] = *reinterpret_cast<const uint32_t*>(x0 + 8 * kXLd);
      a[2] = *reinterpret_cast<const uint32_t*>(x0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(x0 + 8 * kXLd + 8);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        if (j >= n_active) break;
        const uint16_t* w0 = wk + (wcol + j * 8 + g) * w_ld + kk + 2 * t;
        mma_16bit<DT>(acc[0][2 * j], acc[0][2 * j + 1], acc[1][2 * j],
                      acc[1][2 * j + 1], a,
                      *reinterpret_cast<const uint32_t*>(w0),
                      *reinterpret_cast<const uint32_t*>(w0 + 8));
      }
    }
  }
}

// The CTA's whole job: load W (once, unless it streams), then for each
// of its edge tiles stage the clamped ids, run the K chunks through the
// ring into the accumulators, and hand them to `epilogue(acc, tile)`
// (acc as Frag<DT, ROWS> lays it out).
// The epilogue may use tile.msg (the ring) after a __syncthreads of its
// own; the next tile starts with one.
template <int DT, int ROWS, bool VEC, bool WSTREAM, typename Epilogue>
__device__ __forceinline__ void edge_tiles(const EdgeArgs& a,
                                           Epilogue epilogue) {
  using T = typename Elem<DT>::T;
  using F = Frag<DT, ROWS>;
  constexpr int kTileE = 16 * ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(DT, ROWS, a.k_pad, WSTREAM);
  const int w_ld = static_cast<int>(l.w_ld);
  const int x_bytes = static_cast<int>(l.x_bytes);
  const int stage_bytes = static_cast<int>(l.stage_bytes);
  float* bias = reinterpret_cast<float*>(smem);
  int* src_s = reinterpret_cast<int*>(bias + kTileM);
  int* tgt_s = src_s + kTileE;
  int* dst_s = tgt_s + kTileE;
  unsigned char* ring = reinterpret_cast<unsigned char*>(dst_s + kTileE);
  T* w_res = reinterpret_cast<T*>(ring + l.ring_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kTileM;
  // 16-bit: the warp's 16 rows and 32 columns, and its n8 tiles that
  // hold a column < M (warp-uniform)
  const int wrow = (warp / kWarpCols) * 16;
  const int wcol = (warp % kWarpCols) * (kNTiles * 8);
  const int cols_left = a.m - m0 - wcol;
  const int n_active = cols_left <= 0 ? 0
                       : min(kNTiles, (cols_left + 7) / 8);
  Tile tile;
  tile.m0 = m0;
  if constexpr (DT == kFloat32) {
    tile.row0 = tid / kFmaColThreads;
    tile.col0 = 4 * (tid % kFmaColThreads);
  } else {
    tile.row0 = wrow + (lane >> 2);
    tile.col0 = wcol + 2 * (lane & 3);
  }
  tile.bias = bias;
  tile.dst = dst_s;
  tile.msg = reinterpret_cast<float*>(ring);

  for (int c = tid; c < kTileM; c += kThreads)
    bias[c] = m0 + c < a.m ? load_as_float(a.b, m0 + c, DT) : 0.f;
  if constexpr (!WSTREAM) {
    load_w<DT>(w_res, w_ld, a, m0, 0, a.k_pad, a.w_vec);
    cp_async_commit();
  }

  auto stage_x = [&](int s) {
    return reinterpret_cast<T*>(ring + s * stage_bytes);
  };
  auto stage_w = [&](int s) {
    return reinterpret_cast<T*>(ring + s * stage_bytes + x_bytes);
  };
  auto load_chunk = [&](int kc) {
    const int s = kc % kStages;
    load_x<DT, ROWS, VEC>(stage_x(s), a, src_s, tgt_s, kc * kTileK);
    if constexpr (WSTREAM)
      load_w<DT>(stage_w(s), w_ld, a, m0, kc * kTileK, kTileK, a.w_vec);
  };

  const int nk = a.k_pad / kTileK;
  const int n_tiles = (a.e + kTileE - 1) / kTileE;
  for (int te = blockIdx.x; te < n_tiles; te += gridDim.x) {
    tile.index = te;
    __syncthreads();  // the previous tile is done with ids and ring
    if (tid < kTileE) {
      const int ei = te * kTileE + tid;
      int sv = 0, tv = 0, dst = -1;
      if (ei < a.e) {
        sv = a.src[ei];
        tv = a.tgt[ei];
        dst = (tv >= 0 && tv < a.n_tgt) ? tv : -1;
      }
      src_s[tid] = min(max(sv, 0), a.n_src - 1);
      tgt_s[tid] = min(max(tv, 0), a.n_tgt - 1);
      dst_s[tid] = dst;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_chunk(s);
      cp_async_commit();
    }
    float acc[F::kRows][F::kCols];
#pragma unroll
    for (int i = 0; i < F::kRows; ++i)
#pragma unroll
      for (int j = 0; j < F::kCols; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<kStages - 2>();  // chunk kc (and W) has landed
      __syncthreads();               // ... for every thread; kc - 1 is read
      if (kc + kStages - 1 < nk) load_chunk(kc + kStages - 1);
      cp_async_commit();
      const int s = kc % kStages;
      const T* wk;
      if constexpr (WSTREAM)
        wk = stage_w(s);
      else
        wk = DT == kFloat32 ? w_res + kc * kTileK * w_ld
                            : w_res + kc * kTileK;
      chunk_product<DT, ROWS>(acc, stage_x(s), wk, w_ld, wrow, wcol,
                              n_active);
    }
    epilogue(acc, tile);
  }
  cp_async_wait<0>();  // nothing in flight at exit
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The launch of one call, or false when the shape cannot launch.
struct Plan {
  EdgeArgs args;
  Layout layout;
  int dtype, rows;  // tiles of 16 x rows edges
  bool vec, stream;
  dim3 grid;
};

inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

// Tile height in 16-edge row groups for a tile of `tile` edges (0: the
// dtype's default), or 0 when no kernel of that height is built: fp32
// takes 32, 64 or 128 edges, 16-bit 64 (kernel.py's `tiles` says the
// same).
inline int tile_rows(int dtype, int tile) {
  if (tile == 0) return dtype == kFloat32 ? kFmaRows : kMmaRows;
  if (dtype != kFloat32) return tile == 16 * kMmaRows ? kMmaRows : 0;
  return tile == 32 || tile == 64 || tile == 128 ? tile / 16 : 0;
}

// The plan's layout: W resident unless it does not fit.
inline Layout plan_layout(int dtype, int rows, int k_pad, bool* stream) {
  *stream = layout(dtype, rows, k_pad, false).total > kMaxSmem;
  return layout(dtype, rows, k_pad, *stream);
}

// The launch of one call with tiles of 16 x `rows` edges.
inline bool plan(const void* h_src, const void* h_tgt, const int* src,
                 const int* tgt, const void* w, const void* b, float* acc,
                 float* carry, int e, int n_src, int n_tgt, int ds, int dt,
                 int m, int dtype, int act, int rows, Plan* p) {
  const int m_tiles = (m + kTileM - 1) / kTileM;
  if (m <= 0 || m_tiles > 65535 || (e > 0 && n_src <= 0) ||
      ds + static_cast<int64_t>(dt) > 2147483647 - kTileK)
    return false;
  const int k_pad = k_padded(ds + dt);
  const bool f32 = dtype == kFloat32;
  const int vec = f32 ? 4 : 8;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p->vec = ds % vec == 0 && dt % vec == 0 && aligned(h_src) &&
           aligned(h_tgt);
  p->dtype = dtype;
  p->rows = rows;
  p->layout = plan_layout(dtype, p->rows, k_pad, &p->stream);
  const int64_t n_tiles =
      (static_cast<int64_t>(e) + 16 * rows - 1) / (16 * rows);
  p->args = EdgeArgs{h_src, h_tgt, src, tgt, w, b, acc,
                     reinterpret_cast<int4*>(carry),
                     carry == nullptr ? nullptr : carry + 4 * n_tiles,
                     e, n_src, n_tgt, ds, dt, m, act, k_pad,
                     f32 && m % 4 == 0 && aligned(w)};
  // up to 2 CTAs per SM where shared memory allows (__launch_bounds__
  // keeps the registers for 2); past that many CTAs the grid is persistent
  const int per_sm =
      static_cast<int>(kSmSmem / (p->layout.total + 1024)) >= 2 ? 2 : 1;
  const int64_t want = (static_cast<int64_t>(sm_count()) * per_sm +
                        m_tiles - 1) / m_tiles;
  p->grid = dim3(static_cast<unsigned int>(
                     n_tiles < want ? n_tiles : want), m_tiles);
  return true;
}

// Opt kernel `fn` in to `bytes` of dynamic shared memory above 48 KB;
// `allowed` is the caller's record of what it already has.
template <typename Fn>
inline cudaError_t allow_smem(Fn fn, int64_t bytes, int64_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

// Call `launch(dt, rows, vec, stream)` with compile-time constants for
// the plan's dtype, its tile height (a height of tile_rows), copy form
// and W mode.
template <typename Launch>
inline cudaError_t dispatch(const Plan& p, Launch launch) {
  auto by_vec = [&](auto dt, auto rows) {
    auto by_stream = [&](auto v) {
      if (p.stream)
        return launch(dt, rows, v, std::integral_constant<bool, true>{});
      return launch(dt, rows, v, std::integral_constant<bool, false>{});
    };
    if (p.vec) return by_stream(std::integral_constant<bool, true>{});
    return by_stream(std::integral_constant<bool, false>{});
  };
  using Mma = std::integral_constant<int, kMmaRows>;
  if (p.dtype == kBFloat16)
    return by_vec(std::integral_constant<int, kBFloat16>{}, Mma{});
  if (p.dtype == kFloat16)
    return by_vec(std::integral_constant<int, kFloat16>{}, Mma{});
  using F32 = std::integral_constant<int, kFloat32>;
  if (p.rows == 8) return by_vec(F32{}, std::integral_constant<int, 8>{});
  if (p.rows == 4) return by_vec(F32{}, std::integral_constant<int, 4>{});
  return by_vec(F32{}, std::integral_constant<int, kFmaRows>{});
}

// One call: memset of the fp32 accumulator, the edge kernel (skipped for
// e == 0), with a `carry` scratch (edge_mpnn_runs) the fold of its chains
// (carry.cuh; carry_pieces at least the call's edge tiles), and for a
// 16-bit output one cast; tiles of `tile` edges (tile_rows; 0 the
// dtype's default), cudaErrorInvalidValue with nothing launched for a
// height no kernel is built for.  `kernel_of(dt, rows, vec, stream)`
// names the kernel instantiation for the plan's dtype, tile height, copy
// form and W mode.  acc == out exactly when the output is fp32, so an
// fp32 edge_mpnn call is one memset and one kernel, an fp32
// edge_mpnn_runs call one memset and two kernels.
template <typename KernelOf>
inline int edge_call(const void* h_src, const void* h_tgt, const int* src,
                     const int* tgt, const void* w, const void* b,
                     float* acc, void* out, float* carry,
                     long long carry_pieces, int e, int n_src, int n_tgt,
                     int ds, int dt, int m, int dtype, int act, int tile,
                     void* stream, KernelOf kernel_of) {
  Plan p;
  const int rows = tile_rows(dtype, tile);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles =
      (static_cast<int64_t>(e) + 16 * rows - 1) / (16 * rows);
  if (!plan(h_src, h_tgt, src, tgt, w, b, acc, carry, e, n_src, n_tgt, ds,
            dt, m, dtype, act, rows, &p) ||
      (carry != nullptr && carry_pieces < n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_tgt) * m;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(acc, 0, n_out * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e > 0) {
    err = dispatch(p, [&](auto dt_, auto rows, auto vec, auto stream_) {
      auto kernel = kernel_of(dt_, rows, vec, stream_);
      static int64_t allowed = 48 * 1024;  // one record per instantiation
      cudaError_t e2 = allow_smem(kernel, p.layout.total, &allowed);
      if (e2 != cudaSuccess) return e2;
      kernel<<<p.grid, kThreads, p.layout.total, s>>>(p.args);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return static_cast<int>(err);
    if (carry != nullptr) {
      err = carry_fold(carry, acc, n_tiles, m, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (out != acc)
    cast_from_fp32_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
        acc, out, n_out, dtype);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace edge
}  // namespace repro_torch
