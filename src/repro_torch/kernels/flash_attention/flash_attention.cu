// flash_attention for Hopper (sm_90a): online-softmax block attention
// over q [B, Sq, H, D] and k/v [B, Skv, K, D] (H = K * G; query head h
// reads kv head h / G), optionally causal and optionally restricted to
// matching q/kv segment ids (a block-diagonal mask: graph components).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (entry `flash_attention`)
// in src/repro/kernels/flash_attention/kernel.py.  The TPU carries m, l
// and acc in VMEM scratch across a sequential kv grid axis and visits
// every kv block; here one CTA owns one (batch, head, q tile) and walks
// only the kv tiles its mask can reach, keeping m, l and acc in
// registers, so no state crosses CTAs and each output element is written
// by one thread: no atomics, and repeated launches give bit-identical
// outputs.  The TPU wrapper copies each kv head G times (jnp.repeat);
// here the kv head is indexed as h / G.
//
// Arithmetic, as the TPU kernel does it: m, l and acc are fp32 in online
// softmax; a masked logit is -1e30 and its p is exactly 0, so a query no
// key may reach keeps l = 0; the output is acc / max(l, 1e-30) in the
// input dtype, an exact 0 for such a query.  fp32 inputs: q is scaled by
// D^-0.5 in fp32, and both products run as 3xTF32 on the tensor cores
// (flash_mma.cuh: each operand split into TF32 hi + lo in registers as
// its fragment loads, three `mma.sync m16n8k8` per k step; P is split the
// same way), exp by expf.  bf16/fp16 inputs: QK^T on `mma.sync m16n8k16`
// from the inputs as they are, scaled in fp32 afterwards; P is rounded to
// the input's 16-bit type for PV (V read by `ldmatrix.trans`); exp by the
// MUFU's ex2.approx.
//
// The design:
//   * skipping: a CTA takes the [min, max] of its q tile's valid segment
//     ids, and for each kv tile the [min, max] of that tile's valid ids
//     (the CTA reduces them itself, one thread per tile, in passes of
//     kChunk tiles); a kv tile whose range misses the q tile's is not
//     visited.  That is exact for any id order (a skipped tile has no
//     allowed pair, and an all-masked tile leaves m, l and acc as they
//     are) and tight for sorted ids, which every port path passes.  A
//     causal CTA stops at its diagonal tile.  Only tiles that straddle
//     the diagonal, Skv or a segment edge apply the element mask;
//     kernel.py `tile_plan` mirrors the rule in plain Python;
//   * the CTA: 4 warps as row groups x kv splits.  Each row group owns 16
//     q rows; its splits deal the visited kv tiles round-robin, each
//     keeps its own m, l and acc, and they merge in a fixed order at the
//     end (in shared memory, so still no atomics).  `launch` takes 4 row
//     groups when the grid still gives every SM two CTAs, as at (b) and
//     (c); a small grid such as (a)'s takes fewer rows and more splits,
//     so the card still gets warps and a long q row's kv tiles are walked
//     in parallel.  kBlockK = 32 kv
//     rows a tile; q, K and V tiles in shared memory padded to the
//     instantiation's width (32, 64, 128 or 256) with zeros, rows padded
//     so fragment loads are free of bank conflicts;
//   * in flight: K/V tiles move by 16-byte `cp.async` (zero-fill past Skv
//     and past D), with their kv ids when segmented, into a ring of 2
//     stages, so the next step's tiles load while one step's multiply;
//     rows that are not 16-byte aligned take a scalar copy of the same
//     ring;
//   * a causal grid launches its longest q tiles first.
//
// Bound on this card: the operations of the pairs it visits.  For the
// causal prefill (no tile can be skipped) that is 4 D flops per allowed
// pair on the tensor cores (3xTF32: 3 x at 495 TFLOP/s for fp32; 989
// TFLOP/s for 16-bit); for segmented calls the visited pairs exceed the
// allowed ones by the tiles' overhang past each segment edge.  Measured
// (PERF.md §6), fp32 is held back by instruction throughput: the operand
// splits, which each warp repeats for the K and V fragments it shares
// with the others, outnumber the mma instructions several times.
#include <limits.h>

#include <type_traits>

#include "cuda_common.cuh"
#include "flash_attention/flash_mma.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::flash;

constexpr int kBlockK = 32;    // kv rows per tile (kernel.py BLOCK_K)
constexpr int kStages = 2;     // K/V ring depth
constexpr int kMaxWarps = 4;   // warps a CTA, at most
constexpr int kChunk = 128;    // kv tiles ranged per pass (kernel.py CHUNK)
constexpr float kMaskedLogit = -1e30f;  // the reference's NEG_INF
// control block (4-byte words): tile codes and visit list [kChunk] each,
// the kv ids of each ring slot [kStages * kMaxWarps][kBlockK], per-warp
// min/max of the q ids, the visit count, and each warp's m and l of its
// 16 rows for the merge; 128-byte aligned
constexpr int kCtlBytes =
    (4 * (2 * kChunk + kStages * kMaxWarps * kBlockK + 2 * kMaxWarps + 1 +
          2 * kMaxWarps * 16) + 127) / 128 * 128;

// shared-memory element of a dtype (16-bit values stay raw bits: the mma
// reads them as they are), its row padding and 16-byte vector
template <int DT>
struct Elem {
  using T = uint16_t;
  static constexpr int kPad = 8;
  static constexpr int kVec = 8;
};
template <>
struct Elem<kFloat32> {
  using T = float;
  static constexpr int kPad = 4;
  static constexpr int kVec = 4;
};

template <int DT, int kMaxD>
struct Shape {
  using T = typename Elem<DT>::T;
  static constexpr int kLd = kMaxD + Elem<DT>::kPad;  // row stride
  static constexpr int kTile = kBlockK * kLd;         // one K or V tile
  static_assert(kLd * sizeof(T) % 16 == 0, "16-byte rows");
  // bytes of dynamic shared memory for a q tile of 16 x `rows` rows and
  // `splits` kv tiles a ring stage; the merge's partials [warps][16]
  // [kMaxD] fp32 reuse the ring, which holds them for rows * splits <=
  // kMaxWarps
  static constexpr int bytes(int rows, int splits) {
    return kCtlBytes + static_cast<int>(
        (16 * rows * kLd + kStages * splits * 2 * kTile) * sizeof(T));
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;
  const int* kv_seg;
  void* out;
  int b, sq, skv, h, kh, d, n_q_tiles;
  float scale;
  int causal, vec;
  int splits;  // warps that split the visited kv tiles of one q row group
};

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-bit tiles up to width 128 are held to 128 registers, four CTAs an
// SM (a few bytes of spills cost less than the fourth CTA)
template <int DT, int kMaxD>
__global__ void __launch_bounds__(32 * kMaxWarps,
                                  DT != kFloat32 && kMaxD <= 128 ? 4 : 1)
flash_kernel(const Args a) {
  using S = Shape<DT, kMaxD>;
  using T = typename S::T;
  constexpr int kLd = S::kLd;
  constexpr int kN = kBlockK / 8;  // logit n8 tiles of a warp
  constexpr int kDN = kMaxD / 8;   // output n8 tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  int* codes = reinterpret_cast<int*>(smem);
  int* list = codes + kChunk;
  int* red = list + kChunk;
  int* n_vis_s = red + 2 * kMaxWarps;
  int* kv_ids = n_vis_s + 1;  // [kStages * kMaxWarps][kBlockK]
  float* part_m = reinterpret_cast<float*>(kv_ids +
                                           kStages * kMaxWarps * kBlockK);
  float* part_l = part_m + kMaxWarps * 16;
  T* qs = reinterpret_cast<T*>(smem + kCtlBytes);
  // warp = wr * splits + wc: q rows 16 wr .. 16 wr + 15 of the tile, and
  // the visited kv tiles wc, wc + splits, ... of each pass
  const int warps = blockDim.x / 32, splits = a.splits;
  const int bq = 16 * (warps / splits);
  T* ring = qs + bq * kLd;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / splits, wc = warp - wr * splits;
  const int g = lane >> 2, t = lane & 3;
  const int bh_count = a.b * a.h;
  const int rank = blockIdx.x / bh_count;
  const int bh = blockIdx.x - rank * bh_count;
  // causal: the longest q tiles (the last ones) launch first
  const int q_tile = a.causal ? a.n_q_tiles - 1 - rank : rank;
  const int bi = bh / a.h, head = bh - bi * a.h;
  const int kv_head = head / (a.h / a.kh);
  const int q0 = q_tile * bq;
  const bool seg = a.q_seg != nullptr;
  const int* qseg = seg ? a.q_seg + static_cast<int64_t>(bi) * a.sq
                        : nullptr;
  const int* kseg = seg ? a.kv_seg + static_cast<int64_t>(bi) * a.skv
                        : nullptr;

  // q tile -> shared memory, zero past Sq and D (fp32 scaled here)
  const int64_t q_row = static_cast<int64_t>(a.h) * a.d;
  for (int e = tid; e < bq * kMaxD; e += blockDim.x) {
    const int r = e / kMaxD, c = e % kMaxD;
    const int qi = q0 + r;
    T x = 0;
    if (qi < a.sq && c < a.d) {
      const int64_t off = (static_cast<int64_t>(bi) * a.sq + qi) * q_row +
                          static_cast<int64_t>(head) * a.d + c;
      if constexpr (DT == kFloat32)
        x = static_cast<const float*>(a.q)[off] * a.scale;
      else
        x = static_cast<const uint16_t*>(a.q)[off];
    }
    qs[r * kLd + c] = x;
  }

  // [min, max] of the q tile's valid segment ids
  int qmin = INT_MAX, qmax = INT_MIN;
  if (seg) {
    for (int r = tid; r < bq; r += blockDim.x) {
      if (q0 + r < a.sq) {
        const int id = qseg[q0 + r];
        qmin = min(qmin, id);
        qmax = max(qmax, id);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    }
    if (lane == 0) {
      red[warp] = qmin;
      red[kMaxWarps + warp] = qmax;
    }
  }
  __syncthreads();  // q tile and the per-warp ranges are in
  if (seg) {
    for (int w = 0; w < warps; ++w) {
      qmin = min(qmin, red[w]);
      qmax = max(qmax, red[kMaxWarps + w]);
    }
  }

  // this thread's rows of the tile: g and g + 8 of its warp's 16
  const int row_lo = q0 + 16 * wr + g, row_hi = row_lo + 8;
  int seg_lo = 0, seg_hi = 0;
  if (seg) {
    seg_lo = row_lo < a.sq ? qseg[row_lo] : INT_MIN;
    seg_hi = row_hi < a.sq ? qseg[row_hi] : INT_MIN;
  }

  float acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m_lo = kMaskedLogit, m_hi = kMaskedLogit, l_lo = 0.f, l_hi = 0.f;

  const int64_t kv_row = static_cast<int64_t>(a.kh) * a.d;
  const int64_t kv_base = static_cast<int64_t>(bi) * a.skv * kv_row +
                          static_cast<int64_t>(kv_head) * a.d;
  const T* kg = static_cast<const T*>(a.k) + kv_base;
  const T* vg = static_cast<const T*>(a.v) + kv_base;

  // K and V rows [k0, k0 + kBlockK) -> ring slot `slot` (stage * splits
  // + split), zero past Skv and D; with segments also their kv ids
  auto load_tile = [&](int tile, int slot) {
    T* ks = ring + slot * 2 * S::kTile;
    T* vs = ks + S::kTile;
    const int k0 = tile * kBlockK;
    if (seg && tid < kBlockK) {
      const bool ok = k0 + tid < a.skv;
      cp_async4(kv_ids + slot * kBlockK + tid, kseg + (ok ? k0 + tid : 0),
                ok);
    }
    if (a.vec) {
      constexpr int kV = Elem<DT>::kVec, kC = kMaxD / kV;
      for (int e = tid; e < 2 * kBlockK * kC; e += blockDim.x) {
        const int which = e / (kBlockK * kC);
        const int rem = e - which * kBlockK * kC;
        const int r = rem / kC, c = (rem % kC) * kV;
        const bool ok = k0 + r < a.skv && c < a.d;
        const T* src = (which ? vg : kg) +
                       (ok ? static_cast<int64_t>(k0 + r) * kv_row + c : 0);
        cp_async16((which ? vs : ks) + r * kLd + c, src, ok);
      }
    } else {
      for (int e = tid; e < kBlockK * kMaxD; e += blockDim.x) {
        const int r = e / kMaxD, c = e % kMaxD;
        T kx = 0, vx = 0;
        if (k0 + r < a.skv && c < a.d) {
          const int64_t off = static_cast<int64_t>(k0 + r) * kv_row + c;
          kx = kg[off];
          vx = vg[off];
        }
        ks[r * kLd + c] = kx;
        vs[r * kLd + c] = vx;
      }
    }
  };

  // one visited kv tile: logits, masks, online softmax, acc += P V; the
  // element mask is compiled in only where the tile needs it
  auto step = [&](int tile, auto masked_tile, int slot) {
    constexpr bool masked = decltype(masked_tile)::value;
    const T* ks = ring + slot * 2 * S::kTile;
    const T* vs = ks + S::kTile;
    const int* ids = kv_ids + slot * kBlockK;
    const T* qw = qs + 16 * wr * kLd;
    const int k0 = tile * kBlockK;
    float s[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    // the whole padded width, straight-line: its zero columns add
    // nothing, and no branch splits the product
    if constexpr (DT == kFloat32) {
#pragma unroll
      for (int kk = 0; kk < kMaxD / 8; ++kk) {
        const int c = kk * 8 + t;
        uint32_t ah[4], al[4];
        split_tf32(qw[g * kLd + c], ah[0], al[0]);
        split_tf32(qw[(g + 8) * kLd + c], ah[1], al[1]);
        split_tf32(qw[g * kLd + c + 4], ah[2], al[2]);
        split_tf32(qw[(g + 8) * kLd + c + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(ks[(j * 8 + g) * kLd + c], bh[0], bl[0]);
          split_tf32(ks[(j * 8 + g) * kLd + c + 4], bh[1], bl[1]);
          mma_3xtf32(s[j], ah, al, bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        const uint32_t af[4] = {ld_u32(qw + g * kLd + c),
                                ld_u32(qw + (g + 8) * kLd + c),
                                ld_u32(qw + g * kLd + c + 8),
                                ld_u32(qw + (g + 8) * kLd + c + 8)};
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const T* kr = ks + (j * 8 + g) * kLd + c;
          mma_16bit<DT>(s[j][0], s[j][1], s[j][2], s[j][3], af, ld_u32(kr),
                        ld_u32(kr + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= a.scale;
      }
    }

    if constexpr (masked) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1), col = k0 + c;
          const int row = e < 2 ? row_lo : row_hi;
          const bool ok = col < a.skv && (!a.causal || col <= row) &&
                          (!seg || ids[c] == (e < 2 ? seg_lo : seg_hi));
          if (!ok) s[j][e] = kMaskedLogit;
        }
      }
    }

    // online softmax of rows g (lo) and g + 8 (hi); each row's 32 logits
    // lie in the 4 lanes of one quad
    float mx_lo = kMaskedLogit, mx_hi = kMaskedLogit;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_lo : mn_hi;
        const float p = masked && s[j][e] == kMaskedLogit
                            ? 0.f
                            : exp_of<DT>(s[j][e] - mn);
        s[j][e] = p;
        if (e < 2)
          sum_lo += p;
        else
          sum_hi += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    const float al_lo = exp_of<DT>(m_lo - mn_lo);
    const float al_hi = exp_of<DT>(m_hi - mn_hi);
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      acc[n][0] *= al_lo;
      acc[n][1] *= al_lo;
      acc[n][2] *= al_hi;
      acc[n][3] *= al_hi;
    }

    // acc += P V over the tile's 32 kv rows
    if constexpr (DT == kFloat32) {
      // k step j covers kv rows 8j .. 8j + 7, its k index t standing for
      // kv row 8j + 2t and t + 4 for 8j + 2t + 1, so that P's fragment is
      // the logits' accumulator as it lies
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const T* v0 = vs + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < kDN; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(v0[n * 8], bh[0], bl[0]);
          split_tf32(v0[kLd + n * 8], bh[1], bl[1]);
          mma_3xtf32(acc[n], ph, pl, bh, bl);
        }
      }
    } else {
      const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int kb = 0; kb < kBlockK / 16; ++kb) {
        const uint32_t pa[4] = {
            pack_16bit<DT>(s[2 * kb][0], s[2 * kb][1]),
            pack_16bit<DT>(s[2 * kb][2], s[2 * kb][3]),
            pack_16bit<DT>(s[2 * kb + 1][0], s[2 * kb + 1][1]),
            pack_16bit<DT>(s[2 * kb + 1][2], s[2 * kb + 1][3])};
        const T* vrow = vs + (kb * 16 + (mat & 1) * 8 + r8) * kLd +
                        (mat >> 1) * 8;
#pragma unroll
        for (int n = 0; n < kDN; n += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + n * 8);
          mma_16bit<DT>(acc[n][0], acc[n][1], acc[n][2], acc[n][3], pa,
                        vb[0], vb[1]);
          mma_16bit<DT>(acc[n + 1][0], acc[n + 1][1], acc[n + 1][2],
                        acc[n + 1][3], pa, vb[2], vb[3]);
        }
      }
    }
  };

  const int kv_end = a.causal ? min(a.skv, q0 + bq) : a.skv;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int base = 0; base < n_tiles; base += kChunk) {
    // code of each kv tile of this pass: 2 * tile + masked, or -1 when
    // the tile is skipped
    for (int i = tid; i < kChunk; i += blockDim.x) {
      const int tile = base + i;
      int code = -1;
      if (tile < n_tiles) {
        const int k0 = tile * kBlockK, kend = min(k0 + kBlockK, a.skv);
        bool masked = kend - k0 < kBlockK || (a.causal && kend - 1 > q0);
        bool visit = true;
        if (seg) {
          int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll 8
          for (int j = 0; j < kBlockK; ++j) {
            if (k0 + j < kend) {
              const int id = __ldg(kseg + k0 + j);
              kmin = min(kmin, id);
              kmax = max(kmax, id);
            }
          }
          visit = kmax >= qmin && kmin <= qmax;
          masked = masked || kmin != kmax || qmin != qmax || kmin != qmin;
        }
        if (visit) code = 2 * tile + (masked ? 1 : 0);
      }
      codes[i] = code;
    }
    __syncthreads();
    if (warp == 0) {  // compact the visited tiles, in order
      int n = 0;
      for (int i0 = 0; i0 < kChunk; i0 += 32) {
        const int c = codes[i0 + lane];
        const unsigned int ballot = __ballot_sync(0xffffffffu, c >= 0);
        if (c >= 0) list[n + __popc(ballot & ((1u << lane) - 1u))] = c;
        n += __popc(ballot);
      }
      if (lane == 0) *n_vis_s = n;
    }
    __syncthreads();
    // the ring: step i takes the visited tiles i * splits .. + splits - 1
    // (split wc multiplies the wc-th), and the next step's tiles load
    // while they multiply
    const int n_vis = *n_vis_s;
    const int n_steps = (n_vis + splits - 1) / splits;
    auto load_step = [&](int i) {
      for (int sp = 0; sp < splits; ++sp) {
        const int at = i * splits + sp;
        if (at < n_vis) load_tile(list[at] >> 1, (i % kStages) * splits + sp);
      }
      cp_async_commit();
    };
    if (n_steps > 0) load_step(0);
    for (int i = 0; i < n_steps; ++i) {
      if (i + 1 < n_steps) {
        load_step(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // step i's tiles are in for every thread
      const int at = i * splits + wc;
      if (at < n_vis) {
        const int slot = (i % kStages) * splits + wc;
        if (list[at] & 1)
          step(list[at] >> 1, std::true_type{}, slot);
        else
          step(list[at] >> 1, std::false_type{}, slot);
      }
      __syncthreads();  // stage i % kStages is free for step i + kStages
    }
  }

  const int rows[2] = {row_lo, row_hi};
  auto store = [&](int row, int col, float value) {
    if (row < a.sq && col < a.d)
      store_from_float(
          a.out,
          ((static_cast<int64_t>(bi) * a.sq + row) * a.h + head) * a.d + col,
          value, DT);
  };
  if (splits == 1) {
    const float l_div[2] = {fmaxf(l_lo, 1e-30f), fmaxf(l_hi, 1e-30f)};
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      if (n * 8 >= a.d) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(rows[e >> 1], n * 8 + 2 * t + (e & 1),
              acc[n][e] / l_div[e >> 1]);
    }
    return;
  }

  // merge the splits of each row group, in split order: m = max m_s,
  // l = sum l_s w_s, out = sum acc_s w_s / max(l, 1e-30), w_s =
  // exp(m_s - m); warp wc writes the output n8 tiles n = wc (mod splits)
  __syncthreads();  // every warp is done with the ring
  float* part = reinterpret_cast<float*>(ring);  // [warps][16][kMaxD]
  if (t == 0) {
    part_m[warp * 16 + g] = m_lo;
    part_m[warp * 16 + g + 8] = m_hi;
    part_l[warp * 16 + g] = l_lo;
    part_l[warp * 16 + g + 8] = l_hi;
  }
#pragma unroll
  for (int n = 0; n < kDN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(warp * 16 + g + 8 * (e >> 1)) * kMaxD + n * 8 + 2 * t + (e & 1)] =
          acc[n][e];
  }
  __syncthreads();
  float w[2][kMaxWarps], l_div[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r16 = g + 8 * half;
    float m = kMaskedLogit, l = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxWarps; ++sp)
      if (sp < splits) m = fmaxf(m, part_m[(wr * splits + sp) * 16 + r16]);
#pragma unroll
    for (int sp = 0; sp < kMaxWarps; ++sp) {
      w[half][sp] = 0.f;
      if (sp < splits) {
        const int at = (wr * splits + sp) * 16 + r16;
        w[half][sp] = exp_of<DT>(part_m[at] - m);
        l += part_l[at] * w[half][sp];
      }
    }
    l_div[half] = fmaxf(l, 1e-30f);
  }
  for (int n = wc; n < kDN && n * 8 < a.d; n += splits) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1, col = n * 8 + 2 * t + (e & 1);
      float v = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxWarps; ++sp)
        if (sp < splits)
          v += part[((wr * splits + sp) * 16 + g + 8 * half) * kMaxD + col] *
               w[half][sp];
      store(rows[half], col, v / l_div[half]);
    }
  }
}

// The CTA for this call and its launch.  rows: the most row groups (4,
// 2, then 1) whose grid of b * h * ceil(sq / (16 rows)) CTAs still gives
// every one of `sms` SMs two CTAs; splits takes the rest of the 4 warps,
// halved while the CTA's shared memory exceeds a block's.  So a small
// grid still fills the card with warps, and its longest q rows walk their
// kv tiles in parallel.  Writes (rows, splits) to cta[0..1] if cta is not
// null.
template <int DT, int kMaxD>
int launch(Args a, int sms, int* cta, cudaStream_t stream) {
  using S = Shape<DT, kMaxD>;
  const int64_t bh = static_cast<int64_t>(a.b) * a.h;
  const auto q_tiles = [&](int rows) {
    return (a.sq + 16 * rows - 1) / (16 * rows);
  };
  int rows = 1;
  for (int r = kMaxWarps; r > 1; r /= 2) {
    if (bh * q_tiles(r) >= 2 * static_cast<int64_t>(sms)) {
      rows = r;
      break;
    }
  }
  int splits = kMaxWarps / rows;
  while (splits > 1 && S::bytes(rows, splits) > edge::kMaxSmem) splits /= 2;
  const int smem = S::bytes(rows, splits);
  a.n_q_tiles = q_tiles(rows);
  a.splits = splits;
  const int64_t blocks = bh * a.n_q_tiles;
  if (smem > edge::kMaxSmem || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB only after opting in, once per instantiation and size
  static int64_t allowed = 48 * 1024;
  cudaError_t err = edge::allow_smem(flash_kernel<DT, kMaxD>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cta != nullptr) {
    cta[0] = rows;
    cta[1] = splits;
  }
  flash_kernel<DT, kMaxD><<<static_cast<unsigned int>(blocks),
                            32 * rows * splits, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int by_width(const Args& a, int sms, int* cta, cudaStream_t stream) {
  if (a.d <= 32) return launch<DT, 32>(a, sms, cta, stream);
  if (a.d <= 64) return launch<DT, 64>(a, sms, cta, stream);
  if (a.d <= 128) return launch<DT, 128>(a, sms, cta, stream);
  return launch<DT, 256>(a, sms, cta, stream);
}

}  // namespace

// q [b, sq, h, d], k/v [b, skv, kh, d] (dtype code), q_seg [b, sq] and
// kv_seg [b, skv] int32 or both null, out [b, sq, h, d] (dtype code);
// h % kh == 0, 1 <= d <= 256 (the wrapper checks).  The CTA's row groups
// and kv splits are chosen here (`launch`) for the current device's SM
// count and written to cta[0..1] when cta is not null.  Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* q_seg,
                                      const int* kv_seg, void* out, int b,
                                      int sq, int skv, int h, int kh, int d,
                                      float scale, int causal, int dtype,
                                      int* cta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(b) * sq * h == 0)
    return static_cast<int>(cudaGetLastError());
  if (d < 1 || d > 256 || kh < 1 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_elems = dtype == kFloat32 ? 4 : 8;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Args a{q, k, v, q_seg, kv_seg, out, b, sq, skv, h, kh, d, 0, scale,
         causal, d % vec_elems == 0 && aligned(k) && aligned(v), 1};
  if (dtype == kFloat32) return by_width<kFloat32>(a, sms, cta, s);
  if (dtype == kBFloat16) return by_width<kBFloat16>(a, sms, cta, s);
  if (dtype == kFloat16) return by_width<kFloat16>(a, sms, cta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
