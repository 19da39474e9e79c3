// flash_attention for Hopper (sm_90a): online-softmax block attention
// over q [B, Sq, H, D] and k/v [B, Skv, K, D] (H = K * G; query head h
// reads kv head h / G), optionally causal and optionally restricted to
// matching q/kv segment ids (a block-diagonal mask: graph components).
//
// Replaces the Pallas TPU kernel `flash_attention` (_flash_kernel) in
// src/repro/kernels/flash_attention/kernel.py.  The TPU carries m, l and
// acc in VMEM scratch across a sequential kv grid axis; here one CTA owns
// one (batch, head, 64-row q tile) and walks the kv tiles in a loop,
// keeping m, l and acc in registers, so no state crosses CTAs and each
// output row is written by exactly one thread: no atomics, and repeated
// launches give bit-identical outputs.  The TPU wrapper copies each kv
// head G times (jnp.repeat); here the kv head is indexed as h / G.
//
// Arithmetic, as the TPU kernel does it: q is scaled by D^-0.5 in fp32
// before the product; logits, m, l and acc are fp32 (fp32 FMA on the CUDA
// cores: no TF32, no library GEMM; bf16/fp16 inputs are converted on
// load); a masked logit is -1e30 and its p is 0 (the guard is applied to
// every masked logit, so a query no key may reach keeps l = 0); the
// output is acc / max(l, 1e-30) cast to the input dtype, an exact 0 for
// such a query.  Ragged tails are masked against Sq and Skv, so no length
// needs to be a tile multiple.  A causal CTA stops at the last kv tile
// that reaches its q tile's diagonal (the tiles beyond are fully masked).
//
// Bound on this card: operations (4 D fp32 flops per (query, key) pair
// allowed by the mask) for every shape the port runs; the bytes (q, k, v
// and out once each) take a fraction of that.  Shared memory holds the
// scaled q tile, one K and one V tile and the P tile (up to 214 KB at
// D = 256, set by cudaFuncSetAttribute); each thread owns a 4 x 4 block
// of the 64 x 64 logit tile and 4 rows x D/16 columns of acc.  Left for
// a later PR: wgmma/TMA-fed tiles, and skipping kv tiles whose segment
// range misses the q tile's (every kv tile is visited today, so a
// segmented call does the whole padded square's work: 17 segments of a
// 4096-row node set cost about 17 times the bound's operations).
#include "cuda_common.cuh"

namespace {

using namespace repro_torch;

constexpr int kBlockQ = 64;   // q rows per CTA
constexpr int kBlockK = 64;   // kv rows per loop step
constexpr int kFlashThreads = 256;
constexpr float kMaskedLogit = -1e30f;  // the reference's NEG_INF

// shared-memory floats of one CTA at head width d (q and K rows padded to
// d + 1 so the threads of a warp read distinct banks)
__host__ __device__ inline int64_t smem_floats(int d) {
  return static_cast<int64_t>(kBlockQ) * (d + 1)      // q tile, scaled
         + static_cast<int64_t>(kBlockK) * (d + 1)    // K tile
         + static_cast<int64_t>(kBlockK) * d          // V tile
         + static_cast<int64_t>(kBlockQ) * (kBlockK + 1)  // P tile
         + kBlockK;                                   // kv segment ids
}

// Thread t owns rows rg + 16 i (i < 4) of the q tile, with rg = t / 16,
// logit columns cg + 16 j (j < 4) and acc columns cg + 16 j
// (j < kMaxD / 16), with cg = t % 16.  The 16 threads sharing a row
// group are one half-warp, so row reductions are xor shuffles within it.
template <int kMaxD>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const void* q, const void* k, const void* v, const int* q_seg,
             const int* kv_seg, void* out, int sq, int skv, int h, int kh,
             int d, int n_q_tiles, float scale, int causal, int dtype) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;
  float* ks = qs + kBlockQ * dp;
  float* vs = ks + kBlockK * dp;
  float* ps = vs + kBlockK * d;
  int* kseg_s = reinterpret_cast<int*>(ps + kBlockQ * (kBlockK + 1));

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int q_tile = blockIdx.x % n_q_tiles;
  const int bh = blockIdx.x / n_q_tiles;
  const int b = bh / h, head = bh % h;
  const int kv_head = head / (h / kh);
  const int q0 = q_tile * kBlockQ;
  const bool segmented = q_seg != nullptr;

  // q tile -> shared memory, scaled in fp32 (rows past Sq read as 0)
  for (int e = tid; e < kBlockQ * d; e += kFlashThreads) {
    const int r = e / d, c = e - r * d;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < sq)
      x = load_as_float(
          q, ((static_cast<int64_t>(b) * sq + qi) * h + head) * d + c,
          dtype) * scale;
    qs[r * dp + c] = x;
  }
  int my_seg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    my_seg[i] = (segmented && qi < sq)
                    ? q_seg[static_cast<int64_t>(b) * sq + qi] : 0;
  }

  constexpr int kAccCols = kMaxD / 16;
  float acc[4][kAccCols];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMaskedLogit;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) acc[i][j] = 0.f;
  }

  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + kBlockQ);  // keys past the diagonal
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous step is done with ks, vs and ps
    for (int e = tid; e < kBlockK * d; e += kFlashThreads) {
      const int r = e / d, c = e - r * d;
      const int kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < skv) {
        const int64_t off =
            ((static_cast<int64_t>(b) * skv + kj) * kh + kv_head) * d + c;
        kx = load_as_float(k, off, dtype);
        vx = load_as_float(v, off, dtype);
      }
      ks[r * dp + c] = kx;
      vs[r * d + c] = vx;
    }
    if (segmented && tid < kBlockK) {
      const int kj = k0 + tid;
      kseg_s[tid] = kj < skv ? kv_seg[static_cast<int64_t>(b) * skv + kj]
                             : 0;
    }
    __syncthreads();

    // logits of this thread's 4 x 4 block
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < d; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(rg + 16 * i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(cg + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }

    // masks, then the online-softmax update of each of the 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg + 16 * i;
      bool ok[4];
      float row_max = kMaskedLogit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const int kj = k0 + c;
        ok[j] = kj < skv && (!causal || kj <= qi) &&
                (!segmented || kseg_s[c] == my_seg[i]);
        if (!ok[j]) s[i][j] = kMaskedLogit;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_run[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(rg + 16 * i) * (kBlockK + 1) + cg + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + row_sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P @ V over this kv tile
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(rg + 16 * i) * (kBlockK + 1) + c];
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) {
        const int col = cg + 16 * j;
        const float vb = col < d ? vs[c * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    const int64_t row = ((static_cast<int64_t>(b) * sq + qi) * h + head) * d;
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) {
      const int col = cg + 16 * j;
      if (col < d) store_from_float(out, row + col, acc[i][j] / l, dtype);
    }
  }
}

template <int kMaxD>
int launch(const void* q, const void* k, const void* v, const int* q_seg,
           const int* kv_seg, void* out, int b, int sq, int skv, int h,
           int kh, int d, float scale, int causal, int dtype,
           cudaStream_t stream) {
  const int smem = static_cast<int>(smem_floats(d) * sizeof(float));
  // above 48 KB only after opting in; once per instantiation, for its
  // widest head
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const int most = static_cast<int>(smem_floats(kMaxD) * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<kMaxD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = most;
  }
  const int n_q_tiles = (sq + kBlockQ - 1) / kBlockQ;
  const int64_t blocks = static_cast<int64_t>(n_q_tiles) * b * h;
  flash_kernel<kMaxD><<<static_cast<unsigned int>(blocks), kFlashThreads,
                        smem, stream>>>(q, k, v, q_seg, kv_seg, out, sq, skv,
                                        h, kh, d, n_q_tiles, scale, causal,
                                        dtype);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, sq, h, d], k/v [b, skv, kh, d] (dtype code), q_seg [b, sq] and
// kv_seg [b, skv] int32 or both null, out [b, sq, h, d] (dtype code).
// h % kh == 0, 1 <= d <= 256, b * h * ceil(sq / 64) < 2^31 (the wrapper
// checks).  Launches on `stream`; returns the cudaError_t of the launch
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* q_seg,
                                      const int* kv_seg, void* out, int b,
                                      int sq, int skv, int h, int kh, int d,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(b) * sq * h == 0)
    return static_cast<int>(cudaGetLastError());
  if (d <= 32)
    return launch<32>(q, k, v, q_seg, kv_seg, out, b, sq, skv, h, kh, d,
                      scale, causal, dtype, s);
  if (d <= 64)
    return launch<64>(q, k, v, q_seg, kv_seg, out, b, sq, skv, h, kh, d,
                      scale, causal, dtype, s);
  if (d <= 128)
    return launch<128>(q, k, v, q_seg, kv_seg, out, b, sq, skv, h, kh, d,
                       scale, causal, dtype, s);
  return launch<256>(q, k, v, q_seg, kv_seg, out, b, sq, skv, h, kh, d,
                     scale, causal, dtype, s);
}
