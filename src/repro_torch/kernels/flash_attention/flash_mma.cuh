// Tensor-core helpers of flash_attention.cu for Hopper (sm_90a): the
// 3xTF32 form of an fp32 product and the transposing shared-memory load
// of 16-bit V tiles.  cp.async and the 16-bit mma come from
// edge_mpnn/edge_mma.cuh.
//
// 3xTF32.  An fp32 value x is split into two TF32 values: hi, x rounded
// to nearest with ties away from zero (fp32 with its low 13 mantissa
// bits rounded away), and lo, x - hi rounded toward zero.  A product
// a * b is then a_lo b_hi + a_hi b_lo + a_hi b_hi on `mma.sync
// m16n8k8.tf32` into fp32 accumulators, in that order; the dropped
// a_lo b_lo and lo's rounding are each near 2^-21 of |a b| or below, so
// the result keeps about fp32 accuracy at three tensor-core products per
// k step.
#pragma once

#include <stdint.h>

#include "edge_mpnn/edge_mma.cuh"

namespace repro_torch {
namespace flash {

using edge::cp_async16;
using edge::cp_async_commit;
using edge::cp_async_wait;
using edge::mma_16bit;
using edge::smem_u32;

// 4 bytes global -> shared, or 4 zero bytes when !valid (`src` must
// still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// x = hi + lo.  hi is x rounded to TF32 on its bits, to nearest with ties
// away from zero; lo = x - hi is exact in fp32 and goes to the mma as it
// is: the tensor core reads a .tf32 operand's top 19 bits, so lo is
// rounded toward zero there.  Three operations, where cvt.rna.tf32.f32
// alone expands to several on sm_90 (it also handles NaN and infinity,
// which attention inputs do not hold).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (4 fp32 accumulators of mma.m16n8) += a (16 x 8) * b (8 x 8), TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: a_lo b_hi, a_hi b_lo, then a_hi b_hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// Four 8 x 8 16-bit matrices from shared memory, transposed: lane l
// gives the address of row l % 8 of matrix l / 8; r[i] holds, for lane
// (g = lane / 4, t = lane % 4), elements [2t][g] and [2t + 1][g] of
// matrix i (the B fragment of mma.m16n8k16 from a row-major [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// e^x: fp32 inputs take expf (about 1 ulp, inside the 1e-5 rule);
// 16-bit inputs, held to 2e-2, take the MUFU's ex2.approx (relative
// error near 2^-22, plus the rounding of x log2 e)
template <int DT>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (DT == kFloat32) {
    return expf(x);
  } else {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y)
        : "f"(x * 1.4426950408889634f));
    return y;
  }
}

// Two fp32 values as one register of two 16-bit values (`lo` in the low
// half), rounded to nearest even
template <int DT>
__device__ __forceinline__ uint32_t pack_16bit(float lo, float hi) {
  uint32_t r;
  if constexpr (DT == kBFloat16) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

}  // namespace flash
}  // namespace repro_torch
