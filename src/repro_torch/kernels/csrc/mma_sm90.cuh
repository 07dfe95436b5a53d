// Warp-level building blocks shared by the port's tensor-core kernels
// (bitplane_matmul.cu, flash_attention.cu, ssd_scan.cu,
// popcount_matmul.cu): 16- and 4-byte cp.async with zero fill, ldmatrix,
// the bf16 mma.sync m16n8k16 and the tf32 m16n8k8, both with float32
// accumulators, and the split of a float32 operand into two tf32 parts.
// Included by those sources only; build.py hashes this header into every
// library's name, so an edit here rebuilds them.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major):  a[0] (g, 2t..2t+1)    a[1] (g+8, 2t..2t+1)
//                            a[2] (g, 2t+8..)      a[3] (g+8, 2t+8..)
//   B (16 x 8, k major):     b[0] (k 2t..2t+1, n g)  b[1] (k 2t+8.., n g)
//   C (16 x 8, float32):     c[0..1] (g, 2t..2t+1)   c[2..3] (g+8, 2t..)
// and of the tf32 m16n8k8 (one 32-bit element a register):
//   A (16 x 8, row major):   a[0] (g, t)  a[1] (g+8, t)  a[2] (g, t+4)
//                            a[3] (g+8, t+4)
//   B (8 x 8, k major):      b0 (k t, n g)  b1 (k t+4, n g)
//   C (16 x 8, float32):     as m16n8k16's
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with valid == false nothing is
// read and the 16 bytes are zero-filled (rows past a ragged edge).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, through L1; with valid == false nothing is
// read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  Without .trans lane l receives (row l/4, cols 2(l%4),
// 2(l%4)+1) of each matrix; with .trans (rows 2(l%4), 2(l%4)+1, col l/4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d = a * b + c on the tensor cores (bf16 inputs, float32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// Two 8 x 8 b16 matrices, transposed; lanes 0..15 give the row addresses
// (lane l: row l % 8 of matrix l / 8), the other lanes' are ignored.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// two floats -> a bf16 pair (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d = a * b + c on the tensor cores (tf32 inputs: float32 bit patterns
// whose 13 low significand bits are zero; float32 accumulators)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// Finite x rounded to tf32 (10 stored significand bits) to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds: half a tf32 ulp added to
// the bit pattern (a carry into the exponent is the rounding up to the
// next binade), then the 13 low bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split of a float32 operand: hi = tf32(x), lo = tf32(x - hi)
// (the difference is exact), so x = hi + lo to within half a tf32 ulp of
// lo, about 2^-22 |x|; a product a * b is then a_lo b_hi + a_hi b_lo +
// a_hi b_hi, dropping only a_lo b_lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

}  // namespace sm90
