// Primitives of the kernels that stream tiles through cp.async rings and
// run mma.sync on fragments they build themselves (kernels A and C):
// 16- and 4-byte asynchronous copies into shared memory, the m16n8k16 bf16
// tensor-core product, and the pack of two floats into a bf16 pair.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4 and
// q = lane % 4:
//   A (row-major 16 x 16): a[0] = (row g,   cols 2q, 2q+1)
//                          a[1] = (row g+8, cols 2q, 2q+1)
//                          a[2] = (row g,   cols 2q+8, 2q+9)
//                          a[3] = (row g+8, cols 2q+8, 2q+9)
//   B (16 x 8, "col"):     b0 = (rows 2q, 2q+1 of col g), b1 = rows +8
//   C/D (16 x 8, f32):     d[0..1] = (row g, cols 2q, 2q+1), d[2..3] row g+8
// A pair's lower 16 bits hold the lower column (A) or row (B).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace llmd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1.  src_bytes < 16 zero-fills the
// rest (0: a row of zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (src_bytes 0: zeros, nothing read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16; lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Signed byte j of a 32-bit word, as a float (exact).
__device__ __forceinline__ float s8_at(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}

}  // namespace llmd
