// Primitives of the kernels that stream tiles through cp.async rings and
// run mma.sync on fragments they build themselves (kernels A, B, C, E):
// 16- and 4-byte asynchronous copies into shared memory, the m16n8k16 bf16
// tensor-core product, the pack of two floats into a bf16 pair, the exact
// widening of int8 bytes on the integer and f32 pipes, the ring loop
// (run_ring) and the int8-weight fragment step (mma_int8_step) shared by
// the int8 MoE kernels C and E.
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

typedef __nv_bfloat16 bf16;

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

// The four signed bytes of w as exact floats, on the full-rate integer
// and f32 pipes rather than the conversion unit (whose rate bounded the
// loop): byte b + 128 becomes the low byte of 2^23's bit pattern, and
// subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// bf16 pair (lo in the lower half) of two floats holding integers of at
// most 8 significant bits: their low 16 bits are zero, so the upper
// halves are the exact bf16 values.
__device__ __forceinline__ uint32_t pack_int_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The pipeline: N steps through a STAGES-deep ring of STAGE bytes a
// stage; load(s, stage) issues step s's copies, then mma(stage) multiplies
// the stage in, and after(s) runs once step s is in (C's pass 2 folds an
// expert's sum there).  Returns with the ring drained and free.
template <int STAGES, int STAGE, class Load, class Mma, class After>
__device__ __forceinline__ void run_ring(char* smem, int N, Load load,
                                         Mma mma, After after) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < N) load(s, smem + s * STAGE);
    cp_async_commit();
  }
  for (int s = 0; s < N; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                 // step s landed; stage s-1 is free
    const int nx = s + STAGES - 1;
    if (nx < N) load(nx, smem + (nx % STAGES) * STAGE);
    cp_async_commit();
    mma(smem + (s % STAGES) * STAGE);
    after(s);
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the results
}

// One warp's share of a stage of bf16 activations times NW int8 weight
// tiles, over K rows [k0, k1) (multiples of 16):
//   acc[w][mt][j] += A[m16 tile mt] . W_w[:, n8 tile j].
// A points at the warp's first activation row (bf16, pitch LDA, column 0
// of the stage); W at weight tile 0's row 0 (int8, pitch LDW, tiles WSTR
// bytes apart), offset to the warp's 32-column slice.  Thread (g, q) reads
// the 32-bit word of columns 4g .. 4g+3 of the slice from rows 2q, 2q+1,
// 2q+8, 2q+9 and widens byte j into n8 tile j, so tile j's local column g
// is the slice's column 4g + j.  Each accumulator takes its products in
// ascending K order.
template <int NW, int MT, int LDA, int LDW, int WSTR>
__device__ __forceinline__ void mma_int8_step(const bf16* A, const int8_t* W,
                                              int k0, int k1, int g, int q,
                                              float (&acc)[NW][MT][4][4]) {
  const int8_t* Wq = W + 4 * g;
#pragma unroll
  for (int kk = k0; kk < k1; kk += 16) {
    uint32_t b[NW][4][2];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int8_t* wb = Wq + w * WSTR + (kk + 2 * q) * LDW;
      float f0[4], f1[4], f8[4], f9[4];
      s8x4_to_f32(*reinterpret_cast<const uint32_t*>(wb), f0);
      s8x4_to_f32(*reinterpret_cast<const uint32_t*>(wb + LDW), f1);
      s8x4_to_f32(*reinterpret_cast<const uint32_t*>(wb + 8 * LDW), f8);
      s8x4_to_f32(*reinterpret_cast<const uint32_t*>(wb + 9 * LDW), f9);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[w][j][0] = pack_int_bf16(f0[j], f1[j]);
        b[w][j][1] = pack_int_bf16(f8[j], f9[j]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bf16* ab = A + (mt * 16 + g) * LDA + kk + 2 * q;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ab);
      a[1] = *reinterpret_cast<const uint32_t*>(ab + 8 * LDA);
      a[2] = *reinterpret_cast<const uint32_t*>(ab + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ab + 8 * LDA + 8);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[w][mt][j], a, b[w][j][0], b[w][j][1]);
    }
  }
}

}  // namespace llmd
