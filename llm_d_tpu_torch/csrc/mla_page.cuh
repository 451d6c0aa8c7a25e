// Fragment reads of MLA latent pages kept in shared memory as the cache
// stores them (int8 with f32 row scales, or bf16), shared by kernels A
// (mla_decode.cu) and B (mla_prefill.cu): the read-side dequant of
// ops/pallas/quant_util.py make_page_dequant, done as a warp builds its
// mma.sync B fragments, so a page is never widened into shared memory.
// int8 bytes convert exactly to f32; the product with the row scale is
// the f32 one the TPU kernels take.
#pragma once

#include "pipeline.cuh"

namespace llmd {

// bf16 pair of page row `row` at columns f, f + 1 (f even), dequantized.
template <bool QUANT>
__device__ __forceinline__ uint32_t page_pair(const char* row, const float* rs,
                                              int f, int group) {
  if (QUANT) {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(row + f);
    const float sc = rs[f / group];
    return pack_bf16(s8_at(v, 0) * sc, s8_at(v, 1) * sc);
  }
  return *reinterpret_cast<const uint32_t*>(row + 2 * f);
}

// Columns f .. f + 3 of page row `row` (f % 4 == 0), dequantized.
template <bool QUANT>
__device__ __forceinline__ void page_quad(const char* row, const float* rs,
                                          int f, int group, float (&v)[4]) {
  if (QUANT) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + f);
    const float sc = rs[f / group];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = s8_at(w, j) * sc;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 2 * f);
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  }
}

}  // namespace llmd
