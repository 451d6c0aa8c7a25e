// Shared device code for the port's Hopper kernels (sm_90a):
//
//  * small helpers (bf16 reads, warp reductions, SiLU) and the MLA
//    constants kernels A and B share (heads padded to one m16 tile,
//    128-byte alignment, zero rows);
//
//  * the dense (GQA) kernels G and H's key tiles, whose K and V caches are
//    separate planes of KVH*D columns: gqa_issue_tile copies KT keys of
//    one sequence, each found through the block table whatever the
//    cache's block size; ldmatrix_x4 (bf16 tiles) and row_pairs (int8
//    tiles, widened with their scales) read tile rows as mma.sync
//    operands.
//
// The kernels stream tiles through cp.async rings and run mma.sync on
// fragments they build themselves (pipeline.cuh, mla_page.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mla_page.cuh"

#define LLMD_EXPORT extern "C" __attribute__((visibility("default")))

namespace llmd {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;       // masked score
constexpr float kMaxInit = -1e29f;      // running-max floor: masked p == 0

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// jax.nn.silu in f32: x * (1 / (1 + exp(-x))).
__device__ __forceinline__ float silu_f32(float x) {
  return x * (1.0f / (1.0f + expf(-x)));
}

// ---------------------------------------------------------------------------
// MLA (kernels A and B)
// ---------------------------------------------------------------------------

constexpr int kMlaMaxHeads = 16;        // heads padded to one m16 tile

__host__ __device__ inline size_t mla_align128(size_t b) {
  return (b + 127) & ~size_t(127);
}

// Zero-fills an [H, F] output (pad rows: no live key).
__device__ __forceinline__ void mla_zero_out(bf16* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = __float2bfloat16(0.0f);
}

// ---------------------------------------------------------------------------
// GQA key tiles (kernels G and H)
// ---------------------------------------------------------------------------

// Four 8 x 8 bf16 matrices from shared memory (ldmatrix): lane l gives
// the address of row l % 8 of matrix l / 8, and r[i] is matrix i in the
// mma.sync fragment layout (row lane / 4, columns 2 (lane % 4), +1), or
// with trans its transpose (row lane / 4 of the transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// bf16 pairs (row r0, row r1) at columns f .. f + 3 (f % 4 == 0) of two
// tile rows, dequantized as page_quad does (mla_page.cuh): pair j holds
// column f + j, row r0 in the lower half -- the B (or A) operand of a dot
// over the rows.  bf16 rows are paired by byte permutes, int8 ones
// widened with the rows' scales.
template <bool QUANT>
__device__ __forceinline__ void row_pairs(const char* r0, const char* r1,
                                          const float* rs0, const float* rs1,
                                          int f, int group,
                                          uint32_t (&p)[4]) {
  if (QUANT) {
    float v0[4], v1[4];
    page_quad<true>(r0, rs0, f, group, v0);
    page_quad<true>(r1, rs1, f, group, v1);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = pack_bf16(v0[j], v1[j]);
  } else {
    const uint2 w0 = *reinterpret_cast<const uint2*>(r0 + 2 * f);
    const uint2 w1 = *reinterpret_cast<const uint2*>(r1 + 2 * f);
    p[0] = __byte_perm(w0.x, w1.x, 0x5410);
    p[1] = __byte_perm(w0.x, w1.x, 0x7632);
    p[2] = __byte_perm(w0.y, w1.y, 0x5410);
    p[3] = __byte_perm(w0.y, w1.y, 0x7632);
  }
}

// Issues the copies of one key tile: keys k0 .. k0 + kt - 1 of a sequence,
// RB bytes of each K and V row from byte col of the row (the columns of
// the tile's KV heads), into k_dst / v_dst at a pitch of LDP bytes; key
// `key` lives at slot bt_row[key / bs] * bs + key % bs of the planes
// [slots, row] (row bytes a cache row).  Rows r >= nk are zero-filled by
// the copy (nothing read; finite, and p = 0 multiplies them).  Key
// new_pos (decode's fresh row, or -1) is read from k_new / v_new (row
// col offset already applied) and its scales from ks_new / vs_new.  QUANT:
// nsc f32 scales a row, columns scol .. scol + nsc - 1 of the [slots, SW]
// planes, into ks_dst / vs_dst ([kt, nsc]).  All threads of the block
// take part (RB / 16 must divide their count); the caller commits the
// group.
template <bool QUANT>
__device__ __forceinline__ void gqa_issue_tile(
    char* k_dst, char* v_dst, float* ks_dst, float* vs_dst, int kt, int LDP,
    int RB, int k0, int nk, const char* k_plane, const char* v_plane,
    long long row, long long col, const float* ks_plane,
    const float* vs_plane, int SW, int scol, int nsc,
    const int* __restrict__ bt_row, int bs, int new_pos, const char* k_new,
    const char* v_new, const float* ks_new, const float* vs_new) {
  const int p0 = k0 / bs, o0 = k0 - p0 * bs;
  const bool one_page = o0 + nk <= bs;
  const long long base = (long long)bt_row[p0] * bs + o0;
  auto slot = [&](int r) -> long long {
    if (one_page) return base + r;
    const int key = k0 + r;
    return (long long)bt_row[key / bs] * bs + key % bs;
  };
  // RB / 16 divides the block's threads: thread t copies 16-byte chunk
  // t % chunks of rows t / chunks, t / chunks + step, ...
  const int chunks = RB / 16, step = blockDim.x / chunks;
  const int c = (threadIdx.x % chunks) * 16;
  for (int r = threadIdx.x / chunks; r < kt; r += step) {
    const char* ks = k_plane;
    const char* vs = v_plane;
    int n = 0;
    if (r < nk) {
      n = 16;
      if (k0 + r == new_pos) {
        ks = k_new + c;
        vs = v_new + c;
      } else {
        const long long off = slot(r) * row + col + c;
        ks = k_plane + off;
        vs = v_plane + off;
      }
    }
    cp_async16(k_dst + r * LDP + c, ks, n);
    cp_async16(v_dst + r * LDP + c, vs, n);
  }
  if (QUANT) {
    for (int i = threadIdx.x; i < kt * nsc; i += blockDim.x) {
      const int r = i / nsc, c = i - r * nsc;
      const float* ks = ks_plane;
      const float* vs = vs_plane;
      int n = 0;
      if (r < nk) {
        n = 4;
        if (k0 + r == new_pos) {
          ks = ks_new + c;
          vs = vs_new + c;
        } else {
          const long long off = slot(r) * SW + scol + c;
          ks = ks_plane + off;
          vs = vs_plane + off;
        }
      }
      cp_async4(ks_dst + i, ks, n);
      cp_async4(vs_dst + i, vs, n);
    }
  }
}

}  // namespace llmd
