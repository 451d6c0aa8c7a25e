// Shared device code for the port's Hopper kernels (sm_90a).
//
// The building blocks live here:
//
//  * gqa_attend: the page loop of the dense (GQA) decode and prefill
//    kernels G and H, over separate K and V caches, the G heads of one KV
//    head at a time, with per-row or per-KV-head int8 scales (the inline
//    form of ops/pallas/quant_util.py make_page_dequant); both dots on the
//    tensor cores (bf16 wmma), the flash recurrence in f32 with one
//    running max per page, q * scale and p rounded to bf16 before their
//    dots, as the TPU kernels run it.
//
//  * the MLA constants and helpers kernels A and B share (heads padded to
//    one m16 tile, 128-byte alignment, zero rows).
//
// The page loop here is not pipelined and uses neither wgmma nor TMA.
// Kernels A-F stream tiles through cp.async rings and run mma.sync on
// fragments they build themselves (pipeline.cuh, mla_page.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#define LLMD_EXPORT extern "C" __attribute__((visibility("default")))

namespace llmd {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;       // masked score
constexpr float kMaxInit = -1e29f;      // running-max floor: masked p == 0

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// Round-to-nearest-even to bf16 and back: the TPU kernels' astype(bf16).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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
// GQA page attention over separate K and V caches (dense models)
// ---------------------------------------------------------------------------

constexpr int kGqaThreads = 256;

// Four consecutive cache elements (row, columns f..f+3) after the
// read-side dequant: bf16(int8 * scale of column group f / group), or the
// bf16 cache values as they are.
template <bool QUANT>
__device__ __forceinline__ void kv_load4(const void* row, const float* rscale,
                                         int f, int group, bf16* dst) {
  if (QUANT) {
    const char4 v = *reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(row) + f);
    dst[0] = __float2bfloat16((float)v.x * rscale[f / group]);
    dst[1] = __float2bfloat16((float)v.y * rscale[(f + 1) / group]);
    dst[2] = __float2bfloat16((float)v.z * rscale[(f + 2) / group]);
    dst[3] = __float2bfloat16((float)v.w * rscale[(f + 3) / group]);
  } else {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(
        static_cast<const bf16*>(row) + f);
  }
}

// Dynamic shared memory, each part 128-byte aligned:
//   q [RT, D] bf16 | k [bs, D] bf16 | v [bs, D] bf16 | s [RT, bs] f32 |
//   pb [RT, bs] bf16 | pv [RT, D] f32 | acc [RT, D] f32 |
//   m, l, corr [RT] f32 | qpos [RT] i32.
struct GqaSmem {
  size_t q, k, v, s, pb, pv, acc, stats, total;
  __host__ __device__ GqaSmem(int RT, int D, int bs) {
    q = 0;
    k = mla_align128(q + (size_t)RT * D * 2);
    v = mla_align128(k + (size_t)bs * D * 2);
    s = mla_align128(v + (size_t)bs * D * 2);
    pb = mla_align128(s + (size_t)RT * bs * 4);
    pv = mla_align128(pb + (size_t)RT * bs * 2);
    acc = mla_align128(pv + (size_t)RT * D * 4);
    stats = mla_align128(acc + (size_t)RT * D * 4);
    total = stats + 4 * (size_t)RT * 4;
  }
};

// Attends the query rows of ONE KV head of one sequence: row r is head
// r % G (of the G heads sharing the KV head) at position slot r / G of
// n_pos positions.
//   q, out     row (p, g) at q + p * pos_stride + g * D (bf16, global)
//   q_pos      [n_pos] absolute positions (-1 = pad row), or null: every
//              row sits at seq_len - 1 (decode)
//   k/v_plane  one layer plane [slots, ld] (int8 or bf16); the KV head's
//              columns are [col0, col0 + D)
//   ks/vs_plane  [slots, sw] f32 scale planes; the head's scale is column
//              scol (int8 only)
//   new_pos    key position read from k/v_new (+ ks/vs_new) instead of
//              the cache (decode's fresh row, already offset to col0 and
//              scol), or -1
// Row r attends keys at positions <= q_pos[r] and < seq_len, page by page
// through the block table, with the TPU kernels' recurrence: bf16
// q * scale, pages dequantized to bf16, optional soft_cap * tanh(s /
// soft_cap) (soft_cap > 0), one running max per page, bf16 p in the
// value dot, f32 statistics.  Both dots run on the tensor cores (bf16
// wmma, f32 accumulation).  Requires RT, D and bs multiples of 16, rows
// = n_pos * G <= RT.
template <bool QUANT>
__device__ void gqa_attend(const bf16* __restrict__ q, bf16* __restrict__ out,
                           long long pos_stride, int G, int n_pos,
                           const int* __restrict__ q_pos, float scale,
                           float soft_cap, int RT, int D, int bs,
                           const void* k_plane, const void* v_plane, int ld,
                           int col0, const float* ks_plane,
                           const float* vs_plane, int sw, int scol,
                           const int* __restrict__ bt_row, int seq_len,
                           int new_pos, const void* k_new, const void* v_new,
                           const float* ks_new, const float* vs_new,
                           char* smem) {
  namespace wmma = nvcuda::wmma;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int esz = QUANT ? 1 : 2;
  const int rows = n_pos * G;

  const GqaSmem lay(RT, D, bs);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + lay.v);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  bf16* pb_s = reinterpret_cast<bf16*>(smem + lay.pb);
  float* pv_s = reinterpret_cast<float*>(smem + lay.pv);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);
  float* l_s = m_s + RT;
  float* c_s = l_s + RT;
  int* qpos_s = reinterpret_cast<int*>(c_s + RT);

  // Rows past `rows` are zero queries at position -1; page rows past the
  // live keys must hold finite values (p = 0 multiplies them), so the
  // pages start zeroed.
  for (int i = tid; i < RT * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    q_s[i] = r < rows ? __float2bfloat16(
                            bf2f(q[(r / G) * pos_stride + (r % G) * D + d]) *
                            scale)
                      : __float2bfloat16(0.0f);
    acc_s[i] = 0.0f;
  }
  for (int i = tid; i < bs * D; i += blockDim.x) {
    k_s[i] = __float2bfloat16(0.0f);
    v_s[i] = __float2bfloat16(0.0f);
  }
  for (int i = tid; i < RT * bs; i += blockDim.x)
    pb_s[i] = __float2bfloat16(0.0f);
  for (int r = tid; r < RT; r += blockDim.x) {
    m_s[r] = kMaxInit;
    l_s[r] = 0.0f;
    qpos_s[r] = r < rows ? (q_pos ? q_pos[r / G] : seq_len - 1) : -1;
  }
  __syncthreads();

  // Causal bound of the tile: keys past max(q_pos) never score.
  int qmax = -1;
  for (int r = 0; r < rows; ++r) qmax = max(qmax, qpos_s[r]);
  const int live = min(seq_len, qmax + 1);
  const int n_pages = live > 0 ? (live + bs - 1) / bs : 0;

  for (int j = 0; j < n_pages; ++j) {
    const int nk = min(bs, live - j * bs);
    const long long base = (long long)bt_row[j] * bs;

    // 1. K and V rows [0, nk) of the page, dequantized to bf16.
    for (int i = tid; i < nk * D / 4; i += blockDim.x) {
      const int r = (4 * i) / D;
      const int f = 4 * i - r * D;
      if (j * bs + r == new_pos) {
        kv_load4<QUANT>(k_new, ks_new, f, D, k_s + r * D + f);
        kv_load4<QUANT>(v_new, vs_new, f, D, v_s + r * D + f);
      } else {
        const long long slot = base + r;
        const long long off = (slot * ld + col0) * esz;
        kv_load4<QUANT>(static_cast<const char*>(k_plane) + off,
                         QUANT ? ks_plane + slot * sw + scol : nullptr, f, D,
                         k_s + r * D + f);
        kv_load4<QUANT>(static_cast<const char*>(v_plane) + off,
                         QUANT ? vs_plane + slot * sw + scol : nullptr, f, D,
                         v_s + r * D + f);
      }
    }
    __syncthreads();

    // 2. Scores [RT, bs] = q [RT, D] . k^T on the tensor cores.
    const int n_sc = (RT / 16) * (bs / 16);
    for (int t = warp; t < n_sc; t += nwarps) {
      const int m0 = (t / (bs / 16)) * 16;
      const int n0 = (t % (bs / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.0f);
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, q_s + m0 * D + k0, D);
        wmma::load_matrix_sync(b, k_s + n0 * D + k0, D);
        wmma::mma_sync(sc, a, b, sc);
      }
      wmma::store_matrix_sync(s_s + m0 * bs + n0, sc, bs,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // 3. Online softmax, one warp per row.
    for (int r = warp; r < rows; r += nwarps) {
      const int qp = qpos_s[r];
      float mx = kNegInf;
      for (int c = lane; c < bs; c += 32) {
        const int key = j * bs + c;
        float sv = s_s[r * bs + c];
        if (soft_cap > 0.0f) sv = soft_cap * tanhf(sv / soft_cap);
        sv = (c < nk && key <= qp && key < seq_len) ? sv : kNegInf;
        s_s[r * bs + c] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < bs; c += 32) {
        const float pr = expf(s_s[r * bs + c] - m_new);
        sum += pr;
        pb_s[r * bs + c] = __float2bfloat16(pr);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. Values [RT, D] = bf16(p) [RT, bs] . v on the tensor cores.
    const int n_pv = (RT / 16) * (D / 16);
    for (int t = warp; t < n_pv; t += nwarps) {
      const int m0 = (t / (D / 16)) * 16;
      const int n0 = (t % (D / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
      wmma::fill_fragment(pv, 0.0f);
      for (int k0 = 0; k0 < bs; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, pb_s + m0 * bs + k0, bs);
        wmma::load_matrix_sync(b, v_s + k0 * D + n0, D);
        wmma::mma_sync(pv, a, b, pv);
      }
      wmma::store_matrix_sync(pv_s + m0 * D + n0, pv, D, wmma::mem_row_major);
    }
    __syncthreads();

    // 5. acc = acc * corr + pv.  The next page's loads overwrite k_s and
    //    v_s only after their last readers (steps 2 and 4) passed a
    //    barrier; pv_s and c_s are rewritten only after two more.
    for (int i = tid; i < rows * D; i += blockDim.x)
      acc_s[i] = acc_s[i] * c_s[i / D] + pv_s[i];
  }

  // Each thread finishes the acc elements it updated (same mapping); l_s
  // was last written before a barrier.
  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    out[(r / G) * pos_stride + (r % G) * D + d] =
        __float2bfloat16(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

}  // namespace llmd
