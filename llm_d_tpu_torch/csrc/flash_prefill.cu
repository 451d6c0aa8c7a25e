// Kernel H: dense (GQA) causal flash prefill over the paged K/V cache.
//
// Replaces ops/pallas/flash_prefill.py flash_prefill_paged (TPU).
// Read-only: the caller scattered this step's rows and scales first.  One
// thread block of four warps per (KV head, sequence, query tile): the
// tile's kM = 64 rows are P = 64 / G query positions times the G heads
// that share the KV head, row r being position r / G and head r % G (rows
// past P * G are padding when G does not divide 64), and warp w owns rows
// 16 w .. 16 w + 15.  The block walks the sequence's keys up to the
// tile's largest causal bound min(seq_len, q_pos + 1) in key tiles of
// kKT = 64 keys; key k lives at slot block_table[k / bs] * bs + k % bs,
// so the tile does not depend on the cache's block size.  Each key tile
// arrives once per block, as stored (bf16, or int8 plus the KV head's f32
// scale of each row), through a two-stage cp.async ring with rows past
// the bound zero-filled by the copy, and every warp reads it: one barrier
// a key tile.  A warp stops at its own rows' largest bound and masks only
// the tiles that cross its rows' smallest; pad rows (q_pos -1) and pad
// sequences (seq_len 0) give zeros.
//
// FlashAttention-2 on mma.sync m16n8k16, as kernel B: scores [16, kKT]
// stay in registers, the optional soft_cap * tanh(s / soft_cap) is
// applied there, p rounded to bf16 is the A operand of the value dot
// straight from the score accumulator, and the f32 output [16, D] and the
// statistics stay in registers.  bf16 tiles reach both dots through
// ldmatrix (V transposed); int8 ones are widened in the fragments with
// their scales (mla_page.cuh).  The q tile and key tile 0 are in flight
// while the block reads its causal bounds.  The TPU recurrence is kept:
// bf16 q * scale, keys dequantized to bf16, one running-max update per key
// tile, bf16 p in the value dot, f32 sums.
//
// Bound on the H100: bytes at the engine's prefill shapes (each live
// query row read and written once, each key below a sequence's bound
// read once; 4*D flops per head per causal (query, key) pair take a fifth
// of that time at the tensor-core rate).  Shared memory is the q tile and
// two stages of K and V: 46 KB at D = 64 and 87 KB at D = 128 in bf16, so
// four or two blocks share an SM.  Blocks are issued longest first (the
// last query tile of each sequence first).
#include "common.cuh"

namespace {

using llmd::bf16;

constexpr int kThreads = 128;            // four warps
constexpr int kM = 64;                   // fused (position, head) rows
constexpr int kKT = 64;                  // keys of a tile
constexpr int kMaxSmem = 232448;         // dynamic shared memory of a block

// Dynamic shared memory, each part 128-byte aligned: q [kM, D+8] bf16,
// then two stages of K and V tiles [kKT, D*esz + 16] bytes and, for int8,
// their [kKT] f32 scales.
struct PrefillSmem {
  int q, stage, v, ks, vs, stage_bytes, total;
  __host__ __device__ PrefillSmem(int D, bool quant) {
    const int ldp = D * (quant ? 1 : 2) + 16;
    q = 0;
    stage = (int)llmd::mla_align128((size_t)kM * (D + 8) * 2);
    v = (int)llmd::mla_align128((size_t)kKT * ldp);
    ks = (int)llmd::mla_align128((size_t)2 * v);
    vs = ks + (quant ? kKT * 4 : 0);
    stage_bytes = (int)llmd::mla_align128((size_t)vs + (quant ? kKT * 4 : 0));
    total = stage + 2 * stage_bytes;
  }
};

template <bool QUANT, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 2)
gqa_prefill_kernel(const bf16* __restrict__ qs, const int* __restrict__ q_pos,
                   const void* k_cache, const void* v_cache,
                   const float* k_scale, const float* v_scale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ seq_lens, bf16* __restrict__ out,
                   int Q, int H, int KVH, int SW, int bs, int B,
                   long long slots, int layer, float scale, float soft_cap) {
  constexpr int esz = QUANT ? 1 : 2;
  constexpr int RB = D * esz;            // bytes of a KV head's row
  constexpr int LDP = RB + 16;           // their pitch in shared memory
  constexpr int LQ = D + 8;
  constexpr int NTK = kKT / 8;           // n8 key groups of a tile
  constexpr int NG = D / 32;             // 32-column groups (int8 values)
  extern __shared__ __align__(128) char smem[];
  const int kh = blockIdx.x, s = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest tiles first
  const int G = H / KVH, P = kM / G, q0 = qt * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int sl = seq_lens[s];
  const int F = KVH * D;
  const long long row0 = ((long long)s * Q + q0) * H + (long long)kh * G;
  auto out_row = [&](int r) {           // output row r of the tile, or null
    const int p = r / G;
    return r < P * G && q0 + p < Q ? out + (row0 + (long long)p * H + r % G) * D
                                   : nullptr;
  };
  auto zero_out = [&]() {
    for (int i = tid; i < kM * D / 8; i += kThreads) {
      bf16* o = out_row(i / (D / 8));
      if (o) reinterpret_cast<uint4*>(o)[i % (D / 8)] = make_uint4(0, 0, 0, 0);
    }
  };
  if (sl <= 0) {
    zero_out();
    return;
  }

  const PrefillSmem lay(D, QUANT);
  const int* bt_row = block_tables + (long long)s * B;
  const long long plane = (long long)layer * slots;
  const char* kp = static_cast<const char*>(k_cache) + plane * F * esz;
  const char* vp = static_cast<const char*>(v_cache) + plane * F * esz;
  const float* ksp = QUANT ? k_scale + plane * SW : nullptr;
  const float* vsp = QUANT ? v_scale + plane * SW : nullptr;
  // Issues key tile t's copies into buffer b, rows past nk zero-filled.
  auto issue = [&](int t, int b, int nk) {
    char* st = smem + lay.stage + b * lay.stage_bytes;
    const int k0 = t * kKT;
    llmd::gqa_issue_tile<QUANT>(
        st, st + lay.v, reinterpret_cast<float*>(st + lay.ks),
        reinterpret_cast<float*>(st + lay.vs), kKT, LDP, RB, k0,
        min(kKT, nk - k0), kp, vp, (long long)F * esz, (long long)kh * RB,
        ksp, vsp, SW, SW > 1 ? kh : 0, 1, bt_row, bs, -1, nullptr, nullptr,
        nullptr, nullptr);
  };
  // The q tile as stored (pad rows zero-filled by the copy) and key tile 0
  // up to seq_len, in flight while the causal bounds are read.
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  for (int i = tid; i < kM * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int p = r / G;
    const bool live = r < P * G && q0 + p < Q;
    llmd::cp_async16(q_s + r * LQ + c,
                     live ? qs + (row0 + (long long)p * H + r % G) * D + c
                          : qs,
                     live ? 16 : 0);
  }
  issue(0, 0, sl);
  llmd::cp_async_commit();

  const int* qp = q_pos + (long long)s * Q + q0;
  // Causal bound of tile position p (0 for pad rows and positions).
  auto bound = [&](int p) {
    return p < P && q0 + p < Q ? max(0, min(sl, qp[p] + 1)) : 0;
  };
  const int nk_max = __reduce_max_sync(
      0xffffffffu, max(bound(lane), bound(lane + 32)));
  // This thread's rows g and g + 8 of the warp, and the warp's bounds.
  int row_nk[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + 8 * half;
    row_nk[half] = r < P * G ? bound(r / G) : 0;
  }
  const int warp_nk = __reduce_max_sync(0xffffffffu, max(row_nk[0], row_nk[1]));
  const int warp_min = __reduce_min_sync(0xffffffffu, min(row_nk[0], row_nk[1]));
  llmd::cp_async_wait<0>();
  if (nk_max <= 0) {
    zero_out();
    return;
  }
  __syncthreads();

  // The warp's rows of q * scale, rounded to bf16, as the A operand of
  // the score dot (k step kk / 16).
  uint32_t qa[D / 16][4];
  {
    const bf16* qa0 = q_s + (warp * 16 + g) * LQ + 2 * qd;
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            qa0 + (e & 1) * 8 * LQ + 16 * k + (e >> 1) * 8);
        qa[k][e] = llmd::pack_bf16(__uint_as_float(w << 16) * scale,
                                   __uint_as_float(w & 0xffff0000u) * scale);
      }
  }

  // Running max and sum of rows g and g + 8; acc[n][e] is row g + 8
  // (e >> 1) of n8 output tile n: column 8 n + 2 qd + (e & 1) for bf16
  // tiles (read by ldmatrix), column 32 (n / 4) + 4 (2 qd + (e & 1)) +
  // n % 4 for int8 ones (read as words of four columns).
  float m_run[2] = {llmd::kMaxInit, llmd::kMaxInit};
  float l_run[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // ldmatrix row addresses of this lane in a bf16 tile (bytes): matrix
  // lane / 8, row lane % 8 -- K: keys 8 (mi / 2) + row, columns 8 (mi % 2);
  // V (transposed): keys 8 (mi % 2) + row, columns 8 (mi / 2).
  const int mi = lane >> 3, mr = lane & 7;
  const int k_lane = (8 * (mi >> 1) + mr) * LDP + 16 * (mi & 1);
  const int v_lane = (8 * (mi & 1) + mr) * LDP + 16 * (mi >> 1);

  const int n_tiles = (nk_max + kKT - 1) / kKT;
  for (int t = 0; t < n_tiles; ++t) {
    const int b = t & 1;
    llmd::cp_async_wait<0>();
    __syncthreads();              // tile t (and q) in; tile t-1 fully used
    if (t + 1 < n_tiles) issue(t + 1, b ^ 1, nk_max);
    llmd::cp_async_commit();
    const int k0 = t * kKT;
    if (k0 >= warp_nk) continue;        // the warp's rows are done
    const char* st = smem + lay.stage + b * lay.stage_bytes;
    const char* ktile = st;
    const char* vtile = st + lay.v;
    const float* kscl = QUANT ? reinterpret_cast<const float*>(st + lay.ks)
                              : nullptr;
    const float* vscl = QUANT ? reinterpret_cast<const float*>(st + lay.vs)
                              : nullptr;

    // 1. Scores [16, kKT] = q [16, D] . K^T, key groups below warp_nk.
    float sc[NTK][4];
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
#pragma unroll
      for (int j = 0; j < NTK; j += 2) {
        if (k0 + 8 * j >= warp_nk) break;
        uint32_t b[4];                   // (b0, b1) of key groups j, j + 1
        if (QUANT) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int key = 8 * (j + h) + g;
            const char* prow = ktile + key * LDP;
            b[2 * h] = llmd::page_pair<true>(prow, kscl + key, kk + 2 * qd, D);
            b[2 * h + 1] =
                llmd::page_pair<true>(prow, kscl + key, kk + 8 + 2 * qd, D);
          }
        } else {
          llmd::ldmatrix_x4(b, ktile + 8 * j * LDP + 2 * kk + k_lane);
        }
        llmd::mma_bf16(sc[j], qa[kk / 16], b[0], b[1]);
        llmd::mma_bf16(sc[j + 1], qa[kk / 16], b[2], b[3]);
      }
    }

    // 2. Soft cap, the mask where the tile crosses a row's bound, one
    //    running-max update; p = exp(s - m_new), l sums the f32 p, corr
    //    rescales what came before.
    if (soft_cap > 0.0f) {
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = soft_cap * tanhf(sc[j][e] / soft_cap);
    }
    if (k0 + kKT > warp_min) {
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * qd + (e & 1);
          sc[j][e] = key < row_nk[e >> 1] ? sc[j][e] : llmd::kNegInf;
        }
    }
    float mx[2] = {llmd::kNegInf, llmd::kNegInf};
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(m_run[half], mx[half]);
      corr[half] = __expf(m_run[half] - m_new);
      m_run[half] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = __expf(sc[j][e] - m_run[e >> 1]);
        sum[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      l_run[half] = l_run[half] * corr[half] + sum[half];
    }

    // 3. acc = acc * corr + bf16(p) [16, kKT] . V [kKT, D].
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) {
      if (k0 + 16 * ks >= warp_nk) break;
      uint32_t a[4];
      a[0] = llmd::pack_bf16(sc[2 * ks][0], sc[2 * ks][1]);
      a[1] = llmd::pack_bf16(sc[2 * ks][2], sc[2 * ks][3]);
      a[2] = llmd::pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
      a[3] = llmd::pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
      if (QUANT) {
        const int r0 = ks * 16 + 2 * qd;
        const char* v0 = vtile + r0 * LDP;
        const float* rs = vscl + r0;
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          uint32_t p01[4], p89[4];
          llmd::row_pairs<true>(v0, v0 + LDP, rs, rs + 1, gi * 32 + 4 * g, D,
                                p01);
          llmd::row_pairs<true>(v0 + 8 * LDP, v0 + 9 * LDP, rs + 8, rs + 9,
                                gi * 32 + 4 * g, D, p89);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            llmd::mma_bf16(acc[4 * gi + j], a, p01[j], p89[j]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t b[4];                 // (b0, b1) of output tiles n, n + 1
          llmd::ldmatrix_x4_trans(b, vtile + 16 * ks * LDP + 16 * n + v_lane);
          llmd::mma_bf16(acc[n], a, b[0], b[1]);
          llmd::mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }
  }
  llmd::cp_async_wait<0>();

  // out = acc / l for rows g and g + 8: bf16 tiles hold columns 8 n +
  // 2 qd, +1; int8 ones columns 8 qd .. 8 qd + 7 of each 32-column group.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* o = out_row(warp * 16 + g + 8 * half);
    if (!o) continue;
    const float l = fmaxf(l_run[half], 1e-30f);
    if (QUANT) {
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        uint32_t v[4];
#pragma unroll
        for (int c = 0; c < 8; c += 2) {
          const int e = 2 * half + (c >> 2);
          v[c / 2] = llmd::pack_bf16(acc[4 * gi + (c & 3)][e] / l,
                                     acc[4 * gi + ((c + 1) & 3)][e] / l);
        }
        *reinterpret_cast<uint4*>(o + gi * 32 + 8 * qd) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * qd) = llmd::pack_bf16(
            acc[n][2 * half] / l, acc[n][2 * half + 1] / l);
    }
  }
}

template <bool QUANT, int D>
int launch(const void* qs, const void* q_pos, const void* k_cache,
           const void* v_cache, const void* k_scale, const void* v_scale,
           const void* block_tables, const void* seq_lens, void* out, int S,
           int Q, int H, int KVH, int SW, int bs, int B, long long slots,
           int layer, float scale, float soft_cap, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        gqa_prefill_kernel<QUANT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int P = kM / (H / KVH);
  gqa_prefill_kernel<QUANT, D>
      <<<dim3(KVH, S, (Q + P - 1) / P), kThreads,
         PrefillSmem(D, QUANT).total, stream>>>(
          static_cast<const bf16*>(qs), static_cast<const int*>(q_pos),
          k_cache, v_cache, static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(seq_lens), static_cast<bf16*>(out), Q, H,
          KVH, SW, bs, B, slots, layer, scale, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// qs [S, Q, H, D] bf16 (D 64 or 128, H / KVH <= 64); q_pos [S, Q] i32
// (pad -1); k/v_cache [L, slots, KVH*D] (int8 or bf16); k/v_scale
// [L, slots, SW] f32 (int8 only, SW 1 or KVH); block_tables [S, B] i32;
// seq_lens [S] i32; out [S, Q, H, D] bf16.  soft_cap <= 0 means none.
// The shared memory is ops/flash_prefill.prefill_plan's.
LLMD_EXPORT int llmd_flash_prefill(
    const void* qs, const void* q_pos, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* seq_lens, void* out, int S, int Q,
    int H, int KVH, int D, int SW, int bs, int B, long long slots, int layer,
    float scale, float soft_cap, int quantized, void* stream) {
  if (S == 0 || Q == 0) return 0;
  const int G = KVH > 0 ? H / KVH : 0;
  if (G < 1 || G > kM || H != G * KVH || (SW != 1 && SW != KVH) || bs <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LLMD_H_LAUNCH(quant, d)                                               \
  if ((quantized != 0) == quant && D == d)                                    \
    return launch<quant, d>(qs, q_pos, k_cache, v_cache, k_scale, v_scale,    \
                            block_tables, seq_lens, out, S, Q, H, KVH, SW,    \
                            bs, B, slots, layer, scale, soft_cap, st);
  LLMD_H_LAUNCH(true, 64)
  LLMD_H_LAUNCH(true, 128)
  LLMD_H_LAUNCH(false, 64)
  LLMD_H_LAUNCH(false, 128)
#undef LLMD_H_LAUNCH
  return (int)cudaErrorInvalidValue;
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
