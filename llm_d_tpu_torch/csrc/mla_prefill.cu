// Kernel B: MLA causal flash prefill over the paged latent cache.
//
// Replaces ops/pallas/mla_prefill.py mla_flash_prefill (TPU).  Read-only:
// the caller scatters this step's rows (and int8 scales) first.  One
// thread block per (sequence, tile of kTQ = 2 query positions): its 32
// rows are the 2 positions x 16 heads (heads past H are zero rows), and
// since MLA is MQA one latent row serves every row of the tile.  The
// block walks the keys up to the tile's largest causal bound
// min(seq_len, q_pos + 1) in key tiles of KT rows and masks each row's
// scores at its own bound; pad positions (q_pos == -1) and empty
// sequences give zeros.  The TPU recurrence is kept: bf16 q * scale, one
// running-max update per key tile (per page where KT is the cache's block
// size, as at the bench's int8 64-row pages), bf16 p in the value dot,
// f32 sums.
//
// The key tile is not the cache's block size: key k of a sequence lives
// at slot block_tables[k / bs] * bs + k % bs, so one kernel serves every
// block size, and KT (64 or 32) is the larger whose two buffers fit
// beside the q tile (ops/mla_prefill.key_tile): 64 for int8 rows at F =
// 640, 32 for bf16 ones.  A tile inside one page is one run of rows;
// otherwise each row finds its page.
//
// Bound on the H100: bytes (each live query row read and written once,
// each page of the sequence read once: about 0.1 ms at the bench's
// 8192-token step) -- 4*H*F flops per causal (query, key) pair are ~0.02
// ms at the tensor-core rate.  The first version lost ~40x to that: one
// block per query position re-read and widened each page up to 128 times
// element by element into a zero-filled 80 KB bf16 copy, and scores
// round-tripped through shared memory between five barriers a page.  Here
// a key tile arrives once per block, as stored (cp.async,
// double-buffered, rows past the tile's bound zero-filled by the copy),
// and is dequantized in the mma.sync fragments of both dots (mla_page.cuh,
// shared with kernel A).  Warp (row tile t, part p) of 8 takes position
// t's 16 rows over a quarter of F: its partial scores meet the other
// three quarters' in shared memory and are summed in a fixed order, so
// all four warps hold the same full scores and softmax statistics in
// registers; p, rounded to bf16, is the A operand of the value dot
// straight from the score accumulator (FA2), and the f32 output [32, F] is
// split over the warps by F quarters (80 registers a thread at F = 640).
// Two barriers a key tile.
//
// Blocks per SM: one.  The q tile (41 KB), two int8 key tiles of 64 rows
// (82 KB) and the score exchange (36 KB) take ~159 KB of shared memory at
// F = 640; two blocks would need either a single buffer or half the q
// tile.  Eight warps a block keep two warps on each scheduler.
#include "common.cuh"
#include "mla_page.cuh"

namespace {

using llmd::bf16;

constexpr int kThreads = 256;            // 8 warps
constexpr int R = llmd::kMlaMaxHeads;    // head rows of a position (m16)
constexpr int kTQ = 2;                   // query positions of a block
constexpr int kM = kTQ * R;              // rows of a block
constexpr int kParts = 8 / kTQ;          // F parts (warps per row tile)
constexpr int kMaxGroups = 6;            // 32-column groups a part: F <= 768
constexpr int kMaxSmem = 232448;         // dynamic shared memory of a block

// Dynamic shared memory, each part 128-byte aligned:
//   q [kM, F+8] bf16 | 2 key tiles [kt, F*esz + 16] | 2 scales [kt, SW]
//   f32 | partial scores [kParts, kM, kt+8] f32.
struct PrefillSmem {
  size_t q, tile, tile_bytes, scl, xs, total;
  __host__ __device__ PrefillSmem(int F, int kt, int SW, int esz) {
    q = 0;
    tile = llmd::mla_align128(q + (size_t)kM * (F + 8) * 2);
    tile_bytes = (size_t)kt * (F * esz + 16);
    scl = llmd::mla_align128(tile + 2 * tile_bytes);
    xs = llmd::mla_align128(scl + (esz == 1 ? (size_t)2 * kt * SW * 4 : 0));
    total = xs + (size_t)kParts * kM * (kt + 8) * 4;
  }
};

template <bool QUANT, int KT>
__global__ void __launch_bounds__(kThreads, 1)
mla_prefill_kernel(const bf16* __restrict__ qs, const int* __restrict__ q_pos,
                   const void* cache, const float* cscale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ seq_lens, bf16* __restrict__ out,
                   int Q, int H, int F, int SW, int bs, int B,
                   long long slots, int layer, float scale) {
  constexpr int NTK = KT / 8;            // n8 key tiles of a key tile
  constexpr int LX = KT + 8;             // f32 pitch of the score exchange
  constexpr int esz = QUANT ? 1 : 2;
  extern __shared__ __align__(128) char smem[];
  const int s = blockIdx.y, qi0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rt = warp % kTQ, part = warp / kTQ;
  const long long row0 = (long long)s * Q + qi0;     // first query row
  const int sl = seq_lens[s];
  // Causal bound of this warp's position, and the tile's largest.
  auto bound = [&](int t) {
    return qi0 + t < Q ? max(0, min(sl, q_pos[row0 + t] + 1)) : 0;
  };
  const int my_nk = bound(rt);
  int nk_max = 0;
#pragma unroll
  for (int t = 0; t < kTQ; ++t) nk_max = max(nk_max, bound(t));
  if (nk_max <= 0) {
    for (int t = 0; t < kTQ && qi0 + t < Q; ++t)
      llmd::mla_zero_out(out + (row0 + t) * H * F, H * F);
    return;
  }

  const int RB = F * esz;                // bytes of a cache row
  const int LDP = RB + 16;               // its pitch in shared memory
  const int LQ = F + 8;
  const int group = F / SW;
  const int FP = F / kParts, f0 = part * FP;
  const int* bt_row = block_tables + (long long)s * B;
  const long long plane = (long long)layer * slots;
  const char* cache_plane = static_cast<const char*>(cache) + plane * RB;
  const float* scale_plane = QUANT ? cscale + plane * SW : nullptr;
  const PrefillSmem lay(F, KT, SW, esz);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);

  // Issues the copies of key tile t (keys t*KT ..) into buffer b; rows
  // past the tile's bound are zero-filled (finite: p = 0 multiplies
  // them).  Key `key` lives at slot bt_row[key / bs] * bs + key % bs: a
  // tile inside one page is one run of rows, else each row is looked up.
  auto issue = [&](int t, int b) {
    char* dst = smem + lay.tile + b * lay.tile_bytes;
    const int k0 = t * KT;
    const int nk = min(KT, nk_max - k0);
    const int p0 = k0 / bs, o0 = k0 - p0 * bs;
    const bool one_page = o0 + nk <= bs;
    const long long base = (long long)bt_row[p0] * bs + o0;
    auto slot = [&](int r) -> long long {
      if (one_page) return base + r;
      const int key = k0 + r;
      return (long long)bt_row[key / bs] * bs + key % bs;
    };
    const int chunks = RB / 16;
    for (int i = tid; i < KT * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const bool ok = r < nk;
      llmd::cp_async16(dst + r * LDP + c * 16,
                       cache_plane + (ok ? slot(r) * RB + c * 16 : 0),
                       ok ? 16 : 0);
    }
    if (QUANT) {
      float* sdst = reinterpret_cast<float*>(smem + lay.scl) + b * KT * SW;
      for (int i = tid; i < KT * SW; i += kThreads) {
        const int r = i / SW, c = i - r * SW;
        const bool ok = r < nk;
        llmd::cp_async4(sdst + i, scale_plane + (ok ? slot(r) * SW + c : 0),
                        ok ? 4 : 0);
      }
    }
  };

  issue(0, 0);
  llmd::cp_async_commit();
  // q * scale rounded to bf16; rows of heads past H or positions past Q
  // are zero.
  for (int i = tid; i < kM * F / 8; i += kThreads) {
    const int m = i / (F / 8), c = i - m * (F / 8);
    const int t = m / R, h = m % R;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (qi0 + t < Q && h < H) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          qs + ((row0 + t) * H + h) * F + c * 8);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = llmd::pack_bf16(__uint_as_float(w[j] << 16) * scale,
                               __uint_as_float(w[j] & 0xffff0000u) * scale);
    }
    *reinterpret_cast<uint4*>(q_s + m * LQ + c * 8) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }

  // Running max and sum of rows g and g + 8 of the warp's position (the
  // same in the four warps of a position), and its output columns: group
  // gi, n8 tile j, element e is row g + 8 (e >> 1), column
  // f0 + 32 gi + 4 (2 qd + (e & 1)) + j.
  float m_run[2] = {llmd::kMaxInit, llmd::kMaxInit};
  float l_run[2] = {0.0f, 0.0f};
  float acc[kMaxGroups][4][4];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][j][e] = 0.0f;

  const int n_tiles = (nk_max + KT - 1) / KT;
  for (int pg = 0; pg < n_tiles; ++pg) {
    const int b = pg & 1;
    llmd::cp_async_wait<0>();
    __syncthreads();              // tile pg in; tile pg-1 and xs fully used
    if (pg + 1 < n_tiles) issue(pg + 1, b ^ 1);
    llmd::cp_async_commit();
    const char* tile = smem + lay.tile + b * lay.tile_bytes;
    const float* scl =
        QUANT ? reinterpret_cast<const float*>(smem + lay.scl) + b * KT * SW
              : nullptr;

    // 1. Partial scores [16, KT] of the warp's rows over its F part.
    float sc[NTK][4];
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    for (int kk = f0; kk < f0 + FP; kk += 16) {
      const bf16* qa = q_s + (rt * R + g) * LQ + kk + 2 * qd;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LQ);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LQ + 8);
#pragma unroll
      for (int j = 0; j < NTK; ++j) {
        const int key = j * 8 + g;
        const char* prow = tile + key * LDP;
        const float* rs = QUANT ? scl + key * SW : nullptr;
        llmd::mma_bf16(sc[j], a,
                       llmd::page_pair<QUANT>(prow, rs, kk + 2 * qd, group),
                       llmd::page_pair<QUANT>(prow, rs, kk + 8 + 2 * qd,
                                              group));
      }
    }
    float* xw = xs + (part * kM + rt * R + g) * LX + 2 * qd;
#pragma unroll
    for (int j = 0; j < NTK; ++j) {
      *reinterpret_cast<float2*>(xw + 8 * j) = make_float2(sc[j][0], sc[j][1]);
      *reinterpret_cast<float2*>(xw + 8 * LX + 8 * j) =
          make_float2(sc[j][2], sc[j][3]);
    }
    __syncthreads();

    // 2. Full scores (the parts summed in order), masked at the
    //    position's bound; the tile's max updates the running max, p =
    //    exp(s - m_new), l sums the f32 p, corr rescales what came before.
    const float* xr = xs + (rt * R + g) * LX + 2 * qd;
    float mx[2] = {llmd::kNegInf, llmd::kNegInf};
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          const float2 x = *reinterpret_cast<const float2*>(
              xr + (p * kM + 8 * half) * LX + 8 * j);
          v.x += x.x;
          v.y += x.y;
        }
        const int key = pg * KT + 8 * j + 2 * qd;
        sc[j][2 * half] = key < my_nk ? v.x : llmd::kNegInf;
        sc[j][2 * half + 1] = key + 1 < my_nk ? v.y : llmd::kNegInf;
        mx[half] = fmaxf(mx[half], fmaxf(sc[j][2 * half], sc[j][2 * half + 1]));
      }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(m_run[half], mx[half]);
      corr[half] = expf(m_run[half] - m_new);
      m_run[half] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m_run[e >> 1]);
        sum[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      l_run[half] = l_run[half] * corr[half] + sum[half];
    }

    // 3. acc = acc * corr + bf16(p) [16, KT] . tile [KT, F part].
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][j][e] *= corr[e >> 1];
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      uint32_t a[4];
      a[0] = llmd::pack_bf16(sc[2 * ks][0], sc[2 * ks][1]);
      a[1] = llmd::pack_bf16(sc[2 * ks][2], sc[2 * ks][3]);
      a[2] = llmd::pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
      a[3] = llmd::pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
      const int r0 = ks * 16 + 2 * qd;
      const float* rs = QUANT ? scl + r0 * SW : nullptr;
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        if (gi * 32 >= FP) break;
        const int f = f0 + gi * 32 + 4 * g;
        float v0[4], v1[4], v8[4], v9[4];
        llmd::page_quad<QUANT>(tile + r0 * LDP, rs, f, group, v0);
        llmd::page_quad<QUANT>(tile + (r0 + 1) * LDP,
                               QUANT ? rs + SW : nullptr, f, group, v1);
        llmd::page_quad<QUANT>(tile + (r0 + 8) * LDP,
                               QUANT ? rs + 8 * SW : nullptr, f, group, v8);
        llmd::page_quad<QUANT>(tile + (r0 + 9) * LDP,
                               QUANT ? rs + 9 * SW : nullptr, f, group, v9);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          llmd::mma_bf16(acc[gi][j], a, llmd::pack_bf16(v0[j], v1[j]),
                         llmd::pack_bf16(v8[j], v9[j]));
      }
    }
  }

  // out = acc / l: thread (g, qd) holds columns 8 qd .. 8 qd + 7 of each
  // group for rows g and g + 8.
  if (qi0 + rt >= Q) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int h = g + 8 * half;
    if (h >= H) continue;
    const float l = fmaxf(l_run[half], 1e-30f);
    bf16* o = out + ((row0 + rt) * H + h) * F + f0 + 8 * qd;
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi * 32 >= FP) break;
      uint32_t v[4];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const int e = 2 * half + (c >> 2);
        v[c / 2] = llmd::pack_bf16(acc[gi][c & 3][e] / l,
                                   acc[gi][(c + 1) & 3][e] / l);
      }
      *reinterpret_cast<uint4*>(o + gi * 32) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool QUANT, int KT>
int launch(const void* qs, const void* q_pos, const void* cache,
           const void* cscale, const void* block_tables, const void* seq_lens,
           void* out, int S, int Q, int H, int F, int SW, int bs, int B,
           long long slots, int layer, float scale, size_t smem,
           cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_prefill_kernel<QUANT, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  mla_prefill_kernel<QUANT, KT>
      <<<dim3((Q + kTQ - 1) / kTQ, S), kThreads, smem, stream>>>(
          static_cast<const bf16*>(qs), static_cast<const int*>(q_pos), cache,
          static_cast<const float*>(cscale),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(seq_lens), static_cast<bf16*>(out), Q, H, F,
          SW, bs, B, slots, layer, scale);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int launch_kt(const void* qs, const void* q_pos, const void* cache,
              const void* cscale, const void* block_tables,
              const void* seq_lens, void* out, int S, int Q, int H, int F,
              int SW, int bs, int kt, int B, long long slots, int layer,
              float scale, size_t smem, cudaStream_t st) {
  switch (kt) {
    case 32:
      return launch<QUANT, 32>(qs, q_pos, cache, cscale, block_tables,
                               seq_lens, out, S, Q, H, F, SW, bs, B, slots,
                               layer, scale, smem, st);
    case 64:
      return launch<QUANT, 64>(qs, q_pos, cache, cscale, block_tables,
                               seq_lens, out, S, Q, H, F, SW, bs, B, slots,
                               layer, scale, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qs [S, Q, H, F] bf16 (H <= 16, F % 128 == 0, F <= 768), q_pos [S, Q]
// i32 (-1: pad), the cache plane `layer` of [L, slots, F] int8 (+ [L,
// slots, SW] f32 scales) or bf16 in pages of bs rows, block_tables [S, B]
// and seq_lens [S] i32; out [S, Q, H, F] bf16.  kt (32 or 64) is the
// key tile, independent of bs: the q tile, two key tiles and the score
// exchange must fit a block's shared memory (ops/mla_prefill.key_tile
// picks the largest that does).
LLMD_EXPORT int llmd_mla_prefill(const void* qs, const void* q_pos,
                                 const void* cache, const void* cscale,
                                 const void* block_tables, const void* seq_lens,
                                 void* out, int S, int Q, int H, int F, int SW,
                                 int bs, int kt, int B, long long slots,
                                 int layer, float scale, int quantized,
                                 void* stream) {
  if (S == 0 || Q == 0) return 0;
  if (H > R || F % (32 * kParts) != 0 || F > 32 * kParts * kMaxGroups ||
      bs <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = PrefillSmem(F, kt, SW, quantized ? 1 : 2).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch_kt<true>(qs, q_pos, cache, cscale, block_tables, seq_lens,
                           out, S, Q, H, F, SW, bs, kt, B, slots, layer,
                           scale, smem, st);
  return launch_kt<false>(qs, q_pos, cache, cscale, block_tables, seq_lens,
                          out, S, Q, H, F, SW, bs, kt, B, slots, layer, scale,
                          smem, st);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
