// Kernel A: MLA paged decode with the new latent row spliced in place.
//
// Replaces ops/pallas/mla_attention.py mla_paged_decode_update (TPU).
// Flash-decoding in two passes:
//   split    one block per (sequence, range of its key tiles).  A key
//            tile is KT keys (the wrapper's `decode_key_tile`: the page
//            when two pages fit beside the q tile, else the largest of
//            128, 64, 32, 16 rows that divides the page and fits), so a
//            tile lies inside one page and its rows are one run of slots
//            block_table[k / bs] * bs + k % bs.  A sequence's n tiles are
//            cut into min(NS, n) ranges of equal size (NS, the grid's
//            second extent, is sized by the wrapper from the batch and the
//            SM count; ranges past a sequence's last tile exit at once).
//            The block attends all H heads over its tiles with the TPU
//            kernel's recurrence -- bf16 q * scale, keys dequantized to
//            bf16, one running max per tile, bf16 p in the value dot, f32
//            sums -- and writes f32 partials: running max m, sum l and the
//            unnormalised [H, F] accumulator.  The block owning the tile of
//            position len-1 also writes the sequence's new latent row
//            (int8 payload + f32 scale, or bf16) into slot
//            block_table[(len-1)/bs]*bs + (len-1)%bs; no other block reads
//            that slot, and this block takes position len-1 from the input
//            row, never from the cache, so the write cannot race a read.
//   combine  one block per (sequence, head) sums the partials in range
//            order with weights exp(m_i - M) (f32, no atomics, so the
//            output repeats bit for bit) and writes bf16.  Rows with
//            seq_len 0 (batch padding) give zeros.
//
// Bound on the H100: bytes.  Per step it reads each live latent row once
// (F + 4 bytes at int8) plus the queries, about 2*H flops per byte, far
// below the card's ~295 flop/byte ridge -- and at small batches the
// latency of the chain of tiles.  The design spreads a sequence's tiles
// over blocks, keeps each int8 tile as int8 in shared memory (16-byte
// cp.async rows, the next tile in flight while this one is multiplied;
// tail rows zero-filled by the copy, no buffer clearing), and widens it
// to bf16 in the mma.sync fragments of both dots: ~110 KB of shared memory
// at F = 640, KT = 64, so two blocks share an SM.  The key tile does not
// depend on the cache's block size, so every page size the wrapper's
// checks admit is served; at int8 pages of 64 rows the tile is the page.
#include "common.cuh"
#include "mla_page.cuh"

namespace {

using llmd::bf16;

constexpr int kThreads = 256;           // 8 warps
constexpr int R = llmd::kMlaMaxHeads;   // heads padded to one m16 tile
constexpr int kMaxSplits = 256;
constexpr int kMaxSmem = 232448;        // dynamic shared memory of a block
constexpr int kMaxGroups = 3;           // 32-column groups a warp: F <= 768

// Dynamic shared memory, each part 128-byte aligned:
//   q [16, F+8] bf16 | 2 key tiles [KT, F*esz + 16] | 2 scales [KT, SW]
//   f32 | scores [KW, 16, KT] f32 | p [16, KT+8] bf16 | m, l, corr [16] f32.
struct DecSmem {
  size_t q, page, page_bytes, scl, s, pb, stats, total;
  __host__ __device__ DecSmem(int F, int kt, int SW, int esz) {
    q = 0;
    page = llmd::mla_align128(q + (size_t)R * (F + 8) * 2);
    page_bytes = (size_t)kt * (F * esz + 16);
    scl = llmd::mla_align128(page + 2 * page_bytes);
    s = llmd::mla_align128(scl + (esz == 1 ? (size_t)2 * kt * SW * 4 : 0));
    pb = llmd::mla_align128(s + (size_t)score_parts(kt) * R * kt * 4);
    stats = llmd::mla_align128(pb + (size_t)R * (kt + 8) * 2);
    total = stats + 3 * R * 4;
  }
  // Warps that share one key tile's score dot (KT < 64: split over F).
  __host__ __device__ static int score_parts(int kt) {
    return kt >= 64 ? 1 : 64 / kt;
  }
};

template <bool QUANT>
__global__ void __launch_bounds__(kThreads, 2)
mla_decode_split_kernel(const bf16* __restrict__ q,
                        const void* __restrict__ row_new,
                        const float* __restrict__ row_scale_new, void* cache,
                        float* cscale, const int* __restrict__ block_tables,
                        const int* __restrict__ seq_lens,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int H, int F, int SW,
                        int bs, int KT, int B, long long slots, int layer,
                        float scale, int NS) {
  extern __shared__ __align__(128) char smem[];
  const int s = blockIdx.x, sp = blockIdx.y;
  const int sl = seq_lens[s];
  if (sl <= 0) return;
  const int n_tiles = (sl + KT - 1) / KT;
  const int ns = min(NS, n_tiles);
  if (sp >= ns) return;
  const int p0 = (int)((long long)sp * n_tiles / ns);
  const int p1 = (int)((long long)(sp + 1) * n_tiles / ns);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  constexpr int esz = QUANT ? 1 : 2;
  const int RB = F * esz;                 // bytes of a cache row
  const int LDP = RB + 16;                // its pitch in shared memory
  const int group = F / SW;
  const int* bt_row = block_tables + (long long)s * B;
  const long long plane = (long long)layer * slots;
  char* cache_plane = static_cast<char*>(cache) + plane * RB;
  float* scale_plane = QUANT ? cscale + plane * SW : nullptr;
  const char* nr = static_cast<const char*>(row_new) + (long long)s * RB;
  const float* nsc = QUANT ? row_scale_new + (long long)s * SW : nullptr;
  const int wp = sl - 1;

  if (sp == ns - 1) {                     // owns the tile of position wp
    const long long slot = (long long)bt_row[wp / bs] * bs + wp % bs;
    for (int i = tid; i < RB; i += kThreads) cache_plane[slot * RB + i] = nr[i];
    if (QUANT)
      for (int i = tid; i < SW; i += kThreads)
        scale_plane[slot * SW + i] = nsc[i];
  }

  const DecSmem lay(F, KT, SW, esz);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  bf16* pb_s = reinterpret_cast<bf16*>(smem + lay.pb);
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);
  float* l_s = m_s + R;
  float* c_s = l_s + R;
  const int LQ = F + 8, LB = KT + 8;

  // Issues the copies of key tile t into buffer b: keys t*KT .. t*KT+KT-1
  // are one run of slots of page (t*KT)/bs (KT divides bs); rows past the
  // live keys are zero-filled (finite: p = 0 multiplies them), and
  // position wp and its scale come from the new row.
  auto issue = [&](int t, int b) {
    char* dst = smem + lay.page + b * lay.page_bytes;
    const int k0 = t * KT;
    const int nk = min(KT, sl - k0);
    const long long base = (long long)bt_row[k0 / bs] * bs + k0 % bs;
    const int chunks = RB / 16;
    for (int i = tid; i < KT * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const char* src = cache_plane;
      int n = 0;
      if (r < nk) {
        n = 16;
        src = k0 + r == wp ? nr : cache_plane + (base + r) * RB;
        src += c * 16;
      }
      llmd::cp_async16(dst + r * LDP + c * 16, src, n);
    }
    if (QUANT) {
      float* sdst = reinterpret_cast<float*>(smem + lay.scl) + b * KT * SW;
      for (int i = tid; i < KT * SW; i += kThreads) {
        const int r = i / SW, c = i - r * SW;
        const float* src = scale_plane;
        int n = 0;
        if (r < nk) {
          n = 4;
          src = (k0 + r == wp ? nsc : scale_plane + (base + r) * SW) + c;
        }
        llmd::cp_async4(sdst + i, src, n);
      }
    }
  };

  issue(p0, 0);
  llmd::cp_async_commit();
  for (int i = tid; i < R * F; i += kThreads) {
    const int h = i / F, f = i - h * F;
    q_s[h * LQ + f] = h < H ? __float2bfloat16(
                                  llmd::bf2f(q[((long long)s * H + h) * F + f]) *
                                  scale)
                            : __float2bfloat16(0.0f);
  }
  for (int i = tid; i < R * LB; i += kThreads) pb_s[i] = __float2bfloat16(0.0f);
  if (tid < R) {
    m_s[tid] = llmd::kMaxInit;
    l_s[tid] = 0.0f;
    c_s[tid] = 1.0f;
  }

  // The warp's share of the value dot: 32-column groups warp + 8 gi.
  // Thread (g, qd) holds n8 tile j's local column g = the group's column
  // 4g + j, so one 32-bit word per page row feeds four tiles.
  float acc[kMaxGroups][4][4];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][j][e] = 0.0f;

  const int NT = KT / 8;                       // n8 key groups of a tile
  const int KW = DecSmem::score_parts(KT);
  for (int pg = p0; pg < p1; ++pg) {
    const int b = (pg - p0) & 1;
    llmd::cp_async_wait<0>();
    __syncthreads();                  // tile pg in; tile pg-1 fully used
    if (pg + 1 < p1) issue(pg + 1, b ^ 1);
    llmd::cp_async_commit();
    const char* page = smem + lay.page + b * lay.page_bytes;
    const float* scl =
        QUANT ? reinterpret_cast<const float*>(smem + lay.scl) + b * KT * SW
              : nullptr;

    // 1. Scores [16, KT] = q [16, F] . tile^T: warp unit u takes key group
    //    u % NT over the F steps k16 = u / NT (mod KW).
    for (int u = warp; u < NT * KW; u += 8) {
      const int nt = u % NT, kp = u / NT;
      const int key = nt * 8 + g;
      const char* prow = page + key * LDP;
      const float* rs = QUANT ? scl + key * SW : nullptr;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k16 = kp; k16 < F / 16; k16 += KW) {
        const int kk = k16 * 16 + 2 * qd;
        const bf16* qa = q_s + g * LQ + kk;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(qa);
        a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LQ);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LQ + 8);
        llmd::mma_bf16(d, a, llmd::page_pair<QUANT>(prow, rs, kk, group),
                       llmd::page_pair<QUANT>(prow, rs, kk + 8, group));
      }
      float* so = s_s + kp * R * KT + nt * 8 + 2 * qd;
      so[g * KT] = d[0];
      so[g * KT + 1] = d[1];
      so[(g + 8) * KT] = d[2];
      so[(g + 8) * KT + 1] = d[3];
    }
    __syncthreads();

    // 2. Online softmax, one warp per head: the tile max updates the
    //    running max, p = exp(s - m_new) (rounded to bf16 for the value
    //    dot; l sums the f32 p), corr rescales what came before.
    const int nk = min(KT, sl - pg * KT);
    for (int h = warp; h < H; h += 8) {
      float mx = llmd::kNegInf;
      for (int r = lane; r < KT; r += 32) {
        float sv = 0.0f;
        for (int kp = 0; kp < KW; ++kp) sv += s_s[(kp * R + h) * KT + r];
        sv = r < nk ? sv : llmd::kNegInf;
        s_s[h * KT + r] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = llmd::warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int r = lane; r < KT; r += 32) {
        const float pr = expf(s_s[h * KT + r] - m_new);
        sum += pr;
        pb_s[h * LB + r] = __float2bfloat16(pr);
      }
      sum = llmd::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + bf16(p) [16, KT] . tile [KT, F].
    const float c_lo = c_s[g], c_hi = c_s[g + 8];
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[gi][j][0] *= c_lo;
        acc[gi][j][1] *= c_lo;
        acc[gi][j][2] *= c_hi;
        acc[gi][j][3] *= c_hi;
      }
    for (int kk = 0; kk < KT; kk += 16) {
      const bf16* pa = pb_s + g * LB + kk + 2 * qd;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(pa);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * LB);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * LB + 8);
      const int r0 = kk + 2 * qd;
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        const int f = (warp + 8 * gi) * 32 + 4 * g;
        if ((warp + 8 * gi) * 32 >= F) break;
        float v0[4], v1[4], v8[4], v9[4];
        const float* rs = QUANT ? scl + r0 * SW : nullptr;
        llmd::page_quad<QUANT>(page + r0 * LDP, rs, f, group, v0);
        llmd::page_quad<QUANT>(page + (r0 + 1) * LDP, QUANT ? rs + SW : nullptr,
                               f, group, v1);
        llmd::page_quad<QUANT>(page + (r0 + 8) * LDP,
                               QUANT ? rs + 8 * SW : nullptr, f, group, v8);
        llmd::page_quad<QUANT>(page + (r0 + 9) * LDP,
                               QUANT ? rs + 9 * SW : nullptr, f, group, v9);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          llmd::mma_bf16(acc[gi][j], a, llmd::pack_bf16(v0[j], v1[j]),
                         llmd::pack_bf16(v8[j], v9[j]));
      }
    }
  }

  // Partials of this range: the unnormalised accumulator, m and l.
  const long long part = (long long)s * NS + sp;
  float* pa = part_acc + part * H * F;
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    const int f0 = (warp + 8 * gi) * 32;
    if (f0 >= F) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = g + 8 * (e >> 1);
        if (h < H) pa[h * F + f0 + 4 * (2 * qd + (e & 1)) + j] = acc[gi][j][e];
      }
  }
  if (tid < H) {
    part_ml[(part * H + tid) * 2] = m_s[tid];
    part_ml[(part * H + tid) * 2 + 1] = l_s[tid];
  }
}

// out[s, h, :] = sum_i w_i acc_i / sum_i w_i l_i, w_i = exp(m_i - max m),
// over the sequence's ranges in order.
__global__ void __launch_bounds__(128)
mla_decode_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ seq_lens,
                          bf16* __restrict__ out, int H, int F, int KT,
                          int NS) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float inv_l;
  const int s = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  bf16* o = out + ((long long)s * H + h) * F;
  const int sl = seq_lens[s];
  if (sl <= 0) {
    for (int f = tid; f < F; f += blockDim.x) o[f] = __float2bfloat16(0.0f);
    return;
  }
  const int ns = min(NS, (sl + KT - 1) / KT);
  const float* ml = part_ml + ((long long)s * NS * H + h) * 2;  // stride H*2
  if (tid < 32) {
    float mx = llmd::kMaxInit;
    for (int i = tid; i < ns; i += 32) mx = fmaxf(mx, ml[(long long)i * H * 2]);
    mx = llmd::warp_max(mx);
    float l = 0.0f;
    for (int i = tid; i < ns; i += 32) {
      const float w = expf(ml[(long long)i * H * 2] - mx);
      w_s[i] = w;
      l += w * ml[(long long)i * H * 2 + 1];
    }
    l = llmd::warp_sum(l);
    if (tid == 0) inv_l = 1.0f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* pa = part_acc + ((long long)s * NS * H + h) * F;
  for (int f = tid; f < F; f += blockDim.x) {
    float a = 0.0f;
    for (int i = 0; i < ns; ++i) a += w_s[i] * pa[(long long)i * H * F + f];
    o[f] = __float2bfloat16(a * inv_l);
  }
}

template <bool QUANT>
int launch(const void* q, const void* row_new, const void* row_scale_new,
           void* cache, void* cscale, const void* block_tables,
           const void* seq_lens, void* out, float* part_acc, float* part_ml,
           int S, int H, int F, int SW, int bs, int KT, int B,
           long long slots, int layer, float scale, int NS, size_t smem,
           cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_split_kernel<QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  mla_decode_split_kernel<QUANT><<<dim3(S, NS), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), row_new,
      static_cast<const float*>(row_scale_new), cache,
      static_cast<float*>(cscale), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), part_acc, part_ml, H, F, SW, bs, KT,
      B, slots, layer, scale, NS);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine_kernel<<<dim3(S, H), 128, 0, stream>>>(
      part_acc, part_ml, static_cast<const int*>(seq_lens),
      static_cast<bf16*>(out), H, F, KT, NS);
  return (int)cudaGetLastError();
}

}  // namespace

// q [S, H, F] bf16 (H <= 16, F % 32 == 0, F <= 768); row_new [S, F] and
// row_scale_new [S, SW] f32 (int8) or bf16; the cache plane `layer` of
// [L, slots, F] (+ [L, slots, SW] f32 scales); block_tables [S, B] and
// seq_lens [S] int32; out [S, H, F] bf16; f32 scratch `part` of
// S * NS * H * (F + 2) floats (the [S, NS, H, F] accumulators, then the
// [S, NS, H, 2] running max and sum), NS <= 256.  The key tile kt divides
// bs, is a multiple of 16, and two tile buffers fit in a block's shared
// memory.
LLMD_EXPORT int llmd_mla_decode(const void* q, const void* row_new,
                                const void* row_scale_new, void* cache,
                                void* cscale, const void* block_tables,
                                const void* seq_lens, void* out, void* part,
                                int S, int H, int F, int SW, int bs, int kt,
                                int B, long long slots, int layer, float scale,
                                int quantized, int NS, void* stream) {
  if (S == 0) return 0;
  if (H > R || F % 32 != 0 || F > 32 * 8 * kMaxGroups || kt % 16 != 0 ||
      kt < 16 || bs % kt != 0 || NS < 1 || NS > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const size_t smem = DecSmem(F, kt, SW, quantized ? 1 : 2).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(part);
  float* part_ml = part_acc + (long long)S * NS * H * F;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch<true>(q, row_new, row_scale_new, cache, cscale, block_tables,
                        seq_lens, out, part_acc, part_ml, S, H, F, SW, bs, kt,
                        B, slots, layer, scale, NS, smem, st);
  return launch<false>(q, row_new, row_scale_new, cache, cscale, block_tables,
                       seq_lens, out, part_acc, part_ml, S, H, F, SW, bs, kt,
                       B, slots, layer, scale, NS, smem, st);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
