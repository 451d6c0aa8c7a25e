// Kernel G: dense (GQA) paged decode with the new K/V rows spliced in place.
//
// Replaces ops/pallas/paged_attention.py paged_attention_decode_update
// (TPU).  Flash-decoding in two passes:
//   split    one block of four warps per (sequence, group of WH KV heads,
//            range of the sequence's key tiles).  Warp w takes KV head
//            w % WH of the group and, when WH < 4, the key part w / WH of
//            WK = 4 / WH (every WK-th m16 key slice of each tile), so a
//            block always has four warps and reads WH heads' columns of
//            each key row contiguously.  A key tile is KT keys
//            (ops/paged_attention.decode_plan: sized from D, the cache
//            dtype and WH, never from the block size); key k lives at
//            slot block_table[k / bs] * bs + k % bs.  A sequence's n
//            tiles are cut into min(NS, n) ranges of equal size (NS, the
//            grid's third extent, is sized by the wrapper from shapes
//            only; ranges past a sequence's last tile exit at once).  The
//            warp keeps the TPU kernel's recurrence -- bf16 q * scale,
//            keys dequantized to bf16, one running-max update per key
//            tile, bf16 p in the value dot, f32 sums -- and writes f32
//            partials: running max m, sum l and the unnormalised [G, D]
//            accumulator.  The block of the last range also writes the
//            group's columns of the sequence's new K and V rows (int8
//            payload, or bf16) into slot block_table[(len-1)/bs]*bs +
//            (len-1)%bs, with their scales (per-head scales by each head's
//            group, a per-token scale by group 0).  No other block reads
//            those columns of that slot, and every block takes position
//            len-1 (and its scales) from the input rows, never from the
//            cache, so the write cannot race a read.
//   combine  one block per (sequence, head) sums the partials in range
//            order with weights exp(m_i - M) (f32, no atomics, so the
//            output repeats bit for bit) and writes bf16.  Rows with
//            seq_len 0 (batch padding) give zeros.
//
// Both dots run on the tensor cores (mma.sync m16n8k16) with the keys on
// the m16 side and the G <= 16 heads of a KV head on the n8 side (one or
// two n8 tiles): scores S^T = K . (q * scale)^T, so no row of the product
// is padding whatever G is (a 16-row head tile would be 4/16 live at
// llama3-1b's G = 4).  The score accumulator, transposed in registers by
// movmatrix, is the B operand of the value dot O^T = V^T . P^T, whose m16
// side is D.  bf16 tiles reach both dots through ldmatrix (V transposed);
// int8 ones are widened in the fragments, the value dot's m16 tile t of a
// 64-column chunk taking row g from column 4g + t, so one 32-bit word per
// key row feeds four tiles.  Scores, p and the softmax statistics never
// leave registers.  Packing the heads of several KV heads into one tile would
// not work: the columns of one mma share its A operand, and each KV head
// has its own K.
//
// Bound on the H100: bytes.  Each live key costs 2*D bytes of K and V per
// KV head (int8, plus scales; 4*D in bf16) and serves G heads at 4*D flops
// each, far below the card's ~295 flop/byte ridge.  Tiles arrive as
// stored through a three-stage cp.async ring (rows past the sequence
// zero-filled by the copy, no buffer cleared) and int8 is widened in the
// fragments of both dots, with the row's or the KV head's scale.
#include "common.cuh"

namespace {

using llmd::bf16;

constexpr int kThreads = 128;            // four warps
constexpr int kStages = 3;
constexpr int kMaxSplits = 256;
constexpr int kMaxSub = 4;               // m16 key slices of a warp a tile
constexpr int kMaxSmem = 232448;         // dynamic shared memory of a block

// Transposes the 8 x 8 bf16 matrix whose row lane / 4, columns
// 2 (lane % 4), +1 this thread holds in x: returns row lane / 4 of the
// transpose.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// One ring stage, each part 128-byte aligned: K and V tiles [KT, RB + 16]
// bytes (RB = WH * D * esz, the group's columns of a row), then for int8
// their [KT, NSC] f32 scales.
struct StageLayout {
  int ldp, v, ks, vs, bytes;
  __host__ __device__ StageLayout(int kt, int RB, int nsc, bool quant) {
    ldp = RB + 16;
    v = (int)llmd::mla_align128((size_t)kt * ldp);
    ks = (int)llmd::mla_align128((size_t)v + (size_t)kt * ldp);
    vs = ks + (quant ? (int)llmd::mla_align128((size_t)kt * nsc * 4) : 0);
    bytes = vs + (quant ? (int)llmd::mla_align128((size_t)kt * nsc * 4) : 0);
  }
};

// NH n8 tiles of heads (G <= 8 NH), DC 64-column chunks of D.
template <bool QUANT, int NH, int DC>
__global__ void __launch_bounds__(kThreads)
gqa_decode_split_kernel(const bf16* __restrict__ q,
                        const void* __restrict__ k_new,
                        const void* __restrict__ v_new,
                        const float* __restrict__ ks_new,
                        const float* __restrict__ vs_new, void* k_cache,
                        void* v_cache, float* k_scale, float* v_scale,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ seq_lens,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int H, int KVH, int SW,
                        int bs, int KT, int WH, int B, long long slots,
                        int layer, float scale, int NS) {
  constexpr int D = 64 * DC;
  constexpr int esz = QUANT ? 1 : 2;
  extern __shared__ __align__(128) char smem[];
  const int s = blockIdx.x, grp = blockIdx.y, sp = blockIdx.z;
  const int sl = seq_lens[s];
  if (sl <= 0) return;
  const int n_tiles = (sl + KT - 1) / KT;
  const int ns = min(NS, n_tiles);
  if (sp >= ns) return;
  const int t0 = (int)((long long)sp * n_tiles / ns);
  const int t1 = (int)((long long)(sp + 1) * n_tiles / ns);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int WK = 4 / WH;
  const int hw = warp % WH, part = warp / WH;
  const int G = H / KVH;
  const int F = KVH * D;
  const int kh0 = grp * WH, kh = kh0 + hw;
  const int RB = WH * D * esz;
  const int nsc = SW > 1 ? WH : 1;       // scale columns of the group
  const int scol0 = SW > 1 ? kh0 : 0;
  const int* bt_row = block_tables + (long long)s * B;
  const long long plane = (long long)layer * slots;
  char* kp = static_cast<char*>(k_cache) + plane * F * esz;
  char* vp = static_cast<char*>(v_cache) + plane * F * esz;
  float* ksp = QUANT ? k_scale + plane * SW : nullptr;
  float* vsp = QUANT ? v_scale + plane * SW : nullptr;
  const long long col = (long long)kh0 * D * esz;
  const long long new_row = (long long)s * F * esz + col;
  const char* kn = static_cast<const char*>(k_new) + new_row;
  const char* vn = static_cast<const char*>(v_new) + new_row;
  const float* ksn = QUANT ? ks_new + (long long)s * SW + scol0 : nullptr;
  const float* vsn = QUANT ? vs_new + (long long)s * SW + scol0 : nullptr;
  const int wp = sl - 1;

  if (sp == ns - 1) {                    // owns the tile of position wp
    const long long off =
        ((long long)bt_row[wp / bs] * bs + wp % bs) * F * esz + col;
    for (int i = tid; i < RB / 16; i += kThreads) {
      reinterpret_cast<uint4*>(kp + off)[i] =
          reinterpret_cast<const uint4*>(kn)[i];
      reinterpret_cast<uint4*>(vp + off)[i] =
          reinterpret_cast<const uint4*>(vn)[i];
    }
    if (QUANT && (SW > 1 || grp == 0) && tid < nsc) {
      const long long so =
          ((long long)bt_row[wp / bs] * bs + wp % bs) * SW + scol0 + tid;
      ksp[so] = ksn[tid];
      vsp[so] = vsn[tid];
    }
  }

  const StageLayout lay(KT, RB, nsc, QUANT);
  auto issue = [&](int t, int stage) {
    char* st = smem + stage * lay.bytes;
    const int k0 = t * KT;
    llmd::gqa_issue_tile<QUANT>(
        st, st + lay.v, reinterpret_cast<float*>(st + lay.ks),
        reinterpret_cast<float*>(st + lay.vs), KT, lay.ldp, RB, k0,
        min(KT, sl - k0), kp, vp, (long long)F * esz, col, ksp, vsp, SW,
        scol0, nsc, bt_row, bs, wp, kn, vn, ksn, vsn);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t0 + i < t1) issue(t0 + i, i);
    llmd::cp_async_commit();
  }

  // q * scale rounded to bf16 as the B operand of the score dot: head
  // nh * 8 + g of the KV head, columns 16 k + 2 qd (+1) and +8 (heads
  // past G are zero).
  uint32_t qb[D / 16][NH][2];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) {
    const int hh = nh * 8 + g;
    const bf16* qr = q + ((long long)s * H + (long long)kh * G + hh) * D;
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        uint32_t v = 0u;
        if (hh < G) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              qr + 16 * k + 8 * h8 + 2 * qd);
          v = llmd::pack_bf16(__uint_as_float(w << 16) * scale,
                              __uint_as_float(w & 0xffff0000u) * scale);
        }
        qb[k][nh][h8] = v;
      }
  }

  // Statistics of heads nh * 8 + 2 qd + e (the same in the eight lanes of
  // one qd); acc[c][t][nh][e] is O^T at head nh * 8 + 2 qd + (e & 1) and,
  // for bf16 tiles (read by ldmatrix), column 16 (4 c + t) + g + 8 (e >> 1),
  // for int8 ones (read as words of four columns) column 64 c + 32 (e >> 1)
  // + 4 g + t.
  float m_run[NH][2], l_run[NH][2];
  float acc[DC][4][NH][4];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m_run[nh][e] = llmd::kMaxInit;
      l_run[nh][e] = 0.0f;
    }
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][t][nh][e] = 0.0f;

  const int nsub = KT / 16 / WK;
  const int hcol = hw * D * esz;         // the warp's head in a tile row
  const int hsc = nsc > 1 ? hw : 0;      // its scale column
  // ldmatrix row addresses of this lane in a bf16 tile (bytes): matrix
  // lane / 8, row lane % 8 -- K: keys 8 (mi % 2) + row, columns 8 (mi / 2);
  // V (transposed): keys 8 (mi / 2) + row, columns 8 (mi % 2).
  const int mi = lane >> 3, mr = lane & 7;
  const int k_lane = (8 * (mi & 1) + mr) * lay.ldp + 16 * (mi >> 1);
  const int v_lane = (8 * (mi >> 1) + mr) * lay.ldp + 16 * (mi & 1);
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    llmd::cp_async_wait<kStages - 2>();
    __syncthreads();                     // tile t in; tile t-1 fully used
    if (t + kStages - 1 < t1) issue(t + kStages - 1, (i + kStages - 1) % kStages);
    llmd::cp_async_commit();
    const char* st = smem + (i % kStages) * lay.bytes;
    const char* ktile = st + hcol;
    const char* vtile = st + lay.v + hcol;
    const float* kscl = QUANT ? reinterpret_cast<const float*>(st + lay.ks) + hsc
                              : nullptr;
    const float* vscl = QUANT ? reinterpret_cast<const float*>(st + lay.vs) + hsc
                              : nullptr;
    const int k0 = t * KT;

    // 1. Scores S^T [16 keys, 8 NH heads] of each of the warp's slices.
    float sc[kMaxSub][NH][4];
    float mx[NH][2];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) mx[nh][0] = mx[nh][1] = llmd::kNegInf;
#pragma unroll
    for (int jj = 0; jj < kMaxSub; ++jj) {
      const int kb = (part + WK * jj) * 16;
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jj][nh][e] = 0.0f;
      if (jj >= nsub || k0 + kb >= sl) continue;
      const char* r0 = ktile + (kb + g) * lay.ldp;
      const char* r8 = r0 + 8 * lay.ldp;
      const float* s0 = QUANT ? kscl + (kb + g) * nsc : nullptr;
      const float* s8 = QUANT ? s0 + 8 * nsc : nullptr;
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int f = 16 * k + 2 * qd;
        uint32_t a[4];
        if (QUANT) {
          a[0] = llmd::page_pair<true>(r0, s0, f, D);
          a[1] = llmd::page_pair<true>(r8, s8, f, D);
          a[2] = llmd::page_pair<true>(r0, s0, f + 8, D);
          a[3] = llmd::page_pair<true>(r8, s8, f + 8, D);
        } else {
          llmd::ldmatrix_x4(a, ktile + kb * lay.ldp + 32 * k + k_lane);
        }
#pragma unroll
        for (int nh = 0; nh < NH; ++nh)
          llmd::mma_bf16(sc[jj][nh], a, qb[k][nh][0], qb[k][nh][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = k0 + kb + g + 8 * (e >> 1) < sl;
#pragma unroll
        for (int nh = 0; nh < NH; ++nh) {
          sc[jj][nh][e] = live ? sc[jj][nh][e] : llmd::kNegInf;
          mx[nh][e & 1] = fmaxf(mx[nh][e & 1], sc[jj][nh][e]);
        }
      }
    }

    // 2. One running-max update for the tile; p = exp(s - m_new), l sums
    //    the f32 p, corr rescales what came before.
    float corr[NH][2];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = mx[nh][e];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
        const float m_new = fmaxf(m_run[nh][e], v);
        corr[nh][e] = __expf(m_run[nh][e] - m_new);
        m_run[nh][e] = m_new;
        l_run[nh][e] *= corr[nh][e];
      }
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
#pragma unroll
        for (int nh = 0; nh < NH; ++nh)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][tt][nh][e] *= corr[nh][e & 1];

    // 3. acc += V^T [D, 16 keys] . bf16(p)^T [16 keys, 8 NH heads].
#pragma unroll
    for (int jj = 0; jj < kMaxSub; ++jj) {
      const int kb = (part + WK * jj) * 16;
      if (jj >= nsub || k0 + kb >= sl) continue;
      uint32_t b[NH][2];
#pragma unroll
      for (int nh = 0; nh < NH; ++nh) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = __expf(sc[jj][nh][e] - m_run[nh][e & 1]);
          l_run[nh][e & 1] += p[e];
        }
        b[nh][0] = movmatrix_trans(llmd::pack_bf16(p[0], p[1]));
        b[nh][1] = movmatrix_trans(llmd::pack_bf16(p[2], p[3]));
      }
      if (QUANT) {
        const int r = kb + 2 * qd;
        const char* v0 = vtile + r * lay.ldp;
        const float* vs0 = vscl + r * nsc;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          // [keys (0, 1) or (8, 9)][columns lo or hi][t]
          uint32_t pr[2][2][4];
#pragma unroll
          for (int k8 = 0; k8 < 2; ++k8)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
              llmd::row_pairs<true>(
                  v0 + 8 * k8 * lay.ldp, v0 + (8 * k8 + 1) * lay.ldp,
                  vs0 + 8 * k8 * nsc, vs0 + (8 * k8 + 1) * nsc,
                  64 * c + 32 * hi + 4 * g, D, pr[k8][hi]);
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            const uint32_t a[4] = {pr[0][0][tt], pr[0][1][tt], pr[1][0][tt],
                                   pr[1][1][tt]};
#pragma unroll
            for (int nh = 0; nh < NH; ++nh)
              llmd::mma_bf16(acc[c][tt][nh], a, b[nh][0], b[nh][1]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < DC; ++c)
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            uint32_t a[4];
            llmd::ldmatrix_x4_trans(
                a, vtile + kb * lay.ldp + 32 * (4 * c + tt) + v_lane);
#pragma unroll
            for (int nh = 0; nh < NH; ++nh)
              llmd::mma_bf16(acc[c][tt][nh], a, b[nh][0], b[nh][1]);
          }
      }
    }
  }
  llmd::cp_async_wait<0>();

  // Partials of this (range, key part): the unnormalised accumulator, m
  // and l (summed over the eight lanes of each head).
  const long long pidx = ((long long)s * NS + sp) * WK + part;
  float* pa = part_acc + (pidx * H + (long long)kh * G) * D;
  float* pm = part_ml + (pidx * H + (long long)kh * G) * 2;
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float l = l_run[nh][e];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      const int hh = nh * 8 + 2 * qd + e;
      if (hh >= G) continue;
      if (g == 0) {
        pm[hh * 2] = m_run[nh][e];
        pm[hh * 2 + 1] = l;
      }
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          if (QUANT) {
            *reinterpret_cast<float4*>(pa + hh * D + 64 * c + 32 * hi + 4 * g) =
                make_float4(acc[c][0][nh][e + 2 * hi],
                            acc[c][1][nh][e + 2 * hi],
                            acc[c][2][nh][e + 2 * hi],
                            acc[c][3][nh][e + 2 * hi]);
          } else {
#pragma unroll
            for (int tt = 0; tt < 4; ++tt)
              pa[hh * D + 16 * (4 * c + tt) + g + 8 * hi] =
                  acc[c][tt][nh][e + 2 * hi];
          }
        }
    }
}

// out[s, h, :] = sum_i w_i acc_i / sum_i w_i l_i, w_i = exp(m_i - max m),
// over the sequence's (range, key part) partials in order; one block of
// D threads per (sequence, head).
__global__ void __launch_bounds__(128)
gqa_decode_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ seq_lens,
                          bf16* __restrict__ out, int H, int D, int KT,
                          int NS, int WK) {
  __shared__ float w_s[kMaxSplits * 4];
  __shared__ float inv_l;
  const int s = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  bf16* o = out + ((long long)s * H + h) * D;
  const int sl = seq_lens[s];
  if (sl <= 0) {
    o[tid] = __float2bfloat16(0.0f);
    return;
  }
  const int np = min(NS, (sl + KT - 1) / KT) * WK;
  const long long p0 = (long long)s * NS * WK;
  if (tid < 32) {
    const float* ml = part_ml + (p0 * H + h) * 2;      // stride H * 2
    float mx = llmd::kMaxInit;
    for (int i = tid; i < np; i += 32) mx = fmaxf(mx, ml[(long long)i * H * 2]);
    mx = llmd::warp_max(mx);
    float l = 0.0f;
    for (int i = tid; i < np; i += 32) {
      const float w = expf(ml[(long long)i * H * 2] - mx);
      w_s[i] = w;
      l += w * ml[(long long)i * H * 2 + 1];
    }
    l = llmd::warp_sum(l);
    if (tid == 0) inv_l = 1.0f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* pa = part_acc + (p0 * H + h) * D + tid;  // stride H * D
  float a = 0.0f;
#pragma unroll 4
  for (int i = 0; i < np; ++i) a += w_s[i] * pa[(long long)i * H * D];
  o[tid] = __float2bfloat16(a * inv_l);
}

template <bool QUANT, int NH, int DC>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* ks_new, const void* vs_new, void* k_cache,
           void* v_cache, void* k_scale, void* v_scale,
           const void* block_tables, const void* seq_lens, void* out,
           float* part_acc, float* part_ml, int S, int H, int KVH, int SW,
           int bs, int KT, int WH, int B, long long slots, int layer,
           float scale, int NS, size_t smem, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        gqa_decode_split_kernel<QUANT, NH, DC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  gqa_decode_split_kernel<QUANT, NH, DC>
      <<<dim3(S, KVH / WH, NS), kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), k_new, v_new,
          static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
          k_cache, v_cache, static_cast<float*>(k_scale),
          static_cast<float*>(v_scale), static_cast<const int*>(block_tables),
          static_cast<const int*>(seq_lens), part_acc, part_ml, H, KVH, SW, bs,
          KT, WH, B, slots, layer, scale, NS);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int D = 64 * DC;
  gqa_decode_combine_kernel<<<dim3(S, H), D, 0, stream>>>(
      part_acc, part_ml, static_cast<const int*>(seq_lens),
      static_cast<bf16*>(out), H, D, KT, NS, 4 / WH);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int launch_shape(int NH, int DC, const void* q, const void* k_new,
                 const void* v_new, const void* ks_new, const void* vs_new,
                 void* k_cache, void* v_cache, void* k_scale, void* v_scale,
                 const void* block_tables, const void* seq_lens, void* out,
                 float* part_acc, float* part_ml, int S, int H, int KVH,
                 int SW, int bs, int KT, int WH, int B, long long slots,
                 int layer, float scale, int NS, size_t smem,
                 cudaStream_t st) {
#define LLMD_G_LAUNCH(nh, dc)                                                 \
  if (NH == nh && DC == dc)                                                   \
    return launch<QUANT, nh, dc>(q, k_new, v_new, ks_new, vs_new, k_cache,   \
                                 v_cache, k_scale, v_scale, block_tables,     \
                                 seq_lens, out, part_acc, part_ml, S, H, KVH, \
                                 SW, bs, KT, WH, B, slots, layer, scale, NS,  \
                                 smem, st);
  LLMD_G_LAUNCH(1, 1)
  LLMD_G_LAUNCH(1, 2)
  LLMD_G_LAUNCH(2, 1)
  LLMD_G_LAUNCH(2, 2)
#undef LLMD_G_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [S, H, D] bf16 (D 64 or 128, G = H / KVH <= 16); k/v_new [S, KVH*D]
// in the cache dtype; ks/vs_new [S, SW] f32 (int8 only); k/v_cache
// [L, slots, KVH*D]; k/v_scale [L, slots, SW] f32 (int8 only, SW 1 or
// KVH); block_tables [S, B] i32; seq_lens [S] i32 including the new token;
// out [S, H, D] bf16; f32 scratch `part` of S * NS * WK * H * (D + 2)
// floats (the [S, NS, WK, H, D] accumulators, then the [S, NS, WK, H, 2]
// running max and sum), WK = 4 / WH.  The plan (kt, wh, smem) is
// ops/paged_attention.decode_plan's: WH in {1, 2, 4} divides KVH, kt a
// multiple of 16 WK, smem the three ring stages.
LLMD_EXPORT int llmd_paged_decode(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_cache, void* v_cache, void* k_scale,
    void* v_scale, const void* block_tables, const void* seq_lens, void* out,
    void* part, int S, int H, int KVH, int D, int SW, int bs, int kt, int wh,
    int B, long long slots, int layer, float scale, int quantized, int NS,
    void* stream) {
  if (S == 0) return 0;
  const int G = KVH > 0 ? H / KVH : 0;
  if (G < 1 || G > 16 || H != G * KVH || (D != 64 && D != 128) ||
      (wh != 1 && wh != 2 && wh != 4) || KVH % wh != 0 ||
      kt % (16 * (4 / wh)) != 0 || kt / 16 / (4 / wh) > kMaxSub ||
      (SW != 1 && SW != KVH) || bs <= 0 || NS < 1 || NS > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kStages *
      StageLayout(kt, wh * D * (quantized ? 1 : 2), SW > 1 ? wh : 1,
                  quantized != 0).bytes;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(part);
  float* part_ml = part_acc + (long long)S * NS * (4 / wh) * H * D;
  const int NH = (G + 7) / 8, DC = D / 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch_shape<true>(NH, DC, q, k_new, v_new, ks_new, vs_new,
                              k_cache, v_cache, k_scale, v_scale, block_tables,
                              seq_lens, out, part_acc, part_ml, S, H, KVH, SW,
                              bs, kt, wh, B, slots, layer, scale, NS, smem, st);
  return launch_shape<false>(NH, DC, q, k_new, v_new, ks_new, vs_new, k_cache,
                             v_cache, k_scale, v_scale, block_tables,
                             seq_lens, out, part_acc, part_ml, S, H, KVH, SW,
                             bs, kt, wh, B, slots, layer, scale, NS, smem, st);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
