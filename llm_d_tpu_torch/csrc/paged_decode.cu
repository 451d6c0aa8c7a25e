// Kernel G: dense (GQA) paged decode with the new K/V row spliced in place.
//
// Replaces ops/pallas/paged_attention.py paged_attention_decode_update
// (TPU).  One thread block per (sequence, KV head):
//   * writes the KV head's D columns of the sequence's new K and V rows
//     (int8 payload, or bf16) into slot block_table[(len-1)/bs]*bs +
//     (len-1)%bs of the layer plane, and the new rows' scales (per-head
//     scales by the head's block, a per-token scale by the block of KV
//     head 0).  No other block reads those columns of that slot, and this
//     block takes position len-1 from the input rows, never from the
//     cache, so the write cannot race a read;
//   * attends the G query heads of the KV head over the sequence's pages
//     (common.cuh gqa_attend), dequantizing int8 pages with their
//     per-token or per-head f32 scales.  Rows with seq_len 0 (batch
//     padding) write nothing and return zeros.
// The TPU kernel's zero-expanded [H, KVH*D] queries and its sequence
// grouping were TPU devices (128-lane DMA slices, launch amortisation) and
// are dropped: a block reads only its KV head's columns.
//
// Bound on the H100: bytes.  Each live key costs 2*D bytes of K and V per
// KV head (int8; 4*D in bf16) plus scales and serves G heads at 4*D flops
// each, far below the card's ~295 flop/byte ridge.  The G <= 16 heads sit
// in one 16-row tensor-core tile (4 of 16 rows live for llama3-1b), and a
// sequence's pages are not split across blocks: flash-decoding is the
// next step for long contexts at small batches.
#include "common.cuh"

namespace {

using llmd::bf16;

constexpr int kRows = 16;

template <bool QUANT>
__global__ void __launch_bounds__(llmd::kGqaThreads)
paged_decode_kernel(const bf16* __restrict__ q, const void* __restrict__ k_new,
                    const void* __restrict__ v_new,
                    const float* __restrict__ ks_new,
                    const float* __restrict__ vs_new, void* k_cache,
                    void* v_cache, float* k_scale, float* v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, bf16* __restrict__ out,
                    int H, int KVH, int D, int SW, int bs, int B,
                    long long slots, int layer, float scale) {
  extern __shared__ __align__(128) char smem[];
  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / KVH;
  const int F = KVH * D;
  const int sl = seq_lens[s];
  bf16* o = out + ((long long)s * H + (long long)kh * G) * D;
  if (sl <= 0) {
    llmd::mla_zero_out(o, G * D);
    return;
  }
  const int esz = QUANT ? 1 : 2;
  const int* bt_row = block_tables + (long long)s * B;
  const long long plane = (long long)layer * slots;
  char* kp = static_cast<char*>(k_cache) + plane * F * esz;
  char* vp = static_cast<char*>(v_cache) + plane * F * esz;
  float* ksp = QUANT ? k_scale + plane * SW : nullptr;
  float* vsp = QUANT ? v_scale + plane * SW : nullptr;
  const int col0 = kh * D;
  const int scol = SW > 1 ? kh : 0;
  const char* kn = static_cast<const char*>(k_new) +
                   ((long long)s * F + col0) * esz;
  const char* vn = static_cast<const char*>(v_new) +
                   ((long long)s * F + col0) * esz;
  const float* ksn = QUANT ? ks_new + (long long)s * SW + scol : nullptr;
  const float* vsn = QUANT ? vs_new + (long long)s * SW + scol : nullptr;

  const int wp = sl - 1;
  const long long slot = (long long)bt_row[wp / bs] * bs + wp % bs;
  const long long off = (slot * F + col0) * esz;
  for (int i = threadIdx.x; i < D * esz; i += blockDim.x) {
    kp[off + i] = kn[i];
    vp[off + i] = vn[i];
  }
  if (QUANT && threadIdx.x == 0 && (SW > 1 || kh == 0)) {
    ksp[slot * SW + scol] = *ksn;
    vsp[slot * SW + scol] = *vsn;
  }

  llmd::gqa_attend<QUANT>(q + ((long long)s * H + (long long)kh * G) * D, o,
                          0, G, 1, nullptr, scale, 0.0f, kRows, D, bs, kp, vp,
                          F, col0, ksp, vsp, SW, scol, bt_row, sl, wp, kn, vn,
                          ksn, vsn, smem);
}

template <bool QUANT>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* ks_new, const void* vs_new, void* k_cache,
           void* v_cache, void* k_scale, void* v_scale,
           const void* block_tables, const void* seq_lens, void* out, int S,
           int H, int KVH, int D, int SW, int bs, int B, long long slots,
           int layer, float scale, cudaStream_t stream) {
  const size_t smem = llmd::GqaSmem(kRows, D, bs).total;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<QUANT><<<dim3(S, KVH), llmd::kGqaThreads, smem,
                               stream>>>(
      static_cast<const bf16*>(q), k_new, v_new,
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      k_cache, v_cache, static_cast<float*>(k_scale),
      static_cast<float*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<bf16*>(out), H, KVH, D,
      SW, bs, B, slots, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [S, H, D] bf16; k/v_new [S, KVH*D] in the cache dtype; ks/vs_new
// [S, SW] f32 (int8 only); k/v_cache [L, slots, KVH*D]; k/v_scale
// [L, slots, SW] f32 (int8 only); block_tables [S, B] i32; seq_lens [S]
// i32 including the new token; out [S, H, D] bf16.  SW is 1 or KVH.
LLMD_EXPORT int llmd_paged_decode(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_cache, void* v_cache, void* k_scale,
    void* v_scale, const void* block_tables, const void* seq_lens, void* out,
    int S, int H, int KVH, int D, int SW, int bs, int B, long long slots,
    int layer, float scale, int quantized, void* stream) {
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch<true>(q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                        k_scale, v_scale, block_tables, seq_lens, out, S, H,
                        KVH, D, SW, bs, B, slots, layer, scale, st);
  return launch<false>(q, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                       k_scale, v_scale, block_tables, seq_lens, out, S, H,
                       KVH, D, SW, bs, B, slots, layer, scale, st);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
