// Kernel H: dense (GQA) causal flash prefill over the paged K/V cache.
//
// Replaces ops/pallas/flash_prefill.py flash_prefill_paged (TPU).  One
// thread block per (sequence, query tile, KV head): the tile holds
// P = 64 / G query positions times the G heads that share the KV head
// (64 rows, one tensor-core row tile per 16).  The block walks the
// sequence's pages only up to the tile's causal bound min(seq_len,
// max q_pos + 1) (common.cuh gqa_attend), dequantizing int8 pages with
// their per-token or per-head scales and applying the optional soft cap.
// Read-only: the caller scattered this step's rows and scales first.  Pad
// rows (q_pos -1) and pad sequences (seq_len 0) give zeros.
//
// Bound on the H100: operations at prefill shapes (4*D flops per head per
// causal (query, key) pair against 2*D bytes per key and KV head).  Each
// page is loaded once per block for its G*P rows; query tiles of one
// sequence re-read the same pages (from L2), and the page loads are not
// yet pipelined against the dots.
#include "common.cuh"

namespace {

using llmd::bf16;

constexpr int kRows = 64;

template <bool QUANT>
__global__ void __launch_bounds__(llmd::kGqaThreads)
flash_prefill_kernel(const bf16* __restrict__ qs, const int* __restrict__ q_pos,
                     const void* k_cache, const void* v_cache,
                     const float* k_scale, const float* v_scale,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ seq_lens, bf16* __restrict__ out,
                     int Q, int H, int KVH, int D, int SW, int bs, int B,
                     long long slots, int layer, float scale,
                     float soft_cap) {
  extern __shared__ __align__(128) char smem[];
  const int s = blockIdx.x;
  const int kh = blockIdx.z;
  const int G = H / KVH;
  const int P = kRows / G;
  const int q0 = blockIdx.y * P;
  const int n_pos = min(P, Q - q0);
  const int F = KVH * D;
  const int esz = QUANT ? 1 : 2;
  const long long plane = (long long)layer * slots;
  const long long row0 = (((long long)s * Q + q0) * H + (long long)kh * G) * D;
  llmd::gqa_attend<QUANT>(
      qs + row0, out + row0, (long long)H * D, G, n_pos,
      q_pos + (long long)s * Q + q0, scale, soft_cap, kRows, D, bs,
      static_cast<const char*>(k_cache) + plane * F * esz,
      static_cast<const char*>(v_cache) + plane * F * esz,
      F, kh * D, QUANT ? k_scale + plane * SW : nullptr,
      QUANT ? v_scale + plane * SW : nullptr, SW, SW > 1 ? kh : 0,
      block_tables + (long long)s * B, seq_lens[s], -1, nullptr, nullptr,
      nullptr, nullptr, smem);
}

template <bool QUANT>
int launch(const void* qs, const void* q_pos, const void* k_cache,
           const void* v_cache, const void* k_scale, const void* v_scale,
           const void* block_tables, const void* seq_lens, void* out, int S,
           int Q, int H, int KVH, int D, int SW, int bs, int B,
           long long slots, int layer, float scale, float soft_cap,
           cudaStream_t stream) {
  const size_t smem = llmd::GqaSmem(kRows, D, bs).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int P = kRows / (H / KVH);
  flash_prefill_kernel<QUANT><<<dim3(S, (Q + P - 1) / P, KVH),
                                llmd::kGqaThreads, smem, stream>>>(
      static_cast<const bf16*>(qs), static_cast<const int*>(q_pos), k_cache,
      v_cache, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<bf16*>(out), Q, H, KVH,
      D, SW, bs, B, slots, layer, scale, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// qs [S, Q, H, D] bf16; q_pos [S, Q] i32 (pad -1); k/v_cache
// [L, slots, KVH*D] (int8 or bf16); k/v_scale [L, slots, SW] f32 (int8
// only, SW 1 or KVH); block_tables [S, B] i32; seq_lens [S] i32; out
// [S, Q, H, D] bf16.  soft_cap <= 0 means none.  H / KVH <= 64.
LLMD_EXPORT int llmd_flash_prefill(
    const void* qs, const void* q_pos, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* seq_lens, void* out, int S, int Q,
    int H, int KVH, int D, int SW, int bs, int B, long long slots, int layer,
    float scale, float soft_cap, int quantized, void* stream) {
  if (S == 0 || Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch<true>(qs, q_pos, k_cache, v_cache, k_scale, v_scale,
                        block_tables, seq_lens, out, S, Q, H, KVH, D, SW, bs,
                        B, slots, layer, scale, soft_cap, st);
  return launch<false>(qs, q_pos, k_cache, v_cache, k_scale, v_scale,
                       block_tables, seq_lens, out, S, Q, H, KVH, D, SW, bs, B,
                       slots, layer, scale, soft_cap, st);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
