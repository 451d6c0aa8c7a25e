// Kernel B: MLA causal flash prefill over the paged latent cache.
//
// Replaces ops/pallas/mla_prefill.py mla_flash_prefill (TPU).  Read-only:
// the caller scatters this step's rows (and int8 scales) first.  One
// thread block per (sequence, query position), i.e. a query tile of one
// position x H heads; it walks the pages up to the causal bound
// min(seq_len, q_pos + 1) with the page loop in common.cuh
// (mla_attend).  Pad query rows (q_pos == -1) and pad sequences give zeros.
//
// Bound on the H100: at prefill shapes the 4*H*F flops per (query, key)
// pair make it compute-bound (tensor-core rate) once pages are shared by
// a tile of queries; this version keeps one query position per block,
// so every block re-reads and re-dequantizes its pages (L2 serves the
// repeats) while the dots run on the tensor cores.  Multi-query tiles are
// the next step.
#include "common.cuh"

namespace {

using llmd::bf16;

template <bool QUANT>
__global__ void __launch_bounds__(llmd::kMlaThreads)
mla_prefill_kernel(const bf16* __restrict__ qs, const int* __restrict__ q_pos,
                   const void* cache, const float* cscale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ seq_lens, bf16* __restrict__ out,
                   int Q, int H, int F, int SW, int bs, int B, long long slots,
                   int layer, float scale) {
  extern __shared__ __align__(128) char smem[];
  const long long row = blockIdx.x;           // s * Q + qi
  const int s = static_cast<int>(row / Q);
  const int n_keys = min(seq_lens[s], q_pos[row] + 1);
  bf16* o = out + row * H * F;
  if (n_keys <= 0) {
    llmd::mla_zero_out(o, H * F);
    return;
  }
  const int esz = QUANT ? 1 : 2;
  const long long plane = (long long)layer * slots;
  const char* cache_plane = static_cast<const char*>(cache) + plane * F * esz;
  const float* scale_plane = QUANT ? cscale + plane * SW : nullptr;
  llmd::mla_attend<QUANT>(qs + row * H * F, scale, H, F, bs, SW, cache_plane,
                          scale_plane, block_tables + (long long)s * B, n_keys,
                          o, smem);
}

template <bool QUANT>
int launch(const void* qs, const void* q_pos, const void* cache,
           const void* cscale, const void* block_tables, const void* seq_lens,
           void* out, int S, int Q, int H, int F, int SW, int bs, int B,
           long long slots, int layer, float scale, cudaStream_t stream) {
  const size_t smem = llmd::mla_smem_bytes(F, bs);
  cudaError_t err = cudaFuncSetAttribute(
      mla_prefill_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)S * Q;
  mla_prefill_kernel<QUANT><<<(unsigned)rows, llmd::kMlaThreads, smem, stream>>>(
      static_cast<const bf16*>(qs), static_cast<const int*>(q_pos), cache,
      static_cast<const float*>(cscale), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<bf16*>(out), Q, H, F, SW,
      bs, B, slots, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

LLMD_EXPORT int llmd_mla_prefill(const void* qs, const void* q_pos,
                                 const void* cache, const void* cscale,
                                 const void* block_tables, const void* seq_lens,
                                 void* out, int S, int Q, int H, int F, int SW,
                                 int bs, int B, long long slots, int layer,
                                 float scale, int quantized, void* stream) {
  if (S == 0 || Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch<true>(qs, q_pos, cache, cscale, block_tables, seq_lens, out,
                        S, Q, H, F, SW, bs, B, slots, layer, scale, st);
  return launch<false>(qs, q_pos, cache, cscale, block_tables, seq_lens, out, S,
                       Q, H, F, SW, bs, B, slots, layer, scale, st);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
