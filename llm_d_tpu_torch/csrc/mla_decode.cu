// Kernel A: MLA paged decode with the new latent row spliced in place.
//
// Replaces ops/pallas/mla_attention.py mla_paged_decode_update (TPU).
// One thread block per sequence:
//   * writes the sequence's new latent row (int8 payload + f32 scale, or
//     bf16) into slot block_table[(len-1)/bs]*bs + (len-1)%bs of the layer
//     plane -- no other block reads that slot, and this block takes
//     position len-1 from the input row, never from the cache, so the
//     write cannot race a read;
//   * attends all H heads over the sequence's pages (common.cuh
//     mla_attend).  Rows with seq_len 0 (batch padding) write nothing and
//     return zeros.
// The TPU kernel's sequence grouping existed to amortise TPU launch
// overhead and is dropped.
//
// Bound on the H100: bytes.  Per step it reads each live latent row once
// (F + 4 bytes at int8) plus the queries, about 2*H*F flops per key-byte
// pair, far below the card's ~295 flop/byte ridge.  This first version
// does not split a sequence's pages across blocks, so a batch of S
// sequences occupies only S SMs; a split-K (flash-decoding) pass is the
// next step when decode batches are small.
#include "common.cuh"

namespace {

using llmd::bf16;

template <bool QUANT>
__global__ void __launch_bounds__(llmd::kMlaThreads)
mla_decode_kernel(const bf16* __restrict__ q, const void* __restrict__ row_new,
                  const float* __restrict__ row_scale_new, void* cache,
                  float* cscale, const int* __restrict__ block_tables,
                  const int* __restrict__ seq_lens, bf16* __restrict__ out,
                  int H, int F, int SW, int bs, int B, long long slots,
                  int layer, float scale) {
  extern __shared__ __align__(128) char smem[];
  const int s = blockIdx.x;
  const int sl = seq_lens[s];
  bf16* o = out + (long long)s * H * F;
  if (sl <= 0) {
    llmd::mla_zero_out(o, H * F);
    return;
  }
  const int esz = QUANT ? 1 : 2;
  const int* bt_row = block_tables + (long long)s * B;
  const long long plane = (long long)layer * slots;
  char* cache_plane = static_cast<char*>(cache) + plane * F * esz;
  float* scale_plane = QUANT ? cscale + plane * SW : nullptr;
  const char* nr = static_cast<const char*>(row_new) + (long long)s * F * esz;
  const float* ns = QUANT ? row_scale_new + (long long)s * SW : nullptr;

  const int wp = sl - 1;
  const long long slot = (long long)bt_row[wp / bs] * bs + wp % bs;
  for (int i = threadIdx.x; i < F * esz; i += blockDim.x)
    cache_plane[slot * F * esz + i] = nr[i];
  if (QUANT)
    for (int i = threadIdx.x; i < SW; i += blockDim.x)
      scale_plane[slot * SW + i] = ns[i];

  llmd::mla_attend<QUANT>(q + (long long)s * H * F, scale, H, F, bs, SW,
                          cache_plane, scale_plane, bt_row, sl, wp, nr, ns, o,
                          smem);
}

template <bool QUANT>
int launch(const void* q, const void* row_new, const void* row_scale_new,
           void* cache, void* cscale, const void* block_tables,
           const void* seq_lens, void* out, int S, int H, int F, int SW, int bs,
           int B, long long slots, int layer, float scale, cudaStream_t stream) {
  const size_t smem = llmd::mla_smem_bytes(F, bs);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mla_decode_kernel<QUANT><<<S, llmd::kMlaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), row_new,
      static_cast<const float*>(row_scale_new), cache,
      static_cast<float*>(cscale), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<bf16*>(out), H, F, SW, bs,
      B, slots, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

LLMD_EXPORT int llmd_mla_decode(const void* q, const void* row_new,
                                const void* row_scale_new, void* cache,
                                void* cscale, const void* block_tables,
                                const void* seq_lens, void* out, int S, int H,
                                int F, int SW, int bs, int B, long long slots,
                                int layer, float scale, int quantized,
                                void* stream) {
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch<true>(q, row_new, row_scale_new, cache, cscale, block_tables,
                        seq_lens, out, S, H, F, SW, bs, B, slots, layer, scale,
                        st);
  return launch<false>(q, row_new, row_scale_new, cache, cscale, block_tables,
                       seq_lens, out, S, H, F, SW, bs, B, slots, layer, scale,
                       st);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
