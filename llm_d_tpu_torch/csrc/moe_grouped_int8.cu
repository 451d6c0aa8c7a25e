// Kernel F: grouped int8 MoE FFN over sorted, padded rows.
//
// Replaces ops/pallas/moe_int8.py grouped_moe_int8 (TPU), the
// LLMD_MOE_PREFILL_KERNEL=grouped lever of the prefill regime.  The glue
// (ops/moe.py) gathers the rows sorted by expert, each expert's run
// padded to the row tile rt (one expert per tile, pad rows zero with zero
// combine weight).  Rows are contiguous, so no gather happens here.  Each
// rt-row tile is cut into TM-row sub-tiles (TM = 64, 32 or 16 dividing
// rt), and two passes run:
//   pass 1  per (64-column tile of I, sub-tile):
//           a = bf16(silu(x W_g s_g) * (x W_u s_u) * wslot)
//   pass 2  per (64-column tile of H, sub-tile): y = bf16((a W_d) s_d),
//           the kernel's output rows (combine-weighted; the caller
//           un-sorts and sums each token's k rows).
// Sub-tiles past the populated tiles (count read from device memory)
// skip pass 1 and write zeros in pass 2, as the TPU kernel's all-pad
// tiles produce.
//
// Bound on the H100: operations at prefill sizes (6*H*I flops per routed
// row; the padded rows cost flops too).  Consecutive sub-tiles of one
// expert read the same weights, which stay in L2 between them.  The dots
// run on the tensor cores (bf16 wmma, common.cuh); the weight loads are
// not yet pipelined against them.
#include "common.cuh"

namespace {

using llmd::bf16;
using llmd::kMoeThreads;
using llmd::kMoeTN;

template <int TM>
__global__ void __launch_bounds__(kMoeThreads)
grouped_gate_up_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ wslot,
                       const int* __restrict__ tile_expert,
                       const int* __restrict__ num_tiles,
                       const int8_t* __restrict__ wg,
                       const int8_t* __restrict__ wu,
                       const float* __restrict__ gs,
                       const float* __restrict__ us, bf16* __restrict__ act,
                       int rt, int E, int H, int I, int layer) {
  __shared__ const bf16* rows[TM];
  const long long s0 = (long long)blockIdx.y * TM;
  if (s0 >= (long long)*num_tiles * rt) return;
  const int i0 = blockIdx.x * kMoeTN;
  const int e = tile_expert[s0 / rt];
  for (int m = threadIdx.x; m < TM; m += kMoeThreads)
    rows[m] = x + (s0 + m) * H;
  __syncthreads();
  const long long le = (long long)layer * E + e;
  const int8_t* W[2] = {wg + le * H * I, wu + le * H * I};
  float acc[2][TM / 16][4];
  llmd::moe_tile_gemm<TM, 2>(rows, W, I, i0, H, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < TM / 16; ++r) {
    const long long row = s0 + ty + 16 * r;
    const float w = wslot[row];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + tx * 4 + c;
      const float h = acc[0][r][c] * gs[le * I + i];
      const float u = acc[1][r][c] * us[le * I + i];
      act[row * I + i] = __float2bfloat16(llmd::silu_f32(h) * u * w);
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kMoeThreads)
grouped_down_kernel(const bf16* __restrict__ act,
                    const int* __restrict__ tile_expert,
                    const int* __restrict__ num_tiles,
                    const int8_t* __restrict__ wd,
                    const float* __restrict__ ds, bf16* __restrict__ y, int rt,
                    int E, int H, int I, int layer) {
  __shared__ const bf16* rows[TM];
  const long long s0 = (long long)blockIdx.y * TM;
  const int h0 = blockIdx.x * kMoeTN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  if (s0 >= (long long)*num_tiles * rt) {
#pragma unroll
    for (int r = 0; r < TM / 16; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        y[(s0 + ty + 16 * r) * H + h0 + tx * 4 + c] = __float2bfloat16(0.0f);
    return;
  }
  const int e = tile_expert[s0 / rt];
  for (int m = threadIdx.x; m < TM; m += kMoeThreads)
    rows[m] = act + (s0 + m) * I;
  __syncthreads();
  const long long le = (long long)layer * E + e;
  const int8_t* W[1] = {wd + le * I * H};
  float acc[1][TM / 16][4];
  llmd::moe_tile_gemm<TM, 1>(rows, W, H, h0, I, acc);

#pragma unroll
  for (int r = 0; r < TM / 16; ++r) {
    const long long row = s0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = h0 + tx * 4 + c;
      y[row * H + col] = __float2bfloat16(acc[0][r][c] * ds[le * H + col]);
    }
  }
}

template <int TM>
int launch(const void* x, const void* wslot, const void* tile_expert,
           const void* num_tiles, const void* wg, const void* wu,
           const void* wd, const void* gs, const void* us, const void* ds,
           void* act, void* y, int S_pad, int rt, int E, int H, int I,
           int layer, cudaStream_t stream) {
  const int n_sub = S_pad / TM;
  grouped_gate_up_kernel<TM><<<dim3(I / kMoeTN, n_sub), kMoeThreads, 0,
                               stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(wslot),
      static_cast<const int*>(tile_expert), static_cast<const int*>(num_tiles),
      static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
      static_cast<const float*>(gs), static_cast<const float*>(us),
      static_cast<bf16*>(act), rt, E, H, I, layer);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grouped_down_kernel<TM><<<dim3(H / kMoeTN, n_sub), kMoeThreads, 0,
                            stream>>>(
      static_cast<const bf16*>(act), static_cast<const int*>(tile_expert),
      static_cast<const int*>(num_tiles), static_cast<const int8_t*>(wd),
      static_cast<const float*>(ds), static_cast<bf16*>(y), rt, E, H, I,
      layer);
  return (int)cudaGetLastError();
}

}  // namespace

// x [S_pad, H] bf16 sorted, padded rows; wslot [S_pad] f32 (0 = pad row);
// tile_expert [S_pad / rt] i32; num_tiles [1] i32 (device); stacked
// weights [Lm, E, ...]; act scratch [S_pad, I] bf16; y [S_pad, H] bf16.
// tm (the sub-tile, 16, 32 or 64) divides rt, and rt divides S_pad.
LLMD_EXPORT int llmd_moe_grouped_int8(
    const void* x, const void* wslot, const void* tile_expert,
    const void* num_tiles, const void* wg, const void* wu, const void* wd,
    const void* gs, const void* us, const void* ds, void* act, void* y,
    int S_pad, int rt, int E, int H, int I, int layer, int tm, void* stream) {
  if (S_pad == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 16:
      return launch<16>(x, wslot, tile_expert, num_tiles, wg, wu, wd, gs, us,
                        ds, act, y, S_pad, rt, E, H, I, layer, st);
    case 32:
      return launch<32>(x, wslot, tile_expert, num_tiles, wg, wu, wd, gs, us,
                        ds, act, y, S_pad, rt, E, H, I, layer, st);
    case 64:
      return launch<64>(x, wslot, tile_expert, num_tiles, wg, wu, wd, gs, us,
                        ds, act, y, S_pad, rt, E, H, I, layer, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
