// The routed int8 MoE passes of kernel D (moe_routed_int8.cu), over the
// tile GEMM of common.cuh, and the per-token combine that kernel E
// (moe_streamed_int8.cu) shares.  Only those two sources include this
// header, so no other library compiles these kernels.
#pragma once

#include "common.cuh"

namespace llmd {

// ---------------------------------------------------------------------------
// Routed int8 MoE over counting-sort tiles (kernel D; pass 3 also E's)
// ---------------------------------------------------------------------------
//
// The glue (ops/moe.py) sorts the routed (token, expert) rows by expert,
// pads each expert's run to the row tile TM and gives every tile one
// expert.  Three passes:
//   pass 1  per (64-column tile of I, tile): gather the tile's x rows by
//           token id, a = bf16(silu(x W_g s_g) * (x W_u s_u) * wslot)
//   pass 2  per (64-column tile of H, tile): y[slot,:] = bf16((a W_d) s_d)
//           (rounded as the TPU rounds y before its combine)
//   pass 3  per token: out[t,:] = sum of its k slots' y rows, in choice
//           order, in f32 (no atomics: the result repeats bit for bit).
// Tiles past the populated count (read from device memory, so the host
// never waits on the routing) exit at once; experts nobody routed to get
// no tile and their weights are never read.

struct RoutedTile {
  long long s0;                         // first padded slot
  int e;
  bool live;
};

template <int TM>
__device__ __forceinline__ RoutedTile routed_tile(const int* tile_expert,
                                                  const int* num_tiles) {
  const int tile = blockIdx.y;
  RoutedTile t;
  t.live = tile < num_tiles[0];
  t.s0 = (long long)tile * TM;
  t.e = tile_expert[tile];
  return t;
}

template <int TM>
__global__ void __launch_bounds__(kMoeThreads)
routed_gate_up_kernel(const bf16* __restrict__ x,
                      const int* __restrict__ tok_pad,
                      const float* __restrict__ wslot,
                      const int* __restrict__ tile_expert,
                      const int* __restrict__ num_tiles,
                      const int8_t* __restrict__ wg,
                      const int8_t* __restrict__ wu,
                      const float* __restrict__ gs,
                      const float* __restrict__ us, bf16* __restrict__ act,
                      int E, int H, int I, int layer) {
  __shared__ const bf16* rows[TM];
  const RoutedTile t = routed_tile<TM>(tile_expert, num_tiles);
  if (!t.live) return;
  const int i0 = blockIdx.x * kMoeTN;
  for (int m = threadIdx.x; m < TM; m += kMoeThreads)
    rows[m] = x + (long long)tok_pad[t.s0 + m] * H;
  __syncthreads();
  const long long le = (long long)layer * E + t.e;
  const int8_t* W[2] = {wg + le * H * I, wu + le * H * I};
  float acc[2][TM / 16][4];
  moe_tile_gemm<TM, 2>(rows, W, I, i0, H, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < TM / 16; ++r) {
    const long long slot = t.s0 + ty + 16 * r;
    const float w = wslot[slot];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + tx * 4 + c;
      const float h = acc[0][r][c] * gs[le * I + i];
      const float u = acc[1][r][c] * us[le * I + i];
      act[slot * I + i] = __float2bfloat16(silu_f32(h) * u * w);
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kMoeThreads)
routed_down_kernel(const bf16* __restrict__ act,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ num_tiles,
                   const int8_t* __restrict__ wd, const float* __restrict__ ds,
                   bf16* __restrict__ y, int E, int H, int I, int layer) {
  __shared__ const bf16* rows[TM];
  const RoutedTile t = routed_tile<TM>(tile_expert, num_tiles);
  if (!t.live) return;
  const int h0 = blockIdx.x * kMoeTN;
  for (int m = threadIdx.x; m < TM; m += kMoeThreads)
    rows[m] = act + (t.s0 + m) * I;
  __syncthreads();
  const long long le = (long long)layer * E + t.e;
  const int8_t* W[1] = {wd + le * I * H};
  float acc[1][TM / 16][4];
  moe_tile_gemm<TM, 1>(rows, W, H, h0, I, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < TM / 16; ++r) {
    const long long slot = t.s0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = h0 + tx * 4 + c;
      y[slot * H + col] = __float2bfloat16(acc[0][r][c] * ds[le * H + col]);
    }
  }
}

__global__ void routed_combine_kernel(const bf16* __restrict__ y,
                                      const int* __restrict__ pos,
                                      float* __restrict__ out, int k, int H) {
  const long long t = blockIdx.x;
  for (int col = threadIdx.x; col < H; col += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j)
      s += bf2f(y[(long long)pos[t * k + j] * H + col]);
    out[t * H + col] = s;
  }
}

template <int TM>
int routed_moe_passes(const void* x, const void* tok_pad, const void* wslot,
                      const void* tile_expert, const void* num_tiles,
                      const void* pos, const void* wg, const void* wu,
                      const void* wd, const void* gs, const void* us,
                      const void* ds, void* act, void* y, void* out, int T,
                      int k, int NT, int E, int H, int I, int layer,
                      cudaStream_t stream) {
  routed_gate_up_kernel<TM><<<dim3(I / kMoeTN, NT), kMoeThreads, 0,
                              stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(tok_pad),
      static_cast<const float*>(wslot), static_cast<const int*>(tile_expert),
      static_cast<const int*>(num_tiles), static_cast<const int8_t*>(wg),
      static_cast<const int8_t*>(wu), static_cast<const float*>(gs),
      static_cast<const float*>(us), static_cast<bf16*>(act), E, H, I, layer);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  routed_down_kernel<TM><<<dim3(H / kMoeTN, NT), kMoeThreads, 0, stream>>>(
      static_cast<const bf16*>(act), static_cast<const int*>(tile_expert),
      static_cast<const int*>(num_tiles), static_cast<const int8_t*>(wd),
      static_cast<const float*>(ds), static_cast<bf16*>(y), E, H, I, layer);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  routed_combine_kernel<<<T, 256, 0, stream>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(pos),
      static_cast<float*>(out), k, H);
  return (int)cudaGetLastError();
}

// The three passes at row tile rt (16, 32 or 64).  x [T, H] bf16;
// tok_pad [NT * rt] i32 token id per padded slot; wslot [NT * rt] f32 (0 =
// pad slot); tile_expert [NT] i32; num_tiles [1] i32 (device); pos [T, k]
// i32 padded slot of each (token, choice); stacked weights [Lm, E, ...];
// act scratch [NT * rt, I] bf16, y scratch [NT * rt, H] bf16; out [T, H]
// f32.
inline int routed_moe(int rt, const void* x, const void* tok_pad,
                      const void* wslot, const void* tile_expert,
                      const void* num_tiles, const void* pos, const void* wg,
                      const void* wu, const void* wd, const void* gs,
                      const void* us, const void* ds, void* act, void* y,
                      void* out, int T, int k, int NT, int E, int H, int I,
                      int layer, void* stream) {
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rt) {
    case 16:
      return routed_moe_passes<16>(x, tok_pad, wslot, tile_expert, num_tiles,
                                   pos, wg, wu, wd, gs, us, ds, act, y, out, T,
                                   k, NT, E, H, I, layer, st);
    case 32:
      return routed_moe_passes<32>(x, tok_pad, wslot, tile_expert, num_tiles,
                                   pos, wg, wu, wd, gs, us, ds, act, y, out, T,
                                   k, NT, E, H, I, layer, st);
    case 64:
      return routed_moe_passes<64>(x, tok_pad, wslot, tile_expert, num_tiles,
                                   pos, wg, wu, wd, gs, us, ds, act, y, out, T,
                                   k, NT, E, H, I, layer, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace llmd
