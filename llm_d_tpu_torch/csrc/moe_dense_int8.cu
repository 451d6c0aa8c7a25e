// Kernel C: all-experts int8 MoE FFN for small token counts (T <= 64).
//
// Replaces ops/pallas/moe_int8.py dense_moe_int8 (TPU).  Every expert runs
// on every token; the [T, E] combine matrix (zero for unrouted pairs)
// scales the activations before the down projection, so the sum over
// experts is the routed MoE output:
//   pass 1  per (expert, 64-column tile of I, token tile):
//           a[e,t,:] = bf16(silu(x W_g s_g) * (x W_u s_u) * comb[t,e])
//   pass 2  per (64-column tile of H, expert group, token tile):
//           partial[g,t,:] = sum over the group's experts, in order, of
//           (a[e,t,:] W_d) s_d
//   pass 3  out[t,:] = sum over groups, in order (f32; no atomics, so
//           the result repeats bit for bit).
// int8 weights widen exactly to bf16 for the tensor-core dots (f32
// accumulation); the per-column scales multiply the f32 results, as on
// the TPU.
//
// Bound on the H100: bytes.  Every layer streams all E experts' int8
// weights (3*H*I bytes each, ~201 MB per layer at deepseek-v3-bench
// width) for at most 64 tokens, i.e. at most ~128 flops per weight byte.
// The passes split the weight stream over many blocks (E * I/64 in pass
// 1, H/64 * groups in pass 2) so enough loads are in flight; the weight
// loads are not yet pipelined against the dots.
#include "common.cuh"

namespace {

using llmd::bf16;
using llmd::kMoeThreads;
using llmd::kMoeTN;

template <int TM>
__global__ void __launch_bounds__(kMoeThreads)
dense_gate_up_kernel(const bf16* __restrict__ x, const float* __restrict__ comb,
                     const int8_t* __restrict__ wg, const int8_t* __restrict__ wu,
                     const float* __restrict__ gs, const float* __restrict__ us,
                     bf16* __restrict__ act, int T, int E, int H, int I,
                     int layer) {
  __shared__ const bf16* rows[TM];
  const int i0 = blockIdx.x * kMoeTN;
  const int e = blockIdx.y;
  const int t0 = blockIdx.z * TM;
  for (int m = threadIdx.x; m < TM; m += kMoeThreads)
    rows[m] = (t0 + m < T) ? x + (long long)(t0 + m) * H : nullptr;
  __syncthreads();
  const long long le = (long long)layer * E + e;
  const int8_t* W[2] = {wg + le * H * I, wu + le * H * I};
  float acc[2][TM / 16][4];
  llmd::moe_tile_gemm<TM, 2>(rows, W, I, i0, H, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < TM / 16; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t >= T) continue;
    const float cm = comb[(long long)t * E + e];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + tx * 4 + c;
      const float h = acc[0][r][c] * gs[le * I + i];
      const float u = acc[1][r][c] * us[le * I + i];
      act[((long long)e * T + t) * I + i] =
          __float2bfloat16(llmd::silu_f32(h) * u * cm);
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kMoeThreads)
dense_down_kernel(const bf16* __restrict__ act, const int8_t* __restrict__ wd,
                  const float* __restrict__ ds, float* __restrict__ partial,
                  int T, int E, int H, int I, int layer, int experts_per_group) {
  __shared__ const bf16* rows[TM];
  const int h0 = blockIdx.x * kMoeTN;
  const int g = blockIdx.y;
  const int t0 = blockIdx.z * TM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float out_acc[TM / 16][4];
#pragma unroll
  for (int r = 0; r < TM / 16; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out_acc[r][c] = 0.0f;

  for (int e = g * experts_per_group; e < (g + 1) * experts_per_group; ++e) {
    __syncthreads();                      // rows[] of the previous expert
    for (int m = threadIdx.x; m < TM; m += kMoeThreads)
      rows[m] = (t0 + m < T) ? act + ((long long)e * T + t0 + m) * I : nullptr;
    __syncthreads();
    const long long le = (long long)layer * E + e;
    const int8_t* W[1] = {wd + le * I * H};
    float acc[1][TM / 16][4];
    llmd::moe_tile_gemm<TM, 1>(rows, W, H, h0, I, acc);
#pragma unroll
    for (int r = 0; r < TM / 16; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out_acc[r][c] += acc[0][r][c] * ds[le * H + h0 + tx * 4 + c];
  }
#pragma unroll
  for (int r = 0; r < TM / 16; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      partial[((long long)g * T + t) * H + h0 + tx * 4 + c] = out_acc[r][c];
  }
}

__global__ void sum_groups_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int G, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += partial[(long long)g * n + i];
  out[i] = s;
}

template <int TM>
int launch(const void* x, const void* comb, const void* wg, const void* wu,
           const void* wd, const void* gs, const void* us, const void* ds,
           void* act, void* partial, void* out, int T, int E, int H, int I,
           int layer, int groups, cudaStream_t stream) {
  const int t_tiles = (T + TM - 1) / TM;
  dense_gate_up_kernel<TM><<<dim3(I / kMoeTN, E, t_tiles), kMoeThreads, 0,
                             stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(comb),
      static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
      static_cast<const float*>(gs), static_cast<const float*>(us),
      static_cast<bf16*>(act), T, E, H, I, layer);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_down_kernel<TM><<<dim3(H / kMoeTN, groups, t_tiles), kMoeThreads, 0,
                          stream>>>(
      static_cast<const bf16*>(act), static_cast<const int8_t*>(wd),
      static_cast<const float*>(ds), static_cast<float*>(partial), T, E, H, I,
      layer, E / groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)T * H;
  sum_groups_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), groups, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x [T, H] bf16, comb [T, E] f32, stacked weights [Lm, E, ...] int8 with
// f32 scales, act scratch [E, T, I] bf16, partial scratch [groups, T, H]
// f32, out [T, H] f32.  tm is the token tile (16, 32 or 64).
LLMD_EXPORT int llmd_moe_dense_int8(const void* x, const void* comb,
                                    const void* wg, const void* wu,
                                    const void* wd, const void* gs,
                                    const void* us, const void* ds, void* act,
                                    void* partial, void* out, int T, int E,
                                    int H, int I, int layer, int groups, int tm,
                                    void* stream) {
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 16:
      return launch<16>(x, comb, wg, wu, wd, gs, us, ds, act, partial, out, T,
                        E, H, I, layer, groups, st);
    case 32:
      return launch<32>(x, comb, wg, wu, wd, gs, us, ds, act, partial, out, T,
                        E, H, I, layer, groups, st);
    case 64:
      return launch<64>(x, comb, wg, wu, wd, gs, us, ds, act, partial, out, T,
                        E, H, I, layer, groups, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
