// Kernel C: the int8 MoE FFN for small token counts (T <= 64), over the
// experts that a token is routed to.
//
// Replaces ops/pallas/moe_int8.py dense_moe_int8 (TPU).  The [T, E]
// combine matrix (zero for unrouted pairs) scales the activations before
// the down projection, so the sum over experts is the routed MoE output:
//   pass 1  per (expert, 128-column tile of I, token tile):
//           a[e,t,:] = bf16(silu(x W_g s_g) * (x W_u s_u) * comb[t,e])
//   pass 2  per (128-column tile of H, expert group, token tile):
//           partial[g,t,:] = sum over the group's routed experts, in order,
//           of (a[e,t,:] W_d) s_d
//   pass 3  out[t,:] = sum over groups, in order (f32; no atomics, so
//           the result repeats bit for bit).
// An expert whose comb column is zero over the token tile adds exactly 0
// (the TPU kernel multiplies it by 0), so pass 1 exits for it before
// reading a weight and pass 2 leaves it out of its group loop (its act
// rows are never written or read).  A group with no routed expert writes
// zero partials.  int8 weights widen exactly to bf16 for the tensor-core
// dots (f32 accumulation); the per-column scales multiply the f32
// results, as on the TPU.
//
// Bound on the H100: bytes -- the routed experts' int8 weights (3*H*I
// bytes each, 3.1 MB at deepseek-v3-bench width) for at most 64 tokens,
// at most ~128 flops per weight byte against a ridge of ~295.  The design
// keeps the weight stream in flight: each block copies its int8 weight
// tiles as stored (16-byte cp.async, no staging through registers) and its
// activation tile into a ring of 3-5 stages of about 100 KB, so two blocks
// fit an SM and each keeps 32-48 KB of weight loads outstanding (the card
// needs ~32 KB per SM: 3.35 TB/s x ~1.3 us / 132 SMs).  The int8 tile
// stays int8 in shared memory (a quarter of a bf16 tile) and widens to
// bf16 as each warp builds its mma.sync fragments, by byte permutes and
// f32 adds (the conversion unit's rate bounded the loop); pass 2's
// pipeline runs on across the experts of its group, four to a group.
#include "common.cuh"
#include "pipeline.cuh"

namespace {

using llmd::bf16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kRingBudget = 100 * 1024;  // two blocks per SM
// Output columns of a block in passes 1 and 2: 128-byte weight rows, and
// half the activation reloads of 64 columns (measured faster at T = 16
// and T = 64 than 64 columns in either pass).
constexpr int kTN1 = 128;
constexpr int kTN2 = 128;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared-memory plan of a block computing TM x TN outputs of NW weight
// matrices with TK-deep pipeline steps.  A warp owns one (matrix,
// 32-column slice) unit, kMT m16 tiles of the token rows and one kKS-th
// of each step's K rows; the kKS partial sums meet in shared memory at the
// end, in a fixed order.  Weight rows are TN + 16 bytes apart: 16-byte
// aligned for cp.async, and the fragment reads below hit 32 banks.
template <int TM, int NW, int TK, int TN>
struct Plan {
  static constexpr int kLdW = TN + 16;                   // int8 row pitch
  static constexpr int kLdC = TN + 4;                    // f32 row pitch
  static constexpr int kLdA = TK + 8;                    // bf16 row pitch
  static constexpr int kABytes = (TM * kLdA * 2 + 127) / 128 * 128;
  static constexpr int kWBytes = NW * TK * kLdW;
  static constexpr int kStage = kABytes + kWBytes;
  static constexpr int kStages = cmin(8, kRingBudget / kStage);
  static constexpr int kSlices = TN / 32;
  static constexpr int kUnits = NW * kSlices;
  static constexpr int kMS = cmin(TM / 16, 8 / kUnits);  // warps along M
  static constexpr int kKS = 8 / kUnits / kMS;           // warps along K
  static constexpr int kMT = TM / 16 / kMS;              // m16 tiles a warp
  static constexpr int kKW = TK / kKS;                   // K rows a warp
  static constexpr int kCBytes = kKS * NW * TM * kLdC * 4;
  static constexpr int kSmem = cmax(kStages * kStage, kCBytes);
  static_assert(kStages >= 3, "ring too shallow");
  static_assert(kWBytes % 128 == 0, "stage alignment");
  static_assert(kUnits * kMS * kKS == 8 && kKW % 16 == 0, "warp split");
};

struct WarpRole {
  int w, slice, ms, ks, g, q;
};

template <class P>
__device__ __forceinline__ WarpRole warp_role() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp % P::kUnits, rest = warp / P::kUnits;
  return {unit / P::kSlices, unit % P::kSlices, rest % P::kMS, rest / P::kMS,
          lane >> 2, lane & 3};
}

// Issues the copies of one step into ring stage `st`: activation rows
// a_base + m * a_ld (m < rows; zeros past them), columns [k0, k0 + TK),
// and the NW weight tiles W[w][k0 + r][col0 .. col0 + TN).
template <class P, int TM, int NW, int TK, int TN>
__device__ __forceinline__ void load_step(char* st, const bf16* a_base,
                                          long long a_ld, int rows, int k0,
                                          const int8_t* const (&W)[NW],
                                          int ldw, int col0) {
  bf16* As = reinterpret_cast<bf16*>(st);
  int8_t* Ws = reinterpret_cast<int8_t*>(st + P::kABytes);
  constexpr int kAChunks = TM * TK / 8;
  for (int i = threadIdx.x; i < kAChunks; i += kThreads) {
    const int m = i / (TK / 8), c = i % (TK / 8);
    const bool ok = m < rows;
    llmd::cp_async16(As + m * P::kLdA + c * 8,
                     a_base + (ok ? m * a_ld + k0 + c * 8 : 0), ok ? 16 : 0);
  }
  constexpr int kRowChunks = TN / 16;
  constexpr int kWChunks = NW * TK * kRowChunks;
#pragma unroll
  for (int i = threadIdx.x; i < kWChunks; i += kThreads) {
    const int w = i / (TK * kRowChunks), r = (i / kRowChunks) % TK;
    const int c = i % kRowChunks;
    llmd::cp_async16(Ws + (w * TK + r) * P::kLdW + c * 16,
                     W[w] + (long long)(k0 + r) * ldw + col0 + c * 16);
  }
}

// The warp's share of one step (pipeline.cuh mma_int8_step over the
// warp's m16 tiles, its matrix's 32-column slice and its K rows).
template <class P, int TK>
__device__ __forceinline__ void mma_step(const char* st, const WarpRole& r,
                                         float (&acc)[P::kMT][4][4]) {
  const bf16* As = reinterpret_cast<const bf16*>(st) +
                   r.ms * P::kMT * 16 * P::kLdA;
  const int8_t* Ws = reinterpret_cast<const int8_t*>(st + P::kABytes) +
                     r.w * TK * P::kLdW + r.slice * 32;
  llmd::mma_int8_step<1, P::kMT, P::kLdA, P::kLdW, 0>(
      As, Ws, r.ks * P::kKW, (r.ks + 1) * P::kKW, r.g, r.q,
      reinterpret_cast<float(&)[1][P::kMT][4][4]>(acc));
}

// Column (within the block's TN) of accumulator element e (0..3) of n8
// tile j for thread (g, q): elements 0, 2 are local column 2q, 1, 3 are
// 2q + 1.
__device__ __forceinline__ int acc_col(const WarpRole& r, int j, int e) {
  return r.slice * 32 + 4 * (2 * r.q + (e & 1)) + j;
}

// Writes the warp's accumulators into Cs[ks][w][TM][kLdC] (the ring,
// drained).
template <class P, int TM, int NW>
__device__ __forceinline__ void store_acc(float* Cs, const WarpRole& r,
                                          const float (&acc)[P::kMT][4][4]) {
  float* base = Cs + (r.ks * NW + r.w) * TM * P::kLdC;
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = (r.ms * P::kMT + mt) * 16 + r.g + (e >> 1) * 8;
        base[m * P::kLdC + acc_col(r, j, e)] = acc[mt][j][e];
      }
}

constexpr int kTK1 = 64;
template <int TM>
__host__ __device__ constexpr int tk2() { return TM == 64 ? 64 : 128; }
template <int TM>
using Plan1 = Plan<TM, 2, kTK1, kTN1>;
template <int TM>
using Plan2 = Plan<TM, 1, tk2<TM>(), kTN2>;

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
dense_gate_up_kernel(const bf16* __restrict__ x, const float* __restrict__ comb,
                     const int8_t* __restrict__ wg, const int8_t* __restrict__ wu,
                     const float* __restrict__ gs, const float* __restrict__ us,
                     bf16* __restrict__ act, int T, int E, int H, int I,
                     int layer) {
  using P = Plan1<TM>;
  extern __shared__ __align__(128) char smem[];
  const int i0 = blockIdx.x * kTN1;
  const int e = blockIdx.y;
  const int t0 = blockIdx.z * TM;
  const int rows = min(TM, T - t0);
  // No token of the tile routed here: the expert adds exactly 0.
  const int tid = threadIdx.x;
  if (!__syncthreads_or(tid < rows && comb[(long long)(t0 + tid) * E + e] != 0.0f))
    return;
  const long long le = (long long)layer * E + e;
  const int8_t* const W[2] = {wg + le * H * I, wu + le * H * I};
  const bf16* a_base = x + (long long)t0 * H;
  const WarpRole r = warp_role<P>();
  float acc[P::kMT][4][4] = {};
  llmd::run_ring<P::kStages, P::kStage>(
      smem, H / kTK1,
      [&](int s, char* st) {
        load_step<P, TM, 2, kTK1, kTN1>(st, a_base, H, rows, s * kTK1, W, I,
                                        i0);
      },
      [&](const char* st) { mma_step<P, kTK1>(st, r, acc); },
      [](int) {});

  float* Cs = reinterpret_cast<float*>(smem);
  store_acc<P, TM, 2>(Cs, r, acc);
  __syncthreads();
  for (int idx = tid; idx < rows * kTN1; idx += kThreads) {
    const int m = idx / kTN1, col = idx % kTN1;
    float hs = 0.0f, ul = 0.0f;
#pragma unroll
    for (int ks = 0; ks < P::kKS; ++ks) {
      hs += Cs[((ks * 2 + 0) * TM + m) * P::kLdC + col];
      ul += Cs[((ks * 2 + 1) * TM + m) * P::kLdC + col];
    }
    const int i = i0 + col;
    const float h = hs * gs[le * I + i];
    const float u = ul * us[le * I + i];
    act[((long long)e * T + t0 + m) * I + i] = __float2bfloat16(
        llmd::silu_f32(h) * u * comb[(long long)(t0 + m) * E + e]);
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
dense_down_kernel(const bf16* __restrict__ act, const float* __restrict__ comb,
                  const int8_t* __restrict__ wd, const float* __restrict__ ds,
                  float* __restrict__ partial, int T, int E, int H, int I,
                  int layer, int experts_per_group) {
  constexpr int TK = tk2<TM>();
  using P = Plan2<TM>;
  extern __shared__ __align__(128) char smem[];
  __shared__ unsigned long long live_mask;
  __shared__ int live[64];
  __shared__ int n_live;
  const int h0 = blockIdx.x * kTN2;
  const int grp = blockIdx.y;
  const int t0 = blockIdx.z * TM;
  const int rows = min(TM, T - t0);
  const int tid = threadIdx.x;
  const int e0 = grp * experts_per_group;
  // The last groups are shorter (or empty) when groups do not divide E.
  const int n_exp = max(0, min(experts_per_group, E - e0));

  // The group's experts with a routed token in the tile, in order.
  if (tid == 0) live_mask = 0ull;
  __syncthreads();
  for (int i = tid; i < n_exp * rows; i += kThreads) {
    const int el = i / rows, m = i % rows;
    if (comb[(long long)(t0 + m) * E + e0 + el] != 0.0f)
      atomicOr(&live_mask, 1ull << el);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int el = 0; el < n_exp; ++el)
      if ((live_mask >> el) & 1ull) live[n++] = e0 + el;
    n_live = n;
  }
  __syncthreads();

  const int steps = I / TK;                 // per expert
  const WarpRole r = warp_role<P>();
  float acc[P::kMT][4][4] = {};
  float out[P::kMT][4][4] = {};
  llmd::run_ring<P::kStages, P::kStage>(
      smem, n_live * steps,
      [&](int s, char* st) {
        const int e = live[s / steps];
        const long long le = (long long)layer * E + e;
        const int8_t* const W[1] = {wd + le * I * H};
        load_step<P, TM, 1, TK, kTN2>(st, act + ((long long)e * T + t0) * I,
                                      I, rows, (s % steps) * TK, W, H, h0);
      },
      [&](const char* st) { mma_step<P, TK>(st, r, acc); },
      [&](int s) {
        if (s % steps != steps - 1) return;
        // The expert is summed: scale its columns, add it in order.
        const long long le = (long long)layer * E + live[s / steps];
        const float* dsc = ds + le * H + h0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sc = dsc[acc_col(r, j, e)];
#pragma unroll
            for (int mt = 0; mt < P::kMT; ++mt) {
              out[mt][j][e] += acc[mt][j][e] * sc;
              acc[mt][j][e] = 0.0f;
            }
          }
      });

  float* Cs = reinterpret_cast<float*>(smem);
  store_acc<P, TM, 1>(Cs, r, out);
  __syncthreads();
  for (int idx = tid; idx < rows * kTN2; idx += kThreads) {
    const int m = idx / kTN2, col = idx % kTN2;
    float v = 0.0f;
#pragma unroll
    for (int ks = 0; ks < P::kKS; ++ks) v += Cs[(ks * TM + m) * P::kLdC + col];
    partial[((long long)grp * T + t0 + m) * H + h0 + col] = v;
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

// Dynamic shared memory above 48 KB needs the attribute, once per kernel.
template <class K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int TM>
int launch(const void* x, const void* comb, const void* wg, const void* wu,
           const void* wd, const void* gs, const void* us, const void* ds,
           void* act, void* partial, void* out, int T, int E, int H, int I,
           int layer, int groups, cudaStream_t stream) {
  using P1 = Plan1<TM>;
  using P2 = Plan2<TM>;
  static bool ready1 = false, ready2 = false;
  cudaError_t err = allow_smem(dense_gate_up_kernel<TM>, P1::kSmem, ready1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dense_down_kernel<TM>, P2::kSmem, ready2);
  if (err != cudaSuccess) return (int)err;
  const int t_tiles = (T + TM - 1) / TM;
  dense_gate_up_kernel<TM><<<dim3(I / kTN1, E, t_tiles), kThreads, P1::kSmem,
                             stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(comb),
      static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
      static_cast<const float*>(gs), static_cast<const float*>(us),
      static_cast<bf16*>(act), T, E, H, I, layer);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_down_kernel<TM><<<dim3(H / kTN2, groups, t_tiles), kThreads, P2::kSmem,
                          stream>>>(
      static_cast<const bf16*>(act), static_cast<const float*>(comb),
      static_cast<const int8_t*>(wd), static_cast<const float*>(ds),
      static_cast<float*>(partial), T, E, H, I, layer,
      (E + groups - 1) / groups);
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
// f32, out [T, H] f32.  tm is the token tile (16, 32 or 64); groups of
// ceil(E / groups) <= 64 experts (the last ones shorter), H % 128 == 0,
// I % 128 == 0.
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
