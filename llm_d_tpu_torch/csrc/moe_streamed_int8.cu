// Kernels D, E and F: routed int8 MoE FFNs over expert-sorted rows, on
// one set of pipelined passes.
//
// E replaces ops/pallas/moe_routed_stream.py streamed_moe_int8 (TPU, steps
// above 512 tokens).  The glue (ops/moe.py) builds one counting-sort
// layout per token-order chunk of chunk_t rows: within a chunk, rows
// sorted by expert, each expert's run padded to the row tile rt, one
// expert per tile; token ids are local to the chunk.  The TPU chunked the
// batch so that x and the f32 output fit VMEM; the value does not depend
// on the chunking, so here the chunks are only a layout.  A first
// one-block launch groups the populated tiles, expert-major across
// chunks, into row blocks of TM = 32, 64 or 128 rows of one expert
// ([NB, TM / rt] tile ids, -1 past an expert's last tile; plain version:
// ops/moe_routed_stream.py expert_row_blocks_plain), on the device, so the
// host never waits on the routing.  Three passes:
//   pass 1  per (128-column tile of I, row block):
//           act[slot,:] = bf16(silu(x W_g s_g) * (x W_u s_u) * wslot)
//           (pad slots have wslot 0 and are written as 0)
//   pass 2  per (128-column tile of H, row block):
//           y[slot,:] = bf16((act W_d) s_d)
//   pass 3  per token: out[t,:] = sum of its k slots' y rows in choice
//           order, in f32 (routed_combine_kernel).
// No atomics and no split-K, so the output repeats bit for bit.
//
// D replaces ops/pallas/moe_routed.py routed_moe_int8 (64 < T <= 512):
// the same function over one chunk that holds the whole batch, so it is
// E's launch with C = 1.  F replaces ops/pallas/moe_int8.py
// grouped_moe_int8 (the LLMD_MOE_PREFILL_KERNEL=grouped lever): its rows
// arrive gathered, sorted and padded, so passes 1-2 run with the identity
// row map (block b takes rows b*TM .. b*TM+TM-1, a slice of one rt-row
// tile, TM dividing rt; no gather), pass 2's y rows are its output
// (combine-weighted; the glue un-sorts them) and row blocks past the
// populated tiles write zero rows, as the TPU kernel's all-pad tiles do.
//
// Bound on the H100: E and F by operations (T*k rows x 6*H*I flops, ~0.41
// TFLOP per layer at T = 8192, deepseek-v3-bench; F computes its pad rows
// too) against ~201 MB of int8 weights; D by bytes (each routed expert's
// ~3.1 MB of weights against ~16 rows at T = 128).  A block takes up to
// 128 rows of one expert (a weight byte serves all of them), the int8
// weight tiles and the activation rows stream as stored through a
// cp.async ring of 4-5 stages (pipeline.cuh run_ring), and the weights
// widen to bf16 inside the mma.sync fragments by byte permutes
// (pipeline.cuh mma_int8_step, shared with kernel C); accumulators stay
// f32 in registers, warps tiled 2 along M by 4 along the 128 output
// columns, and the epilogues run from registers.  Row blocks run
// expert-major, so an expert's weights stay in the 50 MB L2 while its
// blocks run.  At D's sizes (~16 rows an expert at T = 128) the 32-row
// blocks (one m16 tile a warp along M) put every routed expert's weights
// through the ring once, two blocks an SM with ~70 KB of copies in flight
// each, and where a tile is a row block (one chunk, TM = rt) the tiles
// serve as the row blocks and the grouping launch is skipped.  Each
// product is summed in ascending K, m16n8k16 step by step, as the
// first-version tile GEMM summed it.
#include "common.cuh"
#include "pipeline.cuh"

namespace {

using llmd::bf16;

constexpr int kThreads = 256;           // 8 warps: 2 along M x 4 along N
constexpr int kTN = 128;                // output columns of a block
constexpr int kTK = 64;                 // K rows of a pipeline step
constexpr int kLdA = kTK + 8;           // bf16 row pitch (conflict-free)
constexpr int kLdW = kTN + 16;          // int8 row pitch (conflict-free)

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Ring of a pass with NW weight matrices at TM rows; BLOCKS blocks share
// an SM (TM = 128 in pass 1 holds 128 f32 accumulators a thread: one).
template <int TM, int NW>
struct Plan {
  static constexpr int kBlocks = TM * NW >= 256 ? 1 : 2;
  static constexpr int kMT = TM / 32;                  // m16 tiles a warp
  static constexpr int kABytes = TM * kLdA * 2;
  static constexpr int kWBytes = kTK * kLdW;
  static constexpr int kStage = kABytes + NW * kWBytes;
  static constexpr int kStages =
      cmin(5, (kBlocks == 1 ? 200 : 110) * 1024 / kStage);
  static constexpr int kSmem = kStages * kStage;
  static_assert(kStages >= 3, "ring too shallow");
  static_assert(kABytes % 128 == 0 && kWBytes % 128 == 0, "alignment");
};

// Each row of the block: the element offset of its K row in the pass's
// source (x or act), or -1 past the expert's last tile, and its slot.
template <int TM>
struct Rows {
  long long off[TM];
  int slot[TM];
};

// Issues step k0's copies into stage st: the TM source rows (zeros for
// absent rows), columns [k0, k0 + kTK), and the NW weight tiles
// W[w][k0 + r][col0 .. col0 + kTN).
template <class P, int TM, int NW>
__device__ __forceinline__ void load_step(char* st, const bf16* src,
                                          const Rows<TM>& rows, int k0,
                                          const int8_t* const (&W)[NW],
                                          int ldw, int col0) {
  bf16* As = reinterpret_cast<bf16*>(st);
  int8_t* Ws = reinterpret_cast<int8_t*>(st + P::kABytes);
#pragma unroll
  for (int i = threadIdx.x; i < TM * kTK / 8; i += kThreads) {
    const int m = i / (kTK / 8), c = i % (kTK / 8);
    const long long off = rows.off[m];
    llmd::cp_async16(As + m * kLdA + c * 8,
                     src + (off >= 0 ? off + k0 + c * 8 : 0),
                     off >= 0 ? 16 : 0);
  }
#pragma unroll
  for (int i = threadIdx.x; i < NW * kTK * (kTN / 16); i += kThreads) {
    const int w = i / (kTK * (kTN / 16)), r = (i / (kTN / 16)) % kTK;
    const int c = i % (kTN / 16);
    llmd::cp_async16(Ws + (w * kTK + r) * kLdW + c * 16,
                     W[w] + (long long)(k0 + r) * ldw + col0 + c * 16);
  }
}

// Fills the row table of row block blockIdx.y; returns its expert, or -1
// for a block past the populated ones.  With a block table, row m is slot
// tile * rt + m % rt of tile blocks[blockIdx.y][m / rt]; x_rows: the
// source row is the slot's token in its chunk (pass 1), else the slot
// itself (pass 2).  Without one (one tile a block, or kernel F's TM-row
// slices of a tile), row m is slot blockIdx.y * TM + m, live while it lies
// below num_tiles[0] * rt, and its source row is the slot's token with
// x_rows and tok_pad (kernel D), else the slot (kernel F, and pass 2).
template <int TM>
__device__ __forceinline__ int block_rows(Rows<TM>& rows,
                                          const int* __restrict__ blocks,
                                          const int* __restrict__ tile_expert,
                                          const int* __restrict__ num_tiles,
                                          const int* __restrict__ tok_pad,
                                          int rt, int NT_c, int chunk_t,
                                          int ld, bool x_rows) {
  if (blocks == nullptr) {
    const long long s0 = (long long)blockIdx.y * TM;
    if (s0 >= (long long)num_tiles[0] * rt) return -1;
    for (int m = threadIdx.x; m < TM; m += kThreads) {
      rows.slot[m] = (int)(s0 + m);
      rows.off[m] =
          (x_rows && tok_pad != nullptr ? tok_pad[s0 + m] : s0 + m) * ld;
    }
    __syncthreads();
    return tile_expert[s0 / rt];
  }
  const int* bt = blocks + (long long)blockIdx.y * (TM / rt);
  const int t0 = bt[0];
  if (t0 < 0) return -1;
  for (int m = threadIdx.x; m < TM; m += kThreads) {
    const int tile = bt[m / rt];
    int slot = -1;
    long long off = -1;
    if (tile >= 0) {
      slot = tile * rt + m % rt;
      const long long row =
          x_rows ? (long long)(tile / NT_c) * chunk_t + tok_pad[slot] : slot;
      off = row * ld;
    }
    rows.slot[m] = slot;
    rows.off[m] = off;
  }
  __syncthreads();
  return tile_expert[t0];
}

template <int TM>
__global__ void __launch_bounds__(kThreads, Plan<TM, 2>::kBlocks)
stream_gate_up_kernel(const bf16* __restrict__ x,
                      const int* __restrict__ tok_pad,
                      const float* __restrict__ wslot,
                      const int* __restrict__ tile_expert,
                      const int* __restrict__ num_tiles,
                      const int* __restrict__ blocks,
                      const int8_t* __restrict__ wg,
                      const int8_t* __restrict__ wu,
                      const float* __restrict__ gs,
                      const float* __restrict__ us, bf16* __restrict__ act,
                      int rt, int NT_c, int chunk_t, int E, int H, int I,
                      int layer) {
  using P = Plan<TM, 2>;
  extern __shared__ __align__(128) char smem[];
  __shared__ Rows<TM> rows;
  const int e = block_rows<TM>(rows, blocks, tile_expert, num_tiles, tok_pad,
                               rt, NT_c, chunk_t, H, true);
  if (e < 0) return;
  const int i0 = blockIdx.x * kTN;
  const long long le = (long long)layer * E + e;
  const int8_t* const W[2] = {wg + le * H * I, wu + le * H * I};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp & 3, ms = warp >> 2, g = lane >> 2, q = lane & 3;
  float acc[2][P::kMT][4][4] = {};
  const int m0 = ms * P::kMT * 16;
  llmd::run_ring<P::kStages, P::kStage>(
      smem, H / kTK,
      [&](int s, char* st) {
        load_step<P, TM, 2>(st, x, rows, s * kTK, W, I, i0);
      },
      [&](const char* st) {
        llmd::mma_int8_step<2, P::kMT, kLdA, kLdW, P::kWBytes>(
            reinterpret_cast<const bf16*>(st) + m0 * kLdA,
            reinterpret_cast<const int8_t*>(st + P::kABytes) + slice * 32, 0,
            kTK, g, q, acc);
      },
      [](int) {});

  // Thread (g, q) holds columns c0 .. c0 + 7 of rows g and g + 8 of each
  // m16 tile: element e of n8 tile j is column c0 + 4 * (e & 1) + j.
  const int c0 = i0 + slice * 32 + 8 * q;
  float gsc[8], usc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    gsc[c] = gs[le * I + c0 + c];
    usc[c] = us[le * I + c0 + c];
  }
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + mt * 16 + g + 8 * half;
      const int slot = rows.slot[m];
      if (slot < 0) continue;
      const float w = wslot[slot];
      uint32_t v[4];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        float o[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int j = (c + d) & 3, el = 2 * half + ((c + d) >> 2);
          const float h = acc[0][mt][j][el] * gsc[c + d];
          const float u = acc[1][mt][j][el] * usc[c + d];
          o[d] = llmd::silu_f32(h) * u * w;
        }
        v[c / 2] = llmd::pack_bf16(o[0], o[1]);
      }
      *reinterpret_cast<uint4*>(act + (long long)slot * I + c0) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, Plan<TM, 1>::kBlocks)
stream_down_kernel(const bf16* __restrict__ act,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ num_tiles,
                   const int* __restrict__ blocks,
                   const int8_t* __restrict__ wd, const float* __restrict__ ds,
                   bf16* __restrict__ y, int rt, int E, int H, int I,
                   int layer, int zero_dead) {
  using P = Plan<TM, 1>;
  extern __shared__ __align__(128) char smem[];
  __shared__ Rows<TM> rows;
  const int h0 = blockIdx.x * kTN;
  const int e = block_rows<TM>(rows, blocks, tile_expert, num_tiles, nullptr,
                               rt, 1, 0, I, false);
  if (e < 0) {
    if (zero_dead) {                    // kernel F: an all-pad row block
      const long long s0 = (long long)blockIdx.y * TM;
      for (int i = threadIdx.x; i < TM * kTN / 8; i += kThreads) {
        const int m = i / (kTN / 8), c = i % (kTN / 8);
        *reinterpret_cast<uint4*>(y + (s0 + m) * H + h0 + c * 8) =
            make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const long long le = (long long)layer * E + e;
  const int8_t* const W[1] = {wd + le * I * H};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp & 3, ms = warp >> 2, g = lane >> 2, q = lane & 3;
  float acc[1][P::kMT][4][4] = {};
  const int m0 = ms * P::kMT * 16;
  llmd::run_ring<P::kStages, P::kStage>(
      smem, I / kTK,
      [&](int s, char* st) {
        load_step<P, TM, 1>(st, act, rows, s * kTK, W, H, h0);
      },
      [&](const char* st) {
        llmd::mma_int8_step<1, P::kMT, kLdA, kLdW, 0>(
            reinterpret_cast<const bf16*>(st) + m0 * kLdA,
            reinterpret_cast<const int8_t*>(st + P::kABytes) + slice * 32, 0,
            kTK, g, q, acc);
      },
      [](int) {});

  const int c0 = h0 + slice * 32 + 8 * q;
  float dsc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) dsc[c] = ds[le * H + c0 + c];
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + mt * 16 + g + 8 * half;
      const int slot = rows.slot[m];
      if (slot < 0) continue;
      uint32_t v[4];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const int j0 = c & 3, j1 = (c + 1) & 3, el = 2 * half + (c >> 2);
        v[c / 2] = llmd::pack_bf16(acc[0][mt][j0][el] * dsc[c],
                                   acc[0][mt][j1][el] * dsc[c + 1]);
      }
      *reinterpret_cast<uint4*>(y + (long long)slot * H + c0) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
}

constexpr int kGroupThreads = 1024;
constexpr int kMaxExperts = 256;

// First position in [0, n) of a nondecreasing run whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Row blocks (ops/moe_routed_stream.py expert_row_blocks_plain): expert
// e's populated tiles, chunk by chunk (within a chunk they are one run,
// the glue sorts by expert), fill blocks blk_start[e] .. in groups of G;
// blk_start is the exclusive sum over experts of ceil(n_e / G).  One
// block: a warp per expert, a lane per chunk.
__global__ void __launch_bounds__(kGroupThreads)
stream_blocks_kernel(const int* __restrict__ tile_expert,
                     const int* __restrict__ num_tiles,
                     int* __restrict__ blocks, int C, int NT_c, int E, int G,
                     int NB) {
  __shared__ int n_e[kMaxExperts];
  __shared__ int blk_start[kMaxExperts];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < NB * G; i += kGroupThreads) blocks[i] = -1;
  // The run of expert e in chunk c: [lo, lo + n) of the chunk's tiles.
  auto run = [&](int e, int c, int& lo) {
    const int* te = tile_expert + (long long)c * NT_c;
    const int nt = num_tiles[c];
    lo = lower_bound(te, nt, e);
    return lower_bound(te, nt, e + 1) - lo;
  };
  for (int e = warp; e < E; e += kGroupThreads / 32) {
    int n = 0, lo;
    for (int c = lane; c < C; c += 32) n += run(e, c, lo);
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) n_e[e] = n;
  }
  __syncthreads();
  if (tid == 0) {
    int b = 0;
    for (int e = 0; e < E; ++e) {
      blk_start[e] = b;
      b += (n_e[e] + G - 1) / G;
    }
  }
  __syncthreads();
  for (int e = warp; e < E; e += kGroupThreads / 32) {
    int rank = 0;                       // tiles of e in earlier chunks
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      int lo = 0;
      const int n = c < C ? run(e, c, lo) : 0;
      int incl = n;                     // inclusive scan over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int r0 = rank + incl - n;
      for (int i = 0; i < n; ++i) {
        const int r = r0 + i;
        blocks[(blk_start[e] + r / G) * G + r % G] = c * NT_c + lo + i;
      }
      rank += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// out[t,:] = sum of token t's k slots' y rows, in choice order, in f32;
// a thread takes 8 consecutive columns (one 16-byte load a row).
__global__ void routed_combine_kernel(const bf16* __restrict__ y,
                                      const int* __restrict__ pos,
                                      float* __restrict__ out, int k, int H) {
  const long long t = blockIdx.x;
  const int* p = pos + t * k;
  for (int c = threadIdx.x * 8; c < H; c += blockDim.x * 8) {
    float s[8] = {};
    for (int j = 0; j < k; ++j) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(y + (long long)p[j] * H + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[2 * i] += __uint_as_float(w[i] << 16);
        s[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
      }
    }
    float4* o = reinterpret_cast<float4*>(out + t * H + c);
    o[0] = make_float4(s[0], s[1], s[2], s[3]);
    o[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
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

// Passes 1 and 2 over NB row blocks of TM rows (blocks null: kernel F's
// identity rows).
template <int TM>
int launch_passes(const void* x, const void* tok_pad, const void* wslot,
                  const void* tile_expert, const void* num_tiles,
                  const void* blocks, const void* wg, const void* wu,
                  const void* wd, const void* gs, const void* us,
                  const void* ds, void* act, void* y, int NB, int NT_c,
                  int chunk_t, int E, int H, int I, int layer, int rt,
                  int zero_dead, cudaStream_t stream) {
  using P1 = Plan<TM, 2>;
  using P2 = Plan<TM, 1>;
  static bool ready1 = false, ready2 = false;
  cudaError_t err = allow_smem(stream_gate_up_kernel<TM>, P1::kSmem, ready1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(stream_down_kernel<TM>, P2::kSmem, ready2);
  if (err != cudaSuccess) return (int)err;
  if (NB == 0) return 0;
  stream_gate_up_kernel<TM><<<dim3(I / kTN, NB), kThreads, P1::kSmem,
                              stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(tok_pad),
      static_cast<const float*>(wslot), static_cast<const int*>(tile_expert),
      static_cast<const int*>(num_tiles), static_cast<const int*>(blocks),
      static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
      static_cast<const float*>(gs), static_cast<const float*>(us),
      static_cast<bf16*>(act), rt, NT_c, chunk_t, E, H, I, layer);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_down_kernel<TM><<<dim3(H / kTN, NB), kThreads, P2::kSmem, stream>>>(
      static_cast<const bf16*>(act), static_cast<const int*>(tile_expert),
      static_cast<const int*>(num_tiles), static_cast<const int*>(blocks),
      static_cast<const int8_t*>(wd), static_cast<const float*>(ds),
      static_cast<bf16*>(y), rt, E, H, I, layer, zero_dead);
  return (int)cudaGetLastError();
}

template <int TM>
int launch(const void* x, const void* tok_pad, const void* wslot,
           const void* tile_expert, const void* num_tiles, void* blocks,
           const void* pos,
           const void* wg, const void* wu, const void* wd, const void* gs,
           const void* us, const void* ds, void* act, void* y, void* out,
           int Tp, int k, int C, int NB, int NT_c, int chunk_t, int E, int H,
           int I, int layer, int rt, cudaStream_t stream) {
  // One chunk of tiles as tall as the row block (kernel D's decode waves):
  // the tiles are the row blocks already, in expert order.
  const bool by_tile = C == 1 && TM == rt;
  if (!by_tile) {
    stream_blocks_kernel<<<1, kGroupThreads, 0, stream>>>(
        static_cast<const int*>(tile_expert),
        static_cast<const int*>(num_tiles), static_cast<int*>(blocks), C,
        NT_c, E, TM / rt, NB);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int code = launch_passes<TM>(
      x, tok_pad, wslot, tile_expert, num_tiles, by_tile ? nullptr : blocks,
      wg, wu, wd, gs, us, ds, act, y, by_tile ? NT_c : NB, NT_c, chunk_t, E,
      H, I, layer, rt, 0, stream);
  if (code != 0) return code;
  routed_combine_kernel<<<Tp, 256, 0, stream>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(pos),
      static_cast<float*>(out), k, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels E and D.  x [Tp, H] bf16 (Tp = C * chunk_t); tok_pad
// [C*S_pad_c] i32 chunk-local token id per padded slot; wslot [C*S_pad_c]
// f32 (0 = pad slot); tile_expert [C*NT_c] i32; num_tiles [C] i32
// (device); blocks: i32 scratch for the [NB, tm / rt] row blocks (NB =
// min(NT, NT / (tm / rt) + E)); pos [Tp, k] i32 global padded slot of each
// (token, choice); stacked weights [Lm, E, ...]; act scratch [C*S_pad_c,
// I] bf16, y scratch [C*S_pad_c, H] bf16; out [Tp, H] f32.  rt (the row
// tile) is 16, 32 or 64; tm (the row block) 32, 64 or 128, a multiple of
// rt; E <= 256, H % 128 == 0, I % 128 == 0.  Kernel D is C = 1.
LLMD_EXPORT int llmd_moe_streamed_int8(
    const void* x, const void* tok_pad, const void* wslot,
    const void* tile_expert, const void* num_tiles, void* blocks,
    const void* pos, const void* wg, const void* wu, const void* wd,
    const void* gs, const void* us, const void* ds, void* act, void* y,
    void* out, int Tp, int k, int C, int NB, int NT_c, int chunk_t, int E,
    int H, int I, int layer, int rt, int tm, void* stream) {
  if (Tp == 0) return 0;
  if ((rt != 16 && rt != 32 && rt != 64) || tm % rt != 0 ||
      E > kMaxExperts || H % kTN != 0 || I % kTN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 32:
      return launch<32>(x, tok_pad, wslot, tile_expert, num_tiles, blocks, pos,
                        wg, wu, wd, gs, us, ds, act, y, out, Tp, k, C, NB,
                        NT_c, chunk_t, E, H, I, layer, rt, st);
    case 64:
      return launch<64>(x, tok_pad, wslot, tile_expert, num_tiles, blocks, pos,
                        wg, wu, wd, gs, us, ds, act, y, out, Tp, k, C, NB,
                        NT_c, chunk_t, E, H, I, layer, rt, st);
    case 128:
      return launch<128>(x, tok_pad, wslot, tile_expert, num_tiles, blocks,
                         pos, wg, wu, wd, gs, us, ds, act, y, out, Tp, k, C,
                         NB, NT_c, chunk_t, E, H, I, layer, rt, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel F.  x [S_pad, H] bf16 sorted, padded rows; wslot [S_pad] f32 (0 =
// pad row); tile_expert [S_pad / rt] i32; num_tiles [1] i32 (device);
// stacked weights [Lm, E, ...]; act scratch [S_pad, I] bf16; y [S_pad, H]
// bf16 out.  tm (the row block: 32, 64 or 128) divides rt, and rt divides
// S_pad; H % 128 == 0, I % 128 == 0.
LLMD_EXPORT int llmd_moe_grouped_int8(
    const void* x, const void* wslot, const void* tile_expert,
    const void* num_tiles, const void* wg, const void* wu, const void* wd,
    const void* gs, const void* us, const void* ds, void* act, void* y,
    int S_pad, int rt, int E, int H, int I, int layer, int tm, void* stream) {
  if (S_pad == 0) return 0;
  if (rt % tm != 0 || S_pad % rt != 0 || S_pad / tm > 65535 ||
      H % kTN != 0 || I % kTN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NB = S_pad / tm;
  switch (tm) {
    case 32:
      return launch_passes<32>(x, nullptr, wslot, tile_expert, num_tiles,
                               nullptr, wg, wu, wd, gs, us, ds, act, y, NB, 1,
                               0, E, H, I, layer, rt, 1, st);
    case 64:
      return launch_passes<64>(x, nullptr, wslot, tile_expert, num_tiles,
                               nullptr, wg, wu, wd, gs, us, ds, act, y, NB, 1,
                               0, E, H, I, layer, rt, 1, st);
    case 128:
      return launch_passes<128>(x, nullptr, wslot, tile_expert, num_tiles,
                                nullptr, wg, wu, wd, gs, us, ds, act, y, NB, 1,
                                0, E, H, I, layer, rt, 1, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The row blocks alone (the first launch of llmd_moe_streamed_int8), for
// holding them against ops/moe_routed_stream.py expert_row_blocks_plain:
// blocks [NB, G] i32 from tile_expert [C*NT_c] and num_tiles [C].
LLMD_EXPORT int llmd_moe_stream_blocks(const void* tile_expert,
                                       const void* num_tiles, void* blocks,
                                       int C, int NT_c, int E, int G, int NB,
                                       void* stream) {
  if (E > kMaxExperts) return (int)cudaErrorInvalidValue;
  stream_blocks_kernel<<<1, kGroupThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_expert), static_cast<const int*>(num_tiles),
      static_cast<int*>(blocks), C, NT_c, E, G, NB);
  return (int)cudaGetLastError();
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
