// Kernel E: chunk-streamed routed int8 MoE FFN (steps above 512 tokens).
//
// Replaces ops/pallas/moe_routed_stream.py streamed_moe_int8 (TPU).  The
// glue (ops/moe.py) builds one counting-sort layout per token-order chunk
// of chunk_t rows: within a chunk, rows sorted by expert, each expert's
// run padded to the row tile, one expert per tile; token ids are local to
// the chunk.  The TPU chunked the batch so that x and the f32 output fit
// VMEM; the value does not depend on the chunking, so here the chunks are
// only a layout: every (chunk, tile) is an independent block of the three
// passes of kernel D (moe_routed.cuh routed_moe: gate/up, down, per-token
// combine in a fixed order, no atomics).  Tiles past their chunk's
// populated count (read from device memory, no host sync) exit.
//
// Bound on the H100: operations at prefill sizes (T*k rows x 6*H*I flops,
// ~0.41 TFLOP per layer at T=8192, deepseek-v3-bench).  Weight traffic is
// the trap: every chunk touches nearly every expert, so walking the tiles
// chunk by chunk would stream all weights once per chunk (16 x 201 MB per
// layer at T=8192).  The wrapper hands the tiles over in expert-major
// order (tile_order), so one expert's int8 weights (~3.1 MB) stay in the
// 50 MB L2 while its tiles from every chunk run.  The dots run on the
// tensor cores (bf16 wmma, common.cuh); the weight loads are not yet
// pipelined against them.
#include "moe_routed.cuh"

// x [Tp, H] bf16 (Tp = C * chunk_t); tok_pad [C*S_pad_c] i32 chunk-local
// token id per padded slot; wslot [C*S_pad_c] f32 (0 = pad slot);
// tile_expert [NT] i32 (NT = C * NT_c); num_tiles [C] i32 (device); pos
// [Tp, k] i32 global padded slot of each (token, choice); tile_order [NT]
// i32 a permutation of the tiles (expert-major, idle tiles last); stacked
// weights [Lm, E, ...]; act scratch [NT*rt, I] bf16, y scratch [NT*rt, H]
// bf16; out [Tp, H] f32.  rt (the row tile) is 16, 32 or 64.
LLMD_EXPORT int llmd_moe_streamed_int8(
    const void* x, const void* tok_pad, const void* wslot,
    const void* tile_expert, const void* num_tiles, const void* pos,
    const void* tile_order, const void* wg, const void* wu, const void* wd,
    const void* gs, const void* us, const void* ds, void* act, void* y,
    void* out, int Tp, int k, int NT, int NT_c, int chunk_t, int E, int H,
    int I, int layer, int rt, void* stream) {
  return llmd::routed_moe(rt, x, tok_pad, wslot, tile_expert, num_tiles, pos,
                          tile_order, wg, wu, wd, gs, us, ds, act, y, out, Tp,
                          k, NT, NT_c, chunk_t, E, H, I, layer, stream);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
