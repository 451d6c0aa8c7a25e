// Kernel D: routed int8 MoE FFN over the (token, expert) rows only.
//
// Replaces ops/pallas/moe_routed.py routed_moe_int8 (TPU).  The glue
// (ops/moe.py) builds the counting-sort layout: rows sorted by expert,
// each expert's run padded to a multiple of the row tile, one expert per
// tile, plus each (token, choice)'s padded slot.  The three passes
// (gate/up, down, per-token combine in a fixed order, no atomics) are
// moe_routed.cuh routed_moe, over one chunk that holds the whole batch.
// The TPU kernel's one-hot gather/combine matmuls were an MXU idiom: here
// rows are addressed by token id directly.
//
// Bound on the H100: bytes at decode sizes (each routed expert's 3*H*I
// int8 weights per layer against a few rows each), operations at
// 512-token prefill chunks (T*k rows x 6*H*I flops).  The dots run on
// the tensor cores (bf16 wmma, common.cuh); the weight loads are not yet
// pipelined against them.
#include "moe_routed.cuh"

// x [T, H] bf16; tok_pad [S_pad] i32, wslot [S_pad] f32 (0 = pad slot),
// tile_expert [NT] i32, num_tiles [1] i32 (device), pos [T, k] i32 padded
// slot of each (token, choice); stacked weights [Lm, E, ...]; act scratch
// [S_pad, I] bf16, y scratch [S_pad, H] bf16; out [T, H] f32.
// rt (the row tile) is 16, 32 or 64.
LLMD_EXPORT int llmd_moe_routed_int8(
    const void* x, const void* tok_pad, const void* wslot,
    const void* tile_expert, const void* num_tiles, const void* pos,
    const void* wg, const void* wu, const void* wd, const void* gs,
    const void* us, const void* ds, void* act, void* y, void* out, int T, int k,
    int NT, int E, int H, int I, int layer, int rt, void* stream) {
  return llmd::routed_moe(rt, x, tok_pad, wslot, tile_expert, num_tiles, pos,
                          wg, wu, wd, gs, us, ds, act, y, out, T, k, NT, E, H,
                          I, layer, stream);
}

LLMD_EXPORT const char* llmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
