"""Kernel E: chunk-streamed routed int8 MoE FFN for steps above 512 tokens.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/moe_routed_stream.py``
``streamed_moe_int8``.  CUDA source: ``csrc/moe_streamed_int8.cu`` (tile
GEMM in ``csrc/common.cuh``).

What bounds it on the H100: operations (``2*3*T*k*H*I`` flops, about
0.41 TFLOP per layer for a 8192-token deepseek-v3-bench step, against
201 MB of int8 expert weights).  The TPU chunked the batch so that ``x``
and the f32 output fit VMEM; here the chunks are only the metadata's
layout and every (chunk, tile) is an independent block.  The wrapper
orders the tiles expert-major across chunks so that one expert's weights
stay in L2 while its tiles from every chunk run, instead of streaming
all weights once per chunk; each token's k rows are combined in a fixed
order (no atomics).

``streamed_moe_int8_plain`` is the plain PyTorch version of the same
function (CPU tests, and the reference ``chip_smoke.py`` holds the kernel
to).
"""

from __future__ import annotations

import ctypes

import torch

from llm_d_tpu_torch.ops import _build
from llm_d_tpu_torch.ops.layers import silu
from llm_d_tpu_torch.ops.moe_int8 import check_int8_experts
from llm_d_tpu_torch.ops.moe_routed import ROW_TILES

_MAX_GRID_Y = 65535


def streamed_moe_int8_plain(x, tok_pad, wslot_pad, tile_expert, num_tiles,
                            pos, layer: int, w_gate_q, w_gate_s, w_up_q,
                            w_up_s, w_down_q, w_down_s, chunk_t: int,
                            row_tile: int) -> torch.Tensor:
    """x [Tp, H] bf16 (Tp = C * chunk_t); tok_pad / wslot_pad [C*S_pad_c]
    (chunk-local token id, combine weight); tile_expert [C*NT_c];
    num_tiles [C]; pos [Tp, k] global padded slot of each (token,
    choice) -> [Tp, H] f32.  Per populated tile:
    ``y = bf16(bf16(silu(x Wg sg) (x Wu su) wslot) Wd sd)``; each token
    sums its k slots' y rows in f32.  Rows are independent, so the tiles
    are evaluated one expert at a time."""
    li = int(layer)
    rt = row_tile
    Tp, H = x.shape
    C = num_tiles.shape[0]
    NT = tile_expert.shape[0]
    NT_c = NT // C
    dev = x.device
    tile_ids = torch.arange(NT, device=dev)
    live_tile = (tile_ids % NT_c) < num_tiles.long()[tile_ids // NT_c]
    slot_expert = tile_expert.long().repeat_interleave(rt)
    slot_live = live_tile.repeat_interleave(rt)
    chunk = torch.arange(NT * rt, device=dev) // (NT_c * rt)
    x_row = chunk * chunk_t + tok_pad.long()
    y = torch.zeros((NT * rt, H), dtype=torch.float32, device=dev)
    for e in torch.unique(slot_expert[slot_live]).tolist():
        sel = torch.nonzero(slot_live & (slot_expert == e)).reshape(-1)
        xg = x[x_row[sel]].float()
        h = (xg @ w_gate_q[li, e].float()) * w_gate_s[li, e]
        u = (xg @ w_up_q[li, e].float()) * w_up_s[li, e]
        a = (silu(h) * u * wslot_pad[sel, None]).to(torch.bfloat16).float()
        y[sel] = ((a @ w_down_q[li, e].float()) * w_down_s[li, e]).to(
            torch.bfloat16).float()
    return y[pos.long()].sum(dim=1)


_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"streamed_moe_int8: {msg}")


def streamed_moe_int8(x, tok_pad, wslot_pad, tile_expert, num_tiles, pos,
                      layer: int, w_gate_q, w_gate_s, w_up_q, w_up_s,
                      w_down_q, w_down_s, chunk_t: int,
                      row_tile: int) -> torch.Tensor:
    """[Tp, H] f32 routed MoE output in token order.  CPU tensors run
    :func:`streamed_moe_int8_plain`; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return streamed_moe_int8_plain(
            x, tok_pad, wslot_pad, tile_expert, num_tiles, pos, layer,
            w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s,
            chunk_t, row_tile)
    li = int(layer)
    Lm, E, H, I = check_int8_experts(_check, x, w_gate_q, w_gate_s, w_up_q,
                                     w_up_s, w_down_q, w_down_s, li)
    Tp = x.shape[0]
    rt = row_tile
    C = num_tiles.shape[0]
    NT = tile_expert.shape[0]
    _check(rt in ROW_TILES, f"row_tile {rt} unsupported")
    _check(C > 0 and Tp == C * chunk_t and NT % C == 0 and NT <= _MAX_GRID_Y,
           "x must hold C * chunk_t rows and tile_expert C * NT_c tiles")
    NT_c = NT // C
    k = pos.shape[1] if pos.ndim == 2 else 0
    _check(pos.shape == (Tp, k) and pos.dtype == torch.int32,
           "pos must be int32 [Tp, k]")
    _check(tok_pad.dtype == torch.int32 and wslot_pad.dtype == torch.float32
           and tok_pad.shape == wslot_pad.shape == (NT * rt,)
           and tile_expert.dtype == num_tiles.dtype == torch.int32
           and num_tiles.shape == (C,),
           "routing metadata must be int32/f32 [C*S_pad_c] / [C*NT_c] / [C]")
    for t in (tok_pad, wslot_pad, tile_expert, num_tiles, pos):
        _check(t.device == x.device and t.is_contiguous(),
               "metadata must be contiguous and on x's device")
    # Expert-major tile order across chunks (idle tiles last), so that an
    # expert's weights are read from L2 by its tiles of every chunk.
    tile_ids = torch.arange(NT, device=x.device)
    live = (tile_ids % NT_c) < num_tiles.long()[tile_ids // NT_c]
    key = torch.where(live, tile_expert.long(), E)
    tile_order = torch.sort(key, stable=True).indices.to(torch.int32)
    act = torch.empty((NT * rt, I), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((NT * rt, H), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((Tp, H), dtype=torch.float32, device=x.device)
    _build.launch(
        "moe_streamed_int8.cu", "llmd_moe_streamed_int8", _ARGTYPES,
        x.data_ptr(), tok_pad.data_ptr(), wslot_pad.data_ptr(),
        tile_expert.data_ptr(), num_tiles.data_ptr(), pos.data_ptr(),
        tile_order.data_ptr(), w_gate_q.data_ptr(), w_up_q.data_ptr(),
        w_down_q.data_ptr(), w_gate_s.data_ptr(), w_up_s.data_ptr(),
        w_down_s.data_ptr(), act.data_ptr(), y.data_ptr(), out.data_ptr(),
        Tp, k, NT, NT_c, chunk_t, E, H, I, li, rt,
        _build.stream_ptr(x.device))
    streamed_moe_int8.launches += 1
    return out


streamed_moe_int8.launches = 0
