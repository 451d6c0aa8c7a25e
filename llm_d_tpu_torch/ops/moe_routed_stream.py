"""Kernel E: chunk-streamed routed int8 MoE FFN for steps above 512 tokens,
and the launch it shares with kernel D.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/moe_routed_stream.py``
``streamed_moe_int8``.  CUDA source: ``csrc/moe_streamed_int8.cu`` (the
ring and the int8 fragment step in ``csrc/pipeline.cuh``, shared with
kernel C), which also runs kernels D (one chunk) and F (identity rows).

What bounds it on the H100: operations (``2*3*T*k*H*I`` flops, about
0.41 TFLOP per layer for a 8192-token deepseek-v3-bench step, against
201 MB of int8 expert weights).  The TPU chunked the batch so that ``x``
and the f32 output fit VMEM; here the chunks are only the metadata's
layout.  The kernel's first launch groups the populated tiles,
expert-major across chunks, into row blocks of 32, 64 or 128 rows of one
expert (:func:`row_block_for`, :func:`expert_row_blocks`, plain version
:func:`expert_row_blocks_plain`), so a weight byte is widened once for up
to 128 rows and an expert's weights stay in L2 while its blocks run; the
passes stream the int8 weight tiles and the gathered rows through a
``cp.async`` ring and widen the weights inside the ``mma.sync``
fragments.  Each token's k rows are combined in a fixed order (no
atomics).

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

ROW_TILES = (16, 32, 64)
_MAX_GRID_Y = 65535
_MAX_EXPERTS = 256         # the grouping launch's per-expert tables


def row_block_for(rows: int, E: int, row_tile: int) -> int:
    """The kernel's row block from the mean routed rows per expert: 128
    rows from 256, 64 from 32, else 32 (kernel D's decode waves: ~16 rows
    an expert at T = 128); never shorter than the row tile."""
    tm = 128 if rows >= 256 * E else (64 if rows >= 32 * E else 32)
    return max(tm, row_tile)


def _num_blocks(NT: int, E: int, per_block: int) -> int:
    """A bound on the row blocks: sum over experts of ceil(n_e / G) is at
    most NT // G + E, and at most NT."""
    return min(NT, NT // per_block + E)


def expert_row_blocks_plain(tile_expert: torch.Tensor,
                            num_tiles: torch.Tensor, E: int,
                            per_block: int) -> torch.Tensor:
    """Row blocks of the streamed kernel (the plain version of its first
    launch), computed on the tiles' device without a host sync: the
    populated tiles in expert-major order across
    chunks (stable, so chunk order within an expert), each expert's run
    padded to a multiple of ``per_block`` and cut into blocks.  Returns
    int32 ``[NB, per_block]`` tile ids, -1 past an expert's last tile;
    ``NB = min(NT, NT // per_block + E)`` bounds the count, and rows past
    the populated blocks are all -1."""
    NT = tile_expert.shape[0]
    C = num_tiles.shape[0]
    G = per_block
    dev = tile_expert.device
    live = torch.arange(NT // C, device=dev) < num_tiles[:, None]
    key = torch.where(live.reshape(-1), tile_expert, E)
    key_s, order = torch.sort(key, stable=True)
    # Sorted position p of expert e moves to p + shift[e], where its run
    # starts once every run is padded to a multiple of G; idle tiles (key
    # E) go to a dropped row.
    starts = torch.searchsorted(
        key_s, torch.arange(E + 1, dtype=key_s.dtype, device=dev))
    run = (starts.diff() + G - 1) // G * G
    shift = torch.cumsum(run, 0) - run - starts[:-1]
    NB = _num_blocks(NT, E, G)
    dest = torch.where(key_s < E, torch.arange(NT, device=dev)
                       + shift[key_s.clamp(max=E - 1)], NB * G)
    table = torch.full(((NB + 1) * G,), -1, dtype=torch.int32, device=dev)
    table[dest] = order.to(torch.int32)
    return table.reshape(NB + 1, G)[:NB]


_BLOCK_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


def expert_row_blocks(tile_expert: torch.Tensor, num_tiles: torch.Tensor,
                      E: int, per_block: int) -> torch.Tensor:
    """:func:`expert_row_blocks_plain` for CPU tensors; on CUDA tensors the
    kernel's own grouping launch (the one :func:`streamed_moe_int8` makes
    before its passes)."""
    if not tile_expert.is_cuda:
        return expert_row_blocks_plain(tile_expert, num_tiles, E, per_block)
    NT, C = tile_expert.shape[0], num_tiles.shape[0]
    NB = _num_blocks(NT, E, per_block)
    blocks = torch.empty((NB, per_block), dtype=torch.int32,
                         device=tile_expert.device)
    _build.launch(
        "moe_streamed_int8.cu", "llmd_moe_stream_blocks", _BLOCK_ARGTYPES,
        tile_expert.data_ptr(), num_tiles.data_ptr(), blocks.data_ptr(), C,
        NT // C, E, per_block, NB, _build.stream_ptr(tile_expert.device))
    return blocks


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


_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"streamed_moe_int8: {msg}")


def streamed_moe_int8(x, tok_pad, wslot_pad, tile_expert, num_tiles, pos,
                      layer: int, w_gate_q, w_gate_s, w_up_q, w_up_s,
                      w_down_q, w_down_s, chunk_t: int,
                      row_tile: int) -> torch.Tensor:
    """[Tp, H] f32 routed MoE output in token order.  CPU tensors run
    :func:`streamed_moe_int8_plain`; CUDA tensors launch the kernel (rows
    per block: :func:`row_block_for`) or raise."""
    if not x.is_cuda:
        return streamed_moe_int8_plain(
            x, tok_pad, wslot_pad, tile_expert, num_tiles, pos, layer,
            w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s,
            chunk_t, row_tile)
    out = launch_streamed(
        _check, x, tok_pad, wslot_pad, tile_expert, num_tiles, pos, layer,
        w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s, chunk_t,
        row_tile)
    streamed_moe_int8.launches += 1
    return out


streamed_moe_int8.launches = 0


def launch_streamed(check, x, tok_pad, wslot_pad, tile_expert, num_tiles,
                    pos, layer: int, w_gate_q, w_gate_s, w_up_q, w_up_s,
                    w_down_q, w_down_s, chunk_t: int,
                    row_tile: int) -> torch.Tensor:
    """Checks the inputs and launches ``csrc/moe_streamed_int8.cu`` over
    ``C = num_tiles.shape[0]`` chunks: the grouping launch, passes 1-2
    and the combine.  Kernels E and D (one chunk) share it; ``check``
    raises with the caller's name."""
    li = int(layer)
    Lm, E, H, I = check_int8_experts(check, x, w_gate_q, w_gate_s, w_up_q,
                                     w_up_s, w_down_q, w_down_s, li)
    Tp = x.shape[0]
    rt = row_tile
    C = num_tiles.shape[0]
    NT = tile_expert.shape[0]
    check(rt in ROW_TILES, f"row_tile {rt} unsupported")
    check(C > 0 and Tp == C * chunk_t and NT % C == 0 and NT <= _MAX_GRID_Y,
          "x must hold C * chunk_t rows and tile_expert C * NT_c tiles")
    NT_c = NT // C
    k = pos.shape[1] if pos.ndim == 2 else 0
    check(pos.shape == (Tp, k) and pos.dtype == torch.int32,
          "pos must be int32 [Tp, k]")
    check(tok_pad.dtype == torch.int32 and wslot_pad.dtype == torch.float32
          and tok_pad.shape == wslot_pad.shape == (NT * rt,)
          and tile_expert.dtype == num_tiles.dtype == torch.int32
          and num_tiles.shape == (C,),
          "routing metadata must be int32/f32 [C*S_pad_c] / [C*NT_c] / [C]")
    for t in (tok_pad, wslot_pad, tile_expert, num_tiles, pos):
        check(t.device == x.device and t.is_contiguous(),
              "metadata must be contiguous and on x's device")
    check(all(t.data_ptr() % 16 == 0
              for t in (x, w_gate_q, w_up_q, w_down_q)),
          "x and the expert payloads must be 16-byte aligned (cp.async "
          "rows)")
    tm = row_block_for(Tp * k, E, rt)
    check(E <= _MAX_EXPERTS, f"E={E} > {_MAX_EXPERTS}")
    blocks = torch.empty(_num_blocks(NT, E, tm // rt) * (tm // rt),
                         dtype=torch.int32, device=x.device)
    act = torch.empty((NT * rt, I), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((NT * rt, H), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((Tp, H), dtype=torch.float32, device=x.device)
    _build.launch(
        "moe_streamed_int8.cu", "llmd_moe_streamed_int8", _ARGTYPES,
        x.data_ptr(), tok_pad.data_ptr(), wslot_pad.data_ptr(),
        tile_expert.data_ptr(), num_tiles.data_ptr(), blocks.data_ptr(),
        pos.data_ptr(), w_gate_q.data_ptr(), w_up_q.data_ptr(),
        w_down_q.data_ptr(), w_gate_s.data_ptr(), w_up_s.data_ptr(),
        w_down_s.data_ptr(), act.data_ptr(), y.data_ptr(), out.data_ptr(), Tp,
        k, C, blocks.shape[0] // (tm // rt), NT_c, chunk_t, E, H, I, li, rt,
        tm, _build.stream_ptr(x.device))
    return out
