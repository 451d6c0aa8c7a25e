"""Kernel D: routed int8 MoE FFN over the (token, expert) rows only.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/moe_routed.py``
``routed_moe_int8``.  CUDA source: ``csrc/moe_routed_int8.cu`` (tile GEMM
in ``csrc/common.cuh``).

What bounds it on the H100: bytes at decode sizes (each routed expert's
3*H*I int8 weights against a handful of rows), operations at 512-token
prefill chunks (T*k rows x 6*H*I flops).  The design gathers each row
tile's activations by token id (the TPU's one-hot gather matmul was an
MXU idiom), runs one expert per tile so its weights stream once per
tile, reads the populated tile count from device memory so the host never
waits on routing, and combines each token's k rows in a fixed order
(no atomics).

``routed_moe_int8_plain`` is the plain PyTorch version of the same
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


def routed_moe_int8_plain(x, tok_pad, wslot_pad, tile_expert, num_tiles, pos,
                          layer: int, w_gate_q, w_gate_s, w_up_q, w_up_s,
                          w_down_q, w_down_s, row_tile: int) -> torch.Tensor:
    """x [T, H] bf16; tok_pad / wslot_pad [S_pad] per padded slot;
    tile_expert [NT]; num_tiles [1]; pos [T, k] padded slot of each
    (token, choice) -> [T, H] f32.  Per populated tile:
    ``y = bf16(bf16(silu(x Wg sg) (x Wu su) wslot) Wd sd)``; each token
    sums its k slots' y rows in f32."""
    li = int(layer)
    rt = row_tile
    S_pad = tok_pad.shape[0]
    H = x.shape[1]
    y = torch.zeros((S_pad, H), dtype=torch.float32, device=x.device)
    nt = int(num_tiles.reshape(-1)[0])
    experts = tile_expert[:nt].tolist()
    for t, e in enumerate(experts):
        sl = slice(t * rt, (t + 1) * rt)
        xg = x[tok_pad[sl].long()].float()
        h = (xg @ w_gate_q[li, e].float()) * w_gate_s[li, e]
        u = (xg @ w_up_q[li, e].float()) * w_up_s[li, e]
        a = (silu(h) * u * wslot_pad[sl, None]).to(torch.bfloat16).float()
        y[sl] = ((a @ w_down_q[li, e].float()) * w_down_s[li, e]).to(
            torch.bfloat16).float()
    return y[pos.long()].sum(dim=1)


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"routed_moe_int8: {msg}")


def routed_moe_int8(x, tok_pad, wslot_pad, tile_expert, num_tiles, pos,
                    layer: int, w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q,
                    w_down_s, row_tile: int) -> torch.Tensor:
    """[T, H] f32 routed MoE output in token order.  CPU tensors run
    :func:`routed_moe_int8_plain`; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return routed_moe_int8_plain(
            x, tok_pad, wslot_pad, tile_expert, num_tiles, pos, layer,
            w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s, row_tile)
    li = int(layer)
    Lm, E, H, I = check_int8_experts(_check, x, w_gate_q, w_gate_s, w_up_q,
                                     w_up_s, w_down_q, w_down_s, li)
    T = x.shape[0]
    rt = row_tile
    S_pad = tok_pad.shape[0]
    _check(rt in ROW_TILES and S_pad % rt == 0, f"row_tile {rt} unsupported")
    NT = S_pad // rt
    k = pos.shape[1] if pos.ndim == 2 else 0
    _check(pos.shape == (T, k) and pos.dtype == torch.int32,
           "pos must be int32 [T, k]")
    _check(tok_pad.dtype == torch.int32 and wslot_pad.dtype == torch.float32
           and wslot_pad.shape == (S_pad,) and tile_expert.shape == (NT,)
           and tile_expert.dtype == torch.int32
           and num_tiles.dtype == torch.int32 and num_tiles.numel() == 1,
           "routing metadata must be int32/f32 [S_pad] / [NT] / [1]")
    for t in (tok_pad, wslot_pad, tile_expert, num_tiles, pos):
        _check(t.device == x.device and t.is_contiguous(),
               "metadata must be contiguous and on x's device")
    act = torch.empty((S_pad, I), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((S_pad, H), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((T, H), dtype=torch.float32, device=x.device)
    _build.launch(
        "moe_routed_int8.cu", "llmd_moe_routed_int8", _ARGTYPES,
        x.data_ptr(), tok_pad.data_ptr(), wslot_pad.data_ptr(),
        tile_expert.data_ptr(), num_tiles.data_ptr(), pos.data_ptr(),
        w_gate_q.data_ptr(), w_up_q.data_ptr(), w_down_q.data_ptr(),
        w_gate_s.data_ptr(), w_up_s.data_ptr(), w_down_s.data_ptr(),
        act.data_ptr(), y.data_ptr(), out.data_ptr(),
        T, k, NT, E, H, I, li, rt, _build.stream_ptr(x.device))
    routed_moe_int8.launches += 1
    return out


routed_moe_int8.launches = 0
