"""Kernel D: routed int8 MoE FFN over the (token, expert) rows only.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/moe_routed.py``
``routed_moe_int8`` (64 < T <= 512).  It is kernel E's function over one
chunk, so it runs E's launch (``csrc/moe_streamed_int8.cu``, through
:func:`llm_d_tpu_torch.ops.moe_routed_stream.launch_streamed` with C =
1): the grouping launch, the pipelined gate/up and down passes, and the
per-token combine in a fixed order (no atomics).

What bounds it on the H100: bytes at decode sizes (each routed expert's
3*H*I int8 weights, ~3.1 MB for deepseek-v3-bench, against ~16 rows at
T = 128), operations at 512 tokens.  Row blocks of 32 rows at the
smallest sizes (:func:`~llm_d_tpu_torch.ops.moe_routed_stream.row_block_for`)
put every routed expert's weights through the ``cp.async`` ring once,
with two blocks an SM; the populated tile count is read on the device,
so the host never waits on routing.

``routed_moe_int8_plain`` is the plain PyTorch version of the same
function (CPU tests, and the reference ``chip_smoke.py`` holds the kernel
to).
"""

from __future__ import annotations

import torch

from llm_d_tpu_torch.ops.layers import silu
from llm_d_tpu_torch.ops.moe_routed_stream import launch_streamed


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
    _check(num_tiles.numel() == 1, "num_tiles must hold one count")
    out = launch_streamed(
        _check, x, tok_pad, wslot_pad, tile_expert, num_tiles.reshape(1),
        pos, layer, w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s,
        x.shape[0], row_tile)
    routed_moe_int8.launches += 1
    return out


routed_moe_int8.launches = 0
