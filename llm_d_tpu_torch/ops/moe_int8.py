"""Kernels C and F, the int8 MoE FFNs of ``llm_d_tpu/ops/pallas/moe_int8.py``.

Kernel C: the int8 MoE FFN for small batches (T <= 64) over the routed
experts.  Replaces the TPU kernel ``dense_moe_int8``.  CUDA source:
``csrc/moe_dense_int8.cu`` (cp.async and mma.sync primitives in
``csrc/pipeline.cuh``).

What bounds it on the H100: bytes -- the int8 weights (3*H*I bytes each)
of the experts that a token is routed to, once for at most 64 tokens.
An unrouted expert's ``comb`` column is zero, so it adds exactly 0 (the
TPU kernel multiplies it by 0): the kernel decides on the device which
experts are routed and reads no weight of the others.  Pass 1 (gate/up,
one block per expert x 128-column tile) and pass 2 (down, one block per
128-column tile x group of experts, routed experts in order) stream their
int8 tiles as stored through a ring of 16-byte ``cp.async`` copies, so
each SM keeps tens of KB of weight loads in flight, and widen them to
bf16 in the tensor-core fragments; the per-column scale multiplies the
f32 result, and groups are summed in a fixed order (no atomics).

Kernel F: grouped int8 MoE FFN over rows sorted by expert and padded to
the row tile, the ``LLMD_MOE_PREFILL_KERNEL=grouped`` lever above 512
tokens.  Replaces the TPU kernel ``grouped_moe_int8``.  It runs kernel
E's pipelined gate/up and down passes (``csrc/moe_streamed_int8.cu``
``llmd_moe_grouped_int8``) with the identity row map: the rows arrive
contiguous, so a block takes a slice of 128 (or 64, 32) rows of one
tile without a gather, and pass 2's combine-weighted bf16 rows are the
output (no combine pass: the glue un-sorts them).  What bounds it on the
H100: operations (6*H*I flops per padded row).  Consecutive blocks of one
expert reuse its weights from L2, and blocks past the populated tiles
write zeros without reading any weight.

``dense_moe_int8_plain`` and ``grouped_moe_int8_plain`` are the plain
PyTorch versions of the same functions (CPU tests, and the reference
``chip_smoke.py`` holds the kernels to).
"""

from __future__ import annotations

import ctypes

import torch

from llm_d_tpu_torch.ops import _build
from llm_d_tpu_torch.ops.layers import silu


def dense_moe_int8_plain(x, comb, layer: int, w_gate_q, w_gate_s, w_up_q,
                         w_up_s, w_down_q, w_down_s) -> torch.Tensor:
    """x [T, H] bf16, comb [T, E] f32, stacked [Lm, E, ...] int8 weights
    with [Lm, E, 1, N] f32 scales -> [T, H] f32:
    ``sum_e bf16(silu(x Wg sg) (x Wu su) comb[:, e]) Wd_e sd_e``."""
    li = int(layer)
    xf = x.float()
    h = torch.einsum("th,ehi->eti", xf, w_gate_q[li].float()) * w_gate_s[li]
    u = torch.einsum("th,ehi->eti", xf, w_up_q[li].float()) * w_up_s[li]
    a = (silu(h) * u * comb.float().T[:, :, None]).to(torch.bfloat16)
    y = torch.einsum("eti,eih->eth", a.float(), w_down_q[li].float()) \
        * w_down_s[li]
    return y.sum(dim=0)


def grouped_moe_int8_plain(x_pad, wslot_pad, tile_expert, num_tiles,
                           layer: int, w_gate_q, w_gate_s, w_up_q, w_up_s,
                           w_down_q, w_down_s, row_tile: int) -> torch.Tensor:
    """x_pad [S_pad, H] bf16 rows sorted by expert, wslot_pad [S_pad] f32,
    tile_expert [S_pad / row_tile], num_tiles [1] -> [S_pad, H] bf16:
    ``bf16(bf16(silu(x Wg sg) (x Wu su) wslot) Wd sd)`` per row of a
    populated tile, zeros past them.  Rows are independent, so the tiles
    are evaluated one expert at a time."""
    li = int(layer)
    rt = row_tile
    S_pad, H = x_pad.shape
    y = torch.zeros((S_pad, H), dtype=torch.bfloat16, device=x_pad.device)
    n_live = int(num_tiles.reshape(-1)[0]) * rt
    row_expert = tile_expert.long().repeat_interleave(rt)[:n_live]
    for e in torch.unique(row_expert).tolist():
        sel = torch.nonzero(row_expert == e).reshape(-1)
        xg = x_pad[sel].float()
        h = (xg @ w_gate_q[li, e].float()) * w_gate_s[li, e]
        u = (xg @ w_up_q[li, e].float()) * w_up_s[li, e]
        a = (silu(h) * u * wslot_pad[sel, None]).to(torch.bfloat16).float()
        y[sel] = ((a @ w_down_q[li, e].float()) * w_down_s[li, e]).to(
            torch.bfloat16)
    return y


_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_GROUPED_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]


def dense_groups(E: int) -> int:
    """Expert groups of kernel C's pass 2 (H/128 x groups blocks, a
    group's routed experts summed in order): the most of 16, 8, 4, 2, 1
    dividing ``E`` into groups of at most 64 experts; else 16 groups of
    ceil(E / 16) experts, the last ones shorter (an EPLB physical table
    of E + r slots need not divide)."""
    _check(E <= 16 * 64, f"E={E} needs groups of at most 64 experts")
    return next((g for g in (16, 8, 4, 2, 1) if E % g == 0 and E // g <= 64),
                16)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dense_moe_int8: {msg}")


def check_int8_experts(check, x, w_gate_q, w_gate_s, w_up_q, w_up_s,
                       w_down_q, w_down_s, layer: int):
    """Shape/dtype/layout checks shared by the two int8 MoE wrappers;
    returns (Lm, E, H, I)."""
    Lm, E, H, I = w_gate_q.shape
    check(x.dtype == torch.bfloat16 and x.ndim == 2 and x.shape[1] == H,
          "x must be bf16 [T, H]")
    check(w_gate_q.dtype == w_up_q.dtype == w_down_q.dtype == torch.int8,
          "expert payloads must be int8")
    check(w_up_q.shape == (Lm, E, H, I) and w_down_q.shape == (Lm, E, I, H),
          "expert payload shapes disagree")
    check(w_gate_s.shape == w_up_s.shape == (Lm, E, 1, I)
          and w_down_s.shape == (Lm, E, 1, H)
          and w_gate_s.dtype == w_up_s.dtype == w_down_s.dtype
          == torch.float32, "expert scales must be f32 [Lm, E, 1, N]")
    check(H % 128 == 0 and I % 128 == 0,
          "H and I must be multiples of 128 (column tile and K step)")
    check(0 <= layer < Lm, f"layer {layer} out of range")
    for t in (x, w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s):
        check(t.device == x.device and t.is_contiguous(),
              "inputs must be contiguous and on one device")
    return Lm, E, H, I


def dense_moe_int8(x, comb, layer: int, w_gate_q, w_gate_s, w_up_q, w_up_s,
                   w_down_q, w_down_s) -> torch.Tensor:
    """[T, H] f32 routed MoE output.  CPU tensors run
    :func:`dense_moe_int8_plain`; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return dense_moe_int8_plain(x, comb, layer, w_gate_q, w_gate_s,
                                    w_up_q, w_up_s, w_down_q, w_down_s)
    li = int(layer)
    Lm, E, H, I = check_int8_experts(_check, x, w_gate_q, w_gate_s, w_up_q,
                                     w_up_s, w_down_q, w_down_s, li)
    T = x.shape[0]
    _check(comb.dtype == torch.float32 and comb.shape == (T, E)
           and comb.is_contiguous() and comb.device == x.device,
           "comb must be contiguous f32 [T, E]")
    tm = 16 if T <= 16 else (32 if T <= 32 else 64)
    groups = dense_groups(E)
    _check(x.data_ptr() % 16 == 0 and w_gate_q.data_ptr() % 16 == 0
           and w_up_q.data_ptr() % 16 == 0 and w_down_q.data_ptr() % 16 == 0,
           "x and the int8 weights must be 16-byte aligned (cp.async rows)")
    # One scratch tensor: bf16 act [E, T, I], then f32 partial
    # [groups, T, H] (I % 128 == 0 keeps it 16-byte aligned).
    act_bytes = E * T * I * 2
    scratch = torch.empty(act_bytes + groups * T * H * 4, dtype=torch.uint8,
                          device=x.device)
    out = torch.empty((T, H), dtype=torch.float32, device=x.device)
    _build.launch(
        "moe_dense_int8.cu", "llmd_moe_dense_int8", _ARGTYPES,
        x.data_ptr(), comb.data_ptr(), w_gate_q.data_ptr(), w_up_q.data_ptr(),
        w_down_q.data_ptr(), w_gate_s.data_ptr(), w_up_s.data_ptr(),
        w_down_s.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + act_bytes, out.data_ptr(), T, E, H, I, li,
        groups, tm, _build.stream_ptr(x.device))
    dense_moe_int8.launches += 1
    return out


dense_moe_int8.launches = 0


def _grouped_check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped_moe_int8: {msg}")


def grouped_moe_int8(x_pad, wslot_pad, tile_expert, num_tiles, layer: int,
                     w_gate_q, w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s,
                     row_tile: int) -> torch.Tensor:
    """[S_pad, H] bf16 combine-weighted rows.  CPU tensors run
    :func:`grouped_moe_int8_plain`; CUDA tensors launch the kernel or
    raise."""
    if not x_pad.is_cuda:
        return grouped_moe_int8_plain(
            x_pad, wslot_pad, tile_expert, num_tiles, layer, w_gate_q,
            w_gate_s, w_up_q, w_up_s, w_down_q, w_down_s, row_tile)
    li = int(layer)
    check = _grouped_check
    Lm, E, H, I = check_int8_experts(check, x_pad, w_gate_q, w_gate_s,
                                     w_up_q, w_up_s, w_down_q, w_down_s, li)
    S_pad = x_pad.shape[0]
    rt = row_tile
    check(rt % 32 == 0 and S_pad % rt == 0,
          f"row_tile {rt} must be a multiple of 32 dividing S_pad={S_pad}")
    tm = next(t for t in (128, 64, 32) if rt % t == 0)
    check(S_pad // tm <= 65535, f"S_pad={S_pad} exceeds the grid")
    check(wslot_pad.dtype == torch.float32 and wslot_pad.shape == (S_pad,)
          and tile_expert.dtype == num_tiles.dtype == torch.int32
          and tile_expert.shape == (S_pad // rt,) and num_tiles.numel() == 1,
          "metadata must be f32 [S_pad] / int32 [S_pad / rt] / int32 [1]")
    for t in (wslot_pad, tile_expert, num_tiles):
        check(t.device == x_pad.device and t.is_contiguous(),
              "metadata must be contiguous and on x's device")
    check(all(t.data_ptr() % 16 == 0
              for t in (x_pad, w_gate_q, w_up_q, w_down_q)),
          "x_pad and the expert payloads must be 16-byte aligned (cp.async "
          "rows)")
    act = torch.empty((S_pad, I), dtype=torch.bfloat16, device=x_pad.device)
    y = torch.empty((S_pad, H), dtype=torch.bfloat16, device=x_pad.device)
    _build.launch(
        "moe_streamed_int8.cu", "llmd_moe_grouped_int8", _GROUPED_ARGTYPES,
        x_pad.data_ptr(), wslot_pad.data_ptr(), tile_expert.data_ptr(),
        num_tiles.data_ptr(), w_gate_q.data_ptr(), w_up_q.data_ptr(),
        w_down_q.data_ptr(), w_gate_s.data_ptr(), w_up_s.data_ptr(),
        w_down_s.data_ptr(), act.data_ptr(), y.data_ptr(), S_pad, rt, E, H,
        I, li, tm, _build.stream_ptr(x_pad.device))
    grouped_moe_int8.launches += 1
    return y


grouped_moe_int8.launches = 0
