"""Quantized collectives for the EP / TP path (port of
``llm_d_tpu.parallel.quant_collectives``).

  - :func:`quantize_rows` / :func:`dequantize_rows`: the per-row
    symmetric f32-scale wire format every quantized exchange ships (the
    int8 KV cache's scale arithmetic, ``ops.quant``); the scale vector
    travels in the payload's layout (the EP exchange packs the two into
    one byte exchange, ``ops.moe._pack_rows``).
  - :func:`quantized_psum`: an all-reduce with int8 wire bytes over a
    mesh axis: per-row-quantized chunks go to their owning rank by
    ``all_to_all``, partial sums accumulate there in f32, and the reduced
    chunks are re-quantized and all-gathered.
  - the byte models (:func:`a2a_row_bytes`, :func:`ep_a2a_bytes_per_token`,
    :func:`psum_bytes_per_token`): wire bytes per (token, choice) row,
    the engine's ``llmd_tpu:collective_bytes_total`` accounting.

``LLMD_COLLECTIVE_DTYPE`` (``auto``/``bf16``/``int8``) selects the wire:
``auto`` is int8 on an accelerator (the TPU in the JAX package, a CUDA
card here: the per-collective accuracy harness,
``ops.collective_accuracy``, holds it to its bounds) and bf16 on the
CPU, so CPU tests keep the exact wire unless they opt in.
``int8-dispatch`` (int8 dispatch, bf16 combine) is a function-level A/B
lever, not a valid environment value.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from llm_d_tpu_torch.ops.quant import dequantize_kv_block, quantize_kv_block
from llm_d_tpu_torch.utils.config import env_choice

COLLECTIVE_DTYPES = ("auto", "bf16", "int8")

# Every dispatched (token, choice) row also ships its local expert id
# (int32), counted so the accounting matches the wire.
DISPATCH_INDEX_BYTES = 4
# One symmetric f32 scale per quantized row (the sibling scale plane).
ROW_SCALE_BYTES = 4


def resolve_collective_dtype(explicit: Optional[str] = None,
                             backend: Optional[str] = None) -> str:
    """The wire mode: ``bf16``, ``int8`` (or ``int8-dispatch``).

    ``explicit`` wins over the environment knob and raises when unknown;
    the knob falls back to ``auto`` on invalid values.  ``auto`` is int8
    on an accelerator (``backend`` "cuda" or "tpu"; None reads whether
    CUDA is available) and bf16 on the CPU."""
    if explicit is not None:
        if explicit not in COLLECTIVE_DTYPES + ("int8-dispatch",):
            raise ValueError(
                f"collective_dtype={explicit!r}: expected one of "
                f"{COLLECTIVE_DTYPES + ('int8-dispatch',)}")
        mode = explicit
    else:
        mode = env_choice("LLMD_COLLECTIVE_DTYPE", "auto",
                          COLLECTIVE_DTYPES)
    if mode == "auto":
        if backend is None:
            backend = "cuda" if torch.cuda.is_available() else "cpu"
        mode = "int8" if backend in ("tpu", "cuda") else "bf16"
    return mode


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., N, H]`` rows -> (int8 payload, f32 scales ``[..., N]``)."""
    q, s = quantize_kv_block(x, 1)
    return q, s[..., 0]


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (scales ``[..., N]``)."""
    return dequantize_kv_block(q, scales[..., None], dtype)


def quantized_psum(x: torch.Tensor, mesh, axis, out_dtype=None
                   ) -> torch.Tensor:
    """All-reduce ``x`` ``[T, H]`` over ``axis`` of ``mesh`` with int8
    wire bytes (the JAX decomposition): every rank quantizes its rows,
    an ``all_to_all`` delivers chunk ``i`` (T/n rows) of every source to
    rank ``i``, which dequantizes and sums them in f32; the reduced chunk
    is re-quantized and all-gathered.  Pad rows (T not divisible by n)
    are exact zeros and are dropped."""
    n = mesh.axis_size(axis)
    T, H = x.shape
    xf = x.float()
    if T % n:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, -T % n))
    q, s = quantize_rows(xf)
    rq = mesh.all_to_all(q, axis)
    rs = mesh.all_to_all(s, axis)
    part = dequantize_rows(rq, rs).reshape(n, -1, H).sum(dim=0)
    gq, gs = quantize_rows(part)
    fq = mesh.all_gather(gq, axis, dim=0)
    fs = mesh.all_gather(gs, axis, dim=0)
    out = dequantize_rows(fq, fs)[:T]
    return out.to(out_dtype or x.dtype)


def a2a_row_bytes(h: int, mode: str) -> Dict[str, int]:
    """Wire bytes ONE dispatched (token, choice) row costs, by phase.
    ``mode`` is a resolved wire mode, or ``"f32-combine"`` (bf16
    dispatch, f32 combine: the baseline accounting)."""
    if mode == "int8":
        d, c = h + ROW_SCALE_BYTES, h + ROW_SCALE_BYTES
    elif mode == "int8-dispatch":
        d, c = h + ROW_SCALE_BYTES, 2 * h
    elif mode == "bf16":
        d, c = 2 * h, 2 * h
    elif mode == "f32-combine":
        d, c = 2 * h, 4 * h
    else:
        raise ValueError(f"unknown wire mode {mode!r}")
    return {"dispatch": d + DISPATCH_INDEX_BYTES, "combine": c}


def ep_a2a_bytes_per_token(h: int, k: int, mode: str,
                           layers: int = 1) -> int:
    """EP dispatch + combine wire bytes one token costs across ``layers``
    MoE layers (each of its ``k`` routed copies crosses twice)."""
    row = a2a_row_bytes(h, mode)
    return k * (row["dispatch"] + row["combine"]) * layers


def psum_bytes_per_token(h: int, mode: str) -> int:
    """Wire bytes one token's row costs in the psum all-reduce per MoE
    layer (both legs; the ring factor (n-1)/n folded to 1)."""
    if mode == "int8":
        return 2 * (h + ROW_SCALE_BYTES)
    if mode in ("bf16", "int8-dispatch"):
        return 2 * 4 * h
    raise ValueError(f"unknown wire mode {mode!r}")
