"""Symmetric int8 quantization: MoE expert weights and the KV / latent cache.

Port of ``llm_d_tpu.ops.quant``.  The scale planes must match the JAX
package bit for bit (the KV wire and offload formats carry them), so the
arithmetic is the same: f32 math, round half to even (``torch.round``),
clip to +-127, and the scale ``max(amax, 1e-8) * (1/127)``.  The JAX source
writes ``/ 127.0``, but it always runs under ``jit``, where XLA turns the
division by a constant into a multiply by its f32 reciprocal; that differs
in the last bit for a few percent of scales, and the port follows what the
JAX package actually computes.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

# Keys holding expert-major arrays [L, E, ...] in moe_layers (quantized
# variants carry _q int8 payloads and _s scales).
EXPERT_WEIGHT_KEYS = ("w_gate", "w_up", "w_down")

KV_CACHE_DTYPES = ("bf16", "int8")
KV_SCALE_GRANULARITIES = ("token", "head")
MLA_LATENT_DTYPES = ("auto", "bf16", "int8")

_INV_127 = 1.0 / 127.0


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the contraction dim of ``[..., K, N]`` weights;
    one f32 scale per output column: ``scale [..., 1, N]``."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * _INV_127
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def kv_scale_width(num_kv_heads: int, granularity: str) -> int:
    """Scale columns per cache row: 1 ("token") or KVH ("head")."""
    return num_kv_heads if granularity == "head" else 1


def quantize_kv_block(rows: torch.Tensor, scale_width: int,
                      amax_reduce=None, divide: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over KV rows ``[..., N, F]``: returns (q int8
    ``[..., N, F]``, scales f32 ``[..., N, SW]``), each scale covering one
    contiguous ``F / SW`` column group of its row.  ``amax_reduce`` maps
    the group amax first (under tensor parallelism, the max over the
    ranks that hold the rest of a row).  The scale is ``amax`` times the
    reciprocal of 127, as XLA computes it under jit (the engine's
    quantizer); ``divide`` divides instead, as an eager ``jnp`` call does
    (the accuracy harness's), by a 0-dim tensor: PyTorch's CUDA kernel
    turns a Python-number divisor into a reciprocal multiply."""
    f32 = rows.float()
    *lead, n, f = f32.shape
    g = f32.reshape(*lead, n, scale_width, f // scale_width)
    amax = g.abs().amax(dim=-1)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scales = (torch.clamp_min(amax, 1e-8)
              / torch.full((), 127.0, device=amax.device) if divide
              else torch.clamp_min(amax, 1e-8) * _INV_127)
    q = torch.clamp(torch.round(g / scales[..., None]), -127, 127)
    return q.reshape(f32.shape).to(torch.int8), scales


def dequantize_kv_block(q: torch.Tensor, scales: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_block`."""
    *lead, n, f = q.shape
    sw = scales.shape[-1]
    g = q.float().reshape(*lead, n, sw, f // sw)
    return (g * scales[..., None].float()).reshape(q.shape).to(dtype)


def quantize_moe_experts(params: Dict[str, Any]) -> Dict[str, Any]:
    """Replace moe_layers expert weights with int8 payload + scale pairs:
    ``w_gate [L,E,H,I]`` -> ``w_gate_q`` int8 + ``w_gate_s`` f32 [L,E,1,I].

    One layer plane at a time, so the f32 temporaries stay the size of one
    plane (about 0.27 GB at deepseek-v3-bench width) rather than the whole
    stack.  Each bf16 stack is popped from the caller's ``moe_layers``
    before it is converted, so it is freed once converted (unless the
    caller holds it elsewhere) and at most one bf16 stack is live."""
    ml = params["moe_layers"]
    for name in EXPERT_WEIGHT_KEYS:
        if name not in ml:
            continue
        w = ml.pop(name)
        L, E, K, N = w.shape
        q = torch.empty((L, E, K, N), dtype=torch.int8, device=w.device)
        s = torch.empty((L, E, 1, N), dtype=torch.float32, device=w.device)
        for li in range(L):
            q[li], s[li] = quantize_int8(w[li])
        del w
        ml[f"{name}_q"] = q
        ml[f"{name}_s"] = s
    return params
