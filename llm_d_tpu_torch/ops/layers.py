"""Transformer building blocks (port of ``llm_d_tpu.ops.layers``).

Plain functions over explicit weight tensors.  Matrix products take bf16
operands with f32 accumulation and round the result to the input dtype,
as ``jnp.dot(..., preferred_element_type=f32).astype(x.dtype)`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0, scaling_factor: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for the given absolute positions: [T, D/2] f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    pos = positions.float() / scaling_factor
    freqs = pos[:, None] * inv_freq[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (HF 'half-rotation' convention). x: [T, H, D]."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, None, :].to(x1.dtype)
    sin = sin[:, None, :].to(x1.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., in], w: [in, out]; f32 accumulation, output in x.dtype.

    On the card cuBLAS multiplies bf16 and rounds once; its reductions
    stay in f32 once :func:`~llm_d_tpu_torch.utils.device.resolve_device`
    has resolved a CUDA device (the engine does).  On the CPU the product
    runs in f32 and rounds once, which is what the JAX reference does
    there."""
    if x.is_cuda:
        y = torch.matmul(x, w.to(x.dtype))
    else:
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * 1 / (1 + exp(-x))`` op by op, as ``jax.nn.silu`` lowers: for
    bf16 inputs every step rounds to bf16 (``F.silu`` rounds once, which
    differs in the last bit for about a third of bf16 inputs)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    gate = linear(x, w_gate)
    up = linear(x, w_up)
    return linear(silu(gate) * up, w_down)
