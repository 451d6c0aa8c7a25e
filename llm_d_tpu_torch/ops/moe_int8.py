"""Kernel C: all-experts int8 MoE FFN for small batches (T <= 64).

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/moe_int8.py``
``dense_moe_int8``.  CUDA source: ``csrc/moe_dense_int8.cu`` (tile GEMM
in ``csrc/common.cuh``).

What bounds it on the H100: bytes -- every expert's int8 weights (3*H*I
bytes each, all E experts per layer) stream once for at most 64 tokens.
The design streams each weight byte once from device memory in pass 1
(gate/up, one block per expert x 64-column tile) and pass 2 (down, one
block per 64-column tile x expert group), keeps the int8 -> f32 convert
in shared memory next to the dot, applies the per-column scale to the f32
result, and sums experts in a fixed order (no atomics).

``dense_moe_int8_plain`` is the plain PyTorch version of the same
function (CPU tests, and the reference ``chip_smoke.py`` holds the kernel
to).
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


_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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
    groups = next(g for g in (8, 4, 2, 1) if E % g == 0)
    act = torch.empty((E, T, I), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((groups, T, H), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((T, H), dtype=torch.float32, device=x.device)
    _build.launch(
        "moe_dense_int8.cu", "llmd_moe_dense_int8", _ARGTYPES,
        x.data_ptr(), comb.data_ptr(), w_gate_q.data_ptr(), w_up_q.data_ptr(),
        w_down_q.data_ptr(), w_gate_s.data_ptr(), w_up_s.data_ptr(),
        w_down_s.data_ptr(), act.data_ptr(), partial.data_ptr(),
        out.data_ptr(), T, E, H, I, li, groups, tm,
        _build.stream_ptr(x.device))
    dense_moe_int8.launches += 1
    return out


dense_moe_int8.launches = 0
