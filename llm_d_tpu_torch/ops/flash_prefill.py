"""Kernel H: dense (GQA) causal flash prefill over the paged K/V cache.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/flash_prefill.py``
``flash_prefill_paged``.  CUDA source: ``csrc/flash_prefill.cu`` (key-tile
copies in ``csrc/common.cuh``, shared with kernel G; int8 fragment reads
in ``csrc/mla_page.cuh``).

What bounds it on the H100: bytes at the engine's prefill shapes (each
live query row read and written once, each key below a sequence's bound
read once; 4*D flops per head per causal (query, key) pair are a fifth of
that time at the tensor-core rate).  The design is FlashAttention-2 on
``mma.sync``, as kernel B: one block per (KV head, sequence, tile of 64
fused (position, head) rows), each key tile loaded once per block through
a double-buffered ``cp.async`` ring, as the cache stores it (bf16 read by
``ldmatrix``, int8 widened in the fragments of both dots); scores, ``p``
and the f32 statistics stay in registers, each warp stops at its own
rows' causal bound, and masks apply only on the tiles that cross a
bound.  The key tile
(:func:`prefill_plan`) depends on D and the cache dtype, never on the
block size: a key finds its page through the block table.

Read-only: the caller scatters this step's rows and scales first.
``flash_prefill_paged_plain`` is the plain PyTorch version (CPU tests,
and the reference ``chip_smoke.py`` holds the kernel to).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from llm_d_tpu_torch.ops import _build
from llm_d_tpu_torch.ops.attention import NEG_INF
from llm_d_tpu_torch.ops.mla_decode import _align128
from llm_d_tpu_torch.ops.paged_attention import (
    check_kv_cache, kv_planes, page_rows)

ROWS = 64                # fused (position, head) rows of a block
KEY_TILE = 64            # csrc/flash_prefill.cu kKT


def flash_prefill_paged_plain(
    qs: torch.Tensor,             # [S, Q, H, D] per-seq padded queries
    q_pos: torch.Tensor,          # [S, Q] i32 (pad -> -1)
    k_cache: torch.Tensor,        # [L, slots, KVH*D] or [slots, KVH*D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,   # [S, B]
    seq_lens: torch.Tensor,       # [S]
    block_size: int,
    num_kv_heads: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:                # [S, Q, H, D]
    """Each query row attends keys ``< min(seq_len, q_pos + 1)`` with the
    kernel's page-by-page recurrence (bf16 ``q * scale``, bf16 pages,
    optional ``soft_cap * tanh(s / soft_cap)``, bf16 ``p`` in the value
    dot, f32 statistics)."""
    S, Q, H, D = qs.shape
    KVH = num_kv_heads
    G = H // KVH
    bs = block_size
    dev = qs.device
    scale = scale if scale is not None else D ** -0.5
    kp, ksp = kv_planes(k_cache, k_scale, layer)
    vp, vsp = kv_planes(v_cache, v_scale, layer)
    bt = block_tables.long()
    n_keys = torch.minimum(seq_lens.long()[:, None], q_pos.long() + 1)
    qb = (qs.float() * scale).to(torch.bfloat16).float().reshape(
        S, Q, KVH, G, D)
    m = torch.full((S, Q, KVH, G), -1e29, device=dev)
    l = torch.zeros((S, Q, KVH, G), device=dev)
    acc = torch.zeros((S, Q, KVH, G, D), device=dev)
    n_pages = int((n_keys.max().clamp(min=0) + bs - 1) // bs) if S * Q else 0
    offs = torch.arange(bs, device=dev)
    for j in range(n_pages):
        slots = bt[:, j:j + 1] * bs + offs[None, :]             # [S, bs]
        k = page_rows(kp, ksp, slots, D)                        # [S,bs,KVH,D]
        v = page_rows(vp, vsp, slots, D)
        s = torch.einsum("sqkgd,sbkd->sqkgb", qb, k)
        if soft_cap is not None:
            s = soft_cap * torch.tanh(s / soft_cap)
        valid = (j * bs + offs)[None, None, :] < n_keys[:, :, None]
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("sqkgb,sbkd->sqkgd",
                          p.to(torch.bfloat16).float(), v)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(S, Q, H, D).to(qs.dtype)


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_VP] * 9 + [_I] * 8 + [_LL, _I, _F, _F, _I, _VP]


@functools.lru_cache(maxsize=None)
def prefill_plan(D: int, quantized: bool):
    """Kernel H's plan for heads of ``D`` columns: ``(kt, smem)``, the key
    tile and the block's dynamic shared memory (csrc/flash_prefill.cu
    PrefillSmem): the q tile [64, D+8] bf16, then two stages of K and V
    tiles [kt, D*esz + 16] bytes and, for int8, their [kt] f32 scales,
    each part 128-B aligned.  kt = 64 fits every head size the kernel
    takes; the block size plays no part."""
    a = _align128
    kt = KEY_TILE
    tile = a(kt * (D * (1 if quantized else 2) + 16))
    stage = a(2 * tile + (2 * kt * 4 if quantized else 0))
    return kt, a(ROWS * (D + 8) * 2) + 2 * stage


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_prefill_paged: {msg}")


def flash_prefill_paged(
    qs: torch.Tensor,
    q_pos: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    block_size: int,
    num_kv_heads: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention outputs ``[S, Q, H, D]``.  CPU tensors run
    :func:`flash_prefill_paged_plain`; CUDA tensors launch the kernel or
    raise."""
    if not qs.is_cuda:
        return flash_prefill_paged_plain(
            qs, q_pos, k_cache, v_cache, block_tables, seq_lens, block_size,
            num_kv_heads, scale=scale, soft_cap=soft_cap, layer=layer,
            k_scale=k_scale, v_scale=v_scale)
    S, Q, H, D = qs.shape
    KVH = num_kv_heads
    scale = scale if scale is not None else D ** -0.5
    quantized = k_scale is not None
    _check(soft_cap is None or soft_cap > 0, "soft_cap must be positive")
    k3, v3, ks3, vs3, slots, SW, li = check_kv_cache(
        _check, qs, k_cache, v_cache, k_scale, v_scale, KVH, block_size,
        layer)
    _check(H // KVH <= ROWS, f"{H // KVH} heads per KV head > {ROWS}")
    _, smem = prefill_plan(D, quantized)
    _check(smem <= _build.MAX_SMEM_PER_BLOCK,
           f"D={D} needs {smem} B of shared memory")
    _check(qs.data_ptr() % 16 == 0, "queries must be 16-byte aligned")
    _check(q_pos.dtype == torch.int32 and q_pos.shape == (S, Q),
           "q_pos must be int32 [S, Q]")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32
           and block_tables.shape[0] == S and seq_lens.shape == (S,),
           "block_tables/seq_lens must be int32 [S, B] / [S]")
    tensors = [qs, q_pos, k3, v3, block_tables, seq_lens]
    if quantized:
        tensors += [ks3, vs3]
    dev = qs.device
    for t in tensors:
        _check(t.device == dev and t.is_contiguous(),
               "inputs must be contiguous and on one device")

    out = torch.empty_like(qs)
    _build.launch(
        "flash_prefill.cu", "llmd_flash_prefill", _ARGTYPES,
        qs.data_ptr(), q_pos.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        ks3.data_ptr() if quantized else None,
        vs3.data_ptr() if quantized else None,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        S, Q, H, KVH, D, SW, block_size, block_tables.shape[1], slots, li,
        float(scale), float(soft_cap or 0.0), int(quantized),
        _build.stream_ptr(dev))
    flash_prefill_paged.launches += 1
    return out


flash_prefill_paged.launches = 0
