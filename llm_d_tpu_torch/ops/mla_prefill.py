"""Kernel B: MLA causal flash prefill over the paged latent cache.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/mla_prefill.py``
``mla_flash_prefill``.  CUDA source: ``csrc/mla_prefill.cu`` (page
fragment reads in ``csrc/mla_page.cuh``, shared with kernel A).

What bounds it on the H100: bytes (each live query row read and written
once, each page of a sequence read once; 4*H*F flops per causal (query,
key) pair are a fifth of that time at the tensor-core rate).  The design
gives a block a tile of two query positions (32 rows: positions x heads,
one latent row serving all of them), walks the keys up to the tile's
largest causal bound in key tiles with each row masked at its own, keeps
the tiles as the cache stores them in shared memory (double-buffered
``cp.async``) and dequantizes them in the ``mma.sync`` fragments of both
dots; scores and ``p`` stay in registers, and the f32 statistics follow
the TPU recurrence.  The key tile (:func:`key_tile`) is independent of
the cache's block size: a key finds its page through the block table, so
every block size the cache checks admit is served.

Read-only: the caller scatters this step's rows and scales first.
``mla_flash_prefill_plain`` is the plain PyTorch version (CPU tests, and
the reference ``chip_smoke.py`` holds the kernel to).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llm_d_tpu_torch.ops import _build
from llm_d_tpu_torch.ops.attention import NEG_INF
from llm_d_tpu_torch.ops.mla_decode import (_MAX_HEADS, _align128, _planes,
                                             check_cache)
from llm_d_tpu_torch.ops.quant import dequantize_kv_block


def mla_flash_prefill_plain(
    qs: torch.Tensor,             # [S, Q, H, F] per-seq padded queries
    q_pos: torch.Tensor,          # [S, Q] i32 (pad -> -1)
    kv_cache: torch.Tensor,       # [L, slots, F] or [slots, F]
    block_tables: torch.Tensor,   # [S, B]
    seq_lens: torch.Tensor,       # [S]
    block_size: int,
    scale: float,
    layer: Optional[int] = None,
    kv_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:                # [S, Q, H, F]
    """Each query row attends keys ``< min(seq_len, q_pos + 1)`` with the
    kernel's page-by-page recurrence (bf16 ``q * scale``, bf16 pages,
    bf16 ``p`` in the value dot, f32 statistics)."""
    S, Q, H, F = qs.shape
    bs = block_size
    dev = qs.device
    plane, splane = _planes(kv_cache, kv_scale, layer)
    bt = block_tables.long()
    n_keys = torch.minimum(seq_lens.long()[:, None], q_pos.long() + 1)
    qb = (qs.float() * scale).to(torch.bfloat16).float()
    m = torch.full((S, Q, H), -1e29, device=dev)
    l = torch.zeros((S, Q, H), device=dev)
    acc = torch.zeros((S, Q, H, F), device=dev)
    n_pages = int((n_keys.max().clamp(min=0) + bs - 1) // bs) if S * Q else 0
    offs = torch.arange(bs, device=dev)
    for j in range(n_pages):
        slots = bt[:, j:j + 1] * bs + offs[None, :]             # [S, bs]
        rows = plane[slots]
        if splane is not None:
            page = dequantize_kv_block(rows, splane[slots], torch.bfloat16)
        else:
            page = rows.to(torch.bfloat16)
        page = page.float()                                     # [S, bs, F]
        valid = (j * bs + offs)[None, None, :] < n_keys[:, :, None]
        s = torch.einsum("sqhf,sbf->sqhb", qb, page)
        s = torch.where(valid[:, :, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("sqhb,sbf->sqhf",
                          p.to(torch.bfloat16).float(), page)
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(qs.dtype)


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_KEY_TILES = (64, 32)
_ARGTYPES = [_VP] * 7 + [_I] * 8 + [_LL, _I, _F, _I, _VP]


def smem_bytes(F: int, kt: int, SW: int = 1, quantized: bool = True) -> int:
    """Dynamic shared memory of the kernel at key tile ``kt``
    (csrc/mla_prefill.cu PrefillSmem): the q tile [32, F+8] bf16 (two
    positions x 16 heads), two key tiles [kt, F*esz + 16] bytes and, for
    int8, their [kt, SW] f32 scales, the partial scores [4, 32, kt+8] f32,
    each part 128-B aligned."""
    a = _align128
    rows, parts, esz = 2 * _MAX_HEADS, 4, 1 if quantized else 2
    tile = a(rows * (F + 8) * 2)
    xs = a(a(tile + 2 * kt * (F * esz + 16))
           + (2 * kt * SW * 4 if quantized else 0))
    return xs + parts * rows * (kt + 8) * 4


def key_tile(F: int, SW: int = 1, quantized: bool = True) -> int:
    """The kernel's key tile: 64 keys if that shared-memory plan fits a
    block, else 32 (which fits every F <= 768), else 0."""
    for kt in _KEY_TILES:
        if smem_bytes(F, kt, SW, quantized) <= _build.MAX_SMEM_PER_BLOCK:
            return kt
    return 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mla_flash_prefill: {msg}")


def mla_flash_prefill(
    qs: torch.Tensor,
    q_pos: torch.Tensor,
    kv_cache: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    block_size: int,
    scale: float,
    layer: Optional[int] = None,
    kv_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attended latent rows ``[S, Q, H, F]``.  CPU tensors run
    :func:`mla_flash_prefill_plain`; CUDA tensors launch the kernel or
    raise."""
    if not qs.is_cuda:
        return mla_flash_prefill_plain(
            qs, q_pos, kv_cache, block_tables, seq_lens, block_size, scale,
            layer=layer, kv_scale=kv_scale)
    S, Q, H, F = qs.shape
    quantized = kv_scale is not None
    cache3, scale3, slots, SW, li = check_cache(
        _check, qs, kv_cache, kv_scale, block_size, layer)
    _check(q_pos.dtype == torch.int32 and q_pos.shape == (S, Q),
           "q_pos must be int32 [S, Q]")
    _check(F % 128 == 0 and F <= 768, "the kernel takes F % 128 == 0, F <= 768")
    kt = key_tile(F, SW, quantized)
    _check(kt > 0, "no key tile fits a block's shared memory")
    _check(cache3.data_ptr() % 16 == 0 and qs.data_ptr() % 16 == 0,
           "the cache and the queries must be 16-byte aligned (cp.async "
           "rows, 16-byte query loads)")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32
           and block_tables.shape[0] == S and seq_lens.shape == (S,),
           "block_tables/seq_lens must be int32 [S, B] / [S]")
    tensors = [qs, q_pos, cache3, block_tables, seq_lens]
    if quantized:
        tensors.append(scale3)
    dev = qs.device
    for t in tensors:
        _check(t.device == dev and t.is_contiguous(),
               "inputs must be contiguous and on one device")

    out = torch.empty_like(qs)
    _build.launch(
        "mla_prefill.cu", "llmd_mla_prefill", _ARGTYPES,
        qs.data_ptr(), q_pos.data_ptr(), cache3.data_ptr(),
        scale3.data_ptr() if quantized else None, block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), S, Q, H, F, SW, block_size, kt,
        block_tables.shape[1], slots, li, float(scale), int(quantized),
        _build.stream_ptr(dev))
    mla_flash_prefill.launches += 1
    return out


mla_flash_prefill.launches = 0
