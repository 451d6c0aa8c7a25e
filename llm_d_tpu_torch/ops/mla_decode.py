"""Kernel A: MLA paged decode with the new latent row spliced in place.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/mla_attention.py``
``mla_paged_decode_update``.  CUDA source: ``csrc/mla_decode.cu`` (with
the ``cp.async`` and ``mma.sync`` primitives in ``csrc/pipeline.cuh``).

What bounds it on the H100: bytes -- each live latent row (F int8 + one
f32 scale) is read once per step for all H heads, about 2*H flops per
byte, far below the card's ridge -- and, at small batches, the latency of
walking a sequence's pages one after another.  The design splits each
sequence's pages into ranges, one block per (sequence, range), sized from
the batch, the block-table width and the SM count (no host read of
``seq_lens``: ranges past a sequence's last key tile exit on the device);
a second pass combines the ranges' partial softmax statistics, kept in
one f32 scratch tensor, in range order (no atomics).  A block walks its
range in key tiles (:func:`decode_key_tile`: the page where two pages fit
in shared memory, else a part of it), so every block size the reference
serves is served.  Each int8 tile stays int8 in shared memory, arrives by
``cp.async`` while the previous one is multiplied, and is dequantized into
the tensor-core fragments of both dots (MQA: one tile serves every head).
The block that owns the tile of position ``seq_len - 1`` writes the new
row and takes that position from the input, so no other block reads the
slot being written.

``mla_paged_decode_update_plain`` is the same function in plain PyTorch:
the CPU tests use it, ``chip_smoke.py`` holds the kernel against it, and
the wrapper runs it only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from llm_d_tpu_torch.ops import _build
from llm_d_tpu_torch.ops.attention import NEG_INF
from llm_d_tpu_torch.ops.quant import dequantize_kv_block

_MAX_HEADS = 16
_MAX_F = 1024


def _planes(kv_cache, kv_scale, layer):
    li = 0 if layer is None else int(layer)
    if kv_cache.ndim == 2:
        return kv_cache, kv_scale
    return kv_cache[li], (None if kv_scale is None else kv_scale[li])


def mla_paged_decode_update_plain(
    q_eff: torch.Tensor,          # [S, H, F] absorbed queries (bf16)
    row_new: torch.Tensor,        # [S, F] new rows (int8 when kv_scale given)
    kv_cache: torch.Tensor,       # [L, slots, F] or [slots, F]
    block_tables: torch.Tensor,   # [S, B] i32
    seq_lens: torch.Tensor,       # [S] i32, including the new token
    block_size: int,
    scale: float,
    layer: Optional[int] = None,
    kv_scale: Optional[torch.Tensor] = None,      # [L, slots, SW] f32
    row_scale_new: Optional[torch.Tensor] = None,  # [S, SW] f32
) -> torch.Tensor:                # [S, H, F] in q dtype; cache updated
    """Writes each live sequence's new row (and scale) at position
    ``seq_len - 1`` in place, then attends page by page with the kernel's
    recurrence: bf16 ``q * scale``, pages dequantized to bf16, one running
    max per page, bf16 ``p`` in the value dot, f32 sums."""
    S, H, F = q_eff.shape
    bs = block_size
    dev = q_eff.device
    plane, splane = _planes(kv_cache, kv_scale, layer)
    sl = seq_lens.long()
    bt = block_tables.long()
    live = sl > 0
    wp = (sl - 1).clamp(min=0)
    slot = bt[torch.arange(S, device=dev), wp // bs] * bs + wp % bs
    plane[slot[live]] = row_new[live].to(plane.dtype)
    if splane is not None:
        splane[slot[live]] = row_scale_new[live].to(splane.dtype)

    qb = (q_eff.float() * scale).to(torch.bfloat16).float()
    m = torch.full((S, H), -1e29, device=dev)
    l = torch.zeros((S, H), device=dev)
    acc = torch.zeros((S, H, F), device=dev)
    n_pages = int((sl.max() + bs - 1) // bs) if S else 0
    offs = torch.arange(bs, device=dev)
    for j in range(n_pages):
        slots = bt[:, j:j + 1] * bs + offs[None, :]             # [S, bs]
        rows = plane[slots]
        if splane is not None:
            page = dequantize_kv_block(rows, splane[slots], torch.bfloat16)
        else:
            page = rows.to(torch.bfloat16)
        page = page.float()                                     # [S, bs, F]
        valid = (j * bs + offs)[None, :] < sl[:, None]          # [S, bs]
        s = torch.einsum("shf,sbf->shb", qb, page)
        s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("shb,sbf->shf",
                          p.to(torch.bfloat16).float(), page)
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q_eff.dtype)


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_VP] * 9 + [_I] * 7 + [_LL, _I, _F, _I, _I, _VP]
_MAX_SPLITS = 256        # csrc/mla_decode.cu kMaxSplits
_MAX_SPLIT_F = 768       # three 32-column value groups per warp


@functools.lru_cache(maxsize=None)
def num_splits(S: int, B: int, index: int) -> int:
    """Page ranges per sequence on CUDA device ``index``: enough
    (sequence, range) blocks for two per SM, at most one range per
    block-table entry."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return max(1, min(B, _MAX_SPLITS, -(-2 * sms // max(S, 1))))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mla_paged_decode_update: {msg}")


def check_cache(check, q_like, kv_cache, kv_scale, block_size, layer):
    """Checks shared by the MLA kernel wrappers: the stacked latent cache
    (int8 + f32 scale plane, or bf16), its row width against the queries'
    ``[..., H, F]`` and the layer index; each kernel sizes its key tile
    itself (:func:`decode_key_tile`, ``mla_prefill.key_tile``).  Returns
    ``(cache3, scale3, slots, SW, layer)`` with 2-D caches viewed as one
    plane."""
    H, F = q_like.shape[-2:]
    quantized = kv_scale is not None
    cache3 = kv_cache if kv_cache.ndim == 3 else kv_cache[None]
    scale3 = None
    L, slots, Fc = cache3.shape
    check(q_like.dtype == torch.bfloat16, "queries must be bf16")
    check(Fc == F, "row width mismatch")
    check(H <= _MAX_HEADS and F <= _MAX_F, f"H={H} > 16 or F={F} > 1024")
    li = 0 if layer is None else int(layer)
    check(0 <= li < L, f"layer {li} out of range")
    SW = 1
    if quantized:
        scale3 = kv_scale if kv_scale.ndim == 3 else kv_scale[None]
        SW = scale3.shape[2]
        check(cache3.dtype == torch.int8, "int8 latent cache expected")
        check(scale3.dtype == torch.float32 and scale3.shape[:2] == (L, slots)
              and F % SW == 0, "scale plane must be f32 [L, slots, SW]")
        check(block_size % 32 == 0, "int8 latent pages need block_size % 32")
    else:
        check(cache3.dtype == torch.bfloat16, "bf16 cache expected")
    check(F % 16 == 0 and block_size % 16 == 0 and (F // SW) % 4 == 0,
          "tensor-core tiles need F % 16, block_size % 16, (F / SW) % 4")
    return cache3, scale3, slots, SW, li


def _align128(b: int) -> int:
    return (b + 127) // 128 * 128


def _split_smem_bytes(F: int, kt: int, SW: int, quantized: bool) -> int:
    """Dynamic shared memory of kernel A's split pass at key tile ``kt``
    (csrc/mla_decode.cu DecSmem): q [16, F+8] bf16, two key tiles
    [kt, F*esz + 16] bytes and, for int8, their [kt, SW] f32 scales, scores
    [KW, 16, kt] f32, p [16, kt+8] bf16, three [16] f32 statistics, each
    part 128-B aligned."""
    a = _align128
    R, esz = _MAX_HEADS, 1 if quantized else 2
    page = a(R * (F + 8) * 2)
    s = a(a(page + 2 * kt * (F * esz + 16)) + (2 * kt * SW * 4 if quantized
                                               else 0))
    pb = a(s + (1 if kt >= 64 else 64 // kt) * R * kt * 4)
    stats = a(pb + R * (kt + 8) * 2)
    return stats + 3 * R * 4


def decode_key_tile(F: int, bs: int, SW: int = 1,
                    quantized: bool = True) -> int:
    """Kernel A's key tile for pages of ``bs`` rows: the page itself when
    two pages fit a block's shared memory beside the q tile (so the bench's
    int8 64-row pages run as before), else the largest of 128, 64, 32, 16
    rows that divides the page and fits (a tile then lies inside one
    page); 0 if none fits."""
    for kt in (bs, 128, 64, 32, 16):
        if kt <= bs and bs % kt == 0 and _split_smem_bytes(
                F, kt, SW, quantized) <= _build.MAX_SMEM_PER_BLOCK:
            return kt
    return 0


def mla_paged_decode_update(
    q_eff: torch.Tensor,
    row_new: torch.Tensor,
    kv_cache: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    block_size: int,
    scale: float,
    layer: Optional[int] = None,
    kv_scale: Optional[torch.Tensor] = None,
    row_scale_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns the attended latent rows ``[S, H, F]``; the cache (and, for
    the int8 latent, the scale plane) is updated in place.  CPU tensors
    run :func:`mla_paged_decode_update_plain`; CUDA tensors launch the
    kernel or raise."""
    if not q_eff.is_cuda:
        return mla_paged_decode_update_plain(
            q_eff, row_new, kv_cache, block_tables, seq_lens, block_size,
            scale, layer=layer, kv_scale=kv_scale,
            row_scale_new=row_scale_new)
    S, H, F = q_eff.shape
    quantized = kv_scale is not None
    cache3, scale3, slots, SW, li = check_cache(
        _check, q_eff, kv_cache, kv_scale, block_size, layer)
    kt = decode_key_tile(F, block_size, SW, quantized)
    _check(kt > 0, "no key tile fits a block's shared memory")
    _check(row_new.shape == (S, F) and row_new.dtype == cache3.dtype,
           "new rows must be [S, F] in the cache dtype")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32
           and block_tables.shape[0] == S and seq_lens.shape == (S,),
           "block_tables/seq_lens must be int32 [S, B] / [S]")
    tensors = [q_eff, row_new, cache3, block_tables, seq_lens]
    if quantized:
        _check(row_scale_new is not None and row_scale_new.shape == (S, SW)
               and row_scale_new.dtype == torch.float32,
               "new row scales must be f32 [S, SW]")
        tensors += [scale3, row_scale_new]
    dev = q_eff.device
    di = dev.index
    for t in tensors:
        _check(t.get_device() == di and t.is_contiguous(),
               "inputs must be contiguous and on one device")
    _check(F % 32 == 0 and F <= _MAX_SPLIT_F,
           "the kernel takes F % 32 == 0, F <= 768")
    _check(row_new.data_ptr() % 16 == 0 and cache3.data_ptr() % 16 == 0,
           "cache and new rows must be 16-byte aligned (cp.async rows)")

    B = block_tables.shape[1]
    ns = num_splits(S, B, di)
    out = torch.empty_like(q_eff)
    # The ranges' partials: [S, ns, H, F] accumulators, then [S, ns, H, 2]
    # running max and sum.
    part = torch.empty(S * ns * H * (F + 2), dtype=torch.float32, device=dev)
    _build.launch(
        "mla_decode.cu", "llmd_mla_decode", _ARGTYPES,
        q_eff.data_ptr(), row_new.data_ptr(),
        row_scale_new.data_ptr() if quantized else None,
        cache3.data_ptr(), scale3.data_ptr() if quantized else None,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), S, H, F, SW, block_size, kt, B, slots, li,
        float(scale), int(quantized), ns, _build.stream_ptr(dev))
    mla_paged_decode_update.launches += 1
    return out


mla_paged_decode_update.launches = 0
