"""Kernel G: dense (GQA) paged decode with the new K/V rows spliced in place.

Replaces the TPU kernel ``llm_d_tpu/ops/pallas/paged_attention.py``
``paged_attention_decode_update``.  CUDA source: ``csrc/paged_decode.cu``
(key-tile copies in ``csrc/common.cuh``, ``cp.async`` and ``mma.sync`` in
``csrc/pipeline.cuh``, int8 fragment reads in ``csrc/mla_page.cuh``).

What bounds it on the H100: bytes -- each live key's K and V columns
(bf16, or int8 plus f32 scales) are read once per step for the G query
heads that share the KV head, about 2*G flops per byte, far below the
card's ridge -- and, at small batches, the latency of walking a
sequence's keys one tile after another.  The design splits each
sequence's key tiles into ranges, one block per (sequence, group of KV
heads, range), the range count sized from shapes only
(:func:`num_splits`, cached); a second pass combines the ranges' partial
softmax statistics in range order (no atomics).  A block's four warps
take a KV head each (or share one head's keys), read the group's columns
of each key row contiguously, keep the tiles as stored in a ``cp.async``
ring and widen int8 in the ``mma.sync`` fragments; the keys sit on the
m16 side of both dots, so the G heads waste no tensor-core rows, and
scores stay in registers.  The key tile (:func:`decode_plan`) depends on
D, the cache dtype and the heads a block covers, never on the block
size.  The block of the range holding position ``seq_len - 1`` writes
the new rows and every block takes that position from the input, so no
block reads a slot being written.  The TPU kernel's zero-expanded
queries and sequence grouping were TPU devices and are dropped.

``paged_attention_decode_update_plain`` is the same function in plain
PyTorch: the CPU tests use it, ``chip_smoke.py`` holds the kernel
against it, and the wrapper runs it only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from llm_d_tpu_torch.ops import _build
from llm_d_tpu_torch.ops.attention import NEG_INF
from llm_d_tpu_torch.ops.mla_decode import _align128
from llm_d_tpu_torch.ops.quant import dequantize_kv_block


def kv_planes(cache, scale, layer):
    """One layer plane of a stacked ``[L, slots, W]`` cache (and its scale
    plane), or the 2-D cache itself."""
    if cache.ndim == 2:
        return cache, scale
    li = 0 if layer is None else int(layer)
    return cache[li], (None if scale is None else scale[li])


def page_rows(plane, splane, slots, D):
    """Rows ``plane[slots]`` dequantized to bf16 (int8 with their scale
    columns, each covering ``W / SW`` columns) and returned in f32,
    unfolded to ``[..., KVH, D]``."""
    rows = plane[slots]
    if splane is not None:
        rows = dequantize_kv_block(rows, splane[slots], torch.bfloat16)
    rows = rows.to(torch.bfloat16).float()
    return rows.reshape(*rows.shape[:-1], -1, D)


def paged_attention_decode_update_plain(
    q: torch.Tensor,              # [S, H, D] bf16
    k_new: torch.Tensor,          # [S, KVH*D] in the cache dtype
    v_new: torch.Tensor,
    k_cache: torch.Tensor,        # [L, slots, KVH*D] or [slots, KVH*D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,   # [S, B] i32
    seq_lens: torch.Tensor,       # [S] i32, including the new token
    block_size: int,
    num_kv_heads: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,      # [L, slots, SW] f32
    v_scale: Optional[torch.Tensor] = None,
    k_scale_new: Optional[torch.Tensor] = None,  # [S, SW] f32
    v_scale_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:                # [S, H, D]; caches updated in place
    """Writes each live sequence's new K/V rows (and scales) at position
    ``seq_len - 1`` in place, then attends page by page with the kernel's
    recurrence: bf16 ``q * scale``, pages dequantized to bf16, one running
    max per page, bf16 ``p`` in the value dot, f32 sums."""
    if soft_cap is not None:
        raise NotImplementedError(
            "paged_attention_decode_update: soft_cap is not supported")
    S, H, D = q.shape
    KVH = num_kv_heads
    G = H // KVH
    bs = block_size
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    kp, ksp = kv_planes(k_cache, k_scale, layer)
    vp, vsp = kv_planes(v_cache, v_scale, layer)
    sl = seq_lens.long()
    bt = block_tables.long()
    live = sl > 0
    wp = (sl - 1).clamp(min=0)
    slot = (bt[torch.arange(S, device=dev), wp // bs] * bs + wp % bs)[live]
    kp[slot] = k_new[live].to(kp.dtype)
    vp[slot] = v_new[live].to(vp.dtype)
    if ksp is not None:
        ksp[slot] = k_scale_new[live].to(ksp.dtype)
        vsp[slot] = v_scale_new[live].to(vsp.dtype)

    qb = (q.float() * scale).to(torch.bfloat16).float().reshape(S, KVH, G, D)
    m = torch.full((S, KVH, G), -1e29, device=dev)
    l = torch.zeros((S, KVH, G), device=dev)
    acc = torch.zeros((S, KVH, G, D), device=dev)
    n_pages = int((sl.max() + bs - 1) // bs) if S else 0
    offs = torch.arange(bs, device=dev)
    for j in range(n_pages):
        slots = bt[:, j:j + 1] * bs + offs[None, :]             # [S, bs]
        k = page_rows(kp, ksp, slots, D)                        # [S,bs,KVH,D]
        v = page_rows(vp, vsp, slots, D)
        valid = (j * bs + offs)[None, :] < sl[:, None]          # [S, bs]
        s = torch.einsum("skgd,sbkd->skgb", qb, k)
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("skgb,sbkd->skgd", p.to(torch.bfloat16).float(), v)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(S, H, D).to(q.dtype)


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_VP] * 13 + [_I] * 9 + [_LL, _I, _F, _I, _I, _VP]
_MAX_SPLITS = 256        # csrc/paged_decode.cu kMaxSplits
_STAGES = 3              # csrc/paged_decode.cu kStages
# Two blocks of the split pass share an SM.
_SMEM_BUDGET = _build.MAX_SMEM_PER_BLOCK // 2
HEAD_DIMS = (64, 128)    # the kernels' head sizes
MAX_GROUP = 16           # heads per KV head: two n8 tiles


def check_kv_cache(check, q_like, k_cache, v_cache, k_scale, v_scale,
                   num_kv_heads: int, block_size: int, layer):
    """Checks shared by the dense attention wrappers: stacked K/V caches
    (int8 with f32 scale planes of width 1 or KVH, or bf16), their row
    width against the queries' ``[..., H, D]``, the head size, the JAX
    kernels' page gate and the layer index; each kernel sizes its key
    tile itself (:func:`decode_plan`, ``flash_prefill.prefill_plan``).  Returns
    ``(k3, v3, ks3, vs3, slots, SW, layer)`` with 2-D caches viewed as one
    plane."""
    H, D = q_like.shape[-2:]
    KVH = num_kv_heads
    quantized = k_scale is not None
    k3 = k_cache if k_cache.ndim == 3 else k_cache[None]
    v3 = v_cache if v_cache.ndim == 3 else v_cache[None]
    L, slots, F = k3.shape
    check(q_like.dtype == torch.bfloat16, "queries must be bf16")
    check(v3.shape == k3.shape and v3.dtype == k3.dtype,
          "K and V caches must match")
    check(F == KVH * D and H % KVH == 0, f"row width {F} != KVH*D or H % KVH")
    check(D in HEAD_DIMS, f"head size {D} not in {HEAD_DIMS}")
    check(block_size % 16 == 0, "pages need block_size % 16")
    li = 0 if layer is None else int(layer)
    check(0 <= li < L, f"layer {li} out of range")
    ks3 = vs3 = None
    SW = 1
    if quantized:
        ks3 = k_scale if k_scale.ndim == 3 else k_scale[None]
        vs3 = v_scale if v_scale.ndim == 3 else v_scale[None]
        SW = ks3.shape[2]
        check(k3.dtype == torch.int8, "int8 cache expected")
        check(ks3.dtype == vs3.dtype == torch.float32
              and ks3.shape == vs3.shape == (L, slots, SW)
              and SW in (1, KVH), "scale planes must be f32 [L, slots, 1|KVH]")
    else:
        check(k3.dtype == torch.bfloat16, "bf16 cache expected")
    check(k3.data_ptr() % 16 == 0 and v3.data_ptr() % 16 == 0,
          "caches must be 16-byte aligned (cp.async rows)")
    return k3, v3, ks3, vs3, slots, SW, li


def decode_stage_bytes(kt: int, wh: int, D: int, quantized: bool,
                       per_head: bool) -> int:
    """One ring stage of the split pass (csrc/paged_decode.cu
    StageLayout): K and V tiles [kt, wh*D*esz + 16] bytes, then for int8
    their [kt, wh or 1] f32 scales, each part 128-B aligned."""
    a = _align128
    ldp = wh * D * (1 if quantized else 2) + 16
    tile = a(kt * ldp)
    scales = a(kt * (wh if per_head else 1) * 4) if quantized else 0
    return 2 * tile + 2 * scales


@functools.lru_cache(maxsize=None)
def decode_plan(num_kv_heads: int, D: int, quantized: bool,
                per_head: bool = False):
    """Kernel G's plan for ``num_kv_heads`` KV heads of ``D`` columns:
    ``(wh, kt, smem)``.  A block's four warps cover ``wh`` (4, 2 or 1,
    the largest dividing KVH) KV heads, each head's keys shared by
    ``4 / wh`` warps; the key tile ``kt`` is the largest of 64, 32, 16
    rows that gives every warp a whole number of m16 slices (at most four)
    and whose three ring stages fit two blocks to an SM.  The block size
    plays no part.  ``(0, 0, 0)`` if nothing fits."""
    wh = next(w for w in (4, 2, 1) if num_kv_heads % w == 0)
    wk = 4 // wh
    for kt in (64, 32, 16):
        if kt % (16 * wk) or kt // 16 // wk > 4:
            continue
        smem = _STAGES * decode_stage_bytes(kt, wh, D, quantized, per_head)
        if smem <= _SMEM_BUDGET:
            return wh, kt, smem
    return 0, 0, 0


@functools.lru_cache(maxsize=None)
def num_splits(S: int, groups: int, max_tiles: int, sms: int) -> int:
    """Key-tile ranges per sequence on a card of ``sms`` SMs: as many as
    keep the (sequence, head group, range) blocks within one wave of two
    per SM, at least one, at most one per key tile a block table can hold.
    Shapes only, so a captured step replays it."""
    return max(1, min(max_tiles, _MAX_SPLITS,
                      2 * sms // max(S * groups, 1)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_decode_update: {msg}")


def paged_attention_decode_update(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
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
    k_scale_new: Optional[torch.Tensor] = None,
    v_scale_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns the attention output ``[S, H, D]``; the caches (and, for
    int8, the scale planes) are updated in place.  CPU tensors run
    :func:`paged_attention_decode_update_plain`; CUDA tensors launch the
    kernel or raise."""
    if not q.is_cuda:
        return paged_attention_decode_update_plain(
            q, k_new, v_new, k_cache, v_cache, block_tables, seq_lens,
            block_size, num_kv_heads, scale=scale, soft_cap=soft_cap,
            layer=layer, k_scale=k_scale, v_scale=v_scale,
            k_scale_new=k_scale_new, v_scale_new=v_scale_new)
    _check(soft_cap is None, "soft_cap is not supported")
    S, H, D = q.shape
    KVH = num_kv_heads
    scale = scale if scale is not None else D ** -0.5
    quantized = k_scale is not None
    k3, v3, ks3, vs3, slots, SW, li = check_kv_cache(
        _check, q, k_cache, v_cache, k_scale, v_scale, KVH, block_size,
        layer)
    G = H // KVH
    _check(G <= MAX_GROUP, f"{G} heads per KV head > {MAX_GROUP}")
    wh, kt, smem = decode_plan(KVH, D, quantized, quantized and SW > 1)
    _check(kt > 0, f"no key tile fits KVH={KVH}, D={D} in shared memory")
    F = KVH * D
    _check(k_new.shape == v_new.shape == (S, F)
           and k_new.dtype == v_new.dtype == k3.dtype,
           "new rows must be [S, KVH*D] in the cache dtype")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32
           and block_tables.shape[0] == S and seq_lens.shape == (S,),
           "block_tables/seq_lens must be int32 [S, B] / [S]")
    tensors = [q, k_new, v_new, k3, v3, block_tables, seq_lens]
    if quantized:
        _check(k_scale_new is not None and v_scale_new is not None
               and k_scale_new.shape == v_scale_new.shape == (S, SW)
               and k_scale_new.dtype == v_scale_new.dtype == torch.float32,
               "new row scales must be f32 [S, SW]")
        tensors += [ks3, vs3, k_scale_new, v_scale_new]
    dev = q.device
    di = dev.index
    for t in tensors:
        _check(t.get_device() == di and t.is_contiguous(),
               "inputs must be contiguous and on one device")
    _check(k_new.data_ptr() % 16 == 0 and v_new.data_ptr() % 16 == 0,
           "new rows must be 16-byte aligned (cp.async rows)")

    B = block_tables.shape[1]
    ns = num_splits(S, KVH // wh, -(-B * block_size // kt),
                    _sm_count(di))
    out = torch.empty_like(q)
    # The (range, key part) partials: [S, ns, 4/wh, H, D] accumulators,
    # then [S, ns, 4/wh, H, 2] running max and sum.
    part = torch.empty(S * ns * (4 // wh) * H * (D + 2), dtype=torch.float32,
                       device=dev)
    _build.launch(
        "paged_decode.cu", "llmd_paged_decode", _ARGTYPES,
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_scale_new.data_ptr() if quantized else None,
        v_scale_new.data_ptr() if quantized else None,
        k3.data_ptr(), v3.data_ptr(),
        ks3.data_ptr() if quantized else None,
        vs3.data_ptr() if quantized else None,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), S, H, KVH, D, SW, block_size, kt, wh, B, slots,
        li, float(scale), int(quantized), ns, _build.stream_ptr(dev))
    paged_attention_decode_update.launches += 1
    return out


paged_attention_decode_update.launches = 0
