"""Ragged paged attention over the paged KV cache: the reference path,
the chunked flash path (plain PyTorch, on any device), cache writes, the
batch-layout helpers and the backend dispatch (port of
``llm_d_tpu.ops.attention``).

Batch layout (padded to bucketed sizes, as the JAX package builds it):
  q:              [T, H, D]     query vectors for every token in this step
  token_seq_ids:  [T]           sequence row of each token
  positions:      [T]           absolute position of each token in its seq
  kv cache slots: [L, num_slots, W]; slot = block * bs + offset
  block_tables:   [S, B]        physical block ids per sequence (0 = null)
  seq_lens:       [S]           total context length per sequence (0 = pad)

Block 0 is the reserved null/trash block: padding tokens write there and
null table entries read from it (always masked out).

Unlike the JAX package, the port updates the cache IN PLACE
(``index_copy_``): PyTorch tensors are mutable, and copying a stacked
cache per layer would cost the bytes the paged layout exists to save.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_d_tpu_torch.ops.quant import dequantize_kv_block, quantize_kv_block

NEG_INF = -1e30


def _gather_rows(cache: torch.Tensor, scale: Optional[torch.Tensor],
                 idx: torch.Tensor, layer: Optional[int]) -> torch.Tensor:
    """Row gather with optional int8 dequantization, rows returned in f32."""
    plane = cache if layer is None else cache[layer]
    rows = plane[idx]
    if scale is None:
        return rows.float()
    s = (scale if layer is None else scale[layer])[idx]
    return dequantize_kv_block(rows, s, torch.float32)


def ragged_paged_attention_reference(
    q: torch.Tensor,              # [T, H, D]
    k_cache: torch.Tensor,        # [num_slots, KVH*D] or stacked [L, ...]
    v_cache: torch.Tensor,
    token_seq_ids: torch.Tensor,  # [T]
    positions: torch.Tensor,      # [T]
    block_tables: torch.Tensor,   # [S, B]
    seq_lens: torch.Tensor,       # [S]
    block_size: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:                # [T, H, D] in q.dtype
    """Full-softmax attention in f32 over each sequence's whole context
    (the CPU path and correctness oracle)."""
    T, H, D = q.shape
    S, B = block_tables.shape
    KVH = k_cache.shape[-1] // D
    G = H // KVH
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    slot_ids = (block_tables[:, :, None].long() * block_size
                + torch.arange(block_size, device=dev)[None, None, :]
                ).reshape(S, B * block_size)
    C = B * block_size
    k_seq = _gather_rows(k_cache, k_scale, slot_ids, layer).reshape(
        S, C, KVH, D)
    v_seq = _gather_rows(v_cache, v_scale, slot_ids, layer).reshape(
        S, C, KVH, D)
    tsi = token_seq_ids.long()
    k_tok = k_seq[tsi]
    v_tok = v_seq[tsi]

    qf = q.float().reshape(T, KVH, G, D)
    scores = torch.einsum("tkgd,tckd->tkgc", qf * scale, k_tok)
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    key_pos = torch.arange(C, device=dev)[None, :]
    valid = (key_pos <= positions[:, None]) & (
        key_pos < seq_lens.long()[tsi][:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgc,tckd->tkgd", probs, v_tok)
    return out.reshape(T, H, D).to(q.dtype)


def write_kv(cache: torch.Tensor, new: torch.Tensor,
             slot_mapping: torch.Tensor, layer: Optional[int] = None) -> None:
    """Scatter this step's rows ``new [T, ...]`` into ``cache`` slots, in
    place (one plane of a stacked ``[L, slots, W]`` cache with ``layer``).
    MLA has one latent buffer, so the K/V pair of the JAX signature is one
    cache here."""
    plane = cache if layer is None else cache[layer]
    T = new.shape[0]
    plane.index_copy_(0, slot_mapping.long(),
                      new.reshape(T, -1).to(plane.dtype))


def write_scales(scale_cache: torch.Tensor, scales_new: torch.Tensor,
                 slot_mapping: torch.Tensor,
                 layer: Optional[int] = None) -> None:
    """Scatter per-row KV scales next to their int8 rows, in place."""
    plane = scale_cache if layer is None else scale_cache[layer]
    plane.index_copy_(0, slot_mapping.long(), scales_new.to(plane.dtype))


def gather_per_seq_queries(q: torch.Tensor, positions: torch.Tensor,
                           qtok_idx: torch.Tensor):
    """[T, H, D] ragged queries -> ([S, Q, H, D], [S, Q] positions); the
    pad sentinel T in ``qtok_idx`` gathers a zero row at position -1."""
    T, H, D = q.shape
    q_pad = torch.cat([q, q.new_zeros((1, H, D))])
    pos_pad = torch.cat([positions, positions.new_full((1,), -1)])
    idx = qtok_idx.long()
    return q_pad[idx], pos_pad[idx]


def _flash_over_kv_chunks(
    qs: torch.Tensor,         # [S, Q, H, D] padded per-seq queries
    q_pos: torch.Tensor,      # [S, Q] absolute positions (pad -> -1)
    slot_ids: torch.Tensor,   # [S, C] gather indices into the cache
    seq_lens: torch.Tensor,   # [S]
    k_cache: torch.Tensor, v_cache: torch.Tensor,
    kv_chunk: int, scale: float, soft_cap: Optional[float],
    n_live: int,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:            # [S, Q, H, D]
    """Online-softmax attention over the context in ``kv_chunk`` slices
    (the JAX package's XLA flash recurrence): peak memory is
    O(S*Q*H*kv_chunk), and only the ``n_live`` chunks below the longest
    context run."""
    S, Q, H, D = qs.shape
    KVH = k_cache.shape[-1] // D
    G = H // KVH
    dev = qs.device
    qf = qs.float().reshape(S, Q, KVH, G, D) * scale
    m = torch.full((S, Q, KVH, G), -1e29, device=dev)
    l = torch.zeros((S, Q, KVH, G), device=dev)
    acc = torch.zeros((S, Q, KVH, G, D), device=dev)
    offs = torch.arange(kv_chunk, device=dev)
    sl = seq_lens.long()
    qp = q_pos.long()
    for ci in range(n_live):
        idx = slot_ids[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        k = _gather_rows(k_cache, k_scale, idx, layer).reshape(
            S, kv_chunk, KVH, D)
        v = _gather_rows(v_cache, v_scale, idx, layer).reshape(
            S, kv_chunk, KVH, D)
        s = torch.einsum("sqkgd,sckd->sqkgc", qf, k)   # [S, Q, KVH, G, kc]
        if soft_cap is not None:
            s = soft_cap * torch.tanh(s / soft_cap)
        key_pos = ci * kv_chunk + offs
        valid = (key_pos[None, None, :] <= qp[:, :, None]) & (
            key_pos[None, None, :] < sl[:, None, None])
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        # The running max is clamped to a finite floor, so fully masked
        # rows and chunks give p = exp(NEG_INF - floor) = 0, not 1.
        m_new = torch.clamp_min(torch.maximum(m, s.amax(dim=-1)), -1e29)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("sqkgc,sckd->sqkgd", p, v)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(S, Q, H, D).to(qs.dtype)


def _chunk_size_for(C: int, target: int = 512) -> int:
    kc = min(target, C)
    while C % kc:
        kc //= 2
    return max(kc, 1)


# Peak f32 elements allowed in one flash score tensor [S, Qc, H, kv_chunk]
# (~128 MB). Both chunk dims shrink to honor it, so prefill memory stays
# bounded whatever the (S, Q) bucket combination.
_FLASH_SCORE_BUDGET = 1 << 25


def _flash_batched_q_chunks(
    qs: torch.Tensor,         # [S, Q, H, D]
    q_pos: torch.Tensor,      # [S, Q]
    slot_ids: torch.Tensor,   # [S, C]
    seq_lens: torch.Tensor,   # [S]
    k_cache: torch.Tensor, v_cache: torch.Tensor,
    scale: float, soft_cap: Optional[float], max_len: int,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:            # [S, Q, H, D]
    """All sequences batched through the flash recurrence, the queries in
    chunks of ``qc`` rows so the score tensor stays within
    ``_FLASH_SCORE_BUDGET``."""
    S, Q, H, D = qs.shape
    C = slot_ids.shape[1]
    kv_chunk = _chunk_size_for(C)
    qc = Q
    while qc > 8 and (S * qc * H * kv_chunk > _FLASH_SCORE_BUDGET
                      or Q % qc) and qc % 2 == 0:
        qc //= 2
    while kv_chunk > 16 and S * qc * H * kv_chunk > _FLASH_SCORE_BUDGET \
            and kv_chunk % 2 == 0 and C % (kv_chunk // 2) == 0:
        kv_chunk //= 2
    if Q % qc:      # non-pow2 Q bucket: no clean split, single chunk
        qc = Q
    n_live = min(-(-max_len // kv_chunk), C // kv_chunk)
    outs = [_flash_over_kv_chunks(
        qs[:, i:i + qc], q_pos[:, i:i + qc], slot_ids, seq_lens, k_cache,
        v_cache, kv_chunk, scale, soft_cap, n_live, layer=layer,
        k_scale=k_scale, v_scale=v_scale) for i in range(0, Q, qc)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _context_bound(seq_lens: torch.Tensor, C: int) -> int:
    """The longest context of the batch, read to the host; under a CUDA
    graph capture, which allows no host read, the table's ``C`` slots.
    The chunks past every row's length are then fully masked: each
    leaves the running max, sum and accumulator as they were, so the
    output is the same, bit for bit."""
    if seq_lens.is_cuda and torch.cuda.is_current_stream_capturing():
        return C
    return int(seq_lens.max()) if seq_lens.shape[0] else 0


def ragged_paged_attention_chunked(
    q: torch.Tensor,              # [T, H, D]
    k_cache: torch.Tensor, v_cache: torch.Tensor,
    token_seq_ids: torch.Tensor, positions: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor,
    qtok_idx: torch.Tensor,       # [S, Q] token per (seq, q slot); T = pad
    token_qpos: torch.Tensor,     # [T] q slot of each token within its seq
    block_size: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:                # [T, H, D] in q.dtype
    """Memory-bounded ragged attention in plain PyTorch: the JAX package's
    XLA flash recurrence, which it runs for every batch its kernels do not
    take.  Decode steps (Q == 1) batch all sequences through one pass;
    prefill and mixed steps chunk the queries to bound the score tensor.

    The trip count over KV chunks is data-dependent, as JAX's
    ``while_loop``: ``max(seq_lens)`` is read to the host once per call
    (:func:`_context_bound`).  That sync is this eager path's only one."""
    T, H, D = q.shape
    S, B = block_tables.shape
    Q = qtok_idx.shape[1]
    scale = scale if scale is not None else D ** -0.5
    C = B * block_size
    qs, q_pos = gather_per_seq_queries(q, positions, qtok_idx)
    slot_ids = (block_tables[:, :, None].long() * block_size
                + torch.arange(block_size, device=q.device)[None, None, :]
                ).reshape(S, C)
    max_len = _context_bound(seq_lens, C)
    if Q == 1:
        kv_chunk = _chunk_size_for(C)
        out = _flash_over_kv_chunks(
            qs, q_pos, slot_ids, seq_lens, k_cache, v_cache, kv_chunk,
            scale, soft_cap, min(-(-max_len // kv_chunk), C // kv_chunk),
            layer=layer, k_scale=k_scale, v_scale=v_scale)   # [S, 1, H, D]
    else:
        out = _flash_batched_q_chunks(
            qs, q_pos, slot_ids, seq_lens, k_cache, v_cache, scale,
            soft_cap, max_len, layer=layer, k_scale=k_scale,
            v_scale=v_scale)
    return out[token_seq_ids.long(), token_qpos.long()]


def resolve_backend(backend: str, device: torch.device) -> str:
    """``auto | kernel | chunked | reference``.  'auto' is the hand-written
    kernels on the card and the reference on the CPU.  'kernel' runs a
    kernel where its shape gate admits the batch and the chunked path
    otherwise (as the JAX package's 'pallas' does); 'chunked' always runs
    the chunked path."""
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else \
            "reference"
    if backend not in ("kernel", "chunked", "reference"):
        raise ValueError(f"unknown attention backend {backend!r}")
    return backend


def decode_kernel_eligible(batch, block_size: int, row_width: int) -> bool:
    """Gate for the decode kernel: pure-decode batch (Q == 1), pages of a
    multiple of 16 rows, rows of a multiple of 128 columns (the same gate
    the JAX package applies; its shapes are the ones the kernel is held
    to)."""
    qtok_idx = batch.get("qtok_idx")
    return (qtok_idx is not None and qtok_idx.shape[1] == 1
            and block_size % 16 == 0 and row_width % 128 == 0)


def attention_with_kv_update(
    q: torch.Tensor,              # [T, H, D]
    k_new: torch.Tensor,          # [T, KVH, D] this step's K rows
    v_new: torch.Tensor,
    k_cache: torch.Tensor,        # stacked [L, slots, KVH*D] (or [slots, ...])
    v_cache: torch.Tensor,
    batch,
    block_size: int,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    backend: str = "auto",
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # int8: [L, slots, SW] f32
    v_scale: Optional[torch.Tensor] = None,
):
    """Write this step's K/V rows into the paged cache (in place) and
    attend over it, for the dense (GQA) models.

    Int8 caches quantize the new rows here with the scale plane's width
    (per token or per KV head).  The dispatch is the JAX package's, decided
    from shapes: under 'kernel' a pure-decode batch goes to kernel G,
    which writes the rows itself, and a prefill or mixed batch scatters
    its rows and goes to kernel H; a batch neither gate admits (and every
    batch under 'chunked') scatters its rows and runs the chunked flash
    path; 'reference' runs the full-softmax reference.  Returns
    ``(out, k_cache, v_cache)``, plus ``(k_scale, v_scale)`` for int8."""
    from llm_d_tpu_torch.ops import flash_prefill, paged_attention
    backend = resolve_backend(backend, q.device)
    quantized = k_scale is not None
    T, H, D = q.shape
    F = k_cache.shape[-1]
    k_rows = k_new.reshape(T, F)
    v_rows = v_new.reshape(T, F)
    k_s = v_s = None
    if quantized:
        sw = k_scale.shape[-1]
        k_rows, k_s = quantize_kv_block(k_rows, sw)
        v_rows, v_s = quantize_kv_block(v_rows, sw)
    else:
        k_rows = k_rows.to(k_cache.dtype)
        v_rows = v_rows.to(v_cache.dtype)

    def ret(out):
        if quantized:
            return out, k_cache, v_cache, k_scale, v_scale
        return out, k_cache, v_cache

    qtok_idx = batch.get("qtok_idx")
    tsi = batch["token_seq_ids"].long()
    # Int8 pages need block_size % 32, as the TPU kernels' int8 tiling does.
    kernel_ok = backend == "kernel" and (not quantized
                                         or block_size % 32 == 0)
    if kernel_ok and soft_cap is None and decode_kernel_eligible(
            batch, block_size, F):
        rows = qtok_idx[:, 0].clamp(0, T - 1).long()
        out = paged_attention.paged_attention_decode_update(
            q[rows].contiguous(), k_rows[rows].contiguous(),
            v_rows[rows].contiguous(), k_cache, v_cache,
            batch["block_tables"], batch["seq_lens"],
            block_size=block_size, num_kv_heads=F // D, scale=scale,
            layer=layer, k_scale=k_scale, v_scale=v_scale,
            k_scale_new=k_s[rows].contiguous() if quantized else None,
            v_scale_new=v_s[rows].contiguous() if quantized else None)
        return ret(out[tsi])

    slot_mapping = batch["slot_mapping"]
    write_kv(k_cache, k_rows, slot_mapping, layer=layer)
    write_kv(v_cache, v_rows, slot_mapping, layer=layer)
    if quantized:
        write_scales(k_scale, k_s, slot_mapping, layer=layer)
        write_scales(v_scale, v_s, slot_mapping, layer=layer)
    if kernel_ok and qtok_idx is not None and qtok_idx.shape[1] > 1 \
            and block_size % 16 == 0 and F % 128 == 0:
        qs, q_pos = gather_per_seq_queries(q, batch["positions"], qtok_idx)
        out_s = flash_prefill.flash_prefill_paged(
            qs.contiguous(), q_pos.to(torch.int32).contiguous(), k_cache,
            v_cache, batch["block_tables"], batch["seq_lens"],
            block_size=block_size, num_kv_heads=F // D, scale=scale,
            soft_cap=soft_cap, layer=layer, k_scale=k_scale,
            v_scale=v_scale)
        return ret(out_s[tsi, batch["token_qpos"].long()])
    if backend in ("kernel", "chunked") and qtok_idx is not None:
        return ret(ragged_paged_attention_chunked(
            q, k_cache, v_cache, batch["token_seq_ids"], batch["positions"],
            batch["block_tables"], batch["seq_lens"], qtok_idx,
            batch["token_qpos"], block_size=block_size, scale=scale,
            soft_cap=soft_cap, layer=layer, k_scale=k_scale,
            v_scale=v_scale))
    out = ragged_paged_attention_reference(
        q, k_cache, v_cache, batch["token_seq_ids"], batch["positions"],
        batch["block_tables"], batch["seq_lens"], block_size=block_size,
        scale=scale, soft_cap=soft_cap, layer=layer, k_scale=k_scale,
        v_scale=v_scale)
    return ret(out)
