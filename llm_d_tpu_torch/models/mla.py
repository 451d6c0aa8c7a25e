"""Multi-head latent attention (port of ``llm_d_tpu.models.mla``).

Each token caches one latent row ``c_kv | k_pe`` (kv_lora_rank + rope,
lane-padded to a multiple of 128); queries absorb W_uk so a score is one
dot against the cached row, and outputs absorb W_uv after attending over
the row's first kv_lora_rank columns.  With an int8 latent each row is
quantized once, with one f32 scale, when it is written.

Dispatch follows the JAX package, from shapes: under the 'kernel'
backend a pure-decode batch goes to kernel A (which writes the new rows
itself) and a prefill or mixed batch scatters its rows and goes to kernel
B; every other batch, on every backend, scatters its rows and runs the
chunked flash path (``ops.attention.ragged_paged_attention_chunked``), as
the JAX MLA block does.

On a dp mesh the MoE forward calls the block through
``parallel.dp_attention.dp_attend``: it sees the rank's shard (its tokens,
its block ids rebased to its ``[L, slots / dp, F]`` latent plane), so A
and B run at rank-local shapes, as the Pallas kernels do per shard under
JAX's ``shard_map``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from llm_d_tpu_torch.models.config import ModelConfig
from llm_d_tpu_torch.ops import attention as A
from llm_d_tpu_torch.ops import layers as L
from llm_d_tpu_torch.ops import mla_decode, mla_prefill
from llm_d_tpu_torch.ops.quant import quantize_kv_block

Params = Dict[str, Any]


def mla_param_shapes(c: ModelConfig, n_layers: int) -> Dict[str, Tuple[int, ...]]:
    """Stacked-per-layer MLA projection shapes (HF DeepSeek naming)."""
    H = c.num_heads
    qk = c.qk_nope_head_dim + c.qk_rope_head_dim
    shapes: Dict[str, Tuple[int, ...]] = {
        "kv_a_proj": (n_layers, c.hidden_size,
                      c.kv_lora_rank + c.qk_rope_head_dim),
        "kv_a_norm": (n_layers, c.kv_lora_rank),
        "kv_b_proj": (n_layers, c.kv_lora_rank,
                      H * (c.qk_nope_head_dim + c.v_head_dim)),
        "o_proj": (n_layers, H * c.v_head_dim, c.hidden_size),
    }
    if c.q_lora_rank > 0:
        shapes.update({
            "q_a_proj": (n_layers, c.hidden_size, c.q_lora_rank),
            "q_a_norm": (n_layers, c.q_lora_rank),
            "q_b_proj": (n_layers, c.q_lora_rank, H * qk),
        })
    else:
        shapes["q_proj"] = (n_layers, c.hidden_size, H * qk)
    return shapes


def mla_attention_block(
    lp: Params,
    config: ModelConfig,
    x: torch.Tensor,                  # [T, Hm]
    batch: Dict[str, torch.Tensor],
    kv_cache: torch.Tensor,           # [L, slots, F_cache] stacked
    block_size: int,
    attn_backend: str,
    layer: int,
    kv_scale: torch.Tensor = None,    # int8 latent: [L, slots, SW] f32
    mesh=None,
) -> torch.Tensor:
    """Weight-absorbed MLA over the paged latent cache: returns
    ``[T, Hm]``; the cache (and scale plane) is updated in place.  Under
    tensor parallelism ``config`` is the rank's local config (its share
    of the heads: q_b / kv_b are column-parallel, head-major), the latent
    row and its cache are replicated, and o_proj sums the ranks' partial
    products."""
    c = config
    T = x.shape[0]
    H = c.num_heads
    nope, rope = c.qk_nope_head_dim, c.qk_rope_head_dim
    vdim = c.v_head_dim
    R = c.kv_lora_rank
    F = R + rope

    if "q_a_proj" in lp:
        cq = L.rms_norm(L.linear(x, lp["q_a_proj"]), lp["q_a_norm"],
                        c.rms_norm_eps)
        q = L.linear(cq, lp["q_b_proj"]).reshape(T, H, nope + rope)
    else:
        q = L.linear(x, lp["q_proj"]).reshape(T, H, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    kv_a = L.linear(x, lp["kv_a_proj"])                     # [T, R + rope]
    c_kv = L.rms_norm(kv_a[:, :R], lp["kv_a_norm"], c.rms_norm_eps)
    k_pe = kv_a[:, R:].reshape(T, 1, rope)

    cos, sin = L.rope_cos_sin(batch["positions"], rope, c.rope_theta)
    q_pe = L.apply_rope(q_pe, cos, sin)
    k_pe = L.apply_rope(k_pe, cos, sin)[:, 0, :]            # [T, rope]

    # kv_b columns are head-major [h0:(nope|v), h1:(nope|v), ...].
    w_kv = lp["kv_b_proj"].reshape(R, H, nope + vdim)
    w_uk, w_uv = w_kv[..., :nope], w_kv[..., nope:]
    q_lat = torch.einsum("thn,rhn->thr", q_nope.float(), w_uk.float())
    # The absorbed query is rounded to the model dtype here, before any
    # attention path sees it (the JAX package rounds at the same point).
    q_eff = torch.cat([q_lat, q_pe.float()], dim=-1).to(x.dtype)  # [T,H,F]

    row = torch.cat([c_kv, k_pe], dim=-1)                   # [T, F]
    # Softmax scale comes from the UNABSORBED query dim (nope + rope).
    scale = (nope + rope) ** -0.5

    # Lane-padded cache rows: zero columns are score-neutral.
    F_cache = kv_cache.shape[-1]
    if F_cache > F:
        row = torch.nn.functional.pad(row, (0, F_cache - F))
        q_eff = torch.nn.functional.pad(q_eff, (0, F_cache - F))

    quantized = kv_scale is not None
    row_s = None
    if quantized:
        # One symmetric f32 scale per latent row (SW = 1).
        row, row_s = quantize_kv_block(row, kv_scale.shape[-1])

    backend = A.resolve_backend(attn_backend, x.device)
    qtok_idx = batch["qtok_idx"]
    kernel_ok = not quantized or block_size % 32 == 0
    if backend == "kernel" and kernel_ok and A.decode_kernel_eligible(
            batch, block_size, F_cache):
        rows_idx = qtok_idx[:, 0].clamp(0, T - 1).long()
        out = mla_decode.mla_paged_decode_update(
            q_eff[rows_idx].contiguous(), row[rows_idx].contiguous(),
            kv_cache, batch["block_tables"], batch["seq_lens"],
            block_size=block_size, scale=scale, layer=layer,
            kv_scale=kv_scale,
            row_scale_new=(row_s[rows_idx].contiguous() if quantized
                           else None))
        out_lat = out[batch["token_seq_ids"].long()][..., :R].float()
    elif backend == "kernel" and kernel_ok and qtok_idx.shape[1] > 1 \
            and block_size % 16 == 0 and F_cache % 128 == 0:
        A.write_kv(kv_cache, row, batch["slot_mapping"], layer=layer)
        if quantized:
            A.write_scales(kv_scale, row_s, batch["slot_mapping"],
                           layer=layer)
        qs, q_pos = A.gather_per_seq_queries(
            q_eff, batch["positions"], qtok_idx)            # [S, Q, H, F]
        out_s = mla_prefill.mla_flash_prefill(
            qs.contiguous(), q_pos.to(torch.int32).contiguous(), kv_cache,
            batch["block_tables"], batch["seq_lens"],
            block_size=block_size, scale=scale, layer=layer,
            kv_scale=kv_scale)
        out_lat = out_s[batch["token_seq_ids"].long(),
                        batch["token_qpos"].long()][..., :R].float()
    else:
        # KVH = 1: every head reads the same latent row, and the value
        # "cache" is the key cache (attended values are its first R
        # columns).
        A.write_kv(kv_cache, row, batch["slot_mapping"], layer=layer)
        if quantized:
            A.write_scales(kv_scale, row_s, batch["slot_mapping"],
                           layer=layer)
        out_lat = A.ragged_paged_attention_chunked(
            q_eff, kv_cache, kv_cache, batch["token_seq_ids"],
            batch["positions"], batch["block_tables"], batch["seq_lens"],
            qtok_idx, batch["token_qpos"], block_size=block_size,
            scale=scale, layer=layer, k_scale=kv_scale,
            v_scale=kv_scale)[..., :R].float()

    attn = torch.einsum("thr,rhv->thv", out_lat,
                        w_uv.float()).to(x.dtype)
    return L.linear_reduce(attn.reshape(T, H * vdim), lp["o_proj"], mesh)


def mla_sharding_rules():
    """TP over heads (the JAX table): q_b / kv_b column-parallel
    (head-major last dim), o_proj row-parallel; the low-rank
    down-projections and norms replicate."""
    return [
        (r"layers/(q_proj|q_b_proj|kv_b_proj)", (None, None, "tp")),
        (r"layers/o_proj", (None, "tp", None)),
    ]
