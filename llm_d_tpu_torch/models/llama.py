"""Dense decoder-only transformer, Llama / Qwen2 / Qwen3 families (port of
``llm_d_tpu.models.llama``, one device).

Parameters keep the JAX package's tree (``embed``, ``layers`` stacked on
a leading layer axis, ``final_norm``, ``lm_head`` unless the embeddings
are tied), and a plain Python loop walks the layers.  The paged cache is
``{"k", "v"}`` of ``[L, slots, KVH*D]`` (plus f32 ``{"k_scale",
"v_scale"}`` planes ``[L, slots, SW]`` for an int8 cache), every layer
updating its plane in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from llm_d_tpu_torch.models.config import ModelConfig
from llm_d_tpu_torch.ops import attention as A
from llm_d_tpu_torch.ops import layers as L

Params = Dict[str, Any]


def normal_param(shape, std, dt, generator, device) -> torch.Tensor:
    """N(0, std^2) in f32 rounded to ``dt``, drawn one leading plane at a
    time so the f32 temporary stays one plane."""
    out = torch.empty(shape, dtype=dt, device=device)
    planes = out.reshape(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for p in planes:
        p.copy_(torch.randn(p.shape, generator=generator, device=device,
                            dtype=torch.float32) * std)
    return out


def attention_params(config: ModelConfig, n: int, w, ones) -> Params:
    """The GQA attention tree of ``n`` stacked layers (the dense family's,
    and the MoE family's without MLA: JAX ``moe._attn_params``):
    projections from ``w(shape)``, norms from ``ones(shape)``, zero
    biases under ``attention_bias`` and q/k norms under ``qk_norm``."""
    c = config
    dh, Hm = c.head_dim_, c.hidden_size
    p = {
        "input_norm": ones((n, Hm)),
        "q_proj": w((n, Hm, c.num_heads * dh)),
        "k_proj": w((n, Hm, c.num_kv_heads * dh)),
        "v_proj": w((n, Hm, c.num_kv_heads * dh)),
        "o_proj": w((n, c.num_heads * dh, Hm)),
        "post_attn_norm": ones((n, Hm)),
    }
    if c.attention_bias:
        p["q_bias"] = torch.zeros_like(ones((n, c.num_heads * dh)))
        p["k_bias"] = torch.zeros_like(ones((n, c.num_kv_heads * dh)))
        p["v_bias"] = torch.zeros_like(ones((n, c.num_kv_heads * dh)))
    if c.qk_norm:
        p["q_norm"] = ones((n, dh))
        p["k_norm"] = ones((n, dh))
    return p


def init_params(config: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random-init parameters on ``device`` (same shapes, scales and tree
    as the JAX package; the random bits differ)."""
    c = config
    dt = c.torch_dtype
    Lc = c.num_layers
    Hm = c.hidden_size

    def w(shape):
        return normal_param(shape, shape[-2] ** -0.5, dt, generator, device)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = attention_params(c, Lc, w, ones)
    layers.update({
        "gate_proj": w((Lc, Hm, c.intermediate_size)),
        "up_proj": w((Lc, Hm, c.intermediate_size)),
        "down_proj": w((Lc, c.intermediate_size, Hm)),
    })
    params: Params = {
        "embed": w((c.vocab_size, Hm)),
        "layers": layers,
        "final_norm": ones((Hm,)),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = w((Hm, c.vocab_size))
    return params


def attention_block(lp: Params, config: ModelConfig, x: torch.Tensor,
                    batch: Dict[str, torch.Tensor],
                    caches: Tuple[torch.Tensor, ...], block_size: int,
                    attn_backend: str, layer: int) -> torch.Tensor:
    """GQA self-attention over the paged cache: returns ``[T, Hm]``.
    ``caches`` is (k, v) or, for an int8 cache, (k, v, k_scale, v_scale),
    all stacked and updated in place at plane ``layer``."""
    c = config
    dh = c.head_dim_
    T = x.shape[0]
    q = L.linear(x, lp["q_proj"], lp.get("q_bias")).reshape(
        T, c.num_heads, dh)
    kx = L.linear(x, lp["k_proj"], lp.get("k_bias")).reshape(
        T, c.num_kv_heads, dh)
    vx = L.linear(x, lp["v_proj"], lp.get("v_bias")).reshape(
        T, c.num_kv_heads, dh)
    if c.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], c.rms_norm_eps)
        kx = L.rms_norm(kx, lp["k_norm"], c.rms_norm_eps)
    cos, sin = L.rope_cos_sin(batch["positions"], dh, c.rope_theta)
    q = L.apply_rope(q, cos, sin)
    kx = L.apply_rope(kx, cos, sin)
    k_scale, v_scale = caches[2:] if len(caches) == 4 else (None, None)
    attn = A.attention_with_kv_update(
        q, kx, vx, caches[0], caches[1], batch, block_size=block_size,
        backend=attn_backend, layer=layer, k_scale=k_scale,
        v_scale=v_scale)[0]
    return L.linear(attn.reshape(T, c.num_heads * dh), lp["o_proj"])


def forward(params: Params, kv_cache: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], config: ModelConfig,
            block_size: int, attn_backend: str = "auto") -> torch.Tensor:
    """One engine step over a ragged batch: returns the final-normed
    hidden states of the sampling rows ``[S, D]``; ``kv_cache`` is
    updated in place."""
    c = config
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in kv_cache \
        else ("k", "v")
    caches = tuple(kv_cache[n] for n in names)
    x = params["embed"][batch["token_ids"].long()]
    for li in range(c.num_layers):
        lp = {k: v[li] for k, v in params["layers"].items()}
        a = attention_block(
            lp, c, L.rms_norm(x, lp["input_norm"], c.rms_norm_eps), batch,
            caches, block_size, attn_backend, layer=li)
        # Under jit XLA feeds the post-attention norm the f32 residual sum
        # (its f32 -> bf16 -> f32 convert pair is dropped); the residual
        # stream itself is stored rounded (see models/moe.py).
        h32 = x.float() + a.float()
        x = h32.to(x.dtype)
        hn = L.rms_norm(h32, lp["post_attn_norm"], c.rms_norm_eps).to(x.dtype)
        x = x + L.swiglu_mlp(hn, lp["gate_proj"], lp["up_proj"],
                             lp["down_proj"])
    x = L.rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return x[batch["sample_idx"].long()]


def compute_logits(params: Params, hidden: torch.Tensor,
                   config: ModelConfig) -> torch.Tensor:
    """f32 logits (bf16 operands, f32 products and sums); tied models use
    the embedding's transpose."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return torch.matmul(hidden.float(), head.float())


def init_draft_params(config: ModelConfig, generator: torch.Generator,
                      device) -> Params:
    """The MTP-style drafter (``llama.init_draft_params``): the last
    hidden state and the embedding of the token just sampled, each
    normed, through a ``[2D, D]`` projection plus one SwiGLU MLP; the
    target's embedding and head give the draft logits, and the same
    module serves every draft depth.  A tree of its own, apart from the
    target's parameters (same shapes and scales as the JAX package; the
    random bits differ)."""
    c = config
    dt = c.torch_dtype
    D, I = c.hidden_size, c.intermediate_size

    def w(shape):
        return normal_param(shape, shape[0] ** -0.5, dt, generator, device)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    return {
        "h_norm": ones((D,)),
        "e_norm": ones((D,)),
        "proj": w((2 * D, D)),
        "mlp_norm": ones((D,)),
        "gate_proj": w((D, I)),
        "up_proj": w((D, I)),
        "down_proj": w((I, D)),
    }


def draft_propose(params: Params, draft_params: Params, hidden: torch.Tensor,
                  last_ids: torch.Tensor, K: int,
                  config: ModelConfig) -> torch.Tensor:
    """Greedy MTP rollout (``llama.draft_propose``): ``K`` draft ids
    ``[S, K]`` from the target's hidden state ``hidden [S, D]`` at the
    position that sampled ``last_ids [S]``; each depth folds the previous
    draft's embedding back in.  Drafts are greedy whatever the request's
    sampling (ties to the lower id): the verifier compares them with the
    target's own samples."""
    c, dp = config, draft_params
    eps = c.rms_norm_eps
    h, tok = hidden, last_ids.long()
    out = []
    for _ in range(K):
        e = params["embed"][tok].to(h.dtype)
        x = torch.cat([L.rms_norm(h, dp["h_norm"], eps),
                       L.rms_norm(e, dp["e_norm"], eps)], dim=-1)
        # Under jit XLA feeds the MLP's norm the f32 product (the f32 ->
        # bf16 -> f32 convert pair is dropped); the residual sum adds the
        # rounded one.
        h2_32 = torch.matmul(x.float(), dp["proj"].float())
        h2 = h2_32.to(h.dtype)
        hn = L.rms_norm(h2_32, dp["mlp_norm"], eps).to(h.dtype)
        h = h2 + L.swiglu_mlp(hn, dp["gate_proj"], dp["up_proj"],
                              dp["down_proj"])
        tok = torch.argmax(compute_logits(params, h, c), dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


def kv_cache_layout(config: ModelConfig) -> Dict[str, int]:
    """Per-buffer cache row widths (folded ``[KVH*D]`` layout)."""
    w = config.num_kv_heads * config.head_dim_
    return {"k": w, "v": w}
