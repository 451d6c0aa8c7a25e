"""Dense decoder-only transformer, Llama / Qwen2 / Qwen3 families (port of
``llm_d_tpu.models.llama``).

Parameters keep the JAX package's tree (``embed``, ``layers`` stacked on
a leading layer axis, ``final_norm``, ``lm_head`` unless the embeddings
are tied), and a plain Python loop walks the layers.  The paged cache is
``{"k", "v"}`` of ``[L, slots, KVH*D]`` (plus f32 ``{"k_scale",
"v_scale"}`` planes ``[L, slots, SW]`` for an int8 cache), every layer
updating its plane in place.

Tensor parallelism (``mesh`` with ``tp`` > 1): each rank holds its shard
of :func:`sharding_rules` (the JAX table, Megatron layout) and runs the
collectives XLA inserts for it: the embedding is sharded on the hidden
dim and all-gathered; q/k/v (and gate/up) are column-parallel, so
attention runs at this rank's heads (``local_config``); o_proj (and
down_proj) are row-parallel, their f32 partial products summed over
``tp`` before the one rounding; ``lm_head`` is sharded on the vocabulary
and the logits all-gathered.  The residual stream is replicated.  The
K/V cache holds this rank's KV heads (:func:`kv_cache_spec`); an int8
cache with one scale per row takes the row's amax over every rank.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Tuple

import torch

from llm_d_tpu_torch.models.config import ModelConfig
from llm_d_tpu_torch.ops import attention as A
from llm_d_tpu_torch.ops import layers as L
from llm_d_tpu_torch.parallel.dp_attention import dp_attend
from llm_d_tpu_torch.parallel.sharding import (shard_slices, shard_tensor,
                                               spec_for_path)

Params = Dict[str, Any]


def normal_param(shape, std, dt, generator, device, spec=(),
                 mesh=None) -> torch.Tensor:
    """N(0, std^2) in f32 rounded to ``dt``, drawn one leading plane at a
    time so the f32 temporary stays one plane.

    With a ``mesh`` only this rank's shard of ``spec`` is kept: every
    plane is still drawn, in the same order, so the shard equals the
    full tensor's slice; planes outside the shard are dropped as they
    are drawn."""
    if mesh is None or mesh.size == 1:
        out = torch.empty(shape, dtype=dt, device=device)
        planes = out.reshape(-1, *shape[-2:]) if len(shape) > 2 else out[None]
        for p in planes:
            p.copy_(torch.randn(p.shape, generator=generator, device=device,
                                dtype=torch.float32).mul_(std))
        return out
    sl = shard_slices(shape, spec, mesh.shape, mesh.coord)
    out = torch.empty([s.stop - s.start for s in sl], dtype=dt,
                      device=device)
    for _, dst in sharded_planes(shape, sl, out):
        # Scaled in place: one f32 plane at a time (the head's is 3.1 GB
        # at qwen3-32b, drawn whole on every rank).
        p = torch.randn(shape[-2:], generator=generator, device=device,
                        dtype=torch.float32).mul_(std)
        if dst is not None:
            dst.copy_(p[sl[-2], sl[-1]])
    return out


def sharded_planes(shape, sl, out):
    """(leading index, ``out``'s plane or None) for every ``[K, N]``
    plane of a full tensor of ``shape``, in drawing order; None for a
    plane outside the shard ``sl``."""
    lead = tuple(shape[:-2])
    for idx in itertools.product(*(range(n) for n in lead)):
        inside = all(s.start <= i < s.stop for i, s in zip(idx, sl))
        yield idx, (out[tuple(i - s.start for i, s in zip(idx, sl))]
                    if inside else None)


def attention_params(config: ModelConfig, n: int, w, ones) -> Params:
    """The GQA attention tree of ``n`` stacked layers (the dense family's,
    and the MoE family's without MLA: JAX ``moe._attn_params``):
    projections from ``w(shape, name)``, norms from ``ones(shape,
    name)``, zero biases under ``attention_bias`` and q/k norms under
    ``qk_norm``."""
    c = config
    dh, Hm = c.head_dim_, c.hidden_size
    p = {
        "input_norm": ones((n, Hm), "input_norm"),
        "q_proj": w((n, Hm, c.num_heads * dh), "q_proj"),
        "k_proj": w((n, Hm, c.num_kv_heads * dh), "k_proj"),
        "v_proj": w((n, Hm, c.num_kv_heads * dh), "v_proj"),
        "o_proj": w((n, c.num_heads * dh, Hm), "o_proj"),
        "post_attn_norm": ones((n, Hm), "post_attn_norm"),
    }
    if c.attention_bias:
        for name, heads in (("q_bias", c.num_heads), ("k_bias",
                            c.num_kv_heads), ("v_bias", c.num_kv_heads)):
            p[name] = torch.zeros_like(ones((n, heads * dh), name))
    if c.qk_norm:
        p["q_norm"] = ones((n, dh), "q_norm")
        p["k_norm"] = ones((n, dh), "k_norm")
    return p


def param_makers(config: ModelConfig, generator, device, rules, mesh):
    """``(w, ones)`` leaf makers keyed by parameter path: ``w(shape,
    path)`` draws ``normal_param`` with std ``shape[-2] ** -0.5``,
    ``ones(shape, path)`` fills ones; with a mesh each keeps this rank's
    shard of the rule for ``path`` (the same draws either way)."""
    dt = config.torch_dtype

    def spec(shape, path):
        if mesh is None:
            return ()
        return spec_for_path(rules, path, torch.empty(shape, device="meta"))

    def w(shape, path):
        return normal_param(shape, shape[-2] ** -0.5, dt, generator, device,
                            spec(shape, path), mesh)

    def ones(shape, path):
        t = torch.ones(shape, dtype=dt, device=device)
        return t if mesh is None else shard_tensor(t, spec(shape, path),
                                                   mesh)
    return w, ones


def prefixed(make, prefix: str):
    """A leaf maker whose paths sit under ``prefix``."""
    return lambda shape, name: make(shape, f"{prefix}/{name}")


def init_params(config: ModelConfig, generator: torch.Generator,
                device, mesh=None) -> Params:
    """Random-init parameters on ``device`` (same shapes, scales and tree
    as the JAX package; the random bits differ).  With a ``mesh``, this
    rank's shards of :func:`sharding_rules` (equal to the full init's
    slices)."""
    c = config
    Lc = c.num_layers
    Hm = c.hidden_size
    w, ones = param_makers(c, generator, device, sharding_rules(c), mesh)
    wl, onesl = prefixed(w, "layers"), prefixed(ones, "layers")
    layers = attention_params(c, Lc, wl, onesl)
    layers.update({
        "gate_proj": wl((Lc, Hm, c.intermediate_size), "gate_proj"),
        "up_proj": wl((Lc, Hm, c.intermediate_size), "up_proj"),
        "down_proj": wl((Lc, c.intermediate_size, Hm), "down_proj"),
    })
    params: Params = {
        "embed": w((c.vocab_size, Hm), "embed"),
        "layers": layers,
        "final_norm": ones((Hm,), "final_norm"),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = w((Hm, c.vocab_size), "lm_head")
    return params


def local_config(config: ModelConfig, mesh) -> ModelConfig:
    """The config of this rank's attention under tensor parallelism: its
    share of the query heads and (GQA) KV heads, ``head_dim`` pinned."""
    tp = tp_size(mesh)
    if tp == 1:
        return config
    c = config
    kvh = c.num_kv_heads
    if not c.use_mla:
        if kvh % tp:
            raise ValueError(
                f"{c.name}: {kvh} KV heads do not divide over tp={tp}")
        kvh //= tp
    if c.num_heads % tp:
        raise ValueError(f"{c.name}: {c.num_heads} heads do not divide "
                         f"over tp={tp}")
    return dataclasses.replace(c, num_heads=c.num_heads // tp,
                               num_kv_heads=kvh, head_dim=c.head_dim_)


def tp_size(mesh) -> int:
    return 1 if mesh is None else mesh.axis_size("tp")


def embed_tokens(params: Params, token_ids: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Embedding lookup; under tp each rank holds its hidden-dim shard of
    the table, and the rows are all-gathered."""
    x = params["embed"][token_ids.long()]
    if tp_size(mesh) > 1:
        x = mesh.all_gather(x, "tp", dim=-1)
    return x


def row_amax_reduce(mesh, scale_width: int):
    """The amax reduction an int8 cache row needs under tp: one scale per
    row (``scale_width`` 1) covers every rank's columns; per-head scales
    stay local."""
    if tp_size(mesh) == 1 or scale_width != 1:
        return None
    return lambda amax: mesh.all_reduce(amax, "tp", op="max")


def attention_block(lp: Params, config: ModelConfig, x: torch.Tensor,
                    batch: Dict[str, torch.Tensor],
                    caches: Tuple[torch.Tensor, ...], block_size: int,
                    attn_backend: str, layer: int,
                    mesh=None) -> torch.Tensor:
    """GQA self-attention over the paged cache: returns ``[T, Hm]``.
    ``caches`` is (k, v) or, for an int8 cache, (k, v, k_scale, v_scale),
    all stacked and updated in place at plane ``layer``.  ``config`` is
    the rank's :func:`local_config` under tp (its heads), and o_proj sums
    the ranks' partial products."""
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
        v_scale=v_scale, amax_reduce=row_amax_reduce(
            mesh, k_scale.shape[-1] if k_scale is not None else 0))[0]
    return L.linear_reduce(attn.reshape(T, c.num_heads * dh), lp["o_proj"],
                           mesh)


def forward(params: Params, kv_cache: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], config: ModelConfig,
            block_size: int, attn_backend: str = "auto",
            mesh=None) -> torch.Tensor:
    """One engine step over a ragged batch: returns the final-normed
    hidden states of the sampling rows ``[S, D]`` (on every rank of a
    mesh); ``kv_cache`` is updated in place.  On a mesh with ``dp`` > 1
    the batch, the cache planes and the rows returned are the rank's dp
    shard's (``parallel/dp_attention.py``)."""
    c = config
    lc = local_config(c, mesh)
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in kv_cache \
        else ("k", "v")
    caches = tuple(kv_cache[n] for n in names)

    def attend(lp, hn, caches, ab, li):
        return attention_block(lp, lc, hn, ab, caches, block_size,
                               attn_backend, layer=li, mesh=mesh)

    x = embed_tokens(params, batch["token_ids"], mesh)
    for li in range(c.num_layers):
        lp = {k: v[li] for k, v in params["layers"].items()}
        # On a dp mesh: the rank's shard, its tokens over its cache plane.
        a = dp_attend(attend, mesh, lp,
                      L.rms_norm(x, lp["input_norm"], c.rms_norm_eps),
                      caches, batch, li)
        # Under jit XLA feeds the post-attention norm the f32 residual sum
        # (its f32 -> bf16 -> f32 convert pair is dropped); the residual
        # stream itself is stored rounded (see models/moe.py).
        h32 = x.float() + a.float()
        x = h32.to(x.dtype)
        hn = L.rms_norm(h32, lp["post_attn_norm"], c.rms_norm_eps).to(x.dtype)
        x = x + L.swiglu_mlp(hn, lp["gate_proj"], lp["up_proj"],
                             lp["down_proj"], mesh)
    x = L.rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return x[batch["sample_idx"].long()]


def compute_logits(params: Params, hidden: torch.Tensor,
                   config: ModelConfig, mesh=None) -> torch.Tensor:
    """f32 logits (bf16 operands, f32 products and sums); tied models use
    the embedding's transpose.  Under tp the rank's vocabulary shard of
    ``lm_head`` gives its logits, all-gathered; a tied embedding is
    sharded on the hidden dim, so the ranks' partial logits are
    summed."""
    head = params.get("lm_head")
    if tp_size(mesh) == 1:
        if head is None:
            head = params["embed"].T
        return torch.matmul(hidden.float(), head.float())
    if head is not None:
        return mesh.all_gather(torch.matmul(hidden.float(), head.float()),
                               "tp", dim=-1)
    emb = params["embed"]
    h0 = mesh.axis_index("tp") * emb.shape[1]
    part = torch.matmul(hidden[:, h0:h0 + emb.shape[1]].float(),
                        emb.float().T)
    return mesh.all_reduce(part, "tp")


def sharding_rules(config: ModelConfig):
    """(path-regex, spec) table for TP over the mesh's ``tp`` axis (the
    JAX package's): column-parallel q/k/v/gate/up (+ lm_head),
    row-parallel o/down; norms replicate by the default rule."""
    return [
        (r"embed", (None, "tp")),
        (r"layers/(q|k|v)_proj", (None, None, "tp")),
        (r"layers/(q|k|v)_bias", (None, "tp")),
        (r"layers/(gate|up)_proj", (None, None, "tp")),
        (r"layers/o_proj", (None, "tp", None)),
        (r"layers/down_proj", (None, "tp", None)),
        (r"lm_head", (None, "tp")),
    ]


def kv_cache_spec(config: ModelConfig = None) -> Dict[str, Tuple]:
    """KV cache sharding: the folded head dim over tp, slots replicated."""
    return {"k": (None, None, "tp"), "v": (None, None, "tp")}


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
                  config: ModelConfig, mesh=None) -> torch.Tensor:
    """Greedy MTP rollout (``llama.draft_propose``): ``K`` draft ids
    ``[S, K]`` from the target's hidden state ``hidden [S, D]`` at the
    position that sampled ``last_ids [S]``; each depth folds the previous
    draft's embedding back in.  Drafts are greedy whatever the request's
    sampling (ties to the lower id): the verifier compares them with the
    target's own samples.  Under tp the embedding and the head are the
    target's shards (gathered rows, gathered or summed logits, as in its
    forward); the drafter's own weights are whole on every rank."""
    c, dp = config, draft_params
    eps = c.rms_norm_eps
    h, tok = hidden, last_ids.long()
    out = []
    for _ in range(K):
        e = embed_tokens(params, tok, mesh).to(h.dtype)
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
        tok = torch.argmax(compute_logits(params, h, c, mesh), dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


def kv_cache_layout(config: ModelConfig) -> Dict[str, int]:
    """Per-buffer cache row widths (folded ``[KVH*D]`` layout)."""
    w = config.num_kv_heads * config.head_dim_
    return {"k": w, "v": w}
