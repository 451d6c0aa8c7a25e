"""MoE decoder-only transformer, DeepSeek (MLA) and Qwen-MoE / Mixtral
(GQA) families (port of the single-device half of
``llm_d_tpu.models.moe``).

Parameters keep the JAX package's tree: ``dense_layers`` and
``moe_layers`` hold weights stacked on a leading layer axis (the first
``first_dense_layers`` layers run a dense SwiGLU MLP, the rest shared +
routed experts; with none, ``dense_layers`` keeps its keys with 0-length
leading dims), and a plain Python loop walks the layers.  The MLA cache
is one latent ``[L, slots, F]`` buffer (plus an f32 ``[L, slots, 1]``
scale plane for the int8 latent); the GQA cache is ``{"k", "v"}`` of
``[L, slots, KVH*D]`` (plus f32 ``{"k_scale", "v_scale"}`` planes for an
int8 cache), as the dense family's.  Every layer updates its plane in
place.

On a mesh (``mesh`` with ``tp`` = N): attention, the shared expert, the
first dense layers, the embedding and the head are tensor-parallel as in
``models.llama`` / ``models.mla`` (:func:`sharding_rules`, the JAX
table), the routed experts expert-parallel over all N ranks
(``ops.moe.expert_ffn(..., mesh=)``), and the router and the residual
stream replicated.  The MLA latent cache is replicated; GQA K/V hold the
rank's KV heads (:func:`kv_cache_spec`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from llm_d_tpu_torch.models.config import ModelConfig
# The logits head and the MTP drafter are shared with the dense family
# and are part of this module's model API (the drafter reads only the
# embedding and head of the target, which both families carry alike).
from llm_d_tpu_torch.models.llama import (  # noqa: F401
    compute_logits, draft_propose, init_draft_params)
from llm_d_tpu_torch.models.llama import (
    attention_block, attention_params, embed_tokens, local_config,
    param_makers, prefixed, sharded_planes)
from llm_d_tpu_torch.models.mla import (mla_attention_block,
                                        mla_param_shapes,
                                        mla_sharding_rules)
from llm_d_tpu_torch.ops import layers as L
from llm_d_tpu_torch.ops import moe as moe_ops
from llm_d_tpu_torch.ops.quant import quantize_int8
from llm_d_tpu_torch.parallel.mesh import AXIS_EP
from llm_d_tpu_torch.parallel.sharding import shard_slices

Params = Dict[str, Any]

QUANT_KEYS = ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s",
              "w_down_q", "w_down_s")


def quantized_normal_param(shape, std, dt, generator, device, spec=(),
                           mesh=None) -> Dict[str, torch.Tensor]:
    """``normal_param`` of an expert stack ``[L, E, K, N]`` straight into
    int8: ``{"_q": int8 [L, E, K, N], "_s": f32 [L, E, 1, N]}``.  Each
    ``[K, N]`` plane is drawn as ``normal_param`` draws it, rounded to
    ``dt`` and quantized over K at once (``quantize_int8`` scales each
    plane's columns alone, so this equals quantizing the whole stack).
    With a ``mesh`` only this rank's experts (``spec``) are kept: every
    plane is drawn, the others dropped unquantized."""
    lead = shape[:-2]
    K, N = shape[-2:]
    if mesh is None or mesh.size == 1:
        sl = tuple(slice(0, n) for n in shape)
    else:
        sl = shard_slices(shape, spec, mesh.shape, mesh.coord)
    own = [s.stop - s.start for s in sl[:-2]]
    q = torch.empty((*own, K, N), dtype=torch.int8, device=device)
    s = torch.empty((*own, 1, N), dtype=torch.float32, device=device)
    for idx, qp in sharded_planes(shape, sl, q):
        w = (torch.randn((K, N), generator=generator, device=device,
                         dtype=torch.float32) * std).to(dt)
        if qp is not None:
            sp = s[tuple(i - t.start for i, t in zip(idx, sl))]
            qp[...], sp[...] = quantize_int8(w)
    return {"_q": q, "_s": s}


def init_params(config: ModelConfig, generator: torch.Generator,
                device, quantize_experts: bool = False,
                mesh=None) -> Params:
    """Random-init parameters on ``device`` (same shapes, scales and tree
    as the JAX package; the random bits differ).

    With ``quantize_experts`` the routed experts come as int8 payloads
    and scales (``quantize_moe_experts``' tree), each expert plane drawn
    in bf16 and quantized at once, so no bf16 expert stack is ever held;
    the draws are the same, so the result equals ``init_params`` then
    ``quantize_moe_experts`` bit for bit.  With a ``mesh``, this rank's
    shards of :func:`sharding_rules` (equal to the full init's slices:
    every plane is drawn, only the rank's are kept)."""
    c = config
    dt = c.torch_dtype
    Ld = c.first_dense_layers
    Lm = c.num_layers - Ld
    E, Im = c.num_experts, c.moe_intermediate_size
    Ish = Im * c.num_shared_experts
    rules = sharding_rules(c)
    w, ones = param_makers(c, generator, device, rules, mesh)

    def attn_params(n, prefix):
        wl, onesl = prefixed(w, prefix), prefixed(ones, prefix)
        if not c.use_mla:
            return attention_params(c, n, wl, onesl)
        p = {}
        for name, shape in mla_param_shapes(c, n).items():
            p[name] = (onesl(shape, name) if name.endswith("_norm")
                       else wl(shape, name))
        p["input_norm"] = onesl((n, c.hidden_size), "input_norm")
        p["post_attn_norm"] = onesl((n, c.hidden_size), "post_attn_norm")
        return p

    def experts(shape, name):
        if not quantize_experts:
            return {"": w(shape, f"moe_layers/{name}")}
        return quantized_normal_param(
            shape, shape[-2] ** -0.5, dt, generator, device,
            (None, AXIS_EP), mesh)

    dense = attn_params(Ld, "dense_layers")
    dense.update({
        "gate_proj": w((Ld, c.hidden_size, c.intermediate_size),
                       "dense_layers/gate_proj"),
        "up_proj": w((Ld, c.hidden_size, c.intermediate_size),
                     "dense_layers/up_proj"),
        "down_proj": w((Ld, c.intermediate_size, c.hidden_size),
                       "dense_layers/down_proj"),
    })
    moe = attn_params(Lm, "moe_layers")
    moe["router"] = w((Lm, c.hidden_size, E), "moe_layers/router").float()
    for name, shape in (("w_gate", (Lm, E, c.hidden_size, Im)),
                        ("w_up", (Lm, E, c.hidden_size, Im)),
                        ("w_down", (Lm, E, Im, c.hidden_size))):
        moe.update({name + sfx: t
                    for sfx, t in experts(shape, name).items()})
    if c.scoring_func == "sigmoid":
        moe["e_bias"] = torch.zeros((Lm, E), dtype=torch.float32,
                                    device=device)
    if c.num_shared_experts > 0:
        moe.update({
            "shared_gate": w((Lm, c.hidden_size, Ish),
                             "moe_layers/shared_gate"),
            "shared_up": w((Lm, c.hidden_size, Ish), "moe_layers/shared_up"),
            "shared_down": w((Lm, Ish, c.hidden_size),
                             "moe_layers/shared_down"),
        })
    params: Params = {
        "embed": w((c.vocab_size, c.hidden_size), "embed"),
        "dense_layers": dense,
        "moe_layers": moe,
        "final_norm": ones((c.hidden_size,), "final_norm"),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = w((c.hidden_size, c.vocab_size), "lm_head")
    return params


def forward(params: Params, kv_cache: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], config: ModelConfig,
            block_size: int, attn_backend: str = "auto",
            collect_routed: bool = False,
            moe_opts: Optional[Dict[str, Any]] = None, mesh=None,
            collect_moe_trace: bool = False):
    """One engine step over a ragged batch: returns the final-normed
    hidden states of the sampling rows ``[S, D]``; ``kv_cache`` ({"kv"}
    or {"kv", "kv_scale"}) is updated in place.  With ``collect_routed``
    also returns the routed LOGICAL expert ids ``[Lm, T, k]`` (int32) of
    every MoE layer, for EPLB's load tracker.

    With ``replica_table`` / ``num_replicas`` in ``moe_layers`` (EPLB's
    physical table) a token's logical experts go to physical replicas
    (``ops.moe.to_physical_experts``, phased by the MoE layer index), and
    the expert weights are the ``[Lm, P, ...]`` physical ones.
    ``moe_opts["stub_components"]`` drops components for the attribution
    sweep, as the JAX forward does: ``attn`` (the whole attention block,
    cache writes included: the block contributes zeros), ``moe_ffn`` (the
    routed experts; routing still runs, so EPLB still collects) and
    ``shared_expert``.

    ``kv_cache`` is the MLA latent ({"kv"} or {"kv", "kv_scale"}) or, for
    GQA attention, the dense family's ({"k", "v"} or {"k", "v",
    "k_scale", "v_scale"}), as the JAX forward reads it.

    With ``mesh`` every rank runs its shard (module docstring) and
    returns the same hidden states.  ``collect_moe_trace`` returns, in
    place of the routed ids, what each MoE layer's EP dispatch ships:
    ``{"x": [Lm, T, H], "weights": [Lm, T, k], "idx": [Lm, T, k]}`` (the
    collective accuracy harness's trace)."""
    c = config
    lc = local_config(c, mesh)
    Ld = c.first_dense_layers
    if c.use_mla:
        kv = kv_cache["kv"]
        kv_scale = kv_cache.get("kv_scale")
    else:
        names = (("k", "v", "k_scale", "v_scale") if "k_scale" in kv_cache
                 else ("k", "v"))
        caches = tuple(kv_cache[n] for n in names)
    dl, ml = params["dense_layers"], params["moe_layers"]
    stub = frozenset((moe_opts or {}).get("stub_components") or ())
    quant_stacked = ({k: ml[k] for k in QUANT_KEYS}
                     if "w_gate_q" in ml else None)
    routed = []
    trace = {"x": [], "weights": [], "idx": []}
    x = embed_tokens(params, batch["token_ids"], mesh)
    for li in range(c.num_layers):
        if li < Ld:
            lp = {k: v[li] for k, v in dl.items()}
        else:
            lp = {k: v[li - Ld] for k, v in ml.items() if k not in QUANT_KEYS}
        hn_in = L.rms_norm(x, lp["input_norm"], c.rms_norm_eps)
        if "attn" in stub:
            a = torch.zeros_like(hn_in)
        elif not c.use_mla:
            a = attention_block(lp, lc, hn_in, batch, caches, block_size,
                                attn_backend, layer=li, mesh=mesh)
        else:
            a = mla_attention_block(
                lp, lc, hn_in, batch, kv, block_size, attn_backend, layer=li,
                kv_scale=kv_scale, mesh=mesh)
        # Two bf16 roundings the JAX reference does not perform: under jit
        # XLA feeds the post-attention norm the f32 residual sum, and the
        # router the f32 norm output (an f32 -> bf16 -> f32 convert pair is
        # dropped).  The residual stream itself is stored rounded.
        h32 = x.float() + a.float()
        x = h32.to(x.dtype)
        hn32 = L.rms_norm(h32, lp["post_attn_norm"], c.rms_norm_eps)
        hn = hn32.to(x.dtype)
        if li < Ld:
            m = L.swiglu_mlp(hn, lp["gate_proj"], lp["up_proj"],
                             lp["down_proj"], mesh)
        else:
            weights, idx = moe_ops.route(
                torch.matmul(hn32, lp["router"]), c,
                e_bias=lp.get("e_bias"))
            routed.append(idx)
            phys_idx = idx
            if "replica_table" in lp:
                # A physical replica of each logical expert, round-robin,
                # the MoE layer index phasing the walk.
                phys_idx = moe_ops.to_physical_experts(
                    idx, lp["replica_table"], lp["num_replicas"],
                    phase=li - Ld)
            if collect_moe_trace:
                # The operands the EP dispatch ships: the normed rows and
                # the routing the combine applies.
                for key, v in (("x", hn), ("weights", weights),
                               ("idx", phys_idx)):
                    trace[key].append(v)
            if "moe_ffn" in stub:
                m = torch.zeros_like(hn)
            elif quant_stacked is not None:
                m = moe_ops.expert_ffn(
                    hn, weights, phys_idx, None, None, None,
                    quant=dict(quant_stacked, layer=li - Ld), mesh=mesh)
            else:
                m = moe_ops.expert_ffn(hn, weights, phys_idx, lp["w_gate"],
                                       lp["w_up"], lp["w_down"], mesh=mesh)
            if "shared_gate" in lp and "shared_expert" not in stub:
                m = m + L.swiglu_mlp(hn, lp["shared_gate"], lp["shared_up"],
                                     lp["shared_down"], mesh)
        x = x + m
    x = L.rms_norm(x, params["final_norm"], c.rms_norm_eps)
    hidden = x[batch["sample_idx"].long()]
    if collect_moe_trace:
        return hidden, {k: torch.stack(v) for k, v in trace.items()}
    if collect_routed:
        return hidden, torch.stack(routed)
    return hidden


def kv_cache_layout(config: ModelConfig) -> Dict[str, int]:
    """Per-buffer cache row widths.  MLA: ONE latent row per token
    (kv_lora_rank + rope), always lane-padded to a multiple of 128 so the
    width depends on the config alone (576 -> 640 for V3); GQA: the
    folded ``[KVH*D]`` K and V rows."""
    if config.use_mla:
        w = config.kv_lora_rank + config.qk_rope_head_dim
        return {"kv": -(-w // 128) * 128}
    w = config.num_kv_heads * config.head_dim_
    return {"k": w, "v": w}


def sharding_rules(config: ModelConfig):
    """TP for attention, the shared expert, the dense layers, embedding
    and head (Megatron layout), EP over the flattened (dp, sp, tp) axes
    for the routed experts (the JAX table)."""
    rules = [
        (r"embed", (None, "tp")),
        (r"layers/(q|k|v)_proj", (None, None, "tp")),
        (r"layers/(q|k|v)_bias", (None, "tp")),
        (r"layers/o_proj", (None, "tp", None)),
        (r"dense_layers/(gate|up)_proj", (None, None, "tp")),
        (r"dense_layers/down_proj", (None, "tp", None)),
        (r"moe_layers/router", ()),
        (r"moe_layers/w_(gate|up|down)", (None, AXIS_EP)),
        (r"moe_layers/shared_(gate|up)", (None, None, "tp")),
        (r"moe_layers/shared_down", (None, "tp", None)),
        (r"lm_head", (None, "tp")),
    ]
    if config.use_mla:
        rules = mla_sharding_rules() + rules
    return rules


def kv_cache_spec(config: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Cache sharding: the MLA latent row is shared by all (tp-sharded)
    heads and replicates; GQA K/V shard their folded head dim."""
    if config is not None and config.use_mla:
        return {"kv": ()}
    return {"k": (None, None, "tp"), "v": (None, None, "tp")}
