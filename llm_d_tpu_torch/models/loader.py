"""Checkpoint loading: HuggingFace safetensors -> the port's parameter tree
(port of ``llm_d_tpu.models.loader``).

Weights are loaded plane by plane and stacked on a leading layer axis, in
the tree ``models.llama.init_params`` / ``models.moe.init_params`` build;
linear weights transpose from HF's ``[out, in]`` to ``[in, out]``.  Every
value passes through f32 (FP8 block scales applied there) and is rounded
to the model dtype once, as the JAX loader does, so both packages load
bit-identical trees.  The safetensors format is read here (an 8-byte
little-endian header length, a JSON header, then the raw bytes): no
package beyond torch and numpy is needed, and a tensor is read only when
it is fetched.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from llm_d_tpu_torch.models.config import ModelConfig
from llm_d_tpu_torch.ops.quant import quantize_int8

# our stacked name -> HF per-layer suffix
_LAYER_MAP = {
    "input_norm": "input_layernorm.weight",
    "q_proj": "self_attn.q_proj.weight",
    "k_proj": "self_attn.k_proj.weight",
    "v_proj": "self_attn.v_proj.weight",
    "o_proj": "self_attn.o_proj.weight",
    "q_bias": "self_attn.q_proj.bias",
    "k_bias": "self_attn.k_proj.bias",
    "v_bias": "self_attn.v_proj.bias",
    "q_norm": "self_attn.q_norm.weight",
    "k_norm": "self_attn.k_norm.weight",
    "post_attn_norm": "post_attention_layernorm.weight",
    "gate_proj": "mlp.gate_proj.weight",
    "up_proj": "mlp.up_proj.weight",
    "down_proj": "mlp.down_proj.weight",
}
_TRANSPOSE = {"q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj"}

_ATTN_KEYS = ("input_norm", "q_proj", "k_proj", "v_proj", "o_proj",
              "q_bias", "k_bias", "v_bias", "q_norm", "k_norm",
              "post_attn_norm")
_MLP_KEYS = ("gate_proj", "up_proj", "down_proj")

# MLA projections (DeepSeek-V3/R1 HF naming; models/mla.py layout).
_MLA_MAP = {
    "input_norm": "input_layernorm.weight",
    "post_attn_norm": "post_attention_layernorm.weight",
    "q_a_proj": "self_attn.q_a_proj.weight",
    "q_a_norm": "self_attn.q_a_layernorm.weight",
    "q_b_proj": "self_attn.q_b_proj.weight",
    "kv_a_proj": "self_attn.kv_a_proj_with_mqa.weight",
    "kv_a_norm": "self_attn.kv_a_layernorm.weight",
    "kv_b_proj": "self_attn.kv_b_proj.weight",
    "o_proj": "self_attn.o_proj.weight",
}
_MLA_TRANSPOSE = {"q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj", "o_proj",
                  "q_proj"}

# safetensors dtype names -> torch dtypes.
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}


class SafetensorsFiles(Mapping):
    """The tensors of one or more ``.safetensors`` files, by name, each
    read from its file (into a CPU tensor) when it is looked up."""

    def __init__(self, paths: List[str]) -> None:
        self._index: Dict[str, Tuple[str, torch.dtype, List[int], int,
                                     int]] = {}
        for path in paths:
            with open(path, "rb") as f:
                (n,) = struct.unpack("<Q", f.read(8))
                header = json.loads(f.read(n))
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                begin, end = meta["data_offsets"]
                self._index[name] = (path, SAFETENSORS_DTYPES[meta["dtype"]],
                                     list(meta["shape"]), 8 + n + begin,
                                     end - begin)

    def __getitem__(self, name: str) -> torch.Tensor:
        path, dtype, shape, offset, nbytes = self._index[name]
        raw = torch.empty(nbytes, dtype=torch.uint8)   # aligned, writable
        with open(path, "rb") as f:
            f.seek(offset)
            if f.readinto(raw.numpy()) != nbytes:
                raise ValueError(f"{path}: {name} is truncated")
        return raw.view(dtype).reshape(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)


def _to_tensor(t: Any) -> torch.Tensor:
    """A torch tensor, or a numpy array (``uint16``: raw bf16 bits, as
    the JAX loader reads them), as a CPU tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    a = np.ascontiguousarray(t)
    if a.dtype == np.dtype("<u2"):
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def fetch_weight(weights: Mapping[str, Any], name: str) -> torch.Tensor:
    """An f32 CPU tensor of ``name``, dequantizing FP8 block-quantized
    checkpoints: DeepSeek-V3/R1 ship FP8 weights with a
    ``<name>_scale_inv`` per FIXED 128 x 128 block, the last block of a
    dim possibly partial (row // 128 indexes the grid, so e.g.
    kv_a_proj's 576 rows keep their scales)."""
    a = _to_tensor(weights[name]).float()
    sname = f"{name}_scale_inv"
    if sname in weights:
        s = _to_tensor(weights[sname]).float()
        block = 128
        ri = torch.clamp_max(torch.arange(a.shape[0]) // block,
                             s.shape[0] - 1)
        ci = torch.clamp_max(torch.arange(a.shape[1]) // block,
                             s.shape[1] - 1)
        a = a * s[ri][:, ci]
    return a


def _plane(weights, name: str, transpose: bool) -> torch.Tensor:
    w = fetch_weight(weights, name)
    return w.T if transpose else w


def _stack(weights, names: List[str], transpose: bool, dtype, device
           ) -> torch.Tensor:
    """``names``' planes stacked on a new leading axis, each rounded to
    ``dtype`` on its way to ``device``."""
    first = _plane(weights, names[0], transpose)
    out = torch.empty((len(names), *first.shape), dtype=dtype, device=device)
    out[0] = first.to(dtype)
    for i, n in enumerate(names[1:], 1):
        out[i] = _plane(weights, n, transpose).to(dtype)
    return out


def load_dense_from_state_dict(config: ModelConfig,
                               weights: Mapping[str, Any],
                               prefix: str = "model.",
                               device="cpu") -> Dict[str, Any]:
    """The dense tree (``models.llama``) on ``device`` from a flat
    HF-style state dict (torch tensors or numpy arrays)."""
    c = config
    dt = c.torch_dtype

    def one(name, transpose=False):
        return _plane(weights, name, transpose).to(dt).to(device)

    params: Dict[str, Any] = {
        "embed": one(f"{prefix}embed_tokens.weight"),
        "final_norm": one(f"{prefix}norm.weight"),
        "layers": {},
    }
    for ours, hf_suffix in _LAYER_MAP.items():
        if f"{prefix}layers.0.{hf_suffix}" not in weights:
            continue
        params["layers"][ours] = _stack(
            weights, [f"{prefix}layers.{li}.{hf_suffix}"
                      for li in range(c.num_layers)],
            ours in _TRANSPOSE, dt, device)
    if not c.tie_word_embeddings:
        params["lm_head"] = one("lm_head.weight", True)
    return params


def load_moe_from_state_dict(config: ModelConfig,
                             weights: Mapping[str, Any],
                             prefix: str = "model.", device="cpu",
                             quantize_experts: bool = False
                             ) -> Dict[str, Any]:
    """MoE checkpoint (DeepSeek-V3 / Qwen-MoE / Mixtral naming) -> the
    two-group tree of ``models.moe`` (``dense_layers`` then
    ``moe_layers``) on ``device``.

    HF names: router ``mlp.gate.weight``, experts
    ``mlp.experts.{e}.{gate,up,down}_proj.weight``, shared experts
    ``mlp.shared_experts.*`` (DeepSeek) / ``mlp.shared_expert.*`` (Qwen).
    With ``quantize_experts`` each expert plane is quantized as it is
    loaded (``w_gate_q`` / ``w_gate_s`` ..., equal to
    ``quantize_moe_experts`` of the bf16 tree), so no bf16 expert stack
    is ever held."""
    c = config
    dt = c.torch_dtype
    Ld = c.first_dense_layers

    def stack(names, transpose, dtype=dt):
        return _stack(weights, names, transpose, dtype, device)

    def one(name, transpose=False):
        return _plane(weights, name, transpose).to(dt).to(device)

    params: Dict[str, Any] = {
        "embed": one(f"{prefix}embed_tokens.weight"),
        "final_norm": one(f"{prefix}norm.weight"),
        "dense_layers": {}, "moe_layers": {},
    }

    def fill_attn(group: Dict, layer_ids):
        if c.use_mla:
            mla_map = dict(_MLA_MAP)
            if c.q_lora_rank == 0:
                # DeepSeek-V2-Lite: no query low-rank path, plain q_proj.
                for k_ in ("q_a_proj", "q_a_norm", "q_b_proj"):
                    mla_map.pop(k_)
                mla_map["q_proj"] = "self_attn.q_proj.weight"
            for ours, hf_suffix in mla_map.items():
                group[ours] = stack(
                    [f"{prefix}layers.{li}.{hf_suffix}" for li in layer_ids],
                    ours in _MLA_TRANSPOSE)
            return
        for ours in _ATTN_KEYS:
            hf_suffix = _LAYER_MAP[ours]
            if f"{prefix}layers.{layer_ids[0]}.{hf_suffix}" not in weights:
                continue
            group[ours] = stack(
                [f"{prefix}layers.{li}.{hf_suffix}" for li in layer_ids],
                ours in _TRANSPOSE)

    dense_ids = list(range(Ld))
    moe_ids = list(range(Ld, c.num_layers))
    if dense_ids:
        fill_attn(params["dense_layers"], dense_ids)
        for ours in _MLP_KEYS:
            params["dense_layers"][ours] = stack(
                [f"{prefix}layers.{li}.{_LAYER_MAP[ours]}"
                 for li in dense_ids], True)
    else:
        # first_dense_layers == 0 (Qwen3-MoE, Mixtral): the group keeps
        # init_params' keys with 0-length leading dims (an init with no
        # layers and a one-token vocabulary draws next to nothing).
        from llm_d_tpu_torch.models import moe as moe_model
        empty = dataclasses.replace(c, num_layers=0, vocab_size=1)
        params["dense_layers"] = moe_model.init_params(
            empty, torch.Generator(device="cpu").manual_seed(0),
            "cpu")["dense_layers"]
        params["dense_layers"] = {k: v.to(device) for k, v in
                                  params["dense_layers"].items()}

    fill_attn(params["moe_layers"], moe_ids)
    m = params["moe_layers"]
    m["router"] = stack([f"{prefix}layers.{li}.mlp.gate.weight"
                         for li in moe_ids], True, torch.float32)
    bias = "mlp.gate.e_score_correction_bias"
    if f"{prefix}layers.{moe_ids[0]}.{bias}" in weights:
        # DeepSeek-V3 sigmoid-selection bias (applied to routing choice only).
        m["e_bias"] = stack([f"{prefix}layers.{li}.{bias}" for li in moe_ids],
                            False, torch.float32)
    elif c.scoring_func == "sigmoid":
        m["e_bias"] = torch.zeros((len(moe_ids), c.num_experts),
                                  dtype=torch.float32, device=device)
    for ours, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                     ("w_down", "down_proj")):
        m.update(_load_experts(weights, [
            [f"{prefix}layers.{li}.mlp.experts.{e}.{hf}.weight"
             for e in range(c.num_experts)] for li in moe_ids],
            ours, dt, device, quantize_experts))
    # Shared experts load only when the config declares them: DeepSeek's
    # ungated add.  (Qwen2-MoE's *gated* shared expert is a different op and
    # is deliberately not claimed: loading its weights into the ungated path
    # would silently diverge from HF.)
    shared_prefix = None
    if c.num_shared_experts > 0:
        for cand in ("mlp.shared_experts", "mlp.shared_expert"):
            if f"{prefix}layers.{moe_ids[0]}.{cand}.gate_proj.weight" \
                    in weights:
                shared_prefix = cand
                break
    if shared_prefix is not None:
        for ours, hf in (("shared_gate", "gate_proj"),
                         ("shared_up", "up_proj"),
                         ("shared_down", "down_proj")):
            m[ours] = stack([f"{prefix}layers.{li}.{shared_prefix}.{hf}.weight"
                             for li in moe_ids], True)
    if not c.tie_word_embeddings:
        params["lm_head"] = one("lm_head.weight", True)
    return params


def _load_experts(weights, names: List[List[str]], ours: str, dt, device,
                  quantize: bool) -> Dict[str, torch.Tensor]:
    """One expert stack ``[Lm, E, in, out]`` from its per-(layer, expert)
    planes: ``{ours: bf16}``, or with ``quantize`` ``{ours_q: int8,
    ours_s: f32 [Lm, E, 1, out]}`` quantized plane by plane on
    ``device``."""
    first = _plane(weights, names[0][0], True)
    shape = (len(names), len(names[0]), *first.shape)
    if not quantize:
        out = torch.empty(shape, dtype=dt, device=device)
    else:
        q = torch.empty(shape, dtype=torch.int8, device=device)
        s = torch.empty((*shape[:2], 1, shape[-1]), dtype=torch.float32,
                        device=device)
    for li, row in enumerate(names):
        for e, name in enumerate(row):
            w = (first if li == e == 0 else _plane(weights, name, True))
            w = w.to(dt).to(device)
            if quantize:
                q[li, e], s[li, e] = quantize_int8(w)
            else:
                out[li, e] = w
    if not quantize:
        return {ours: out}
    return {f"{ours}_q": q, f"{ours}_s": s}


def load_from_safetensors_dir(config: ModelConfig, path: str, device="cpu",
                              quantize_experts: bool = False
                              ) -> Dict[str, Any]:
    """Load all ``*.safetensors`` under ``path`` (an HF snapshot) onto
    ``device``; MoE configs may quantize their experts as they load."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    weights = SafetensorsFiles([os.path.join(path, f) for f in files])
    if config.is_moe:
        return load_moe_from_state_dict(config, weights, device=device,
                                        quantize_experts=quantize_experts)
    return load_dense_from_state_dict(config, weights, device=device)


def config_from_hf_dir(path: str, name: str = "hf") -> ModelConfig:
    """Derive a ModelConfig from an HF ``config.json`` (dense or MoE).

    MoE field names follow DeepSeek-V2/V3 (``n_routed_experts``,
    ``num_experts_per_tok``, ``moe_intermediate_size``, ``n_shared_experts``,
    ``first_k_dense_replace``, ``n_group``/``topk_group``,
    ``routed_scaling_factor``, ``scoring_func``); the routed-expert count
    also falls back to Mixtral's ``num_local_experts``.  Qwen2-MoE's *gated*
    shared expert is not supported (its weights are skipped, not mis-added).
    """
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    num_experts = int(hf.get("n_routed_experts")
                      or hf.get("num_local_experts")
                      or hf.get("num_experts") or 0)
    return ModelConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=hf.get("attention_bias", False)
        or hf.get("model_type") == "qwen2",
        qk_norm=hf.get("model_type") == "qwen3",
        max_model_len=min(hf.get("max_position_embeddings", 32000), 32000),
        num_experts=num_experts,
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 0)
                                if num_experts else 0),
        moe_intermediate_size=int(hf.get("moe_intermediate_size", 0)
                                  or (hf["intermediate_size"]
                                      if num_experts else 0)),
        num_shared_experts=int(hf.get("n_shared_experts") or 0),
        first_dense_layers=int(hf.get("first_k_dense_replace") or 0),
        moe_renormalize=bool(hf.get("norm_topk_prob", True)),
        n_group=int(hf.get("n_group") or 0),
        topk_group=int(hf.get("topk_group") or 0),
        routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
        scoring_func=hf.get("scoring_func", "softmax"),
        # MLA (DeepSeek-V2/V3): present iff kv_lora_rank is configured.
        q_lora_rank=int(hf.get("q_lora_rank") or 0),
        kv_lora_rank=int(hf.get("kv_lora_rank") or 0),
        qk_nope_head_dim=int(hf.get("qk_nope_head_dim") or 0),
        qk_rope_head_dim=int(hf.get("qk_rope_head_dim") or 0),
        v_head_dim=int(hf.get("v_head_dim") or 0),
    )
