"""Port parity: the checkpoint loader (``models/loader.py``) against the
JAX package's.

* Each test writes its own HuggingFace-named checkpoints with
  ``safetensors.torch.save_file`` from a seed (nothing is downloaded):
  dense ``tiny``, a tied dense model with attention biases and q/k norms,
  ``tiny-moe`` with Qwen's ``shared_expert`` naming (in two shards),
  ``tiny-mla`` with DeepSeek's naming, two FP8 tensors with their
  ``_scale_inv`` (one with a partial 128 x 128 block) and
  ``e_score_correction_bias``, ``tiny-mla`` without a query low-rank path,
  and a MoE with no dense layer.  ``load_from_safetensors_dir`` of each
  package must give the same tree, bf16 bits equal; the port's
  ``quantize_experts`` load equals ``quantize_moe_experts`` of its bf16
  tree.
* ``config_from_hf_dir`` gives equal fields on DeepSeek, Qwen3-MoE,
  Mixtral and dense ``config.json`` files the test writes.
* The port's own safetensors reader equals ``safetensors.safe_open`` on
  every dtype it serves.
* The ``tiny-moe`` checkpoint loaded by each package serves the same
  greedy tokens (int8 experts).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.models import loader as JL
from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models import get_model
from llm_d_tpu_torch.models import loader as TL
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.ops.quant import quantize_moe_experts
from llm_d_tpu_torch.ops.sampling import SamplingParams

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

_MOE0 = dict(first_dense_layers=0, num_shared_experts=0, head_dim=32,
             qk_norm=True)
CHECKPOINTS = {
    # name: (preset, config overrides, shared-expert prefix, FP8 names,
    #        e_score_correction_bias, shards)
    "tiny": ("tiny", {}, None, (), False, 1),
    "tiny-tied-bias": ("tiny", dict(tie_word_embeddings=True,
                                    attention_bias=True, qk_norm=True),
                       None, (), False, 1),
    "tiny-moe": ("tiny-moe", {}, "mlp.shared_expert", (), False, 2),
    "tiny-mla": ("tiny-mla", dict(scoring_func="sigmoid"),
                 "mlp.shared_experts",
                 ("model.embed_tokens.weight",
                  "model.layers.1.self_attn.kv_a_proj_with_mqa.weight"),
                 True, 1),
    "tiny-mla-no-q-lora": ("tiny-mla", dict(q_lora_rank=0),
                           "mlp.shared_experts", (), False, 1),
    "tiny-moe-no-dense": ("tiny-moe", _MOE0, None, (), False, 1),
}


def _configs(name):
    preset, over = CHECKPOINTS[name][:2]
    return (dataclasses.replace(jget_config(preset), **over),
            dataclasses.replace(tget_config(preset), **over))


def _hf_names(c):
    """(HF name, our group, our key, layer, transpose) of every tensor a
    checkpoint of ``c`` holds, in the JAX loader's maps."""
    out = [("model.embed_tokens.weight", None, "embed", None, False),
           ("model.norm.weight", None, "final_norm", None, False)]
    if not c.tie_word_embeddings:
        out.append(("lm_head.weight", None, "lm_head", None, True))
    if not c.is_moe:
        for li in range(c.num_layers):
            for ours, hf in JL._LAYER_MAP.items():
                if ours.endswith("_bias") and not c.attention_bias:
                    continue
                if ours in ("q_norm", "k_norm") and not c.qk_norm:
                    continue
                out.append((f"model.layers.{li}.{hf}", "layers", ours, li,
                            ours in JL._TRANSPOSE))
        return out
    if c.use_mla:
        attn = dict(JL._MLA_MAP)
        if c.q_lora_rank == 0:
            for k in ("q_a_proj", "q_a_norm", "q_b_proj"):
                attn.pop(k)
            attn["q_proj"] = "self_attn.q_proj.weight"
        trans = JL._MLA_TRANSPOSE | {"q_proj"}
    else:
        attn = {k: JL._LAYER_MAP[k] for k in JL._ATTN_KEYS
                if not (k.endswith("_bias") and not c.attention_bias)
                and not (k in ("q_norm", "k_norm") and not c.qk_norm)}
        trans = JL._TRANSPOSE
    for li in range(c.num_layers):
        p = f"model.layers.{li}."
        group = "dense_layers" if li < c.first_dense_layers else "moe_layers"
        for ours, hf in attn.items():
            out.append((p + hf, group, ours, li, ours in trans))
        if group == "dense_layers":
            for ours in JL._MLP_KEYS:
                out.append((p + JL._LAYER_MAP[ours], group, ours, li, True))
            continue
        out.append((p + "mlp.gate.weight", group, "router", li, True))
        for e in range(c.num_experts):
            for ours, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
                out.append((f"{p}mlp.experts.{e}.{hf}.weight", group,
                            (ours, e), li, True))
    return out


def _write_checkpoint(path, name, seed):
    """A checkpoint of ``name`` in HF layout, values from ``seed``: the
    shapes of the port's random init, transposed to HF's ``[out, in]``."""
    _, _, shared, fp8, e_bias, shards = CHECKPOINTS[name]
    _, c = _configs(name)
    tree = get_model(c).init_params(c, torch.Generator().manual_seed(0),
                                    "cpu")
    rng = np.random.default_rng(seed)

    def value(shape, dtype=torch.bfloat16):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.2).astype(np.float32)).to(dtype)

    sd = {}
    for hf, group, key, li, transpose in _hf_names(c):
        if group is None:
            shape = tree[key].shape
        else:
            Ld = c.first_dense_layers if group == "moe_layers" else 0
            e = None
            if isinstance(key, tuple):
                key, e = key
            plane = tree[group][key][li - Ld]
            shape = (plane if e is None else plane[e]).shape
        if transpose:
            shape = shape[::-1]
        sd[hf] = value(tuple(shape))
    Ld = c.first_dense_layers
    for li in range(Ld, c.num_layers if c.is_moe else 0):
        p = f"model.layers.{li}."
        if shared is not None:
            Ish = c.moe_intermediate_size * c.num_shared_experts
            for hf, shape in (("gate_proj", (Ish, c.hidden_size)),
                              ("up_proj", (Ish, c.hidden_size)),
                              ("down_proj", (c.hidden_size, Ish))):
                sd[f"{p}{shared}.{hf}.weight"] = value(shape)
        if e_bias:
            sd[p + "mlp.gate.e_score_correction_bias"] = value(
                (c.num_experts,), torch.float32)
    for n in fp8:
        w = sd[n].float()
        sd[n] = w.to(torch.float8_e4m3fn)
        sd[n + "_scale_inv"] = value(
            (-(-w.shape[0] // 128), -(-w.shape[1] // 128)),
            torch.float32).abs() + 0.5
    names = sorted(sd)
    for i in range(shards):
        save_file({n: sd[n] for n in names[i::shards]},
                  str(path / f"model-{i:05d}.safetensors"),
                  metadata={"format": "pt"})
    return c


def _bits(x):
    """(dtype name, values as comparable integers: bf16 as its bits) of a
    tensor or an array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[-1]
        return name, (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                      else x.numpy())
    a = np.asarray(x)
    return a.dtype.name, (a.view(np.int16) if a.dtype.name == "bfloat16"
                          else a)


def _assert_trees_bit_equal(got, want):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        (dg, g), (dw, w) = _bits(flat_g[path]), _bits(w)
        assert dg == dw and g.shape == w.shape, (path, dg, dw)
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_loaded_tree_is_bit_identical_to_jax(name, tmp_path):
    jc, tc = _configs(name)
    _write_checkpoint(tmp_path, name, seed=len(name))
    want = JL.load_from_safetensors_dir(jc, str(tmp_path))
    got = TL.load_from_safetensors_dir(tc, str(tmp_path), device="cpu")
    _assert_trees_bit_equal(got, want)
    # The loaded tree is the one the port's model builds.
    shapes = jax.tree.map(lambda t: tuple(t.shape), get_model(tc).init_params(
        tc, torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
    if tc.is_moe:
        q = TL.load_from_safetensors_dir(tc, str(tmp_path), device="cpu",
                                         quantize_experts=True)
        _assert_trees_bit_equal(q, quantize_moe_experts(got))


def test_fetch_weight_dequantizes_fp8_blocks_as_jax():
    """FP8 e4m3 and e5m2 weights with 128 x 128 block scales, both dims
    with a partial last block, from torch tensors and numpy arrays."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((300, 140)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 2, (3, 2)).astype(np.float32))
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        sd = {"w": w.to(dt), "w_scale_inv": s}
        got = TL.fetch_weight(sd, "w")
        np.testing.assert_array_equal(got.numpy(), JL.fetch_weight(sd, "w"))
    bf = {"b": w.to(torch.bfloat16).view(torch.uint16).numpy()}
    np.testing.assert_array_equal(TL.fetch_weight(bf, "b").numpy(),
                                  JL.fetch_weight(bf, "b"))


def _write_config(path, **hf):
    path.mkdir()
    (path / "config.json").write_text(json.dumps(hf))
    return str(path)


def test_config_from_hf_dir_equals_jax(tmp_path):
    base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=2)
    files = {
        "deepseek": dict(base, n_routed_experts=16, num_experts_per_tok=4,
                         moe_intermediate_size=32, n_shared_experts=1,
                         first_k_dense_replace=1, n_group=4, topk_group=2,
                         routed_scaling_factor=2.5, scoring_func="sigmoid",
                         norm_topk_prob=True, q_lora_rank=32,
                         kv_lora_rank=32, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16),
        "qwen3_moe": dict(base, model_type="qwen3_moe", num_experts=128,
                          num_experts_per_tok=8, moe_intermediate_size=768,
                          head_dim=128, rope_theta=1000000.0,
                          norm_topk_prob=True,
                          max_position_embeddings=40960),
        "mixtral": dict(base, model_type="mixtral", num_local_experts=8,
                        num_experts_per_tok=2, rope_theta=1000000.0,
                        max_position_embeddings=65536),
        "qwen2": dict(base, model_type="qwen2", tie_word_embeddings=True,
                      rms_norm_eps=1e-6),
        "qwen3": dict(base, model_type="qwen3", head_dim=32),
    }
    for name, hf in files.items():
        d = _write_config(tmp_path / name, **hf)
        got = dataclasses.asdict(TL.config_from_hf_dir(d, name=name))
        want = dataclasses.asdict(JL.config_from_hf_dir(d, name=name))
        assert got == want, name


def test_reader_equals_safetensors_package(tmp_path):
    """Every dtype the reader serves, a scalar, an empty tensor and
    metadata, against ``safe_open``."""
    g = torch.Generator().manual_seed(5)
    f = torch.randn((3, 5, 7), generator=g)
    tensors = {
        "bf16": f.to(torch.bfloat16), "f16": f.to(torch.float16), "f32": f,
        "f64": f.double(), "f8_e4m3": f.to(torch.float8_e4m3fn),
        "f8_e5m2": f.to(torch.float8_e5m2),
        "i8": torch.randint(-128, 127, (9, 4), dtype=torch.int8,
                            generator=g),
        "u8": torch.randint(0, 255, (13,), dtype=torch.uint8, generator=g),
        "i16": torch.randint(-999, 999, (6,), dtype=torch.int16,
                             generator=g),
        "i32": torch.randint(-2**31, 2**31 - 1, (4, 3), dtype=torch.int32,
                             generator=g),
        "i64": torch.randint(-2**40, 2**40, (5,), dtype=torch.int64,
                             generator=g),
        "bool": torch.rand((7,), generator=g) > 0.5,
        "scalar": torch.tensor(2.5), "empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    mine = TL.SafetensorsFiles([path])
    assert sorted(mine) == sorted(tensors) and len(mine) == len(tensors)
    with safe_open(path, framework="pt") as ref:
        for name in tensors:
            want, got = ref.get_tensor(name), mine[name]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name


def test_loaded_tiny_moe_serves_the_jax_tokens(tmp_path):
    """The ``tiny-moe`` checkpoint, loaded by each package and served with
    int8 experts (the port quantizing as it loads, the JAX engine after):
    three requests, eight greedy tokens each, token for token."""
    jc, tc = _configs("tiny-moe")
    _write_checkpoint(tmp_path, "tiny-moe", seed=11)
    kw = dict(model="tiny-moe", block_size=16, num_blocks=32,
              max_num_seqs=4, max_num_batched_tokens=64,
              quantization="int8", enable_prefix_caching=False)
    jeng = JEngineCore(JEngineConfig(**kw),
                       params=JL.load_from_safetensors_dir(jc, str(tmp_path)))
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=TL.load_from_safetensors_dir(
                          tc, str(tmp_path), device="cpu",
                          quantize_experts=True))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (6, 17, 30)]
    want = jeng.generate([JRequest(f"r{i}", p, JSamplingParams(
        temperature=0.0, max_tokens=8, ignore_eos=True))
        for i, p in enumerate(prompts)])
    got = teng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=8, ignore_eos=True))
        for i, p in enumerate(prompts)])
    assert got == want
