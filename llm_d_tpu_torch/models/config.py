"""Model configurations and presets (copy of ``llm_d_tpu.models.config``).

One config type covers the dense (Llama/Qwen) and MoE (Mixtral/DeepSeek
-style) families; ``num_experts == 0`` means dense.  The port serves
every preset: dense models, MoE with MLA attention (``deepseek-v3-bench``,
``tiny-mla``) and MoE with GQA attention (``tiny-moe``,
``qwen3-30b-a3b``, ``mixtral-8x22b``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "custom"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: Optional[int] = None          # default hidden/heads
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False            # Qwen2: True
    qk_norm: bool = False                   # Qwen3: True
    max_model_len: int = 32000
    dtype: str = "bfloat16"
    # --- MoE (0 experts = dense) ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0             # DeepSeek shared expert(s)
    first_dense_layers: int = 0             # DeepSeek: first k layers dense
    moe_renormalize: bool = True
    n_group: int = 0                        # DeepSeek group-limited routing (0=off)
    topk_group: int = 0
    routed_scaling_factor: float = 1.0
    # "softmax" (Mixtral/Qwen-MoE) or "sigmoid" (DeepSeek-V3/R1: sigmoid
    # scores + e_score_correction_bias used for selection only).
    scoring_func: str = "softmax"
    # --- MLA (multi-head latent attention; 0 = classic MHA/GQA) ---
    # The serving cache holds one rank-``kv_lora_rank`` latent plus one
    # shared RoPE key per token.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def use_mla(self) -> bool:
        return self.kv_lora_rank > 0

    def __post_init__(self):
        if self.scoring_func not in ("softmax", "sigmoid"):
            raise ValueError(
                f"scoring_func must be 'softmax' or 'sigmoid', "
                f"got {self.scoring_func!r}")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


# ---- Presets (architecture dims from the public model cards) ----

PRESETS = {
    # Tiny configs for tests / CI (CPU-friendly).
    "tiny": ModelConfig(
        name="tiny", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
        max_model_len=512),
    "tiny-moe": ModelConfig(
        name="tiny-moe", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
        max_model_len=512, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=96, num_shared_experts=1, first_dense_layers=1),
    "qwen3-0.6b": ModelConfig(
        name="qwen3-0.6b", vocab_size=151936, hidden_size=1024,
        intermediate_size=3072, num_layers=28, num_heads=16, num_kv_heads=8,
        head_dim=128, rope_theta=1000000.0, qk_norm=True,
        tie_word_embeddings=True, max_model_len=32768),
    "qwen3-32b": ModelConfig(
        name="qwen3-32b", vocab_size=151936, hidden_size=5120,
        intermediate_size=25600, num_layers=64, num_heads=64, num_kv_heads=8,
        head_dim=128, rope_theta=1000000.0, qk_norm=True,
        max_model_len=32768),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        rope_theta=500000.0, max_model_len=32000),
    "llama3-70b": ModelConfig(
        name="llama3-70b", vocab_size=128256, hidden_size=8192,
        intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
        rope_theta=500000.0, max_model_len=32000),
    "llama3-1b": ModelConfig(
        name="llama3-1b", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rope_theta=500000.0, max_model_len=8192),
    "qwen3-30b-a3b": ModelConfig(
        name="qwen3-30b-a3b", vocab_size=151936, hidden_size=2048,
        intermediate_size=6144, num_layers=48, num_heads=32, num_kv_heads=4,
        head_dim=128, rope_theta=1000000.0, qk_norm=True, max_model_len=32768,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768),
    "mixtral-8x22b": ModelConfig(
        name="mixtral-8x22b", vocab_size=32768, hidden_size=6144,
        intermediate_size=16384, num_layers=56, num_heads=48, num_kv_heads=8,
        rope_theta=1000000.0, max_model_len=32000,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16384),
    "deepseek-v3": ModelConfig(
        name="deepseek-v3", vocab_size=129280, hidden_size=7168,
        intermediate_size=18432, num_layers=61, num_heads=128, num_kv_heads=1,
        head_dim=128, rope_theta=10000.0, max_model_len=32000,
        num_experts=256, num_experts_per_tok=8, moe_intermediate_size=2048,
        num_shared_experts=1, first_dense_layers=3, n_group=8, topk_group=4,
        routed_scaling_factor=2.5, scoring_func="sigmoid",
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128),
    # The port's main-path model: DeepSeek-V3's serving structure (MLA
    # latent cache, sigmoid group-limited routing, shared expert, first
    # layer dense, top-8 of 64 routed experts) at a single-card size.
    "deepseek-v3-bench": ModelConfig(
        name="deepseek-v3-bench", vocab_size=32768, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=16, num_kv_heads=1,
        rope_theta=10000.0, max_model_len=8192,
        num_experts=64, num_experts_per_tok=8, moe_intermediate_size=512,
        num_shared_experts=1, first_dense_layers=1, n_group=8, topk_group=4,
        routed_scaling_factor=2.5, scoring_func="sigmoid",
        q_lora_rank=768, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128),
    # Tiny MLA+MoE config for CPU tests.
    "tiny-mla": ModelConfig(
        name="tiny-mla", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=1,
        rope_theta=10000.0, max_model_len=512, num_experts=8,
        num_experts_per_tok=2, moe_intermediate_size=96,
        num_shared_experts=1, first_dense_layers=1,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16),
}


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset '{name}' (have {sorted(PRESETS)})")
    return PRESETS[name]
