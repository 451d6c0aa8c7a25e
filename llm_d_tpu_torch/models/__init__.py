from llm_d_tpu_torch.models.config import ModelConfig, PRESETS, get_config


def get_model(config: ModelConfig):
    """Model module for a config: ``models.moe`` for MoE configs
    (num_experts > 0; MLA or GQA attention), ``models.llama`` for dense
    ones (each exposes init_params / forward / compute_logits /
    kv_cache_layout)."""
    if config.is_moe:
        from llm_d_tpu_torch.models import moe
        return moe
    from llm_d_tpu_torch.models import llama
    return llama


__all__ = ["ModelConfig", "PRESETS", "get_config", "get_model"]
