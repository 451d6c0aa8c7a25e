from llm_d_tpu_torch.models.config import ModelConfig, PRESETS, get_config


def get_model(config: ModelConfig):
    """Model module for a config: ``models.moe`` for MLA + MoE configs,
    ``models.llama`` for dense ones (each exposes init_params / forward /
    compute_logits / kv_cache_layout).  MoE models with GQA attention
    raise until they are ported."""
    if not config.is_moe:
        from llm_d_tpu_torch.models import llama
        return llama
    if config.use_mla:
        from llm_d_tpu_torch.models import moe
        return moe
    raise NotImplementedError(
        f"model {config.name!r}: GQA attention in MoE models is not ported "
        "yet; the port serves dense models and MLA + MoE models")


__all__ = ["ModelConfig", "PRESETS", "get_config", "get_model"]
