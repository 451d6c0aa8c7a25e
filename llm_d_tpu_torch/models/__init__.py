from llm_d_tpu_torch.models.config import ModelConfig, PRESETS, get_config


def get_model(config: ModelConfig):
    """Model module for a config.  The port serves the MLA + MoE family
    (``models.moe``: init_params / forward / compute_logits /
    kv_cache_layout); other families raise until they are ported."""
    if config.is_moe and config.use_mla:
        from llm_d_tpu_torch.models import moe
        return moe
    raise NotImplementedError(
        f"model {config.name!r}: the port serves MLA + MoE models only")


__all__ = ["ModelConfig", "PRESETS", "get_config", "get_model"]
