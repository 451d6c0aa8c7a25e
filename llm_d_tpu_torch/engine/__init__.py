from llm_d_tpu_torch.engine.engine import EngineConfig, EngineCore

__all__ = ["EngineConfig", "EngineCore"]
