from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config

__all__ = ["ModelConfig", "get_config", "ARCH_IDS"]
