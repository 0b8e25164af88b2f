from repro_torch.configs.base import ARCH_IDS, ModelConfig, all_configs, get_config

__all__ = ["ModelConfig", "get_config", "all_configs", "ARCH_IDS"]
