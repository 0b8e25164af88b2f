from repro_torch.configs.base import ARCH_IDS, ModelConfig, all_configs, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, input_specs

__all__ = ["ModelConfig", "get_config", "all_configs", "ARCH_IDS", "INPUT_SHAPES",
           "InputShape", "input_specs"]
