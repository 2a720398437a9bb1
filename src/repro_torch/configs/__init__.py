"""repro_torch.configs — model configs, dry-run shapes and the architecture
registry."""
from repro_torch.configs.base import (SHAPES, MLAConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig,
                                      cell_is_runnable, get_config,
                                      list_archs, register)
from repro_torch.configs.tiny import tiny_config

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "cell_is_runnable", "get_config",
           "list_archs", "register", "tiny_config"]
