"""repro_torch.configs — model configs and the architecture registry."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig, get_config, list_archs,
                                      register)
from repro_torch.configs.tiny import tiny_config

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "get_config",
           "list_archs", "register", "tiny_config"]
