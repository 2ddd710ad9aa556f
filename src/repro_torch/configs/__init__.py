from repro_torch.configs.base import (CommConfig, ModelConfig, ServeConfig,
                                      reduced)
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "CommConfig", "ModelConfig", "ServeConfig",
           "get_config", "reduced"]
