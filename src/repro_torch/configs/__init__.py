from repro_torch.configs.base import (CommConfig, ModelConfig, RunConfig,
                                      ServeConfig, ShapeConfig, TenantConfig,
                                      reduced)
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "CommConfig", "ModelConfig", "RunConfig",
           "ServeConfig", "ShapeConfig", "TenantConfig", "get_config",
           "reduced"]
