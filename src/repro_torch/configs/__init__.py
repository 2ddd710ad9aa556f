from repro_torch.configs.base import (SHAPES, CommConfig, ModelConfig,
                                      MoEConfig, RunConfig, ServeConfig,
                                      ShapeConfig, TenantConfig,
                                      cell_skip_reason, cells_for, describe,
                                      reduced)
from repro_torch.configs.registry import (ARCH_IDS, all_cells, get_config,
                                          get_shape)

__all__ = ["ARCH_IDS", "CommConfig", "ModelConfig", "MoEConfig",
           "RunConfig", "SHAPES", "ServeConfig", "ShapeConfig",
           "TenantConfig", "all_cells", "cell_skip_reason", "cells_for",
           "describe", "get_config", "get_shape", "reduced"]
