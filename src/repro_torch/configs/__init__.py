from repro_torch.configs.base import (SHAPES, ArchConfig, MoECfg, SSMCfg,
                                      ShapeCfg, reduced)
from repro_torch.configs.registry import (ARCH_IDS, all_cells,
                                          cell_applicable, get_arch,
                                          get_shape)

__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "ShapeCfg", "SHAPES", "reduced",
           "get_arch", "get_shape", "ARCH_IDS", "all_cells",
           "cell_applicable"]
