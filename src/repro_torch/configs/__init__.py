from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg, reduced
from repro_torch.configs.registry import ARCH_IDS, get_arch

__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "reduced", "get_arch",
           "ARCH_IDS"]
