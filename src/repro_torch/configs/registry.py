"""Architecture registry: ``--arch <id>`` resolution for the configs the
port serves so far."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, reduced

_MODULES = {
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "paper-moe-100m": "repro_torch.configs.paper_moe_100m",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduced(get_arch(name[: -len("-smoke")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
