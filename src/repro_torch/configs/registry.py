"""Architecture registry: ``--arch <id>`` resolution for the reference's
eleven configs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCfg, reduced

# the reference's ten architectures, the dry run's cells (``all_cells``)
_CELL_MODULES = {
    "whisper-base": "repro_torch.configs.whisper_base",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}
_MODULES = {**_CELL_MODULES,
            "paper-moe-100m": "repro_torch.configs.paper_moe_100m"}

ARCH_IDS = tuple(_MODULES)
CELL_ARCH_IDS = tuple(_CELL_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduced(get_arch(name[: -len("-smoke")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeCfg:
    return SHAPES[name]


def cell_applicable(arch: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Is this (arch x shape) dry-run cell runnable?  The reference's rule:
    a 512k-token decode only for a sub-quadratic arch."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("pure full-attention arch: 512k dense KV cache per "
                       "layer is the non-sub-quadratic case")
    return True, ""


def all_cells():
    """Yield ``(arch, shape, applicable, reason)`` for the reference's 40
    cells: its ten architectures x the four shapes."""
    for a in CELL_ARCH_IDS:
        arch = get_arch(a)
        for s in SHAPES:
            ok, why = cell_applicable(arch, SHAPES[s])
            yield a, s, ok, why
