"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside a plain
torch version of the same function.  ``build`` compiles the sources with
``nvcc`` into shared libraries loaded through ``ctypes``; ``LAUNCHES``
counts each wrapper's kernel launches; ``resolve`` and ``records`` are the
dispatchers' routing rules."""
from typing import Dict

import torch

# One count per kernel wrapper, raised only where the wrapper launches its
# kernel (never for the plain torch version), so a run can show that its
# main path went through the kernels.
LAUNCHES = {"moe_gating": 0, "moe_dispatch": 0, "moe_combine": 0,
            "rwkv6_scan": 0, "mamba2_ssd": 0, "flash_fwd": 0, "flash_bwd": 0,
            "rwkv6_scan_bwd": 0, "mamba2_ssd_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The wrapper calls counted since the snapshot ``before``."""
    return {k: LAUNCHES[k] - before[k] for k in LAUNCHES}


def credit_launches(delta: Dict[str, int]) -> None:
    """Count one more run of work whose wrapper calls were ``delta``: a CUDA
    graph's replay launches the kernels that its capture recorded, and no
    wrapper runs to count them."""
    for k, n in delta.items():
        LAUNCHES[k] += n


def resolve(impl: str, x) -> str:
    """``auto`` -> ``cuda`` for a CUDA tensor, ``torch`` (the plain version)
    for a CPU tensor.  ``cuda`` on a CPU tensor raises in the wrapper."""
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def records(*xs) -> bool:
    """Whether autograd would record an op on ``xs`` (None entries are
    skipped): where a dispatcher routes a CUDA tensor through a kernel's
    ``autograd.Function`` rather than its forward wrapper alone."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)
