"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside a plain
torch version of the same function.  ``build`` compiles the sources with
``nvcc`` into shared libraries loaded through ``ctypes``; ``LAUNCHES``
counts each wrapper's kernel launches."""
from typing import Dict

# One count per kernel wrapper, raised only where the wrapper launches its
# kernel (never for the plain torch version), so a run can show that its
# main path went through the kernels.
LAUNCHES = {"moe_gating": 0, "moe_dispatch": 0, "moe_combine": 0,
            "rwkv6_scan": 0, "mamba2_ssd": 0, "flash_fwd": 0, "flash_bwd": 0}


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
