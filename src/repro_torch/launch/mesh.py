"""The card's constants and the device mesh.

The constants are NVIDIA's H100 SXM datasheet figures (dense rates, no
sparsity, at the card's 700 W limit): the roofline (``analysis/roofline``)
and the dry run (``launch/dryrun``) divide by them.  ``make_mesh`` is a
function, not a module-level mesh: importing this module touches no
device and starts no process group.
"""
from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM datasheet: bf16 tensor-core peak (dense), HBM3 bandwidth
# and capacity, NVLink bandwidth per GPU each way (900 GB/s in all)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card
HBM_BW = 3.35e12                # bytes/s per card
HBM_BYTES = 80e9                # bytes per card
NVLINK_BW = 4.5e11               # bytes/s per card, each way (450 GB/s)


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the ranks of
    the default process group, which the caller has already initialised
    (``torch.distributed.init_process_group`` with its address, world size
    and rank)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))
