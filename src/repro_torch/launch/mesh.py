"""The card's constants and the device mesh.

The constants are NVIDIA's H100 SXM datasheet figures (dense rates, no
sparsity, at the card's 700 W limit): the roofline (``analysis/roofline``)
and the dry run (``launch/dryrun``) divide by them.  ``make_mesh`` and
``make_production_mesh`` are functions, not module-level meshes: importing
this module touches no device and starts no process group.

The production mesh has an H100 node's shape: 8 cards a node, joined all
to all by NVLink, along ``model`` (the tensor- and expert-parallel axis,
whose collectives are the most frequent), and the nodes along ``data``
(and two pods along ``pod``); ``production_mesh`` is its shape alone, which
the dry run prices (``--mesh production``, ``production2``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


# cards a node (NVLink, all to all) and nodes a pod of the production mesh
NODE_CARDS = 8
POD_NODES = 32


def production_shape(multi_pod: bool = False, nodes: int = POD_NODES,
                     per_node: int = NODE_CARDS
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's sizes and axis names: ``("data", "model")``
    of ``(nodes, per_node)``, or with ``multi_pod`` ``("pod", "data",
    "model")`` of ``(2, nodes, per_node)``."""
    if multi_pod:
        return (2, nodes, per_node), ("pod", "data", "model")
    return (nodes, per_node), ("data", "model")


def production_mesh(multi_pod: bool = False, nodes: int = POD_NODES,
                    per_node: int = NODE_CARDS):
    """The production mesh's shape with no devices
    (``runtime.sharding.Mesh``): what the dry run prices."""
    from repro_torch.runtime.sharding import Mesh
    sizes, names = production_shape(multi_pod, nodes, per_node)
    return Mesh(names, sizes)


def make_production_mesh(*, multi_pod: bool = False, nodes: int = POD_NODES,
                         per_node: int = NODE_CARDS,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh``: ``production_shape``'s over the
    ranks of the default process group, which the caller has started with
    ``nodes * per_node`` ranks (twice that with ``multi_pod``), rank
    ``r`` the ``r % per_node``-th card of node ``r // per_node``."""
    sizes, names = production_shape(multi_pod, nodes, per_node)
    return make_mesh(sizes, names, device_type)
