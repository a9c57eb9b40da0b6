"""Sharding rules: logical parameter axes -> mesh axes, batch and cache
specs, and the per-device bytes they imply — the JAX package's
``runtime/sharding.py`` on a plain mesh description.

A mesh is described by its axis names and sizes (``Mesh``: ``("data",
"model")`` for ``1x4``, ``("pod", "data", "model")`` for ``2x16x16``).  A
spec is a tuple with one entry per dim of its leaf: ``None``
(replicated), a mesh-axis name, or a tuple of names (the dim split over
their product), as the reference's ``PartitionSpec`` entries are.

Baseline layout (the reference's): every big matrix splits its output dim
over ``model`` (Megatron-style tensor parallelism) and its input/embed dim
over ``data`` (+``pod``) (FSDP/ZeRO-style), experts over ``model``.  A dim
that its axes do not divide falls back to replication, per leaf (whisper's
vocab of 51865).  The port runs only the experts' split so far
(``models.moe.moe_ffn_sharded``); the rest is what the dry run prices.
The reference's other layouts are options here as there: ``fsdp=False``
(the embed dim replicated), ``layout="dp"`` (the batch over ``model``
too, where it divides) and ``force_seq_shard`` (weight-stationary decode:
the cache's sequence over ``data``, the batch replicated).

A serve slot pool *placed* on a device group (``ServeEngine(placements=
...)``) has a mesh of its own, ``pool_mesh``: axes ``("data",
"model")`` and the group's devices; ``pool_specs`` gives its rows'
specs, and ``pool_shards`` how the port lays them out (which shard and
row each slot has): the slots split over ``data`` where it divides them,
each shard's rows on its row of the group, split by heads over ``model``
(``models.tp``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models.params import ParamDef, map_defs


class Mesh(NamedTuple):
    """A device mesh's axis names and sizes, and for a pool's mesh
    (``pool_mesh``) the devices of its group, row-major over the axes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    group: Tuple[torch.device, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> int:
        return math.prod(self.sizes)

    def __str__(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def parse_mesh(text: str) -> Mesh:
    """``"1x4"`` -> (data 1, model 4); ``"2x16x16"`` -> (pod, data, model)."""
    sizes = tuple(int(s) for s in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(sizes))
    if names is None:
        raise ValueError(f"mesh {text!r}: give 2 or 3 sizes, as 1x4")
    return Mesh(names, sizes)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def logical_rules(mesh, fsdp: bool = True) -> Dict[str, object]:
    return {
        "vocab": "model",
        "embed": data_axes(mesh) if fsdp else None,
        "qkv": "model",
        "mlp": "model",
        "experts": "model",
        "layers": None,
    }


def param_specs(cfg: ArchConfig, mesh, fsdp: bool = True):
    """Spec tree of ``lm.model_defs(cfg)`` with the per-leaf divisibility
    fallback; without ``fsdp`` the embed dim is replicated."""
    from repro_torch.models.lm import model_defs
    rules = logical_rules(mesh, fsdp)

    def spec(d: ParamDef):
        parts = []
        for dim, ax in zip(d.shape, d.axes):
            target = rules.get(ax) if ax is not None else None
            if target is None:
                parts.append(None)
            elif dim % axis_size(mesh, target) == 0:
                parts.append(target)
            else:
                parts.append(None)           # non-divisible -> replicate
        return tuple(parts)

    return map_defs(spec, model_defs(cfg))


def _batch_axes(shape: ShapeCfg, mesh, layout: str) -> Tuple[str, ...]:
    """The axes a batch splits over: the data axes, and under ``"dp"``
    ``model`` too where the global batch divides by them all."""
    da = data_axes(mesh)
    if layout == "dp":
        full = da + ("model",)
        if shape.global_batch % axis_size(mesh, full) == 0:
            return full
    return da


def batch_specs(cfg: ArchConfig, shape: ShapeCfg, mesh, layout: str = "tp"):
    da = _batch_axes(shape, mesh, layout)
    dp = axis_size(mesh, da)
    seq_sharded = shape.global_batch < dp        # long_500k: batch of 1
    tok = (None, da) if seq_sharded else (da, None)
    out = {"tokens": tok}
    rows = (None, None, None) if seq_sharded else (da, None, None)
    if cfg.enc_layers:
        out["frames"] = rows
    if cfg.mrope:
        out["positions3"] = rows
    return out


def _model_dim_part(mesh, *dims) -> Optional[int]:
    """The first dim (by index into ``dims``) divisible by |model|."""
    m = axis_size(mesh, "model")
    for i, d in enumerate(dims):
        if d % m == 0:
            return i
    return None


def act_spec_for(cfg: ArchConfig, shape: ShapeCfg, mesh,
                 layout: str = "tp"):
    """Spec of ``[B, S, D]`` activations under ``layout``: the batch over
    the data axes (and ``model`` under ``"dp"`` where it divides), or the
    sequence where the batch is smaller than the data axes."""
    da = data_axes(mesh)
    if layout == "dp":
        full = da + ("model",)
        if shape.global_batch % axis_size(mesh, full) == 0:
            return (full, None, None)
    if shape.global_batch < axis_size(mesh, da):
        return (None, da, None)
    return (da, None, None)


KV_TYPES = ("attn", "local", "moe", "shared_attn", "dec")


def cache_specs(cfg: ArchConfig, mesh, shape: ShapeCfg, cache_tree,
                force_seq_shard: bool = False):
    """Spec tree matching ``lm.init_cache``'s output.  decode_*: batch over
    data; long_500k (batch < dp): KV sequence over data, SSM state over
    model.  ``force_seq_shard``: weight-stationary decode, the KV sequence
    over data and the batch replicated at any batch."""
    da = data_axes(mesh)
    dp = axis_size(mesh, da)
    seq_sharded = shape.global_batch < dp or force_seq_shard
    batch = None if seq_sharded else da

    def leaf_spec(btype, x):
        shp = tuple(x.shape)
        nd = len(shp)
        if btype in KV_TYPES and nd == 5:     # [n, B, S, KH, hd]
            i = _model_dim_part(mesh, shp[3], shp[4])
            kv = [None, None]
            if i is not None:
                kv[i] = "model"
            seq = da if seq_sharded else None
            return (None, batch, seq, *kv)
        if nd >= 4:                           # SSM states: [n,B,H,...] etc.
            i = _model_dim_part(mesh, *shp[2:])
            tail = [None] * (nd - 2)
            if i is not None:
                tail[i] = "model"
            return (None, batch, *tail)
        if nd == 3:                           # x_tm/x_cm [n, B, D]
            return (None, batch, None)
        return (None,) * nd

    caches = {t: {k: leaf_spec(t, v) for k, v in leaves.items()}
              for t, leaves in cache_tree["caches"].items()}
    return {"caches": caches, "pos": ()}


def as_device(dev) -> torch.device:
    """``dev`` (a string or a ``torch.device``) as a device with its index:
    ``"cuda"`` names the current card, so that two names of one card
    compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pool_mesh(devices, tp: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over an explicit device group (a
    device, its name, or a sequence of them): the unit a serve slot pool
    is placed on.  ``tp`` is the tensor-parallel degree within the pool:
    ``model`` gets ``tp`` devices and ``data`` the rest.  The default
    ``tp=1`` keeps every product's reduction on one device, which keeps
    the engine's greedy outputs those of ``generate_static``.  A group may
    name one device several times, or distinct devices of one type."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    group = tuple(as_device(d) for d in devices)
    if not group:
        raise ValueError("pool_mesh needs at least one device")
    if len({d.type for d in group}) > 1:
        raise ValueError(f"a pool over {[str(d) for d in group]}: a CPU and "
                         "a CUDA device never share a pool")
    tp = max(int(tp), 1)
    if len(group) % tp:
        raise ValueError(f"{len(group)} devices do not divide by tp={tp}")
    return Mesh(("data", "model"), (len(group) // tp, tp), group)


def _slot_dim(path: Tuple[str, ...]) -> int:
    """The slot dim of a pool leaf: 1 in the cache and draft rows
    ``[n, slots, ...]``, 0 in ``ng``, ``ctx`` and ``pos``."""
    return 1 if path[0] in ("caches", "draft") else 0


def pool_specs(mesh, pool_tree):
    """Spec tree of a slot pool's rows (``SlotPool.state()``: ``caches``
    and ``draft`` leaves ``[n, slots, ...]``, ``ng``, ``ctx`` and ``pos``
    ``[slots, ...]``): the slot dim over ``data`` where its size divides
    (slots are independent, so the split touches no reduction) and, at
    ``model`` > 1, the first dim past the slot's successor that ``model``
    divides (the reference's rule on its ``[slots, n, 1, ...]`` leaves,
    whose batch-of-one dim no axis divides).  Other leaves replicate."""
    da = data_axes(mesh)
    dp = axis_size(mesh, da)

    def leaf(path, x):
        nd, s = len(x.shape), _slot_dim(path)
        spec = [None] * nd
        if da and x.shape[s] % dp == 0:
            spec[s] = da
        if nd >= 3 and axis_size(mesh, "model") > 1:
            i = _model_dim_part(mesh, *x.shape[2:])
            if i is not None:
                spec[2 + i] = "model"
        return tuple(spec)

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return leaf(path, node)

    return walk((), pool_tree)


def opt_state_specs(param_spec_tree):
    from repro_torch.optim.adamw import OptState
    return OptState(param_spec_tree, param_spec_tree, ())


def shard_numel(shape: Sequence[int], spec, mesh) -> int:
    """Elements of one device's shard of a leaf of ``shape`` under
    ``spec`` (a replicated dim is whole on every device)."""
    n = 1
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        n *= dim // axis_size(mesh, ax) if ax else dim
    return n


def bytes_per_device(tree, spec_tree, mesh) -> int:
    """Bytes one device holds of a nested dict of tensors (``meta`` ones
    too) under the matching spec tree."""
    if isinstance(tree, dict):
        return sum(bytes_per_device(tree[k], spec_tree[k], mesh)
                   for k in tree)
    return shard_numel(tree.shape, spec_tree, mesh) * tree.element_size()


def pool_shards(mesh, slots: int):
    """How a pool of ``slots`` slots lies on its mesh: ``[(lo, hi,
    devices)]``, one entry a data shard holding slots ``[lo, hi)`` on the
    ``model`` devices of its row of the group (row-major over (data,
    model)).  The slot dim splits over ``data`` where it divides, as
    ``pool_specs`` says; where it does not, the reference replicates the
    rows over ``data`` and the port keeps them whole on the group's first
    row, which gives the same results."""
    d, t = mesh.shape["data"], mesh.shape["model"]
    rows = [tuple(mesh.group[i * t:(i + 1) * t]) for i in range(d)]
    if d > 1 and slots % d == 0:
        n = slots // d
        return [(i * n, (i + 1) * n, rows[i]) for i in range(d)]
    return [(0, slots, rows[0])]

