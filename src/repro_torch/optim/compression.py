"""Gradient compression: int8 block-quantized gradient all-reduce with
error feedback, the JAX package's ``optim/compression.py`` in torch.

Each leaf is quantized with one scale (``max|g| / 127``), the int8 codes
are summed in int32 across the ranks of a process group (8x fewer bytes
on the wire than f32), then dequantized; the quantization residual is
carried to the next step (error feedback keeps convergence).  Both
``torch.round`` and ``jnp.round`` round half to even, so the codes equal
the reference's.  No training path calls it, as in the reference.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def quantize(g, scale=None):
    """g -> (int8 codes, the scale: max|g| in g's dtype, or ``scale``, at
    least 1e-12), computed in g's dtype as the reference does."""
    a = g.abs().max() if scale is None else torch.as_tensor(scale)
    a = torch.clamp(a, min=1e-12)
    q = torch.clamp(torch.round(g / a * 127.0), -127, 127)
    return q.to(torch.int8), a


def dequantize(q, a):
    """int8 codes and their scale -> f32 values."""
    return q.float() * (a / 127.0)


def compress_tree(grads, residual) -> Tuple[Any, Any, Any]:
    """Returns (quantized tree, scales tree, new residual tree)."""
    g = tree_map(lambda g, r: g.float() + r, grads, residual)
    scales = tree_map(lambda x: quantize(x)[1], g)
    codes = tree_map(lambda x, a: quantize(x, a)[0], g, scales)
    return codes, scales, tree_map(lambda x, q, a: x - dequantize(q, a), g,
                                   codes, scales)


def quantized_psum(grads, residual, group=None):
    """Error-feedback int8 all-reduce over the ranks of ``group`` (the
    default process group when None; one rank when ``torch.distributed``
    is not initialised).  Every rank encodes its leaves with one shared
    scale a leaf (a MAX all-reduce of the local scales), the codes are
    summed in int32 (no overflow for at most 2^23 ranks) in one SUM
    all-reduce, and each sum is dequantized with that scale.  Returns (the
    summed tree in f32, this rank's new residual tree)."""
    import torch.distributed as dist
    spread = dist.is_available() and dist.is_initialized()
    leaves = [g.float() + r for g, r in zip(tree_leaves(grads),
                                            tree_leaves(residual))]
    scales = torch.stack([g.abs().max() for g in leaves])
    if spread:
        dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
    # encoded with the scale clamped at 1e-12, decoded with it as it is
    codes = [quantize(g, a)[0] for g, a in zip(leaves, scales)]
    res = [g - dequantize(q, a) for g, q, a in zip(leaves, codes, scales)]
    summed = torch.cat([q.reshape(-1).to(torch.int32) for q in codes])
    if spread:
        dist.all_reduce(summed, group=group)
    out, at = [], 0
    for q, a in zip(codes, scales):
        n = q.numel()
        out.append(dequantize(summed[at:at + n].reshape(q.shape), a))
        at += n
    return tree_unflatten(grads, out), tree_unflatten(grads, res)
