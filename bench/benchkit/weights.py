"""Random weights from the seed, drawn on the device in the type they are
served in (bfloat16), in one draw.

The tree's names and shapes are the reference family's ``layout``: the
same tensors go to the program (``BatchedServer``) and, after the window,
to the reference.  Laws: ``normal`` is N(0, 1/fan_in) with fan_in the
last-but-one dim (the contraction dim of ``x @ w``), ``embed`` N(0, 1),
``gain`` 1 + N(0, 0.1^2), so that a norm's gain is not the identity.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _leaves(layout, prefix=()):
    for k in sorted(layout):
        v = layout[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def draw(layout: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The tree of ``layout`` filled from ``torch.Generator(seed)`` on
    ``device``: one normal draw into one buffer, each leaf a view of it,
    scaled in place by its law."""
    leaves = list(_leaves(layout))
    total = sum(math.prod(shape) for _, (shape, _) in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree: Dict = {}
    off = 0
    for path, (shape, law) in leaves:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if law == "normal":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif law == "gain":
            t.mul_(0.1).add_(1.0)
        elif law != "embed":
            raise ValueError(f"unknown law {law!r}")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def shapes(tree, prefix: Tuple = ()) -> Dict[Tuple, Tuple]:
    """Every leaf's path and shape (for holding the layout against the
    program's own parameter tree)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out
