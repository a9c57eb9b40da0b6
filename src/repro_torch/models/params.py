"""Declarative parameter system.

A model is declared as a nested dict of ``ParamDef``s (shape + logical axes +
init law), exactly as in the JAX package, so the port's parameter trees have
the same keys and shapes.  ``init_params`` draws them with a
``torch.Generator``; the numbers differ from the JAX init for the same seed,
so parity tests carry weights over from the reference instead
(``models.bridge``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | embed

    def fan_in(self) -> int:
        # last-but-one dim is the contraction dim for our matmuls
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]


def stacked(n: int, d: ParamDef) -> ParamDef:
    """Prepend a layer-stacking dim (logical axis 'layers')."""
    return ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init)


def map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef leaf of a nested dict."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    """Draw a parameter tree in ``dtype`` on ``device``.  Leaves are drawn in
    sorted-key order (the JAX package's flatten order), one after another
    from ``generator``, which must live on ``device``."""

    def draw(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        x = torch.randn(d.shape, generator=generator, dtype=dtype,
                        device=device)
        scale = 0.02 if d.init == "embed" else \
            1.0 / math.sqrt(max(1, d.fan_in()))
        return x * scale

    def walk(node):
        if isinstance(node, ParamDef):
            return draw(node)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(defs)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
