"""Parameter bridge from the JAX package's trees.

The JAX package is the reference: parity tests take its weights
(``repro.models.lm.init``), hand them over as numpy, and run both models on
the same numbers.  The port's parameter trees have the same nested keys and
the same stacked ``[L, ...]`` layer dims, so the bridge is a leaf-wise
conversion.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def from_jax(tree, device="cpu") -> Dict[str, Any]:
    """A nested dict of array-likes (numpy, or anything ``np.asarray``
    accepts) -> the same nested dict of torch tensors, dtype preserved
    (bfloat16 leaves included)."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16: move the bits, reinterpret on the torch side
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)
