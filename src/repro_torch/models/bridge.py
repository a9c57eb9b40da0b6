"""Parameter bridge from the JAX package's trees.

The JAX package is the reference: parity tests take its weights
(``repro.models.lm.init``), hand them over as numpy, and run both models on
the same numbers.  The port's parameter trees have the same nested keys and
the same stacked ``[L, ...]`` layer dims (and the same single unstacked
``shared_attn`` copy), so the bridge is a leaf-wise conversion.  Like the
port's other entry points it puts the tensors on the card unless the caller
asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def from_jax(tree, device="cuda") -> Dict[str, Any]:
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


def opt_from_jax(opt, device="cuda"):
    """An AdamW ``OptState`` of the JAX package (``m``, ``v``, ``count``, as
    numpy or anything ``np.asarray`` accepts) -> the port's ``OptState``,
    so a parity test can start both frameworks from one training state."""
    from repro_torch.optim.adamw import OptState
    return OptState(from_jax(opt.m, device), from_jax(opt.v, device),
                    from_jax(np.asarray(opt.count, dtype=np.int32), device))


def state_from_jax(state, device="cuda") -> Dict[str, Any]:
    """A whole training state ``{"params", "opt", "step"}`` of the JAX
    package -> the port's."""
    return {"params": from_jax(state["params"], device),
            "opt": opt_from_jax(state["opt"], device),
            "step": from_jax(np.asarray(state["step"], dtype=np.int32),
                             device)}
