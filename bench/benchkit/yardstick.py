"""The yardstick: the H100's bf16 peak and the model FLOPs of a position.

Frozen copies, so that a change to the program cannot move the measure:
the peak is ``src/repro_torch/launch/mesh.py``'s (NVIDIA's H100 SXM
data sheet, dense rate, at the card's 700 W limit), and ``flops_affine``
is the arithmetic of ``fwd_flops_per_token`` in
``src/repro_torch/analysis/flops.py`` for the dense ``attn`` block type,
written over a configuration file's keys.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card, bf16 dense


def flops_affine(c: Dict):
    """(A, B): a position whose query attends to ``ctx`` keys costs
    ``A + B * ctx`` model FLOPs (2 per multiply-add)."""
    d, nh = c["hidden_size"], c["num_attention_heads"]
    nkv = c["num_key_value_heads"]
    hd = c.get("head_dim") or d // nh
    n, v = c["num_hidden_layers"], c["vocab_size"]
    per_layer = 2 * d * (nh + 2 * nkv) * hd + 2 * nh * hd * d \
        + 2 * 3 * d * c["intermediate_size"]
    a = 2 * d * v + n * per_layer
    b = n * 2 * 2 * nh * hd
    return float(a), float(b)


def flops_per_position(c: Dict, ctx: float) -> float:
    a, b = flops_affine(c)
    return a + b * ctx


def flops_of_positions(c: Dict, lo: int, hi: int) -> float:
    """Model FLOPs of positions ``lo..hi-1`` of one sequence: position
    ``i`` attends to ``i + 1`` keys."""
    if hi <= lo:
        return 0.0
    a, b = flops_affine(c)
    keys = (hi * (hi + 1) - lo * (lo + 1)) / 2      # sum of i + 1
    return a * (hi - lo) + b * keys
