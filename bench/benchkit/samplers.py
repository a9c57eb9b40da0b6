"""The seeded length sampler.

A frozen copy of the arithmetic of ``heavy_tail_lengths`` (bounded
Pareto) in ``src/repro_torch/engine/loadgen.py``: the benchmark's
yardstick may not move when the program does.  The copy differs in one
way: it takes its uniform draws ``u`` in [0, 1) and applies the inverse
CDF, so that ``traffic`` can hand every seed the same stratified set of
draws in another order.
"""
from __future__ import annotations

import numpy as np


def bounded_pareto(u, lo: int, hi: int, alpha: float) -> np.ndarray:
    """Bounded Pareto lengths on [lo, hi] (``heavy_tail_lengths``)."""
    la, ha = float(lo) ** alpha, float(hi) ** alpha
    x = (-(np.asarray(u, np.float64) * (ha - la) - ha) / (ha * la)) \
        ** (-1.0 / alpha)
    return np.clip(np.floor(x), lo, hi).astype(np.int64)
