"""Reshape skew detection (paper §3.2).

Skew test between workers L (loaded) and C (candidate helper):
    phi_L >= eta            (3.1)  — L is computationally burdened
    phi_L - phi_C >= tau    (3.2)  — the gap is big enough to act on
Helper selection: the lowest-workload candidate not already assigned.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class SkewParams:
    eta: float = 100.0
    tau: float = 100.0


def skew_test(phi_l: float, phi_c: float, p: SkewParams) -> bool:
    return phi_l >= p.eta and (phi_l - phi_c) >= p.tau


def detect(workloads: Dict[int, float], p: SkewParams,
           max_pairs: int | None = None) -> List[Tuple[int, int]]:
    """Pair skewed workers with helpers.

    Returns [(skewed, helper), ...].  Skewed workers are considered in
    decreasing workload order; each helper (lowest workload first) is
    assigned to at most one skewed worker (§3.2.1).
    """
    order = sorted(workloads, key=lambda w: -workloads[w])
    assigned: set[int] = set()
    pairs: List[Tuple[int, int]] = []
    for s in order:
        if s in assigned:
            continue
        candidates = [c for c in sorted(workloads, key=lambda w: workloads[w])
                      if c != s and c not in assigned
                      and skew_test(workloads[s], workloads[c], p)]
        if not candidates:
            continue
        h = candidates[0]
        pairs.append((s, h))
        assigned.update((s, h))
        if max_pairs and len(pairs) >= max_pairs:
            break
    return pairs


def load_balancing_ratio(sizes: Sequence[float]) -> float:
    """Paper §3.7.4: min(total_S, total_H) / max(...) — higher is better."""
    lo, hi = min(sizes), max(sizes)
    return 0.0 if hi == 0 else lo / hi
