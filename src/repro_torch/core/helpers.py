"""Multi-helper selection (paper §3.6.2).

Given helper candidates h_1..h_c in increasing workload order, add helpers
while chi = min(LR_max, F) keeps increasing, where
    LR_max = (f_S - avg_{w in {S,h..}} f_w) * T     (ideal load reduction)
    F      = (L - M * t) * f_hat_S                  (S's future tuples left
                                                     after state migration)
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def lr_max(f_s: float, f_helpers: List[float], total_tuples: float) -> float:
    fs = [f_s] + list(f_helpers)
    return (f_s - sum(fs) / len(fs)) * total_tuples


def future_after_migration(tuples_left: float, migration_secs: float,
                           tuples_per_sec: float, f_hat_s: float) -> float:
    return max(0.0, (tuples_left - migration_secs * tuples_per_sec) * f_hat_s)


def choose_helpers(f_s: float, candidates: List[Tuple[int, float]],
                   total_tuples: float, tuples_left: float,
                   tuples_per_sec: float,
                   migration_secs_for: "callable") -> List[int]:
    """candidates: [(worker, workload fraction)] in increasing workload order.
    ``migration_secs_for(n)`` estimates migration time with n helpers.
    Returns the chosen helper ids (paper: stop right before chi decreases)."""
    chosen: List[int] = []
    fracs: List[float] = []
    best_chi = -1.0
    for w, fw in candidates:
        trial_f = fracs + [fw]
        m = migration_secs_for(len(trial_f))
        chi = min(lr_max(f_s, trial_f, total_tuples),
                  future_after_migration(tuples_left, m, tuples_per_sec, f_s))
        if chi <= best_chi:
            break
        best_chi = chi
        chosen.append(w)
        fracs.append(fw)
    return chosen
