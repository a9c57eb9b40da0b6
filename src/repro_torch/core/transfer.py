"""Result-aware load transfer (paper §3.3): SBK vs SBR, two-phase transfer.

``PartitionLogic`` is the paper's "partitioning logic at the previous
operator": a mapping key -> [(worker, cumulative fraction)].  SBK moves whole
keys between workers; SBR splits a key's records across workers by fractions.
The two phases:
  phase 1 (catch-up): redirect ALL future input of the skewed worker S to the
      helper H until their queued workloads meet (§3.3.2);
  phase 2 (steady state): split future input so both receive comparable load,
      using the workload estimator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

Assignment = List[Tuple[int, float]]          # [(worker, cum_frac)], cum->1.0


@dataclasses.dataclass
class PartitionLogic:
    assignment: Dict[object, Assignment]

    def route(self, key, u: float) -> int:
        for worker, cum in self.assignment[key]:
            if u < cum:
                return worker
        return self.assignment[key][-1][0]

    def workers_of(self, key) -> List[int]:
        return [w for w, _ in self.assignment[key]]

    def copy(self) -> "PartitionLogic":
        return PartitionLogic({k: list(v) for k, v in self.assignment.items()})

    @staticmethod
    def hash_partition(keys: Sequence, n_workers: int) -> "PartitionLogic":
        return PartitionLogic(
            {k: [(hash(k) % n_workers, 1.0)] for k in keys})

    @staticmethod
    def modulo(keys: Sequence[int], n_workers: int) -> "PartitionLogic":
        return PartitionLogic({k: [(k % n_workers, 1.0)] for k in keys})


def keys_on(logic: PartitionLogic, worker: int) -> List:
    return [k for k, a in logic.assignment.items()
            if any(w == worker for w, _ in a)]


def keys_owned(logic: PartitionLogic, worker: int) -> List:
    """Keys whose OWNER (remainder-taker, last in the assignment) is
    ``worker`` — a worker's partition for load-transfer purposes; keys it
    merely helps with belong to another pair's mitigation."""
    return [k for k, a in logic.assignment.items() if a[-1][0] == worker]


# ------------------------------------------------------------------ SBK / SBR

def sbk_plan(key_loads: Dict[object, float], skewed: int, helper: int,
             logic: PartitionLogic, target: float) -> List:
    """Split-by-keys: choose keys of S (smallest first, never the largest —
    mirroring that SBK cannot split a single hot key) whose combined load
    moves ~``target`` to H.  Returns the moved keys."""
    s_keys = [(k, key_loads.get(k, 0.0)) for k in keys_owned(logic, skewed)]
    s_keys.sort(key=lambda kv: kv[1])
    moved, acc = [], 0.0
    for k, load in s_keys[:-1]:               # keep the hottest on S
        if acc >= target:
            break
        moved.append(k)
        acc += load
    for k in moved:
        logic.assignment[k] = [(helper, 1.0)]
    return moved


def sbr_fraction(phi_s_hat: float, phi_h_hat: float) -> float:
    """Steady-state fraction of S's future input to redirect so both receive
    comparable load:  (phi_S - phi_H) / (2 phi_S), clipped to [0, 1]."""
    if phi_s_hat <= 0:
        return 0.0
    return min(1.0, max(0.0, (phi_s_hat - phi_h_hat) / (2.0 * phi_s_hat)))


def sbr_apply(logic: PartitionLogic, skewed: int, helper: int,
              frac_to_helper: float) -> None:
    """Split every key OWNED by S: ``frac_to_helper`` of records go to H
    (ownership stays with S; re-application recomputes the fraction)."""
    for k in keys_owned(logic, skewed):
        logic.assignment[k] = [(helper, frac_to_helper), (skewed, 1.0)]


def phase1_apply(logic: PartitionLogic, skewed: int, helper: int) -> None:
    """Catch-up: all future input of S goes to H."""
    sbr_apply(logic, skewed, helper, 1.0)


def multi_sbr_apply(logic: PartitionLogic, skewed: int,
                    helpers_frac: List[Tuple[int, float]]) -> None:
    """SBR across multiple helpers: [(helper, frac)], remainder stays on S."""
    cum, asg = 0.0, []
    for h, f in helpers_frac:
        cum += f
        asg.append((h, cum))
    asg.append((skewed, 1.0))
    for k in keys_on(logic, skewed):
        logic.assignment[k] = list(asg)
