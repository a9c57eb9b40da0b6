"""Conditional breakpoints (paper §2.5).

*Local* predicates are checkable per worker/shard independently (e.g. NaN
loss, grad-norm spike, per-shard token count).  *Global* predicates (COUNT /
SUM over all workers) use the target-splitting protocol of §2.5.3: the
principal divides the target equally, workers pause on reaching their share
and notify; the principal waits a sync timeout tau, inquires laggards,
re-divides the remainder, and repeats — trading sync time against
parallelism (Fig 2.13).

``GlobalTargetProtocol`` simulates the protocol over workers with arbitrary
production rates (continuous time) — the Fig 2.13 benchmark.  The runtime
adapter for SPMD training is in ``repro.runtime.loop`` (data shards advance
in lockstep, so the principal's view is exact per step; the protocol governs
the asynchronous data-pipeline workers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class LocalBreakpoint:
    name: str
    predicate: Callable[[dict], bool]

    def check(self, metrics: dict) -> bool:
        return bool(self.predicate(metrics))


def nan_breakpoint() -> LocalBreakpoint:
    return LocalBreakpoint(
        "nan", lambda m: not math.isfinite(float(m.get("loss", 0.0))))


def grad_norm_breakpoint(threshold: float) -> LocalBreakpoint:
    return LocalBreakpoint(
        "grad_norm", lambda m: float(m.get("grad_norm", 0.0)) > threshold)


@dataclasses.dataclass
class GlobalCountBreakpoint:
    """Pause when the total count of X produced across shards reaches N."""
    name: str
    metric: str
    target: float
    _total: float = 0.0

    def update(self, shard_values: Sequence[float]) -> bool:
        self._total += float(sum(shard_values))
        return self._total >= self.target


# ----------------------------------------------------- §2.5.3 protocol sim

@dataclasses.dataclass
class ProtocolResult:
    total_time: float
    normal_time: float
    sync_time: float
    produced: float
    overshoot: float
    rounds: int


def run_global_target_protocol(
        target: float, rates: Sequence[float], tau: float,
        values_per_tuple: Optional[Sequence[float]] = None,
        single_worker_threshold: float = 0.0) -> ProtocolResult:
    """Continuous-time simulation of the COUNT/SUM target-splitting protocol.

    ``rates``: tuples/sec per worker.  For SUM predicates pass
    ``values_per_tuple`` (mean value each worker's tuples contribute) and a
    ``single_worker_threshold``: once the remaining target drops below it,
    the principal gives the whole remainder to ONE worker to minimize
    overshoot (paper's G2 strategy).
    """
    k = len(rates)
    vals = list(values_per_tuple or [1.0] * k)
    remaining = float(target)
    produced = 0.0
    normal_time = sync_time = 0.0
    rounds = 0
    while remaining > 1e-9:
        rounds += 1
        if remaining <= single_worker_threshold and k > 1:
            # end-game: single worker finishes the remainder
            w = max(range(k), key=lambda i: rates[i])
            n_tuples = math.ceil(remaining / vals[w])
            dt = n_tuples / rates[w]
            normal_time += dt
            got = n_tuples * vals[w]
            produced += got
            remaining -= got
            continue
        share = remaining / k
        # tuples each worker must produce to cover its share
        need = [math.ceil(share / vals[i]) for i in range(k)]
        t_first = min(need[i] / rates[i] for i in range(k))
        normal_time += t_first
        # principal waits tau; everyone keeps producing during the wait
        t_window = t_first + tau
        got_tuples = [min(need[i], math.floor(rates[i] * t_window))
                      for i in range(k)]
        # laggards are inquired and pause; add their tally
        round_produced = sum(got_tuples[i] * vals[i] for i in range(k))
        finished_in_tau = all(got_tuples[i] >= need[i] for i in range(k))
        sync_time += tau if not finished_in_tau else min(
            tau, max((need[i] / rates[i] for i in range(k))) - t_first)
        produced += round_produced
        remaining -= round_produced
    overshoot = max(0.0, produced - target)
    return ProtocolResult(normal_time + sync_time, normal_time, sync_time,
                          produced, overshoot, rounds)
