"""Tier-A pipelined-execution substrate (DESIGN.md §2): a deterministic
tick-based simulator of a partitioned operator under pipelined execution.

This is the validation bed on which the paper's algorithms run *verbatim*:
workers with unprocessed input queues (the workload metric phi), an upstream
partitioning logic the controller mutates via (possibly delayed) control
messages, state-migration latency, and per-key processed counts feeding the
"results shown to the user" (result-representativeness curves, Fig 3.16).

Determinism: per-key arrival uses fractional-rate accumulation; SBR record
splitting uses a per-key low-discrepancy (golden ratio) sequence — no RNG, so
every benchmark figure is exactly reproducible.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.transfer import PartitionLogic

GOLDEN = 0.6180339887498949


@dataclasses.dataclass
class PendingAction:
    apply_at: int
    fn: Callable[["PipelinedSim"], None]


class PipelinedSim:
    def __init__(self, n_workers: int,
                 key_rates: Callable[[int], Dict[object, float]],
                 proc_rate: float, logic: PartitionLogic,
                 control_delay: int = 0, migration_ticks: int = 0):
        self.n = n_workers
        self.key_rates = key_rates
        self.proc_rate = proc_rate
        self.logic = logic
        self.control_delay = control_delay
        self.migration_ticks = migration_ticks
        self.tick_no = 0
        self.queues: List[deque] = [deque() for _ in range(n_workers)]
        self.queue_size = [0.0] * n_workers
        self.arrived = [0.0] * n_workers            # cumulative allotted
        self.processed_key: Dict[object, float] = defaultdict(float)
        self.arrived_key: Dict[object, float] = defaultdict(float)
        self.processed = [0.0] * n_workers
        self._frac: Dict[object, float] = defaultdict(float)
        self._ukey: Dict[object, float] = defaultdict(float)
        self._pending: List[PendingAction] = []
        self.migrating_until = [-1] * n_workers     # helper busy w/ migration
        self.total_emitted = 0.0

    # ---------------------------------------------------------- control plane
    def send_control(self, fn: Callable[["PipelinedSim"], None],
                     extra_delay: int = 0) -> None:
        """Controller -> workers message with delivery delay (Fig 3.21)."""
        self._pending.append(PendingAction(
            self.tick_no + self.control_delay + extra_delay, fn))

    def set_logic_with_migration(self, mutate: Callable[[PartitionLogic], None],
                                 helpers: List[int]) -> None:
        """State migration first (M ticks), then the logic change (§3.6.1).
        ``mutate`` edits the partitioning logic IN EFFECT at apply time, so
        concurrent mitigations of different pairs compose instead of
        clobbering each other."""
        m = self.migration_ticks

        def do(sim: "PipelinedSim"):
            for h in helpers:
                sim.migrating_until[h] = sim.tick_no + m

            def swap(sim2: "PipelinedSim"):
                logic = sim2.logic.copy()
                mutate(logic)
                sim2.logic = logic
            sim._pending.append(PendingAction(sim.tick_no + m, swap))
        self.send_control(do)

    def change_logic(self, mutate: Callable[[PartitionLogic], None],
                     extra_delay: int = 0) -> None:
        def do(sim: "PipelinedSim"):
            logic = sim.logic.copy()
            mutate(logic)
            sim.logic = logic
        self.send_control(do, extra_delay)

    # ------------------------------------------------------------------ step
    def workloads(self) -> Dict[int, float]:
        return {w: self.queue_size[w] for w in range(self.n)}

    def _emit(self) -> None:
        rates = self.key_rates(self.tick_no)
        for key, rate in rates.items():
            self._frac[key] += rate
            count = int(self._frac[key])
            if count <= 0:
                continue
            self._frac[key] -= count
            asg = self.logic.assignment[key]
            if len(asg) == 1:
                dests = [(asg[0][0], count)]
            else:
                dests = []
                left = count
                for _ in range(count):
                    self._ukey[key] = (self._ukey[key] + GOLDEN) % 1.0
                    w = self.logic.route(key, self._ukey[key])
                    if dests and dests[-1][0] == w:
                        dests[-1] = (w, dests[-1][1] + 1)
                    else:
                        dests.append((w, 1))
                    left -= 1
            for w, c in dests:
                self.queues[w].append([key, c])
                self.queue_size[w] += c
                self.arrived[w] += c
            self.arrived_key[key] += count
            self.total_emitted += count

    def _process(self) -> None:
        for w in range(self.n):
            if self.migrating_until[w] > self.tick_no:
                continue                       # busy receiving state
            budget = self.proc_rate
            q = self.queues[w]
            while budget > 0 and q:
                key, c = q[0]
                take = min(budget, c)
                self.processed_key[key] += take
                self.processed[w] += take
                self.queue_size[w] -= take
                budget -= take
                if take >= c:
                    q.popleft()
                else:
                    q[0][1] = c - take

    def step(self) -> None:
        due = [a for a in self._pending if a.apply_at <= self.tick_no]
        self._pending = [a for a in self._pending if a.apply_at > self.tick_no]
        for a in sorted(due, key=lambda a: a.apply_at):
            a.fn(self)
        self._emit()
        self._process()
        self.tick_no += 1

    def run(self, ticks: int, strategy=None, metric_interval: int = 1,
            observer: Optional[Callable[["PipelinedSim"], None]] = None):
        for _ in range(ticks):
            if strategy is not None and self.tick_no % metric_interval == 0:
                strategy.on_metrics(self.tick_no, self, self.workloads())
            self.step()
            if observer is not None:
                observer(self)
        return self
