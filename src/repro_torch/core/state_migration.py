"""State migration by mutability class (paper §3.5, Table 3.1).

* immutable state (HashJoin probe): replicate at the helper, then re-route.
* mutable + SBK (group-by): synchronized move (pause-migrate-resume or
  markers) — the helper's state for the moved keys is the skewed worker's.
* mutable + SBR (range-sort): the same scope's value is *scattered* across
  workers; blocking operators merge scattered parts on END markers (§3.5.4).

The classes below implement real operator state (hash tables / sorted runs /
aggregates) over the simulator's record streams, plus the merge protocol.
Migration cost (bytes) feeds tau' (§3.6.1) and multi-helper selection.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

MUTABILITY = {
    # operator phase -> mutable?
    ("hashjoin", "probe"): False,
    ("set_difference", "probe"): False,
    ("set_intersection", "probe"): False,
    ("hashjoin", "build"): True,
    ("groupby", "agg"): True,
    ("sort", "insert"): True,
    ("set_union", "insert"): True,
}


def is_mutable(op: str, phase: str) -> bool:
    return MUTABILITY[(op, phase)]


@dataclasses.dataclass
class MigrationCost:
    bytes_moved: int
    seconds: float


def migration_time(state_bytes: int, bandwidth_bps: float,
                   serialization_overhead: float = 1.1) -> float:
    return state_bytes * serialization_overhead / bandwidth_bps


# --------------------------------------------------------------- operators

class HashJoinProbe:
    """Immutable-state op: build table fixed during probe phase."""

    def __init__(self, build: Dict[object, List]):
        self.build = build                     # scope -> build tuples

    def state_bytes(self, keys) -> int:
        return sum(len(self.build.get(k, ())) * 8 for k in keys)

    def replicate_to(self, other: "HashJoinProbe", keys) -> MigrationCost:
        moved = 0
        for k in keys:
            if k in self.build:
                other.build[k] = list(self.build[k])
                moved += len(self.build[k]) * 8
        return MigrationCost(moved, 0.0)

    def process(self, key, value):
        return [(value, b) for b in self.build.get(key, ())]


class GroupByAgg:
    """Mutable-state op, SBK-migratable with synchronization (§3.5.3)."""

    def __init__(self):
        self.agg: Dict[object, float] = defaultdict(float)

    def process(self, key, value):
        self.agg[key] += value

    def state_bytes(self, keys) -> int:
        return sum(16 for k in keys if k in self.agg)

    def migrate_keys_to(self, other: "GroupByAgg", keys) -> MigrationCost:
        moved = 0
        for k in list(keys):
            if k in self.agg:
                other.agg[k] += self.agg.pop(k)
                moved += 16
        return MigrationCost(moved, 0.0)


class RangeSortWorker:
    """Mutable-state op under SBR: scattered state + END-marker merge
    (paper Fig 3.11).  Each worker keeps a sorted run per scope (range)."""

    def __init__(self, wid: int):
        self.wid = wid
        self.runs: Dict[object, List] = defaultdict(list)   # scope -> sorted
        self.ended_upstreams: set = set()
        self.output: Optional[List] = None

    def process(self, scope, value):
        bisect.insort(self.runs[scope], value)

    def state_bytes(self, scopes) -> int:
        return sum(len(self.runs.get(s, ())) * 8 for s in scopes)

    def on_end_marker(self, upstream: int, n_upstreams: int,
                      scope_owner: Dict[object, "RangeSortWorker"]):
        """When END markers from all upstreams arrive, ship scattered parts
        of scopes owned elsewhere to their owners (Fig 3.11(e,f))."""
        self.ended_upstreams.add(upstream)
        if len(self.ended_upstreams) < n_upstreams:
            return MigrationCost(0, 0.0)
        moved = 0
        for scope, run in list(self.runs.items()):
            owner = scope_owner[scope]
            if owner is not self:
                for v in run:
                    bisect.insort(owner.runs[scope], v)
                moved += len(run) * 8
                del self.runs[scope]
        return MigrationCost(moved, 0.0)

    def finalize(self, scope_order: List) -> List:
        out: List = []
        for s in scope_order:
            out.extend(self.runs.get(s, ()))
        self.output = out
        return out


def merged_sorted_output(workers: List[RangeSortWorker],
                         scope_order: List) -> List:
    """Concatenate per-owner outputs in range order — must be fully sorted
    iff the scattered-state merge was correct (test invariant)."""
    out: List = []
    for s in scope_order:
        for w in workers:
            out.extend(w.runs.get(s, ()))
    return out
