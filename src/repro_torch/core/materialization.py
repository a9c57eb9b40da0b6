"""Materialization-choice enumeration (paper §4.5.1, Figs 4.11/4.12).

A conflict exists when a blocking input edge (u -> v) and some pipelined
input path into v live in the same region (the build side cannot complete
before the probe side starts).  For each conflict, the candidate cut points
are the pipelined edges on the probe-side paths *after* the last operator
shared with the build side's ancestry (the divergence point — Fig 4.12).
A materialization choice picks one cut per conflict such that the resulting
region graph is acyclic; the result set is de-duplicated and minimal.
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Set, Tuple

import networkx as nx

from repro_torch.core.regions import Workflow, is_schedulable, regions, region_of

Edge = Tuple[str, str]


def conflicts(wf: Workflow) -> List[Tuple[Edge, List[List[Edge]]]]:
    """[(blocking_edge, probe paths (edge lists) that conflict with it)]."""
    regs = regions(wf)
    out = []
    for u, v, d in wf.g.edges(data=True):
        if not d["blocking"] or d["materialized"]:
            continue
        if region_of(regs, u) is not region_of(regs, v):
            continue                        # already separated
        build_anc = nx.ancestors(wf.g, u) | {u}
        paths: List[List[Edge]] = []
        for src in wf.sources():
            for p in nx.all_simple_paths(wf.g, src, v):
                edges = list(zip(p, p[1:]))
                if edges[-1] == (u, v):
                    continue                # that's the build path itself
                if wf.g[edges[-1][0]][edges[-1][1]]["blocking"]:
                    continue                # enters v via another blocking port
                if not (set(p) & build_anc):
                    continue                # no shared ancestry, no conflict
                # cut candidates: edges after the LAST node shared with the
                # build ancestry
                last_shared = max(i for i, n in enumerate(p)
                                  if n in build_anc)
                paths.append(edges[last_shared:])
        if paths:
            out.append(((u, v), paths))
    return out


def candidate_cuts(wf: Workflow, probe_paths: List[List[Edge]]) -> List[Edge]:
    """Single pipelined edges that cut ALL conflicting probe paths."""
    sets = [set(p) for p in probe_paths]
    common = set.intersection(*sets) if sets else set()
    return [e for e in common
            if not wf.g[e[0]][e[1]]["blocking"]
            and not wf.g[e[0]][e[1]]["materialized"]]


def enumerate_choices(wf: Workflow, max_extra: int = 2) -> List[FrozenSet[Edge]]:
    """All minimal materialization choices making the workflow schedulable."""
    if is_schedulable(wf):
        return [frozenset()]
    confs = conflicts(wf)
    per_conflict = [candidate_cuts(wf, paths) for _, paths in confs]
    choices: Set[FrozenSet[Edge]] = set()
    if all(per_conflict):
        for combo in itertools.product(*per_conflict):
            c = frozenset(combo)
            if is_schedulable(wf.materialize(c)):
                choices.add(c)
    if not choices:
        # fall back: small subsets of pipelined edges
        edges = wf.pipelined_edges()
        for k in range(1, max_extra + 1):
            for combo in itertools.combinations(edges, k):
                c = frozenset(combo)
                if is_schedulable(wf.materialize(c)):
                    choices.add(c)
            if choices:
                break
    # minimality: drop choices that strictly contain another valid choice
    minimal = [c for c in choices
               if not any(o < c for o in choices)]
    return sorted(minimal, key=lambda c: (len(c), sorted(c)))
