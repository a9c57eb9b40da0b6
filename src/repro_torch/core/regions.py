"""Maestro regions (paper §4.4).

A workflow is a DAG of operators; edges are *pipelined* or *blocking* (the
destination produces nothing until that input is fully consumed — e.g. a
HashJoin build input, a sort input).  A **region** is a connected component
over pipelined, non-materialized edges; the **region graph** has an edge
R1 -> R2 per blocking/materialized workflow edge crossing the regions.
A workflow is schedulable iff the region graph is acyclic (self-loops — a
blocking edge inside one region, Fig 4.5/4.8 — are the canonical violation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import networkx as nx


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: str = "op"              # scan|filter|join|ml|union|replicate|sink|...
    cost_per_tuple: float = 1.0
    selectivity: float = 1.0      # output cards = selectivity * input cards
    source_cardinality: float = 0.0


class Workflow:
    def __init__(self):
        self.g = nx.DiGraph()
        self.ops: Dict[str, Op] = {}

    def add_op(self, op: Op) -> "Workflow":
        self.ops[op.name] = op
        self.g.add_node(op.name)
        return self

    def add_edge(self, src: str, dst: str, *, blocking: bool = False,
                 materialized: bool = False, port: str = "") -> "Workflow":
        self.g.add_edge(src, dst, blocking=blocking,
                        materialized=materialized, port=port)
        return self

    def copy(self) -> "Workflow":
        wf = Workflow()
        wf.ops = dict(self.ops)
        wf.g = self.g.copy()
        return wf

    def materialize(self, edges: Iterable[Tuple[str, str]]) -> "Workflow":
        wf = self.copy()
        for u, v in edges:
            wf.g[u][v]["materialized"] = True
        return wf

    def pipelined_edges(self) -> List[Tuple[str, str]]:
        return [(u, v) for u, v, d in self.g.edges(data=True)
                if not d["blocking"] and not d["materialized"]]

    def barrier_edges(self) -> List[Tuple[str, str]]:
        return [(u, v) for u, v, d in self.g.edges(data=True)
                if d["blocking"] or d["materialized"]]

    def sinks(self) -> List[str]:
        return [n for n in self.g if self.g.out_degree(n) == 0]

    def sources(self) -> List[str]:
        return [n for n in self.g if self.g.in_degree(n) == 0]


def regions(wf: Workflow) -> List[FrozenSet[str]]:
    ug = nx.Graph()
    ug.add_nodes_from(wf.g.nodes)
    ug.add_edges_from(wf.pipelined_edges())
    return [frozenset(c) for c in nx.connected_components(ug)]


def region_of(regs: List[FrozenSet[str]], op: str) -> FrozenSet[str]:
    for r in regs:
        if op in r:
            return r
    raise KeyError(op)


def region_graph(wf: Workflow) -> nx.DiGraph:
    regs = regions(wf)
    rg = nx.DiGraph()
    rg.add_nodes_from(regs)
    for u, v in wf.barrier_edges():
        ru, rv = region_of(regs, u), region_of(regs, v)
        rg.add_edge(ru, rv)            # self-loop possible (= infeasible)
    return rg


def is_schedulable(wf: Workflow) -> bool:
    rg = region_graph(wf)
    if any(u == v for u, v in rg.edges):
        return False
    return nx.is_directed_acyclic_graph(rg)


def schedule(wf: Workflow) -> List[FrozenSet[str]]:
    """Topological order of regions (the execution schedule, §4.3)."""
    rg = region_graph(wf)
    assert is_schedulable(wf), "region graph has cycles"
    return list(nx.topological_sort(rg))
