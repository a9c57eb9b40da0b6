"""Result-aware choice selection (paper §4.5.2–4.5.4) + the ML mapping.

Two scheduling objectives live here, and every online engine decision is a
choice between them:

* **First-response time (FRT)** — the *interactive* objective: time to the
  FIRST tuple out of the sink.  Every region that must complete before the
  sink's region runs is paid in full; the sink's region contributes only
  its pipeline-fill latency (Figs 4.13–4.15).  Maestro picks the min-FRT
  choice, tie-breaking on materialized bytes (§4.6.3).  This is the serve
  objective: a user is waiting on the first token.
* **Completion time** — the *throughput* objective: total time to drain
  every region.  This is the train-step and kernel-choice objective:
  nobody reads anything until the whole step lands.

``weighted`` variants divide the score by a caller-supplied weight — the
multi-pool serving engine scores each candidate tick as FRT over the summed
priority-class weight of the requests the tick advances, which is how a
high-priority class preempts a low-priority one without a separate queue.

ML mapping (DESIGN.md §2): the same machinery selects the activation
materialization (remat) policy of the training step — regions = {fwd, bwd,
opt}; "materializing" the fwd/bwd edge = saving activations; FRT analogue =
step latency subject to the HBM budget.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

import networkx as nx

from repro_torch.core.materialization import Edge, enumerate_choices
from repro_torch.core.regions import (Workflow, region_graph, region_of, regions,
                                schedule)


@dataclasses.dataclass
class CostModel:
    parallelism: float = 1.0
    tuple_bytes: float = 64.0


def cardinalities(wf: Workflow) -> Dict[str, float]:
    """Output cardinality per op (topological propagation)."""
    cards: Dict[str, float] = {}
    for n in nx.topological_sort(wf.g):
        op = wf.ops[n]
        inp = sum(cards[p] for p in wf.g.predecessors(n))
        cards[n] = op.source_cardinality if wf.g.in_degree(n) == 0 \
            else op.selectivity * inp
    return cards


def region_full_time(wf: Workflow, region: FrozenSet[str],
                     cards: Dict[str, float], cm: CostModel) -> float:
    t = 0.0
    for n in region:
        op = wf.ops[n]
        inp = sum(cards[p] for p in wf.g.predecessors(n)) or \
            op.source_cardinality
        t += inp * op.cost_per_tuple / cm.parallelism
    return t


def region_first_tuple_time(wf: Workflow, region: FrozenSet[str],
                            cm: CostModel) -> float:
    """Pipeline-fill latency ~ per-tuple cost along the longest path."""
    sub = wf.g.subgraph(region)
    best = 0.0
    for n in region:
        if sub.in_degree(n) == 0:
            for m in region:
                if sub.out_degree(m) == 0:
                    for p in nx.all_simple_paths(sub, n, m):
                        best = max(best, sum(wf.ops[x].cost_per_tuple
                                             for x in p))
                    best = max(best, wf.ops[n].cost_per_tuple)
    return best / cm.parallelism


def first_response_time(wf: Workflow, choice: FrozenSet[Edge],
                        cm: CostModel) -> float:
    w = wf.materialize(choice)
    regs = regions(w)
    rg = region_graph(w)
    cards = cardinalities(w)
    sinks = w.sinks()
    # multiple sink-feeding regions (Fig 4.14/4.15): min over sinks
    best = float("inf")
    for s in sinks:
        rs = region_of(regs, s)
        upstream = nx.ancestors(rg, rs)
        t = sum(region_full_time(w, r, cards, cm) for r in upstream)
        t += region_first_tuple_time(w, rs, cm)
        best = min(best, t)
    return best


def materialized_bytes(wf: Workflow, choice: FrozenSet[Edge],
                       cm: CostModel) -> float:
    cards = cardinalities(wf)
    return sum(cards[u] * cm.tuple_bytes for u, _ in choice)


def choose(wf: Workflow, cm: CostModel) -> Tuple[FrozenSet[Edge], dict]:
    """Result-aware materialization selection: min FRT, then min bytes."""
    options = enumerate_choices(wf)
    scored = []
    for c in options:
        scored.append((first_response_time(wf, c, cm),
                       materialized_bytes(wf, c, cm), c))
    scored.sort(key=lambda x: (x[0], x[1]))
    frt, mbytes, best = scored[0]
    return best, {"frt": frt, "bytes": mbytes,
                  "all": [(f, b, sorted(c)) for f, b, c in scored]}


def completion_time(wf: Workflow, cm: CostModel) -> float:
    """Total time to drain the workflow: every region paid in full.  The
    engine's *throughput* objective — compare with ``first_response_time``,
    the *interactive* objective; the online scheduler picks which of the two
    to minimize depending on whether a user is waiting (result-awareness at
    the job level)."""
    cards = cardinalities(wf)
    return sum(region_full_time(wf, r, cards, cm) for r in regions(wf))


def weighted_first_response_time(wf: Workflow, choice: FrozenSet[Edge],
                                 cm: CostModel,
                                 weight: float = 1.0) -> float:
    """FRT scaled by urgency: candidates serving more (or heavier) waiting
    requests score lower.  ``weight`` is the summed priority-class weight of
    the requests whose first response the candidate advances; weight 1.0 is
    plain FRT, so single-class scheduling falls out unchanged."""
    return first_response_time(wf, choice, cm) / max(weight, 1e-9)


def placement_adjusted_frt(frt: float, weight: float = 1.0,
                           load: float = 0.0, xfer: float = 0.0) -> float:
    """Weighted FRT with device-placement terms: ``load`` (busy fraction of
    the candidate's device group) inflates the score multiplicatively — a
    tick on a contended device finishes later than its pool-local EMA says —
    and ``xfer`` (seconds of pending state migration headed at the pool)
    adds the transfer the tick must wait behind.  Both default to zero, so
    unplaced scheduling reduces to ``weighted_first_response_time``
    exactly — the decision-identity the pre-placement tests pin."""
    return (frt * (1.0 + max(load, 0.0)) + max(xfer, 0.0)) / max(weight,
                                                                 1e-9)


def compare_frt(candidates: Dict[str, Workflow], cm: CostModel,
                weight: float = 1.0) -> Tuple[str, Dict[str, float]]:
    """Arbitrate named alternative workflows under (weighted) FRT: returns
    ``(best_name, scores)`` with the minimum-FRT candidate first and every
    candidate's score for the decision audit trail.  This is the
    reuse-vs-recompute comparator: the engine hands it e.g.
    ``{"seed": prefix_seed_workflow(...), "prefill": prefill_workflow(...)}``
    and takes whichever path answers the waiting user first — the §4.5
    min-FRT rule applied to materialized intermediate state instead of tick
    composition.  Ties break on candidate name for determinism."""
    assert candidates, "compare_frt needs at least one candidate"
    scores = {name: weighted_first_response_time(wf, frozenset(), cm, weight)
              for name, wf in candidates.items()}
    best = min(sorted(scores), key=scores.get)
    return best, scores


def score_choices(wf: Workflow, cm: CostModel,
                  objective: str = "frt",
                  weight: float = 1.0) -> List[Tuple[float, float,
                                                     FrozenSet[Edge]]]:
    """Online API: score every materialization choice under an objective
    ('frt' or 'completion'); sorted best-first, tie-broken on bytes.
    ``weight`` divides the score (see ``weighted_first_response_time``) so
    the same API arbitrates between workflows serving different aggregate
    priority weights; the default leaves scores unweighted."""
    assert objective in ("frt", "completion"), objective
    scored = []
    for c in enumerate_choices(wf):
        t = first_response_time(wf, c, cm) if objective == "frt" \
            else completion_time(wf.materialize(c), cm)
        scored.append((t / max(weight, 1e-9),
                       materialized_bytes(wf, c, cm), c))
    scored.sort(key=lambda x: (x[0], x[1]))
    return scored


# ----------------------------------------------------------- SLO grading

def percentile(xs, q: float) -> float:
    """Deterministic nearest-rank percentile (``q`` in [0, 100]) — the
    SLO-grading primitive.  Nearest-rank (not interpolated) so a grade
    computed from N latency samples is exactly reproducible across numpy
    versions and never manufactures a latency no request actually saw.
    Empty input grades as +inf: a scenario that produced no samples for a
    bounded metric must fail the bound, not vacuously pass it."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        return float("inf")
    q = min(max(float(q), 0.0), 100.0)
    rank = max(int(-(-q / 100.0 * len(xs) // 1)), 1)   # ceil, >= 1
    return xs[rank - 1]


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """One scenario's service-level objective over measured serve behavior.

    All latency bounds are in *virtual ticks* (scheduling rounds), not wall
    seconds: the gauntlet grades scheduling quality, and tick-denominated
    metrics are deterministic across machines where wall-clock ones embed
    the host's speed.  ``None`` disables a bound.  ``scope`` names the
    priority class the bound applies to (``None``: all requests pooled) —
    a scenario lists one SLO per class it cares about."""
    scope: Optional[str] = None       # priority class (None: all requests)
    p50_ttft: Optional[float] = None  # median first-response bound (ticks)
    p99_ttft: Optional[float] = None  # tail first-response bound (ticks)
    min_goodput: Optional[float] = None   # committed tokens per tick, >=
    max_deferred: Optional[int] = None    # aging-bound ceiling (ticks)
    max_dropped: int = 0              # dropped requests allowed (always 0
    #                                   today: the engine never sheds load)


def grade_slo(metrics: Dict[str, float],
              slos: List[ServeSLO]) -> Tuple[bool, Dict[str, str]]:
    """Grade measured scenario metrics against a list of SLOs.

    ``metrics`` carries per-scope keys — ``p50_ttft``/``p99_ttft``/
    ``goodput``/``max_deferred``/``dropped`` for the pooled scope and
    ``<cls>/p50_ttft`` etc. for class scopes (the shape
    ``loadgen.summarize`` emits).  Returns ``(passed, detail)`` where
    ``detail`` maps each checked criterion to ``"pass:<measured>"`` or
    ``"FAIL:<measured>><bound>"`` — the row the gauntlet prints, so a CI
    failure names the violated bound directly.  A bound whose metric is
    missing fails: silence is not compliance."""
    detail: Dict[str, str] = {}
    ok = True

    def check(scope, name, bound, larger_ok=False):
        nonlocal ok
        if bound is None:
            return
        key = f"{scope}/{name}" if scope else name
        v = metrics.get(key)
        good = v is not None and (v >= bound if larger_ok else v <= bound)
        cmp = ">=" if larger_ok else "<="
        if good:
            detail[key] = f"pass:{v:.2f}{cmp}{bound:g}"
        else:
            ok = False
            detail[key] = (f"FAIL:missing{cmp}{bound:g}" if v is None
                           else f"FAIL:{v:.2f}!{cmp}{bound:g}")

    for s in slos:
        check(s.scope, "p50_ttft", s.p50_ttft)
        check(s.scope, "p99_ttft", s.p99_ttft)
        check(s.scope, "goodput", s.min_goodput, larger_ok=True)
        check(s.scope, "max_deferred", s.max_deferred)
        check(s.scope, "dropped", s.max_dropped)
    return ok, detail


# ------------------------------------------------------------- ML mapping

@dataclasses.dataclass
class RematOption:
    name: str                      # none | dots | full
    act_bytes_per_layer: float     # activations persisted per layer
    recompute_flops_factor: float  # extra fwd fraction paid in bwd


def remat_policy(cfg, shape, hbm_bytes_per_device: float,
                 act_bytes_per_layer: Dict[str, float],
                 step_flops: float, peak_flops: float) -> Tuple[str, dict]:
    """Maestro-style result-aware choice of the activation materialization:
    pick the fastest policy whose persisted activations fit the budget."""
    options = [
        RematOption("none", act_bytes_per_layer["none"], 0.0),
        RematOption("dots", act_bytes_per_layer["dots"], 0.30),
        RematOption("full", act_bytes_per_layer["full"], 1.0 / 3.0),
    ]
    scored = []
    for o in options:
        mem = o.act_bytes_per_layer * cfg.num_layers
        time = step_flops * (1 + o.recompute_flops_factor) / peak_flops
        fits = mem <= hbm_bytes_per_device
        scored.append((not fits, time, o.name, mem))
    scored.sort()
    bad, time, name, mem = scored[0]
    return name, {"fits": not bad, "est_time": time, "act_bytes": mem,
                  "all": scored}
