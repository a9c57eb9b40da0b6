"""Reshape's pipelined-execution simulator in the port against the JAX
package's, and the port's import guard.

``repro_torch.core.{helpers, transfer, worker, state_migration,
strategies}`` are copies of the reference's JAX-free modules.  Every
scenario of the reference's tests/test_sim_strategies.py and
tests/test_state_migration.py runs through both packages on the same
inputs, and the outputs must be identical, with no tolerance: the
per-tick arrivals (the load-balance series), the queue sizes, the
per-key counts, the final partitioning logic, the strategies' iteration
and migration counts, and the migrated state.

The guard parses every module under ``src/repro_torch/`` and
``chip_smoke.py`` and fails if any imports ``repro`` (the JAX package)
or ``jax``.
"""
import ast
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core.adaptive as j_adaptive
import repro.core.helpers as j_helpers
import repro.core.skew as j_skew
import repro.core.state_migration as j_state
import repro.core.strategies as j_strat
import repro.core.transfer as j_transfer
import repro.core.worker as j_worker
import repro_torch.core.adaptive as t_adaptive
import repro_torch.core.helpers as t_helpers
import repro_torch.core.skew as t_skew
import repro_torch.core.state_migration as t_state
import repro_torch.core.strategies as t_strat
import repro_torch.core.transfer as t_transfer
import repro_torch.core.worker as t_worker

ROOT = Path(__file__).resolve().parents[1]


def _pkg(adaptive, helpers, skew, state, strat, transfer, worker):
    return types.SimpleNamespace(adaptive=adaptive, helpers=helpers,
                                 skew=skew, state=state, strat=strat,
                                 transfer=transfer, worker=worker)


REF = _pkg(j_adaptive, j_helpers, j_skew, j_state, j_strat, j_transfer,
           j_worker)
PORT = _pkg(t_adaptive, t_helpers, t_skew, t_state, t_strat, t_transfer,
            t_worker)

# tests/test_sim_strategies.py's operator: 8 workers, key 6 hot, key 4 warm
KEYS = list(range(8))
RATES = {k: 1.0 for k in KEYS}
RATES[6] = 26.0
RATES[4] = 3.8


def _trace(p, strategy, rates=lambda t: RATES, ticks=300, proc_rate=5.0,
           **sim_kw):
    """Run the simulator; every tick's arrivals, queue sizes and
    processed counts, then the final state: what a figure reads."""
    sim = p.worker.PipelinedSim(8, rates, proc_rate=proc_rate,
                                logic=p.transfer.PartitionLogic.modulo(
                                    KEYS, 8), **sim_kw)
    series = []
    sim.run(ticks, strategy, metric_interval=5,
            observer=lambda s: series.append(
                (tuple(s.arrived), tuple(s.queue_size),
                 tuple(s.processed))))
    return {"series": series,
            "processed_key": dict(sim.processed_key),
            "arrived_key": dict(sim.arrived_key),
            "assignment": {k: list(v)
                           for k, v in sim.logic.assignment.items()},
            "migrating_until": list(sim.migrating_until),
            "total_emitted": sim.total_emitted,
            "iterations": getattr(strategy, "iterations", None),
            "migrations": getattr(strategy, "migrations", None),
            "active": dict(getattr(strategy, "active", {}) or {}),
            "tau": (strategy.adaptive_tau.tau
                    if getattr(strategy, "adaptive_tau", None) else None)}


def _skew(p, tau=20):
    return p.skew.SkewParams(eta=20, tau=tau)


def _shift(t):
    rates = {k: 1.0 for k in KEYS}
    if t < 150:
        rates[0] = 20.0
    else:
        rates[0], rates[1] = 8.0, 13.0
    return rates


# each scenario of tests/test_sim_strategies.py, as (package -> outputs)
SIM_SCENARIOS = {
    "no_mitigation": lambda p: _trace(p, p.strat.NoMitigation()),
    "flux": lambda p: _trace(p, p.strat.FluxStrategy(_skew(p))),
    "flow_join": lambda p: _trace(p, p.strat.FlowJoinStrategy()),
    "reshape": lambda p: _trace(p, p.strat.ReshapeStrategy(_skew(p))),
    "reshape_sbk": lambda p: _trace(p, p.strat.ReshapeStrategy(
        _skew(p), mode="sbk")),
    "reshape_no_first_phase": lambda p: _trace(
        p, p.strat.ReshapeStrategy(_skew(p), first_phase=False),
        ticks=600),
    "control_delay": lambda p: _trace(p, p.strat.ReshapeStrategy(_skew(p)),
                                      control_delay=30),
    "shift_reshape": lambda p: _trace(p, p.strat.ReshapeStrategy(_skew(p)),
                                      rates=_shift, ticks=400,
                                      proc_rate=4.0),
    "shift_flow_join": lambda p: _trace(p, p.strat.FlowJoinStrategy(),
                                        rates=_shift, ticks=400,
                                        proc_rate=4.0),
    "fixed_tiny_tau": lambda p: _trace(p, p.strat.ReshapeStrategy(
        _skew(p, tau=2))),
    "adaptive_tau": lambda p: _trace(p, p.strat.ReshapeStrategy(
        _skew(p, tau=2), adaptive_tau=p.adaptive.TauAdjuster(
            eps_l=1.0, eps_u=5.0, tau=2, increase_by=20))),
    "migration_time": lambda p: _trace(p, p.strat.ReshapeStrategy(
        _skew(p)), migration_ticks=10),
}


@pytest.mark.parametrize("name", sorted(SIM_SCENARIOS))
def test_simulator_scenario_identical(name):
    ref, port = SIM_SCENARIOS[name](REF), SIM_SCENARIOS[name](PORT)
    assert port == ref
    # the scenario does work: keys arrive and are processed
    assert ref["total_emitted"] > 0 and sum(ref["processed_key"].values())


def test_reshape_claims_hold_on_the_port():
    """The reference test's qualitative claim (paper Fig 3.20), on the
    port's copy: Reshape balances the hot key's pair best."""
    def pair_lb(out):
        arr = out["series"][-1][0]
        other = max(a for i, a in enumerate(arr) if i != 6)
        return min(arr[6], other) / max(arr[6], other)

    lb = {n: pair_lb(SIM_SCENARIOS[n](PORT))
          for n in ("no_mitigation", "flux", "flow_join", "reshape")}
    assert lb["reshape"] > 0.85
    assert lb["reshape"] > lb["flow_join"] > lb["flux"]
    assert lb["flux"] == lb["no_mitigation"]


# ----------------------------------------------------- state migration

def _hashjoin(p):
    a = p.state.HashJoinProbe({"k1": [1, 2], "k2": [3]})
    b = p.state.HashJoinProbe({})
    cost = a.replicate_to(b, ["k1"])
    return (dict(b.build), cost, a.process("k1", 9), b.process("k1", 9))


def _groupby(p):
    a, b = p.state.GroupByAgg(), p.state.GroupByAgg()
    for _ in range(10):
        a.process("g1", 1.0)
        a.process("g2", 2.0)
    cost = a.migrate_keys_to(b, ["g2"])
    for _ in range(5):
        b.process("g2", 2.0)
    return dict(a.agg), dict(b.agg), cost


def _sort(p):
    """tests/test_state_migration.py's scattered range-sort (paper Fig
    3.11): half of r0's records go to the helper; END markers merge."""
    rng = np.random.default_rng(0)
    s = [p.state.RangeSortWorker(i) for i in range(3)]
    scopes = ["r0", "r1", "r2"]
    owner = {"r0": s[0], "r1": s[1], "r2": s[2]}
    values = rng.integers(0, 30, 300)
    for i, v in enumerate(values):
        scope = "r0" if v <= 10 else "r1" if v <= 20 else "r2"
        w = s[2] if scope == "r0" and i % 2 == 0 else owner[scope]
        w.process(scope, int(v))
    for w in s:
        w.on_end_marker(0, 2, owner)
        w.on_end_marker(1, 2, owner)
    out = p.state.merged_sorted_output(s, scopes)
    return out, [{k: list(v) for k, v in w.runs.items()} for w in s]


STATE_SCENARIOS = {
    "mutability": lambda p: dict(p.state.MUTABILITY),
    "hashjoin_replication": _hashjoin,
    "groupby_sbk": _groupby,
    "sort_scattered_merge": _sort,
    "migration_time": lambda p: [p.state.migration_time(b, bw, o)
                                 for b, bw, o in ((1000, 1000.0, 1.1),
                                                  (4096, 3.0e9, 1.0),
                                                  (123457, 7.5e8, 1.25))],
}


def _plain(x):
    """Dataclass instances of either package as (class name, fields)."""
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__,
                {f: _plain(getattr(x, f)) for f in x.__dataclass_fields__})
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("name", sorted(STATE_SCENARIOS))
def test_state_migration_identical(name):
    assert _plain(STATE_SCENARIOS[name](PORT)) == \
        _plain(STATE_SCENARIOS[name](REF))


def test_sort_merge_complete_on_the_port():
    out, runs = _sort(PORT)
    values = np.random.default_rng(0).integers(0, 30, 300)
    assert out == sorted(values.tolist())
    assert not runs[2].get("r0")


def test_helpers_and_transfer_identical():
    """Multi-helper selection and the SBK/SBR plans on fixed inputs."""
    def run(p):
        cands = [(3, 0.05), (1, 0.1), (5, 0.2), (2, 0.4)]
        chosen = [p.helpers.choose_helpers(0.6, cands, 1e4, left, 50.0,
                                           lambda n: 2.0 * n)
                  for left in (1e2, 1e3, 1e4)]
        logic = p.transfer.PartitionLogic.modulo(KEYS, 4)
        loads = {k: float(3 * k + 1) for k in KEYS}
        p.transfer.sbk_plan(loads, 2, 0, logic, 5.0)
        p.transfer.sbr_apply(logic, 3, 1,
                             p.transfer.sbr_fraction(30.0, 10.0))
        p.transfer.phase1_apply(logic, 1, 2)
        p.transfer.multi_sbr_apply(logic, 0, [(2, 0.25), (3, 0.25)])
        return (chosen, p.helpers.lr_max(0.6, [0.1, 0.2], 1e3),
                {k: list(v) for k, v in logic.assignment.items()},
                [p.transfer.keys_on(logic, w) for w in range(4)],
                [p.transfer.keys_owned(logic, w) for w in range(4)])

    assert run(PORT) == run(REF)


# -------------------------------------------------------- import guard

def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("repro", "jax", "jaxlib")]
    assert not bad, bad
