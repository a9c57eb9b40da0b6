"""The port's knob autotuner (``engine/autotune.py``, a copy of the
reference's) on the port's engine: the reference's tests/test_autotune.py.

Convergence is proven with a synthetic cost function (no wall clock):
a forced bad chunk and a forced bad ``spec_len`` recover, warm-up windows
are discarded, two knobs converge round-robin, a window that committed
nothing is dropped.  ``Engine.choose_knob`` bootstraps every arm,
exploits and re-explores.  The update handlers clamp, the class-weight
knob leaves the aging bound alone, ``update(autotune=...)`` toggles the
tuner, and an engine tuning ``spec_len``, ``prefill_chunk`` and
``compact_frac`` every 2 work ticks still equals ``generate_static``.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.engine import jobs as j_jobs
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.configs.base import PriorityClass
from repro_torch.engine import jobs as J
from repro_torch.engine.autotune import AutoTuner, Knob, default_knobs
from repro_torch.engine.engine import Engine
from repro_torch.engine.serve import ServeEngine
from repro_torch.models import bridge
from repro_torch.runtime.serve import BatchedServer

from conftest import PYTEST_SEED

CFG = get_arch("gemma3-1b-smoke")
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _cpu_numerics():
    """One torch thread (smoke-size ops run fastest so, and the suite's
    parallel workers would otherwise oversubscribe the cores), and the
    native GEMM, whose rows do not depend on the batch height (see
    tests/test_torch_compact.py)."""
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


@lru_cache(maxsize=None)
def _fixture():
    params = jax.jit(j_lm.init, static_argnums=0)(
        j_get_arch("gemma3-1b-smoke"), jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return tp, BatchedServer(CFG, tp, max_len=MAX_LEN, device="cpu")


def _engine(**kw):
    return ServeEngine(CFG, _fixture()[0], max_len=MAX_LEN, device="cpu",
                       **kw)


def _synthetic_tuner(eng, costmap, name="prefill_chunk", window=1,
                     key="prefill_chunk"):
    """A tuner whose window cost is a function of the live knob value."""
    knob = Knob(name, tuple(sorted(costmap)), key=key)
    tuner = AutoTuner(eng, knobs=[knob], window=window, warmup=0,
                      measure=lambda stats: costmap[getattr(eng, key)])
    eng.autotuner = tuner
    return tuner


# ------------------------------------------------------------ choose_knob

def test_choose_knob_bootstrap_covers_every_arm():
    e = Engine()
    values = (1, 2, 4, 8)
    seen = []
    for v in values:
        got = e.choose_knob("k", values)
        seen.append(got)
        assert isinstance(got, int)
        e.costs.observe(J.knob_kind("k", got), float(10 - got))
    assert seen == list(values)
    assert e.choose_knob("k", values) == 8


def test_choose_knob_reexplores_losers():
    e = Engine()
    values = (1, 2)
    e.costs.observe(J.knob_kind("k", 1), 5.0)
    e.costs.observe(J.knob_kind("k", 2), 1.0)
    picks = [e.choose_knob("k", values) for _ in range(32)]
    assert picks.count(1) == 2
    assert all(p == 2 for i, p in enumerate(picks) if (i + 1) % 16 != 0)
    deq = [d for d in e.decisions if d["decision"] == "autotune_knob"]
    assert any(d.get("why") == "re-explore" for d in deq)


def test_knob_kinds_equal_reference():
    for name, v in (("spec_len", 4), ("compact_frac", 0.25),
                    ("weight:hi", 8.0), ("prefill_chunk", 16)):
        assert J.knob_kind(name, v) == j_jobs.knob_kind(name, v)
    assert J.knob_kind("spec_len", 4) != J.knob_kind("spec_len", 8)


# --------------------------------------------------- synthetic convergence

def test_forced_bad_chunk_recovers():
    eng = _engine(slots=2, prefill_chunk=16, decode_chunk=2)
    tuner = _synthetic_tuner(eng, {1: 5.0, 4: 2.0, 16: 1.0})
    eng._apply_updates({"prefill_chunk": 1})
    tuner.current["prefill_chunk"] = 1
    for _ in range(10):
        tuner.on_tick()
    assert tuner.current["prefill_chunk"] == 16 and eng.prefill_chunk == 16


def test_forced_bad_spec_len_recovers():
    eng = _engine(slots=2, prefill_chunk=8, decode_chunk=2,
                  spec_decode=True)
    costmap = {2: 3.0, 4: 1.0, 8: 2.0}
    tuner = AutoTuner(eng, knobs=[Knob("spec_len", (2, 4, 8),
                                       key="spec_len")],
                      window=1, warmup=0,
                      measure=lambda s: costmap[eng.spec_len])
    eng.autotuner = tuner
    eng._apply_updates({"spec_len": 8})
    tuner.current["spec_len"] = 8
    for _ in range(10):
        tuner.on_tick()
    assert tuner.current["spec_len"] == 4 and eng.spec_len == 4


def test_warmup_windows_discarded():
    eng = _engine(slots=2, prefill_chunk=16, decode_chunk=2)
    calls = []

    def measure(stats):
        calls.append(eng.prefill_chunk)
        return 1.0

    tuner = AutoTuner(eng, knobs=[Knob("prefill_chunk", (1, 16),
                                       key="prefill_chunk")],
                      window=1, warmup=1, measure=measure)
    eng.autotuner = tuner
    tuner.on_tick()                      # measures settled 16, moves to 1
    assert eng.prefill_chunk == 1
    n = len(calls)
    tuner.on_tick()                      # warm-up under 1: not measured
    assert len(calls) == n
    tuner.on_tick()                      # settled 1: measured
    assert len(calls) == n + 1 and calls[-1] == 1


def test_round_robin_coordinate_descent():
    eng = _engine(slots=2, prefill_chunk=16, decode_chunk=2)
    cost = lambda s: ({1: 3.0, 16: 1.0}[eng.prefill_chunk]
                      + {0.25: 0.5, 0.75: 0.0}[eng.compact_frac])
    tuner = AutoTuner(
        eng, knobs=[Knob("prefill_chunk", (1, 16), key="prefill_chunk"),
                    Knob("compact_frac", (0.25, 0.75), key="compact_frac")],
        window=1, warmup=0, measure=cost)
    eng.autotuner = tuner
    eng._apply_updates({"prefill_chunk": 1, "compact_frac": 0.25})
    tuner.current.update({"prefill_chunk": 1, "compact_frac": 0.25})
    for _ in range(14):
        tuner.on_tick()
    assert tuner.current == {"prefill_chunk": 16, "compact_frac": 0.75}


def test_starved_window_dropped_not_scored():
    eng = _engine(slots=2, prefill_chunk=16, decode_chunk=2)
    tuner = AutoTuner(eng, knobs=[Knob("prefill_chunk", (1, 16),
                                       key="prefill_chunk")],
                      window=1, warmup=0)
    assert tuner._measure_wall({"wall_s": 1.0, "tokens": 0.0,
                                "ticks": 4.0}) is None
    assert tuner._measure_wall({"wall_s": 1.0, "tokens": 4.0,
                                "ticks": 4.0}) == 0.25


# ------------------------------------------------------------ knob plumbing

def test_update_handlers_clamp_and_apply():
    eng = _engine(slots=2, prefill_chunk=8, decode_chunk=2)
    eng._apply_updates({"spec_len": 6})
    assert eng.spec_len == 6
    eng._apply_updates({"spec_len": -3})
    assert eng.spec_len == 0
    eng._apply_updates({"compact_frac": 1.7})
    assert eng.compact_frac == 1.0
    eng._apply_updates({"compact_frac": -0.5})
    assert eng.compact_frac == 0.0
    eng._apply_updates({"compact_decode": True})
    assert eng.compact_decode is True
    eng._apply_updates({"compact_decode": None})
    assert eng.compact_decode is None
    eng._apply_updates({"class_weights": {"default": 9.0}})
    assert eng.classes["default"].weight == 9.0
    with pytest.raises(ValueError):
        eng._apply_updates({"class_weights": {"nope": 1.0}})


def test_autotune_hot_toggle_via_update():
    eng = _engine(slots=2, prefill_chunk=8, decode_chunk=2)
    assert eng.autotuner is None
    eng.update(autotune={"window": 2, "warmup": 0})
    eng.tick()                                 # applied at the boundary
    assert eng.autotuner is not None and eng.autotuner.window == 2
    assert eng._inspect("all")["autotune"]["enabled"]
    eng._apply_updates({"autotune": False})
    assert eng.autotuner is None
    assert eng._inspect("all")["autotune"] == {"enabled": False}


def test_default_knobs_shape():
    eng = _engine(slots=2, prefill_chunk=8, decode_chunk=2,
                  spec_decode=True)
    knobs = {k.name: k for k in default_knobs(eng)}
    assert "prefill_chunk" in knobs and "compact_frac" in knobs
    assert all(v <= 8 for v in knobs["prefill_chunk"].values)
    assert "spec_len" in knobs
    assert not any(n.startswith("weight:") for n in knobs)


def test_class_weight_knob_wrap():
    cfg = dataclasses.replace(CFG, serve=dataclasses.replace(
        CFG.serve, classes=(PriorityClass("a", 1.0, 4),
                            PriorityClass("b", 2.0, 8))))
    eng = ServeEngine(cfg, _fixture()[0], max_len=MAX_LEN, slots=2,
                      prefill_chunk=8, decode_chunk=2, device="cpu")
    knobs = {k.name: k for k in default_knobs(eng)}
    kb = knobs["weight:b"]
    assert kb.current(eng) == 2.0
    eng._apply_updates(kb.updates(4.0))
    assert eng.classes["b"].weight == 4.0 and kb.current(eng) == 4.0
    assert eng.classes["b"].max_defer == 8
    assert eng._inspect("all")["knobs"]["class_weights"] == {"a": 1.0,
                                                             "b": 4.0}


# ------------------------------------------- greedy output under tuning

def test_tuning_preserves_greedy_bit_identicality():
    """An engine tuning spec_len, prefill_chunk and compact_frac every 2
    work ticks (warm-up 0: the worst churn) equals the static loop."""
    eng = _engine(slots=3, prefill_chunk=8, decode_chunk=2,
                  spec_decode=True,
                  autotune={"window": 2, "warmup": 0, "knobs": [
                      Knob("spec_len", (2, 4, 8), key="spec_len"),
                      Knob("prefill_chunk", (1, 4, 8), key="prefill_chunk"),
                      Knob("compact_frac", (0.25, 0.5, 0.75),
                           key="compact_frac")]})
    srv = _fixture()[1]
    rng = np.random.default_rng(PYTEST_SEED + 4242)
    prompts = [rng.integers(1, CFG.vocab, (int(rng.integers(2, 13)),))
               .astype(np.int32) for _ in range(7)]
    max_news = [int(rng.integers(1, 9)) for _ in prompts]
    reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, max_news)]
    ticks = 0
    while eng.queue or any(r is not None for r in eng.active):
        assert eng.tick() and ticks < 2000
        ticks += 1
    assert eng.autotuner.windows > 3 and eng.autotuner.moves >= 1
    for p, n, r in zip(prompts, max_news, reqs):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(p[None], n)[0],
            err_msg=f"plen={len(p)} max_new={n} "
                    f"tuner={eng.autotuner.snapshot()}")
