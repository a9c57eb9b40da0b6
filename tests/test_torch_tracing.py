"""The serve engine's spans and token marks (``runtime.tracing``).

* Every working ``ServeEngine.tick`` is one ``serve.tick`` span whose
  children are ``serve.poll``, ``serve.admit``, ``serve.plan``,
  ``serve.device`` (holding ``serve.dispatch`` and ``serve.collect``) and
  ``serve.commit``, in that order and apart; its attributes are the
  plan's.
* A request's marks count its visible tokens tick by tick, the first at
  ``t_first``.
* The ring keeps its bound and counts what it overwrote.
* Under a profiler only the host phases (poll, admit, plan, commit) are
  ``record_function`` ranges, and device work inside one (a prefix-cache
  row copy, a weight publish) lies outside every range; without a
  profiler no range is entered.
* On the card (``-m cuda``): no device event of a profiled graphed tick
  carries a ``serve.`` name, and the host phases are among the host
  events.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.models import lm
from repro_torch.runtime import tracing

MIRRORED = {"serve.poll", "serve.admit", "serve.plan", "serve.commit"}
UNMIRRORED = {"serve.tick", "serve.device", "serve.dispatch",
              "serve.collect", "serve.capture", "serve.rows",
              "serve.publish", "serve.alloc"}
PHASES = ["serve.poll", "serve.admit", "serve.plan", "serve.device",
          "serve.commit"]


@pytest.fixture(autouse=True)
def _cpu_numerics():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def _model(arch="yi-34b-smoke"):
    cfg = get_arch(arch)
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, (n,)).astype(np.int32) for n in lens]


def _serve(device="cpu", **kw):
    """Five requests of mixed lengths on 4 slots: prefill, full and
    compact decode ticks; the ring holds only this run's spans."""
    cfg, params = _model()
    eng = ServeEngine(cfg, params, max_len=64, slots=4, prefill_chunk=8,
                      decode_chunk=4, device=device, **kw)
    tracing.RECORDER.clear()
    reqs = [eng.submit(p, max_new=n) for p, n in zip(
        _prompts(cfg, [5, 13, 3, 9, 6]), [9, 4, 14, 6, 11])]
    eng.run_until_done()
    return eng, reqs, tracing.RECORDER.spans()


def _tree(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.t0)
    return kids


def test_one_tick_span_with_its_phases_in_order():
    eng, _, spans = _serve()
    kids = _tree(spans)
    ticks = [s for s in spans if s.name == "serve.tick"]
    work = [s for s in ticks if s.attrs["rows"]]
    assert len(work) == eng.tick_no > 0
    assert [s.attrs["tick_no"] for s in work] == list(range(eng.tick_no))
    for t in work:
        assert t.parent is None
        ch = kids[t.sid]
        assert [c.name for c in ch] == PHASES
        for a, b in zip(ch, ch[1:]):
            assert t.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= t.t1
        dev = ch[3]
        assert [c.name for c in kids[dev.sid]] == ["serve.dispatch",
                                                    "serve.collect"]
        d, c = kids[dev.sid]
        assert dev.t0 <= d.t0 <= d.t1 <= c.t0 <= c.t1 <= dev.t1
    # the run ends on an idle tick: poll, admit and plan only
    idle = [s for s in ticks if not s.attrs["rows"]]
    for t in idle:
        assert [c.name for c in kids.get(t.sid, [])] == PHASES[:3]


def test_tick_attributes_are_the_plans():
    cfg, params = _model()
    eng = ServeEngine(cfg, params, max_len=64, slots=8, prefill_chunk=8,
                      decode_chunk=4, compact_decode=True, device="cpu")
    plans = []
    plan_tick = eng._plan_tick

    def spy(*a):
        p = plan_tick(*a)
        plans.append(p)
        return p

    eng._plan_tick = spy
    tracing.RECORDER.clear()
    for p, n in zip(_prompts(cfg, [4, 12, 20, 6], seed=1), [20, 6, 12, 24]):
        eng.submit(p, max_new=n)
    eng.run_until_done()
    ticks = [s for s in tracing.RECORDER.spans()
             if s.name == "serve.tick" and s.attrs["rows"]]
    assert len(ticks) == len(plans)
    compact = 0
    for t, p in zip(ticks, plans):
        a = t.attrs
        assert (a["mode"], a["L"], a["rows"], a["height"], a["compact"],
                a["pool"], a["group"], a["device"]) == (
            p.mode, p.L, len(p.part), len(p.idx), p.compact, p.sp.lid, 0,
            "cpu")
        assert a["cold"] == p.job.meta["cold"]
        if p.compact:
            compact += 1
            assert a["height"] & (a["height"] - 1) == 0
            assert a["rows"] <= a["height"] < eng.slots
        else:
            assert a["height"] == eng.slots
        commit = [s for s in tracing.RECORDER.spans()
                  if s.name == "serve.commit" and s.parent == t.sid]
        assert len(commit) == 1 and commit[0].attrs["tokens"] >= 0
    assert compact == eng.compact_ticks > 0
    assert {t.attrs["mode"] for t in ticks} == {"prefill", "decode"}


def test_marks_count_the_visible_tokens():
    eng, reqs, spans = _serve()
    for r in reqs:
        assert r.marks and r.marks[0][0] == r.t_first
        counts = [n for _, n, _ in r.marks]
        assert counts[-1] == len(r.tokens) == r.max_new
        assert all(a < b for a, b in zip(counts, counts[1:]))
        times = [t for t, _, _ in r.marks]
        ticks = [k for _, _, k in r.marks]
        assert times == sorted(times) and ticks == sorted(set(ticks))
        assert r.marks[-1][0] <= r.t_done
    # a mark's tick is the tick whose commit made it
    commits = {}
    for s in spans:
        if s.name == "serve.tick" and s.attrs["rows"]:
            commits[s.attrs["tick_no"]] = s
    for r in reqs:
        for t, _, k in r.marks:
            assert commits[k].t0 <= t <= commits[k].t1


def test_result_cache_answer_is_one_mark():
    cfg, params = _model()
    eng = ServeEngine(cfg, params, max_len=64, slots=2, prefill_chunk=8,
                      decode_chunk=4, prefix_cache=True, device="cpu")
    p = _prompts(cfg, [10], seed=2)[0]
    first = eng.submit(p, max_new=5)
    eng.run_until_done()
    again = eng.submit(p, max_new=5)
    eng.run_until_done()
    assert again.tokens == first.tokens
    assert again.marks == [(again.t_first, 5, eng.tick_no)]


def test_ring_keeps_its_bound_and_counts_what_it_dropped():
    rec = tracing.Recorder(capacity=8)
    for i in range(20):
        with rec.span("s", i=i):
            pass
    got = rec.spans()
    assert [s.attrs["i"] for s in got] == list(range(12, 20))
    assert rec.written == 20 and rec.dropped == 12
    assert all(a.t1 <= b.t0 for a, b in zip(got, got[1:]))
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0
    with pytest.raises(ValueError):
        tracing.Recorder(capacity=0)


def test_threads_lose_no_span_and_nest_apart():
    """More writers than cores with a short switch interval: every span
    lands once, and each thread's spans nest inside its own."""
    import os
    import sys
    import threading
    rec = tracing.Recorder(capacity=1 << 16)
    n_threads, n = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()

    def work(k):
        for i in range(n):
            with rec.span("outer", k=k):
                with rec.span("inner", k=k):
                    pass

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = rec.spans()
    assert rec.written == len(got) == 2 * n * n_threads
    assert len({s.sid for s in got}) == len(got)
    by_id = {s.sid: s for s in got}
    for s in got:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "outer" and p.attrs["k"] == s.attrs["k"]
        else:
            assert s.parent is None


def test_nesting_and_explicit_times():
    rec = tracing.Recorder()
    with rec.span("outer") as o:
        inner = rec.span("inner").begin(5.0)
        with rec.span("leaf"):
            pass
        inner.end(6.0)
        o.attrs["k"] = 1
    leaf, inner_s, outer = rec.spans()
    assert (inner_s.t0, inner_s.t1) == (5.0, 6.0)
    assert leaf.parent == inner_s.sid and inner_s.parent == outer.sid
    assert outer.parent is None and outer.attrs == {"k": 1}


def test_a_span_left_open_by_an_exception_closes_with_its_parent():
    rec = tracing.Recorder()
    with pytest.raises(RuntimeError):
        with rec.span("outer"):
            rec.span("left").begin()
            raise RuntimeError("x")
    with rec.span("next"):
        pass
    names = [(s.name, s.parent) for s in rec.spans()]
    assert names[0][0] == "outer" and names[1] == ("next", None)


def _host_events(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def test_profiler_sees_the_host_phases_only():
    cfg, params = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng, _, spans = _serve(prefix_cache=True)
        # a publish while serving (its weights bound under serve.publish)
        eng.update(params=lm.init(cfg, torch.Generator().manual_seed(1),
                                  device="cpu"))
        for p in _prompts(cfg, [7, 7], seed=3):
            eng.submit(p, max_new=3)
        eng.run_until_done()
    names = {n for n, _, _ in _host_events(prof)}
    assert MIRRORED <= names
    assert not {n for n in names if n.startswith("serve.")} - MIRRORED
    recorded = {s.name for s in tracing.RECORDER.spans()}
    assert {"serve.rows", "serve.publish", "serve.alloc"} <= recorded


def test_work_inside_a_host_phase_lies_outside_its_range():
    """A span that is not mirrored closes the ranges of the mirrored spans
    it lies in, so an operation inside it is inside none of them; the
    mirrored span's range opens again after it."""
    rec = tracing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("serve.commit", mirror=True):
            torch.ones(4).add_(1)
            with rec.span("serve.rows"):
                with rec.span("serve.plan", mirror=True):
                    pass
                torch.ones(8).mul_(3)
            torch.ones(4).sub_(1)
    ev = _host_events(prof)
    ranges = [(a, b) for n, a, b in ev if n == "serve.commit"]
    assert len(ranges) == 2
    mul = [(a, b) for n, a, b in ev if n == "aten::mul_"]
    add = [(a, b) for n, a, b in ev if n == "aten::add_"]
    sub = [(a, b) for n, a, b in ev if n == "aten::sub_"]
    inside = lambda x: any(a <= x[0][0] and x[0][1] <= b for a, b in ranges)
    assert not inside(mul) and inside(add) and inside(sub)
    # a mirrored span inside one that is not mirrored has its own range
    assert sum(n == "serve.plan" for n, _, _ in ev) == 1
    assert [s.name for s in rec.spans()] == ["serve.plan", "serve.rows",
                                             "serve.commit"]


def test_no_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    _serve()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _serve()
    assert set(entered) == MIRRORED


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_no_device_event_carries_a_serve_name(cuda):
    """A few graphed ticks of a tiny model profiled with CPU and CUDA
    activities: the host phases are host events; no device event (kernel,
    copy, fill or a range's device-side annotation) is named ``serve.``."""
    cfg, params = _model("paper-moe-100m-smoke")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, fused_gating=True, fused_dispatch=True))
    eng = ServeEngine(cfg, params, max_len=64, slots=4, prefill_chunk=8,
                      decode_chunk=4, device=cuda)
    prompts = _prompts(cfg, [5, 13, 3, 9, 6])
    for p in prompts:
        eng.submit(p, max_new=6)
    eng.run_until_done()                      # captures every height
    for p in prompts:
        eng.submit(p, max_new=10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_until_done()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    dev = [e for e in events if "CUDA" in str(e.device_type())]
    host = [e for e in events if "CUDA" not in str(e.device_type())]
    bad = sorted({e.name() for e in dev if e.name().startswith("serve.")})
    got = {e.name() for e in host if e.name().startswith("serve.")}
    print(f"[tracing] {len(events)} events, {len(dev)} on the device, "
          f"host serve. names {sorted(got)}, device serve. names {bad}")
    assert dev and not bad
    assert got == MIRRORED
