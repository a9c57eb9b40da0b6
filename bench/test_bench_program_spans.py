"""The readers of the program's spans and marks (``benchkit.spans`` and
the six metrics on it) on synthetic spans: the window's ticks only, those
in the profiler's interval left out, the None cases; and a tiny traced
run on the CPU, where the six read nothing (a CPU tick is not a card's)
and the same readers over that run's CPU ticks read what the tiny cell
gives."""
import importlib.util
import time
import types

import pytest

import bench_tiny
from bench_tiny import torch_cpu  # noqa: F401 (fixture)
from benchkit import drive, spans
from benchkit.spec import Spec
from repro_torch.runtime import tracing

SPEC = Spec(bench_tiny.BENCH.parent)
SIX = ["host_ms.batch", "prefill_step_ms.batch", "decode_step_ms.batch",
       "row_use.batch", "token_gap_p90_ms.batch", "capture_s.batch"]


def _tick(rec, t0, dur, dev, tick_no, mode, L, rows, height, cold=False,
          device="cuda"):
    """A serve.tick span at ``t0`` of ``dur`` s whose serve.device span
    takes ``dev`` s from 10 % in."""
    s = rec.span("serve.tick", tick_no=tick_no, rows=rows, device=device,
                 mode=mode, L=L, height=height, cold=cold).begin(t0)
    d = rec.span("serve.device").begin(t0 + 0.1 * dur)
    d.end(t0 + 0.1 * dur + dev)
    s.end(t0 + dur)


class World:
    """Ticks of 1 s from t = 100: tick k on [100 + k, 100 + k + 0.9].
    0, 1: prefill (L 16, 8 rows of 8, device 0.8 s), 2-5: decode (L 4, 3
    rows of 4, device 0.4 s; 5 speculative), 6 is cold, 7 idle; a graph
    captured in set-up and one between ticks 2 and 3; the client saw 0-7,
    the profiler was on over 3 and 4.  Spans are written in the order they
    end, as the program writes them."""

    def __init__(self, capacity=tracing.CAPACITY):
        self.rec = tracing.Recorder(capacity)
        c = self.rec.span("serve.capture", pool=0, step="step", rows=8)
        c.begin(10.0)
        c.end(12.5)
        for k in range(7):
            if k == 3:
                # a capture in the window, between ticks 2 and 3
                c = self.rec.span("serve.capture", pool=0, step="step",
                                  rows=2)
                c.begin(102.92)
                c.end(102.95)
            pre = k < 2
            _tick(self.rec, 100.0 + k, 0.9, 0.8 if pre else 0.4, k,
                  "prefill" if pre else ("decode" if k != 5 else
                                         "spec:ngram"),
                  16 if pre else 4, 8 if pre else 3, 8 if pre else 4,
                  cold=k == 6)
        s = self.rec.span("serve.tick", tick_no=7, rows=0,
                          device="cuda").begin(107.0)
        s.end(107.1)
        client = [drive.TickRec(100.0 + k - 0.01, 100.0 + k + 0.95,
                                rows=0 if k == 7 else 3)
                  for k in range(8)]
        self.client = client
        # marks of two requests: one every tick 0-6, one at ticks 1, 2, 5
        reqs = [types.SimpleNamespace(marks=[(100.85 + k, k + 1, k)
                                             for k in range(7)]),
                types.SimpleNamespace(marks=[(101.85, 1, 1), (102.85, 2, 2),
                                             (105.85, 3, 5)])]
        self.run = {"open": 99.0, "close": 108.0, "setup_s": 1.0,
                    "trace": None,
                    "ticks": [t for i, t in enumerate(client)
                              if i not in (3, 4)],
                    "sampled": [types.SimpleNamespace(req=r) for r in reqs]}


@pytest.fixture
def world(monkeypatch):
    w = World()
    monkeypatch.setattr(spans, "recorder", lambda: w.rec)
    return w


def read(name, run, **kw):
    return SPEC.reader(name)(run, **kw)


def test_tick_readers_read_the_windows_warm_ticks(world):
    kept = spans.ticks(world.run)
    # 3 and 4 in the profiler's interval, 6 cold, 7 idle
    assert [t.span.attrs["tick_no"] for t in kept] == [0, 1, 2, 5]
    assert read("host_ms.batch", world.run) == pytest.approx(
        1e3 * (0.1 + 0.1 + 0.5 + 0.5) / 4)
    assert read("prefill_step_ms.batch", world.run) == pytest.approx(
        1e3 * 1.6 / 32)
    # decode and speculative ticks
    assert read("decode_step_ms.batch", world.run) == pytest.approx(
        1e3 * 0.8 / 8)
    assert read("row_use.batch", world.run) == pytest.approx(
        100.0 * (2 * 8 * 16 + 2 * 3 * 4) / (2 * 8 * 16 + 2 * 4 * 4))


def test_token_gaps_leave_out_ticks_outside_the_window(world):
    # request 1: gaps into ticks 1, 2 and 5 count (3, 4 traced; 6 cold);
    # request 2: 1 -> 2 counts, 2 -> 5 spans the traced 3 and 4
    assert sorted(spans.token_gaps(world.run)) == pytest.approx(
        [1.0, 1.0, 1.0, 1.0])
    # under 100 gaps: nothing
    assert read("token_gap_p90_ms.batch", world.run) is None


def test_token_gap_p90_is_the_nearest_rank(world, monkeypatch):
    gaps = [0.001 * (i + 1) for i in range(200)]
    monkeypatch.setattr(spans, "token_gaps", lambda run, device: list(gaps))
    assert read("token_gap_p90_ms.batch", world.run) == pytest.approx(180.0)


def test_capture_s_sums_set_ups_captures(world, capsys):
    assert read("capture_s.batch", world.run) == pytest.approx(2.5)
    assert "1 captures in the window" in capsys.readouterr().err


def test_none_without_the_programs_spans(world, monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: None)
    for name in SIX:
        assert read(name, world.run) is None


def test_none_where_a_window_tick_has_no_span(world):
    run = dict(world.run, ticks=world.run["ticks"] + [
        drive.TickRec(120.0, 121.0, rows=2)])
    for name in SIX[:5]:
        assert read(name, run) is None


def test_none_where_the_ring_dropped_what_a_reading_needs(monkeypatch):
    """17 spans: a ring of 16 drops set-up's capture; one of 14 also tick
    0's two spans.  A window tick that began before the oldest kept span
    ended may have lost a child: the readings that need it read None."""
    for cap, first in ((16, 1), (14, 2)):
        w = World(capacity=cap)
        monkeypatch.setattr(spans, "recorder", lambda: w.rec)
        assert w.rec.dropped == 17 - cap
        assert read("capture_s.batch", w.run) is None
        for k in range(first):
            run = dict(w.run, ticks=w.run["ticks"][k:])
            assert read("host_ms.batch", run) is None
            assert read("token_gap_p90_ms.batch", run) is None
        run = dict(w.run, ticks=w.run["ticks"][first:])
        assert read("host_ms.batch", run) is not None


def test_a_ticks_device_type_decides(world):
    for name in SIX[:4]:
        assert read(name, world.run, device="cpu") is None
    assert spans.ticks(world.run, device="cpu") == []


def test_tiny_traced_run_on_the_cpu(tmp_path):
    """The six are absent from a traced run on the CPU; over the same
    run's CPU ticks the readers read what the tiny cell gives (no graph,
    so no capture)."""
    root = bench_tiny.make_root(tmp_path)
    runs = []

    class Keep(Spec):
        def reader(self, name):
            f = super().reader(name)

            def read_(run):
                runs.append(run)
                return f(run)
            return read_

    spec_ = importlib.util.spec_from_file_location(
        "bench_run_spans", bench_tiny.BENCH / "run.py")
    bench_run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(bench_run)
    out = bench_run.run_cell(Keep(root), "tiny-llama.closed", 2 ** 31 + 21,
                             1.0, True, device="cpu", t0=time.perf_counter())
    assert out["correct"]
    assert not set(out["metrics"]) & set(SIX)
    run = runs[0]
    # every window tick has its span; the kept ones are the warm ones,
    # each inside the client's own timing of it
    kept = spans.ticks(run, device="cpu")
    assert (kept is None) == (not any(t.rows for t in run["ticks"]))
    kept = kept or []
    assert all(not t.span.attrs["cold"] for t in kept)
    for t in kept:
        c, = [c for c in run["ticks"] if c.t0 <= t.span.t0 <= c.t1]
        assert t.span.t1 <= c.t1 and t.child_s("serve.device") < t.span.dur
    got = {n: SPEC.reader(n)(run, device="cpu") for n in SIX[:5]}
    # each reads what the run's ticks hold (how many a loaded machine
    # fits in the tiny window varies)
    modes = [t.span.attrs["mode"] for t in kept]
    assert (got["host_ms.batch"] is None) == (not kept)
    assert (got["row_use.batch"] is None) == (not kept)
    assert (got["prefill_step_ms.batch"] is None) == ("prefill" not in modes)
    assert (got["decode_step_ms.batch"] is None) == (
        not any(m != "prefill" for m in modes))
    assert all(v is None or v > 0 for v in got.values())
    assert got["row_use.batch"] is None or got["row_use.batch"] <= 100
    gaps = spans.token_gaps(run, device="cpu") or []
    assert all(g > 0 for g in gaps)
    assert (got["token_gap_p90_ms.batch"] is None) == (len(gaps) < 100)
    assert SPEC.reader("capture_s.batch")(run) is None
