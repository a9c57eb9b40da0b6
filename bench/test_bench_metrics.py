"""The metric arithmetic on synthetic ticks: the window's tokens, tick
times, rows and MFU, the idle share from intervals and the idle gaps by
what the host was doing, and the FLOPs of a run of positions."""
import types

import pytest

import bench_tiny
from bench_tiny import torch_cpu  # noqa: F401 (fixture)
from benchkit import drive, trace, yardstick
from benchkit.spec import Spec

CFG = dict(bench_tiny.TINY_CONFIGS["tiny-llama"])
SPEC = Spec(bench_tiny.BENCH.parent)


def run_of(ticks=(), trace_=None, open_=0.0, close=10.0):
    return {"sampled": [], "ticks": list(ticks), "open": open_,
            "close": close, "trace": trace_, "setup_s": 3.5}


def test_window_tick_metrics():
    ticks = [drive.TickRec(0.0, 0.5, rows=4, positions=16, flops=4e12,
                           gen=10),
             drive.TickRec(0.5, 0.6),              # idle: left out
             drive.TickRec(0.6, 1.1, rows=2, positions=8, flops=1e12,
                           gen=6)]
    run = run_of(ticks, open_=0.0, close=2.0)
    assert SPEC.reader("gen_tok_s")(run) == pytest.approx(8.0)
    assert SPEC.reader("tick_ms.batch")(run) == pytest.approx(500.0)
    assert SPEC.reader("rows_per_tick.batch")(run) == pytest.approx(3.0)
    assert SPEC.reader("mfu.batch")(run) == pytest.approx(
        100 * 5e12 / (1.0 * 989e12))
    assert SPEC.reader("setup_s")(run) == 3.5


def test_flops_of_positions_is_the_sum_over_positions():
    got = yardstick.flops_of_positions(CFG, 5, 17)
    want = sum(yardstick.flops_per_position(CFG, i + 1) for i in range(5, 17))
    assert got == pytest.approx(want)
    assert yardstick.flops_of_positions(CFG, 7, 7) == 0.0


@pytest.mark.parametrize("ctx", [1, 517, 3088])
def test_frozen_flops_equal_the_programs_today(ctx):
    """The frozen copy is the program's ``fwd_flops_per_token`` (dense
    blocks) at each configuration the benchmark runs and the tiny one."""
    from benchkit import model
    from repro_torch.analysis.flops import fwd_flops_per_token
    for cfg in [SPEC.config(c["name"]) for c in SPEC.bench["configs"]] + \
            [CFG]:
        assert yardstick.flops_per_position(cfg, ctx) == pytest.approx(
            fwd_flops_per_token(model.arch_config(cfg), ctx), rel=1e-12)


class Ev:
    """A profiler event as ``trace.read_events`` reads it."""
    def __init__(self, name, a, b, device):
        self._n, self._a, self._b, self._d = name, a, b, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._a * 1e9

    def duration_ns(self):
        return (self._b - self._a) * 1e9

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def _trace(kernels):
    ticks = [types.SimpleNamespace(height=8), types.SimpleNamespace(
        height=4), types.SimpleNamespace(height=4)]
    ev = [Ev("bench.tick", 0.0, 0.1, False), Ev("bench.tick", 0.2, 1.2,
                                                  False),
          Ev("bench.tick", 1.3, 2.2, False), Ev("aten::copy_", 0.55, 0.75,
                                                False)]
    ev += [Ev(n, a, b, True) for n, a, b in kernels]
    return trace.read_events(ev, ticks)


def test_idle_share_from_intervals():
    got = _trace([("k1", 0.2, 0.6), ("k2", 0.7, 1.15), ("k3", 1.3, 1.8),
                  ("k4", 1.5, 1.6), ("early", 0.0, 0.1)])
    # the sub-window is [0.2, 2.2]: from the second traced tick on
    assert got["window_s"] == pytest.approx(2.0)
    assert got["busy_s"] == pytest.approx(1.35)
    run = run_of(trace_=got)
    assert SPEC.reader("idle_share.batch")(run) == pytest.approx(32.5)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"tick: aten::copy_": 0.1, "client": 0.15,
                                  "tick: host": 0.4})


def test_lost_start_reads_nothing():
    """Fewer tick spans than one past the first: nothing to read."""
    ticks = [types.SimpleNamespace(height=8)]
    ev = [Ev("bench.tick", 0.0, 0.1, False), Ev("k", 0.0, 0.1, True)]
    assert trace.read_events(ev, ticks) is None


def test_untraced_leaves_out_the_profilers_ticks():
    ticks = [drive.TickRec(0.0, 1.0), drive.TickRec(1.0, 2.0),
             drive.TickRec(2.0, 3.0), drive.TickRec(3.5, 4.0)]
    assert trace.untraced(ticks, (1.5, 3.2)) == [ticks[0], ticks[3]]
    assert trace.untraced(ticks, None) == ticks


def test_no_trace_reads_nothing():
    assert SPEC.reader("idle_share.batch")(run_of()) is None
