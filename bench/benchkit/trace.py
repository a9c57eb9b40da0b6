"""The traced sub-window of a ``--trace 1`` run, read in memory (no trace
file is written).

``Tracer`` starts ``torch.profiler`` (CPU and CUDA activities) at a tick
boundary and stops it at a later one; meanwhile the client wraps every
tick in a ``bench.tick`` span.  Starting and stopping the profiler stall
the client for seconds, so the host-clock metrics of a traced run leave
out the ticks in the interval the profiler was on (``span``;
``untraced``).  A trace can lose the records of its very
start, so the sub-window opens at the second traced tick and closes at the
end of the last.  ``read`` gives the device's busy seconds in it (the
union of every kernel, copy and fill), the device operations that took
most time and the idle gaps labelled by what the host was doing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

# a device operation's name in the breakdown is cut to this many letters
NAME_CHARS = 160
# ticks a traced sub-window holds at least (the first is left out)
MIN_TICKS = 3


class Tracer:
    def __init__(self, client, start: float, stop: float):
        self.client = client
        self.start, self.stop = start, stop
        self.prof = None
        self.done = False
        self.seen = {}
        # host-clock interval the profiler was on, its start and stop
        # included (they take seconds)
        self.span = None

    @staticmethod
    def prime() -> None:
        """A first, throw-away profiler session (set-up): the first session
        of a process can lose its device records while the profiler's
        device tracing starts up."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            x = torch.ones(1024, device="cuda" if len(acts) > 1 else "cpu")
            (x * 2).sum().item()

    def on_tick(self, now: float) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        if self.prof is None and not self.done and now >= self.start:
            self.span = [now, None]
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            # the sub-window's length counts from when the profiler is on
            # (starting it takes seconds)
            self.stop = self.client.clock() + (self.stop - self.start)
            self.client.span = record_function
            self.client.tracing = True
        elif self.prof is not None and not self.done and now >= self.stop \
                and sum(t.traced for t in self.client.ticks) >= MIN_TICKS:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.client.span = _null
            self.client.tracing = False
            self.done = True
            self.span[1] = self.client.clock()

    def close(self) -> None:
        """Stop a profiler the window's end left running."""
        if self.prof is not None and not self.done:
            self.on_tick(float("inf"))

    def read(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        ticks = [t for t in self.client.ticks if t.traced]
        self.seen = {"events": len(events), "traced_ticks": len(ticks),
                     "device_events": sum(map(_is_device, events)),
                     "tick_spans": sum(e.name() == "bench.tick" and
                                       not _is_device(e) for e in events)}
        return read_events(events, ticks)


class _null:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def untraced(ticks, span):
    """The ticks a traced run's host-clock metrics read: those outside the
    profiler's interval ``span``."""
    if span is None:
        return ticks
    a, b = span
    return [t for t in ticks if t.t1 <= a or t.t0 >= b]


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _merge(iv: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def read_events(events, ticks) -> Optional[Dict]:
    """The sub-window's readings from the profiler's events (times in
    seconds of the profiler's clock): ``busy_s``, ``window_s`` and the
    ``breakdown``."""
    spans, dev, cpu = [], [], []
    for e in events:
        name = e.name()
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if _is_device(e):
            if not name.startswith("bench."):
                dev.append((a, b, name[:NAME_CHARS]))
        elif name == "bench.tick":
            spans.append((a, b))
        else:
            cpu.append((a, b, name))
    spans.sort()
    # a trace can lose the records of its start: the spans left are the
    # last ticks'
    if len(spans) < 2 or len(spans) > len(ticks):
        return None
    w0, w1 = spans[1][0], spans[-1][1]
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
           if b > w0 and a < w1]
    if not dev:
        return None
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += b - a
    starts = [s[0] for s in spans]

    cpu.sort()
    cstarts = [c[0] for c in cpu]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        in_tick = i >= 0 and spans[i][1] >= mid
        gaps[("tick: " + _innermost(cpu, cstarts, mid)) if in_tick
             else "client"] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_s, "window_s": w1 - w0,
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(gaps)}}


def _innermost(cpu, cstarts, t: float, back: int = 400) -> str:
    """The shortest host event that holds ``t`` (what the host was doing),
    among the ``back`` events that began last before it."""
    i = bisect.bisect_right(cstarts, t)
    best = None
    for a, b, n in cpu[max(0, i - back):i]:
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, n)
    return best[2] if best else "host"
