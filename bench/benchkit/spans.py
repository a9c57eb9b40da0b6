"""The program's own spans and marks, as the per-layer metrics of the
engine's tick read them.

The program records a ``serve.tick`` span around every
``ServeEngine.tick`` call, its phases inside it, a ``serve.capture`` span
around every step graph it captures (``repro_torch.runtime.tracing``,
always on, in memory), and a mark ``(time, len(tokens), tick_no)`` on a
request each time its visible tokens grow (``Request.marks``).  All are
on the host's ``perf_counter``, the client's clock.

``ticks(run)`` gives the window's ticks as the program recorded them:
the ``serve.tick`` spans that lie inside one of ``run["ticks"]`` (the
window's ticks outside the profiler's interval), non-idle, not ``cold``
(a first run of a shape, or one that captured a graph) and of a pool on
a card, each with its child spans by name.  A CPU tick's times are the
host's and never a card's, so a run on the CPU reads nothing (``device``
names another device type, for the tests).  Everything here returns None
where the program records no spans (a program without the recorder) or
where the ring dropped a span a reading needs.
"""
from __future__ import annotations

import bisect
import sys
from typing import Dict, List, NamedTuple, Optional


class Tick(NamedTuple):
    span: object                 # the serve.tick span
    kids: Dict[str, list]        # its child spans by name

    def child_s(self, name: str) -> float:
        return sum(s.dur for s in self.kids.get(name, ()))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    return getattr(tracing, "RECORDER", None)


def _horizon(rec, spans) -> float:
    """A time every dropped span ended at or before (the ring keeps spans
    in the order they end): a span that began after it lost no child."""
    return spans[0].t1 if rec.dropped and spans else float("-inf")


def ticks(run, device: str = "cuda") -> Optional[List[Tick]]:
    """The window's kept ticks (see the module's docstring), or None where
    a window tick has no ``serve.tick`` span or lies where the ring
    dropped spans."""
    rec = recorder()
    if rec is None:
        return None
    spans = rec.spans()
    horizon = _horizon(rec, spans)
    client = sorted((t for t in run["ticks"] if t.rows),
                    key=lambda t: t.t0)
    if not client or client[0].t0 <= horizon:
        return None
    starts = [t.t0 for t in client]
    found = [None] * len(client)
    kids: Dict[int, Dict[str, list]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, {}).setdefault(s.name, []).append(s)
    for s in spans:
        if s.name != "serve.tick":
            continue
        i = bisect.bisect_right(starts, s.t0) - 1
        if i >= 0 and s.t1 <= client[i].t1 and s.attrs.get("rows"):
            found[i] = s
    if any(s is None for s in found):
        return None
    return [Tick(s, kids.get(s.sid, {})) for s in found
            if not s.attrs.get("cold") and s.attrs.get("device") == device]


def captures(run) -> Optional[List[object]]:
    """Every ``serve.capture`` span the program recorded, or None where it
    records none or the ring dropped spans (a capture can come at any
    time from the process's start)."""
    rec = recorder()
    if rec is None or rec.dropped:
        return None
    return [s for s in rec.spans() if s.name == "serve.capture"]


def token_gaps(run, device: str = "cuda") -> Optional[List[float]]:
    """The gaps, in seconds, between successive marks of the sampled
    requests whose every tick in between is one of ``ticks(run)``."""
    kept = ticks(run, device)
    if kept is None:
        return None
    window = {t.span.attrs["tick_no"] for t in kept}
    gaps = []
    for rec in run["sampled"]:
        marks = getattr(rec.req, "marks", None)
        if marks is None:
            return None
        for (ta, _, a), (tb, _, b) in zip(marks, marks[1:]):
            if all(k in window for k in range(a + 1, b + 1)):
                gaps.append(tb - ta)
    return gaps


def step_ms(run, which, device: str = "cuda") -> Optional[float]:
    """The summed ``serve.device`` spans of the window's ticks whose mode
    ``which`` accepts over their summed ``L``, in ms."""
    ts = [t for t in ticks(run, device) or ()
          if which(t.span.attrs["mode"])]
    steps = sum(t.span.attrs["L"] for t in ts)
    if not steps:
        return None
    return 1e3 * sum(t.child_s("serve.device") for t in ts) / steps
