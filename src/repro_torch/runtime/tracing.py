"""The engine's span recorder: timed spans of the serving tick, kept in a
process-wide ring in memory.

A span records its name, its start and end on ``time.perf_counter`` (the
clock of ``Request.t_submit``, ``t_first``, ``t_done`` and ``marks``), the
span it lies in (``parent``, by id; spans nest per thread) and a few
attributes.  The ring holds the last ``capacity`` spans and counts those
it overwrote (``dropped``).  Recording is always on and host-only: it
never waits for a device, records no CUDA event and reads no tensor's
value.  A span costs two ``perf_counter`` reads and one ring write.

Mirroring.  While a ``torch.profiler`` session is on, a span opened with
``mirror=True`` also enters a ``record_function`` range of its name, so
that it appears among the profiler's host events, on the profiler's
clock, and labels what the host was doing there.  Only phases that
enqueue no device work are mirrored: a range that encloses a kernel
launch becomes a device-side annotation in the profiler's trace, counted
there as device time.  A span that is not mirrored closes the ranges of
the mirrored spans it lies in for its length (they open again after it),
so that device work inside a host phase (a seed write of the prefix
cache, a weight publish) lies outside every mirrored range.

Reading it (an operator's view of the last minutes of ticks)::

    from repro_torch.runtime.tracing import RECORDER
    spans = RECORDER.spans()          # oldest first, ``Span`` records
    ticks = [s for s in spans if s.name == "serve.tick"]
    RECORDER.dropped                  # spans the ring has overwritten

The engine's spans (``engine/serve.py``): ``serve.tick`` (one
``ServeEngine.tick`` call, with its plan's attributes) and, inside it,
``serve.poll``, ``serve.admit``, ``serve.plan`` and ``serve.commit``
(mirrored), ``serve.device`` (the first dispatch to the end of the last
host copy) holding ``serve.dispatch`` and ``serve.collect``, and where
they happen ``serve.capture`` (a step graph captured), ``serve.rows`` (a
prefix-cache row copy), ``serve.publish`` (new weights bound) and
``serve.alloc`` (a pool's buffers or weights made on first use).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

# spans the process-wide ring keeps (a few hundred bytes each)
CAPACITY = 1 << 16

_now = time.perf_counter
# whether a torch.profiler session is on (one call into torch's C++)
_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """A finished span; times in seconds of ``time.perf_counter``."""
    sid: int
    parent: Optional[int]
    name: str
    t0: float
    t1: float
    attrs: Dict[str, Any]

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class OpenSpan:
    """A span being recorded: a context manager, or ``begin`` and ``end``
    where the times are read already.  ``attrs`` may grow while it is
    open."""
    __slots__ = ("_rec", "name", "mirror", "attrs", "sid", "parent", "t0",
                 "t1", "_range")

    def __init__(self, rec: "Recorder", name: str, mirror: bool,
                 attrs: Dict[str, Any]):
        self._rec, self.name, self.mirror, self.attrs = rec, name, mirror, \
            attrs
        self.t1 = None
        # the profiler range: None, open (a record_function), or False
        # while a span inside it that is not mirrored holds it closed
        self._range = None

    def __enter__(self) -> "OpenSpan":
        stack = self._rec._local.stack
        self.parent = stack[-1].sid if stack else None
        self.sid = next(self._rec._ids)
        if _profiling():
            if self.mirror:
                self._range = _range(self.name)
            else:
                _suspend(stack)
        stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now() if self.t1 is None else self.t1
        stack = self._rec._local.stack
        # spans an exception left open inside this one close with it
        while stack:
            top = stack.pop()
            if top._range:
                top._range.__exit__(None, None, None)
                top._range = None
            if top is self:
                break
        if stack and stack[-1]._range is False:
            _resume(stack)
        self._rec._write((self.sid, self.parent, self.name, self.t0, t1,
                          self.attrs))
        return False

    def begin(self, t0: Optional[float] = None) -> "OpenSpan":
        """Open the span, at ``t0`` where given."""
        self.__enter__()
        if t0 is not None:
            self.t0 = t0
        return self

    def end(self, t1: Optional[float] = None) -> None:
        """Close the span, at ``t1`` where given."""
        self.t1 = t1
        self.__exit__(None, None, None)


def _range(name: str):
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


def _suspend(stack: List[OpenSpan]) -> None:
    """Close the open ranges of the mirrored spans at the top of
    ``stack`` (down to the first span that is not mirrored), innermost
    first."""
    for s in reversed(stack):
        if not s.mirror:
            return
        if s._range:
            s._range.__exit__(None, None, None)
            s._range = False


def _resume(stack: List[OpenSpan]) -> None:
    """Open again, outermost first, the ranges ``_suspend`` closed that no
    span above them that is not mirrored still holds closed."""
    held = []
    for s in reversed(stack):
        if not s.mirror:
            break
        held.append(s)
    for s in reversed(held):
        if s._range is False:
            s._range = _range(s.name) if _profiling() else None


class _Stack(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.stack: List[OpenSpan] = []


class Recorder:
    """A ring of the last ``capacity`` finished spans, written in the order
    they end, and the count of those it overwrote."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self.capacity = int(capacity)
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._local = _Stack()

    def _write(self, rec: tuple) -> None:
        with self._lock:
            self._ring[self._n % self.capacity] = rec
            self._n += 1

    def span(self, name: str, mirror: bool = False, **attrs) -> OpenSpan:
        """A span of ``name`` with ``attrs``, begun on ``with`` (or
        ``begin``).  ``mirror``: a host-only phase that a profiler session
        also sees as a ``record_function`` range."""
        return OpenSpan(self, name, mirror, attrs)

    @property
    def written(self) -> int:
        """Spans written since the start or the last ``clear``."""
        return self._n

    @property
    def dropped(self) -> int:
        """Spans the ring overwrote (the oldest)."""
        return max(self._n - self.capacity, 0)

    def spans(self) -> List[Span]:
        """The spans the ring holds, oldest first."""
        with self._lock:
            n, ring = self._n, list(self._ring)
        if n > self.capacity:
            i = n % self.capacity
            ring = ring[i:] + ring[:i]
        else:
            ring = ring[:n]
        return [Span(*r) for r in ring]

    def clear(self) -> None:
        """Forget every span and the dropped count (open spans still
        finish into the ring)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._n = 0


# the process's recorder, which the engine writes
RECORDER = Recorder()


def span(name: str, mirror: bool = False, **attrs) -> OpenSpan:
    """A span of the process's recorder (``Recorder.span``)."""
    return OpenSpan(RECORDER, name, mirror, attrs)
