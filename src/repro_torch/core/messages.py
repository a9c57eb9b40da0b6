"""Amber-style control messages (paper §2.3.3, §2.4).

Control messages co-exist with the data plane (training steps) and must take
effect within one *iteration* (paper: one tuple; here: one microbatch).
Every message carries a sequence number; its processing point relative to the
data plane — (step, microbatch) — is recorded in the control-replay log for
fault tolerance (§2.6.2).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Callable, Dict, Optional

_seq = itertools.count()


@dataclasses.dataclass
class ControlMessage:
    kind: str                       # pause|resume|inspect|update|breakpoint|plan|stop
    payload: Any = None
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    response: Any = dataclasses.field(default=None, compare=False)

    def reply(self, value: Any) -> None:
        self.response = value
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        self._done.wait(timeout)
        return self.response


def pause() -> ControlMessage:
    return ControlMessage("pause")


def resume() -> ControlMessage:
    return ControlMessage("resume")


def inspect(what: str = "all") -> ControlMessage:
    return ControlMessage("inspect", what)


def update(**kv) -> ControlMessage:
    return ControlMessage("update", dict(kv))


def set_breakpoint(bp) -> ControlMessage:
    return ControlMessage("breakpoint", bp)


def set_plan(plan_slots, plan_cum, migrations=()) -> ControlMessage:
    return ControlMessage("plan", {"slots": plan_slots, "cum": plan_cum,
                                   "migrations": tuple(migrations)})


def stop() -> ControlMessage:
    return ControlMessage("stop")


@dataclasses.dataclass(frozen=True)
class LogRecord:
    """Replay point of a control message relative to the data plane:
    the paper's <msg, main-thread data seq, (DP msg seq, tuple idx)> maps to
    <msg kind+payload, step, microbatch>."""
    kind: str
    payload: Any
    seq: int
    step: int
    microbatch: int
