"""Closed-loop knob autotuning: the engine's own knobs as a Maestro decision.

Every decision surface the engine carries — tick composition, spec arm,
layout, admission, placement — is result-aware: arms are measured, the
CostBook scores them, bootstrap/re-explore keeps the EMAs honest.  But the
*knobs* those decisions run under (``spec_len``, the compaction threshold,
``prefill_chunk``, priority-class weights) stayed config-pinned constants.
This module closes the loop: an :class:`AutoTuner` attached to a
:class:`~repro_torch.engine.serve.ServeEngine` treats each knob as one more
decision family.

Mechanics — deliberately the same discipline as every ``Engine.choose_*``:

* Time is split into fixed **windows** of work ticks.  Each window runs
  entirely under one (knob, value) arm; at the window boundary the tuner
  records the window's measured cost — wall seconds per committed token by
  default — under ``jobs.knob_kind(name, value)`` in the shared CostBook.
* The first window after an arm switch is a **warm-up**: a changed
  ``compact_frac`` can reach a compact height whose graph is not captured
  yet, a changed chunk a tick length not run yet, and a capture-carrying
  window entering the EMA would wedge the choice exactly the way
  ``Engine.observe`` guards against for jobs.  Warm-up windows are
  counted but not recorded.
* Knobs are tuned **round-robin** (coordinate descent): one knob owns the
  measurement at a time, so a window's cost is attributable to the arm
  that ran it.  Arm selection is :meth:`Engine.choose_knob` — bootstrap
  every unmeasured value, exploit the cheapest, re-explore a rotating
  loser every 16th round — so every knob move lands in the decision
  telemetry deque with its scores, like any other engine choice.
* Application goes through the same handlers ``update()`` uses
  (``ServeEngine._apply_updates``), called directly at the tick boundary
  the tuner runs on — the tuner IS a control client, just an in-process
  one, so it can never apply a knob mid-tick.

Greedy bit-identicality is preserved by construction: every tuned knob is
one the engine already accepts as a hot update, and the differential
harness sweeps exactly those updates (chunk flips, spec toggles) against
the static oracle.  ``tests/test_torch_autotune.py`` pins it anyway.

Measurement is injectable (``measure=``): unit tests hand the tuner a
synthetic cost function and prove convergence deterministically; the real
default reads the engine's wall clock and token counter.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.engine import jobs as J

__all__ = ["Knob", "AutoTuner", "default_knobs"]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable engine knob: a name, the discrete arm values the tuner
    may pick from, and how a value becomes an ``_apply_updates`` dict —
    ``key`` for plain ``{key: value}`` knobs, ``wrap`` for structured ones
    (class weights).  ``read`` recovers the engine's current value so the
    tuner starts from — and accounts the first window to — whatever the
    config pinned."""
    name: str
    values: Tuple[Any, ...]
    key: str = ""
    wrap: Optional[Callable[[Any], Dict[str, Any]]] = None
    read: Optional[Callable[[Any], Any]] = None

    def updates(self, value) -> Dict[str, Any]:
        if self.wrap is not None:
            return self.wrap(value)
        assert self.key, f"knob {self.name}: no key and no wrap"
        return {self.key: value}

    def current(self, eng) -> Any:
        if self.read is not None:
            return self.read(eng)
        return getattr(eng, self.key)


def default_knobs(eng) -> List[Knob]:
    """The stock knob set for one engine, filtered to what the engine can
    actually honor: spec_len arms only when speculative decoding is live
    (and capped so prompt+max_new+spec_len stays inside max_len for
    typical traffic), chunk arms capped at the configured chunk (larger
    values would change submit()'s admission contract mid-flight), class
    weights only when there are classes to trade off."""
    knobs: List[Knob] = []
    pc = int(eng.prefill_chunk)
    arms = tuple(c for c in (1, 2, 4, 8, 16, 32) if c <= pc)
    if len(arms) > 1:
        knobs.append(Knob("prefill_chunk", arms, key="prefill_chunk"))
    if eng.spec_decode:
        cap = max(eng.max_len // 8, 2)
        sarms = tuple(s for s in (2, 4, 8) if s <= cap)
        if len(sarms) > 1:
            knobs.append(Knob("spec_len", sarms, key="spec_len"))
    knobs.append(Knob("compact_frac", (0.25, 0.5, 0.75),
                      key="compact_frac"))
    for name, c in eng.classes.items():
        if len(eng.classes) < 2:
            break
        base = float(c.weight)
        knobs.append(Knob(
            f"weight:{name}",
            tuple(round(base * m, 4) for m in (0.5, 1.0, 2.0)),
            wrap=lambda v, _n=name: {"class_weights": {_n: v}},
            read=lambda e, _n=name: float(e.classes[_n].weight)))
    return knobs


class AutoTuner:
    """The meta-controller: windowed measurement + round-robin knob moves.

    ``window`` is in WORK ticks (the engine only calls :meth:`on_tick`
    on ticks that dispatched something).  ``measure`` overrides the cost
    sample for a closing window: a callable of the stats dict
    ``{"wall_s", "tokens", "ticks"}`` returning seconds-per-token-like
    cost, or ``None`` to drop the window.  ``warmup`` is the number of
    post-switch windows discarded before measurement (default 1: the
    capture window)."""

    def __init__(self, eng, knobs: Optional[List[Knob]] = None,
                 window: int = 32, warmup: int = 1,
                 measure: Optional[Callable[[Dict[str, float]],
                                            Optional[float]]] = None):
        assert window >= 1
        self.eng = eng
        self.knobs = list(knobs) if knobs is not None else default_knobs(eng)
        assert self.knobs, "AutoTuner needs at least one knob"
        names = [k.name for k in self.knobs]
        assert len(set(names)) == len(names), f"duplicate knobs: {names}"
        self.window = int(window)
        self.warmup = int(warmup)
        self.measure = measure or self._measure_wall
        self.windows = 0              # windows closed (incl. warm-ups)
        self.moves = 0                # arm applications that changed value
        self._ki = 0                  # knob being measured (round-robin)
        self._warm = 0                # warm-up windows left to discard
        self._ticks = 0
        self._t0 = time.perf_counter()
        self._tok0 = int(eng.tokens_out)
        # current value per knob, read off the live engine so the first
        # window is accounted to the config-pinned arm (which may not be
        # in ``values`` — that's fine, it just never gets re-chosen)
        self.current: Dict[str, Any] = {k.name: k.current(eng)
                                        for k in self.knobs}

    # ------------------------------------------------------------ measurement
    @staticmethod
    def _measure_wall(stats: Dict[str, float]) -> Optional[float]:
        """Default window cost: wall seconds per committed token.  A
        window that committed nothing has no signal — dropped rather than
        scored, so a starved window can't poison an arm's EMA with a
        divide-by-almost-zero artifact."""
        if stats["tokens"] <= 0:
            return None
        return stats["wall_s"] / stats["tokens"]

    def _window_stats(self) -> Dict[str, float]:
        return {"wall_s": time.perf_counter() - self._t0,
                "tokens": float(int(self.eng.tokens_out) - self._tok0),
                "ticks": float(self._ticks)}

    # ------------------------------------------------------------------ loop
    def on_tick(self) -> None:
        """Called by the engine at the end of every WORK tick.  Closes the
        window when due, records the measurement, rotates to the next
        knob, asks ``Engine.choose_knob`` for its next arm, applies it."""
        self._ticks += 1
        if self._ticks < self.window:
            return
        stats = self._window_stats()
        self.windows += 1
        if self._warm > 0:
            # post-switch warm-up window (capture-carrying): discard, and
            # only start measuring once the warm-ups have elapsed
            self._warm -= 1
        else:
            knob = self.knobs[self._ki % len(self.knobs)]
            cost = self.measure(stats)
            if cost is not None:
                self.eng.engine.costs.observe(
                    J.knob_kind(knob.name, self.current[knob.name]),
                    float(cost))
            # measured (or dropped) a settled window: move on — next knob
            # in the rotation picks its next arm
            self._ki += 1
            nxt = self.knobs[self._ki % len(self.knobs)]
            value = self.eng.engine.choose_knob(nxt.name, nxt.values)
            if value != self.current[nxt.name]:
                self.eng._apply_updates(nxt.updates(value))
                self.current[nxt.name] = value
                self.moves += 1
                self._warm = self.warmup
        self._ticks = 0
        self._t0 = time.perf_counter()
        self._tok0 = int(self.eng.tokens_out)

    # ------------------------------------------------------------- telemetry
    def snapshot(self) -> Dict[str, Any]:
        """The ``_inspect()["autotune"]`` payload: live arm per knob, the
        knob currently owning the measurement window, and each arm's
        CostBook EMA — enough to explain every move without replaying the
        decision deque."""
        book = self.eng.engine.costs
        return {
            "enabled": True,
            "window": self.window,
            "windows": self.windows,
            "moves": self.moves,
            "measuring": self.knobs[self._ki % len(self.knobs)].name,
            "current": dict(self.current),
            "arms": {k.name: {str(v): book.estimate(J.knob_kind(k.name, v))
                              for v in k.values}
                     for k in self.knobs},
        }
