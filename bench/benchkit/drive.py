"""The client: drives the program's serve engine through its front door
(``BatchedServer.submit``, ``ServeEngine.tick``) and times what a user of
it would see.

Between ticks the client submits what its clients send, then reads each
live request's public fields: ``tokens`` (the tokens so far),
``prompt_off`` (prompt positions consumed) and ``done``.  Each tick is a
span on the host's clock, with the rows and positions it advanced and
their model FLOPs (``yardstick``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from benchkit import yardstick
from benchkit.traffic import Item


@dataclasses.dataclass
class Rec:
    """One submitted request as the client saw it (times: the host's
    ``perf_counter``)."""
    item: Item
    req: Any
    phase: str
    t_submit: float
    sampled: bool = False
    t_done: Optional[float] = None
    n_seen: int = 0
    consumed: int = 0          # positions of the sequence consumed so far

    @property
    def plen(self) -> int:
        return len(self.item.prompt)


@dataclasses.dataclass
class TickRec:
    t0: float
    t1: float
    rows: int = 0              # requests that advanced (0: an idle tick)
    positions: int = 0
    flops: float = 0.0
    gen: int = 0               # tokens that became visible
    height: int = 0            # rows the step ran at
    queued: int = 0            # requests waiting for a slot after it
    traced: bool = False


def _consumed(req) -> int:
    """Positions a request's row has consumed: its prompt's, then one per
    generated token fed back (the last token is never fed)."""
    return int(req.prompt_off) + max(len(req.tokens) - 1, 0)


class Client:
    """Submits requests, runs ticks and keeps the records.  ``cfg`` is the
    configuration file's dict (for the FLOPs of a position)."""

    def __init__(self, server, cfg: Dict, clock: Callable = time.perf_counter):
        self.server = server
        self.eng = server.engine()
        self.cfg = cfg
        self.clock = clock
        self.slots = int(server.slots)
        self.live: List[Rec] = []
        self.recs: List[Rec] = []
        self.ticks: List[TickRec] = []
        self.span: Callable = contextlib.nullcontext
        self.tracing = False

    def submit(self, item: Item, phase: str, now: float) -> Rec:
        req = self.server.submit(item.prompt, max_new=item.max_new,
                                 temperature=0.0)
        rec = Rec(item, req, phase, now)
        self.live.append(rec)
        self.recs.append(rec)
        return rec

    @property
    def busy(self) -> bool:
        return bool(self.live)

    def step(self) -> TickRec:
        """One engine tick, then the scan of every live request."""
        before = self.eng.compact_ticks
        t0 = self.clock()
        with self.span("bench.tick"):
            self.eng.tick()
        t1 = self.clock()
        tk = TickRec(t0, t1, queued=len(self.eng.queue),
                     traced=self.tracing)
        live = []
        for r in self.live:
            req = r.req
            n = len(req.tokens)
            c = _consumed(req)
            if c > r.consumed:
                tk.rows += 1
                tk.positions += c - r.consumed
                tk.flops += yardstick.flops_of_positions(self.cfg,
                                                         r.consumed, c)
                r.consumed = c
            if n > r.n_seen:
                tk.gen += n - r.n_seen
                r.n_seen = n
            if req.done.is_set():
                r.t_done = t1
            else:
                live.append(r)
        self.live = live
        compact = self.eng.compact_ticks > before
        tk.height = (1 << max(tk.rows - 1, 0).bit_length()) if compact \
            else self.slots
        self.ticks.append(tk)
        return tk


class ClosedSource:
    """A closed loop of ``clients`` clients: each sends one of the
    stream's first ``clients`` items at once, then the stream's next item
    each time its request is done."""

    def __init__(self, stream, clients: int, phase: str, client: Client):
        self.stream = stream
        self.phase = phase
        self.i = int(clients)
        now = client.clock()
        self.out: List[Rec] = [client.submit(stream[j], phase, now)
                               for j in range(self.i)]

    def pump(self, client: Client, now: float) -> None:
        for j, rec in enumerate(self.out):
            if rec.t_done is not None:
                self.out[j] = client.submit(self.stream[self.i], self.phase,
                                            now)
                self.i += 1


def serve(client: Client, sources: List, until: Callable[[float], bool],
          on_tick: Callable[[float], None] = lambda now: None) -> None:
    """Send what the sources have to send and tick until ``until(now)``
    or nothing is in flight."""
    while True:
        now = client.clock()
        if until(now):
            return
        on_tick(now)
        for s in sources:
            s.pump(client, now)
        if not client.busy:
            return
        client.step()


def _captured(client):
    """The step heights whose graph the engine's tick has captured, or
    None where the tick runs eagerly (no graphs) or does not say."""
    tick = getattr(client.eng, "_tick", None)
    graphs = getattr(tick, "graphs", None)
    if not getattr(tick, "graph", False) or not isinstance(graphs, dict):
        return None
    return {k[2] for k in graphs if len(k) >= 3 and k[1] == "step"}


def ladder(client: Client, stream, heights, decode_ticks: int = 4,
           again_ticks: int = 19) -> None:
    """Warm the compact step heights a window uses (the mix's ``ladder``):
    ``k`` short requests at once for each height ``k`` below the pool's,
    decoding ``decode_ticks`` ticks.  The engine's layout choice explores the
    compact layout first and runs the losing layout at least every 16th
    eligible tick, so a height whose graph is still missing afterwards
    (or every height, where the tick does not say) runs again for
    ``again_ticks`` ticks, enough for the choice to reach it."""
    srv = client.server
    want = [k for k in heights if k < client.slots]
    i = 0

    def rung(k, ticks):
        nonlocal i
        # as many decode ticks as the cache leaves room for
        n_new = min(int(srv.decode_chunk) * ticks,
                    int(srv.max_len) - 8 - max(int(srv.prefill_chunk),
                                               int(srv.decode_chunk)))
        for _ in range(k):
            client.submit(Item(stream[i].prompt[:8], n_new), "ladder",
                          client.clock())
            i += 1
        serve(client, [], lambda now: not client.busy)

    for k in want:
        rung(k, decode_ticks)
    got = _captured(client)
    if getattr(getattr(client.eng, "_tick", None), "graph", True):
        for k in want:
            if got is None or k not in got:
                rung(k, again_ticks)
