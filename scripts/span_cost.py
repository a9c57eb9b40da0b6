#!/usr/bin/env python3
"""What the serve engine's span recorder (``repro_torch.runtime.tracing``)
costs on the host.

    PYTHONPATH=src python3 scripts/span_cost.py [--spans N] [--ticks N]
        [--reps R]

Per span: ``N`` spans in a loop, not mirrored and mirrored, with no
profiler on.  Per tick: ``N`` times the eight spans of a working tick
(``serve.tick`` with its attributes, ``serve.poll``, ``serve.admit``,
``serve.plan``, ``serve.device`` holding ``serve.dispatch`` and
``serve.collect``, and ``serve.commit``; the four host phases mirrored)
with no profiler on, and under a ``torch.profiler`` session (CPU and,
with a card, CUDA activities).  Each number is the best of ``R`` loops,
in microseconds, on a recorder of the default capacity.  Last, the
memory a full ring of ticks' spans holds (``tracemalloc``, MB).  It
prints the card's name and power limit where there is one, and one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.runtime import tracing  # noqa: E402


def per_span(rec, n: int, mirror: bool) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with rec.span("serve.plan", mirror=mirror):
            pass
    return (time.perf_counter() - t) / n * 1e6


def one_tick(rec, i: int) -> None:
    with rec.span("serve.tick", tick_no=i, rows=0, device="cuda") as tick:
        with rec.span("serve.poll", mirror=True):
            pass
        with rec.span("serve.admit", mirror=True) as a:
            a.attrs["admitted"] = 0
        with rec.span("serve.plan", mirror=True):
            pass
        tick.attrs.update(pool=0, mode="decode", L=4, rows=3, height=4,
                          compact=True, cold=False, group=0)
        dev = rec.span("serve.device").begin()
        with rec.span("serve.dispatch"):
            pass
        with rec.span("serve.collect"):
            pass
        dev.end()
        with rec.span("serve.commit", mirror=True) as c:
            c.attrs["tokens"] = 12


def per_tick(rec, n: int) -> float:
    t = time.perf_counter()
    for i in range(n):
        one_tick(rec, i)
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=100_000)
    ap.add_argument("--ticks", type=int, default=10_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"[span_cost] card: {smi}", flush=True)
    rec = tracing.Recorder()
    out = {"host": "the card's host" if cuda else "no card"}
    for mirror in (False, True):
        out[f"span_us{'_mirrored' if mirror else ''}"] = min(
            per_span(rec, args.spans, mirror) for _ in range(args.reps))
    out["tick_us"] = min(per_tick(rec, args.ticks)
                         for _ in range(args.reps))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts):
        out["tick_us_profiled"] = min(per_tick(rec, args.ticks)
                                      for _ in range(args.reps))
    out["spans_a_tick"] = 8
    import tracemalloc
    full = tracing.Recorder()
    tracemalloc.start()
    for i in range(full.capacity // 8):
        one_tick(full, i)
    out["full_ring_mb"] = tracemalloc.get_traced_memory()[0] / 1e6
    tracemalloc.stop()
    out["ring"] = {"capacity": rec.capacity, "written": rec.written,
                   "dropped": rec.dropped}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
