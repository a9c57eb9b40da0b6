#!/usr/bin/env python3
"""One traced run of a benchmark cell, with the program's spans held to
the client's clock and to the device trace.

    python3 scripts/span_check.py --workload yi-34b.batch --seed N
        [--seconds 51] [--root DIR]

It runs ``bench/run.py``'s ``run_cell`` of the checkout at ``--root`` (by
default this one) with ``--trace 1`` and prints, beside the run's result
line: the mean ``serve.tick`` span of the window's working ticks against
the client's mean tick over the same ticks; the mean time of each phase
a tick (``serve.poll`` ... ``serve.commit``) and the spans a tick; the
host time plus the mean ``serve.device`` against the mean tick; the
captures in set-up and in the window; and in the profiler's trace the
host events of each ``serve.`` name and the device events of any (count
and the union of their time over the traced sub-window).  One JSON line
last.  It exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

T0 = time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    spec_ = importlib.util.spec_from_file_location("bench_run",
                                                   root / "bench" / "run.py")
    bench_run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(bench_run)
    bench_run._paths(root)
    bench_run._caches(root)
    import torch
    if not torch.cuda.is_available():
        print("[span_check] needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from benchkit import spans, trace
    from benchkit.spec import Spec

    runs, dev_serve = [], {}

    class Keep(Spec):
        def reader(self, name):
            f = super().reader(name)

            def read(run):
                runs.append(run)
                return f(run)
            return read

    read_trace = trace.Tracer.read

    def read(self):
        if self.prof is not None:
            events = self.prof.profiler.kineto_results.events()
            host, dev = Counter(), []
            for e in events:
                if not e.name().startswith("serve."):
                    continue
                if trace._is_device(e):
                    a = e.start_ns() * 1e-9
                    dev.append((a, a + e.duration_ns() * 1e-9, e.name()))
                else:
                    host[e.name()] += 1
            dev_serve.update(
                host=dict(host), device=len(dev),
                device_names=sorted({n for _, _, n in dev}),
                device_union_s=sum(b - a for a, b in trace._merge(
                    [(a, b) for a, b, _ in dev])),
                host_gaps_by_span=host_gaps(
                    events, [t for t in self.client.ticks if t.traced]))
        return read_trace(self)

    trace.Tracer.read = read
    out = bench_run.run_cell(Keep(root), args.workload, args.seed,
                             args.seconds, True, t0=T0)
    out.pop("diag", None)
    print(json.dumps(out), flush=True)
    print(json.dumps({"span_check": check(root, runs[0], out, dev_serve)}),
          flush=True)
    return 0


def host_gaps(events, ticks):
    """The idle gaps inside a traced tick that the breakdown labels
    ``host`` (no host event holds them), in seconds by the innermost
    program span that holds each (``serve.*``, or ``none``), placed on
    the host's clock by matching the trace's last ``bench.tick`` events
    to the last traced ticks (the median offset)."""
    from benchkit import spans, trace
    rec = spans.recorder()
    if rec is None:
        return None
    prog = rec.spans()
    ticks_, dev, cpu = [], [], []
    for e in events:
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if trace._is_device(e):
            if not e.name().startswith("bench."):
                dev.append((a, b))
        elif e.name() == "bench.tick":
            ticks_.append((a, b))
        else:
            cpu.append((a, b, e.name()))
    ticks_.sort()
    k = min(len(ticks_), len(ticks))
    if k < 2:
        return None
    offs = sorted(t.t0 - a for (a, _), t in zip(ticks_[-k:], ticks[-k:]))
    off = offs[k // 2]
    w0, w1 = ticks_[1][0], ticks_[-1][1]
    busy = trace._merge([(max(a, w0), min(b, w1)) for a, b in dev
                         if b > w0 and a < w1])
    cpu.sort()
    cstarts = [c[0] for c in cpu]
    out = Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        mid = (a + b) / 2
        if b <= a or not any(x <= mid <= y for x, y in ticks_) or \
                trace._innermost(cpu, cstarts, mid) != "host":
            continue
        t = mid + off
        held = [s for s in prog if s.t0 <= t <= s.t1]
        out[min(held, key=lambda s: s.dur).name if held else "none"] += \
            b - a
    return dict(out)


def check(root, run, out, dev_serve, device="cuda"):
    """The span checks of one traced run (``run``: what the readers read;
    ``out``: its result; ``dev_serve``: the trace's ``serve.`` events)."""
    from benchkit import spans
    from benchkit.spec import Spec
    rec = spans.recorder()
    got = {"trace_serve_events": dev_serve}
    if out.get("device", {}).get("window_s"):
        got["trace_serve_events"]["device_union_share"] = \
            dev_serve.get("device_union_s", 0.0) / out["device"]["window_s"]
    if rec is None:
        return got
    all_spans = rec.spans()
    kids = defaultdict(list)
    for s in all_spans:
        kids[s.parent].append(s)
    pairs = []
    for c in (t for t in run["ticks"] if t.rows):
        inside = [s for s in all_spans if s.name == "serve.tick"
                  and c.t0 <= s.t0 and s.t1 <= c.t1]
        if inside:
            pairs.append((c, inside[0]))
    n = max(len(pairs), 1)

    def count(s):
        return 1 + sum(count(k) for k in kids.get(s.sid, []))

    phases = defaultdict(float)
    for _, s in pairs:
        for k in kids.get(s.sid, []):
            phases[k.name] += k.dur
            for kk in kids.get(k.sid, []):
                phases[kk.name] += kk.dur
    kept = spans.ticks(run, device) or []
    m = max(len(kept), 1)
    mean_dev = sum(t.child_s("serve.device") for t in kept) / m
    host = Spec(root).reader("host_ms.batch")(run, device)
    caps = spans.captures(run) or []
    got.update({
        "window_ticks": sum(1 for t in run["ticks"] if t.rows),
        "matched": len(pairs),
        "mean_serve_tick_ms": 1e3 * sum(s.dur for _, s in pairs) / n,
        "mean_client_tick_ms": 1e3 * sum(c.t1 - c.t0 for c, _ in pairs) / n,
        "spans_a_tick": sum(count(s) for _, s in pairs) / n,
        "phase_ms_a_tick": {k: 1e3 * v / n for k, v in phases.items()},
        "kept_ticks": len(kept),
        "kept_mean_tick_ms": 1e3 * sum(t.span.dur for t in kept) / m,
        "kept_mean_device_ms": 1e3 * mean_dev,
        "host_ms_plus_device_ms": (host or 0.0) + 1e3 * mean_dev,
        "modes": dict(Counter(t.span.attrs["mode"] for t in kept)),
        "captures_setup": sum(s.t1 <= run["open"] for s in caps),
        "captures_window": sum(s.t1 > run["open"] for s in caps),
        "token_gaps": len(spans.token_gaps(run, device) or []),
        "ring": {"written": rec.written, "dropped": rec.dropped,
                 "capacity": rec.capacity}})
    return got


if __name__ == "__main__":
    sys.exit(main())
