"""tick_ms: the engine tick.  The summed wall time of the window's
non-idle ticks (``ServeEngine.tick`` calls that advanced a request), in
the client's span around each call, over their number."""


def read(run):
    ts = [t for t in run["ticks"] if t.rows]
    return sum(t.t1 - t.t0 for t in ts) / len(ts) * 1e3 if ts else None
