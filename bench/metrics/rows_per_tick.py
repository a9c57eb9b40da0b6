"""rows_per_tick: batching.  The mean number of requests a non-idle tick
of the window advanced (from each request's consumed positions, read
between ticks)."""


def read(run):
    ts = [t for t in run["ticks"] if t.rows]
    return sum(t.rows for t in ts) / len(ts) if ts else None
