"""row_use: batching.  Over the window's ticks (``benchkit.spans.ticks``),
the rows that did work over the rows the steps ran at, each weighted by
the tick's positions ``L``: sum of ``rows`` x ``L`` over sum of ``height``
x ``L``, in percent (the ``serve.tick`` span's attributes)."""
from benchkit import spans


def read(run, device="cuda"):
    ts = spans.ticks(run, device)
    if not ts:
        return None
    a = [t.span.attrs for t in ts]
    return 100.0 * sum(x["rows"] * x["L"] for x in a) / sum(
        x["height"] * x["L"] for x in a)
