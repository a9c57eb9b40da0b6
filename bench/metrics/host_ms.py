"""host_ms: the engine tick's host work.  The mean over the window's
ticks (``benchkit.spans.ticks``) of the ``serve.tick`` span less its
``serve.device`` span: polling, admission, the plan and the commit, which
the card waits through, in ms."""
from benchkit import spans


def read(run, device="cuda"):
    ts = spans.ticks(run, device)
    if not ts:
        return None
    return 1e3 * sum(t.span.dur - t.child_s("serve.device")
                     for t in ts) / len(ts)
