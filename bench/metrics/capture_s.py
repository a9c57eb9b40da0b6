"""capture_s: set-up's graph captures.  The summed ``serve.capture``
spans (a step's eager warm-up step and its CUDA graph capture) that
ended before the window opened, in s; captures inside the window are
logged.  None where nothing was captured (a pool on the CPU runs its
steps eagerly)."""
from benchkit import spans


def read(run):
    caps = spans.captures(run)
    if not caps:
        return None
    late = [s for s in caps if s.t1 > run["open"]]
    if late:
        spans.log(f"[bench] capture_s: {len(late)} captures in the window, "
                  f"{sum(s.dur for s in late):.3f} s: "
                  f"{[dict(s.attrs) for s in late]}")
    return sum(s.dur for s in caps if s.t1 <= run["open"])
