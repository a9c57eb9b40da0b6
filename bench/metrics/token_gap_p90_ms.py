"""token_gap_p90_ms: batching, as a request feels it.  The 90th
percentile (nearest rank) of the gaps between successive token marks of
the sampled requests (``Request.marks``), a gap counting only where every
tick it spans is one of the window's (``benchkit.spans.token_gaps``), in
ms; None under ``MIN_GAPS`` gaps."""
import math

from benchkit import spans

MIN_GAPS = 100


def read(run, device="cuda"):
    gaps = spans.token_gaps(run, device)
    if gaps is None:
        return None
    spans.log(f"[bench] token_gap_p90_ms: {len(gaps)} gaps")
    if len(gaps) < MIN_GAPS:
        return None
    gaps.sort()
    return 1e3 * gaps[math.ceil(0.9 * len(gaps)) - 1]
