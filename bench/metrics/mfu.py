"""mfu: the model step's share of the card's bf16 peak.  The model FLOPs
of the positions the window's ticks advanced (each at its own context,
``yardstick.flops_of_positions``) over the summed wall of those ticks
times 989e12 FLOP/s, in percent."""
from benchkit import yardstick


def read(run):
    ts = [t for t in run["ticks"] if t.rows]
    wall = sum(t.t1 - t.t0 for t in ts)
    if not ts or wall <= 0:
        return None
    return 100.0 * sum(t.flops for t in ts) / (
        wall * yardstick.PEAK_FLOPS_BF16)
