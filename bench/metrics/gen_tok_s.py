"""gen_tok_s: every token that became visible in the window's ticks, of
finished and unfinished requests alike, over the window's wall time."""


def read(run):
    wall = run["close"] - run["open"]
    return sum(t.gen for t in run["ticks"]) / wall if wall > 0 else None
