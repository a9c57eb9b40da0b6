"""The readings a cell's check limit is set from, run once when the limit
is set (not by the benchmark's runs):

    python3 bench/calibrate.py --workload yi-34b.batch --seeds 1-12 \
        --seconds 20 --out chiprun_out/calib.jsonl

Each seed is a whole run of the cell (``run.run_cell`` with
``control=True``): the program's readings over the sample of what it
served (``logit_gap``) and the control's at the same positions
(``control_gap``: the reference in float8 e4m3 products in the
program's place).  A limit lies above the largest
program reading and below the smallest control reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import run


def _seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    run._paths(run.ROOT)
    run._caches(run.ROOT)
    import torch
    from benchkit.spec import Spec
    spec = Spec(run.ROOT)
    for seed in _seeds(args.seeds):
        out = run.run_cell(spec, args.workload, seed, args.seconds, False,
                           control=True, t0=time.perf_counter())
        line = {"seed": seed, **out["readings"], "correct": out["correct"]}
        run.log(f"[calibrate] {json.dumps(line)}")
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
