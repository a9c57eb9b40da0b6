#!/usr/bin/env python3
"""Time the bf16 scan backwards of two trees of the port on one card, in
turns (A, B, B, A), at the training shapes: `zamba2-7b`'s Mamba2 layer
(x [1, 112, 1024, 64], B and C [1, 1024, 64] sliced from one conv output,
as `models/blocks.py` hands them over) and `rwkv6-1.6b`'s RWKV6 layer
([1, 32, 1024, 64] in the model's transposed layout), no initial state
and no final-state cotangent, as in training.

    python3 scripts/scan_bwd_ab.py --tree build/parent --tree .

For each tree, in a process of its own (its `src` first on the path, its
kernels built into a directory of their own under `build/`): each
backward's graph-replayed time (`mamba2_bwd_cuda`, `rwkv6_bwd_cuda`, the
wrappers of every tree since their port), each of its kernels' device
time from `torch.profiler`, whether a rerun is equal bit for bit, and
with `--check` every gradient against the plain backward with
`chip_smoke.py` `check_scan_bwd`'s tolerance (elements over it). Prints
the card's name and power limit, one `RESULT` JSON line a run, and exits
1 if a run fails or a checked gradient misses the tolerance.  Needs a
card.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tag: str, check: bool) -> dict:
    import torch

    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import mamba2_bwd_cuda
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_bwd_ref
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_bwd_cuda

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    def mamba_args():
        b, t, h, p, n = 1, 1024, 112, 64, 64
        conv = rn(b, t, h * p + 2 * n).bfloat16()
        xs, bm, c = torch.split(conv, [h * p, n, n], dim=-1)
        x = xs.reshape(b, t, h, p).transpose(1, 2)
        dt = torch.nn.functional.softplus(rn(b, t, h, scale=2.0)).transpose(
            1, 2)
        a = -torch.rand(h, generator=gen, device=dev) * 1.5 - 0.5
        dy = rn(b, t, h, p).bfloat16().transpose(1, 2)
        return (x, dt, a, bm, c, rn(h), dy, None, None)

    def rwkv_args():
        b, t, h, n = 1, 1024, 32, 64
        r, k, v = (rn(b, t, h, n, scale=0.5).bfloat16().transpose(1, 2)
                   for _ in range(3))
        w = (0.0113 + (0.9997 - 0.0113) * torch.rand(
            b, t, h, n, generator=gen, device=dev)).bfloat16().transpose(1, 2)
        dy = rn(b, t, h, n).bfloat16().transpose(1, 2)
        return (r, k, v, w, rn(h, n, scale=0.1), dy, None, None)

    def graph_ms(fn, reps=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        best = None
        for _ in range(3):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            graph.replay()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / reps
            best = ms if best is None else min(best, ms)
        return best

    def kernels(fn, n=5):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {e.key[:90]: e.device_time_total / n / 1e3
                for e in prof.key_averages() if e.device_time_total > 0}

    def gate(got, want):
        rows = []
        for i, (x, y) in enumerate(zip(got, want)):
            if x is None:
                continue
            ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 1e-4
            err = (x.float() - y.float()).abs()
            scale = y.float().abs().max().item()
            over = int((err > ulp * y.float().abs() + 1e-4 * scale).sum())
            rows.append({"grad": i, "max_abs_err": err.max().item(),
                         "scale": scale, "over": over})
        return rows

    res = {"tag": tag}
    for name, fn, ref, args in (
            ("mamba2_ssd_bwd", mamba2_bwd_cuda, mamba2_bwd_ref, mamba_args()),
            ("rwkv6_scan_bwd", rwkv6_bwd_cuda, rwkv6_bwd_ref, rwkv_args())):
        out = fn(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        row = {"ms": graph_ms(lambda: fn(*args)),
               "kernels": kernels(lambda: fn(*args)),
               "rerun_equal": all(x is None or torch.equal(x, y)
                                  for x, y in zip(out, again))}
        if check:
            row["gate"] = gate(out, ref(*args))
        res[name] = row
        del out, again
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout's root (twice: A, then B)")
    ap.add_argument("--check", action="store_true",
                    help="hold every gradient to the plain backward")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print("RESULT " + json.dumps(one(args.one, args.check)), flush=True)
        return 0
    if len(args.tree) != 2:
        ap.error("give --tree twice")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = [Path(t).resolve() for t in args.tree]
    ok = True
    for i in (0, 1, 1, 0):
        tag = "AB"[i] + ":" + str(trees[i].relative_to(ROOT)
                                  if trees[i].is_relative_to(ROOT)
                                  else trees[i])
        env = dict(os.environ, PYTHONPATH=str(trees[i] / "src"),
                   REPRO_TORCH_BUILD_DIR=str(ROOT / "build" /
                                             f"ab_kernels_{'ab'[i]}"))
        run = subprocess.run(
            [sys.executable, __file__, "--one", tag] +
            (["--check"] if args.check else []),
            env=env, capture_output=True, text=True)
        lines = [x for x in run.stdout.splitlines()
                 if x.startswith("RESULT ")]
        if run.returncode or not lines:
            print(f"{tag}: failed\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}",
                  flush=True)
            ok = False
            continue
        print(lines[-1], flush=True)
        res = json.loads(lines[-1][7:])
        for name in ("mamba2_ssd_bwd", "rwkv6_scan_bwd"):
            row = res[name]
            over = sum(g["over"] for g in row.get("gate", []))
            ok = ok and row["rerun_equal"] and not over
            print(f"{tag} {name}: {row['ms']:.7f} ms; rerun equal "
                  f"{row['rerun_equal']}; elements over the tolerance "
                  f"{over if 'gate' in row else 'not checked'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
