#!/usr/bin/env python3
"""Activation recompute on one card: how large a microbatch each policy
lets a recurrent model train, what a step costs there, and that the
policies give the same parameters.

    python3 scripts/remat_ab.py [--arch rwkv6-1.6b:24,zamba2-7b:30]
        [--seq 1024] [--shared 2] [--max-rows 64]

For each config (``name:layers``, cut to its first ``layers`` layers, at
its published widths, random f32 weights from seed 0) and each policy
(``none``, ``dots``, ``full``; ``TrainHyper.remat``):

1. the largest microbatch (rows of ``--seq`` tokens, one microbatch a
   step) that the dry run (``launch.dryrun.dry_cell`` on ``meta``) admits
   on one 80 GB card, found by tracing: each guess is the line through
   the last two traces (the bytes grow about linearly in the rows), kept
   between the rows known to fit and known not to, at most
   ``--max-rows``;
2. two fused steps at that microbatch (the training loop's in-place
   step), the second one timed: its wall, training tokens/s and peak
   device memory beside the dry run's prediction (predicted / measured).
   The dry run predicts the allocated bytes; the caching allocator also
   holds blocks it cannot reuse, so a step it admits may run out of
   memory: then the rows step down by a tenth at a time until a step
   runs, and both row counts are reported;
3. at ``--shared`` rows, one step of each policy from the same seeded
   state on the same seeded tokens: the updated parameters of ``dots`` and
   ``full`` against ``none``'s, bit for bit.

Prints the card's name and power limit and one ``RESULT`` JSON line, and
exits 1 if the parameters differ or a step fails.  Needs a card.
"""
import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

POLICIES = ("none", "dots", "full")
SEED = 0


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cut(cfg, layers):
    if layers >= cfg.num_layers:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               layer_pattern=cfg.pattern[:layers])


def predicted(cfg, rows, seq, remat) -> float:
    """The dry run's bytes on one card for a step of one microbatch of
    ``rows`` x ``seq`` tokens under ``remat``."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.runtime.sharding import parse_mesh
    shape = ShapeCfg(f"train [{rows}, {seq}]", seq, rows, "train", 1)
    return dryrun.dry_cell(cfg, shape, [parse_mesh("1x1")],
                           remat)[0]["bytes_per_device"]["total"]


def largest_rows(cfg, seq, remat, max_rows) -> tuple:
    """(rows, predicted bytes): the largest microbatch the dry run admits
    on one card, at most ``max_rows``.  The bytes grow about linearly in
    the rows, so each guess is the line through the last two traces,
    kept inside the rows known to fit and known not to."""
    from repro_torch.launch.mesh import HBM_BYTES
    seen = {1: predicted(cfg, 1, seq, remat), 2: predicted(cfg, 2, seq,
                                                          remat)}
    last = [1, 2]
    while True:
        fit = [r for r, v in seen.items() if v <= HBM_BYTES]
        over = [r for r, v in seen.items() if v > HBM_BYTES]
        lo = max(fit) if fit else 0
        hi = min(over + [max_rows + 1])
        if hi - lo <= 1:
            return (lo, seen[lo]) if lo else (1, seen[1])
        (r0, v0), (r1, v1) = [(r, seen[r]) for r in last[-2:]]
        per = max((v1 - v0) / (r1 - r0), 1.0)
        guess = r1 + int((HBM_BYTES - v1) // per)
        guess = min(max(guess, lo + 1), hi - 1)
        if guess in seen:
            guess = (lo + hi) // 2
        seen[guess] = predicted(cfg, guess, seq, remat)
        last.append(guess)


def fresh(torch, cfg, rows, seq, dev):
    """The seeded state and tokens of one step."""
    from repro_torch.runtime.train import make_state
    state = make_state(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    tokens = torch.randint(1, cfg.vocab, (rows, seq), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 1))
    return state, {"tokens": tokens}


def step_at(torch, cfg, rows, seq, remat, dev) -> dict:
    """Two in-place fused steps of one microbatch; the second timed."""
    from repro_torch.runtime.train import TrainHyper, build_fused_step
    state, batch = fresh(torch, cfg, rows, seq, dev)
    fused = build_fused_step(cfg, TrainHyper(remat=remat))
    out = {}
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics, _ = fused(state, batch, None, None, 1.0, 1,
                                  step=i, donate=True)
        torch.cuda.synchronize()
        out = {"wall": time.perf_counter() - t0,
               "peak": torch.cuda.max_memory_allocated(),
               "loss": float(metrics["loss"].mean())}
    out["tok_s"] = rows * seq / out["wall"]
    del state, batch
    return out


def same_params(torch, cfg, rows, seq, dev) -> dict:
    """One step of each policy from one state: dots and full against
    none, bit for bit."""
    from repro_torch.runtime.train import TrainHyper, build_fused_step
    ref, out = None, {}
    for remat in POLICIES:
        state, batch = fresh(torch, cfg, rows, seq, dev)
        state, _, _ = build_fused_step(cfg, TrainHyper(remat=remat))(
            state, batch, None, None, 1.0, 1, step=0, donate=True)
        params = [p for _, p in sorted(_flat(state["params"]))]
        del state, batch
        if ref is None:
            ref = params
        else:
            out[remat] = all(torch.equal(a, b) for a, b in zip(ref, params))
        del params
        torch.cuda.empty_cache()
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b:24,zamba2-7b:30")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--shared", type=int, default=2)
    ap.add_argument("--max-rows", type=int, default=64)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("remat_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all()
    gpu = card()
    print(gpu, flush=True)
    result, ok = {"card": gpu, "seq": args.seq, "configs": []}, True
    for spec in args.arch.split(","):
        name, layers = spec.split(":")
        cfg = cut(get_arch(name), int(layers))
        rec = {"arch": name, "layers": cfg.num_layers, "policies": {}}
        for remat in POLICIES:
            t0 = time.perf_counter()
            admitted, pred = largest_rows(cfg, args.seq, remat,
                                          args.max_rows)
            t_dry = time.perf_counter() - t0
            rows, got = admitted, None
            while got is None and rows >= 1:
                try:
                    got = step_at(torch, cfg, rows, args.seq, remat, dev)
                except torch.cuda.OutOfMemoryError as e:
                    print(f"[remat] {name} remat {remat} at {rows} rows: "
                          f"out of memory ({str(e)[:160]})", flush=True)
                    rows = min(rows - 1, int(rows * 0.9))
                gc.collect()
                torch.cuda.empty_cache()
            if got is None:
                ok = False
                got = {"error": "out of memory at every row count"}
            at = pred if rows == admitted else predicted(cfg, rows, args.seq,
                                                         remat)
            got.update(admitted=admitted, admitted_predicted=pred, rows=rows,
                       predicted=at, dry_run_s=t_dry)
            if "peak" in got:
                got["predicted_over_measured"] = at / got["peak"]
                print(f"[remat] {name} at {cfg.num_layers} layers, remat "
                      f"{remat}: the dry run admits {admitted} x "
                      f"{args.seq} a microbatch ({pred / 2 ** 30:.3f} GiB "
                      f"predicted); at {rows} x {args.seq} a step "
                      f"{got['wall']:.4f} s, {got['tok_s']:.1f} training "
                      f"tok/s, peak {got['peak'] / 2 ** 30:.3f} GiB "
                      f"(predicted {at / 2 ** 30:.3f}: predicted / measured "
                      f"{got['predicted_over_measured']:.4f}), loss "
                      f"{got['loss']:.6f}; {gpu}", flush=True)
            rec["policies"][remat] = got
        eq = same_params(torch, cfg, args.shared, args.seq, dev)
        rec["bit_equal_to_none"] = eq
        ok &= all(eq.values())
        print(f"[remat] {name}: one step at {args.shared} x {args.seq} "
              f"from one state: parameters equal none's bit for bit {eq}",
              flush=True)
        result["configs"].append(rec)
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
