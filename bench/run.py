"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for
(``BENCHMARK.json``).  A run draws its weights and traffic from the seed,
warms up the step heights the cell's traffic uses, starts the mix's
clients, opens the window ``warmup_s`` later and measures for
``--seconds``, checks a sample of what was served against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with a trace also
``breakdown``, and last ``compared`` (each number checked, with its
limit).  Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke")


def _paths(root: Path) -> None:
    for p in (root / "src", root / "bench"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run in a checkout builds."""
    cache = root / "build" / "bench-cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _histogram(ticks) -> dict:
    out: dict = {}
    for t in ticks:
        if t.rows:
            k = f"{t.height}x{t.positions // t.rows}"
            out[k] = out.get(k, 0) + 1
    return dict(sorted(out.items()))


def _diag(recs, ticks, t_start, t_open, t_close) -> dict:
    """What the logs read: requests sent and finished in the window, the
    first finishing times from the clients' start, and the queue for a
    slot."""
    sent = [r.t_submit for r in recs if r.phase != "ladder"]
    fin = sorted(r.t_done for r in recs if r.phase != "ladder" and r.t_done)
    return {"sent": sum(t_open <= t < t_close for t in sent),
            "finished": sum(t_open <= t < t_close for t in fin),
            "first_done_s": [round(t - t_start, 3) for t in fin[:8]],
            "queued_open": ticks[0].queued if ticks else 0,
            "queued_close": ticks[-1].queued if ticks else 0}


def run_cell(spec, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             t0: float = T0) -> dict:
    """One run of ``cell``; returns the result's fields, ``diag``, and
    with ``control`` every reading of the check and its control
    (``readings``)."""
    import torch
    from benchkit import check, drive, model, traffic, weights as W
    from benchkit.trace import Tracer, untraced
    from repro_torch.runtime.serve import BatchedServer

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    ref = spec.reference(cfg["family"])
    arch = model.arch_config(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    tree = W.draw(ref.layout(cfg), traffic.torch_seed(seed, "weights"),
                  device)
    model.check_layout(arch, W.shapes(tree))
    server = BatchedServer(arch, tree, device=device, **mix["server"])
    client = drive.Client(server, cfg)
    vocab = cfg["vocab_size"]
    drive.ladder(client, traffic.Stream(mix, vocab, seed, "ladder"),
                 mix["ladder"])
    sync()
    t_ladder = time.perf_counter()
    if trace:
        Tracer.prime()
    # the clients start at once; the window opens ``warmup_s`` later
    source = drive.ClosedSource(traffic.Stream(mix, vocab, seed,
                                               "measured"),
                                mix["clients"], "measured", client)
    t_start, n_warm = client.clock(), len(client.ticks)
    drive.serve(client, [source], lambda t: t >= t_start + mix["warmup_s"])

    # the window
    t_open = client.clock()
    setup_s = t_open - t0
    heights_open = drive._captured(client) or set()
    for r in client.live:
        r.sampled = True
    tracer = None
    if trace:
        mid = t_open + seconds / 2
        tracer = Tracer(client, mid - mix["trace_s"] / 2,
                        mid + mix["trace_s"] / 2)
    n_ticks = len(client.ticks)
    drive.serve(client, [source], lambda t: t >= t_open + seconds,
                on_tick=tracer.on_tick if tracer else (lambda t: None))
    t_close = client.clock()
    if tracer:
        tracer.close()
    window_ticks = client.ticks[n_ticks:]
    in_window = sorted((drive._captured(client) or set()) - heights_open)
    for r in client.recs:
        if r.t_submit >= t_open:
            r.sampled = True
    # the check judges finished requests: the requests in flight go on
    # (no new ones) until ``min_requests`` of the sampled ones have
    # finished, or the cap
    need, cap = mix["check"]["min_requests"], t_close + mix["drain_cap_s"]
    drive.serve(client, [], lambda t: t >= cap or sum(
        r.sampled and r.t_done is not None for r in client.recs) >= need)
    sampled = [r for r in client.recs if r.sampled]
    t_end = client.clock()
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    run = {"open": t_open, "close": t_close, "sampled": sampled, "setup_s": setup_s,
           "ticks": untraced(window_ticks, tracer and tracer.span),
           "trace": tracer.read() if tracer else None}
    if tracer:
        log(f"[bench] trace: {tracer.seen}, profiler on "
            f"{tracer.span[1] - tracer.span[0]:.3f} s")
    log(f"[bench] {cell} seed {seed}: set-up {setup_s:.3f} s (ladder "
        f"{t_ladder - t0:.3f} s), window {t_close - t_open:.3f} s, "
        f"{len(window_ticks)} ticks, drain {t_end - t_close:.3f} s, "
        f"{len(sampled)} sampled, step heights captured "
        f"{sorted(drive._captured(client) or [])}, in the window "
        f"{in_window}, window ticks by (height, positions a row): "
        f"{_histogram(window_ticks)}, warm-up's "
        f"{_histogram(client.ticks[n_warm:n_ticks])}")

    sample = check.pick(client.recs, seed, **mix["check"])
    diag = _diag(client.recs, window_ticks, t_start, t_open, t_close)
    seqs, starts, served = check.sequences(sample)
    # the program's state goes before the reference runs
    del client, server, source, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    got = check.gaps(ref, cfg, tree, seqs, starts, served, control)
    sync()
    number, limit = "logit_gap", float(cfg["check"]["limit"])
    log(f"[bench] check: {len(sample)} requests, "
        f"{sum(len(s) for s in served)} served tokens, reference "
        f"{time.perf_counter() - t_ref:.3f} s, readings {got}")

    metrics = {}
    for m in spec.metrics(cell, trace):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(sample) and got[number] <= limit,
           "attempted": len(sampled), "failed": 0,
           "metrics": metrics, "device": dev}
    if run["trace"] is not None:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = run["trace"]["breakdown"]
    out["compared"] = {number: {"value": got[number], "limit": limit}}
    if control:
        out["readings"] = got
    out["diag"] = diag
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths(ROOT)
    _caches(ROOT)
    import torch
    from benchkit.spec import Spec

    spec = Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[bench] {args.workload} needs {chips} CUDA device(s); this "
            f"machine has {torch.cuda.device_count()}: no result")
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
        log(f"[bench] card: {smi}")
    except (OSError, subprocess.SubprocessError) as e:
        log(f"[bench] nvidia-smi: {e}")
    torch.set_num_threads(4)
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"[bench] modules of JAX or the JAX package loaded: {bad}; "
            "no result")
        return 3
    log(f"[bench] diag {json.dumps(out['diag'])}")
    for k, v in out["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    out.pop("diag")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
