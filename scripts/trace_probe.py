#!/usr/bin/env python3
"""Where a CUDA-only profiler trace loses launch records, on one NVIDIA
GPU.

    python3 scripts/trace_probe.py [--gating N [--settle]] [--zamba2 N]
        [--suite K]

``--gating N``: the MoE gating wrapper at the four shapes of
``tests/test_torch_kernels.py::test_cuda_gating_one_launch_and_replays``,
each call traced N times under ``torch.profiler`` with CUDA activity only
(as that test traced it: one warm-up call, then one call inside the
trace); it counts the traces that hold no record of the call, and holds
each shape's one call against the nodes of a CUDA graph of it (one kernel
node, no memset), N times.  ``--zamba2 N``: ``zamba2-7b``'s forward on
``[2, 1024]`` at full width (random bf16 weights from seed 0), traced N
times as ``chip_smoke.py``'s ``device_trace`` traces it; for each trace
the records of each ``mamba2_ssd`` kernel against the 68 the layers
launch, the trace's record count, and where a short trace's gap lies (the
largest interval between two of the state kernel's starts, over the
median); then the kernel nodes of a CUDA graph of the same forward.
``--settle``: the gating traces open with a kernel and a 50 ms pause
before the traced call, as ``chip_smoke.py``'s ``device_trace`` does
(then only the gating kernel's records count); each part reports the
traced call's start after the trace's start.  ``--suite K``: the
``cuda``-marked tests of the port, K times, each in a
process of its own, with the outcome of the gating test.  It prints the
card's name and power limit, and each part's findings, one JSON line a
part.  It exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GATING_SHAPES = ((8, 1, 16, 2), (1, 4096, 16, 2), (3, 700, 16, 2),
                 (1, 513, 128, 8))
MAMBA_KERNELS = ("mamba2_ssd_state_kernel", "mamba2_ssd_pass_kernel",
                 "mamba2_ssd_scan_kernel")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def cuda_records(torch, prof):
    """(name, start ns, end ns) of every CUDA activity record of a trace,
    by start."""
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    return sorted(out, key=lambda r: r[1])


def gating_part(torch, n, settle=False) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.graphs import capture_nodes
    from repro_torch.kernels.moe_gating.moe_gating import gating_cuda
    rng = np.random.default_rng(0)
    out = {}
    for g, t, e, k in GATING_SHAPES:
        x = torch.as_tensor(rng.standard_normal((g, t, e)),
                            dtype=torch.float32, device="cuda")
        gating_cuda(x, k)
        torch.cuda.synchronize()
        empty, short, nodes_bad, offsets = [], [], 0, []
        for i in range(n):
            time.sleep(0.05)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                if settle:
                    torch.ones(1, device="cuda").add_(1)
                    torch.cuda.synchronize()
                    time.sleep(0.05)
                gating_cuda(x, k)
                torch.cuda.synchronize()
                time.sleep(0.05)
            recs = cuda_records(torch, prof)
            if settle:
                recs = [r for r in recs if "gating" in r[0]]
            if recs:
                # the call's start after the trace's, in µs
                offsets.append(round((recs[0][1] - prof.profiler
                                      .kineto_results.trace_start_ns())
                                     / 1e3, 1))
            if not recs:
                empty.append(i)
            elif len(recs) != 1:
                short.append((i, [r[0][:40] for r in recs]))
            nodes, _ = capture_nodes(torch, lambda: gating_cuda(x, k))
            kern = [nm for kind, nm in nodes if kind == "kernel"]
            memset = sum(kind == "memset" for kind, _ in nodes)
            if len(kern) != 1 or "gating" not in kern[0] or memset:
                nodes_bad += 1
        out[f"{g}-{t}-{e}-{k}"] = {"traces": n, "empty": empty,
                                   "other": short, "graph_checks": n,
                                   "start_offsets_us": [min(offsets),
                                                        max(offsets)]
                                   if offsets else None,
                                   "graph_checks_failed": nodes_bad,
                                   "graph_nodes": [list(x) for x in nodes]}
    return out


def zamba2_part(torch, n) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.graphs import capture_nodes
    from repro_torch.models import lm
    cfg = get_arch("zamba2-7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init(cfg, gen, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 1024)),
                           dtype=torch.long, device="cuda")
    want = lm.type_counts(cfg)["mamba"]
    traces = []
    with torch.no_grad():
        lm.forward(params, {"tokens": toks}, cfg)
        reset_launches()
        lm.forward(params, {"tokens": toks}, cfg)
        host = LAUNCHES["mamba2_ssd"]

        def settle():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)

        for i in range(n):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                settle()
                lm.forward(params, {"tokens": toks}, cfg)
                torch.cuda.synchronize()
                settle()
            recs = cuda_records(torch, prof)
            counts = {kn: sum(kn in r[0] for r in recs)
                      for kn in MAMBA_KERNELS}
            starts = [r[1] for r in recs if MAMBA_KERNELS[0] in r[0]]
            gaps = np.diff(starts) if len(starts) > 1 else np.zeros(1)
            j = int(np.argmax(gaps))
            # which records sit in the largest gap's span: the kernels the
            # lost layer would have run between its neighbours
            lo, hi = (starts[j], starts[j + 1]) if len(starts) > 1 else (0, 0)
            inside = [r[0][:60] for r in recs if lo < r[1] < hi]
            traces.append({
                "records": len(recs), "mamba": counts,
                "first_record": recs[0][0][:40] if recs else None,
                "last_record": recs[-1][0][:40] if recs else None,
                "largest_gap_at": j, "largest_gap_over_median":
                    float(gaps[j] / max(np.median(gaps), 1)),
                "records_in_largest_gap": len(inside),
                "short": any(v != want for v in counts.values())})
        try:
            nodes, _ = capture_nodes(
                torch, lambda: lm.forward(params, {"tokens": toks}, cfg))
        except RuntimeError as e:       # a probe: report, do not stop
            return {"layers": want, "host_launches": host,
                    "traces": traces, "graph_error": str(e)[:300]}
    kern = [nm for kind, nm in nodes if kind == "kernel"]
    graph = {kn: sum(kn in nm for nm in kern) for kn in MAMBA_KERNELS}
    return {"layers": want, "host_launches": host, "traces": traces,
            "graph_kernel_nodes": len(kern), "graph_mamba": graph,
            "graph_memsets": sum(kind == "memset" for kind, _ in nodes)}


def suite_part(k) -> list:
    out = []
    for _ in range(k):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", *sorted(str(p) for p in
                                         (ROOT / "tests").glob(
                                             "test_torch_*.py"))],
            cwd=ROOT, capture_output=True, text=True,
            env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src"),
                 "JAX_PLATFORMS": "cpu"})
        tail = r.stdout.strip().splitlines()[-1:] if r.stdout else []
        failed = [ln for ln in r.stdout.splitlines()
                  if ln.startswith("FAILED")]
        out.append({"rc": r.returncode, "summary": tail,
                    "failed": failed[:10],
                    "seconds": round(time.perf_counter() - t0, 1)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gating", type=int, default=0)
    ap.add_argument("--zamba2", type=int, default=0)
    ap.add_argument("--suite", type=int, default=0)
    ap.add_argument("--settle", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build_all()
    print(card(), flush=True)
    print(torch.__version__, torch.version.cuda, flush=True)
    if args.gating:
        print(json.dumps({"gating": gating_part(torch, args.gating,
                                                args.settle)}), flush=True)
    if args.zamba2:
        print(json.dumps({"zamba2": zamba2_part(torch, args.zamba2)}),
              flush=True)
    if args.suite:
        print(json.dumps({"suite": suite_part(args.suite)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
