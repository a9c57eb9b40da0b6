#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. serves ``paper-moe-100m`` at full width (8 layers, d_model 512, 16
   experts + 2 spare slots, vocab 32000; random weights from a seed) with
   the fused gating and dispatch flags on, through ``BatchedServer.generate``
   and so the ``ServeEngine``: 8 prompts of mixed lengths 16..128, 32 new
   tokens each — the main path, with every kernel's launch count set to 0
   just before it and read just after; then the same work again under a
   CUDA-only ``torch.profiler`` trace, for the device's busy share of the
   untraced main path's wall time;
3. holds each kernel against its plain torch version on the card, on the
   inputs the main path's decode ticks gave it (integer outputs equal, float
   outputs within the stated tolerance), and times both, with CUDA-graph
   replay so the times are device times;
4. checks that greedy ``ServeEngine`` output equals ``generate_static`` token
   for token on a 4-row batch (4 rows never overflow a capacity of 4, so
   neither grouping drops an assignment);
5. prints the kernels' JSON line, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or without
the repository's ``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM published peaks (dense): HBM bytes/s and f32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SEED = 0
PROMPT_LENS = (16, 24, 37, 50, 64, 81, 100, 128)
MAX_NEW = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed between two events (no host launch gaps)."""
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
    best = float("inf")
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def capture_kernel_inputs(torch, run):
    """Run ``run()`` with the kernel wrappers wrapped so that each keeps a
    copy of the arguments of its last call."""
    from repro_torch.kernels.moe_dispatch import ops as dops
    from repro_torch.kernels.moe_gating import ops as gops
    seen = {}
    targets = [(gops, "gating_cuda"), (dops, "dispatch_cuda"),
               (dops, "combine_cuda")]
    originals = [getattr(m, n) for m, n in targets]

    def recorder(name, fn):
        def wrapped(*args):
            seen[name] = tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args)
            return fn(*args)
        return wrapped

    for (m, n), fn in zip(targets, originals):
        setattr(m, n, recorder(n, fn))
    try:
        run()
    finally:
        for (m, n), fn in zip(targets, originals):
            setattr(m, n, fn)
    return seen


def check_kernels(torch, seen, launches):
    """Kernel vs plain version on the captured inputs; returns the rows of
    the kernels JSON line and the shapes each kernel ran at.  Raises on a
    mismatch."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_dispatch.moe_dispatch import (combine_cuda,
                                                               dispatch_cuda)
    from repro_torch.kernels.moe_dispatch.ref import combine_ref, dispatch_ref
    from repro_torch.kernels.moe_gating.moe_gating import gating_cuda
    from repro_torch.kernels.moe_gating.ref import gating_ref
    rows, shapes = [], {}

    def compare(name, got, ref, n_int, tol):
        for a, b in zip(got[:n_int], ref[:n_int]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: integer outputs differ")
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got[n_int:], ref[n_int:]))
        if err > tol:
            raise AssertionError(f"{name}: max |err| {err} > {tol}")
        return err

    # gating: ids and phi exact; weights within 1e-6 (the kernel sums the
    # softmax denominator in another order, so weights may differ by ulps)
    logits, k = seen["gating_cuda"]
    g_, t_, e_ = logits.shape
    w, ids, cnt = gating_cuda(logits, k)
    rw, rids, rcnt = gating_ref(logits, k)
    err = compare("moe_gating", (ids, cnt, w), (rids, rcnt, rw), 2, 1e-6)
    nb = 4 * (g_ * t_ * e_ + 2 * g_ * t_ * k + g_ * e_)
    b_ms, b_by = bound_ms(nb, g_ * t_ * e_ * (5 + 2 * k))
    rows.append(dict(
        name="moe_gating", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating/moe_gating.py:18",
        launches=launches["moe_gating"], max_abs_err=err,
        ms=graph_ms(torch, lambda: gating_cuda(logits, k)),
        plain_ms=graph_ms(torch, lambda: gating_ref(logits, k)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    shapes["moe_gating"] = {"logits": list(logits.shape), "k": k,
                            "tol": 1e-6}

    # dispatch: rank/keep/routed/kept exact; the buffer exact (one f32
    # product rounded once, in both)
    v, wd, slot, valid, n_slots, cap = seen["dispatch_cuda"]
    g_, t_, d_ = v.shape
    k = slot.shape[-1]
    got = dispatch_cuda(v, wd, slot, valid, n_slots, cap)
    ref = dispatch_ref(v, wd, slot, valid, n_slots, cap)
    err = compare("moe_dispatch", got[1:] + got[:1], ref[1:] + ref[:1], 4,
                  0.0)
    es = v.element_size()
    nb = es * (g_ * t_ * d_ + g_ * n_slots * cap * d_) + \
        4 * (5 * g_ * t_ * k + 2 * g_ * n_slots)
    b_ms, b_by = bound_ms(nb, g_ * t_ * k * d_)
    rows.append(dict(
        name="moe_dispatch", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_dispatch.cu",
        replaces="src/repro/kernels/moe_dispatch/moe_dispatch.py:38",
        launches=launches["moe_dispatch"], max_abs_err=err,
        ms=graph_ms(torch, lambda: dispatch_cuda(v, wd, slot, valid,
                                                  n_slots, cap)),
        plain_ms=graph_ms(torch, lambda: dispatch_ref(v, wd, slot, valid,
                                                      n_slots, cap)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    shapes["moe_dispatch"] = {"v": list(v.shape), "k": k, "slots": n_slots,
                              "cap": cap, "tol": 0.0}

    # combine: exact (the k terms added in j order in f32, rounded once, in
    # both).  Library yardstick: one embedding_bag call (weighted sum of
    # the gathered buffer rows), timed here and used nowhere in the port.
    buf, wc, slot, rank, keep = seen["combine_cuda"]
    g_, s_, c_, d_ = buf.shape
    t_, k = slot.shape[1:]
    y = combine_cuda(buf, wc, slot, rank, keep)
    ry = combine_ref(buf, wc, slot, rank, keep)
    err = compare("moe_combine", (y,), (ry,), 0, 0.0)
    groups = torch.arange(g_, device=buf.device)[:, None, None]
    bag_idx = ((groups * s_ + slot.long()) * c_ + rank.long()).reshape(-1, k)
    bag_w = (wc * keep).reshape(-1, k).to(buf.dtype)
    table = buf.reshape(-1, d_)
    # the function reads only the kept rows of the buffer (at most k per
    # token), the four routing words of every assignment, and writes y
    es = buf.element_size()
    n_kept = int((keep != 0).sum().item())
    nb = es * (n_kept * d_ + g_ * t_ * d_) + 4 * 4 * g_ * t_ * k
    b_ms, b_by = bound_ms(nb, 2 * n_kept * d_)
    rows.append(dict(
        name="moe_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_dispatch.cu",
        replaces="src/repro/kernels/moe_dispatch/moe_dispatch.py:78",
        launches=launches["moe_combine"], max_abs_err=err,
        ms=graph_ms(torch, lambda: combine_cuda(buf, wc, slot, rank, keep)),
        plain_ms=graph_ms(torch, lambda: combine_ref(buf, wc, slot, rank,
                                                     keep)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: F.embedding_bag(
            bag_idx, table, per_sample_weights=bag_w, mode="sum"))))
    shapes["moe_combine"] = {"buf": list(buf.shape), "tokens": g_ * t_,
                             "k": k, "kept": n_kept, "tol": 0.0}
    return rows, shapes


def device_trace(torch, fn):
    """Run ``fn()`` under a CUDA-only ``torch.profiler`` trace (no CPU
    activity, so the host's op dispatch is not traced).  Returns the traced
    call's wall seconds, the device time summed over the trace in µs (one
    stream, so no overlap) and ``{kernel name: [launches, µs]}``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n = by_name.setdefault(e.name, [0, 0.0])
            n[0] += 1
            n[1] += e.time_range.elapsed_us()
    busy = sum(v[1] for v in by_name.values())
    if busy <= 0:
        raise AssertionError("the CUDA trace recorded no device time")
    return wall, busy, by_name


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {built} in {time.perf_counter() - t0:.2f} s")
    for name, text in build.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"[build] {name}: {line.strip()}")

    base = get_arch("paper-moe-100m")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, fused_gating=True, fused_dispatch=True))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts}+{cfg.moe.spare_slots} "
        f"slots, top-{cfg.moe.top_k}, vocab {cfg.vocab}, {n_params} params")
    max_len = max(PROMPT_LENS) + MAX_NEW + 32
    srv = BatchedServer(cfg, params, max_len=max_len, slots=len(PROMPT_LENS),
                        prefill_chunk=16, decode_chunk=4, device=dev)
    del params
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS]

    # warm-up on the same server (first-use costs stay out of the timed
    # run), keeping the kernels' inputs from its last decode tick
    seen = capture_kernel_inputs(
        torch, lambda: srv.generate([p[:16] for p in prompts], 4))

    # the main path
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = srv.generate(prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if out.shape != (len(prompts), MAX_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"bad serve output {out.shape}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    gen_toks = out.size
    prompt_toks = sum(PROMPT_LENS)
    eng = srv.engine()
    log(f"[serve] {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
        f"{MAX_NEW} new each: {wall:.4f} s, {gen_toks / wall:.1f} "
        f"generated tok/s, {(gen_toks + prompt_toks) / wall:.1f} "
        f"processed tok/s, {eng.tick_no} ticks, launches {launches}")

    t_tok = {k: v for k, v in eng.engine.costs.snapshot().items()
             if k.endswith("_per_tok") and ":" not in k}
    log(f"[serve] measured per-token tick EMAs (s): {t_tok}")

    # the main path's work once more under a CUDA-only trace: its device
    # time over the untraced main path's wall gives the busy share
    ticks0 = eng.tick_no
    wall_t, busy_us, by_name = device_trace(
        torch, lambda: srv.generate(prompts, MAX_NEW))
    busy = busy_us / 1e6 / wall
    log(f"[profile] main path's work again under a CUDA-only trace "
        f"({eng.tick_no - ticks0} ticks, traced wall {wall_t:.4f} s): device "
        f"busy {busy_us:.0f} us; over the untraced main path's wall "
        f"{wall:.4f} s: busy {busy:.4f}, idle {1 - busy:.4f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        log(f"[profile]   {us:10.1f} us {n:6d} launches  {name[:90]}")

    rows, shapes = check_kernels(torch, seen, launches)
    for r in rows:
        log(f"[kernel] {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} "
            f"us by {r['bound_by']}), integer outputs equal, max |err| "
            f"{r['max_abs_err']}, shapes and tolerance {shapes[r['name']]}")

    # greedy ServeEngine == generate_static on a drop-free batch
    srv4 = BatchedServer(cfg, srv.params, max_len=max_len, slots=4,
                         prefill_chunk=16, decode_chunk=4, device=dev)
    batch = rng.integers(1, cfg.vocab, (4, 64)).astype(np.int32)
    t0 = time.perf_counter()
    ref = srv4.generate_static(batch, MAX_NEW)
    t_static = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = srv4.generate(batch, MAX_NEW)
    t_engine = time.perf_counter() - t0
    if not np.array_equal(got, ref):
        bad = np.argwhere(got != ref)[:5].tolist()
        raise AssertionError(f"ServeEngine != generate_static at {bad}")
    log(f"[equiv] ServeEngine == generate_static on [4, 64] + {MAX_NEW}: "
        f"engine {t_engine:.4f} s, static {t_static:.4f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
