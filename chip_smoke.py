#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
2. ``[serve]``: serves ``paper-moe-100m`` at full width (8 layers, d_model
   512, 16 experts + 2 spare slots, vocab 32000; random weights from a
   seed) with the fused gating and dispatch flags on, through
   ``BatchedServer.generate`` and so the ``ServeEngine``: 8 prompts of mixed
   lengths 16..128, 32 new tokens each — the MoE main path, with every
   kernel's launch count set to 0 just before it and read just after; then
   the same work again under a CUDA-only ``torch.profiler`` trace, for the
   device's busy share of the untraced main path's wall time;
3. ``[kernel]``: holds each MoE kernel against its plain torch version on
   the card, on the inputs the main path's decode ticks gave it (integer
   outputs equal, float outputs within the stated tolerance), and times
   both, with CUDA-graph replay so the times are device times;
4. ``[equiv]``: checks that greedy ``ServeEngine`` output equals
   ``generate_static`` token for token on a 4-row batch (4 rows never
   overflow a capacity of 4, so neither grouping drops an assignment);
5. ``[rwkv6]`` and ``[zamba2]``: for ``rwkv6-1.6b`` (24 layers, d_model
   2048, 32 heads of 64, vocab 65536) and ``zamba2-7b`` (81 layers: 68
   Mamba2 and 13 occurrences of one shared attention block, d_model 3584,
   112 SSM heads), at full width with random bf16 weights from the seed:
   ``lm.forward`` on ``[4, 1024]`` / ``[2, 1024]`` tokens, the main path
   (launch counts reset just before it and read just after: exactly one
   scan launch per recurrent layer), then again under a CUDA-only trace
   for its device time by kernel; the scan kernel against its plain
   version on one layer's inputs captured from that forward, timed like the
   MoE kernels; forward against step-by-step decode on ``[2, 128]``;
   ``BatchedServer.generate`` on 4 prompts of 16..64 tokens; greedy
   ``ServeEngine`` against ``generate_static`` on ``[4, 32] + 16``.  Each
   model is freed before the next;
6. prints the kernels' JSON line, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or without
the repository's ``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import gc
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

# The recurrent families at full width: the forward's batch (of FWD_LEN
# tokens each), the block type whose every layer launches the scan kernel
# once, and the logit tolerance within which the reference holds its own
# forward against its decode (tests/test_serve_consistency.py).
SSM_PHASES = (
    dict(tag="rwkv6", arch="rwkv6-1.6b", batch=4, block="rwkv",
         kernel="rwkv6_scan", atol=0.08),
    dict(tag="zamba2", arch="zamba2-7b", batch=2, block="mamba",
         kernel="mamba2_ssd", atol=0.25),
)
BLOCK_TOL = 2e-2                # one block, forward vs decode (bf16)
FWD_LEN = 1024
EQUIV_FWD = (2, 128)            # forward vs step-by-step decode
SSM_PROMPT_LENS = (16, 29, 45, 64)
SSM_NEW = 16
SSM_STATIC = (4, 32)            # greedy engine vs static loop, + SSM_NEW


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


def capture_kernel_inputs(torch, run, targets=None, clone=True):
    """Run ``run()`` with the kernel wrappers wrapped so that each keeps its
    last call's arguments (copies, or with ``clone=False`` the tensors
    themselves, for callers whose inputs are never written again).
    ``targets`` are (module, wrapper name) pairs, by default the MoE
    kernels'.  Returns ``(run()'s result, {wrapper name: args})``."""
    if targets is None:
        from repro_torch.kernels.moe_dispatch import ops as dops
        from repro_torch.kernels.moe_gating import ops as gops
        targets = [(gops, "gating_cuda"), (dops, "dispatch_cuda"),
                   (dops, "combine_cuda")]
    seen = {}
    originals = [getattr(m, n) for m, n in targets]

    def recorder(name, fn):
        def wrapped(*args):
            seen[name] = tuple(a.clone() if clone and torch.is_tensor(a)
                               else a for a in args)
            return fn(*args)
        return wrapped

    for (m, n), fn in zip(targets, originals):
        setattr(m, n, recorder(n, fn))
    try:
        out = run()
    finally:
        for (m, n), fn in zip(targets, originals):
            setattr(m, n, fn)
    return out, seen


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


def scan_rwkv6(torch, args):
    """The RWKV6 scan on one captured call's inputs: (kernel call, plain
    call, bytes moved, f32 operations, shapes)."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_cuda
    r, k, v, w, u, s0 = args
    b, h, t, n = r.shape
    # r, k, v, w read once and y written once; u; s0 (if any) and sT
    n_states = 1 if s0 is None else 2
    nbytes = r.element_size() * 5 * b * h * t * n + \
        4 * (h * n + n_states * b * h * n * n)
    # per token and head: y = r.S (2N^2), r*u*k summed (3N), + bonus*v
    # (2N), S = w*S + k*v (3N^2)
    flops = b * h * t * (5 * n * n + 5 * n)
    return (lambda: rwkv6_cuda(*args)), (lambda: rwkv6_ref(*args)), \
        nbytes, flops, {"r,k,v,w": [b, h, t, n], "dtype": str(r.dtype),
                        "s0": s0 is not None}


def scan_mamba2(torch, args):
    """The Mamba2 scan on one captured call's inputs: (kernel call, plain
    call, bytes moved, f32 operations, shapes)."""
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import mamba2_cuda
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ref
    x, dt, a, bm, c, d, h0 = args
    b, h, t, p = x.shape
    n = bm.shape[-1]
    es = x.element_size()
    n_states = 1 if h0 is None else 2
    # x read once and y written once; dt; a, d; B and C (shared by the
    # heads); h0 (if any) and hT
    nbytes = es * (2 * b * h * t * p + 2 * b * t * n) + \
        4 * (b * h * t + 2 * h + n_states * b * h * p * n)
    # per token and head: exp(dt a) (2), dt*x (P), h = h*dec + xd*B (3PN),
    # y = h.C (2PN), + D x (2P)
    flops = b * h * t * (5 * p * n + 3 * p + 2)
    return (lambda: mamba2_cuda(*args)), (lambda: mamba2_ref(*args)), \
        nbytes, flops, {"x": [b, h, t, p], "B,C": [b, t, n],
                        "dtype": str(x.dtype), "h0": h0 is not None}


# kernel name (= its source csrc/<name>.cu) -> (inputs to timed calls, its
# wrapper's name in the dispatcher module, the TPU kernel it replaces)
SCANS = {"rwkv6_scan": (scan_rwkv6, "rwkv6_cuda",
                        "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:20"),
         "mamba2_ssd": (scan_mamba2, "mamba2_cuda",
                        "src/repro/kernels/mamba2_ssd/mamba2_ssd.py:17")}


def check_scan(torch, name, args, launches, tag):
    """A scan kernel against its plain version on the captured inputs,
    both timed; returns the kernels JSON row.  Tolerance: y within one ulp
    of its dtype (2^-7 relative in bf16: the kernel sums in another order,
    so a value may round to the neighbouring ulp) plus 1e-4 of y's scale;
    the final f32 state within 1e-4 of its scale."""
    scan, _, replaces = SCANS[name]
    kern, plain, nbytes, flops, shapes = scan(torch, args)
    y, st = kern()
    ry, rst = plain()
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-4
    dy = (y.float() - ry.float()).abs()
    y_scale = ry.float().abs().max().item()
    s_err = (st - rst).abs().max().item()
    s_scale = rst.abs().max().item()
    over = dy > ulp * ry.float().abs() + 1e-4 * y_scale
    if over.any() or s_err > 1e-4 * s_scale:
        raise AssertionError(f"{name}: y max |err| {dy.max().item()} "
                             f"({int(over.sum())} over the tolerance), "
                             f"state max |err| {s_err} of {s_scale}")
    b_ms, b_by = bound_ms(nbytes, flops)
    row = dict(name=name, route="cuda",
               source=f"src/repro_torch/kernels/csrc/{name}.cu",
               replaces=replaces, launches=launches,
               max_abs_err=dy.max().item(),
               ms=graph_ms(torch, kern, reps=10),
               plain_ms=graph_ms(torch, plain, reps=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[{tag}] kernel {name}: {row['ms'] * 1e3:.2f} us (plain "
        f"{row['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us by "
        f"{b_by}), y max |err| {row['max_abs_err']} (|y| <= {y_scale}), "
        f"state max |err| {s_err} (|s| <= {s_scale}); tolerance: y within "
        f"{ulp:g}*|ref| + 1e-4*max|ref|, state within 1e-4*max|ref| "
        f"(sums in another order); shapes {shapes}")
    return row


def ssm_phase(torch, dev, ph, fails) -> dict:
    """One recurrent family at full width: the forward (its main path),
    the scan kernel against its plain version, forward == decode, serving
    and engine == static.  Returns the scan kernel's JSON row; a check that
    does not hold is appended to ``fails`` (so that one run reports every
    phase) and the caller fails."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.mamba2_ssd import ops as mops
    from repro_torch.kernels.rwkv6_scan import ops as rops
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer

    tag, name = ph["tag"], ph["kernel"]
    cfg = get_arch(ph["arch"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init(cfg, gen, dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in _leaves(params))
    counts = lm.type_counts(cfg)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers {counts}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} attention heads, ssm {cfg.ssm}, "
        f"vocab {cfg.vocab}, {n_params} params (bf16)")
    rng = np.random.default_rng(SEED)

    def tokens(b, s):
        return torch.as_tensor(rng.integers(1, cfg.vocab, (b, s)),
                               dtype=torch.long, device=dev)

    ops_mod = rops if name == "rwkv6_scan" else mops
    with torch.no_grad():
        # warm-up at the main path's shape (allocator growth, GEMM
        # heuristics), so the timed forward is a steady-state one
        lm.forward(params, {"tokens": tokens(ph["batch"], FWD_LEN)}, cfg)
        # the main path; the scan's inputs are fresh tensors in every
        # layer and never written again, so capturing keeps references
        toks = tokens(ph["batch"], FWD_LEN)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, _), seen = capture_kernel_inputs(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg),
            [(ops_mod, SCANS[name][1])], clone=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        want = counts[ph["block"]]
        if launches[name] != want:
            raise AssertionError(f"{tag}: {launches[name]} {name} launches "
                                 f"in the forward, expected {want}")
        if tuple(logits.shape) != (ph["batch"], FWD_LEN, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{tag}: bad forward logits")
        n_tok = ph["batch"] * FWD_LEN
        log(f"[{tag}] forward {list(toks.shape)}: {wall:.4f} s, "
            f"{n_tok / wall:.1f} tok/s, launches {launches}")
        del logits
        # the same forward again under a CUDA-only trace: device time by
        # kernel, and the busy share of the untraced forward's wall
        wall_t, busy_us, by_name = device_trace(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg))
        busy = busy_us / 1e6 / wall
        log(f"[{tag}] forward again under a CUDA-only trace (traced wall "
            f"{wall_t:.4f} s): device busy {busy_us:.0f} us; over the "
            f"untraced forward's wall {wall:.4f} s: busy {busy:.4f}, idle "
            f"{1 - busy:.4f}")
        for kname, (n, us) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][1])[:6]:
            log(f"[{tag}]   {us:10.1f} us {n:6d} launches  {kname[:90]}")
        row = check_scan(torch, name, seen[SCANS[name][1]], launches[name],
                         tag)
        del seen

        # forward == step-by-step decode.  With random weights the full
        # bf16 stack amplifies rounding layer by layer, so the whole
        # model's argmax is held only where the decode's top-2 margin
        # exceeds twice the larger of the reference's tolerance and the
        # logit change that the scan's summation order alone causes (the
        # forward through the plain scan against the forward through the
        # kernel); each block type on its own, which is well conditioned,
        # is held within BLOCK_TOL
        b, s = EQUIV_FWD
        toks = tokens(b, s)
        fwd, _ = lm.forward(params, {"tokens": toks}, cfg)
        again, _ = lm.forward(params, {"tokens": toks}, cfg)
        plain, _ = lm.forward(params, {"tokens": toks}, cfg, impl="torch")
        noise = (plain - fwd).abs().max().item()
        state = lm.init_cache(cfg, b, s, device=dev)
        t0 = time.perf_counter()
        dec = []
        for i in range(s):
            lg, state = lm.decode_step(params, state, toks[:, i:i + 1], cfg)
            dec.append(lg)
        dec = torch.stack(dec, 1)
        t_dec = time.perf_counter() - t0
        del state
        top2 = dec.topk(2, dim=-1).values
        margin_tol = 2 * max(ph["atol"], noise)
        sure = (top2[..., 0] - top2[..., 1]) > margin_tol
        differ = dec.argmax(-1) != fwd.argmax(-1)
        diff = (dec - fwd).abs().max().item()
        log(f"[{tag}] forward vs decode on {list(EQUIV_FWD)}: max |logit "
            f"diff| {diff} (max |logit| {fwd.abs().max().item()}); the "
            f"forward through the plain scan differs from the kernel's by "
            f"{noise}; argmax equal at {int((~differ).sum())} of "
            f"{differ.numel()} positions, {int((sure & differ).sum())} "
            f"differ of the {int(sure.sum())} whose decode top-2 margin "
            f"exceeds {margin_tol} (twice the larger of that and "
            f"{ph['atol']}); a second kernel forward equal bit for "
            f"bit: {torch.equal(again, fwd)}; decode {t_dec:.4f} s "
            f"({s} steps)")
        if (sure & differ).any() or not torch.isfinite(dec).all() or \
                not torch.equal(again, fwd):
            fails.append(f"{tag}: step-by-step decode does not reproduce "
                         f"the forward")
        block_decode_check(torch, cfg, params, toks, tag, fails)
        del fwd, again, plain, dec

    # serving through the engine, and engine == static
    max_len = max(SSM_PROMPT_LENS) + SSM_NEW + 16
    srv = BatchedServer(cfg, params, max_len=max_len, slots=4,
                        prefill_chunk=16, decode_chunk=4, device=dev)
    del params
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in SSM_PROMPT_LENS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = srv.generate(prompts, SSM_NEW)
    wall = time.perf_counter() - t0
    if out.shape != (len(prompts), SSM_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"{tag}: bad serve output {out.shape}")
    log(f"[{tag}] serve {len(prompts)} requests, prompts "
        f"{list(SSM_PROMPT_LENS)}, {SSM_NEW} new each: {wall:.4f} s, "
        f"{out.size / wall:.1f} generated tok/s, {srv.engine().tick_no} "
        f"ticks")
    batch = rng.integers(1, cfg.vocab, SSM_STATIC).astype(np.int32)
    t0 = time.perf_counter()
    ref = srv.generate_static(batch, SSM_NEW)
    t_static = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = srv.generate(batch, SSM_NEW)
    t_engine = time.perf_counter() - t0
    if not np.array_equal(got, ref):
        bad = np.argwhere(got != ref)[:5].tolist()
        fails.append(f"{tag}: ServeEngine != generate_static at {bad}")
    log(f"[{tag}] ServeEngine vs generate_static on {list(SSM_STATIC)} + "
        f"{SSM_NEW}: equal {np.array_equal(got, ref)}, engine "
        f"{t_engine:.4f} s, static {t_static:.4f} s")
    return row


def block_decode_check(torch, cfg, params, toks, tag, fails) -> None:
    """For each block type, its last layer on the hidden states the forward
    feeds it: the full-sequence apply (the scan kernel) against the block's
    step-by-step decode from an empty cache, every output within BLOCK_TOL
    of the output's scale plus BLOCK_TOL relative (bf16 rounds at other
    points in the two paths)."""
    from repro_torch.models import lm
    from repro_torch.models.blocks import BLOCKS
    inputs, applies = {}, {t: BLOCKS[t]["apply"] for t in lm.type_counts(cfg)}

    def recorder(t, fn):
        def apply(p, x, ctx):
            inputs[t] = (p, x)                 # the last occurrence stays
            return fn(p, x, ctx)
        return apply

    for t, fn in applies.items():
        BLOCKS[t]["apply"] = recorder(t, fn)
    try:
        lm.forward(params, {"tokens": toks}, cfg)
    finally:
        for t, fn in applies.items():
            BLOCKS[t]["apply"] = fn
    b, s = toks.shape
    dev = toks.device
    pos = torch.arange(s, device=dev)
    out = []
    for t, (p, x) in inputs.items():
        ref = applies[t](p, x, {"cfg": cfg, "impl": "auto",
                                "positions": pos[None].expand(b, s)})
        cache = BLOCKS[t]["cache"](cfg, b, s, None, dev)
        got = torch.cat([BLOCKS[t]["decode"](
            p, x[:, i:i + 1], cache, {"cfg": cfg, "pos": pos[i].expand(b)})
            for i in range(s)], dim=1)
        err = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        ok = bool((err <= BLOCK_TOL * (scale + ref.float().abs())).all())
        out.append(f"{t} max |diff| {err.max().item()} of {scale}")
        if not ok:
            fails.append(f"{tag}: block {t} decode does not reproduce its "
                         f"forward")
    log(f"[{tag}] each block type's last layer, forward vs step-by-step "
        f"decode on the forward's hidden states {list(toks.shape)}: "
        f"{'; '.join(out)} (tolerance {BLOCK_TOL} of the scale + "
        f"{BLOCK_TOL} relative)")


def _free(torch) -> None:
    """Return the last phase's device memory before the next model."""
    gc.collect()
    torch.cuda.empty_cache()


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


def moe_phase(torch, dev) -> list:
    """The MoE serving main path, its device trace, the MoE kernels against
    their plain versions, and engine == static.  Returns the kernels' JSON
    rows."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer

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
    _, seen = capture_kernel_inputs(
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
    missing = [k for k in ("moe_gating", "moe_dispatch", "moe_combine")
               if launches[k] == 0]
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
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

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

    rows, fails = moe_phase(torch, dev), []
    for ph in SSM_PHASES:
        _free(torch)
        rows.append(ssm_phase(torch, dev, ph, fails))
    if fails:
        raise AssertionError("; ".join(fails))

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
