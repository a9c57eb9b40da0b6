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
5. ``[train]``: trains ``paper-moe-100m`` at full width with ``TrainLoop``
   (fused gating and dispatch, ``MoEReshaper`` closing the Reshape loop,
   a skewed ``TokenStream``, global batch 8 x 1024 in 2 microbatches):
   first, from the initial state, one step through the kernels against
   the same step through the plain versions (the integer load metrics,
   the loss and every gradient leaf, the plain step replaying the kernel
   step's expert choices; and against the plain MoE kernels alone, the
   attention kernel in both arms, exactly), the granulated step against
   the fused one, and the kernel step run twice; then a warm-up step and
   6 steps of the main path, each step's kernel launches checked against
   what the code predicts, one more step under a CUDA-only trace, and the
   MoE kernels against their plain versions on the inputs of the warm-up
   step's last calls (dispatch and combine as each other's backward);
6. ``[flash]``: the flash-attention forward and backward kernels against
   their plain version (and an f32 oracle) at the training shape,
   ``zamba2-7b``'s shared-attention shape and a ragged length, timed at
   the training shape beside ``scaled_dot_product_attention``;
7. ``[rwkv6]`` and ``[zamba2]``: for ``rwkv6-1.6b`` (24 layers, d_model
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
8. prints the kernels' JSON line, the card's name and power limit, and
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

# H100 SXM published peaks (dense): HBM bytes/s, f32 CUDA-core FLOP/s and
# bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

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


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S
             ) -> tuple:
    """The least time for the work: bytes over the memory rate or
    operations over the peak ``rate`` for their type, the larger."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / rate * 1e3
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


# [train]: paper-moe-100m at full width, trained by TrainLoop with the
# fused kernels on and the Reshape loop closed (as src/repro/launch/
# train.py sets it up), on a skewed token stream
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = 1024, 8, 2, 6
TRAIN_ALPHA = 1.5
# kernels vs plain versions over one full step: loss within 1e-3 relative,
# each gradient leaf within 5e-2 relative L2 (bf16 forward and backward,
# rounded at other points by the attention kernel and cuBLAS)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-3, 5e-2
# a token that the kernel step and the all-plain step first route to
# different experts must be a near-tie of the plain router: a top-k margin
# of at most this many bf16 ulps of the token's largest |logit|
FLIP_MARGIN_ULPS = 4

# [flash]: (tag, [B, S, H, hd]) in the model's layout, bf16, causal: the
# training shape, zamba2-7b's shared attention, and a ragged length
FLASH_CASES = (("train", (4, 1024, 8, 64)), ("zamba2", (2, 1024, 32, 112)),
               ("ragged", (4, 1000, 8, 64)))
# kernel vs plain version (both bf16, each rounding its results at other
# points and after sums in another order), by relative L2 error: over the
# whole tensor within FLASH_RTOL, and within FLASH_TILE_RTOL in every tile
# of FLASH_TILE sequence rows of one head (query rows for o and dq, key
# rows for dk and dv), so that a fault confined to late rows or late KV
# tiles, where the values are small, shows
FLASH_RTOL, FLASH_TILE_RTOL, FLASH_TILE = 5e-3, 1e-2, 64


def event_ms(torch, fn, reps: int = 10) -> float:
    """Device time of one ``fn()`` call between two events, best of three
    runs of ``reps`` calls after a warm-up (for work that a CUDA graph
    cannot capture, such as autograd's backward)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def flash_bound(b, s, h, hd, es, backward):
    """Causal attention over [B, S, H, hd] inputs of ``es`` bytes: (bound
    ms, by).  Operations: 2·hd per (q, k) pair a product, 2 products in the
    forward (QK^T, PV) and 5 in the backward (QK^T, dO·V^T, P^T·dO,
    dS^T·Q, dS·K), at the bf16 tensor-core rate; bytes: q, k, v, o (and
    dO, dq, dk, dv) once, and the f32 log-sum-exp."""
    pairs = b * h * s * (s + 1) // 2
    n = 8 if backward else 4
    return bound_ms(n * b * s * h * hd * es + 4 * b * h * s,
                    (10 if backward else 4) * hd * pairs, BF16_FLOP_PER_S)


def flash_phase(torch, dev, launches) -> list:
    """The flash-attention kernels against their plain version (chunked
    attention in bf16, differentiated by autograd) and an f32 materialised
    oracle, forward and backward, at each of FLASH_CASES; timed at the
    training shape.  ``launches`` are the [train] main path's counts.
    Returns the two kernels' JSON rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_bwd_cuda, flash_fwd_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import chunked_attention
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for tag, (b, s, h, hd) in FLASH_CASES:
        q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = flash_fwd_cuda(q, k, v)
        grads = flash_bwd_cuda(q, k, v, o, lse, do)
        ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
        po = chunked_attention(*ps)
        pgrads = torch.autograd.grad(po, ps, do, retain_graph=True)
        fs = [x.float().requires_grad_(True) for x in (q, k, v)]
        fo = attention_ref(*(x.transpose(1, 2) for x in fs)).transpose(1, 2)
        fgrads = torch.autograd.grad(fo, fs, do.float())
        torch.cuda.synchronize()
        errs, out = {}, []
        for name, got, plain, oracle in zip(
                ("o", "dq", "dk", "dv"), (o,) + grads, (po,) + pgrads,
                (fo,) + fgrads):
            errs[name] = (got.float() - plain.float()).abs().max().item()
            rel = _rel_l2(torch, got, plain)
            tile = _tile_rel_l2(torch, got, plain)
            k_or = _tile_rel_l2(torch, got, oracle)
            p_or = _tile_rel_l2(torch, plain, oracle)
            out.append(f"{name} {rel:.4g}, worst tile {tile:.4g} (worst "
                       f"tile vs f32: kernel {k_or:.4g}, plain {p_or:.4g}; "
                       f"max abs {errs[name]:.4g} of "
                       f"{plain.float().abs().max().item():.4g})")
            if not (rel <= FLASH_RTOL and tile <= FLASH_TILE_RTOL):
                raise AssertionError(
                    f"flash {tag}: {name} kernel vs plain rel L2 {rel}, "
                    f"worst tile {tile} > {FLASH_RTOL}, {FLASH_TILE_RTOL}")
        log(f"[flash] {tag} q,k,v,dO {[b, s, h, hd]} bf16 causal, kernel "
            f"vs plain rel L2: {'; '.join(out)}; tolerance {FLASH_RTOL}, "
            f"{FLASH_TILE_RTOL} in every {FLASH_TILE}-row tile of a head")
        if tag == "train":
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            so = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            doh = do.transpose(1, 2).contiguous()
            with torch.no_grad():
                fwd_t = dict(
                    ms=graph_ms(torch, lambda: flash_fwd_cuda(q, k, v),
                                reps=10),
                    plain_ms=graph_ms(torch, lambda: chunked_attention(
                        q, k, v), reps=10),
                    library_ms=graph_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, is_causal=True), reps=10))
                bwd_ms = graph_ms(torch, lambda: flash_bwd_cuda(
                    q, k, v, o, lse, do), reps=10)
            bwd_t = dict(
                ms=bwd_ms,
                plain_ms=event_ms(torch, lambda: torch.autograd.grad(
                    po, ps, do, retain_graph=True)),
                library_ms=event_ms(torch, lambda: torch.autograd.grad(
                    so, (qh, kh, vh), doh, retain_graph=True)))
            for name, t, bwd, err in (
                    ("flash_fwd", fwd_t, False, errs["o"]),
                    ("flash_bwd", bwd_t, True,
                     max(errs["dq"], errs["dk"], errs["dv"]))):
                b_ms, b_by = flash_bound(b, s, h, hd, 2, bwd)
                rows.append(dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention/"
                             "flash_attention.py:58",
                    launches=launches[name], max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    library_ms=t["library_ms"]))
                log(f"[flash] {name} at {[b, s, h, hd]}: {t['ms']:.4f} ms "
                    f"(plain {t['plain_ms']:.4f} ms, scaled_dot_product_"
                    f"attention {t['library_ms']:.4f} ms, bound "
                    f"{b_ms:.5f} ms by {b_by})")
            del qh, kh, vh, so, doh
        del q, k, v, do, o, lse, grads, ps, po, pgrads, fs, fo, fgrads
        _free(torch)
    return rows


def _rel_l2(torch, a, b) -> float:
    return (torch.linalg.vector_norm((a - b).float()) /
            torch.linalg.vector_norm(b.float()).clamp_min(1e-30)).item()


def _tile_rel_l2(torch, got, ref) -> float:
    """The worst relative L2 error of ``got`` against ``ref`` ([B, S, H,
    hd]) over tiles of FLASH_TILE sequence rows of one batch row and
    head (the last tile of a ragged S is short)."""
    import torch.nn.functional as F
    pad = -got.shape[1] % FLASH_TILE

    def tiles(x):
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
        b, s, h, hd = x.shape
        return x.reshape(b, s // FLASH_TILE, FLASH_TILE, h, hd).square() \
            .sum((2, 4)).sqrt()
    err = tiles(got.float() - ref.float())
    return (err / tiles(ref).clamp_min(1e-30)).max().item()


def _int_diff(torch, a, b) -> int:
    return int((a != b).sum().item())


def _gating_tap(torch, record=None, replay=None):
    """A stand-in for ``models.moe``'s gating call: it records each call's
    router logits and outputs (weights, ids, phi) into ``record``, or
    returns the recorded outputs in order instead of computing them
    (``replay``), so that a second run routes every token exactly as the
    first did."""
    from repro_torch.models import moe as moe_lib
    orig = moe_lib.gating
    it = iter(replay or ())

    def gating(logits, k, impl="auto"):
        if replay is not None:
            return next(it)[1]
        out = orig(logits, k, impl)
        record.append((logits.clone(), tuple(x.clone() for x in out)))
        return out
    return gating


def _first_flips(torch, kern, plain, n_layers) -> list:
    """Where two steps' gating calls (``_gating_tap`` records, microbatch
    by microbatch, layer by layer) first give a token another expert set,
    in each microbatch: (layer, tokens flipped, the worst top-k margin of
    the plain step's router over them — its k-th largest logit less the
    next —, and the worst change of a logit between the two steps), the
    last two in bf16 ulps of the token's largest |logit|.  Later layers
    see hidden states that the flips changed."""
    out = []
    for i, ((lk, ok), (lp, op)) in enumerate(zip(kern, plain)):
        if i % n_layers == 0:
            found = False
        if found:
            continue
        ek, ep = ok[1].sort(-1).values, op[1].sort(-1).values
        flip = (ek != ep).any(-1)
        if not flip.any():
            continue
        found = True
        k = ep.shape[-1]
        top = lp.topk(k + 1, dim=-1).values
        ulp = torch.exp2(torch.floor(torch.log2(lp.abs().amax(-1))) - 7)
        margin = ((top[..., k - 1] - top[..., k]) / ulp)[flip]
        moved = ((lk - lp).abs().amax(-1) / ulp)[flip]
        out.append((i % n_layers, int(flip.sum()), margin.max().item(),
                    moved.max().item()))
    return out


def train_compare(torch, cfg, hyper, state, tokens, plan, fails):
    """Checks from one state on one batch, before the loop trains: the
    full step through the kernels against the same step through the plain
    versions (every one of them; the MoE ones only, with the attention
    kernel in both arms), the granulated step against the fused one, and
    the kernel step run twice."""
    from repro_torch.models import blocks, lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime.train import build_fused_step, build_grad_step
    n_mb = TRAIN_MB
    ps, pc = plan
    mb = TRAIN_BATCH // n_mb
    ints = ("expert_counts", "slot_counts", "dropped")
    gating = moe_lib.gating

    def step(impl):
        return build_fused_step(cfg, hyper, impl)(
            state, {"tokens": tokens}, ps, pc, 1.0, n_mb)

    def mb0_grads(impl):
        grad_mb = build_grad_step(cfg, hyper, impl)[0]
        return grad_mb(state["params"], {"tokens": tokens[:mb]}, ps, pc, 0)

    def worst_leaf(a, b):
        return max(_rel_l2(torch, x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))

    step_routes, mb0_routes = [], []
    try:
        moe_lib.gating = _gating_tap(torch, record=step_routes)
        sk, mk, ok = step("auto")
        moe_lib.gating = _gating_tap(torch, record=mb0_routes)
        gk, _ = mb0_grads("auto")
    finally:
        moe_lib.gating = gating
    loss_k = mk["loss"].mean().item()

    # every plain version: near-tied router logits can send a token to
    # another expert (the attention kernel and the plain attention round
    # bf16 at other points), and a flip changes the later layers' inputs.
    # So the integer metrics are reported, the first flips in each
    # microbatch are held to be near-ties, and the arithmetic is held on a
    # second plain step that replays the kernel step's expert choices
    plain_routes = []
    try:
        moe_lib.gating = _gating_tap(torch, record=plain_routes)
        sp, mp, _ = step("torch")
    finally:
        moe_lib.gating = gating
    loss_p = mp["loss"].mean().item()
    flips = {key: _int_diff(torch, mk[key], mp[key]) for key in ints}
    first = _first_flips(torch, step_routes, plain_routes,
                         lm.n_moe_layers(cfg))
    worst_margin = max((f[2] for f in first), default=0.0)
    log(f"[train] kernels vs every plain version, first flipped expert "
        f"sets per microbatch (layer, tokens, worst plain top-k margin and "
        f"worst logit change, in bf16 ulps of the token's largest |logit|):"
        f" {[(a, b, round(c, 3), round(d, 3)) for a, b, c, d in first]}; "
        f"tolerance {FLIP_MARGIN_ULPS} ulps")
    if worst_margin > FLIP_MARGIN_ULPS:
        fails.append(f"train: a token flipped at a top-k margin of "
                     f"{worst_margin} bf16 ulps, not a near-tie")
    del sp, mp, plain_routes
    try:
        moe_lib.gating = _gating_tap(torch, replay=step_routes)
        sr, mr, _ = step("torch")
        moe_lib.gating = _gating_tap(torch, replay=mb0_routes)
        gr, _ = mb0_grads("torch")
    finally:
        moe_lib.gating = gating
    loss_r = mr["loss"].mean().item()
    diffs = {key: _int_diff(torch, mk[key], mr[key]) for key in ints}
    worst = worst_leaf(gk, gr)
    log(f"[train] one step, kernels vs every plain version (same state and "
        f"batch): loss {loss_k:.7f} vs {loss_p:.7f} (rel "
        f"{abs(loss_k - loss_p) / loss_p:.3g}), integer entries that "
        f"differ {flips} (router near-ties); with the plain step replaying "
        f"the kernel step's expert choices: loss {loss_r:.7f} (rel "
        f"{abs(loss_k - loss_r) / loss_r:.3g}, tolerance "
        f"{TRAIN_LOSS_RTOL}), integer entries that differ {diffs}, "
        f"microbatch-0 gradient leaves worst rel L2 {worst:.4g} (tolerance "
        f"{TRAIN_GRAD_RTOL})")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * loss_p or \
            abs(loss_k - loss_r) > TRAIN_LOSS_RTOL * loss_r or \
            any(diffs.values()) or worst > TRAIN_GRAD_RTOL:
        fails.append("train: the kernel step differs from the plain step")
    del sr, mr, gr, step_routes, mb0_routes
    # the MoE kernels' plain versions, attention through its kernel in both
    orig = blocks.flash_attention
    blocks.flash_attention = lambda q, k, v, impl="auto", **kw: orig(
        q, k, v, impl="auto", **kw)
    try:
        sm, mm, _ = step("torch")
        gm, _ = mb0_grads("torch")
    finally:
        blocks.flash_attention = orig
    diffs = {key: _int_diff(torch, mk[key], mm[key]) for key in ints}
    worst = worst_leaf(gk, gm)
    same_loss = torch.equal(mk["loss"], mm["loss"])
    log(f"[train] one step, kernels vs the plain gating, dispatch and "
        f"combine (attention kernel in both): integer metrics "
        f"{'equal' if not any(diffs.values()) else diffs}; per-microbatch "
        f"losses equal bit for bit: {same_loss}; microbatch-0 gradient "
        f"leaves: worst rel L2 {worst:.4g}; expert_counts per layer of "
        f"microbatch 0: {mk['expert_counts'][0].tolist()}")
    if any(diffs.values()) or worst > TRAIN_GRAD_RTOL:
        fails.append("train: the MoE kernels' step differs from their plain "
                     "versions'")
    del sm, mm, gm
    # granulated (gradient per microbatch, summed, then apply) vs fused
    grad_mb, apply, _ = build_grad_step(cfg, hyper)
    acc, metrics = None, []
    for i in range(n_mb):
        g, m = grad_mb(state["params"],
                       {"tokens": tokens[i * mb:(i + 1) * mb]}, ps, pc,
                       i * mb * TRAIN_SEQ)
        acc = g if acc is None else tree_map(lambda a, b: a + b, acc, g)
        metrics.append(m)
    sg, _ = apply(state, acc, n_mb, 1.0)
    int_eq = all(torch.equal(torch.stack([m[key] for m in metrics]), mk[key])
                 for key in ints)
    pairs = list(zip(tree_leaves(sg["params"]), tree_leaves(sk["params"])))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    worst = max(_rel_l2(torch, a, b) for a, b in pairs)
    log(f"[train] granulated vs fused step: integer metrics equal {int_eq}, "
        f"updated params equal bit for bit {bitwise} (worst rel L2 "
        f"{worst:.3g})")
    if not int_eq or worst > 1e-6:
        fails.append("train: granulated and fused steps differ")
    del sg, acc, metrics
    # the kernel step again: the same bits?
    s2, _, _ = step("auto")
    again = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(s2["params"]), tree_leaves(sk["params"])))
    log(f"[train] the kernel step run twice from the same state gives the "
        f"same parameters bit for bit: {again}")
    del s2, sk, mk, ok, gk


def train_phase(torch, dev, fails):
    """The training main path: ``TrainLoop.run`` on paper-moe-100m at full
    width through the kernels, with the Reshape loop closed.  Returns
    (the MoE kernels' JSON rows at training shapes, the main path's launch
    counts)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.reshape_moe import MoEReshaper
    from repro_torch.core.skew import SkewParams
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.train import TrainHyper

    base = get_arch("paper-moe-100m")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, fused_gating=True, fused_dispatch=True))
    nl = lm.n_moe_layers(cfg)
    stream = TokenStream(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=SEED,
                         class_alpha=TRAIN_ALPHA)
    reshaper = MoEReshaper(cfg, nl, ep_ranks=2,
                           params=SkewParams(eta=0.0, tau=0.2))
    hyper = TrainHyper()
    loop = TrainLoop(cfg, stream, hyper,
                     LoopConfig(microbatches=TRAIN_MB, device="cuda"),
                     reshaper=reshaper, seed=SEED)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, "
        f"{cfg.moe.num_experts}+{cfg.moe.spare_slots} slots top-"
        f"{cfg.moe.top_k}, expert d_ff {cfg.moe.expert_d_ff}, vocab "
        f"{cfg.vocab}, {sum(p.numel() for p in _leaves(loop.state['params']))}"
        f" f32 params; global batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_MB} microbatches, TokenStream class_alpha {TRAIN_ALPHA}, "
        f"Reshape ep_ranks 2, tau 0.2")
    tokens = torch.as_tensor(TokenStream(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=SEED, class_alpha=TRAIN_ALPHA).next()["tokens"], device=dev)
    train_compare(torch, cfg, hyper, loop.state, tokens, loop._plan_args(),
                  fails)
    _free(torch)

    # warm-up step (first-use costs stay out of the main path), keeping the
    # MoE kernels' inputs from its last calls: gating's last forward, and
    # dispatch and combine as each other's backward
    _, seen = capture_kernel_inputs(torch, lambda: loop.run(1))
    # what the code launches per step: per MoE layer and microbatch, the
    # forward's attention, gating, dispatch and combine, and the backward's
    # attention, combine (dispatch's gradient) and dispatch (combine's)
    per_step = {"flash_fwd": nl * TRAIN_MB, "flash_bwd": nl * TRAIN_MB,
                "moe_gating": nl * TRAIN_MB,
                "moe_dispatch": 2 * nl * TRAIN_MB,
                "moe_combine": 2 * nl * TRAIN_MB}

    # the main path
    reset_launches()
    prev, walls = dict(LAUNCHES), []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = loop.run(1)[-1]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        now = dict(LAUNCHES)
        delta = {k: now[k] - prev[k] for k in per_step}
        prev = now
        if delta != per_step:
            fails.append(f"train: step {h['step']} launched {delta}, the "
                         f"code predicts {per_step}")
        if not np.isfinite(h["loss"]):
            fails.append(f"train: step {h['step']} loss {h['loss']}")
        path = loop.engine.decisions[-1]["choice"] \
            if loop.engine.decisions else "?"
        log(f"[train] step {h['step']}: loss {h['loss']:.6f} grad_norm "
            f"{h['grad_norm']:.6f} dropped {int(np.sum(h['dropped']))} "
            f"slot_counts (summed over layers) "
            f"{np.sum(h['slot_counts'], 0).tolist()}; reshape iterations "
            f"{reshaper.iterations}, events {len(reshaper.events)}; "
            f"{walls[-1]:.4f} s, {n_tok / walls[-1]:.1f} training tok/s "
            f"({path} step path); launches {delta}")
    launches = dict(LAUNCHES)
    wall = sum(walls) / len(walls)
    log(f"[train] {TRAIN_STEPS} steps: mean {wall:.4f} s a step, "
        f"{n_tok / wall:.1f} training tok/s; launches {launches}; reshape "
        f"events {[(e.layer, e.hot_expert) for e in reshaper.events]}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB")

    # one more step under a CUDA-only trace: the busy share of a step
    wall_t, busy_us, by_name = device_trace(torch, lambda: loop.run(1))
    busy = busy_us / 1e6 / wall
    log(f"[train] one more step under a CUDA-only trace (traced wall "
        f"{wall_t:.4f} s): device busy {busy_us:.0f} us; over the untraced "
        f"steps' mean wall {wall:.4f} s: busy {busy:.4f}, idle "
        f"{1 - busy:.4f}")
    for kname, (n, us) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][1])[:10]:
        log(f"[train]   {us:10.1f} us {n:6d} launches  {kname[:90]}")
    # the engine picks the step path from measured costs; each path forced
    # for two more steps, for the record
    for path in ("fused", "granulated"):
        loop.lc.step_path = path
        ts = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.run(1)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        log(f"[train] {path} step path forced: {ts} s a step")
    del loop
    _free(torch)
    rows, shapes = check_kernels(torch, seen, launches)
    for r in rows:
        r["name"] += "@train"
        log(f"[train] kernel {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} "
            f"us by {r['bound_by']}), integer outputs equal, max |err| "
            f"{r['max_abs_err']}, shapes and tolerance "
            f"{shapes[r['name'][:-6]]}")
    return rows, launches


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
    _free(torch)
    train_rows, train_launches = train_phase(torch, dev, fails)
    rows += flash_phase(torch, dev, train_launches) + train_rows
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
