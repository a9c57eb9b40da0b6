#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together), prints each kernel's
   registers and spills, and fails unless every bf16 flash, Mamba2 SSD and
   RWKV6 chunk kernel issues tensor-core instructions (HMMA in its SASS)
   and spills nothing;
2. ``[serve]``: serves ``paper-moe-100m`` at full width (8 layers, d_model
   512, 16 experts + 2 spare slots, vocab 32000; random weights from a
   seed) with the fused gating and dispatch flags on, through
   ``BatchedServer.generate`` and so the ``ServeEngine``, whose tick
   replays a CUDA graph of the decode step (captured in a warm-up): 8
   prompts of mixed lengths 16..128, 32 new tokens each — the MoE main
   path, with every kernel's launch count set to 0 just before it and read
   just after (each replay credits the launches its capture recorded, and
   the counts must be exactly replays x that); then the same work again
   under a CUDA-only ``torch.profiler`` trace, for the device's busy share
   of the untraced main path's wall time;
3. ``[graph]``: a prefill tick and a decode tick through the graphed and
   the eager tick from the same state, logits, tokens, positions and
   caches equal bit for bit, and both ticks' host wall;
   ``[kernel]``: holds each MoE kernel against its plain torch version on
   the card, on the inputs of the decode step at the serve shape (integer
   outputs equal, float outputs within the stated tolerance), and times
   both, with CUDA-graph replay so the times are device times; gating also
   at E 128, k 8 over 4096 tokens;
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
   ``zamba2-7b``'s shared-attention shape and a ragged length; the forward
   timed at the training and ``zamba2-7b`` shapes beside
   ``scaled_dot_product_attention``, the backward at the training shape
   beside aten's flash-attention backward, all by CUDA-graph replay;
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
   ``BatchedServer.generate`` on 4 prompts of 16..64 tokens (after a
   warm-up that captures the tick's graph); greedy
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


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_mma_kernel<64>`` from a mangled kernel name (a
    length-prefixed identifier ending in ``_kernel``, then its template
    arguments)."""
    import re
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            ident = mangled[m.end():m.end() + int(digits[i:])]
            if ident.endswith("_kernel") and ident[0].isalpha():
                arg = re.match(r"ILi(\d+)E", mangled[m.end() + len(ident):])
                return ident + (f"<{arg.group(1)}>" if arg else "")
    return mangled[:60]


# bf16 kernels that must issue tensor-core instructions (HMMA in their
# SASS), by library: the names that mark them and how many there are (one
# per head dim or state size); none of them may spill
TENSOR_CORE_KERNELS = {
    "flash_attention": (("_mma_kernel",), 9),
    "mamba2_ssd": (("mamba2_ssd_state_kernel", "mamba2_ssd_scan_kernel"),
                   8),
    "rwkv6_scan": (("rwkv6_scan_chunk_kernel",), 4)}
NO_SPILLS = tuple(m for marks, _ in TENSOR_CORE_KERNELS.values()
                  for m in marks)


def build_report(build) -> None:
    """Each kernel's registers and spills (ptxas) and, for the libraries of
    TENSOR_CORE_KERNELS, each kernel's tensor-core instructions (HMMA in
    the SASS); fails if a bf16 kernel issues none or spills."""
    import re
    import shutil
    spilled = []
    for src, text in build.PTXAS_LOG.items():
        name = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill, nbytes = _kernel_name(m.group(1)), "", 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = f", spill stores {m.group(1)} B, loads {m.group(2)} B"
                nbytes = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                log(f"[build] {src}: {name}: {m.group(1)} registers{spill}")
                if nbytes and any(k in name for k in NO_SPILLS):
                    spilled.append(name)
    if spilled:
        raise AssertionError(f"bf16 kernels that spill: {spilled}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, (marks, count) in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run(
            [tool, "-sass", str(build.build_dir() / f"lib{lib}.so")],
            capture_output=True, text=True, check=True).stdout
        hmma, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = _kernel_name(line.split("Function :")[1].strip())
                hmma.setdefault(name, 0)
            elif name and "HMMA" in line:
                hmma[name] += 1
        log(f"[build] {lib} SASS, HMMA instructions by kernel: "
            f"{dict(sorted(hmma.items()))}")
        bf16 = {n: c for n, c in hmma.items() if any(k in n for k in marks)}
        if len(bf16) != count or min(bf16.values()) == 0:
            raise AssertionError(f"bf16 {lib} kernels without tensor-core "
                                 f"instructions: {bf16}")


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


def compare_outputs(name, got, ref, n_int, tol):
    """The first ``n_int`` outputs equal, the rest within ``tol``; returns
    the largest float error."""
    for a, b in zip(got[:n_int], ref[:n_int]):
        if not a.equal(b):
            raise AssertionError(f"{name}: integer outputs differ")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got[n_int:], ref[n_int:]))
    if err > tol:
        raise AssertionError(f"{name}: max |err| {err} > {tol}")
    return err


def gating_row(torch, logits, k, launches, name="moe_gating"):
    """The gating kernel against its plain version on ``logits`` [G,T,E]:
    ids and phi exact, weights within 1e-6 (the kernel sums the softmax
    denominator in another order, so weights may differ by ulps); both
    timed.  Returns the kernels JSON row."""
    from repro_torch.kernels.moe_gating.moe_gating import gating_cuda
    from repro_torch.kernels.moe_gating.ref import gating_ref
    g_, t_, e_ = logits.shape
    w, ids, cnt = gating_cuda(logits, k)
    rw, rids, rcnt = gating_ref(logits, k)
    err = compare_outputs(name, (ids, cnt, w), (rids, rcnt, rw), 2, 1e-6)
    nb = 4 * (g_ * t_ * e_ + 2 * g_ * t_ * k + g_ * e_)
    b_ms, b_by = bound_ms(nb, g_ * t_ * e_ * (5 + 2 * k))
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating/moe_gating.py:18",
        launches=launches, max_abs_err=err,
        ms=graph_ms(torch, lambda: gating_cuda(logits, k)),
        plain_ms=graph_ms(torch, lambda: gating_ref(logits, k)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_kernels(torch, seen, launches):
    """Kernel vs plain version on the captured inputs; returns the rows of
    the kernels JSON line and the shapes each kernel ran at.  Raises on a
    mismatch."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_dispatch.moe_dispatch import (combine_cuda,
                                                               dispatch_cuda)
    from repro_torch.kernels.moe_dispatch.ref import combine_ref, dispatch_ref
    rows, shapes = [], {}
    compare = compare_outputs

    logits, k = seen["gating_cuda"]
    rows.append(gating_row(torch, logits, k, launches["moe_gating"]))
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
    call, bytes moved, (operations, their peak rate), shapes).  bf16 runs
    the chunked form on the tensor cores, so its operations are the chunked
    form's products at the bf16 rate; f32 runs the exact recurrence on the
    CUDA cores."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import (CHUNK, SUB,
                                                           rwkv6_cuda)
    r, k, v, w, u, s0 = args
    b, h, t, n = r.shape
    # r, k, v, w read once and y written once; u; s0 (if any) and sT
    n_states = 1 if s0 is None else 2
    nbytes = r.element_size() * 5 * b * h * t * n + \
        4 * (h * n + n_states * b * h * n * n)
    if r.dtype == torch.bfloat16:
        # per token and head, each f32 operand in two bf16 pieces (three
        # products where both operands are f32, two where one is v): its
        # row of y_state, (r.Gpre) S (3 x 2N^2), and of the state update,
        # (k.Gpost)^T v (2 x 2N^2); per chunk, A_ij = q k^T for the pairs
        # of distinct sub-chunks (3 x 2N a (t, s) pair) and A V over the
        # sub-chunk blocks on or below the diagonal (2 x 2N a pair).  The
        # diagonal blocks' A and the decays run on the CUDA cores beside
        # the products and are left out.
        ns = CHUNK // SUB
        chunks = t / CHUNK
        pairs_qk = SUB * SUB * ns * (ns - 1) // 2 * chunks
        pairs_av = SUB * SUB * ns * (ns + 1) // 2 * chunks
        ops = (b * h * (10 * n * n * t + 6 * n * pairs_qk +
                        4 * n * pairs_av), BF16_FLOP_PER_S)
    else:
        # per token and head: y = r.S (2N^2), r*u*k summed (3N), + bonus*v
        # (2N), S = w*S + k*v (3N^2)
        ops = (b * h * t * (5 * n * n + 5 * n), F32_FLOP_PER_S)
    return (lambda: rwkv6_cuda(*args)), (lambda: rwkv6_ref(*args)), \
        nbytes, ops, \
        {"r,k,v,w": [b, h, t, n], "dtype": str(r.dtype), "s0": s0 is not None}


def scan_mamba2(torch, args):
    """The Mamba2 scan on one captured call's inputs: (kernel call, plain
    call, bytes moved, (operations, their peak rate), shapes).  bf16 runs
    the chunked form on the tensor cores, so its operations are the chunked
    form's products at the bf16 rate; f32 runs the exact recurrence on the
    CUDA cores."""
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import CHUNK, mamba2_cuda
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
    if x.dtype == torch.bfloat16:
        # per token and head: its row of the chunk's state, x.w B (2PN),
        # and C h_in^T (2PN); per pair of a token and one at or before it
        # in its chunk, and head, (C B^T . L) x (2P); each with its f32
        # operand in two bf16 pieces; per pair, C B^T (2N) once for all
        # heads.  The f32
        # element-wise work (about 5P a token and head, one exp a pair and
        # head) runs on the CUDA cores beside the products and takes less
        # time than they do, so it is left out.
        full, rest = divmod(t, CHUNK)
        pairs = full * CHUNK * (CHUNK + 1) // 2 + rest * (rest + 1) // 2
        ops = (b * h * (2 * 4 * p * n * t + 2 * 2 * p * pairs) +
               b * 2 * n * pairs, BF16_FLOP_PER_S)
    else:
        # per token and head: exp(dt a) (2), dt*x (P), h = h*dec + xd*B
        # (3PN), y = h.C (2PN), + D x (2P)
        ops = (b * h * t * (5 * p * n + 3 * p + 2), F32_FLOP_PER_S)
    return (lambda: mamba2_cuda(*args)), (lambda: mamba2_ref(*args)), \
        nbytes, ops, {"x": [b, h, t, p], "B,C": [b, t, n],
                        "dtype": str(x.dtype), "h0": h0 is not None}


# kernel name (= its source csrc/<name>.cu) -> (inputs to timed calls, its
# wrapper's name in the dispatcher module, the TPU kernel it replaces)
SCANS = {"rwkv6_scan": (scan_rwkv6, "rwkv6_cuda",
                        "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:20"),
         "mamba2_ssd": (scan_mamba2, "mamba2_cuda",
                        "src/repro/kernels/mamba2_ssd/mamba2_ssd.py:17")}


# the device kernels each wrapper call of a scan launches once (the bf16
# route of the model)
SCAN_KERNELS = {"rwkv6_scan": ("rwkv6_scan_chunk_kernel",),
                "mamba2_ssd": ("mamba2_ssd_state_kernel",
                               "mamba2_ssd_pass_kernel",
                               "mamba2_ssd_scan_kernel")}


def check_scan(torch, name, args, launches, tag):
    """A scan kernel against its plain version on the captured inputs,
    both timed; returns the kernels JSON row.  Tolerance: y within one ulp
    of its dtype (2^-7 relative in bf16: the kernel sums in another order,
    so a value may round to the neighbouring ulp) plus 1e-4 of y's scale;
    the final f32 state within 1e-4 of its scale."""
    scan, _, replaces = SCANS[name]
    kern, plain, nbytes, ops, shapes = scan(torch, args)
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
    b_ms, b_by = bound_ms(nbytes, *ops)
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


def ssm_phase(torch, dev, ph, fails) -> tuple:
    """One recurrent family at full width: the forward (its main path),
    the scan kernel against its plain version, forward == decode, serving
    and engine == static.  Returns the scan kernel's JSON row and the
    forward's launch counts; a check that does not hold is appended to
    ``fails`` (so that one run reports every phase) and the caller
    fails."""
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
        # one flash_fwd launch per occurrence of the shared attention block
        if launches["flash_fwd"] != counts.get("shared_attn", 0):
            raise AssertionError(f"{tag}: {launches['flash_fwd']} flash_fwd "
                                 f"launches in the forward, expected "
                                 f"{counts.get('shared_attn', 0)}")
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
        log_trace(tag, by_name, 6)
        # the scan's kernels (every one named <name>_*) summed: one launch
        # of each per recurrent layer
        mine = {k: v for k, v in by_name.items() if f"{name}_" in k}
        log(f"[{tag}] {name} in the trace: {len(mine)} kernels, "
            f"{sum(v[0] for v in mine.values())} launches, "
            f"{sum(v[1] for v in mine.values()):.1f} us")
        for kern in SCAN_KERNELS[name]:
            n_k = sum(v[0] for k, v in mine.items() if kern in k)
            if n_k != want:
                fails.append(f"{tag}: {n_k} {kern} launches in the traced "
                             f"forward, expected {want}")
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
    # warm-up: the tick's graph is captured on the engine's first tick
    srv.generate([p[:16] for p in prompts], 4)
    replays0 = srv.engine()._tick.graphed.replays
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
        f"ticks (warm-up included), "
        f"{srv.engine()._tick.graphed.replays - replays0} replays of the "
        f"tick's graph")
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
    log(f"[{tag}] ServeEngine (graphed tick) vs generate_static on "
        f"{list(SSM_STATIC)} + {SSM_NEW}: equal {np.array_equal(got, ref)}, "
        f"engine "
        f"{t_engine:.4f} s, static {t_static:.4f} s")
    return row, launches


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


def device_trace(torch, fn, gaps=None):
    """Run ``fn()`` under a CUDA-only ``torch.profiler`` trace (no CPU
    activity, so the host's op dispatch is not traced).  Returns the traced
    call's wall seconds, the device time summed over the trace in µs (one
    stream, so no overlap) and ``{kernel name: [launches, µs]}``.  A list
    ``gaps`` receives the device's idle gaps in µs, between the first
    traced activity and the last."""
    from torch.profiler import ProfilerActivity, profile

    def settle():
        # a kernel and a short host pause on each side of the traced work,
        # so that no record of it is lost at the trace's edges
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        settle()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        settle()
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n = by_name.setdefault(e.name, [0, 0.0])
            n[0] += 1
            n[1] += e.time_range.elapsed_us()
            spans.append((e.time_range.start, e.time_range.end))
    if gaps is not None:
        spans.sort()
        end = spans[0][1] if spans else 0
        for a, b in spans[1:]:
            if a > end:
                gaps.append(a - end)
            end = max(end, b)
    busy = sum(v[1] for v in by_name.values())
    if busy <= 0:
        raise AssertionError("the CUDA trace recorded no device time")
    return wall, busy, by_name


def log_trace(tag, by_name, top) -> None:
    """Log the ``top`` kernels of a trace by device time, then every other
    kernel of the port's (they sit in an anonymous namespace)."""
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for i, (name, (n, us)) in enumerate(ranked):
        if i < top or "(anonymous namespace)::" in name:
            log(f"[{tag}]   {us:10.1f} us {n:6d} launches  {name[:90]}")


def serve_kernel_inputs(torch, cfg, params, dev, rng):
    """The MoE kernels' inputs at the decode tick's shapes: four eager runs
    of the tick's own decode step over len(PROMPT_LENS) fresh slots, the
    last call of each kernel kept (the graphed tick replays kernels that no
    wrapper sees)."""
    from repro_torch.engine.serve import build_decode_step
    from repro_torch.models import lm
    b = len(PROMPT_LENS)
    state = lm.init_cache(cfg, b, 16, device=dev)
    step = build_decode_step(cfg, dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)

    @torch.no_grad()
    def run():
        for _ in range(4):
            tok = torch.as_tensor(rng.integers(1, cfg.vocab, b), device=dev)
            step(params, state["caches"], state["pos"], tok, active)
    return capture_kernel_inputs(torch, run)[1]


def graph_check(torch, cfg, params, dev, rng, tag, fails) -> None:
    """One prefill tick (16 tokens: prompts of 16, 11, 7 and 1 over 8
    slots, 2 of them idle) and one decode tick (4 tokens) through the
    graphed and the eager tick, on two pools in the same state: every
    step's logits, the tokens, the positions and every cache leaf must be
    equal bit for bit.  Then both ticks' host wall per decode tick, in
    turns."""
    from repro_torch.engine.serve import SlotPool, SlotTick
    b = len(PROMPT_LENS)
    pools = [SlotPool(cfg, b, 128, dev) for _ in range(2)]
    ticks = [SlotTick(cfg, dev, graph=g) for g in (True, False)]
    for t in ticks:
        t.record = []
    temps, gens = np.zeros(b, np.float32), [None] * b
    active = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)[:b]
    toks = rng.integers(1, cfg.vocab, (b, 16))
    n_given = np.array([16, 11, 7, 1, 16, 16, 1, 1])[:b]
    outs = [t(params, p.caches, p.pos, toks, n_given, active,
              np.ones(b, bool), temps, gens) for t, p in zip(ticks, pools)]
    same_toks = np.array_equal(outs[0][1], outs[1][1])
    dec = np.zeros((b, 4), np.int64)
    dec[:, 0] = outs[0][1][:, -1]
    outs = [t(params, p.caches, p.pos, dec, np.ones(b, np.int64), active,
              np.zeros(b, bool), temps, gens) for t, p in zip(ticks, pools)]
    same_toks = same_toks and np.array_equal(outs[0][1], outs[1][1])
    same_logits = [torch.equal(a, c) for a, c in zip(*(t.record
                                                        for t in ticks))]
    diff = max((a - c).abs().max().item()
               for a, c in zip(*(t.record for t in ticks)))
    same_state = torch.equal(pools[0].pos, pools[1].pos) and all(
        torch.equal(c, pools[1].caches[t][n])
        for t in pools[0].caches for n, c in pools[0].caches[t].items())
    for t in ticks:
        t.record = None
    walls = {True: [], False: []}
    for _ in range(4):
        for t, p in zip(ticks, pools):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t(params, p.caches, p.pos, dec, np.ones(b, np.int64), active,
              np.zeros(b, bool), temps, gens)
            torch.cuda.synchronize()
            walls[t.graph].append(time.perf_counter() - t0)
    g = ticks[0].graphed
    log(f"[graph] {tag}: a prefill tick of 16 and a decode tick of 4 over "
        f"{b} slots, graphed vs eager tick from the same state: logits "
        f"equal bit for bit at {sum(same_logits)} of {len(same_logits)} "
        f"steps (max |diff| {diff}), tokens equal {same_toks}, positions and "
        f"caches equal {same_state}; {g.replays} replays, per replay the "
        f"launches {_nonzero(g.per_replay)}; host wall of a decode tick of 4 "
        f"(in turns, best of 4): graphed {min(walls[True]):.6f} s, eager "
        f"{min(walls[False]):.6f} s")
    if not (all(same_logits) and same_toks and same_state):
        fails.append(f"{tag}: the graphed tick differs from the eager tick")
    del pools, ticks


def replay_spans(torch, eng, fn) -> tuple:
    """Run ``fn()`` with CUDA events around every replay of ``eng``'s tick
    graph (no profiler, which slows the host).  Returns seconds: the wall,
    the device time inside replays, and the time from one replay's end to
    the next one's start, within a tick and across ticks."""
    graphed = eng._tick.graphed
    real, marks = graphed.graph, []

    class Timed:
        def replay(self):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            real.replay()
            b.record()
            marks.append((eng.tick_no, a, b))

    graphed.graph = Timed()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        graphed.graph = real
    inside = sum(a.elapsed_time(b) for _, a, b in marks) / 1e3
    within = across = 0.0
    for (tick0, _, end), (tick1, start, _) in zip(marks, marks[1:]):
        if tick0 == tick1:
            within += end.elapsed_time(start) / 1e3
        else:
            across += end.elapsed_time(start) / 1e3
    return wall, inside, within, across


def _nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def moe_phase(torch, dev, fails) -> list:
    """The MoE serving main path, its device trace, the graphed tick
    against the eager one, the MoE kernels against their plain versions,
    and engine == static.  Returns the kernels' JSON rows."""
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

    # warm-up on the same server (first-use costs, the tick's graph
    # capture among them, stay out of the timed run)
    srv.generate([p[:16] for p in prompts], 4)
    graphed = srv.engine()._tick.graphed
    replays0 = graphed.replays

    # the main path
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = srv.generate(prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    replays = graphed.replays - replays0
    if out.shape != (len(prompts), MAX_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"bad serve output {out.shape}")
    missing = [k for k in ("moe_gating", "moe_dispatch", "moe_combine")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    # every launch of the main path is one that a replay of the graph made
    if launches != {k: replays * n for k, n in graphed.per_replay.items()}:
        raise AssertionError(f"main path launches {launches} are not "
                             f"{replays} replays of {graphed.per_replay}")
    gen_toks = out.size
    prompt_toks = sum(PROMPT_LENS)
    eng = srv.engine()
    log(f"[serve] {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
        f"{MAX_NEW} new each: {wall:.4f} s, {gen_toks / wall:.1f} "
        f"generated tok/s, {(gen_toks + prompt_toks) / wall:.1f} "
        f"processed tok/s, {eng.tick_no} ticks; {replays} replays of the "
        f"tick's graph, each credited {_nonzero(graphed.per_replay)}; "
        f"launches {launches}")

    t_tok = {k: v for k, v in eng.engine.costs.snapshot().items()
             if k.endswith("_per_tok") and ":" not in k}
    log(f"[serve] measured per-token tick EMAs (s): {t_tok}")

    # the main path's work once more under a CUDA-only trace: its device
    # time over the untraced main path's wall gives the busy share; the
    # trace must see the replays' kernels (one gating launch per MoE layer
    # and replay)
    ticks0, replays0 = eng.tick_no, graphed.replays
    gaps = []
    wall_t, busy_us, by_name = device_trace(
        torch, lambda: srv.generate(prompts, MAX_NEW), gaps)
    busy = busy_us / 1e6 / wall
    traced = sum(n for name, (n, _) in by_name.items() if "gating" in name)
    want = (graphed.replays - replays0) * graphed.per_replay["moe_gating"]
    log(f"[profile] main path's work again under a CUDA-only trace "
        f"({eng.tick_no - ticks0} ticks, {graphed.replays - replays0} "
        f"replays, traced wall {wall_t:.4f} s): device busy {busy_us:.0f} "
        f"us; over the untraced main path's wall {wall:.4f} s: busy "
        f"{busy:.4f}, idle {1 - busy:.4f}; gating kernels in the trace "
        f"{traced} (replays x per replay {want})")
    if traced != want:
        fails.append(f"serve: the trace saw {traced} gating kernels of the "
                     f"replays' {want}")
    # the device's idle gaps by length: the host's work between ticks
    # (planning, the tick's host copy) shows as gaps of about a millisecond,
    # one a tick; launch gaps inside a replayed step as microseconds
    parts = []
    for lo, hi in ((0, 20), (20, 500), (500, float("inf"))):
        sel = [g for g in gaps if lo <= g < hi]
        parts.append(f"[{lo}, {hi}): {len(sel)} gaps, {sum(sel) / 1e3:.3f} "
                     f"ms, {sum(sel) / 1e6 / wall_t:.4f} of the traced wall")
    log(f"[profile] device idle gaps in the trace, by length in us: "
        f"{'; '.join(parts)}; {eng.tick_no - ticks0} ticks (the trace "
        f"slows the host: its traced wall is longer)")
    # the same work with CUDA events around every replay, untraced: where
    # the wall goes between the graph's replays
    ticks0 = eng.tick_no
    wall_e, inside, within, across = replay_spans(
        torch, eng, lambda: srv.generate(prompts, MAX_NEW))
    log(f"[profile] the same work with events around each replay, "
        f"untraced: wall {wall_e:.4f} s over {eng.tick_no - ticks0} ticks; "
        f"inside replays {inside:.4f} s ({inside / wall_e:.4f} of the wall), "
        f"between replays of one tick {within:.4f} s ({within / wall_e:.4f}),"
        f" between ticks {across:.4f} s ({across / wall_e:.4f})")
    log_trace("profile", by_name, 8)

    graph_check(torch, cfg, srv.params, dev, rng, cfg.name, fails)

    seen = serve_kernel_inputs(torch, cfg, srv.params, dev, rng)
    rows, shapes = check_kernels(torch, seen, launches)
    # gating at E 128, k 8 (qwen3-moe-235b-a22b's routing) over a
    # microbatch of 4096 tokens; no main path runs it yet
    wide = torch.randn((1, 4096, 128), generator=gen, device=dev)
    rows.append(gating_row(torch, wide, 8, 0, "moe_gating@e128"))
    shapes["moe_gating@e128"] = {"logits": list(wide.shape), "k": 8,
                                 "tol": 1e-6}
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
    log(f"[equiv] ServeEngine (graphed tick) == generate_static on [4, 64] "
        f"+ {MAX_NEW}: engine {t_engine:.4f} s, static {t_static:.4f} s")
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


def sdpa_backward(torch, q, k, v, do):
    """One call of aten's flash-attention backward (the backward of
    ``scaled_dot_product_attention``'s flash backend) on heads-first causal
    inputs, as a closure that a CUDA graph can capture."""
    aten = torch.ops.aten
    o, lse, cq, ck, mq, mk, seed, offset = \
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True)[:8]
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset)


def flash_phase(torch, dev, launches) -> list:
    """The flash-attention kernels against their plain version (chunked
    attention in bf16, differentiated by autograd) and an f32 materialised
    oracle, forward and backward, at each of FLASH_CASES; timed at the
    training shape (forward and backward) and at zamba2-7b's (forward),
    beside ``scaled_dot_product_attention``.  ``launches`` are the [train]
    main path's counts.  Returns the JSON rows: flash_fwd and flash_bwd,
    and flash_fwd@zamba2, whose launches the [zamba2] forward fills in."""
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
        if tag in ("train", "zamba2"):
            qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                               for x in (q, k, v, do))
            with torch.no_grad():
                timed = [("flash_fwd", False, errs["o"], dict(
                    ms=graph_ms(torch, lambda: flash_fwd_cuda(q, k, v),
                                reps=10),
                    plain_ms=graph_ms(torch, lambda: chunked_attention(
                        q, k, v), reps=10),
                    library_ms=graph_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, is_causal=True), reps=10)))]
                if tag == "train":
                    timed.append(("flash_bwd", True, max(
                        errs["dq"], errs["dk"], errs["dv"]), dict(
                        ms=graph_ms(torch, lambda: flash_bwd_cuda(
                            q, k, v, o, lse, do), reps=10),
                        library_ms=graph_ms(torch, sdpa_backward(
                            torch, qh, kh, vh, doh), reps=10))))
            if tag == "train":
                timed[1][3]["plain_ms"] = event_ms(
                    torch, lambda: torch.autograd.grad(
                        po, ps, do, retain_graph=True))
            for name, bwd, err, t in timed:
                b_ms, b_by = flash_bound(b, s, h, hd, 2, bwd)
                rows.append(dict(
                    name=name if tag == "train" else f"{name}@{tag}",
                    route="cuda",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention/"
                             "flash_attention.py:58",
                    launches=launches[name] if tag == "train" else 0,
                    max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    library_ms=t["library_ms"]))
                lib = "aten flash backward" if bwd else \
                    "scaled_dot_product_attention"
                log(f"[flash] {name} at {[b, s, h, hd]}: {t['ms']:.4f} ms "
                    f"(plain {t['plain_ms']:.4f} ms, {lib} "
                    f"{t['library_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                    f"{b_by}; all by CUDA-graph replay but the plain "
                    f"backward, timed between events)")
            del qh, kh, vh, doh
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
    log_trace("train", by_name, 10)
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
    build_report(build)

    fails = []
    rows = moe_phase(torch, dev, fails)
    _free(torch)
    train_rows, train_launches = train_phase(torch, dev, fails)
    flash_rows = flash_phase(torch, dev, train_launches)
    rows += flash_rows + train_rows
    for ph in SSM_PHASES:
        _free(torch)
        row, launches = ssm_phase(torch, dev, ph, fails)
        rows.append(row)
        for r in flash_rows:
            if r["name"] == f"flash_fwd@{ph['tag']}":
                r["launches"] = launches["flash_fwd"]
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
