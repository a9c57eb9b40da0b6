"""Dry run of every (arch x shape) cell on the ``meta`` device: no tensor
has storage, so nothing is allocated on any device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--mesh 1x1,1x4]
        [--arch <id>[,<id>..]] [--shape <name>[,..]]
        [--remat none|dots|full] [--layout tp|dp] [--kv-dtype bf16|f8]
        [--force-seq-shard] [--microbatches N] [--out results.json]

For every cell that ``cell_applicable`` admits it

(a) builds the abstract state on ``meta``: the parameters (f32 for
    ``train``, with both AdamW moments; bf16 to serve), and for
    ``decode`` the cache through ``lm.init_cache`` (its attention K/V in
    fp8 under ``--kv-dtype f8``);
(b) traces the step at full width on those tensors, which catches shape
    errors: ``train`` runs the fused step (``loss_fn``'s forward and
    backward over one microbatch under the ``--remat`` policy, so a
    recompute's tensors count where the backward makes them; a
    ``--microbatches`` count sets the microbatch's rows), the f32
    gradient sum, the in-place AdamW update), ``prefill``
    ``lm.forward``, ``decode`` ``lm.decode_step``.  The kernels take the card's route, and
    ``meta_kernels`` stands in for their wrappers while it traces: each
    makes its outputs' shapes and launches nothing.  The host values the
    card's code reads from the device are passed in: the fused step's
    ``step`` as a Python int.  A training step of the recurrent configs
    runs the scans' backward kernels, whose stand-ins make their
    checkpoint scratch too, so its bytes count;
(c) records per device, for each mesh: parameter, optimizer, gradient
    and cache bytes from ``runtime.sharding``'s spec tree, the peak of
    the step's other live bytes (``MemTrace``: activations, the bf16
    weights, gradients, scratch; traced on one device and, on a larger
    mesh, assumed split evenly over its devices: the port runs no
    tensor-parallel forward that would show it), the analytic step bytes, FLOPs
    and collective bytes (``analysis.flops``, with the policy's recompute)
    and the roofline's three terms with the H100's constants.  The
    reference's layout options reach the specs, the bytes and the
    roofline: ``--layout dp`` (the batch and activations over ``model``
    too, the MoE over an all-to-all), ``--force-seq-shard``
    (weight-stationary decode: the cache's sequence over ``data``, the
    weights over every device) and ``--kv-dtype f8`` (one byte a K/V
    element);
(d) records whether the cell fits in one card's 80 GB on that mesh and at
    most how many layers would: the bytes at full depth and at one layer
    (a second trace of ``cut(cfg, 1)``) set a line in the layer count.

``--mesh`` takes sizes (``1x4``: data x model, ``2x16x16``: pod x data x
model) or ``production`` and ``production2``: the H100 production mesh of
one and two pods (``launch.mesh.production_mesh``, 32 x 8 and 2 x 32 x 8).

It prints ``PASS``/``FAIL``/``SKIP`` a cell, writes the records as JSON to
``--out``, and exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional
from unittest import mock

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import flops as F
from repro_torch.analysis import roofline as RL
from repro_torch.configs import (ARCH_IDS, SHAPES, ArchConfig, ShapeCfg,
                                 cell_applicable, get_arch)
from repro_torch.kernels.decode_attention.decode_attention import \
    scratch_floats
from repro_torch.kernels.mamba2_ssd.mamba2_ssd import \
    bwd_scratch as mamba2_scratch
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import \
    bwd_scratch as rwkv6_scratch
from repro_torch.launch.mesh import HBM_BYTES, production_mesh
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.train import TrainHyper, build_fused_step

META = torch.device("meta")
F32, I32 = torch.float32, torch.int32


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


# The kernel wrappers' outputs on ``meta``, as each wrapper allocates them
# (``kernels/*/``); their arguments are the wrappers'.
def _gating(logits, k):
    g, t, e = logits.shape
    return _empty((g, t, k), F32), _empty((g, t, k), I32), _empty((g, e), I32)


def _dispatch(v, w, slot, valid, n_slots, cap):
    g, t, d = v.shape
    k = slot.shape[-1]
    return (_empty((g, n_slots, cap, d), v.dtype), _empty((g, t, k), I32),
            _empty((g, t, k), I32), _empty((g, n_slots), I32),
            _empty((g, n_slots), I32))


def _combine(buf, w, slot, rank, keep):
    return _empty((buf.shape[0], slot.shape[1], buf.shape[3]), buf.dtype)


def _flash_fwd(q, k, v, causal=True, window=None, q_offset=0,
               keep_f32=False):
    b, sq, h, _ = q.shape
    o = _empty(q.shape, q.dtype)
    o32 = None
    if keep_f32:
        o32 = o if q.dtype == F32 else _empty(q.shape, F32)
    return o, _empty((b, h, sq), F32), o32


def _flash_bwd(q, k, v, o, lse, do, causal=True, window=None, q_offset=0):
    return tuple(_empty(x.shape, x.dtype) for x in (q, k, v))


def _decode_attn(q, k_cache, v_cache, pos, window=None, rolling=False):
    b, _, h, hd = q.shape
    part = _empty((scratch_floats(b, h, k_cache.shape[1], hd),), F32)
    del part
    return _empty(q.shape, q.dtype)


def _rwkv6(r, k, v, w, u, s0=None):
    b, h, _, n = r.shape
    return _empty(r.shape, r.dtype), _empty((b, h, n, n), F32)


def _mamba2(x, dt, a, bm, c, d, h0=None):
    b, h, _, p = x.shape
    return _empty(x.shape, x.dtype), _empty((b, h, p, bm.shape[-1]), F32)


def _rwkv6_bwd(r, k, v, w, u, dy, s0=None, ds_t=None):
    b, h, t, n = r.shape
    out = tuple(_empty(r.shape, r.dtype) for _ in range(4)) + \
        (_empty((h, n), F32),
         None if s0 is None else _empty((b, h, n, n), F32))
    scratch = [_empty(s, F32)
               for s in rwkv6_scratch(b, h, t, n, r.dtype).values()]
    del scratch
    return out


def _mamba2_bwd(x, dt, a, bm, c, d, dy, h0=None, dh_t=None):
    b, h, t, p = x.shape
    n = bm.shape[-1]
    out = (_empty(x.shape, x.dtype), _empty(dt.shape, F32),
           _empty((h,), F32), _empty((b, t, n), x.dtype),
           _empty((b, t, n), x.dtype), _empty((h,), F32),
           None if h0 is None else _empty((b, h, p, n), F32))
    scratch = [_empty(s, F32)
               for s in mamba2_scratch(b, h, t, p, n, x.dtype).values()]
    del scratch
    return out


@contextlib.contextmanager
def meta_kernels():
    """While it is open, the kernels' dispatchers send a ``meta`` tensor
    down the card's route, and each CUDA wrapper there is replaced by its
    outputs' shapes: the trace sees the card's path (the flash kernels,
    not the plain chunked attention) and launches nothing."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as mb
    from repro_torch.kernels.moe_dispatch import ops as md
    from repro_torch.kernels.moe_gating import ops as mg
    from repro_torch.kernels.rwkv6_scan import ops as rw
    real = mg.resolve

    def resolve(impl, x):
        return "cuda" if x.is_meta and impl == "auto" else real(impl, x)

    fakes = [(mg, "gating_cuda", _gating), (md, "dispatch_cuda", _dispatch),
             (md, "combine_cuda", _combine),
             (fa, "flash_fwd_cuda", _flash_fwd),
             (fa, "flash_bwd_cuda", _flash_bwd), (rw, "rwkv6_cuda", _rwkv6),
             (mb, "mamba2_cuda", _mamba2), (rw, "rwkv6_bwd_cuda", _rwkv6_bwd),
             (mb, "mamba2_bwd_cuda", _mamba2_bwd),
             (da, "decode_attn_cuda", _decode_attn)]
    fakes += [(m, "resolve", resolve) for m in (mg, md, fa_ops, rw, mb, da)]
    with contextlib.ExitStack() as stack:
        for mod, name, fn in fakes:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


class MemTrace(TorchDispatchMode):
    """Live and peak bytes of the storages that the traced ops create:
    each new storage is counted once (views and in-place results share
    it) until the last tensor on it dies, as the card's allocator would
    hold it.  The storages of the tensors in ``state`` (made before the
    trace, and written in place by it) are not counted.  An op that makes
    a tensor of any bytes anywhere but on ``meta`` raises: the dry run
    allocates nothing (``torch.utils.checkpoint`` makes an empty marker
    tensor on the CPU, which passes)."""

    def __init__(self, *state):
        super().__init__()
        self.live: Dict[int, Any] = {}      # storage -> (weak ref, bytes)
        for t in tree_leaves(state):
            st = t.untyped_storage()
            self.live[st._cdata] = (StorageWeakRef(st), 0)
        self.cur = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        new = 0
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if not t.is_meta:
                if st.nbytes() == 0:    # e.g. a checkpoint's empty marker
                    continue
                raise RuntimeError(f"the dry run allocated: {func} made a "
                                   f"tensor on {t.device}")
            have = self.live.get(st._cdata)
            if have is not None and not have[0].expired():
                continue
            if have is not None:            # the address of a dead one
                self.cur -= have[1]
            self.live[st._cdata] = (StorageWeakRef(st), st.nbytes())
            new += st.nbytes()
        if new:
            dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
            for k in dead:
                self.cur -= self.live.pop(k)[1]
            self.cur += new
            self.peak = max(self.peak, self.cur)
        return out


def cut(cfg: ArchConfig, layers: int) -> ArchConfig:
    """``cfg`` cut to its first ``layers`` layers."""
    if layers >= cfg.num_layers:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               layer_pattern=cfg.pattern[:layers])


def batch_rows(shape: ShapeCfg) -> int:
    """Rows a step traces: one microbatch of a training step."""
    if shape.kind == "train":
        return shape.global_batch // max(1, shape.microbatches)
    return shape.global_batch


def model_inputs(cfg: ArchConfig, rows: int, seq: int) -> Dict[str, Any]:
    """The model's batch on ``meta``: tokens, whisper's frames, qwen2-vl's
    (t, h, w) ids."""
    out = {"tokens": torch.empty((rows, seq), dtype=torch.long, device=META)}
    if cfg.enc_layers:
        out["frames"] = torch.empty((rows, cfg.enc_seq, cfg.d_model),
                                    dtype=torch.float32, device=META)
    if cfg.mrope:
        out["positions3"] = torch.empty((rows, seq, 3), dtype=torch.long,
                                        device=META)
    return out


def abstract_state(cfg: ArchConfig) -> Dict[str, Any]:
    """f32 parameters, both AdamW moments and the step, on ``meta``."""
    params = lm.abstract(cfg)
    scalar = torch.empty((), dtype=torch.int32, device=META)
    return {"params": params,
            "opt": adamw.OptState(lm.abstract(cfg), lm.abstract(cfg),
                                  scalar),
            "step": scalar.clone()}


KV_DTYPES = {None: None, "bf16": None, "f8": torch.float8_e4m3fn}


def trace_step(cfg: ArchConfig, shape: ShapeCfg, remat: str = "none",
               kv_dtype: Optional[str] = None) -> Dict[str, Any]:
    """(a) and (b): the state on ``meta`` and the step traced over it
    (a training step under the recompute policy ``remat``; a decode step
    over a cache whose attention K/V are ``KV_DTYPES[kv_dtype]``).
    Returns the state (``params``, and ``cache`` for decode) and the peak
    of the step's own live bytes."""
    rows = batch_rows(shape)
    nl = lm.n_moe_layers(cfg)
    plan = moe_lib.identity_plan(cfg, nl, device=META) if nl else None
    ps, pc = (plan.slots, plan.cum) if plan else (None, None)
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        state = abstract_state(cfg)
        out["params"] = state["params"]
        batch = model_inputs(cfg, rows, shape.seq_len)
        fused = build_fused_step(cfg, TrainHyper(remat=remat))
        mem = MemTrace(state["params"], list(state["opt"]), state["step"])
        with meta_kernels(), mem:
            fused(state, batch, ps, pc, 1.0, n_mb=1, step=0, donate=True)
    elif shape.kind == "prefill":
        params = out["params"] = lm.abstract(cfg, torch.bfloat16)
        batch = model_inputs(cfg, rows, shape.seq_len)
        mem = MemTrace(params)
        with torch.no_grad(), meta_kernels(), mem:
            logits, _ = lm.forward(params, batch, cfg, plan=plan)
        _check_shape(logits, (rows, shape.seq_len, cfg.vocab))
    else:
        params = out["params"] = lm.abstract(cfg, torch.bfloat16)
        cache = out["cache"] = lm.init_cache(
            cfg, rows, shape.seq_len, kv_dtype=KV_DTYPES[kv_dtype],
            device=META)
        token = torch.empty((rows, 1), dtype=torch.long, device=META)
        mem = MemTrace(params, cache)
        with torch.no_grad(), meta_kernels(), mem:
            logits, _ = lm.decode_step(params, cache, token, cfg, plan=plan)
        _check_shape(logits, (rows, cfg.vocab))
    out["transient"] = mem.peak
    return out


def _check_shape(x, want):
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"logits {tuple(x.shape)}, want {tuple(want)}")


def device_bytes(cfg: ArchConfig, shape: ShapeCfg, traced, mesh,
                 force_seq_shard: bool = False) -> Dict:
    """(c)'s bytes on one device of ``mesh`` (the cache's sequence over
    ``data`` with ``force_seq_shard``)."""
    pspec = SH.param_specs(cfg, mesh)
    params = traced["params"]
    out = {"params": 0, "optimizer": 0, "gradients": 0, "cache": 0}
    transient = traced["transient"]
    if shape.kind == "train":
        p = SH.bytes_per_device(params, pspec, mesh)
        out.update(params=p, optimizer=2 * p, gradients=p)
        # the f32 gradient sum is made inside the step: counted once, by
        # its spec
        transient -= SH.bytes_per_device(params, pspec, SH.parse_mesh("1x1"))
    else:
        out["params"] = SH.bytes_per_device(params, pspec, mesh)
    if "cache" in traced:
        cache = traced["cache"]
        out["cache"] = SH.bytes_per_device(
            cache["caches"], SH.cache_specs(
                cfg, mesh, shape, cache,
                force_seq_shard=force_seq_shard)["caches"], mesh)
    out["transient"] = transient / mesh.devices
    out["total"] = sum(out.values())
    return out


def dry_cell(cfg: ArchConfig, shape: ShapeCfg, meshes, remat: str = "none",
             layout: str = "tp", kv_dtype: Optional[str] = None,
             force_seq_shard: bool = False,
             microbatches: Optional[int] = None) -> List[Dict]:
    """Every record of one cell, one per mesh, under the recompute policy
    ``remat`` and the reference's layout options (``main``'s flags)."""
    if microbatches:
        shape = dataclasses.replace(shape, microbatches=microbatches)
    kv_bytes = 1 if kv_dtype == "f8" else 2
    t0 = time.perf_counter()
    full = trace_step(cfg, shape, remat, kv_dtype)
    t_trace = time.perf_counter() - t0
    one = None                  # the 1-layer trace, made when needed
    fc = F.step_flops(cfg, shape, remat)
    records = []
    for mesh in meshes:
        mem = device_bytes(cfg, shape, full, mesh, force_seq_shard)
        layers = cfg.num_layers
        if mem["total"] > HBM_BYTES:
            if one is None and cfg.num_layers > 1:
                one = trace_step(cut(cfg, 1), shape, remat, kv_dtype)
            small = device_bytes(cut(cfg, 1), shape, one, mesh,
                                 force_seq_shard)["total"] \
                if one else mem["total"]
            per = (mem["total"] - small) / max(cfg.num_layers - 1, 1)
            layers = max(0, int((HBM_BYTES - small + per) // per)) \
                if per > 0 else 0
        rl = RL.analyze(cfg, shape, mesh.shape, remat=remat, layout=layout,
                        kv_bytes=kv_bytes, seq_shard_decode=force_seq_shard)
        records.append({
            "arch": cfg.name, "shape": shape.name, "mesh": str(mesh),
            "remat": remat, "layout": layout, "kv_dtype": kv_dtype or "bf16",
            "force_seq_shard": force_seq_shard,
            "microbatches": shape.microbatches,
            "act_spec": SH.act_spec_for(cfg, shape, mesh, layout),
            "batch_specs": SH.batch_specs(cfg, shape, mesh, layout),
            "ok": True, "trace_s": round(t_trace, 2),
            "bytes_per_device": mem,
            "fits": mem["total"] <= HBM_BYTES, "max_layers": layers,
            "num_layers": cfg.num_layers,
            "step_flops": {"model": fc.model_flops, "hlo": fc.hlo_flops},
            "step_bytes_per_device": F.step_bytes_per_device(
                cfg, shape, mesh.devices, mesh.shape["model"], remat,
                kv_bytes, force_seq_shard),
            "collective_bytes_per_device": F.collective_bytes_per_device(
                cfg, shape, mesh.shape, layout=layout),
            "roofline": {
                "compute_s": rl.compute_s, "memory_s": rl.memory_s,
                "collective_s": rl.collective_s, "dominant": rl.dominant,
                "usefulness": rl.usefulness,
                "roofline_fraction": rl.roofline_fraction},
        })
    return records


def _mesh(text: str):
    """A ``--mesh`` entry: ``"production"``/``"production2"`` (the H100
    production mesh, one or two pods: ``launch.mesh.production_mesh``) or
    sizes as ``"1x4"``."""
    if text in ("production", "production2"):
        return production_mesh(multi_pod=text == "production2")
    return SH.parse_mesh(text)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="1x1,1x4",
                    help="meshes, data x model (or pod x data x model), "
                         "or production (H100 nodes: 32 x 8) and "
                         "production2 (2 x 32 x 8)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--remat", default="none", choices=("none", "dots",
                                                         "full"),
                    help="the training steps' recompute policy")
    ap.add_argument("--layout", default="tp", choices=("tp", "dp"),
                    help="dp: the batch over data x model, the MoE over "
                    "an all-to-all")
    ap.add_argument("--kv-dtype", default=None, choices=("bf16", "f8"),
                    help="the decode cache's attention K/V dtype")
    ap.add_argument("--force-seq-shard", action="store_true",
                    help="weight-stationary decode: the cache's sequence "
                    "over data")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="a training step's microbatches (by default the "
                    "shape's)")
    ap.add_argument("--out", default=os.path.join("build", "dryrun.json"))
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [_mesh(m) for m in args.mesh.split(",")]
    results = []
    for a in archs:
        cfg = get_arch(a)
        for s in shapes:
            shape = SHAPES[s]
            ok, why = cell_applicable(cfg, shape)
            if not ok:
                for mesh in meshes:
                    print(f"SKIP {a} x {s} x {mesh}: {why}", flush=True)
                    results.append({"arch": a, "shape": s, "mesh": str(mesh),
                                    "ok": None, "skip_reason": why})
                continue
            try:
                recs = dry_cell(cfg, shape, meshes, args.remat, args.layout,
                                args.kv_dtype, args.force_seq_shard,
                                args.microbatches)
            except Exception as e:      # a failed cell is reported, the
                traceback.print_exc()   # run goes on to the next
                for mesh in meshes:
                    print(f"FAIL {a} x {s} x {mesh}: {e}", flush=True)
                    results.append({"arch": a, "shape": s, "mesh": str(mesh),
                                    "ok": False, "error": str(e)[:500]})
                continue
            for r in recs:
                m, rr = r["bytes_per_device"], r["roofline"]
                print(f"PASS {a} x {s} x {r['mesh']}: trace={r['trace_s']}s "
                      f"mem/dev={m['total'] / 1e9:.3f}GB "
                      f"fits={r['fits']} max_layers={r['max_layers']}/"
                      f"{r['num_layers']} dominant={rr['dominant']} "
                      f"roofline={rr['roofline_fraction']:.1%}", flush=True)
                results.append(r)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n = {k: sum(1 for r in results if r.get("ok") is k)
         for k in (True, False, None)}
    print(f"\n== dry-run: {n[True]} pass, {n[False]} fail, {n[None]} skip "
          f"-> {args.out}")
    return 1 if n[False] else 0


if __name__ == "__main__":
    raise SystemExit(main())
