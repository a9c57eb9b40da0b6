"""Launch wrappers for the CUDA MoE dispatch and combine kernels
(``csrc/moe_dispatch.cu``).

``dispatch_cuda`` replaces ``dispatch_pallas`` and ``combine_cuda``
replaces ``combine_pallas`` (src/repro/kernels/moe_dispatch/
moe_dispatch.py:98 and :129).  The wrappers validate, allocate outputs and
scratch, launch on the current stream and raise on a refused launch; they
never fall back to the plain versions.  Each kernel is also the other's
backward (``ops.Dispatch``, ``ops.Combine``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fns():
    so = lib("moe_dispatch")
    d, c = so.moe_dispatch_launch, so.moe_combine_launch
    d.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    c.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    d.restype = c.restype = ctypes.c_int
    return d, c


def _check_routing(name, x, shape, dtype, device):
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be on {device}")
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")


def dispatch_cuda(v, w, slot, valid, n_slots: int, cap: int):
    """v [G,T,D] (f32 or bf16); w [G,T,k] f32; slot/valid [G,T,k] i32 ->
    (buf [G,S,C,D], rank [G,T,k] i32, keep [G,T,k] i32, routed [G,S] i32,
    kept [G,S] i32)."""
    if not v.is_cuda or v.dim() != 3 or v.dtype not in _DTYPES:
        raise ValueError("v must be a [G,T,D] float32/bfloat16 CUDA tensor")
    g, t, d = v.shape
    k = slot.shape[-1]
    _check_routing("w", w, (g, t, k), torch.float32, v.device)
    _check_routing("slot", slot, (g, t, k), torch.int32, v.device)
    _check_routing("valid", valid, (g, t, k), torch.int32, v.device)
    v, w, slot, valid = (a.contiguous() for a in (v, w, slot, valid))
    dev = v.device
    buf = torch.empty((g, n_slots, cap, d), dtype=v.dtype, device=dev)
    rank = torch.empty((g, t, k), dtype=torch.int32, device=dev)
    keep = torch.empty((g, t, k), dtype=torch.int32, device=dev)
    routed = torch.empty((g, n_slots), dtype=torch.int32, device=dev)
    kept = torch.empty((g, n_slots), dtype=torch.int32, device=dev)
    owner = torch.empty((g, n_slots, cap), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fns()[0](v.data_ptr(), w.data_ptr(), slot.data_ptr(),
                    valid.data_ptr(), buf.data_ptr(), rank.data_ptr(),
                    keep.data_ptr(), routed.data_ptr(), kept.data_ptr(),
                    owner.data_ptr(), g, t, k, d, n_slots, cap,
                    _DTYPES[v.dtype], stream)
    check(err, "moe_dispatch launch")
    LAUNCHES["moe_dispatch"] += 1
    return buf, rank, keep, routed, kept


def combine_cuda(buf, w, slot, rank, keep):
    """buf [G,S,C,D] (f32 or bf16); w [G,T,k] f32; slot/rank/keep [G,T,k]
    i32 -> y [G,T,D] in buf's dtype."""
    if not buf.is_cuda or buf.dim() != 4 or buf.dtype not in _DTYPES:
        raise ValueError("buf must be a [G,S,C,D] float32/bfloat16 CUDA "
                         "tensor")
    g, s, cap, d = buf.shape
    t, k = slot.shape[1:]
    _check_routing("w", w, (g, t, k), torch.float32, buf.device)
    for name, x in (("slot", slot), ("rank", rank), ("keep", keep)):
        _check_routing(name, x, (g, t, k), torch.int32, buf.device)
    buf, w, slot, rank, keep = (a.contiguous()
                                for a in (buf, w, slot, rank, keep))
    y = torch.empty((g, t, d), dtype=buf.dtype, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = _fns()[1](buf.data_ptr(), w.data_ptr(), slot.data_ptr(),
                    rank.data_ptr(), keep.data_ptr(), y.data_ptr(),
                    g, t, k, d, s, cap, _DTYPES[buf.dtype], stream)
    check(err, "moe_combine launch")
    LAUNCHES["moe_combine"] += 1
    return y
