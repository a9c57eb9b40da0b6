"""Launch wrapper for the CUDA RWKV6 WKV scan (``csrc/rwkv6_scan.cu``).

Replaces ``rwkv6_pallas`` (src/repro/kernels/rwkv6_scan/rwkv6_scan.py:59).
bf16 runs the chunked form on the tensor cores (chunks of ``CHUNK`` tokens
cut into sub-chunks of ``SUB``, every decay a product of the w's, so no
clamp);
f32 runs the exact recurrence on the CUDA cores.  The wrapper validates
its inputs, allocates the outputs, launches on the current stream and
raises on a refused launch; it never falls back to the plain version.  The
four ``[B,H,T,N]`` inputs may be strided views (the model hands over
``[B,T,H,N]`` activations transposed), as long as they share strides and
N is contiguous; y is allocated in the same layout, so the caller's
transpose back is free.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64, 128)
# tokens a chunk and a sub-chunk of the bf16 route (the kernel's L and SUB;
# the CPU tests emulate the kernel at these lengths)
CHUNK, SUB = 64, 16


@functools.lru_cache(maxsize=None)
def _fn():
    f = lib("rwkv6_scan").rwkv6_scan_launch
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
        [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def rwkv6_cuda(r, k, v, w, u, s0=None):
    """r,k,v,w [B,H,T,N] (f32 or bf16, one dtype) on a CUDA device; u [H,N];
    s0 [B,H,N,N] or None.  Returns (y [B,H,T,N] in r's dtype, sT [B,H,N,N]
    f32)."""
    if not r.is_cuda or r.dim() != 4 or r.dtype not in _DTYPES:
        raise ValueError("r must be a [B,H,T,N] float32/bfloat16 CUDA "
                         "tensor")
    b, h, t, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"head size {n} not in {HEAD_SIZES}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.device != r.device or x.shape != r.shape or x.dtype != r.dtype:
            raise ValueError(f"{name} must match r: {tuple(r.shape)} "
                             f"{r.dtype} on {r.device}")
    ins = [r, k, v, w]
    if r.stride(-1) != 1 or any(x.stride() != r.stride() for x in ins):
        ins = [x.contiguous() for x in ins]
    dev = r.device
    u = u.to(device=dev, dtype=torch.float32).contiguous()
    if tuple(u.shape) != (h, n):
        raise ValueError(f"u must be [{h},{n}], got {tuple(u.shape)}")
    if s0 is not None:
        s0 = s0.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(s0.shape) != (b, h, n, n):
            raise ValueError(f"s0 must be [{b},{h},{n},{n}], got "
                             f"{tuple(s0.shape)}")
    y = torch.empty_like(ins[0])          # keeps the inputs' strides
    s_t = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(*(x.data_ptr() for x in ins), u.data_ptr(),
                0 if s0 is None else s0.data_ptr(), y.data_ptr(),
                s_t.data_ptr(), b, h, t, n, _DTYPES[r.dtype],
                *ins[0].stride()[:3], *y.stride()[:3], stream)
    check(err, "rwkv6_scan launch")
    LAUNCHES["rwkv6_scan"] += 1
    return y, s_t
