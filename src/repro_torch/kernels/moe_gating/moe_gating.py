"""Launch wrapper for the CUDA MoE gating kernel (``csrc/moe_gating.cu``).

Replaces ``gating_pallas`` (src/repro/kernels/moe_gating/moe_gating.py:48).
The kernel runs one warp per token; the wrapper validates its inputs,
allocates the outputs, launches on the current stream and raises on a
refused launch.  It never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, lib

MAX_K = 8
MAX_E = 128


@functools.lru_cache(maxsize=None)
def _fn():
    f = lib("moe_gating").moe_gating_launch
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def gating_cuda(logits: torch.Tensor, k: int):
    """logits [G,T,E] f32 on a CUDA device -> (weights [G,T,k] f32,
    experts [G,T,k] i32, counts [G,E] i32)."""
    if not logits.is_cuda:
        raise ValueError("gating_cuda needs a CUDA tensor")
    if logits.dim() != 3 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be [G,T,E] float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    g, t, e = logits.shape
    if not (1 <= k <= min(MAX_K, e)) or e > MAX_E:
        raise ValueError(f"unsupported k={k}, E={e} (k <= {MAX_K}, "
                         f"E <= {MAX_E})")
    x = logits.contiguous()
    w = torch.empty((g, t, k), dtype=torch.float32, device=x.device)
    ids = torch.empty((g, t, k), dtype=torch.int32, device=x.device)
    counts = torch.zeros((g, e), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), w.data_ptr(), ids.data_ptr(),
                counts.data_ptr(), g, t, e, k, stream)
    check(err, "moe_gating launch")
    LAUNCHES["moe_gating"] += 1
    return w, ids, counts
