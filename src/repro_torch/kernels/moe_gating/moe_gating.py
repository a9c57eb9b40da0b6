"""Launch wrapper for the CUDA MoE gating kernel (``csrc/moe_gating.cu``).

Replaces ``gating_pallas`` (src/repro/kernels/moe_gating/moe_gating.py:48).
One launch a call: 16 lanes a row for E <= 16 and a warp a row up to
``MAX_E``, a shared-memory histogram per block, and every count of phi
stored by exactly one block (see the source).  ``counts`` comes from
``torch.empty``: the kernel writes all of it.

The kernel's scratch (ticket counters, zeroed once and put back to 0 by
the kernel itself, and per-block partial histograms) belongs to this
module, one pair per device, allocated on the device's first call, which
must not be inside CUDA-graph capture.  It assumes one stream at a time.
The wrapper validates its inputs, launches on the current stream and
raises on a refused launch.  It never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, lib

MAX_K = 8
MAX_E = 128
_SCRATCH = {}           # device -> (tickets [n] i32, partials [2·n·128] i32)


@functools.lru_cache(maxsize=None)
def _fns():
    so = lib("moe_gating")
    f = so.moe_gating_launch
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    f.restype = so.moe_gating_max_blocks.restype = ctypes.c_int
    return f, so.moe_gating_max_blocks()


def _scratch(device):
    """The device's (tickets, partials), made on its first call."""
    have = _SCRATCH.get(device)
    if have is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("moe_gating: its scratch is made outside "
                               "CUDA-graph capture; call it once on this "
                               "device before capturing")
        n = _fns()[1]
        have = (torch.zeros(n, dtype=torch.int32, device=device),
                torch.empty(2 * n * MAX_E, dtype=torch.int32, device=device))
        _SCRATCH[device] = have
    return have


def gating_cuda(logits: torch.Tensor, k: int):
    """logits [G,T,E] f32 on a CUDA device -> (weights [G,T,k] f32,
    experts [G,T,k] i32, counts [G,E] i32)."""
    if not logits.is_cuda:
        raise ValueError("gating_cuda needs a CUDA tensor")
    if logits.dim() != 3 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be [G,T,E] float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    g, t, e = logits.shape
    if not (1 <= k <= min(MAX_K, e)) or e > MAX_E or g < 1 or t < 1:
        raise ValueError(f"unsupported G={g}, T={t}, k={k}, E={e} (G, T >= "
                         f"1, k <= {MAX_K}, E <= {MAX_E})")
    x = logits.contiguous()
    dev = x.device
    launch = _fns()[0]
    tickets, partials = _scratch(dev)
    w = torch.empty((g, t, k), dtype=torch.float32, device=dev)
    ids = torch.empty((g, t, k), dtype=torch.int32, device=dev)
    counts = torch.empty((g, e), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(x.data_ptr(), w.data_ptr(), ids.data_ptr(),
                 counts.data_ptr(), tickets.data_ptr(), partials.data_ptr(),
                 g, t, e, k, stream)
    check(err, "moe_gating launch")
    LAUNCHES["moe_gating"] += 1
    return w, ids, counts
