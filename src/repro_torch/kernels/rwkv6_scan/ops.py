"""The RWKV6 WKV scan's dispatcher and one-token decode step.

``rwkv6`` runs the full sequence: the CUDA kernel for a tensor on the card,
the plain version (``ref.rwkv6_ref``, the exact recurrence) for a tensor on
the CPU.  On the card, f32 runs the exact recurrence and bf16 (the model's
dtype) a chunked form on the tensor cores, chunks of 64 tokens cut into
sub-chunks of 16, whose every decay is a product of the w's (no
exponential, no clamp).  The reference's
chunked form (``rwkv6_chunked``, src/repro/kernels/rwkv6_scan/ops.py:18) is
not ported: its decay factoring clamps the cumulative in-chunk decay at
e^-30 and is wrong at the model's own chunk of 128 tokens with
model-range decays.  The model has no chunk length to pass: the kernel's
is fixed (``rwkv6_scan.CHUNK``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gating.ops import resolve
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_cuda


def rwkv6(r, k, v, w, u, s0=None, impl: str = "auto"):
    """r,k,v,w [B,H,T,N]; u [H,N]; s0 [B,H,N,N] f32 or None.  Returns
    (y [B,H,T,N] in r's dtype, sT [B,H,N,N] f32)."""
    if resolve(impl, r) == "torch":
        return rwkv6_ref(r, k, v, w, u, s0)
    return rwkv6_cuda(r, k, v, w, u, s0)


def rwkv6_decode_step(rt, kt, vt, wt, u, s):
    """One-token update (the serve path).  rt..wt [B,H,N]; u [H,N]; s
    [B,H,N,N] f32.  Returns (y [B,H,N] in rt's dtype, new s f32)."""
    f32 = torch.float32
    y = torch.einsum("bhn,bhnm->bhm", rt.to(f32), s) + \
        (rt * u[None] * kt).sum(-1, keepdim=True).to(f32) * vt.to(f32)
    s_new = wt.to(f32)[..., :, None] * s + \
        kt.to(f32)[..., :, None] * vt.to(f32)[..., None, :]
    return y.to(rt.dtype), s_new
