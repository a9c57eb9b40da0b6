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

Gradients: on the card, where autograd would record, ``rwkv6`` runs
``RWKV6Scan``, the forward kernel differentiated by the backward kernel
(``rwkv6_bwd_cuda``); under ``torch.no_grad()`` it launches the forward
kernel alone, as serving does.  On the CPU autograd differentiates the
plain forward.  The Function also takes ``impl="torch"`` (the plain
forward and ``ref.rwkv6_bwd_ref``), so the CPU tests run its plumbing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import records, resolve
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref, rwkv6_ref
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import (rwkv6_bwd_cuda,
                                                       rwkv6_cuda)


def rwkv6(r, k, v, w, u, s0=None, impl: str = "auto"):
    """r,k,v,w [B,H,T,N]; u [H,N]; s0 [B,H,N,N] f32 or None.  Returns
    (y [B,H,T,N] in r's dtype, sT [B,H,N,N] f32)."""
    if resolve(impl, r) == "torch":
        return rwkv6_ref(r, k, v, w, u, s0)
    if records(r, k, v, w, u, s0):
        return RWKV6Scan.apply(r, k, v, w, u, s0, "cuda")
    return rwkv6_cuda(r, k, v, w, u, s0)


class RWKV6Scan(torch.autograd.Function):
    """(r, k, v, w, u, s0) -> (y, sT) through the forward kernel (``impl
    "cuda"``) or the plain forward (``"torch"``), differentiated by the
    matching backward.  Gradients come back in each input's dtype; an
    unused y or sT has no cotangent (None, not zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, impl):
        fwd = rwkv6_cuda if impl == "cuda" else rwkv6_ref
        y, s_t = fwd(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.impl = impl
        ctx.set_materialize_grads(False)
        return y, s_t

    @staticmethod
    def backward(ctx, dy, ds_t):
        r, k, v, w, u, s0 = ctx.saved_tensors
        bwd = rwkv6_bwd_cuda if ctx.impl == "cuda" else rwkv6_bwd_ref
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype)
        grads = bwd(r, k, v, w, u, dy, s0, ds_t)
        ins = (r, k, v, w, u, s0)
        return (*(g.to(x.dtype) if need else None
                  for g, x, need in zip(grads, ins, ctx.needs_input_grad)),
                None)


def rwkv6_decode_step(rt, kt, vt, wt, u, s):
    """One-token update (the serve path).  rt..wt [B,H,N]; u [H,N]; s
    [B,H,N,N] f32.  Returns (y [B,H,N] in rt's dtype, new s f32)."""
    f32 = torch.float32
    y = torch.einsum("bhn,bhnm->bhm", rt.to(f32), s) + \
        (rt * u[None] * kt).sum(-1, keepdim=True).to(f32) * vt.to(f32)
    s_new = wt.to(f32)[..., :, None] * s + \
        kt.to(f32)[..., :, None] * vt.to(f32)[..., None, :]
    return y.to(rt.dtype), s_new
