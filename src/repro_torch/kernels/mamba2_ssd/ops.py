"""The Mamba2 SSD scan's dispatcher and one-token decode step.

``mamba2`` runs the full sequence: the CUDA kernel for a tensor on the
card, the plain version (``ref.mamba2_ref``) for a tensor on the CPU.  The
plain version computes the exact recurrence; the kernel's bf16 route the
chunked form at its own chunk length, which matches it at any chunk
length up to rounding (the decay matrix is at most 1 on the causal
triangle), so there is no chunk length here.

Gradients: on the card, where autograd would record, ``mamba2`` runs
``Mamba2Scan``, the forward kernel differentiated by the backward kernel
(``mamba2_bwd_cuda``); under ``torch.no_grad()`` it launches the forward
kernel alone, as serving does.  On the CPU autograd differentiates the
plain forward.  The Function also takes ``impl="torch"`` (the plain
forward and ``ref.mamba2_bwd_ref``), so the CPU tests run its plumbing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import records, resolve
from repro_torch.kernels.mamba2_ssd.mamba2_ssd import (mamba2_bwd_cuda,
                                                       mamba2_cuda)
from repro_torch.kernels.mamba2_ssd.ref import mamba2_bwd_ref, mamba2_ref


def mamba2(x, dt, a, bm, c, d, h0=None, impl: str = "auto"):
    """x [B,H,T,P]; dt [B,H,T] f32; a, d [H] f32; bm,c [B,T,N]; h0
    [B,H,P,N] f32 or None.  Returns (y [B,H,T,P] in x's dtype, hT [B,H,P,N]
    f32)."""
    if resolve(impl, x) == "torch":
        return mamba2_ref(x, dt, a, bm, c, d, h0)
    if records(x, dt, a, bm, c, d, h0):
        return Mamba2Scan.apply(x, dt, a, bm, c, d, h0, "cuda")
    return mamba2_cuda(x, dt, a, bm, c, d, h0)


class Mamba2Scan(torch.autograd.Function):
    """(x, dt, a, bm, c, d, h0) -> (y, hT) through the forward kernel
    (``impl "cuda"``) or the plain forward (``"torch"``), differentiated by
    the matching backward.  Gradients come back in each input's dtype; an
    unused y or hT has no cotangent (None, not zeros)."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, c, d, h0, impl):
        fwd = mamba2_cuda if impl == "cuda" else mamba2_ref
        y, h_t = fwd(x, dt, a, bm, c, d, h0)
        ctx.save_for_backward(x, dt, a, bm, c, d, h0)
        ctx.impl = impl
        ctx.set_materialize_grads(False)
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        x, dt, a, bm, c, d, h0 = ctx.saved_tensors
        bwd = mamba2_bwd_cuda if ctx.impl == "cuda" else mamba2_bwd_ref
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        grads = bwd(x, dt, a, bm, c, d, dy, h0, dh_t)
        ins = (x, dt, a, bm, c, d, h0)
        return (*(g.to(z.dtype) if need else None
                  for g, z, need in zip(grads, ins, ctx.needs_input_grad)),
                None)


def mamba2_decode_step(xt, dtt, a, bt, ct, d, hs):
    """One-token update (the serve path).  xt [B,H,P]; dtt [B,H]; a, d [H];
    bt,ct [B,N]; hs [B,H,P,N] f32.  Returns (y [B,H,P] in xt's dtype, new
    hs f32)."""
    f32 = torch.float32
    decay = torch.exp(dtt.to(f32) * a[None])
    hs = hs * decay[..., None, None] + \
        (dtt[..., None].to(f32) * xt.to(f32))[..., :, None] * \
        bt.to(f32)[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", hs, ct.to(f32)) + \
        d[None, :, None] * xt.to(f32)
    return y.to(xt.dtype), hs
