"""The Mamba2 SSD scan's dispatcher and one-token decode step.

``mamba2`` runs the full sequence: the CUDA kernel for a tensor on the
card, the plain version (``ref.mamba2_ref``) for a tensor on the CPU.  The
plain version computes the exact recurrence; the kernel's bf16 route the
chunked form at its own chunk length, which matches it at any chunk
length up to rounding (the decay matrix is at most 1 on the causal
triangle), so there is no chunk length here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba2_ssd.mamba2_ssd import mamba2_cuda
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ref
from repro_torch.kernels.moe_gating.ops import resolve


def mamba2(x, dt, a, bm, c, d, h0=None, impl: str = "auto"):
    """x [B,H,T,P]; dt [B,H,T] f32; a, d [H] f32; bm,c [B,T,N]; h0
    [B,H,P,N] f32 or None.  Returns (y [B,H,T,P] in x's dtype, hT [B,H,P,N]
    f32)."""
    if resolve(impl, x) == "torch":
        return mamba2_ref(x, dt, a, bm, c, d, h0)
    return mamba2_cuda(x, dt, a, bm, c, d, h0)


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
