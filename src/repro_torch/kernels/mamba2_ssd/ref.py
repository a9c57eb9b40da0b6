"""Plain torch version of the Mamba2 SSD scan: the sequential (exact)
recurrence, per (batch, head), with a ``[P, N]`` f32 state h (P = head dim,
N = d_state):

    h_t = exp(dt_t * A) h_{t-1} + (dt_t * x_t) B_t^T
    y_t = h_t C_t + D * x_t

A < 0 is a scalar per head; B and C are shared across heads (one group).
f32 inside; the D skip is added in f32 and y rounded once to x's dtype.
"""
from __future__ import annotations

import torch


def mamba2_ref(x, dt, a, bm, c, d, h0=None):
    """x [B,H,T,P]; dt [B,H,T]; a [H]; bm,c [B,T,N]; d [H]; h0 [B,H,P,N]
    f32 or None.  Returns (y [B,H,T,P] in x's dtype, hT [B,H,P,N] f32)."""
    b, h, t, p = x.shape
    n = bm.shape[-1]
    f32 = torch.float32
    hs = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    xs, dts, bs, cs = x.to(f32), dt.to(f32), bm.to(f32), c.to(f32)
    af = a.to(f32)
    ys = []
    for i in range(t):
        dtt = dts[:, :, i]                                 # [B,H]
        decay = torch.exp(dtt * af[None])
        hs = hs * decay[..., None, None] + \
            (dtt[..., None] * xs[:, :, i])[..., :, None] * \
            bs[:, i][:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hs, cs[:, i]))
    y = torch.stack(ys, 2) if ys else torch.zeros_like(xs)
    y = y + d.to(f32)[None, :, None, None] * xs
    return y.to(x.dtype), hs
