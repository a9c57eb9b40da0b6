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


def mamba2_bwd_ref(x, dt, a, bm, c, d, dy, h0=None, dh_t=None):
    """The scan's backward, the reverse recurrence run explicitly in f32.
    With a_t = exp(dt_t A) and G_t the adjoint of h_t, carried back as
    G_t = dy_t C_t^T + a_{t+1} G_{t+1} from dh_t (0 when None):

        dx_t = dt_t G_t B_t + D dy_t
        ddt_t = x_t^T G_t B_t + A a_t <G_t, h_{t-1}>
        dA = sum dt_t a_t <G_t, h_{t-1}>,   dD = sum <dy_t, x_t>
        dB_t = sum_heads dt_t G_t^T x_t,    dC_t = sum_heads h_t^T dy_t
        dh0 = a_1 G_1.

    The states h_{t-1} come from a forward pass, kept for every t.
    x, dy [B,H,T,P]; dt [B,H,T]; a, d [H]; bm, c [B,T,N]; h0, dh_t
    [B,H,P,N] or None.  Returns (dx in x's dtype, ddt [B,H,T] f32, da [H]
    f32, dbm and dc in bm's dtype, dd [H] f32, dh0 [B,H,P,N] f32, or None
    without h0)."""
    b, h, t, p = x.shape
    n = bm.shape[-1]
    f32 = torch.float32
    hs = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    xs, dts, bs, cs, dys = (z.to(f32) for z in (x, dt, bm, c, dy))
    af, df = a.to(f32), d.to(f32)
    decay = torch.exp(dts * af[None, :, None])            # [B,H,T]
    states = [hs]
    for i in range(t):
        hs = hs * decay[:, :, i, None, None] + \
            (dts[:, :, i, None] * xs[:, :, i])[..., :, None] * \
            bs[:, i][:, None, None, :]
        states.append(hs)
    g_next = torch.zeros_like(hs) if dh_t is None else dh_t.to(f32)
    dx, ddt = torch.zeros_like(xs), torch.zeros_like(dts)
    dbm, dc = torch.zeros_like(bs), torch.zeros_like(cs)
    da = torch.zeros((h,), dtype=f32, device=x.device)
    for i in reversed(range(t)):
        xt, dyt, dtt, dec = xs[:, :, i], dys[:, :, i], dts[:, :, i], \
            decay[:, :, i]
        g = g_next + dyt[..., :, None] * cs[:, i][:, None, None, :]
        gb = torch.einsum("bhpn,bn->bhp", g, bs[:, i])
        sig = (g * states[i]).sum((-2, -1))               # <G_t, h_{t-1}>
        dx[:, :, i] = dtt[..., None] * gb + df[None, :, None] * dyt
        ddt[:, :, i] = (xt * gb).sum(-1) + af[None] * dec * sig
        da += (dtt * dec * sig).sum(0)
        dbm[:, i] = torch.einsum("bhpn,bhp->bn", g, dtt[..., None] * xt)
        dc[:, i] = torch.einsum("bhpn,bhp->bn", states[i + 1], dyt)
        g_next = dec[..., None, None] * g
    dd = (dys * xs).sum((0, 2, 3))
    return (dx.to(x.dtype), ddt, da, dbm.to(bm.dtype), dc.to(c.dtype), dd,
            None if h0 is None else g_next)
