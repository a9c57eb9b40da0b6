"""Plain torch version of the RWKV6 WKV scan: the sequential (exact)
recurrence, per (batch, head), with an ``[N_k, N_v]`` f32 state S:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with a data-dependent per-channel decay w_t in (0, 1].  f32 inside; y is
returned in r's dtype, the final state in f32.
"""
from __future__ import annotations

import torch


def rwkv6_ref(r, k, v, w, u, s0=None):
    """r,k,v,w [B,H,T,N]; u [H,N]; s0 [B,H,N,N] f32 or None.  Returns
    (y [B,H,T,N], sT [B,H,N,N] f32)."""
    b, h, t, n = r.shape
    f32 = torch.float32
    s = torch.zeros((b, h, n, n), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    uf = u.to(f32)[None]                                  # [1,H,N]
    rs, ks, vs, ws = (x.to(f32) for x in (r, k, v, w))
    ys = []
    for i in range(t):
        rt, kt, vt, wt = rs[:, :, i], ks[:, :, i], vs[:, :, i], ws[:, :, i]
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, s) +
                  (rt * uf * kt).sum(-1, keepdim=True) * vt)
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    y = torch.stack(ys, 2) if ys else torch.zeros_like(rs)
    return y.to(r.dtype), s


def rwkv6_bwd_ref(r, k, v, w, u, dy, s0=None, ds_t=None):
    """The scan's backward, the reverse recurrence run explicitly in f32.
    With G_t the adjoint of S_t (G_T = ds_t, 0 when None):

        dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
        dk_t = G_t v_t + u * r_t (v_t . dy_t)
        dv_t = G_t^T k_t + (sum_n r u k)_t dy_t
        dw_t[n] = sum_m G_t[n,m] S_{t-1}[n,m]
        du = sum_{b,t} r_t * k_t (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0.

    The states S_{t-1} come from a forward pass, kept for every t.
    r,k,v,w,dy [B,H,T,N]; u [H,N]; s0, ds_t [B,H,N,N] or None.  Returns
    (dr, dk, dv, dw in r's dtype, du [H,N] f32, ds0 [B,H,N,N] f32, or
    None without s0)."""
    b, h, t, n = r.shape
    f32 = torch.float32
    s = torch.zeros((b, h, n, n), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    uf = u.to(f32)[None]                                  # [1,H,N]
    rs, ks, vs, ws, dys = (x.to(f32) for x in (r, k, v, w, dy))
    states = []
    for i in range(t):
        states.append(s)
        s = ws[:, :, i, :, None] * s + \
            ks[:, :, i, :, None] * vs[:, :, i, None, :]
    g = torch.zeros_like(s) if ds_t is None else ds_t.to(f32).clone()
    dr, dk, dv, dw = (torch.zeros_like(rs) for _ in range(4))
    du = torch.zeros((h, n), dtype=f32, device=r.device)
    for i in reversed(range(t)):
        rt, kt, vt, wt, dyt = (x[:, :, i] for x in (rs, ks, vs, ws, dys))
        sp = states[i]
        vdy = (vt * dyt).sum(-1, keepdim=True)            # [B,H,1]
        dr[:, :, i] = torch.einsum("bhnm,bhm->bhn", sp, dyt) + \
            uf * kt * vdy
        dk[:, :, i] = torch.einsum("bhnm,bhm->bhn", g, vt) + uf * rt * vdy
        dv[:, :, i] = torch.einsum("bhnm,bhn->bhm", g, kt) + \
            (rt * uf * kt).sum(-1, keepdim=True) * dyt
        dw[:, :, i] = (g * sp).sum(-1)
        du += (rt * kt * vdy).sum(0)
        g = wt[..., :, None] * g + rt[..., :, None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(r.dtype),
            du, None if s0 is None else g)
