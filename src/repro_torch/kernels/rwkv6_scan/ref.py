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
