"""Plain torch version of the fused MoE dispatch/combine kernel family.

The same fused algorithm the CUDA kernels run, per group ``g`` of a leading
group dimension:

* **in-segment rank without a sort**: an assignment's rank is the number of
  earlier valid assignments (flat T·k order) with the same slot, an
  exclusive running histogram, computed here from an exclusive cumsum of
  the slot one-hot.  It equals the stable-argsort rank of
  ``models.moe.dispatch_combine``, bit for bit.
* **capacity mask**: ``keep = valid & (rank < cap)``; rank is 0 where the
  assignment is invalid.
* **bucketed store**: each kept assignment owns one ``(slot, rank)`` row,
  ``buf[s, r] = w · v[tok]`` (f32 product, one rounding), zeros elsewhere.
* **combine**: ``y[t] = Σ_j w · keep · buf[slot, rank]``, the terms added in
  j order in f32 and rounded once — the order the CUDA kernel uses, so the
  two agree exactly.
"""
from __future__ import annotations

import torch


def dispatch_ref(v, w, slot, valid, n_slots: int, cap: int):
    """v [G,T,D]; w [G,T,k] f32; slot/valid [G,T,k] i32.

    Returns (buf [G,S,C,D] in v's dtype, rank [G,T,k] i32, keep [G,T,k]
    i32, routed [G,S] i32, kept [G,S] i32)."""
    g, t, d = v.shape
    k = slot.shape[-1]
    n = t * k
    flat_slot = slot.reshape(g, n).long()
    flat_valid = valid.reshape(g, n) != 0
    # invalid assignments rank in a virtual segment past n_slots-1
    s_eff = torch.where(flat_valid, flat_slot, n_slots)
    oh = (s_eff[..., None] == torch.arange(n_slots + 1, device=v.device)
          ).to(torch.int32)                                 # [G,N,S+1]
    excl = torch.cumsum(oh, dim=1) - oh                     # [G,N,S+1]
    rank = torch.gather(excl, 2, s_eff[..., None])[..., 0]
    keep = flat_valid & (rank < cap)
    rank = torch.where(flat_valid, rank, 0)
    dest = torch.where(keep, flat_slot * cap + rank, n_slots * cap)
    tok = torch.arange(t, device=v.device)[:, None].expand(t, k).reshape(-1)
    rows = (w.reshape(g, n, 1).float() * v[:, tok].float()).to(v.dtype)
    buf = torch.zeros((g, n_slots * cap + 1, d), dtype=v.dtype,
                      device=v.device)
    buf.scatter_(1, dest[..., None].expand(g, n, d), rows)
    routed = oh[..., :n_slots].sum(1, dtype=torch.int32)
    kept = (oh[..., :n_slots] * keep[..., None]).sum(1, dtype=torch.int32)
    return (buf[:, :-1].reshape(g, n_slots, cap, d),
            rank.reshape(g, t, k).to(torch.int32),
            keep.reshape(g, t, k).to(torch.int32), routed, kept)


def combine_ref(buf, w, slot, rank, keep):
    """buf [G,S,C,D]; w [G,T,k] f32; slot/rank/keep [G,T,k] i32 -> y
    [G,T,D] in buf's dtype."""
    g, s, cap, d = buf.shape
    t, k = slot.shape[1:]
    flat = buf.reshape(g, s * cap, d)
    kb = keep != 0
    dest = torch.where(kb, slot.long() * cap + rank.long(), 0)   # [G,T,k]
    acc = torch.zeros((g, t, d), dtype=torch.float32, device=buf.device)
    for j in range(k):
        rows = torch.gather(flat, 1, dest[:, :, j, None].expand(g, t, d))
        term = w[:, :, j, None].float() * rows.float()
        acc = acc + torch.where(kb[:, :, j, None], term, 0.0)
    return acc.to(buf.dtype)
