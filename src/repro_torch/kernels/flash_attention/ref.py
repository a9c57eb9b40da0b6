"""Materialised attention, the flash kernels' second plain version: the
full [Sq, Sk] logits in f32, one softmax, one product with V.  Torch's
autograd of it is the plain backward."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0):
    """q [B,H,Sq,hd]; k,v [B,H,Sk,hd] (heads already repeated) ->
    [B,H,Sq,hd] in v's dtype."""
    sq, sk = q.shape[2], k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) * (q.shape[-1] ** -0.5)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
