"""GQA attention.

``chunked_attention`` is the full-sequence path (online softmax over KV
chunks, O(S·chunk) memory): the plain version of the flash-attention
kernel (``kernels.flash_attention``), which the blocks call on the card.
``decode_attention`` is the serving path: one new token per row against a
KV cache, with a *per-row* position, so rows of one batch may sit at
different depths (the serve engine's slots).  It is the plain version of
the split-KV decode-attention kernel (``kernels.decode_attention``), which
the blocks call on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k, n_rep: int):
    """[B,S,KH,hd] -> [B,S,KH*n_rep,hd]."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(
        b, s, kh * n_rep, hd)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      kv_chunk: int = 1024):
    """q [B,Sq,H,hd]; k,v [B,Sk,KH,hd].  Online softmax over KV chunks;
    logits and accumulators are f32, the probabilities are rounded to V's
    dtype before they meet V, as in the reference.  ``q_offset`` is the
    absolute position of q[0] relative to k[0]; ``window`` a sliding
    window (None = full)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    q = q * (hd ** -0.5)
    k = repeat_kv(k, h // kh)
    v = repeat_kv(v, h // kh)
    kv_chunk = min(kv_chunk, sk)
    qt = q.transpose(1, 2).float()                    # [B,H,Sq,hd]
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, sk, kv_chunk):
        kb = k[:, start:start + kv_chunk].transpose(1, 2)   # [B,H,C,hd]
        vb = v[:, start:start + kv_chunk].transpose(1, 2)
        k_pos = start + torch.arange(kb.shape[2], device=q.device)
        logits = torch.einsum("bhqd,bhkd->bhqk", qt, kb.float())
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        # p is rounded to V's dtype, as in the reference; the product is
        # summed in f32 and not rounded, as the reference's compiled scan
        # does (XLA keeps the bf16 dot's result in f32 when it feeds an f32
        # add), so the port's attention matches it to f32 rounding
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)            # [B,Sq,H,hd]


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None, rolling: bool = False):
    """Single-token decode.  q [B,1,H,hd]; caches [B,Smax,KH,hd]; ``pos``
    [B] is each row's absolute position of the new token (already written
    to the cache): a row attends to cache entries ``idx <= pos``, and with
    a ``window`` only to those with ``idx > pos - window``.  ``rolling``:
    the cache is a ring (Smax == the window) holding position p at
    ``p % Smax``, so once a row has written Smax entries (``pos + 1 >=
    Smax``) every entry is valid.  An fp8 cache is dequantized to bf16
    first."""
    b, _, h, hd = q.shape
    smax, kh = k_cache.shape[1], k_cache.shape[2]
    if k_cache.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        k_cache = k_cache.to(torch.bfloat16)
        v_cache = v_cache.to(torch.bfloat16)
    k = repeat_kv(k_cache, h // kh)
    v = repeat_kv(v_cache, h // kh)
    q = q * (hd ** -0.5)
    # f32 logits from the working-dtype operands (the reference's
    # preferred_element_type=f32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    idx = torch.arange(smax, device=q.device)
    valid = idx[None, :] <= pos[:, None]                      # [B,Smax]
    if rolling:
        valid = valid | (pos[:, None] + 1 >= smax)
    elif window is not None:
        valid = valid & (idx[None, :] > pos[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)
