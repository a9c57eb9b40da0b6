"""Dispatcher for decode attention: the split-KV CUDA kernel
(``decode_attn_cuda``) for tensors on the card, the plain
``models.attention.decode_attention`` for tensors on the CPU.  Serving
runs no backward through it: there is no autograd Function."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import resolve
from repro_torch.kernels.decode_attention.decode_attention import \
    decode_attn_cuda
from repro_torch.models.attention import decode_attention as plain


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None, rolling: bool = False,
                     impl: str = "auto"):
    """q [B,1,H,hd]; caches [B,Smax,KH,hd]; pos [B] each row's position
    (see ``models.attention.decode_attention``).  Returns [B,1,H,hd] in
    q's dtype."""
    if resolve(impl, q) == "torch":
        return plain(q, k_cache, v_cache, pos, window=window,
                     rolling=rolling)
    return decode_attn_cuda(q, k_cache, v_cache, pos, window, rolling)
