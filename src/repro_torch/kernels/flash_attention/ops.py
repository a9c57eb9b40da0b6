"""Dispatcher for flash attention: the CUDA kernels (forward and backward,
through ``FlashAttention``) for tensors on the card, the plain
``chunked_attention`` (differentiated by autograd) for tensors on the
CPU."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import resolve
from repro_torch.kernels.flash_attention.flash_attention import \
    FlashAttention
from repro_torch.models.attention import chunked_attention, repeat_kv


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    impl: str = "auto"):
    """q [B,Sq,H,hd]; k,v [B,Sk,KH,hd].  Returns [B,Sq,H,hd] in q's
    dtype."""
    if resolve(impl, q) == "torch":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    h, kh = q.shape[2], k.shape[2]
    return FlashAttention.apply(q, repeat_kv(k, h // kh),
                                repeat_kv(v, h // kh), causal, window,
                                q_offset)
