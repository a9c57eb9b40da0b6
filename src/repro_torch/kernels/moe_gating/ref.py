"""Plain torch version of the fused MoE gating kernel: softmax + top-k + the
per-group load histogram phi.

It repeats the kernel's arithmetic step by step (max-subtracted exp, one
division by the row sum, ``k`` rounds of max/argmax/mask), so the CPU path
and the card's kernel agree on every integer output.  Ties go to the lowest
expert index: ``torch.argmax`` documents that it returns the first maximal
index, which ``torch.topk`` does not promise.
"""
from __future__ import annotations

import torch


def top_k_rounds(probs, k: int):
    """``k`` rounds of (max, first argmax, mask with -1) over the last dim.
    Returns (values [..., k], indices [..., k] int64) in selection order."""
    remaining = probs
    vals, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1, keepdim=True)
        vals.append(torch.gather(remaining, -1, idx))
        idxs.append(idx)
        remaining = remaining.scatter(-1, idx, -1.0)
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def gating_ref(logits, k: int):
    """logits [G,T,E] -> (weights [G,T,k] f32, experts [G,T,k] i32,
    counts [G,E] i32).

    ``weights`` are the re-normalized top-k softmax probabilities; ``counts``
    is the Reshape load metric phi of each group (tokens routed per expert,
    before capacity)."""
    x = logits.float()
    p = torch.exp(x - x.amax(-1, keepdim=True))
    probs = p / p.sum(-1, keepdim=True)
    top_p, top_e = top_k_rounds(probs, k)
    weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    g, _, e = logits.shape
    counts = torch.zeros((g, e), dtype=torch.int32, device=logits.device)
    counts.scatter_add_(1, top_e.reshape(g, -1),
                        torch.ones_like(top_e.reshape(g, -1),
                                        dtype=torch.int32))
    return weights, top_e.to(torch.int32), counts
