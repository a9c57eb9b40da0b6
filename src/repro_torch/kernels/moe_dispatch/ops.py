"""Dispatchers for the fused MoE dispatch/combine family: the CUDA kernels
for tensors on the card, the plain torch versions for tensors on the CPU.
Forward only; the backward pair arrives with the training slice."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_dispatch.moe_dispatch import (combine_cuda,
                                                           dispatch_cuda)
from repro_torch.kernels.moe_dispatch.ref import combine_ref, dispatch_ref
from repro_torch.kernels.moe_gating.ops import resolve


def dispatch(v, w, slot, valid, n_slots: int, cap: int, impl: str = "auto"):
    """v [G,T,D]; w/slot/valid [G,T,k] -> (buf [G,S,C,D], rank, keep
    [G,T,k] i32, routed [G,S] i32, kept [G,S] i32)."""
    if resolve(impl, v) == "torch":
        return dispatch_ref(v, w, slot, valid, n_slots, cap)
    return dispatch_cuda(v, w, slot, valid, n_slots, cap)


def combine(buf, w, slot, rank, keep, impl: str = "auto"):
    """buf [G,S,C,D]; w [G,T,k] f32; slot/rank/keep [G,T,k] i32 -> y
    [G,T,D]."""
    if resolve(impl, buf) == "torch":
        return combine_ref(buf, w, slot, rank, keep)
    return combine_cuda(buf, w, slot, rank, keep)


def dispatch_combine(x, slot, weight, expert_fn, n_slots: int, cap: int,
                     valid=None, impl: str = "auto"):
    """The fused counterpart of ``models.moe.dispatch_combine``: x
    [G,T,D]; slot/weight [G,T,k].  Returns (y [G,T,D], metrics) with drop
    decisions and Reshape load metrics bit-identical to the argsort path:
    slot_counts (routed phi) and kept_counts [G,S], dropped [G]."""
    g, t, _ = x.shape
    k = slot.shape[-1]
    valid_i = (torch.ones((g, t, k), dtype=torch.int32, device=x.device)
               if valid is None else valid.to(torch.int32))
    slot = slot.to(torch.int32)
    ones = torch.ones((g, t, k), dtype=torch.float32, device=x.device)
    buf, rank, keep, routed, kept = dispatch(x, ones, slot, valid_i,
                                             n_slots, cap, impl)
    out_buf = expert_fn(buf)
    y = combine(out_buf, weight.float(), slot, rank, keep, impl)
    dropped = valid_i.sum((1, 2)) - keep.sum((1, 2))
    return y.to(x.dtype), {"slot_counts": routed, "kept_counts": kept,
                           "dropped": dropped}
