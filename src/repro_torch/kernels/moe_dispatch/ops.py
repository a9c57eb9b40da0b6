"""Dispatchers for the fused MoE dispatch/combine family, and their
gradients.

``dispatch`` and ``combine`` run the CUDA kernels for tensors on the card
and the plain torch versions for tensors on the CPU.

Gradients: the routing decisions (slot, rank, keep, counts) are int32 and
carry none; the differentiable dataflow is the weighted scatter (dispatch)
and the weighted gather (combine).  The two are transposes of each other,
so each one's backward is the other re-applied, as in the reference's
``custom_vjp``s (src/repro/kernels/moe_dispatch/ops.py:71-160):

* ``Dispatch`` backward: dv is a combine of the buffer cotangent at the
  forward's (slot, rank, keep);
* ``Combine`` backward: d_buf is a dispatch of the output cotangent, whose
  ranks are recomputed from the same (slot, valid, cap), so the scatter
  fills exactly the forward's buckets;
* dw, the per-assignment weight's gradient, is a row dot of the cotangent
  with the gathered counterpart rows, in f32, in plain torch.

With ``impl="torch"`` the model differentiates the plain versions
directly (``dispatch_combine``); the Functions also take ``impl``, so the
CPU tests hold their backward logic against the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve
from repro_torch.kernels.moe_dispatch.moe_dispatch import (combine_cuda,
                                                           dispatch_cuda)
from repro_torch.kernels.moe_dispatch.ref import combine_ref, dispatch_ref


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


def _rows(buf, slot, rank, keep):
    """The buffer rows [G,T,k,D] that each kept assignment owns (row 0 of
    the group where it is not kept)."""
    g, s, cap, d = buf.shape
    t, k = slot.shape[1:]
    dest = torch.where(keep != 0, slot.long() * cap + rank.long(), 0)
    return torch.gather(buf.reshape(g, s * cap, d), 1,
                        dest.reshape(g, t * k, 1).expand(g, t * k, d)
                        ).reshape(g, t, k, d)


def _row_dot(rows, x, keep):
    """dw [G,T,k] f32 = keep · <rows[g,t,j], x[g,t]>."""
    return (rows.float() * x[:, :, None, :].float()).sum(-1) * (keep != 0)


class Dispatch(torch.autograd.Function):
    """(v, w) -> buf, with rank/keep/routed/kept as integer side outputs."""

    @staticmethod
    def forward(ctx, v, w, slot, valid, n_slots, cap, impl):
        buf, rank, keep, routed, kept = dispatch(v, w, slot, valid, n_slots,
                                                 cap, impl)
        ctx.save_for_backward(v, w, slot, rank, keep)
        ctx.impl = impl
        ctx.mark_non_differentiable(rank, keep, routed, kept)
        return buf, rank, keep, routed, kept

    @staticmethod
    def backward(ctx, g_buf, *_):
        v, w, slot, rank, keep = ctx.saved_tensors
        g_buf = g_buf.to(v.dtype).contiguous()
        dv = dw = None
        if ctx.needs_input_grad[0]:
            dv = combine(g_buf, w, slot, rank, keep, ctx.impl)
        if ctx.needs_input_grad[1]:
            dw = _row_dot(_rows(g_buf, slot, rank, keep), v, keep)
        return dv, dw, None, None, None, None, None


class Combine(torch.autograd.Function):
    """(buf, w) -> y.  ``valid`` is only read by the backward (it lets the
    backward's dispatch recompute the forward's ranks)."""

    @staticmethod
    def forward(ctx, buf, w, slot, rank, keep, valid, impl):
        y = combine(buf, w, slot, rank, keep, impl)
        ctx.save_for_backward(buf, w, slot, rank, keep, valid)
        ctx.impl = impl
        return y

    @staticmethod
    def backward(ctx, g_y):
        buf, w, slot, rank, keep, valid = ctx.saved_tensors
        g_y = g_y.to(buf.dtype).contiguous()
        d_buf = dw = None
        if ctx.needs_input_grad[0]:
            s, cap = buf.shape[1:3]
            d_buf = dispatch(g_y, w, slot, valid, s, cap, ctx.impl)[0]
        if ctx.needs_input_grad[1]:
            dw = _row_dot(_rows(buf, slot, rank, keep), g_y, keep)
        return d_buf, dw, None, None, None, None, None


def dispatch_combine(x, slot, weight, expert_fn, n_slots: int, cap: int,
                     valid=None, impl: str = "auto", out_dtype=None):
    """The fused counterpart of ``models.moe.dispatch_combine``: x
    [G,T,D]; slot/weight [G,T,k].  Returns (y [G,T,D], metrics) with drop
    decisions and Reshape load metrics bit-identical to the argsort path:
    slot_counts (routed phi) and kept_counts [G,S], dropped [G].  y is in
    x's dtype, or ``out_dtype``: f32 keeps the combine's f32 sum unrounded
    (the experts' outputs are combined in f32), for a caller that adds
    partial sums (``models.moe.moe_ffn_sharded``) and rounds once.

    On the card the kernels run forward and backward (``Dispatch``,
    ``Combine``); with the plain versions autograd differentiates them
    directly."""
    g, t, _ = x.shape
    k = slot.shape[-1]
    valid_i = (torch.ones((g, t, k), dtype=torch.int32, device=x.device)
               if valid is None else valid.to(torch.int32))
    slot = slot.to(torch.int32)
    ones = torch.ones((g, t, k), dtype=torch.float32, device=x.device)
    if resolve(impl, x) == "torch":
        buf, rank, keep, routed, kept = dispatch_ref(x, ones, slot, valid_i,
                                                     n_slots, cap)
        y = combine_ref(expert_fn(buf).to(out_dtype or buf.dtype),
                        weight.float(), slot, rank, keep)
    else:
        buf, rank, keep, routed, kept = Dispatch.apply(
            x, ones, slot, valid_i, n_slots, cap, impl)
        y = Combine.apply(expert_fn(buf).to(out_dtype or buf.dtype),
                          weight.float(), slot, rank, keep, valid_i, impl)
    dropped = valid_i.sum((1, 2)) - keep.sum((1, 2))
    return y.to(out_dtype or x.dtype), {
        "slot_counts": routed, "kept_counts": kept, "dropped": dropped}
