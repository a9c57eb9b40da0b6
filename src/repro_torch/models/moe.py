"""Mixture-of-Experts FFN with first-class Reshape skew handling (local
path: one device, no expert parallelism).

Tokens arrive in **groups**, ``x [G,T,D]``: every group routes, ranks and
fills its own capacity-bucketed ``[S, C, D]`` buffer with ``C =
capacity(cfg, T)``, and hashes its tokens from its own ``token_offset``.
The grouping is the caller's: a batched decode over ``[B,1]`` tokens is one
group of ``T = B`` (what the JAX ``decode_step`` sees), while the serve
engine's slots are ``B`` groups of ``T = 1`` (what its vmap over slots
sees).  The two can drop different assignments, so the port never merges
them.

* The **partitioning logic** the paper mutates by control messages is a
  :class:`RoutingPlan` mapping each *logical* expert to up to R *physical
  slots* with split fractions (SBR: hot experts split across spare slots).
* Load metrics (per-slot routed/kept counts, drops, the per-expert histogram
  phi from the fused gating kernel) are side outputs of the layer.
* Dispatch is either the argsort pipeline below or the fused kernel family
  (``cfg.moe.fused_dispatch``); both make the same drop decisions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_dispatch import ops as dispatch_ops
from repro_torch.kernels.moe_gating.ops import gating
from repro_torch.kernels.moe_gating.ref import top_k_rounds

class RoutingPlan(NamedTuple):
    """Per-layer partitioning logic: logical expert -> physical slots."""
    slots: torch.Tensor   # [L, E, R] int64 — physical slot of replica r
    cum: torch.Tensor     # [L, E, R] f32  — cumulative split fractions (last=1)


def identity_plan(cfg: ArchConfig, n_moe_layers: int,
                  device="cuda") -> RoutingPlan:
    e, r = cfg.moe.num_experts, cfg.moe.max_replicas
    slots = torch.arange(e, device=device)[None, :, None].expand(
        n_moe_layers, e, r).contiguous()
    cum = torch.ones((n_moe_layers, e, r), dtype=torch.float32,
                     device=device)
    return RoutingPlan(slots, cum)


def num_slots(cfg: ArchConfig) -> int:
    return cfg.moe.num_experts + cfg.moe.spare_slots


def capacity(cfg: ArchConfig, tokens: int) -> int:
    m = cfg.moe
    return max(4, int(tokens * m.top_k * m.capacity_factor / m.num_experts))


def _hash_unit(idx):
    """Deterministic token -> [0,1) bucket (Knuth multiplicative hash with
    uint32 wraparound, computed in int64)."""
    h = (idx.long() * 2654435761) & 0xFFFFFFFF
    return h.float() / float(2 ** 32)


def route(router_w, x, plan_slots, plan_cum, cfg: ArchConfig, token_offset,
          impl: str = "auto"):
    """x [G,T,D]; token_offset [G] -> (slot [G,T,k], weight [G,T,k],
    probs [G,T,E], expert [G,T,k], counts [G,E] i32 from the fused gating
    kernel, or None).  The gating kernel takes detached logits: its outputs
    used here are integers, and the differentiable weights are re-gathered
    from ``probs``, so it needs no backward."""
    m = cfg.moe
    # the products of the activations' dtype summed in f32 and not rounded
    # back: the reference's einsum followed by an f32 cast compiles to
    # exactly that, and a bf16-rounded logit reorders near-tied experts
    logits = x.float() @ router_w.to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    counts = None
    if m.fused_gating:
        # the kernel's integer outputs (expert ids, phi) are used here; the
        # weights are re-gathered from ``probs`` as the reference does
        _, top_e, counts = gating(logits.detach(), m.top_k, impl)
        top_e = top_e.long()
        top_p = torch.gather(probs, -1, top_e)
    else:
        top_p, top_e = top_k_rounds(probs, m.top_k)
    weight = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Reshape SBR replica choice: hash the token index into [0,1) and pick
    # the replica by the plan's cumulative fractions.
    t = x.shape[1]
    t_idx = token_offset[:, None] + torch.arange(t, device=x.device)
    u = _hash_unit(t_idx)                                     # [G,T]
    cum_g = plan_cum[top_e]                                   # [G,T,k,R]
    r = (cum_g[..., :-1] <= u[..., None, None]).sum(-1)       # [G,T,k]
    slot = torch.gather(plan_slots[top_e], -1, r[..., None])[..., 0]
    return slot.to(torch.int32), weight, probs, top_e, counts


def dispatch_combine(x, slot, weight, expert_fn, n_slots: int, cap: int,
                     valid=None, fused: bool = False, impl: str = "auto"):
    """Capacity dispatch -> per-slot ``expert_fn`` -> weighted combine.

    x [G,T,D]; slot/weight [G,T,k]; ``valid`` [G,T,k] masks assignments.
    Returns (y [G,T,D], metrics: slot_counts/kept_counts [G,S], dropped
    [G]).  ``fused=True`` runs the fused kernel family; otherwise the
    stable argsort + searchsorted + scatter pipeline of the reference."""
    if fused:
        return dispatch_ops.dispatch_combine(x, slot, weight, expert_fn,
                                             n_slots, cap, valid=valid,
                                             impl=impl)
    g, t, d = x.shape
    k = slot.shape[-1]
    tk = t * k
    dev = x.device
    flat_valid = (torch.ones((g, tk), dtype=torch.bool, device=dev)
                  if valid is None else valid.reshape(g, tk) != 0)
    # invalid assignments sort to a virtual segment past n_slots-1
    flat_slot = torch.where(flat_valid, slot.reshape(g, tk).long(), n_slots)

    # rank within the slot segment via a stable sort
    sort_idx = torch.argsort(flat_slot, dim=-1, stable=True)
    sorted_slot = torch.gather(flat_slot, 1, sort_idx)
    bounds = torch.arange(n_slots + 1, device=dev).expand(g, -1).contiguous()
    seg_start = torch.searchsorted(sorted_slot, bounds)
    pos_sorted = torch.arange(tk, device=dev) - torch.gather(
        seg_start, 1, torch.clamp(sorted_slot, max=n_slots))
    pos = torch.empty_like(pos_sorted).scatter_(1, sort_idx, pos_sorted)

    keep = (pos < cap) & flat_valid
    dest = torch.where(keep, flat_slot * cap + pos, n_slots * cap)
    tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    buf = torch.zeros((g, n_slots * cap + 1, d), dtype=x.dtype, device=dev)
    buf.scatter_add_(1, dest[..., None].expand(g, tk, d),
                     x[:, tok] * keep[..., None].to(x.dtype))
    buf = buf[:, :-1].reshape(g, n_slots, cap, d)

    out_buf = expert_fn(buf).reshape(g, n_slots * cap, d)
    gathered = torch.gather(out_buf, 1,
                            torch.where(keep, dest, 0)[..., None].expand(
                                g, tk, d))
    contrib = gathered * (weight.reshape(g, tk, 1) *
                          keep[..., None]).to(x.dtype)
    y = torch.zeros((g, t, d), dtype=x.dtype, device=dev)
    y.index_add_(1, tok, contrib)

    in_range = torch.where(flat_valid, flat_slot, 0)
    slot_counts = torch.zeros((g, n_slots), dtype=torch.int32, device=dev)
    slot_counts.scatter_add_(1, in_range, flat_valid.to(torch.int32))
    kept_counts = torch.zeros((g, n_slots), dtype=torch.int32, device=dev)
    kept_counts.scatter_add_(1, in_range, keep.to(torch.int32))
    dropped = flat_valid.sum(1) - keep.sum(1)
    return y, {"slot_counts": slot_counts, "kept_counts": kept_counts,
               "dropped": dropped}


def expert_ffn(p, buf):
    """Per-slot SwiGLU experts: buf [G,S,C,D] -> [G,S,C,D].  The slot's
    rows of every group are stacked into one matmul."""
    g, s, c, d = buf.shape
    h = buf.permute(1, 0, 2, 3).reshape(s, g * c, d)
    gate = F.silu(torch.bmm(h, p["w_gate"].to(h.dtype)))
    up = torch.bmm(h, p["w_up"].to(h.dtype))
    out = torch.bmm(gate * up, p["w_down"].to(h.dtype))
    return out.reshape(s, g, c, d).permute(1, 0, 2, 3)


def moe_ffn(p, x, plan_slots, plan_cum, cfg: ArchConfig, token_offset,
            impl: str = "auto"):
    """Full MoE FFN over groups.  p: dict(router, w_gate [S,D,F], w_up,
    w_down [S,F,D]); x [G,T,D]; token_offset [G]; ``impl`` picks the
    kernels or their plain versions (``kernels.*.ops``).

    Returns (y [G,T,D], metrics), every metric with a leading group dim:
    slot_counts/kept_counts [G,S] (the Reshape load metric phi per physical
    slot), dropped [G], aux_loss [G], expert_counts [G,E], router_z [G]."""
    m = cfg.moe
    t = x.shape[1]
    slot, weight, probs, top_e, r_counts = route(
        p["router"], x, plan_slots, plan_cum, cfg, token_offset, impl)
    y, metrics = dispatch_combine(x, slot, weight,
                                  lambda buf: expert_ffn(p, buf),
                                  num_slots(cfg), capacity(cfg, t),
                                  fused=m.fused_dispatch, impl=impl)

    # Switch-style load-balance aux loss over *logical* experts.  With fused
    # gating the histogram comes straight from the kernel.
    if r_counts is not None:
        e_counts = r_counts.float()
    else:
        flat_e = top_e.reshape(x.shape[0], -1)
        e_counts = torch.zeros((x.shape[0], m.num_experts),
                               dtype=torch.float32, device=x.device)
        e_counts.scatter_add_(1, flat_e, torch.ones(
            flat_e.shape, dtype=torch.float32, device=x.device))
    f = e_counts / (t * m.top_k)
    pbar = probs.mean(1)
    metrics["aux_loss"] = m.num_experts * (f * pbar).sum(-1)
    metrics["expert_counts"] = e_counts.to(torch.int32)
    metrics["router_z"] = torch.logsumexp(
        torch.log(probs + 1e-9), dim=-1).square().mean(-1)
    return y, metrics
