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
* ``moe_ffn_sharded`` is the expert-parallel path over ``torch.distributed``
  (experts over a mesh's ``model`` dim, tokens over ``data``), and
  ``moe_ffn_a2a`` its all-to-all variant (tokens over ``data`` x ``model``,
  exchanged with the experts' ranks); ``moe_ffn(..., mesh, layout)``
  picks among the three.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_dispatch import ops as dispatch_ops
from repro_torch.kernels.moe_gating.ops import gating
from repro_torch.kernels.moe_gating.ref import top_k_rounds

# Bytes that moe_ffn_sharded and moe_ffn_a2a hand to each kind of
# collective (counted where they call one with more than one rank, and
# nowhere else), as kernels.LAUNCHES counts launches: the port's count of
# what an HLO parse counted for the reference.
COLLECTIVE_BYTES = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}


def reset_collective_bytes() -> None:
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


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
                     valid=None, fused: bool = False, impl: str = "auto",
                     out_dtype=None):
    """Capacity dispatch -> per-slot ``expert_fn`` -> weighted combine.

    x [G,T,D]; slot/weight [G,T,k]; ``valid`` [G,T,k] masks assignments.
    Returns (y [G,T,D], metrics: slot_counts/kept_counts [G,S], dropped
    [G]).  ``fused=True`` runs the fused kernel family (``out_dtype``: the
    dtype its f32 combine is returned in, x's by default); otherwise the
    stable argsort + searchsorted + scatter pipeline of the reference,
    which sums in x's dtype."""
    if fused:
        return dispatch_ops.dispatch_combine(x, slot, weight, expert_fn,
                                             n_slots, cap, valid=valid,
                                             impl=impl, out_dtype=out_dtype)
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
            impl: str = "auto", mesh=None, layout: str = "tp"):
    """Full MoE FFN over groups.  p: dict(router, w_gate [S,D,F], w_up,
    w_down [S,F,D]); x [G,T,D]; token_offset [G]; ``impl`` picks the
    kernels or their plain versions (``kernels.*.ops``).  With a ``mesh``
    (one group) the layer is expert-parallel, as the reference's
    ``moe_ffn``: ``layout="tp"`` runs ``moe_ffn_sharded``, ``"dp"``
    ``moe_ffn_a2a``.

    Returns (y [G,T,D], metrics), every metric with a leading group dim:
    slot_counts/kept_counts [G,S] (the Reshape load metric phi per physical
    slot), dropped [G], aux_loss [G], expert_counts [G,E], router_z [G]."""
    if mesh is not None:
        if layout not in ("tp", "dp"):
            raise ValueError(f"unknown layout {layout!r}")
        ffn = moe_ffn_a2a if layout == "dp" else moe_ffn_sharded
        return ffn(p, x, plan_slots, plan_cum, cfg, mesh, token_offset,
                   impl)
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


# ------------------------------------------------------ expert parallelism

def _data_axis(mesh):
    """(this rank's data row, the number of rows, their process group or
    None) of ``mesh``: dims ``model`` and, optionally, ``data``."""
    names = tuple(mesh.mesh_dim_names)
    if set(names) - {"data", "model"} or "model" not in names:
        raise ValueError(f"mesh dims {names}: want ('data', 'model') or "
                         f"('model',)")
    if "data" not in names:
        return 0, 1, None
    return (mesh.get_local_rank("data"), mesh.shape[names.index("data")],
            mesh.get_group("data"))


def slots_per_rank(cfg: ArchConfig, mesh) -> int:
    mdl = mesh.shape[tuple(mesh.mesh_dim_names).index("model")]
    s = num_slots(cfg)
    if s % mdl:
        raise ValueError(f"{s} slots do not split over model {mdl}")
    return s // mdl


def local_experts(w: torch.Tensor, cfg: ArchConfig, mesh, dim: int = 0):
    """This rank's slots of an expert-stacked leaf (slots on ``dim``: 0 for
    one layer's ``[S, D, F]``, 1 for the model's stacked ``[L, S, D,
    F]``)."""
    spr = slots_per_rank(cfg, mesh)
    lo = mesh.get_local_rank("model") * spr
    return w.narrow(dim, lo, spr)


def shard_experts(params: Dict, cfg: ArchConfig, mesh) -> Dict:
    """A model's parameter tree with every ``moe`` layer's experts cut to
    this rank's slots (the rest is shared), as ``lm.forward(mesh=...)``
    takes it."""
    out = dict(params)
    out["moe"] = {k: (local_experts(v, cfg, mesh, 1).contiguous()
                      if k in ("w_gate", "w_up", "w_down") else v)
                  for k, v in params["moe"].items()}
    return out


def _all_reduce(x, group):
    """``x`` summed in place over ``group``'s ranks, its bytes counted."""
    import torch.distributed as dist
    COLLECTIVE_BYTES["all_reduce"] += x.numel() * x.element_size()
    dist.all_reduce(x, group=group)
    return x


def _all_to_all(x, group):
    """``x`` [m * C, ...] cut into ``m`` equal blocks along dim 0: block j
    goes to rank j of ``group``, and block j of the result came from rank j
    (``lax.all_to_all`` with split and concat axis 0); its bytes
    counted."""
    import torch.distributed as dist
    x = x.contiguous()
    COLLECTIVE_BYTES["all_to_all"] += x.numel() * x.element_size()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _forward_only(name, x, p):
    if torch.is_grad_enabled() and (x.requires_grad or any(
            v.requires_grad for v in p.values())):
        raise RuntimeError(f"{name} is forward only: run it under "
                           f"torch.no_grad()")


def moe_ffn_sharded(p, x, plan_slots, plan_cum, cfg: ArchConfig, mesh,
                    token_offset, impl: str = "auto"):
    """Expert-parallel MoE FFN over a ``torch.distributed`` ``DeviceMesh``
    with dims ``model`` and, optionally, ``data``: the JAX
    package's ``moe_ffn_sharded`` (its shard_map's body run by each rank).

    Each rank holds its ``num_slots // |model|`` expert slots (``p``'s
    expert leaves ``[spr, D, F]``, ``local_experts``) and its data row's
    share of the tokens, ``x [1, T_loc, D]``, hashed from ``token_offset +
    row * T_loc``.  Every rank routes
    its rows over all experts, then dispatches only the assignments to its
    own slots (``valid``, local slot ids, capacity ``capacity(cfg,
    T_loc)``) through the dispatch kernels when ``cfg.moe.fused_dispatch``
    is set, and the partial outputs are summed by one ``all_reduce`` over
    ``model``.  The fused path's partial sums stay in f32 and are rounded
    to x's dtype once, after that sum, as the one-device combine rounds its
    f32 sum once (so with 2 ranks and k 2 the result is the one-device
    result bit for bit); the argsort path sums in x's dtype, as it does on
    one device.

    Forward only: the collectives are plain ``torch.distributed`` calls
    that autograd does not see, so it raises where autograd would record
    (the reference's shard_map also sums the router's gradient over
    ``model``, which no training path here does yet).

    Returns (y [1, T_loc, D], metrics with the reference's keys, a leading
    group dim of 1): ``slot_counts`` = ``kept_counts`` [1, S] (each slot's
    kept assignments, gathered over ``model`` and summed over ``data``, as
    the reference's sharded path reports them), ``expert_counts`` [1, E]
    summed over ``data``, ``dropped`` [1] summed over every rank (the
    reference reports the first ``model`` column's alone), ``aux_loss`` and
    ``router_z`` [1] from the ``data``-averaged router statistics."""
    import torch.distributed as dist
    _forward_only("moe_ffn_sharded", x, p)
    m = cfg.moe
    names = tuple(mesh.mesh_dim_names)
    mdl = mesh.shape[names.index("model")]
    col = mesh.get_local_rank("model")
    spr = slots_per_rank(cfg, mesh)
    row, dp, data_group = _data_axis(mesh)
    t_loc = x.shape[1]
    base = torch.as_tensor(token_offset, device=x.device).reshape(1) + \
        row * t_loc
    slot, weight, probs, top_e, r_counts = route(
        p["router"], x, plan_slots, plan_cum, cfg, base, impl)
    lo = col * spr
    mine = (slot >= lo) & (slot < lo + spr)
    local = torch.where(mine, slot - lo, 0).to(torch.int32)
    y, met = dispatch_combine(
        x, local, torch.where(mine, weight, 0.0),
        lambda buf: expert_ffn(p, buf), spr, capacity(cfg, t_loc),
        valid=mine, fused=m.fused_dispatch, impl=impl,
        out_dtype=torch.float32 if mdl > 1 else None)
    if mdl > 1:
        y = _all_reduce(y.contiguous(), mesh.get_group("model")).to(x.dtype)

    # integer metrics: summed over data in one all-reduce, then each model
    # rank's kept counts and drops gathered
    kept = met["kept_counts"][0]
    dropped = met["slot_counts"][0].sum() - kept.sum()
    if r_counts is not None:
        e_counts = r_counts[0].to(torch.int32)
    else:
        e_counts = torch.zeros(m.num_experts, dtype=torch.int32,
                               device=x.device)
        e_counts.scatter_add_(0, top_e.reshape(-1),
                              torch.ones(top_e.numel(), dtype=torch.int32,
                                         device=x.device))
    ints = torch.cat([kept, e_counts, dropped.reshape(1)]).to(torch.int32)
    if dp > 1:
        ints = _all_reduce(ints, data_group)
    e_counts = ints[spr:spr + m.num_experts]
    mine_ints = torch.cat([ints[:spr], ints[-1:]])
    if mdl > 1:
        parts = [torch.empty_like(mine_ints) for _ in range(mdl)]
        COLLECTIVE_BYTES["all_gather"] += \
            mine_ints.numel() * mine_ints.element_size()
        dist.all_gather(parts, mine_ints, group=mesh.get_group("model"))
    else:
        parts = [mine_ints]
    slot_counts = torch.cat([q[:spr] for q in parts])
    dropped = sum(q[spr] for q in parts)

    # router statistics averaged over data (f32), as the reference's pmean
    rz = torch.logsumexp(torch.log(probs[0] + 1e-9), dim=-1).square().mean()
    stats = torch.cat([probs[0].mean(0), rz.reshape(1)])
    if dp > 1:
        stats = _all_reduce(stats, data_group) / dp
    pbar, rz = stats[:m.num_experts], stats[m.num_experts]
    f = e_counts.float() / torch.clamp(e_counts.sum().float(), min=1.0)
    aux = m.num_experts * (f * pbar).sum()
    return y, {"slot_counts": slot_counts[None], "kept_counts":
               slot_counts[None], "dropped": dropped.reshape(1),
               "aux_loss": aux.reshape(1), "expert_counts": e_counts[None],
               "router_z": rz.reshape(1)}


def moe_ffn_a2a(p, x, plan_slots, plan_cum, cfg: ArchConfig, mesh,
                token_offset, impl: str = "auto"):
    """All-to-all expert parallelism over a ``torch.distributed``
    ``DeviceMesh`` (dims ``model`` and, optionally, ``data``; it spans the
    default process group): the JAX package's ``moe_ffn_a2a`` (its
    shard_map's body run by each rank).

    Each rank holds its ``num_slots // |model|`` expert slots (as
    ``moe_ffn_sharded``) and its share of the tokens over ``data`` x
    ``model``, ``x [1, T_loc, D]``, the rows ``idx * T_loc ...`` of the
    flattened batch with ``idx = data_row * |model| + model_col``, hashed
    from ``token_offset + idx * T_loc``.  It routes them over all experts,
    buckets each assignment by its destination column ``slot // spr`` into
    ``[|model|, cap_s, D]`` with ``cap_s = max(4, int(T_loc k cf /
    |model|))`` (the dispatch kernel when ``cfg.moe.fused_dispatch`` is
    set, else a stable sort), exchanges the buckets and their slot ids
    with one ``all_to_all`` over ``model`` each, runs the rows it received
    through its own slots (``dispatch_combine`` at capacity ``cap2 =
    max(4, int(|model| cap_s cf / spr))``, ``valid`` where a row holds an
    assignment), returns them with a second ``all_to_all``, and combines
    them at the source (the combine kernel when fused, rounded once to x's
    dtype).

    Forward only, as ``moe_ffn_sharded``.  Returns (y [1, T_loc, D],
    metrics with the reference's keys and a leading group dim of 1):
    ``slot_counts`` = ``kept_counts`` [1, S] (each slot's kept rows, summed
    over ``data``), ``expert_counts`` [1, E], ``dropped`` [1] (assignments
    past a bucket's ``cap_s`` at the source plus rows past ``cap2`` at the
    experts) summed over every rank, ``aux_loss`` and ``router_z`` [1]
    from the router statistics averaged over every rank."""
    import torch.distributed as dist
    _forward_only("moe_ffn_a2a", x, p)
    m = cfg.moe
    names = tuple(mesh.mesh_dim_names)
    mdl = mesh.shape[names.index("model")]
    col = mesh.get_local_rank("model")
    spr = slots_per_rank(cfg, mesh)
    row, _, _ = _data_axis(mesh)
    world = dist.get_world_size()
    t_loc, d = x.shape[1:]
    k = m.top_k
    tk = t_loc * k
    dev = x.device
    base = torch.as_tensor(token_offset, device=dev).reshape(1) + \
        (row * mdl + col) * t_loc
    slot, weight, probs, top_e, r_counts = route(
        p["router"], x, plan_slots, plan_cum, cfg, base, impl)
    col_of = torch.div(slot, spr, rounding_mode="floor").to(torch.int32)
    flat_col, flat_slot = col_of.reshape(tk).long(), slot.reshape(tk)
    cap_s = max(4, int(tk * m.capacity_factor / mdl))
    if m.fused_dispatch:
        ones = torch.ones((1, t_loc, k), dtype=torch.float32, device=dev)
        send, rank2, keep2, _, _ = dispatch_ops.dispatch(
            x, ones, col_of, torch.ones_like(col_of), mdl, cap_s, impl)
        pos, keep = rank2.reshape(tk).long(), keep2.reshape(tk) != 0
        send = send[0]                               # [mdl, cap_s, D]
    else:
        sort_idx = torch.argsort(flat_col, stable=True)
        sorted_col = flat_col[sort_idx]
        seg = torch.searchsorted(sorted_col, torch.arange(mdl, device=dev))
        pos = torch.empty_like(sort_idx).scatter_(
            0, sort_idx, torch.arange(tk, device=dev) - seg[sorted_col])
        keep = pos < cap_s
    dest = torch.where(keep, flat_col * cap_s + pos, mdl * cap_s)
    tok = torch.arange(t_loc, device=dev).repeat_interleave(k)
    if not m.fused_dispatch:
        send = torch.zeros((mdl * cap_s + 1, d), dtype=x.dtype, device=dev)
        send[dest[keep]] = x[0, tok[keep]]
        send = send[:-1].reshape(mdl, cap_s, d)
    send_slot = torch.full((mdl * cap_s + 1,), -1, dtype=torch.int32,
                           device=dev)
    send_slot[dest[keep]] = flat_slot[keep]
    group = mesh.get_group("model")
    rx = _all_to_all(send.reshape(mdl * cap_s, d), group)
    rs = _all_to_all(send_slot[:-1], group)
    valid = rs >= 0
    local = torch.where(valid, rs - col * spr, 0).to(torch.int32)
    cap2 = max(4, int(mdl * cap_s * m.capacity_factor / spr))
    y_rx, met = dispatch_combine(
        rx[None], local[None, :, None], valid[None, :, None].float(),
        lambda buf: expert_ffn(p, buf), spr, cap2,
        valid=valid[None, :, None], fused=m.fused_dispatch, impl=impl)
    y_back = _all_to_all(y_rx[0], group)             # [mdl * cap_s, D]
    if m.fused_dispatch:
        y = dispatch_ops.combine(y_back.reshape(1, mdl, cap_s, d),
                                 weight.float(), col_of, rank2, keep2,
                                 impl).to(x.dtype)
    else:
        gathered = y_back[torch.where(keep, dest, 0)]
        y = torch.zeros((1, t_loc, d), dtype=x.dtype, device=dev)
        y[0].index_add_(0, tok, gathered * (weight.reshape(tk) * keep)
                        [:, None].to(x.dtype))

    # integer metrics over every rank in one all-reduce: each column's kept
    # counts in its own slots' places (so the sum is the data sum of each
    # column's), the expert histogram, the drops
    kept = torch.zeros(num_slots(cfg), dtype=torch.int32, device=dev)
    kept[col * spr:(col + 1) * spr] = met["kept_counts"][0]
    if r_counts is not None:
        e_counts = r_counts[0].to(torch.int32)
    else:
        e_counts = torch.zeros(m.num_experts, dtype=torch.int32, device=dev)
        e_counts.scatter_add_(0, top_e.reshape(-1),
                              torch.ones(tk, dtype=torch.int32, device=dev))
    dropped = (tk - keep.sum()) + met["dropped"][0]
    ints = torch.cat([kept, e_counts, dropped.reshape(1).to(torch.int32)])
    rz = torch.logsumexp(torch.log(probs[0] + 1e-9), dim=-1).square().mean()
    stats = torch.cat([probs[0].mean(0), rz.reshape(1)])
    if world > 1:
        ints = _all_reduce(ints, None)
        stats = _all_reduce(stats, None) / world
    s = num_slots(cfg)
    slot_counts, e_counts = ints[:s], ints[s:s + m.num_experts]
    pbar, rz = stats[:m.num_experts], stats[m.num_experts]
    f = e_counts.float() / torch.clamp(e_counts.sum().float(), min=1.0)
    aux = m.num_experts * (f * pbar).sum()
    return y, {"slot_counts": slot_counts[None], "kept_counts":
               slot_counts[None], "dropped": ints[-1:],
               "aux_loss": aux.reshape(1), "expert_counts": e_counts[None],
               "router_z": rz.reshape(1)}
