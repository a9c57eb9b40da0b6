"""The tensor-parallel decode step of ``repro_torch.models.tp`` written
as one pass over the shards, every device crossing an inline
``.to(device)``: the form the staged step (``tp.Stages``) replaced in the
engine, kept here as the oracle that the staged step's eager run equals
bit for bit (tests/test_torch_tp_cards.py)."""
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.models.tp import _mamba_dims, _part, split_plan


class _Shards:
    """The per-step context of the shards: their devices, per-layer
    weights and caches, each device's copy of the positions and the active
    mask, and the partial-sum reduction on the first device."""

    def __init__(self, cfg, tp, devices, pos, active):
        self.cfg, self.tp, self.devices = cfg, tp, list(devices)
        self.plan = split_plan(cfg, tp)
        self.dev0 = self.devices[0]
        self.pos = [pos.to(d) for d in self.devices]
        self.active = [None if active is None else active.to(d)
                       for d in self.devices]

    def ctx(self, base, j):
        return dict(base, pos=self.pos[j], active=self.active[j])

    def sum(self, parts):
        """Partial outputs added on the first device, in shard order."""
        out = parts[0].to(self.dev0)
        for p in parts[1:]:
            out = out + p.to(self.dev0)
        return out

    def project(self, ys, ws, dtype):
        """The sum of the shards' partial products ``y @ w`` (``w`` a
        slice of a projection along the dim it contracts, in f32): each
        product in f32, added on the first device in shard order, rounded
        to ``dtype`` once."""
        return self.sum([y.float() @ w for y, w in zip(ys, ws)]).to(dtype)

    def shard_cfg(self):
        c = self.cfg
        return dataclasses.replace(c, n_heads=c.n_heads // self.tp,
                                   n_kv_heads=c.n_kv_heads // self.tp,
                                   head_dim=c.hd)


def _sq_sum(y):
    return y.float().square().sum(-1, keepdim=True)


def _norm_split(sh, ys, gammas, eps, width):
    """``rms_norm`` over the concatenation of the shards' ``ys`` (each on
    its device) with the matching slices of its gain: the sum of squares
    added over the shards on the first device, the scale handed back."""
    var = sh.sum([_sq_sum(y) for y in ys]) / width
    scale = torch.rsqrt(var + eps)
    return [y * scale.to(y.device).to(y.dtype) * g.to(y.dtype)
            for y, g in zip(ys, gammas)]


def _attention(sh, ps, cs, xn, base, window=None, rolling=False):
    cfg = sh.cfg
    if not sh.plan["attn"]:
        return B._decode_attention(cfg, ps[0], xn, cs[0], sh.ctx(base, 0),
                                   window, rolling)
    scfg = sh.shard_cfg()
    return sh.project([B._decode_attention(scfg, p, xn.to(d), c,
                                           sh.ctx(base, j), window, rolling,
                                           project=False)
                       for j, (p, c, d) in enumerate(zip(ps, cs,
                                                         sh.devices))],
                      [p["wo"] for p in ps], xn.dtype)


def _mlp(sh, ps, hn):
    if not sh.plan["mlp"]:
        p = ps[0]
        return swiglu(hn, p["w_gate"], p["w_up"], p["w_down"])
    gus = []
    for p, d in zip(ps, sh.devices):
        h = hn.to(d)
        gus.append(F.silu(h @ p["w_gate"].to(h.dtype)) *
                   (h @ p["w_up"].to(h.dtype)))
    return sh.project(gus, [p["w_down"] for p in ps], hn.dtype)


def _attn_block(sh, ps, x, cs, base, window=None, rolling=False):
    eps = sh.cfg.norm_eps
    h = x + _attention(sh, ps, cs, rms_norm(x, ps[0]["ln1"], eps), base,
                       window, rolling)
    return h + _mlp(sh, ps, rms_norm(h, ps[0]["ln2"], eps))


def _local_block(sh, ps, x, cs, base):
    return _attn_block(sh, ps, x, cs, base, window=sh.cfg.window,
                       rolling=True)


def expert_fn(sh, ps):
    """The experts over the dispatch buffer ``[G, slots, cap, D]``: each
    shard its own range of slots, on its device, gathered back whole on
    the first device."""
    def run(buf):
        if not sh.plan["experts"]:
            return moe_lib.expert_ffn(ps[0], buf)
        s = buf.shape[1]
        outs = []
        for j, (p, d) in enumerate(zip(ps, sh.devices)):
            lo, hi = _part(s, sh.tp, j)
            outs.append(moe_lib.expert_ffn(p, buf[:, lo:hi].to(d))
                        .to(sh.dev0))
        return torch.cat(outs, 1)
    return run


def moe_ffn(ps, x, plan_slots, plan_cum, cfg: ArchConfig, token_offset,
            devices, impl: str = "auto"):
    """The MoE FFN over ``len(devices)`` shards of ``ps`` (``x`` [G,T,D]
    on the first device): ``models.moe.moe_ffn`` with the experts' buffer
    split over the shards, so routing, dispatch and combine are the
    unsplit layer's calls."""
    sh = _Shards(cfg, len(devices), devices, token_offset, None)
    return moe_lib.moe_ffn(ps[0], x, plan_slots, plan_cum, cfg,
                           token_offset, impl, expert_fn=expert_fn(sh, ps))


def _moe_block(sh, ps, x, cs, base):
    eps = sh.cfg.norm_eps
    h = x + _attention(sh, ps, cs, rms_norm(x, ps[0]["ln1"], eps), base)
    return B._moe_ffn(ps[0], h, dict(base, expert_fn=expert_fn(sh, ps)))


def _rwkv_block(sh, ps, x, cs, base):
    cfg, eps, p0, c0 = sh.cfg, sh.cfg.norm_eps, ps[0], cs[0]
    active = base.get("active")
    xn = rms_norm(x, p0["ln1"], eps)
    x_tm = c0["x_tm"].to(xn.dtype)
    if not sh.plan["rwkv"]:
        tm, _, s_new = B.rwkv_time_mix(p0, xn, base, x_prev=x_tm,
                                       state=c0["s"])
        B._write_rows(c0["s"], s_new, active)
    else:
        ctx = dict(base, cfg=sh.shard_cfg())
        ys, gs = [], []
        for j, (p, c, d) in enumerate(zip(ps, cs, sh.devices)):
            y, g, s_new = B.rwkv_time_heads(p, xn.to(d), ctx,
                                            x_prev=x_tm.to(d), state=c["s"])
            B._write_rows(c["s"], s_new, sh.active[j])
            ys.append(y)
            gs.append(g)
        ys = _norm_split(sh, ys, [p["ln_x"] for p in ps], eps, cfg.d_model)
        tm = sh.project([y * F.silu(g) for y, g in zip(ys, gs)],
                        [p["wo"] for p in ps], xn.dtype)
    B._write_rows(c0["x_tm"], xn, active)
    h = x + tm
    hn = rms_norm(h, p0["ln2"], eps)
    value = None
    if sh.plan["mlp"]:
        def value(xk):
            return sh.project([B.rwkv_channel_key(p, xk.to(d))
                               for p, d in zip(ps, sh.devices)],
                              [p["wcv"] for p in ps], hn.dtype)
    cm, _ = B.rwkv_channel_mix(p0, hn, x_prev=c0["x_cm"].to(hn.dtype),
                               value=value)
    B._write_rows(c0["x_cm"], hn, active)
    return h + cm


def _mamba_block(sh, ps, x, cs, base):
    if not sh.plan["mamba"]:
        return B.mamba_decode(ps[0], x, cs[0], sh.ctx(base, 0))
    cfg, eps, p0, c0 = sh.cfg, sh.cfg.norm_eps, ps[0], cs[0]
    di, nh, ns = _mamba_dims(cfg)
    dl, hl = di // sh.tp, nh // sh.tp
    xn = rms_norm(x, p0["ln"], eps)
    # B and C, shared by every head: their conv window on the first shard
    win_bc, bc = B.conv_step(c0["conv_bc"], xn @ p0["in_proj_bc"].to(x.dtype),
                             p0["conv_w_bc"])
    bm, cm = torch.split(bc, [ns, ns], dim=-1)
    B._write_rows(c0["conv_bc"], win_bc[:, 1:], base.get("active"))
    vs = []
    for j, (p, c, d) in enumerate(zip(ps, cs, sh.devices)):
        z, xj, dt = torch.split(xn.to(d) @ p["in_proj"].to(x.dtype),
                                [dl, dl, hl], dim=-1)
        win, xs = B.conv_step(c["conv"], xj, p["conv_w"])
        y, h_new = B.mamba_heads_step(p, xs, dt[:, 0], bm.to(d), cm.to(d),
                                      c["h"], cfg.ssm.head_dim)
        B._write_rows(c["conv"], win[:, 1:], sh.active[j])
        B._write_rows(c["h"], h_new, sh.active[j])
        vs.append(y * F.silu(z))
    vs = _norm_split(sh, vs, [p["norm"] for p in ps], eps, di)
    return x + sh.project(vs, [p["out_proj"] for p in ps], x.dtype)


def _replicated(t):
    """A block type the step does not split runs whole on the first
    shard (whisper's ``dec``)."""
    def run(sh, ps, x, cs, base):
        return B.BLOCKS[t]["decode"](ps[0], x, cs[0], sh.ctx(base, 0))
    return run


TP_BLOCKS = {"attn": _attn_block, "shared_attn": _attn_block,
             "local": _local_block, "moe": _moe_block, "rwkv": _rwkv_block,
             "mamba": _mamba_block}


def _embed(sh, shards, token):
    if not sh.plan["vocab"]:
        return shards[0]["embed"][token].to(torch.bfloat16)
    parts = []
    for j, (p, d) in enumerate(zip(shards, sh.devices)):
        lo, hi = _part(sh.cfg.vocab, sh.tp, j)
        t = token.to(d)
        mine = (t >= lo) & (t < hi)
        rows = p["embed"][torch.where(mine, t - lo, 0)]
        parts.append(torch.where(mine[..., None], rows, 0)
                     .to(torch.bfloat16))
    return sh.sum(parts)


def _logits(sh, shards, x):
    cfg = sh.cfg

    def head(p, xj):
        w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
        return xj @ w.to(xj.dtype)

    if not sh.plan["vocab"]:
        return head(shards[0], x)
    return torch.cat([head(p, x.to(d)).to(sh.dev0)
                      for p, d in zip(shards, sh.devices)], -1)


def decode_step(shards: List[Dict[str, Any]], state, token,
                cfg: ArchConfig, devices: Sequence[torch.device], *,
                plan=None, moe_groups: str = "row", active=None,
                metrics: Optional[list] = None):
    """``lm.decode_step`` over ``len(devices)`` shards: ``shards`` from
    ``split_params``, ``state["caches"]`` from ``init_cache`` (updated in
    place), ``state["pos"]`` ``[B]``, ``token`` ``[B, 1]`` and ``active``
    on the first device.  Returns (logits [B,V] f32 on the first device,
    state with ``pos`` advanced)."""
    tp = len(devices)
    pos = state["pos"]
    sh = _Shards(cfg, tp, devices, pos, active)
    x = _embed(sh, shards, token)
    base = {"cfg": cfg, "pos": pos, "moe_groups": moe_groups,
            "token_offset": pos[:1], "active": active, "moe_metrics": []}
    if plan is None and lm.n_moe_layers(cfg):
        plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg),
                                     device=x.device)
    caches, counts, views = state["caches"], lm.type_counts(cfg), {}
    for t, count, off in lm.pattern_runs(cfg):
        run = TP_BLOCKS.get(t) or _replicated(t)
        if t not in views:
            views[t] = [lm._layer_views(s, t, counts[t]) for s in shards]
        for li in range(off, off + count):
            ps = [v[li] for v in views[t]]
            cs = [{k: v[li] for k, v in c.get(t, {}).items()}
                  for c in caches]
            ctx = base
            if t == "moe":
                ctx = dict(base, plan_slots=plan.slots[li],
                           plan_cum=plan.cum[li])
            x = run(sh, ps, x, cs, ctx)
    if metrics is not None:
        metrics.extend(base["moe_metrics"])
    x = rms_norm(x, shards[0]["final_ln"], cfg.norm_eps)
    logits = _logits(sh, shards, x)
    step = torch.ones_like(pos) if active is None else active.long()
    return logits[:, 0].float(), {"caches": caches, "pos": pos + step}
