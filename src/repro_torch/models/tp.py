"""A tensor-parallel decode step over ``tp`` shards, written out by hand:
the function the JAX package's ``decode_step`` computes when XLA
partitions it for weights placed under ``param_specs(cfg, mesh,
fsdp=False)`` on a mesh whose ``model`` axis has ``tp`` devices (a serve
pool at ``serve.pool_tp = tp``).

The split is by meaning, so that every shard's slice is a whole unit:

* attention (``attn``, ``local``, ``moe``'s, zamba2's ``shared_attn``):
  by groups of KV heads, each with its query heads (``qkv`` -> ``model``);
  a model whose KV heads ``tp`` does not divide (gemma3-1b has one) runs
  it whole on the first shard, as the reference replicates a leaf whose
  dim does not divide;
* the dense MLP and RWKV6's channel mix: by ``d_ff`` columns (``mlp``);
* RWKV6's time mix: by heads.  Its ``ln_x`` is an RMSNorm over the whole
  ``d_model``, so its sum of squares is added over the shards;
* Mamba2: by heads (``z``, ``x``, ``dt`` and the conv's ``x`` columns);
  ``B`` and ``C`` are shared by every head and run once, on the first
  shard.  The gated RMSNorm over ``d_inner`` adds its sum of squares over
  the shards;
* the logits: by vocab columns, gathered before the argmax; the embedding
  lookup by vocab rows (each token's row lives on one shard, so the sum of
  the shards' masked lookups is exact);
* MoE (``experts`` -> ``model``): the router, gating (kernel 1) and
  dispatch (kernel 2) run once, on the first shard; each shard runs its
  own range of the ``[G, slots, cap, D]`` buffer's expert slots; their
  outputs are gathered back whole and combine (kernel 3) runs once.  So
  the layer's integers (expert ids, phi, keep masks, drops) are the
  unsplit layer's, exactly.

Every partial output projection (``wo``, ``w_down``, ``out_proj``,
``wcv``) is a product over the shard's slice of the contracted dim,
kept in f32 (its weights stored in f32 by ``split_params``), summed on
the first shard's device in shard order (0 + 1 + ...) and rounded to
bf16 once, as the unsplit product rounds its f32 sum once; the residual
stream lives there, and the sum goes back to each shard with the next
layer's input.  The adds run in another order than one product's, so the
step is not bit-identical to the unsplit one (the reference says the
same of its split, ``configs/base.py``'s ``pool_tp``).

``split_params`` makes each shard's weights; ``cache_pieces`` says how a
pool's cache leaves split with the heads they belong to, and
``init_cache`` makes each shard's; ``decode_step`` is the step.

The step is written as a program of *stages* (``Stages``): each stage is
one shard's work on its own device and tensors, and every device crossing
above (the positions, mask and token to each shard; a block's normed
input, Mamba2's ``B``/``C`` and RWKV6's shifted row to each shard; each
partial sum, sum of squares, expert output and logit slice back to the
first shard; the norm's scale and the experts' buffer slices out to the
shards) is an *exchange* between stages.  Run eagerly the stages do
exactly the arithmetic above; on the card the engine captures one CUDA
graph per (shard, stage) and runs the exchanges as copies between them
(``engine.serve.StagedStep``), so a pool's shards may sit on distinct
cards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import rms_norm, swiglu

ATTN_TYPES = ("attn", "local", "moe", "shared_attn")


def split_plan(cfg: ArchConfig, tp: int) -> Dict[str, bool]:
    """Which parts of the model split over ``tp`` shards (a part whose
    unit count ``tp`` does not divide runs whole on the first shard)."""
    out = {"attn": cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0,
           "mlp": cfg.d_ff % tp == 0,
           "vocab": cfg.vocab % tp == 0,
           "rwkv": cfg.n_heads % tp == 0,
           "experts": bool(cfg.moe) and moe_lib.num_slots(cfg) % tp == 0,
           "mamba": False}
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        out["mamba"] = (di // cfg.ssm.head_dim) % tp == 0
    return out


def _mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    di = cfg.ssm.expand * cfg.d_model
    return di, di // cfg.ssm.head_dim, cfg.ssm.state_size


def _part(n: int, tp: int, j: int) -> Tuple[int, int]:
    return j * n // tp, (j + 1) * n // tp


# the partial output projections: their shards' products are summed
PARTIAL = ("wo", "w_down", "out_proj", "wcv")


def _leaf_splits(cfg: ArchConfig, t: str, tp: int) -> Dict[str, tuple]:
    """Block type ``t``'s split leaves: name -> (dim in the per-layer
    leaf, size of that dim).  A leaf not listed is whole on every shard."""
    sp = split_plan(cfg, tp)
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {}
    if t in ATTN_TYPES and sp["attn"]:
        out.update(wq=(1, h * hd), wk=(1, kh * hd), wv=(1, kh * hd),
                   wo=(0, h * hd))
    if t in ("attn", "local", "shared_attn") and sp["mlp"]:
        out.update(w_gate=(1, cfg.d_ff), w_up=(1, cfg.d_ff),
                   w_down=(0, cfg.d_ff))
    if t == "moe" and sp["experts"]:
        s = moe_lib.num_slots(cfg)
        out.update(w_gate=(0, s), w_up=(0, s), w_down=(0, s))
    if t == "rwkv":
        if sp["rwkv"]:
            out.update(wr=(1, d), wk=(1, d), wv=(1, d), wg=(1, d),
                       w_lora_b=(1, d), w0=(0, d), u=(0, h), ln_x=(0, d),
                       wo=(0, d))
        if sp["mlp"]:
            out.update(wck=(1, cfg.d_ff), wcv=(0, cfg.d_ff))
    if t == "mamba" and sp["mamba"]:
        di, nh, _ = _mamba_dims(cfg)
        out.update(dt_bias=(0, nh), a_log=(0, nh), d_skip=(0, nh),
                   norm=(0, di), out_proj=(0, di))
    return out


def split_params(params, cfg: ArchConfig, tp: int,
                 devices: Sequence[torch.device]) -> List[Dict[str, Any]]:
    """Each shard's weights from the serving weights ``params``: a split
    leaf's slice on the shard's device (a slice along a leading dim is a
    view where the device is the same, any other a contiguous copy), a
    leaf that does not split whole on every shard (the same tensor where
    the device is the same).  A partial output projection's slice
    (``PARTIAL``, split along the dim it contracts) is stored in f32, the
    type its partial products are summed in.  Mamba2's ``in_proj`` and
    ``conv_w`` become
    each shard's ``z``/``x``/``dt`` and ``x`` columns, with the shared
    ``B``/``C`` columns as ``in_proj_bc``/``conv_w_bc``."""
    sp = split_plan(cfg, tp)
    out = []
    for j, dev in enumerate(devices):
        def cut(x, dim, n):
            lo, hi = _part(n, tp, j)
            return x.narrow(dim, lo, hi - lo).to(dev).contiguous()

        shard: Dict[str, Any] = {}
        for k, v in params.items():
            if not isinstance(v, dict):
                if k == "embed" and sp["vocab"]:
                    shard[k] = cut(v, 0, cfg.vocab)
                elif k == "lm_head" and sp["vocab"]:
                    shard[k] = cut(v, 1, cfg.vocab)
                else:
                    shard[k] = v.to(dev)
                continue
            off = 0 if k == "shared_attn" else 1   # the stacked layer dim
            splits = _leaf_splits(cfg, k, tp)
            leaves = {}
            for n, x in v.items():
                if n in splits:
                    dim, size = splits[n]
                    leaves[n] = cut(x, dim + off, size)
                    if n in PARTIAL and not (k == "moe" and n == "w_down"):
                        leaves[n] = leaves[n].float()
                else:
                    leaves[n] = x.to(dev)
            if k == "mamba" and sp["mamba"]:
                di, nh, ns = _mamba_dims(cfg)
                w, cw = v["in_proj"], v["conv_w"]
                (zl, zh), (hl, hh) = _part(di, tp, j), _part(nh, tp, j)
                leaves["in_proj"] = torch.cat(
                    [w[..., zl:zh], w[..., di + zl:di + zh],
                     w[..., 2 * di + 2 * ns + hl:2 * di + 2 * ns + hh]],
                    -1).to(dev)
                leaves["in_proj_bc"] = w[..., 2 * di:2 * di + 2 * ns].to(
                    dev).contiguous()
                leaves["conv_w"] = cw[..., zl:zh].to(dev).contiguous()
                leaves["conv_w_bc"] = cw[..., di:].to(dev).contiguous()
            shard[k] = leaves
        out.append(shard)
    return out


def cache_pieces(cfg: ArchConfig, tp: int):
    """How each cache leaf ``(type, name)`` of ``lm.init_cache`` splits
    over the shards: ``[(shard, key, dim, lo, hi)]``, the piece shard
    ``shard`` holds under ``key`` being the leaf's ``[lo, hi)`` along
    ``dim`` (of the stacked ``[n, slots, ...]`` leaf), or the whole leaf
    (``dim`` None) on the first shard.  Attention K/V split by KV head,
    RWKV6's state and Mamba2's by head, Mamba2's conv window by its ``x``
    columns, with its ``B``/``C`` columns on the first shard; RWKV6's
    token-shift rows stay whole on the first shard.

    The reference's ``pool_specs`` splits the first dim past the slot's
    successor that ``model`` divides: for an attention leaf ``[n, slots,
    S, KH, hd]`` that is the cache's sequence ``S``, so each device would
    hold a range of positions of every head and a decode step would merge
    partial softmaxes across devices.  The port splits by KV head, the
    unit its step splits attention by, so each head's softmax stays on one
    shard and nothing of it crosses; the recurrent states split by head
    in both."""
    sp = split_plan(cfg, tp)
    out = {}

    def even(t, k, dim, n):
        return [(j, k, dim) + _part(n, tp, j) for j in range(tp)]

    for t in lm.type_counts(cfg):
        one = B.BLOCKS[t]["cache"](cfg, 1, 1, None, "meta")
        for k in one:
            whole = [(0, k, None, 0, 0)]
            if t in ATTN_TYPES and k in ("k", "v") and sp["attn"]:
                out[(t, k)] = even(t, k, 3, cfg.n_kv_heads)
            elif t == "rwkv" and k == "s" and sp["rwkv"]:
                out[(t, k)] = even(t, k, 2, cfg.n_heads)
            elif t == "mamba" and sp["mamba"] and k in ("h", "conv"):
                di, nh, ns = _mamba_dims(cfg)
                if k == "h":
                    out[(t, k)] = even(t, k, 2, nh)
                else:
                    out[(t, k)] = even(t, k, 3, di) + \
                        [(0, "conv_bc", 3, di, di + 2 * ns)]
            else:
                out[(t, k)] = whole
    return out


def init_cache(cfg: ArchConfig, slots: int, max_len: int, tp: int,
               devices: Sequence[torch.device]) -> List[Dict[str, Any]]:
    """Each shard's cache leaves (zeros), as ``cache_pieces`` splits
    ``lm.init_cache``'s: ``[{type: {key: [n, slots, ...]}}]``."""
    full = lm.init_cache(cfg, slots, max_len, device="meta")["caches"]
    out: List[Dict[str, Any]] = [{} for _ in range(tp)]
    for (t, k), pieces in cache_pieces(cfg, tp).items():
        leaf = full[t][k]
        for j, key, dim, lo, hi in pieces:
            shape = list(leaf.shape)
            if dim is not None:
                shape[dim] = hi - lo
            out[j].setdefault(t, {})[key] = torch.zeros(
                shape, dtype=leaf.dtype, device=devices[j])
    return out


# ---------------------------------------------------------------- the step

class Stages:
    """The step as a program over its shards: its work runs in *stages*,
    each on one shard's device and reading only that shard's tensors, and
    an *exchange* hands a tensor from one shard to another between stages.

    ``at(j)`` says that the work that follows is shard ``j``'s (a new
    stage unless shard ``j``'s is the one open); ``to(x, src, dst)`` hands
    shard ``src``'s ``x`` to shard ``dst`` and ends the open stage, also
    where ``src == dst`` (then ``x`` itself comes back), so that the work
    after it on shard ``src`` is a stage of its own; ``end()`` ends the
    last stage.  A step hands every shard its inputs before any shard
    starts on them (``_Shards.bcast``), so that on distinct cards the
    shards' stages of one exchange run side by side.

    This form runs each stage where it stands (on a card with the shard's
    device current) and an exchange as ``x.to(device)``.  The engine's
    ``engine.serve.StagedStep`` captures each (shard, stage) in a CUDA
    graph of its own on the shard's device and replays them in order, with
    the exchanges' copies into persistent staging tensors between them,
    outside every graph."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._home: Optional[int] = None

    def at(self, j: int) -> None:
        d = self.devices[j]
        if d.type == "cuda" and d.index is not None:
            if self._home is None:
                self._home = torch.cuda.current_device()
            torch.cuda.set_device(d)

    def to(self, x, src: int, dst: int):
        return x if src == dst else x.to(self.devices[dst])

    def end(self) -> None:
        if self._home is not None:
            torch.cuda.set_device(self._home)
            self._home = None


class _Shards:
    """The per-step context of the shards: their devices, each shard's
    copy of the positions and the active mask, the broadcast from and the
    partial-sum reduction on the first shard, and the step's ``Stages``."""

    def __init__(self, cfg, tp, devices, pos, active, rt: Stages):
        self.cfg, self.tp, self.devices, self.rt = cfg, tp, list(devices), rt
        self.plan = split_plan(cfg, tp)
        self.pos = self.bcast(pos)
        self.active = [None] * tp if active is None else self.bcast(active)

    def ctx(self, base, j):
        return dict(base, pos=self.pos[j], active=self.active[j])

    def bcast(self, x):
        """The first shard's ``x`` handed to every shard (shard 0 keeps
        ``x``)."""
        return [self.rt.to(x, 0, j) for j in range(self.tp)]

    def sum(self, parts):
        """Partial outputs (shard ``j``'s on shard ``j``) added on the
        first shard, in shard order; shard 0's stage is left open."""
        got = [self.rt.to(p, j, 0) for j, p in enumerate(parts)]
        self.rt.at(0)
        out = got[0]
        for p in got[1:]:
            out = out + p
        return out

    def shard_cfg(self):
        c = self.cfg
        return dataclasses.replace(c, n_heads=c.n_heads // self.tp,
                                   n_kv_heads=c.n_kv_heads // self.tp,
                                   head_dim=c.hd)


def _sq_sum(y):
    return y.float().square().sum(-1, keepdim=True)


def _partial(y, w):
    """A shard's partial product ``y @ w`` (``w`` a slice of a projection
    along the dim it contracts, in f32), in f32; ``_Shards.sum`` adds the
    shards' and the caller rounds once."""
    return y.float() @ w


def _norm_scales(sh, sqs, eps, width):
    """``rms_norm``'s scale over the concatenation of the shards' rows
    from each shard's sum of squares ``sqs``: added over the shards on the
    first shard, the scale handed back to each shard."""
    var = sh.sum(sqs) / width
    return sh.bcast(torch.rsqrt(var + eps))


def _attention(sh, ps, cs, xn, base, window=None, rolling=False):
    cfg = sh.cfg
    if not sh.plan["attn"]:
        sh.rt.at(0)
        return B._decode_attention(cfg, ps[0], xn, cs[0], sh.ctx(base, 0),
                                   window, rolling)
    scfg, xs, parts = sh.shard_cfg(), sh.bcast(xn), []
    for j, (p, c) in enumerate(zip(ps, cs)):
        sh.rt.at(j)
        y = B._decode_attention(scfg, p, xs[j], c, sh.ctx(base, j), window,
                                rolling, project=False)
        parts.append(_partial(y, p["wo"]))
    return sh.sum(parts).to(xn.dtype)


def _mlp(sh, ps, hn):
    if not sh.plan["mlp"]:
        sh.rt.at(0)
        p = ps[0]
        return swiglu(hn, p["w_gate"], p["w_up"], p["w_down"])
    hs, parts = sh.bcast(hn), []
    for j, p in enumerate(ps):
        sh.rt.at(j)
        h = hs[j]
        gu = F.silu(h @ p["w_gate"].to(h.dtype)) * (h @ p["w_up"].to(h.dtype))
        parts.append(_partial(gu, p["w_down"]))
    return sh.sum(parts).to(hn.dtype)


def _attn_block(sh, ps, x, cs, base, window=None, rolling=False):
    eps = sh.cfg.norm_eps
    sh.rt.at(0)
    h = x + _attention(sh, ps, cs, rms_norm(x, ps[0]["ln1"], eps), base,
                       window, rolling)
    return h + _mlp(sh, ps, rms_norm(h, ps[0]["ln2"], eps))


def _local_block(sh, ps, x, cs, base):
    return _attn_block(sh, ps, x, cs, base, window=sh.cfg.window,
                       rolling=True)


def expert_fn(sh, ps):
    """The experts over the dispatch buffer ``[G, slots, cap, D]`` (on the
    first shard): each shard its own range of slots, gathered back whole
    on the first shard, whose stage is left open."""
    def run(buf):
        if not sh.plan["experts"]:
            return moe_lib.expert_ffn(ps[0], buf)
        s = buf.shape[1]
        pieces, outs = [], []
        for j in range(sh.tp):
            lo, hi = _part(s, sh.tp, j)
            pieces.append(sh.rt.to(buf[:, lo:hi], 0, j))
        for j, p in enumerate(ps):
            sh.rt.at(j)
            outs.append(moe_lib.expert_ffn(p, pieces[j]))
        got = [sh.rt.to(o, j, 0) for j, o in enumerate(outs)]
        sh.rt.at(0)
        return torch.cat(got, 1)
    return run


def moe_ffn(ps, x, plan_slots, plan_cum, cfg: ArchConfig, token_offset,
            devices, impl: str = "auto"):
    """The MoE FFN over ``len(devices)`` shards of ``ps`` (``x`` [G,T,D]
    on the first device): ``models.moe.moe_ffn`` with the experts' buffer
    split over the shards, so routing, dispatch and combine are the
    unsplit layer's calls."""
    rt = Stages(devices)
    try:
        sh = _Shards(cfg, len(devices), devices, token_offset, None, rt)
        rt.at(0)
        return moe_lib.moe_ffn(ps[0], x, plan_slots, plan_cum, cfg,
                               token_offset, impl,
                               expert_fn=expert_fn(sh, ps))
    finally:
        rt.end()


def _moe_block(sh, ps, x, cs, base):
    eps = sh.cfg.norm_eps
    sh.rt.at(0)
    h = x + _attention(sh, ps, cs, rms_norm(x, ps[0]["ln1"], eps), base)
    return B._moe_ffn(ps[0], h, dict(base, expert_fn=expert_fn(sh, ps)))


def _rwkv_block(sh, ps, x, cs, base):
    cfg, eps, p0, c0 = sh.cfg, sh.cfg.norm_eps, ps[0], cs[0]
    active = base.get("active")
    sh.rt.at(0)
    xn = rms_norm(x, p0["ln1"], eps)
    x_tm = c0["x_tm"].to(xn.dtype)
    if not sh.plan["rwkv"]:
        tm, _, s_new = B.rwkv_time_mix(p0, xn, base, x_prev=x_tm,
                                       state=c0["s"])
        B._write_rows(c0["s"], s_new, active)
    else:
        ctx = dict(base, cfg=sh.shard_cfg())
        xs, prev = sh.bcast(xn), sh.bcast(x_tm)
        ys, gs, sqs = [], [], []
        for j, (p, c) in enumerate(zip(ps, cs)):
            sh.rt.at(j)
            y, g, s_new = B.rwkv_time_heads(p, xs[j], ctx, x_prev=prev[j],
                                            state=c["s"])
            B._write_rows(c["s"], s_new, sh.active[j])
            ys.append(y)
            gs.append(g)
            sqs.append(_sq_sum(y))
        scales, parts = _norm_scales(sh, sqs, eps, cfg.d_model), []
        for j, (p, y, g) in enumerate(zip(ps, ys, gs)):
            sh.rt.at(j)
            y = y * scales[j].to(y.dtype) * p["ln_x"].to(y.dtype)
            parts.append(_partial(y * F.silu(g), p["wo"]))
        tm = sh.sum(parts).to(xn.dtype)
    B._write_rows(c0["x_tm"], xn, active)
    h = x + tm
    hn = rms_norm(h, p0["ln2"], eps)
    value = None
    if sh.plan["mlp"]:
        def value(xk):
            xks, parts = sh.bcast(xk), []
            for j, p in enumerate(ps):
                sh.rt.at(j)
                parts.append(_partial(B.rwkv_channel_key(p, xks[j]),
                                      p["wcv"]))
            return sh.sum(parts).to(hn.dtype)
    cm, _ = B.rwkv_channel_mix(p0, hn, x_prev=c0["x_cm"].to(hn.dtype),
                               value=value)
    B._write_rows(c0["x_cm"], hn, active)
    return h + cm


def _mamba_block(sh, ps, x, cs, base):
    sh.rt.at(0)
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
    xs, bms, cms = sh.bcast(xn), sh.bcast(bm), sh.bcast(cm)
    vs, sqs = [], []
    for j, (p, c) in enumerate(zip(ps, cs)):
        sh.rt.at(j)
        z, xj, dt = torch.split(xs[j] @ p["in_proj"].to(x.dtype),
                                [dl, dl, hl], dim=-1)
        win, xc = B.conv_step(c["conv"], xj, p["conv_w"])
        y, h_new = B.mamba_heads_step(p, xc, dt[:, 0], bms[j], cms[j],
                                      c["h"], cfg.ssm.head_dim)
        B._write_rows(c["conv"], win[:, 1:], sh.active[j])
        B._write_rows(c["h"], h_new, sh.active[j])
        vs.append(y * F.silu(z))
        sqs.append(_sq_sum(vs[-1]))
    scales, parts = _norm_scales(sh, sqs, eps, di), []
    for j, (p, v) in enumerate(zip(ps, vs)):
        sh.rt.at(j)
        v = v * scales[j].to(v.dtype) * p["norm"].to(v.dtype)
        parts.append(_partial(v, p["out_proj"]))
    return x + sh.sum(parts).to(x.dtype)


def _replicated(t):
    """A block type the step does not split runs whole on the first
    shard (whisper's ``dec``)."""
    def run(sh, ps, x, cs, base):
        sh.rt.at(0)
        return B.BLOCKS[t]["decode"](ps[0], x, cs[0], sh.ctx(base, 0))
    return run


TP_BLOCKS = {"attn": _attn_block, "shared_attn": _attn_block,
             "local": _local_block, "moe": _moe_block, "rwkv": _rwkv_block,
             "mamba": _mamba_block}


def _embed(sh, shards, token):
    if not sh.plan["vocab"]:
        sh.rt.at(0)
        return shards[0]["embed"][token].to(torch.bfloat16)
    ts, parts = sh.bcast(token), []
    for j, p in enumerate(shards):
        sh.rt.at(j)
        lo, hi = _part(sh.cfg.vocab, sh.tp, j)
        t = ts[j]
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
        sh.rt.at(0)
        return head(shards[0], x)
    xs, outs = sh.bcast(x), []
    for j, p in enumerate(shards):
        sh.rt.at(j)
        outs.append(head(p, xs[j]))
    got = [sh.rt.to(o, j, 0) for j, o in enumerate(outs)]
    sh.rt.at(0)
    return torch.cat(got, -1)


def decode_step(shards: List[Dict[str, Any]], state, token,
                cfg: ArchConfig, devices: Sequence[torch.device], *,
                plan=None, moe_groups: str = "row", active=None,
                metrics: Optional[list] = None,
                stages: Optional[Stages] = None,
                tap: Optional[Callable] = None):
    """``lm.decode_step`` over ``len(devices)`` shards: ``shards`` from
    ``split_params``, ``state["caches"]`` from ``init_cache`` (updated in
    place), ``state["pos"]`` ``[B]``, ``token`` ``[B, 1]`` and ``active``
    on the first device.  Returns (logits [B,V] f32 on the first device,
    state with ``pos`` advanced).

    The step runs as ``stages`` says (``Stages`` for the eager form, which
    this call ends; a caller that passes its own ends it, so that its work
    after the step joins shard 0's last stage).  It begins with one
    exchange (the positions, the active mask and the token to every
    shard) and ends in shard 0's stage.  ``tap`` is ``lm.decode_step``'s,
    called in shard 0's stage."""
    tp = len(devices)
    rt = Stages(devices) if stages is None else stages
    try:
        pos = state["pos"]
        sh = _Shards(cfg, tp, devices, pos, active, rt)
        x = _embed(sh, shards, token)
        rt.at(0)
        if tap is not None:
            x = tap(0, x)
        base = {"cfg": cfg, "pos": pos, "moe_groups": moe_groups,
                "token_offset": pos[:1], "active": active,
                "moe_metrics": []}
        if plan is None and lm.n_moe_layers(cfg):
            plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg),
                                         device=x.device)
        caches, counts, views = state["caches"], lm.type_counts(cfg), {}
        i = 0
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
                i += 1
                if tap is not None:
                    rt.at(0)
                    x = tap(i, x)
        if metrics is not None:
            metrics.extend(base["moe_metrics"])
        rt.at(0)
        x = rms_norm(x, shards[0]["final_ln"], cfg.norm_eps)
        logits = _logits(sh, shards, x)
        step = torch.ones_like(pos) if active is None else active.long()
        return logits[:, 0].float(), {"caches": caches, "pos": pos + step}
    finally:
        if stages is None:
            rt.end()
