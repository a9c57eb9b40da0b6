"""Per-block-type parameter definitions and apply functions for the block
types the port runs so far: ``attn`` (full-attention decoder block) and
``moe`` (attention + MoE-FFN decoder block).

Each type defines:
  defs(cfg)                        parameter declaration (ParamDef tree)
  apply(p, x, ctx)                 full-sequence forward (train / prefill)
  decode(p, x, cache, ctx)         one-token forward over a batch of rows,
                                   each at its own position ``ctx["pos"]``
  cache(cfg, batch, smax)          per-layer cache
Decode writes the new K/V rows into the cache tensors in place (the
reference returns updated copies): one row per batch row, at that row's
position, and only for the rows ``ctx["active"]`` selects.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_rope, rms_norm, swiglu
from repro_torch.models.params import ParamDef


def _attn_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, h * hd), ("embed", "qkv")),
        "wk": ParamDef((d, kh * hd), ("embed", "qkv")),
        "wv": ParamDef((d, kh * hd), ("embed", "qkv")),
        "wo": ParamDef((h * hd, d), ("qkv", "embed")),
    }


def _mlp_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "mlp")),
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed")),
    }


def _rope(cfg: ArchConfig, x, positions):
    if cfg.rope_theta <= 0:
        return x
    return apply_rope(x, positions, cfg.rope_theta)


def _project_qkv(cfg, p, x):
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _self_attention(cfg, p, x, ctx):
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q = _rope(cfg, q, ctx["positions"])
    k = _rope(cfg, k, ctx["positions"])
    out = attn_lib.chunked_attention(q, k, v)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def _decode_attention(cfg, p, x, cache, ctx):
    """x [B,1,D] (normed); writes this token's K/V into ``cache`` in place
    and returns the attention output projected back to [B,1,D]."""
    pos = ctx["pos"]                                     # [B]
    q, k, v = _project_qkv(cfg, p, x)
    positions = pos[:, None]
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    # an out-of-range index is clamped, as the reference's
    # dynamic_update_slice does; inactive rows keep their cache untouched
    widx = torch.clamp(pos, max=cache["k"].shape[1] - 1)
    active = ctx.get("active")
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        new = new[:, 0].to(c.dtype)
        if active is not None:
            new = torch.where(active[:, None, None], new, c[rows, widx])
        c[rows, widx] = new
    out = attn_lib.decode_attention(q, cache["k"], cache["v"], pos)
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def attn_cache(cfg: ArchConfig, batch: int, smax: int, kv_dtype=None,
               device="cpu"):
    kh, hd = cfg.n_kv_heads, cfg.hd
    dt = kv_dtype or torch.bfloat16
    return {"k": torch.zeros((batch, smax, kh, hd), dtype=dt, device=device),
            "v": torch.zeros((batch, smax, kh, hd), dtype=dt, device=device)}


# ---------------------------------------------------------------------- attn

def attn_defs(cfg):
    return {"ln1": ParamDef((cfg.d_model,), ("embed",), "ones"),
            "ln2": ParamDef((cfg.d_model,), ("embed",), "ones"),
            **_attn_defs(cfg), **_mlp_defs(cfg)}


def attn_apply(p, x, ctx):
    cfg = ctx["cfg"]
    h = x + _self_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
    return h + swiglu(rms_norm(h, p["ln2"], cfg.norm_eps),
                      p["w_gate"], p["w_up"], p["w_down"])


def attn_decode(p, x, cache, ctx):
    cfg = ctx["cfg"]
    h = x + _decode_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps),
                              cache, ctx)
    return h + swiglu(rms_norm(h, p["ln2"], cfg.norm_eps),
                      p["w_gate"], p["w_up"], p["w_down"])


# ----------------------------------------------------------------------- moe

def moe_defs(cfg):
    m = cfg.moe
    s = moe_lib.num_slots(cfg)
    d, f = cfg.d_model, m.expert_d_ff
    return {"ln1": ParamDef((cfg.d_model,), ("embed",), "ones"),
            "ln2": ParamDef((cfg.d_model,), ("embed",), "ones"),
            **_attn_defs(cfg),
            "router": ParamDef((d, m.num_experts), ("embed", None)),
            "w_gate": ParamDef((s, d, f), ("experts", "embed", None)),
            "w_up": ParamDef((s, d, f), ("experts", "embed", None)),
            "w_down": ParamDef((s, f, d), ("experts", None, "embed"))}


def _moe_ffn(p, h, ctx):
    """RMSNorm + MoE over h [B,S,D], grouped as ``ctx["moe_groups"]``
    says: "batch" is one group of all B·S tokens hashed from
    ``ctx["token_offset"]`` (a scalar), "row" is one group per row hashed
    from that row's position."""
    cfg = ctx["cfg"]
    b, s, d = h.shape
    xn = rms_norm(h, p["ln2"], cfg.norm_eps)
    if ctx["moe_groups"] == "row":
        flat, offset = xn, ctx["pos"]
    else:
        flat = xn.reshape(1, b * s, d)
        offset = torch.as_tensor(ctx["token_offset"],
                                 device=h.device).reshape(1)
    y, metrics = moe_lib.moe_ffn(p, flat, ctx["plan_slots"], ctx["plan_cum"],
                                 cfg, offset)
    ctx["moe_metrics"].append(metrics)
    return h + y.reshape(b, s, d)


def moe_apply(p, x, ctx):
    cfg = ctx["cfg"]
    h = x + _self_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
    return _moe_ffn(p, h, ctx)


def moe_decode(p, x, cache, ctx):
    cfg = ctx["cfg"]
    h = x + _decode_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps),
                              cache, ctx)
    return _moe_ffn(p, h, ctx)


BLOCKS: Dict[str, Dict[str, Any]] = {
    "attn": dict(defs=attn_defs, apply=attn_apply, decode=attn_decode,
                 cache=attn_cache),
    "moe": dict(defs=moe_defs, apply=moe_apply, decode=moe_decode,
                cache=attn_cache),
}
