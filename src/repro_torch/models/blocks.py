"""Per-block-type parameter definitions and apply functions for every
block type of the reference: ``attn`` (full-attention decoder block),
``local`` (the same block over a sliding window of ``cfg.window`` keys,
decoding from a rolling cache of that many rows), ``moe`` (attention +
MoE-FFN decoder block), ``rwkv`` (RWKV6 time mix + channel mix),
``mamba`` (Mamba2 SSD block), ``shared_attn`` (zamba2's attention
block, one weight copy shared by every occurrence), and whisper's ``enc``
(bidirectional encoder block; no decode, no cache) and ``dec`` (decoder
block with cross-attention over the encoder's output, decoding against
the cross K/V held in its cache).  With ``cfg.mrope`` (qwen2-vl) every
rotary block rotates by the (t, h, w) ids ``ctx["positions3"]``.

Each type defines:
  defs(cfg)                        parameter declaration (ParamDef tree)
  apply(p, x, ctx)                 full-sequence forward (train / prefill)
  decode(p, x, cache, ctx)         one-token forward over a batch of rows,
                                   each at its own position ``ctx["pos"]``
  cache(cfg, batch, smax, kv_dtype, device)   per-layer cache
  f32                              parameter names the block reads in f32
                                   (all others are cast to the bf16
                                   activations at use)
Decode updates the cache tensors in place (the reference returns updated
copies), and only for the rows ``ctx["active"]`` selects: attention writes
one K/V row per batch row at that row's position (``local``: at that
position modulo the ring's length); the recurrent blocks
overwrite their state rows, which cannot be rewound, so an inactive row
must keep its state untouched.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba2_ssd.ops import mamba2, mamba2_decode_step
from repro_torch.kernels.rwkv6_scan.ops import rwkv6, rwkv6_decode_step
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_mrope, apply_rope, rms_norm,
                                       swiglu)
from repro_torch.models.params import ParamDef

LORA_DIM = 64


def _attn_defs(cfg: ArchConfig, cross: bool = False) -> Dict[str, ParamDef]:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pre = "c" if cross else ""
    return {
        pre + "wq": ParamDef((d, h * hd), ("embed", "qkv")),
        pre + "wk": ParamDef((d, kh * hd), ("embed", "qkv")),
        pre + "wv": ParamDef((d, kh * hd), ("embed", "qkv")),
        pre + "wo": ParamDef((h * hd, d), ("qkv", "embed")),
    }


def _mlp_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "mlp")),
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed")),
    }


def _rope(cfg: ArchConfig, x, ctx):
    """Rotary positions from ``ctx``: ``positions`` [B,S], or with
    ``cfg.mrope`` the (t, h, w) ids ``positions3`` [B,S,3]; none at a
    ``rope_theta`` of 0 (whisper)."""
    if cfg.rope_theta <= 0:
        return x
    if cfg.mrope:
        return apply_mrope(x, ctx["positions3"], cfg.rope_theta)
    return apply_rope(x, ctx["positions"], cfg.rope_theta)


def _step_positions(pos):
    """A decode step's rotary positions from each row's position ``pos``
    [B]: every M-RoPE id is the row's position, as the reference's decode
    broadcasts its scalar one."""
    p = pos[:, None]
    return {"positions": p, "positions3": p[..., None].expand(-1, 1, 3)}


def _project_qkv(cfg, p, x):
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _self_attention(cfg, p, x, ctx, window=None, causal=True):
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q = _rope(cfg, q, ctx)
    k = _rope(cfg, k, ctx)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          impl=ctx.get("impl", "auto"))
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def _decode_attention(cfg, p, x, cache, ctx, window=None, rolling=False,
                      project=True):
    """x [B,1,D] (normed); writes this token's K/V into ``cache`` in place
    and returns the attention output projected back to [B,1,D] (without
    ``project``: the heads' output [B,1,H*hd] before ``wo``).  A
    ``rolling`` cache is a ring: row ``pos % Smax``."""
    pos = ctx["pos"]                                     # [B]
    q, k, v = _project_qkv(cfg, p, x)
    positions = _step_positions(pos)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    # an out-of-range index is clamped, as the reference's
    # dynamic_update_slice does; inactive rows keep their cache untouched
    smax = cache["k"].shape[1]
    widx = pos % smax if rolling else torch.clamp(pos, max=smax - 1)
    active = ctx.get("active")
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        new = new[:, 0].to(c.dtype)
        if active is not None:
            new = torch.where(active[:, None, None], new, c[rows, widx])
        c[rows, widx] = new
    out = decode_attention(q, cache["k"], cache["v"], pos, window=window,
                           rolling=rolling, impl=ctx.get("impl", "auto"))
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x.dtype) if project else out


def attn_cache(cfg: ArchConfig, batch: int, smax: int, kv_dtype, device):
    kh, hd = cfg.n_kv_heads, cfg.hd
    dt = kv_dtype or torch.bfloat16
    return {"k": torch.zeros((batch, smax, kh, hd), dtype=dt, device=device),
            "v": torch.zeros((batch, smax, kh, hd), dtype=dt, device=device)}


# ---------------------------------------------------------------------- attn

def attn_defs(cfg):
    return {"ln1": ParamDef((cfg.d_model,), ("embed",), "ones"),
            "ln2": ParamDef((cfg.d_model,), ("embed",), "ones"),
            **_attn_defs(cfg), **_mlp_defs(cfg)}


def attn_apply(p, x, ctx, window=None):
    cfg = ctx["cfg"]
    h = x + _self_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps), ctx,
                            window)
    return h + swiglu(rms_norm(h, p["ln2"], cfg.norm_eps),
                      p["w_gate"], p["w_up"], p["w_down"])


def attn_decode(p, x, cache, ctx, window=None, rolling=False):
    cfg = ctx["cfg"]
    h = x + _decode_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps),
                              cache, ctx, window, rolling)
    return h + swiglu(rms_norm(h, p["ln2"], cfg.norm_eps),
                      p["w_gate"], p["w_up"], p["w_down"])


# --------------------------------------------------------------------- local

def local_apply(p, x, ctx):
    return attn_apply(p, x, ctx, window=ctx["cfg"].window)


def local_decode(p, x, cache, ctx):
    # the rolling cache holds min(smax, window) rows (local_cache)
    return attn_decode(p, x, cache, ctx, window=ctx["cfg"].window,
                       rolling=True)


def local_cache(cfg: ArchConfig, batch: int, smax: int, kv_dtype, device):
    return attn_cache(cfg, batch, min(smax, cfg.window), kv_dtype, device)


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
    from that row's position.  With a ``ctx["mesh"]`` (a ``DeviceMesh``;
    "batch" groups only) the experts are parallel over its ``model`` dim,
    as ``ctx["layout"]`` says (``moe.moe_ffn``: "tp" ``moe_ffn_sharded``,
    "dp" ``moe_ffn_a2a``): ``p`` holds this rank's slots and ``h`` this
    rank's rows.  ``ctx["expert_fn"]`` runs the experts over the dispatch
    buffer in place of ``p``'s (``models.tp``'s split over shards)."""
    cfg = ctx["cfg"]
    b, s, d = h.shape
    xn = rms_norm(h, p["ln2"], cfg.norm_eps)
    if ctx["moe_groups"] == "row":
        flat, offset = xn, ctx["pos"]
    else:
        flat = xn.reshape(1, b * s, d)
        offset = torch.as_tensor(ctx["token_offset"],
                                 device=h.device).reshape(1)
    y, metrics = moe_lib.moe_ffn(p, flat, ctx["plan_slots"],
                                 ctx["plan_cum"], cfg, offset,
                                 ctx.get("impl", "auto"), ctx.get("mesh"),
                                 ctx.get("layout", "tp"),
                                 expert_fn=ctx.get("expert_fn"))
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


def _write_rows(c, new, active):
    """Overwrite the cache leaf ``c`` [B,...] in place with ``new``, for
    the rows ``active`` [B] selects (every row when None)."""
    new = new.to(c.dtype)
    if active is not None:
        new = torch.where(active.view((-1,) + (1,) * (c.dim() - 1)), new, c)
    c.copy_(new)


# ---------------------------------------------------------------------- rwkv

def rwkv_defs(cfg):
    d = cfg.d_model
    h, n = cfg.n_heads, cfg.hd
    f = cfg.d_ff
    return {
        "ln1": ParamDef((d,), ("embed",), "ones"),
        "ln2": ParamDef((d,), ("embed",), "ones"),
        "mu_r": ParamDef((d,), ("embed",), "zeros"),
        "mu_k": ParamDef((d,), ("embed",), "zeros"),
        "mu_v": ParamDef((d,), ("embed",), "zeros"),
        "mu_w": ParamDef((d,), ("embed",), "zeros"),
        "mu_g": ParamDef((d,), ("embed",), "zeros"),
        "wr": ParamDef((d, d), ("embed", "qkv")),
        "wk": ParamDef((d, d), ("embed", "qkv")),
        "wv": ParamDef((d, d), ("embed", "qkv")),
        "wg": ParamDef((d, d), ("embed", "qkv")),
        "w0": ParamDef((d,), ("embed",), "zeros"),
        "w_lora_a": ParamDef((d, LORA_DIM), ("embed", None)),
        "w_lora_b": ParamDef((LORA_DIM, d), (None, "embed")),
        "u": ParamDef((h, n), (None, None)),
        "ln_x": ParamDef((d,), ("embed",), "ones"),
        "wo": ParamDef((d, d), ("qkv", "embed")),
        "mu_ck": ParamDef((d,), ("embed",), "zeros"),
        "wck": ParamDef((d, f), ("embed", "mlp")),
        "wcv": ParamDef((f, d), ("mlp", "embed")),
        "wcr": ParamDef((d, d), ("embed", "qkv")),
    }


def _shift(x, x_prev_token=None):
    """Token shift: prepend the previous-token row (zeros, or the carried
    row of a decode cache)."""
    pad = torch.zeros_like(x[:, :1]) if x_prev_token is None else \
        x_prev_token
    return torch.cat([pad, x[:, :-1]], dim=1)


def _rwkv_decay(p, xw):
    """Data-dependent decay w = exp(-exp(clip(w0 + lora(xw), -8, 1.5))),
    in f32."""
    lora = torch.tanh(xw @ p["w_lora_a"].to(xw.dtype)) @ \
        p["w_lora_b"].to(xw.dtype)
    return torch.exp(-torch.exp((p["w0"].float() + lora.float())
                                .clamp(-8, 1.5)))


def rwkv_time_heads(p, x, ctx, x_prev=None, state=None):
    """x [B,S,D].  The time mix's heads (``ctx["cfg"]``'s, which under
    ``models.tp`` are a shard's, with ``p`` its slices) before ``ln_x``:
    (their output [B,S,H*N], the gate's input g [B,S,H*N], new WKV
    state).  A one-token call with a state is a decode step; anything else
    runs the scan (the kernel on the card)."""
    cfg = ctx["cfg"]
    b, s, _ = x.shape
    h, n = cfg.n_heads, cfg.hd
    xs = _shift(x, x_prev)

    def mix(mu):
        return x + mu.to(x.dtype) * (xs - x)

    r = mix(p["mu_r"]) @ p["wr"].to(x.dtype)
    k = mix(p["mu_k"]) @ p["wk"].to(x.dtype)
    v = mix(p["mu_v"]) @ p["wv"].to(x.dtype)
    g = mix(p["mu_g"]) @ p["wg"].to(x.dtype)
    # the scan takes the decay in the activations' dtype, as the reference
    # hands it over: in bf16, decays above ~0.998 round to 1.0
    w = _rwkv_decay(p, mix(p["mu_w"])).to(x.dtype)

    def to_heads(z):
        return z.reshape(b, s, h, n).transpose(1, 2)      # [B,H,S,N]

    u = p["u"].float()
    if s == 1 and state is not None:
        y, s_new = rwkv6_decode_step(
            to_heads(r)[:, :, 0], to_heads(k)[:, :, 0], to_heads(v)[:, :, 0],
            to_heads(w)[:, :, 0], u, state)
        y = y[:, :, None]                                 # [B,H,1,N]
    else:
        y, s_new = rwkv6(to_heads(r), to_heads(k), to_heads(v), to_heads(w),
                         u, s0=state, impl=ctx.get("impl", "auto"))
    return y.transpose(1, 2).reshape(b, s, h * n), g, s_new


def rwkv_time_mix(p, x, ctx, x_prev=None, state=None):
    """x [B,S,D].  Returns (out, last row of x, new WKV state)
    (``rwkv_time_heads``, then ``ln_x``, the gate and ``wo``)."""
    y, g, s_new = rwkv_time_heads(p, x, ctx, x_prev, state)
    y = rms_norm(y, p["ln_x"], ctx["cfg"].norm_eps) * F.silu(g)
    return y @ p["wo"].to(x.dtype), x[:, -1:], s_new


def rwkv_channel_key(p, xk):
    """The channel mix's key relu(xk @ wck)^2 over ``p``'s ``d_ff``
    columns."""
    return torch.square(torch.relu(xk @ p["wck"].to(xk.dtype)))


def rwkv_channel_mix(p, x, x_prev=None, value=None):
    """Returns (out, last row of x).  ``value(xk)`` computes the key's
    product with ``wcv`` in place of ``p``'s (``models.tp``'s sum over
    shards)."""
    xs = _shift(x, x_prev)
    xk = x + p["mu_ck"].to(x.dtype) * (xs - x)
    r = torch.sigmoid(xk @ p["wcr"].to(x.dtype))
    kv = rwkv_channel_key(p, xk) @ p["wcv"].to(x.dtype) if value is None \
        else value(xk)
    return r * kv, x[:, -1:]


def rwkv_apply(p, x, ctx):
    cfg = ctx["cfg"]
    tm, _, _ = rwkv_time_mix(p, rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
    h = x + tm
    cm, _ = rwkv_channel_mix(p, rms_norm(h, p["ln2"], cfg.norm_eps))
    return h + cm


def rwkv_cache(cfg, batch, smax, kv_dtype, device):
    h, n, d = cfg.n_heads, cfg.hd, cfg.d_model
    return {"s": torch.zeros((batch, h, n, n), dtype=torch.float32,
                             device=device),
            "x_tm": torch.zeros((batch, 1, d), dtype=torch.bfloat16,
                                device=device),
            "x_cm": torch.zeros((batch, 1, d), dtype=torch.bfloat16,
                                device=device)}


def rwkv_decode(p, x, cache, ctx):
    cfg = ctx["cfg"]
    active = ctx.get("active")
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    tm, last_x, s_new = rwkv_time_mix(
        p, xn, ctx, x_prev=cache["x_tm"].to(xn.dtype), state=cache["s"])
    h = x + tm
    hn = rms_norm(h, p["ln2"], cfg.norm_eps)
    cm, last_cm = rwkv_channel_mix(p, hn,
                                   x_prev=cache["x_cm"].to(hn.dtype))
    _write_rows(cache["s"], s_new, active)
    _write_rows(cache["x_tm"], last_x, active)
    _write_rows(cache["x_cm"], last_cm, active)
    return h + cm


# --------------------------------------------------------------------- mamba

def mamba_defs(cfg):
    d = cfg.d_model
    ssm = cfg.ssm
    di = ssm.expand * d
    h = di // ssm.head_dim
    n = ssm.state_size
    conv_dim = di + 2 * n
    return {
        "ln": ParamDef((d,), ("embed",), "ones"),
        "in_proj": ParamDef((d, 2 * di + 2 * n + h), ("embed", "qkv")),
        "conv_w": ParamDef((ssm.conv_kernel, conv_dim), (None, "qkv")),
        "dt_bias": ParamDef((h,), (None,), "zeros"),
        "a_log": ParamDef((h,), (None,), "zeros"),
        "d_skip": ParamDef((h,), (None,), "zeros"),
        "norm": ParamDef((di,), ("qkv",), "ones"),
        "out_proj": ParamDef((di, d), ("qkv", "embed")),
    }


def _mamba_split(cfg, zxbcdt):
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    h = di // ssm.head_dim
    n = ssm.state_size
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)
    return z, xbc, dt, di, h, n


def _mamba_ssm_inputs(p, dt):
    """softplus dt (f32) and A = -exp(a_log) (f32)."""
    dt_full = F.softplus(dt.float() + p["dt_bias"].float())
    return dt_full, -torch.exp(p["a_log"].float())


def conv_step(conv, new, w):
    """One step of a causal depthwise conv: (its window [B,K,C], ``conv``
    [B,K-1,C] with ``new`` [B,1,C] appended, and silu of the window's
    product with ``w`` [K,C])."""
    window = torch.cat([conv.to(new.dtype), new], dim=1)
    return window, F.silu(torch.einsum("bkc,kc->bc", window,
                                       w.to(new.dtype)))


def mamba_heads_step(p, xs, dt, bm, c, state, head_dim):
    """The SSM's decode step over ``p``'s heads (a shard's under
    ``models.tp``): ``xs`` [B,H*P], ``dt`` [B,H].  Returns (y [B,1,H*P]
    before the gated norm, new state)."""
    b = xs.shape[0]
    dt_full, a = _mamba_ssm_inputs(p, dt)
    y, h_new = mamba2_decode_step(xs.reshape(b, -1, head_dim), dt_full, a,
                                  bm, c, p["d_skip"].float(), state)
    return y.reshape(b, 1, -1), h_new


def _mamba_out(p, x, y, z, cfg):
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return x + y @ p["out_proj"].to(x.dtype)


def mamba_apply(p, x, ctx):
    cfg = ctx["cfg"]
    ssm = cfg.ssm
    b, s, _ = x.shape
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt, di, h, n = _mamba_split(cfg, xn @ p["in_proj"].to(x.dtype))
    # causal depthwise conv over (x, B, C)
    k = ssm.conv_kernel
    xbc_pad = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(xbc_pad[:, i:i + s] * p["conv_w"][i].to(x.dtype)
               for i in range(k))
    xs, bm, c = torch.split(F.silu(conv), [di, n, n], dim=-1)
    dt_full, a = _mamba_ssm_inputs(p, dt)
    xh = xs.reshape(b, s, h, ssm.head_dim).transpose(1, 2)
    y, _ = mamba2(xh, dt_full.transpose(1, 2), a, bm, c,
                  p["d_skip"].float(), impl=ctx.get("impl", "auto"))
    return _mamba_out(p, x, y.transpose(1, 2).reshape(b, s, di), z, cfg)


def mamba_cache(cfg, batch, smax, kv_dtype, device):
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    h = di // ssm.head_dim
    n = ssm.state_size
    return {"conv": torch.zeros((batch, ssm.conv_kernel - 1, di + 2 * n),
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros((batch, h, ssm.head_dim, n),
                             dtype=torch.float32, device=device)}


def mamba_decode(p, x, cache, ctx):
    cfg = ctx["cfg"]
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt, di, h, n = _mamba_split(cfg, xn @ p["in_proj"].to(x.dtype))
    window, act = conv_step(cache["conv"], xbc, p["conv_w"])
    xs, bm, c = torch.split(act, [di, n, n], dim=-1)
    y, h_new = mamba_heads_step(p, xs, dt[:, 0], bm, c, cache["h"],
                                cfg.ssm.head_dim)
    _write_rows(cache["conv"], window[:, 1:], ctx.get("active"))
    _write_rows(cache["h"], h_new, ctx.get("active"))
    return _mamba_out(p, x, y, z, cfg)


# ------------------------------------------------------------- whisper enc/dec

def enc_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {"ln1": ParamDef((d,), ("embed",), "ones"),
            "ln2": ParamDef((d,), ("embed",), "ones"),
            **_attn_defs(cfg),
            "w_in": ParamDef((d, f), ("embed", "mlp")),
            "w_out": ParamDef((f, d), ("mlp", "embed"))}


def _plain_mlp(p, x):
    """GELU MLP; the tanh form, ``jax.nn.gelu``'s default."""
    hdn = F.gelu(x @ p["w_in"].to(x.dtype), approximate="tanh")
    return hdn @ p["w_out"].to(x.dtype)


def enc_apply(p, x, ctx):
    cfg = ctx["cfg"]
    h = x + _self_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps), ctx,
                            causal=False)
    return h + _plain_mlp(p, rms_norm(h, p["ln2"], cfg.norm_eps))


def dec_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {"ln1": ParamDef((d,), ("embed",), "ones"),
            "ln_c": ParamDef((d,), ("embed",), "ones"),
            "ln2": ParamDef((d,), ("embed",), "ones"),
            **_attn_defs(cfg), **_attn_defs(cfg, cross=True),
            "w_in": ParamDef((d, f), ("embed", "mlp")),
            "w_out": ParamDef((f, d), ("mlp", "embed"))}


def cross_kv(cfg, p, enc_out):
    """The cross K/V of one ``dec`` layer from the encoder's output [B,Se,D]:
    (k, v) [B,Se,KH,hd]."""
    b = enc_out.shape[0]
    k = (enc_out @ p["cwk"].to(enc_out.dtype)).reshape(
        b, -1, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["cwv"].to(enc_out.dtype)).reshape(
        b, -1, cfg.n_kv_heads, cfg.hd)
    return k, v


def _cross_attention(cfg, p, x, enc_out, impl="auto"):
    b, s, _ = x.shape
    q = (x @ p["cwq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.hd)
    k, v = cross_kv(cfg, p, enc_out.to(x.dtype))
    out = flash_attention(q, k, v, causal=False, impl=impl)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["cwo"].to(x.dtype)


def dec_apply(p, x, ctx):
    cfg = ctx["cfg"]
    h = x + _self_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps), ctx)
    h = h + _cross_attention(cfg, p, rms_norm(h, p["ln_c"], cfg.norm_eps),
                             ctx["enc_out"], ctx.get("impl", "auto"))
    return h + _plain_mlp(p, rms_norm(h, p["ln2"], cfg.norm_eps))


def dec_cache(cfg, batch, smax, kv_dtype, device):
    """Self-attention K/V, and the cross K/V ``ck``/``cv`` [B,enc_seq,KH,hd]
    bf16, zeros until the caller writes the encoder's (``cross_kv``)."""
    c = attn_cache(cfg, batch, smax, kv_dtype, device)
    for name in ("ck", "cv"):
        c[name] = torch.zeros((batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd),
                              dtype=torch.bfloat16, device=device)
    return c


def dec_decode(p, x, cache, ctx):
    cfg = ctx["cfg"]
    h = x + _decode_attention(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps),
                              cache, ctx)
    # cross-attention against the precomputed encoder K/V: every row sees
    # all enc_seq frames (the reference's position enc_seq - 1)
    xq = rms_norm(h, p["ln_c"], cfg.norm_eps)
    b = x.shape[0]
    qc = (xq @ p["cwq"].to(x.dtype)).reshape(b, 1, cfg.n_heads, cfg.hd)
    last = torch.full((b,), cache["ck"].shape[1] - 1, dtype=torch.long,
                      device=x.device)
    co = decode_attention(qc, cache["ck"], cache["cv"], last,
                          impl=ctx.get("impl", "auto"))
    h = h + co.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["cwo"].to(x.dtype)
    return h + _plain_mlp(p, rms_norm(h, p["ln2"], cfg.norm_eps))


BLOCKS: Dict[str, Dict[str, Any]] = {
    "attn": dict(defs=attn_defs, apply=attn_apply, decode=attn_decode,
                 cache=attn_cache, f32=()),
    "local": dict(defs=attn_defs, apply=local_apply, decode=local_decode,
                  cache=local_cache, f32=()),
    "moe": dict(defs=moe_defs, apply=moe_apply, decode=moe_decode,
                cache=attn_cache, f32=()),
    "rwkv": dict(defs=rwkv_defs, apply=rwkv_apply, decode=rwkv_decode,
                 cache=rwkv_cache, f32=("u", "w0")),
    "mamba": dict(defs=mamba_defs, apply=mamba_apply, decode=mamba_decode,
                  cache=mamba_cache, f32=("dt_bias", "a_log", "d_skip")),
    # zamba2's shared block is an attention block; lm keeps one unstacked
    # weight copy for all its occurrences and a KV cache per occurrence
    "shared_attn": dict(defs=attn_defs, apply=attn_apply, decode=attn_decode,
                        cache=attn_cache, f32=()),
    # whisper: the encoder runs once over the frames (``lm.encode``)
    "enc": dict(defs=enc_defs, apply=enc_apply, decode=None, cache=None,
                f32=()),
    "dec": dict(defs=dec_defs, apply=dec_apply, decode=dec_decode,
                cache=dec_cache, f32=()),
}
