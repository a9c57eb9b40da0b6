"""Per-block-type parameter definitions and apply functions for the block
types the port runs so far: ``attn`` (full-attention decoder block),
``moe`` (attention + MoE-FFN decoder block), ``rwkv`` (RWKV6 time mix +
channel mix), ``mamba`` (Mamba2 SSD block) and ``shared_attn`` (zamba2's
attention block, one weight copy shared by every occurrence).

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
one K/V row per batch row at that row's position; the recurrent blocks
overwrite their state rows, which cannot be rewound, so an inactive row
must keep its state untouched.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba2_ssd.ops import mamba2, mamba2_decode_step
from repro_torch.kernels.rwkv6_scan.ops import rwkv6, rwkv6_decode_step
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_rope, rms_norm, swiglu
from repro_torch.models.params import ParamDef

LORA_DIM = 64


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


def rwkv_time_mix(p, x, ctx, x_prev=None, state=None):
    """x [B,S,D].  Returns (out, last row of x, new WKV state).  A one-token
    call with a state is a decode step; anything else runs the scan (the
    kernel on the card)."""
    cfg = ctx["cfg"]
    b, s, d = x.shape
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
    y = y.transpose(1, 2).reshape(b, s, d)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * F.silu(g)
    return y @ p["wo"].to(x.dtype), x[:, -1:], s_new


def rwkv_channel_mix(p, x, x_prev=None):
    xs = _shift(x, x_prev)
    xk = x + p["mu_ck"].to(x.dtype) * (xs - x)
    r = torch.sigmoid(xk @ p["wcr"].to(x.dtype))
    k = torch.square(torch.relu(xk @ p["wck"].to(x.dtype)))
    return r * (k @ p["wcv"].to(x.dtype)), x[:, -1:]


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
    ssm = cfg.ssm
    b = x.shape[0]
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt, di, h, n = _mamba_split(cfg, xn @ p["in_proj"].to(x.dtype))
    window = torch.cat([cache["conv"].to(x.dtype), xbc], dim=1)  # [B,K,C]
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(x.dtype))
    xs, bm, c = torch.split(F.silu(conv), [di, n, n], dim=-1)
    dt_full, a = _mamba_ssm_inputs(p, dt[:, 0])
    y, h_new = mamba2_decode_step(xs.reshape(b, h, ssm.head_dim), dt_full,
                                  a, bm, c, p["d_skip"].float(), cache["h"])
    _write_rows(cache["conv"], window[:, 1:], ctx.get("active"))
    _write_rows(cache["h"], h_new, ctx.get("active"))
    return _mamba_out(p, x, y.reshape(b, 1, di), z, cfg)


BLOCKS: Dict[str, Dict[str, Any]] = {
    "attn": dict(defs=attn_defs, apply=attn_apply, decode=attn_decode,
                 cache=attn_cache, f32=()),
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
}
