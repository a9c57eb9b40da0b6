"""Plain float32 pieces of a decoder: RMSNorm, rotary embedding,
causal grouped-query attention, a SwiGLU feed-forward, and the matrix
products of the reference and of its lower-precision control."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def f32_mm(x, w):
    """The reference's product: float32 operands, float32 accumulation
    (TF32 is off: ``check`` turns it off before a reference runs)."""
    return x.float() @ w.float()


def _fp8(x, dim: int):
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the largest magnitude maps to e4m3's largest, 448), back in
    float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def fp8_mm(x, w):
    """The control's product, the step below the configuration's bfloat16:
    both operands in float8 e4m3 (activations scaled per row, weights per
    output column), products summed in float32."""
    return _fp8(x.float(), -1) @ _fp8(w.float(), -2)


def rms_norm(x, g, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x, theta: float):
    """Rotary embedding of x [S, heads, hd] at positions 0..S-1, in the
    rotate-half form: the pair (i, i + hd/2) turns by pos * theta^(-2i/hd)."""
    s, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, w, cfg, mm, block: int = 1024):
    """Causal grouped-query self-attention of h [S, D] (already normed):
    ``num_attention_heads`` query heads share ``num_key_value_heads`` key
    and value heads; softmax over each query's earlier positions in
    float32, queries in blocks of ``block`` so the scores fit."""
    s = h.shape[0]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // nh
    theta = float(cfg["rope_theta"])
    q = rope(mm(h, w["wq"]).reshape(s, nh, hd), theta)
    k = rope(mm(h, w["wk"]).reshape(s, nkv, hd), theta)
    v = mm(h, w["wv"]).reshape(s, nkv, hd)
    rep = nh // nkv
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # [nh, S, hd]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty((s, nh, hd), dtype=torch.float32, device=h.device)
    for a in range(0, s, block):
        b = min(a + block, s)
        qb = q[a:b].transpose(0, 1) * hd ** -0.5             # [nh, B, hd]
        sc = qb @ k[:, :b].transpose(1, 2)                    # [nh, B, b]
        mask = torch.arange(b, device=h.device)[None] > \
            torch.arange(a, b, device=h.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[a:b] = (torch.softmax(sc, -1) @ v[:, :b]).transpose(0, 1)
    return mm(out.reshape(s, nh * hd), w["wo"])


def swiglu(h, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(h, w_gate)) * mm(h, w_up), w_down)
