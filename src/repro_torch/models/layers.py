"""Shared neural layers: RMSNorm, RoPE, gated MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, gamma, eps=1e-6):
    """The variance in f32, the multiply in x's dtype (as the reference)."""
    var = x.float().square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    return out * gamma.to(x.dtype)


def _rope_angles(positions, head_dim, theta):
    """positions [..., S] -> (cos, sin) [..., S, head_dim/2]."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta=10000.0):
    """x [B,S,H,hd]; positions [B,S] (int).  Rotate-half convention, f32."""
    hd = x.shape[-1]
    cos, sin = _rope_angles(positions, hd, theta)    # [B,S,hd/2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """Gated MLP: silu(x@Wg) * (x@Wu) @ Wd."""
    g = F.silu(x @ w_gate.to(x.dtype))
    u = x @ w_up.to(x.dtype)
    return (g * u) @ w_down.to(x.dtype)
