"""Shared neural layers: RMSNorm, RoPE (and M-RoPE), gated MLP, sinusoidal
positions."""
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


# Qwen2-VL multimodal rotary: the head_dim/2 frequency dims are partitioned
# into 3 sections driven by (t, h, w) position ids respectively.
MROPE_SECTIONS = (2, 3, 3)   # ratios; scaled to head_dim//2 at call time


def mrope_bounds(half: int):
    """The first frequency index of each section after the first.  Python's
    ``round`` (half to even), as the reference: at head dim 16, [2, 5]."""
    total = sum(MROPE_SECTIONS)
    bounds, acc = [], 0
    for s in MROPE_SECTIONS[:-1]:
        acc += round(half * s / total)
        bounds.append(acc)
    return bounds


def apply_mrope(x, positions3, theta=1_000_000.0):
    """x [B,S,H,hd]; positions3 [B,S,3] (t, h, w ids).  Each frequency index
    rotates by the id of its section; rotate-half convention, f32."""
    half = x.shape[-1] // 2
    idx = torch.arange(half, device=x.device)
    sec = sum((idx >= b).long() for b in mrope_bounds(half))
    pos = positions3[..., sec]                        # [B,S,half]
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """Gated MLP: silu(x@Wg) * (x@Wu) @ Wd."""
    g = F.silu(x @ w_gate.to(x.dtype))
    u = x @ w_up.to(x.dtype)
    return (g * u) @ w_down.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None):
    """[seq, dim] f32: sines of the first dim/2 frequencies, then cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / dim))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
