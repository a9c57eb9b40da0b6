"""Dispatcher for fused MoE gating: the CUDA kernel for a tensor on the
card, the plain torch version for a tensor on the CPU."""
from __future__ import annotations

from repro_torch.kernels import resolve
from repro_torch.kernels.moe_gating.moe_gating import gating_cuda
from repro_torch.kernels.moe_gating.ref import gating_ref


def gating(logits, k: int, impl: str = "auto"):
    """logits [G,T,E] -> (weights [G,T,k] f32, experts [G,T,k] i32,
    counts [G,E] i32)."""
    if resolve(impl, logits) == "torch":
        return gating_ref(logits, k)
    return gating_cuda(logits.float(), k)
