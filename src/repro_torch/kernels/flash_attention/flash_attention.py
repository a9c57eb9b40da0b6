"""Launch wrappers for the CUDA flash-attention kernels
(``csrc/flash_attention.cu``) and the autograd Function over them.

``flash_fwd_cuda`` replaces ``flash_attention_pallas``
(src/repro/kernels/flash_attention/flash_attention.py:58) and also returns
each row's log-sum-exp; ``flash_bwd_cuda`` is its backward (the reference
differentiates its jnp form instead).  The wrappers validate, allocate
outputs and scratch, launch on the current stream and raise on a refused
launch; they never fall back to a plain version.  Tensors are in the
model's layout, q [B,Sq,H,hd] and k, v [B,Sk,H,hd], with the KV heads
already repeated.  bf16 runs on the tensor cores and takes hd a multiple
of 8 up to 128; f32 runs on the CUDA cores and takes any hd up to 128.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


@functools.lru_cache(maxsize=None)
def _fns():
    so = lib("flash_attention")
    f, b = so.flash_fwd_launch, so.flash_bwd_launch
    shape = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
    f.argtypes = [ctypes.c_void_p] * 5 + shape
    b.argtypes = [ctypes.c_void_p] * 11 + shape
    f.restype = b.restype = ctypes.c_int
    return f, b


def _shape_args(q, k, causal, window, q_offset):
    b, sq, h, hd = q.shape
    return (b, h, sq, k.shape[1], hd, int(causal),
            0 if window is None else int(window), int(q_offset),
            hd ** -0.5, _DTYPES[q.dtype])


def _check(q, k, v):
    if not q.is_cuda or q.dim() != 4 or q.dtype not in _DTYPES:
        raise ValueError("q must be a [B,Sq,H,hd] float32/bfloat16 CUDA "
                         "tensor")
    b, sq, h, hd = q.shape
    if not 1 <= hd <= MAX_HEAD_DIM or sq < 1:
        raise ValueError(f"need 1 <= hd <= {MAX_HEAD_DIM} and Sq >= 1, got "
                         f"{tuple(q.shape)}")
    if q.dtype == torch.bfloat16 and hd % 8:
        raise ValueError(f"the bf16 kernels need hd % 8 == 0, got hd {hd}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.dim() != 4 or \
                (x.shape[0], x.shape[2], x.shape[3]) != (b, h, hd) or \
                x.shape[1] < 1:
            raise ValueError(f"{name} must be [{b},Sk>=1,{h},{hd}] {q.dtype} "
                             f"on {q.device}, got {tuple(x.shape)} "
                             f"{x.dtype}")
    if k.shape[1] != v.shape[1]:
        raise ValueError("k and v must have the same length")


def _dense(x):
    """Contiguous, and 16-byte aligned (the bf16 kernels copy 16-byte
    chunks)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_fwd_cuda(q, k, v, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0):
    """-> (o [B,Sq,H,hd] in q's dtype, lse [B,H,Sq] f32)."""
    _check(q, k, v)
    q, k, v = (_dense(x) for x in (q, k, v))
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fns()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(),
                    *_shape_args(q, k, causal, window, q_offset), stream)
    check(err, "flash_fwd launch")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0):
    """The forward's inputs, its o and lse, and dO -> (dq, dk, dv) in the
    inputs' dtype.  One launch of the C entry point runs three kernels
    (delta and the scaled q, dK/dV, dQ); it counts once."""
    _check(q, k, v)
    q, k, v, o, do = (_dense(x) for x in (q, k, v, o, do.to(q.dtype)))
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or \
            lse.dtype != torch.float32:
        raise ValueError("o and dO must be shaped like q, lse [B,H,Sq] f32")
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    # the scaled q, the bf16 products' operand (the f32 kernels scale q as
    # they load it)
    qs = torch.empty_like(q) if q.dtype == torch.bfloat16 else None
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fns()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    None if qs is None else qs.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    *_shape_args(q, k, causal, window, q_offset), stream)
    check(err, "flash_bwd launch")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention through the forward kernel, differentiated by the backward
    kernel.  q [B,Sq,H,hd], k, v [B,Sk,H,hd] (KV heads repeated by the
    caller, so autograd sums dk and dv over the repeats)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_fwd_cuda(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, do, *ctx.mask)
        return dq, dk, dv, None, None, None
