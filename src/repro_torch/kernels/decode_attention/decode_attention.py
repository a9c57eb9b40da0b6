"""Launch wrapper for the CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

It replaces no TPU kernel (the reference's ``decode_attention`` is plain
jnp); it takes the place of the plain version's repeat of K and V to every
query head and f32 copy of the whole cache.  One call is two launches: the
split-KV kernel, one block a (split of ``CHUNK`` keys, KV head, row), each
reading only its row's visible keys in the cache's own dtype, and the
merge of a row's splits; it counts once in ``LAUNCHES["decode_attn"]``.
``CHUNK`` is fixed, so a row's output does not depend on the batch height
or the cache's length.  The wrapper validates its inputs, allocates the
output and the f32 scratch of the splits' partial sums, launches on the
current stream and raises on a refused launch.  It never falls back to the
plain version.  It copies nothing but ``pos`` where that is a strided
view (a few bytes); q and the caches must be contiguous.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, lib

CHUNK = 256          # keys a split (a multiple of 64)
MAX_HEAD_DIM = 256
# the cache dtypes the kernel reads, by the launch's code
KV_DTYPES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}


@functools.lru_cache(maxsize=None)
def _fn():
    f = lib("decode_attention").decode_attn_launch
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def scratch_floats(b: int, h: int, smax: int, hd: int) -> int:
    """The f32 scratch a call needs: each split's acc [hd] and (m, l) per
    (row, head)."""
    return b * h * -(-smax // CHUNK) * (hd + 2)


def _aligned(x) -> bool:
    return x.is_contiguous() and x.data_ptr() % 16 == 0


def _check(q, k, v, pos, window):
    if not q.is_cuda or q.dim() != 4 or q.dtype != torch.bfloat16 or \
            q.shape[1] != 1:
        raise ValueError(f"q must be a [B,1,H,hd] bfloat16 CUDA tensor, got "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    b, _, h, hd = q.shape
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"hd must be a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"got {hd}")
    if k.dtype not in KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"the caches must share one of {list(KV_DTYPES)}, "
                         f"got {k.dtype} and {v.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dim() != 4 or x.shape[0] != b or \
                x.shape[1] < 1 or x.shape[3] != hd or \
                x.shape != k.shape or h % x.shape[2]:
            raise ValueError(f"{name} must be [{b},Smax,KH,{hd}] with KH "
                             f"dividing {h}, beside the other cache, on "
                             f"{q.device}, got {tuple(x.shape)}")
    if pos.device != q.device or pos.dtype != torch.int64 or \
            pos.shape != (b,):
        raise ValueError(f"pos must be [{b}] int64 on {q.device}, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if not all(_aligned(x) for x in (q, k, v)):
        raise ValueError("q, k and v must be contiguous and 16-byte "
                         "aligned")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def decode_attn_cuda(q, k_cache, v_cache, pos, window: Optional[int] = None,
                     rolling: bool = False):
    """q [B,1,H,hd] bf16; caches [B,Smax,KH,hd] bf16 or fp8; pos [B] int64
    -> [B,1,H,hd] bf16, as ``models.attention.decode_attention``."""
    _check(q, k_cache, v_cache, pos, window)
    pos = pos.contiguous()       # [B] (a caller may pass one expanded)
    b, _, h, hd = q.shape
    smax, kh = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    part = torch.empty(scratch_floats(b, h, smax, hd), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos.data_ptr(), o.data_ptr(), part.data_ptr(), b, h, kh,
                smax, hd, 0 if window is None else int(window), int(rolling),
                CHUNK, KV_DTYPES[k_cache.dtype], hd ** -0.5, stream)
    check(err, "decode_attn launch")
    LAUNCHES["decode_attn"] += 1
    return o
