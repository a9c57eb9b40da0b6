"""Launch wrapper for the CUDA Mamba2 SSD scan (``csrc/mamba2_ssd.cu``).

Replaces ``mamba2_pallas`` (src/repro/kernels/mamba2_ssd/mamba2_ssd.py:52).
The wrapper validates its inputs, allocates the outputs (and, for bf16, the
scratch of the chunked passes: each chunk's state and decay in f32, and
the state entering it as two bf16 pieces), launches on the current stream
and raises on a refused launch; it never falls back to the plain
version.  bf16 runs the chunked tensor-core passes, f32 the
sequential FMA kernel.  x, dt, B and C may be strided views (the model
hands over ``[B,T,H,P]`` activations transposed, and B and C as column
slices of one tensor) as long as their last dim is contiguous.  y takes
x's strides where x is dense; for a non-dense x, such as the model's
column slice, it is dense in the dimension order of x's strides
(``[B,T,H,P]`` there), so the caller's transpose back is free.

``mamba2_bwd_cuda`` wraps the backward (``csrc/mamba2_ssd_bwd.cu``): for
bf16 the chunked form on the tensor cores at the forward's chunk
(``CHUNK``), all chunks in parallel, the boundary states recomputed by the
forward's passes; for f32 the exact reverse recurrence on the CUDA cores,
the states recomputed from checkpoints every ``BWD_CHUNK`` tokens.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (16, 32, 64, 128)
MAX_HEAD_DIM = 1024
CHUNK = 64                # tokens per chunk of the bf16 route (the kernel's Q)
# the backward's head dims and state sizes (the f32 route's threads keep a
# row or a column of the state in registers; the bf16 route's blocks take
# 64 head channels), and the tokens between the f32 route's checkpoints
# (the kernel's L; the library reports it and the bf16 route's CHUNK)
BWD_SIZES = (16, 32, 64)
BWD_CHUNK = 32


@functools.lru_cache(maxsize=None)
def _fn():
    so = lib("mamba2_ssd")
    # the scratch below is sized with CHUNK; the library reports its Q
    if so.mamba2_ssd_chunk() != CHUNK:
        raise RuntimeError(f"libmamba2_ssd chunks {so.mamba2_ssd_chunk()} "
                           f"tokens, the wrapper sizes scratch for {CHUNK}")
    f = so.mamba2_ssd_launch
    f.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + \
        [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _unit_last(x):
    return x if x.stride(-1) == 1 else x.contiguous()


def mamba2_cuda(x, dt, a, bm, c, d, h0=None):
    """x [B,H,T,P] (f32 or bf16) on a CUDA device; dt [B,H,T]; a, d [H];
    bm, c [B,T,N] in x's dtype; h0 [B,H,P,N] or None.  Returns (y [B,H,T,P]
    in x's dtype, hT [B,H,P,N] f32)."""
    if not x.is_cuda or x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("x must be a [B,H,T,P] float32/bfloat16 CUDA "
                         "tensor")
    b, h, t, p = x.shape
    n = bm.shape[-1]
    if n not in STATE_SIZES or not 1 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"state size {n} not in {STATE_SIZES} or head dim "
                         f"{p} not in [1, {MAX_HEAD_DIM}]")
    dev = x.device
    for name, z in (("bm", bm), ("c", c)):
        if z.device != dev or tuple(z.shape) != (b, t, n) or \
                z.dtype != x.dtype:
            raise ValueError(f"{name} must be [{b},{t},{n}] {x.dtype} on "
                             f"{dev}")
    if dt.device != dev or tuple(dt.shape) != (b, h, t):
        raise ValueError(f"dt must be [{b},{h},{t}] on {dev}")
    x, bm, c = _unit_last(x), _unit_last(bm), _unit_last(c)
    if bm.stride() != c.stride():
        bm, c = bm.contiguous(), c.contiguous()
    dt = dt.to(torch.float32)
    a, d = (z.to(device=dev, dtype=torch.float32).contiguous()
            for z in (a, d))
    if tuple(a.shape) != (h,) or tuple(d.shape) != (h,):
        raise ValueError(f"a and d must be [{h}]")
    if h0 is not None:
        h0 = h0.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(h0.shape) != (b, h, p, n):
            raise ValueError(f"h0 must be [{b},{h},{p},{n}], got "
                             f"{tuple(h0.shape)}")
    y = torch.empty_like(x)   # x's strides if dense, else its dim order
    h_t = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    nc = -(-t // CHUNK) if x.dtype == torch.bfloat16 else 0
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32, device=dev)
    decays = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
    entering = torch.empty((b, h, nc, 2, p, n), dtype=torch.bfloat16,
                           device=dev)
    strides = (ctypes.c_longlong * 11)(*x.stride()[:3], *dt.stride(),
                                       *bm.stride()[:2], *y.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                c.data_ptr(), d.data_ptr(),
                0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                h_t.data_ptr(), states.data_ptr(), decays.data_ptr(),
                entering.data_ptr(), b, h, t, p, n, _DTYPES[x.dtype],
                strides, stream)
    check(err, "mamba2_ssd launch")
    LAUNCHES["mamba2_ssd"] += 1
    return y, h_t


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    so = lib("mamba2_ssd_bwd")
    chunks = (so.mamba2_ssd_bwd_chunk(), so.mamba2_ssd_bwd_bf16_chunk())
    if chunks != (BWD_CHUNK, CHUNK):
        raise RuntimeError(f"libmamba2_ssd_bwd chunks {chunks} tokens, the "
                           f"wrapper sizes scratch for {(BWD_CHUNK, CHUNK)}")
    f = so.mamba2_ssd_bwd_launch
    f.argtypes = [ctypes.c_void_p] * 16 + \
        [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 6 + \
        [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def bwd_scratch(b, h, t, p, n, dtype=torch.bfloat16):
    """The backward's f32 scratch shapes, in the launch's order.  bf16: each
    chunk's state from zero, then the state entering it (as two bf16
    pieces), its local adjoint, then the adjoint at its end (the same), and
    its decay; f32: the state at every checkpoint and one chunk's
    recomputed states per (b, h) in two layouts.  Then the per-(b, h)
    partials of dB and dC, and those of dA and dD (per chunk in bf16)."""
    if dtype == torch.bfloat16:
        nc = -(-t // CHUNK)
        route = {"states": (b * h, nc, p, n), "adjoints": (b * h, nc, p, n),
                 "decays": (b * h, nc)}
        heads = (b * h, nc)
    else:
        route = {"ckpt": (b * h, -(-t // BWD_CHUNK), n, p),
                 "states_a": (b * h, BWD_CHUNK, n, p),
                 "states_b": (b * h, BWD_CHUNK, p, n)}
        heads = (b * h,)
    return {**route, "db_part": (b * h, t, n), "dc_part": (b * h, t, n),
            "da_part": heads, "dd_part": heads}


def mamba2_bwd_cuda(x, dt, a, bm, c, d, dy, h0=None, dh_t=None):
    """The scan's backward on the card (``ref.mamba2_bwd_ref`` is its plain
    version).  x, dt, a, bm, c, d as ``mamba2_cuda`` takes them; dy
    [B,H,T,P] in x's dtype (any strides with P contiguous); h0, dh_t
    [B,H,P,N] or None.  Returns (dx in x's dtype and layout, ddt f32 in
    dt's layout, da [H] f32, dbm and dc [B,T,N] in x's dtype, dd [H] f32,
    dh0 [B,H,P,N] f32, or None without h0)."""
    if not x.is_cuda or x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError("x must be a [B,H,T,P] float32/bfloat16 CUDA "
                         "tensor")
    b, h, t, p = x.shape
    n = bm.shape[-1]
    if n not in BWD_SIZES or p not in BWD_SIZES:
        raise ValueError(f"state size {n} or head dim {p} not in "
                         f"{BWD_SIZES}")
    dev = x.device
    for name, z in (("bm", bm), ("c", c)):
        if z.device != dev or tuple(z.shape) != (b, t, n) or \
                z.dtype != x.dtype:
            raise ValueError(f"{name} must be [{b},{t},{n}] {x.dtype} on "
                             f"{dev}")
    if dt.device != dev or tuple(dt.shape) != (b, h, t):
        raise ValueError(f"dt must be [{b},{h},{t}] on {dev}")
    if dy.device != dev or dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: {tuple(x.shape)} {x.dtype}")
    x, bm, c, dy = _unit_last(x), _unit_last(bm), _unit_last(c), \
        _unit_last(dy)
    if bm.stride() != c.stride():
        bm, c = bm.contiguous(), c.contiguous()
    dt = dt.to(torch.float32)
    a, d = (z.to(device=dev, dtype=torch.float32).contiguous()
            for z in (a, d))
    if tuple(a.shape) != (h,) or tuple(d.shape) != (h,):
        raise ValueError(f"a and d must be [{h}]")
    state = []
    for name, z in (("h0", h0), ("dh_t", dh_t)):
        if z is not None:
            z = z.to(device=dev, dtype=torch.float32).contiguous()
            if tuple(z.shape) != (b, h, p, n):
                raise ValueError(f"{name} must be [{b},{h},{p},{n}], got "
                                 f"{tuple(z.shape)}")
        state.append(z)
    h0, dh_t = state
    dx = torch.empty_like(x)          # x's strides if dense, else its order
    ddt = torch.empty_like(dt)
    dbm = torch.empty((b, t, n), dtype=x.dtype, device=dev)
    dc = torch.empty_like(dbm)
    da, dd = (torch.empty((h,), dtype=torch.float32, device=dev)
              for _ in range(2))
    dh0 = None if h0 is None else torch.empty((b, h, p, n),
                                               dtype=torch.float32,
                                               device=dev)
    scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in bwd_scratch(b, h, t, p, n, x.dtype).values()]

    def ptr(z):
        return 0 if z is None else z.data_ptr()

    strides = (ctypes.c_longlong * 17)(
        *x.stride()[:3], *dt.stride(), *bm.stride()[:2], *dy.stride()[:3],
        *dx.stride()[:3], *ddt.stride())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                    bm.data_ptr(), c.data_ptr(), d.data_ptr(), dy.data_ptr(),
                    ptr(h0), ptr(dh_t), dx.data_ptr(), ddt.data_ptr(),
                    da.data_ptr(), dbm.data_ptr(), dc.data_ptr(),
                    dd.data_ptr(), ptr(dh0),
                    (ctypes.c_void_p * len(scratch))(
                        *(z.data_ptr() for z in scratch)),
                    b, h, t, p, n, _DTYPES[x.dtype], strides, stream)
    check(err, "mamba2_ssd_bwd launch")
    LAUNCHES["mamba2_ssd_bwd"] += 1
    return dx, ddt, da, dbm, dc, dd, dh0
