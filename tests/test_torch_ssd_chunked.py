"""The chunked SSD algorithm of the bf16 Mamba2 kernel
(``csrc/mamba2_ssd.cu``), written out in plain torch at the kernel's chunk
length, against the JAX package's chunked form and the port's exact
``mamba2_ref``.

The kernel computes the recurrence ``h <- exp(dt a) h + (dt x) B^T``,
``y = h C + D x`` in three passes over chunks of ``CHUNK`` tokens, all
chunks at once: each chunk's state from a zero start and its total decay
(pass 1), the states entering each chunk by a scan over the chunks (pass 2),
and each chunk's outputs from its entering state and the decay-masked
``C B^T`` (pass 3).  ``ssd_three_pass`` below is that algorithm; with
``split=True`` every f32 operand that meets a bf16 one on the tensor cores
(``x dt exp(la_Q - la)`` in pass 1; ``(C B^T) L dt`` and the entering
state in pass 3) is cut to the two bf16 pieces the kernel multiplies,
``hi = bf16(v)`` and ``lo = bf16(v - hi)``; their sum is exact in f32, so
the emulation differs from the kernel only by the accumulator's rounding.

Tolerances: against ``mamba2_chunked`` those of tests/test_torch_ssm.py
(1e-3 of the output's scale, rtol 1e-2); against ``mamba2_ref`` the scan
gate of the kernel tests (tests/test_torch_kernels.py ``_assert_scan_close``
and chip_smoke.py ``check_scan``): y within one ulp of its dtype (2^-7
relative in bf16, 1e-4 in f32) plus 1e-4 of y's scale, the final state
within 1e-4 of its scale.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.mamba2_ssd import ops as j_mops
from repro_torch.kernels.mamba2_ssd.mamba2_ssd import CHUNK
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ref

_j_mamba2_chunked = jax.jit(j_mops.mamba2_chunked, static_argnums=(7,))


def _split(v):
    """v as the kernel multiplies it: bf16(v) + bf16(v - bf16(v))."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float()


def ssd_three_pass(x, dt, a, bm, c, d, h0=None, q=CHUNK, split=False):
    """The kernel's three passes over chunks of q tokens; shapes as in
    ``mamba2_ref``.  Returns (y [B,H,T,P] in x's dtype, hT [B,H,P,N]
    f32)."""
    b, h, t, p = x.shape
    n = bm.shape[-1]
    f32 = torch.float32
    op = _split if split else (lambda v: v)
    nc = math.ceil(t / q)
    pad = nc * q - t                      # the ragged last chunk: zeros
    xs = torch.nn.functional.pad(x.to(f32), (0, 0, 0, pad)) \
        .reshape(b, h, nc, q, p)
    dts = torch.nn.functional.pad(dt.to(f32), (0, pad)).reshape(b, h, nc, q)
    bs, cs = (torch.nn.functional.pad(z.to(f32), (0, 0, 0, pad))
              .reshape(b, nc, q, n) for z in (bm, c))
    # log decay from the chunk's start, inclusive of each step's own
    la = torch.cumsum(dts * a.to(f32)[None, :, None, None], -1)
    la_q = la[..., -1]
    # pass 1: the chunk's state from zero, and its total decay
    w = dts * torch.exp(la_q[..., None] - la)
    s_c = torch.einsum("bhcqp,bcqn->bhcpn", op(xs * w[..., None]), bs)
    dec = torch.exp(la_q)
    # pass 2: the state entering each chunk
    hcur = torch.zeros((b, h, p, n), dtype=f32) if h0 is None \
        else h0.to(f32)
    h_in = []
    for ci in range(nc):
        h_in.append(hcur)
        hcur = dec[:, :, ci, None, None] * hcur + s_c[:, :, ci]
    h_in = torch.stack(h_in, 2) if nc else s_c
    # pass 3: y = ((C B^T) . L . dt) x + exp(la) (C h_in^T) + D x, the
    # upper triangle's exponent masked to -inf before exp
    cb = torch.einsum("bctn,bcsn->bcts", cs, bs)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    seg = torch.where(tri, la[..., :, None] - la[..., None, :],
                      -torch.inf)
    g = cb[:, None] * torch.exp(seg) * dts[..., None, :]
    y = torch.einsum("bhcts,bhcsp->bhctp", op(g), xs) + \
        torch.exp(la)[..., None] * torch.einsum("bctn,bhcpn->bhctp", cs,
                                                op(h_in))
    y = y + d.to(f32)[None, :, None, None, None] * xs
    y = y.reshape(b, h, nc * q, p)[:, :, :t]
    return y.to(x.dtype), hcur


def _inputs(rng, b, h, t, p, n, with_h0):
    """The model's ranges: softplus dt of a wide normal (up to ~8), A in
    [-2, -0.5], so that |dt a| reaches ~16 a step."""
    x = rng.standard_normal((b, h, t, p))
    dt = np.logaddexp(2.0 * rng.standard_normal((b, h, t)), 0.0)
    a = -rng.uniform(0.5, 2.0, h)
    bm, c = (rng.standard_normal((b, t, n)) for _ in range(2))
    d = rng.standard_normal(h)
    h0 = 0.1 * rng.standard_normal((b, h, p, n)) if with_h0 else None
    return [None if z is None else z.astype(np.float32)
            for z in (x, dt, a, bm, c, d, h0)]


def _assert_scan_gate(y, ry, st, rst):
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-4
    y, ry = y.float(), ry.float()
    dy = (y - ry).abs()
    assert torch.all(dy <= ulp * ry.abs() + 1e-4 * ry.abs().max()), \
        dy.max().item()
    assert (st - rst).abs().max().item() <= 1e-4 * rst.abs().max().item()


@pytest.mark.parametrize("b,h,t,p,n,with_h0", [
    (1, 3, 1024, 64, 64, False), (2, 2, 257, 64, 64, True),
    (1, 2, 1024, 64, 64, True), (1, 2, 40, 16, 128, True)])
def test_three_pass_matches_chunked_reference_and_exact_scan(
        rng, b, h, t, p, n, with_h0):
    args = _inputs(rng, b, h, t, p, n, with_h0)
    tensors = [None if z is None else torch.from_numpy(z) for z in args]
    y, hT = ssd_three_pass(*tensors)
    ry, rhT = mamba2_ref(*tensors)
    _assert_scan_gate(y, ry, hT, rhT)
    # the JAX chunked form needs T to be a multiple of its chunk: 128, or
    # the whole of a ragged T as one chunk
    jy, jhT = _j_mamba2_chunked(*[None if z is None else jnp.asarray(z)
                                  for z in args], 128 if t % 128 == 0 else t)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-3 * scale,
                               rtol=1e-2)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT),
                               atol=1e-3 * scale, rtol=1e-2)


@pytest.mark.parametrize("t,with_h0", [(1024, False), (1024, True),
                                       (1000, True)])
def test_two_piece_split_meets_the_scan_gate(rng, t, with_h0):
    """bf16 x, B and C as the model hands them over, every f32 operand cut
    to two bf16 pieces: y (rounded once to bf16) and the final state still
    meet the gate against the exact f32 recurrence on the same inputs, at
    the zamba2 layer's T (and a T that is not a multiple of the chunk)."""
    x, dt, a, bm, c, d, h0 = (None if z is None else torch.from_numpy(z)
                              for z in _inputs(rng, 1, 4, t, 64, 64,
                                               with_h0))
    x, bm, c = x.bfloat16(), bm.bfloat16(), c.bfloat16()
    y, hT = ssd_three_pass(x, dt, a, bm, c, d, h0, split=True)
    ry, rhT = mamba2_ref(x, dt, a, bm, c, d, h0)
    assert y.dtype == torch.bfloat16
    _assert_scan_gate(y, ry, hT, rhT)


def test_split_keeps_sixteen_bits():
    """hi + lo carries v to about 2^-17 relative (eight bits each, the
    second piece starting where the first one's ulp ends)."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 100
    rel = ((_split(v) - v).abs() / v.abs()).max().item()
    assert rel < 2.0 ** -16
    assert torch.equal(_split(v.bfloat16().float()), v.bfloat16().float())
