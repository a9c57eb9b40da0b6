"""The chunked backward of the bf16 Mamba2 SSD kernels
(``csrc/mamba2_ssd_bwd.cu``), written out in plain torch at the kernels'
chunk length, against ``jax.vjp`` of the JAX package's exact scan
(``mamba2_ref``) and the port's plain backward (``mamba2_bwd_ref``).

The forward is, per (batch, head), ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t
B_t^T``, ``y_t = h_t C_t + D x_t``.  Over chunks of ``CHUNK`` tokens, with
``la`` the cumulative sum of ``dt A`` from the chunk's start (inclusive),
``L[t, s] = exp(la_t - la_s)`` on ``s <= t``, ``h_in`` the state entering
a chunk and ``G_end`` the adjoint of the state at its end, the kernels run
``ssd_chunked_bwd`` below:

(a) each chunk's state from zero and its decay ``exp(la_Q)``, and the
    entering states by a scan over the chunks (the forward's passes 1-2);
(b) each chunk's local adjoint of its entering state,
    ``sum_t exp(la_t) dy_t C_t^T``;
(c) the same scan run backwards from ``dhT``: ``G_end`` of every chunk, and
    ``dh0``;
(d) per chunk, from the [Q,Q] tiles ``C B^T`` and ``dy x^T`` and the
    boundary states:
    ``dx = dt (exp(la_Q - la) B G_end^T + (L . C B^T)^T dy) + D dy``,
    ``dB_h = dt (exp(la_Q - la) x G_end + (L . dy x^T)^T C)``,
    ``dC_h = exp(la) dy h_in + (L . dy x^T . dt_s) B``, and the gradient of
    each step's log decay ``dt_t A`` as the sum of four terms with no
    cancellation between them (the rectangle sum ``R`` below, not a
    cumulative sum of differences);
(e) dB and dC summed over the heads, dA and dD over rows and chunks.

With ``split=True`` every f32 operand that meets a bf16 one on the tensor
cores is cut into the two bf16 pieces the kernels multiply, ``hi =
bf16(v)`` and ``lo = bf16(v - hi)``; the boundary states are stored as
such pieces between the kernels.

Tolerance: ``chip_smoke.py`` ``check_scan_bwd``'s, each gradient
element-wise within one ulp of its dtype (2^-7 relative in bf16, 1e-4 in
f32) plus 1e-4 of the gradient's largest magnitude.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mamba2_ssd.ref import mamba2_ref as j_mamba2_ref
from repro_torch.kernels.mamba2_ssd.mamba2_ssd import CHUNK
from repro_torch.kernels.mamba2_ssd.ref import mamba2_bwd_ref


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(v):
    """v as the kernels multiply it: bf16(v) + bf16(v - bf16(v))."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float()


def ssd_chunked_bwd(x, dt, a, bm, c, d, dy, h0=None, dh_t=None, q=CHUNK,
                    split=False):
    """The kernels' chunked backward; arguments and results as
    ``mamba2_bwd_ref``'s."""
    b, h, t, p = x.shape
    n = bm.shape[-1]
    f32 = torch.float32
    op = _split if split else (lambda v: v)
    nc = -(-t // q)
    pad = nc * q - t                      # the ragged last chunk: zeros

    def cut(z):
        return F.pad(z.to(f32), (0, 0, 0, pad)).reshape(
            *z.shape[:-2], nc, q, z.shape[-1])
    xs, dys = cut(x), cut(dy)                             # [b,h,nc,q,p]
    bs, cs = cut(bm), cut(c)                              # [b,nc,q,n]
    dts = F.pad(dt.to(f32), (0, pad)).reshape(b, h, nc, q)
    af, df = a.to(f32), d.to(f32)
    la = torch.cumsum(dts * af[None, :, None, None], -1)
    la_q = la[..., -1:]                                   # [b,h,nc,1]
    # (a) entering states
    s_c = torch.einsum("bhcqp,bcqn->bhcpn",
                       op(xs * (dts * torch.exp(la_q - la))[..., None]), bs)
    dec = torch.exp(la_q[..., 0])
    hcur = torch.zeros((b, h, p, n), dtype=f32) if h0 is None \
        else h0.to(f32)
    h_in = []
    for ci in range(nc):
        h_in.append(hcur)
        hcur = dec[:, :, ci, None, None] * hcur + s_c[:, :, ci]
    # (b) local adjoints, (c) the end adjoints and dh0
    loc = torch.einsum("bhcqp,bcqn->bhcpn",
                       op(dys * torch.exp(la)[..., None]), cs)
    g = torch.zeros((b, h, p, n), dtype=f32) if dh_t is None \
        else dh_t.to(f32)
    g_end = [None] * nc
    for ci in reversed(range(nc)):
        g_end[ci] = g
        g = dec[:, :, ci, None, None] * g + loc[:, :, ci]
    dh0 = None if h0 is None else g
    if nc == 0:
        z = torch.zeros((h,), dtype=f32)
        return (torch.zeros_like(x), torch.zeros_like(dt, dtype=f32), z,
                torch.zeros_like(bm), torch.zeros_like(c), z, dh0)
    # the kernels keep the boundary states as two bf16 pieces
    h_in = op(torch.stack(h_in, 2))                       # [b,h,nc,p,n]
    g_end = op(torch.stack(g_end, 2))
    # (d) per chunk
    cb = torch.einsum("bctn,bcsn->bcts", cs, bs)[:, None]  # C_t . B_s
    m = torch.einsum("bhctp,bhcsp->bhcts", dys, xs)        # dy_t . x_s
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    lmat = torch.exp(torch.where(tri, la[..., :, None] - la[..., None, :],
                                 -torch.inf))             # [t, s], s <= t
    lt = lmat.transpose(-1, -2)                           # [t, s], s >= t
    e_end = torch.exp(la_q - la)                          # exp(la_Q - la_t)
    bg = torch.einsum("bcqn,bhcpn->bhcqp", bs, g_end)
    dxb = e_end[..., None] * bg + torch.einsum(
        "bhcts,bhcsp->bhctp", op(lt * cb.transpose(-1, -2)), dys)
    dx = dts[..., None] * dxb + df[None, :, None, None, None] * dys
    xg = torch.einsum("bhcqp,bhcpn->bhcqn", xs, g_end)
    db_h = dts[..., None] * (e_end[..., None] * xg + torch.einsum(
        "bhcts,bcsn->bhctn", op(lt * m.transpose(-1, -2)), cs))
    dyh = torch.einsum("bhcqp,bhcpn->bhcqn", dys, h_in)
    w3 = lmat * m * dts[..., None, :]
    dc_h = torch.exp(la)[..., None] * dyh + torch.einsum(
        "bhcts,bcsn->bhctn", op(w3), bs)
    # d(la): dtheta_t = sum_{s>=t} exp(la_s) C_s.(dy_s h_in)
    #   + sum_{s>=t} sum_{r<t} Z[s,r] + exp(la_Q) <G_end, h_in>
    #   + sum_{r<t} exp(la_Q - la_r) dt_r B_r.(x_r G_end)
    yoff = torch.exp(la) * (dyh * cs[:, None]).sum(-1)
    zt = w3 * cb                                          # Z[s, r], r <= s
    u = F.pad(torch.cumsum(zt, -1)[..., :-1], (1, 0))     # sum_{r<t} Z[s,r]
    rect = torch.tril(u).sum(-2)                          # over s >= t
    suffix = torch.flip(torch.cumsum(torch.flip(yoff, [-1]), -1), [-1])
    e_r = e_end * dts * (xg * bs[:, None]).sum(-1)
    prefix = F.pad(torch.cumsum(e_r, -1)[..., :-1], (1, 0))
    gh = (g_end * h_in).sum((-2, -1))[..., None]          # [b,h,nc,1]
    dtheta = suffix + rect + torch.exp(la_q) * gh + prefix
    term1 = (xs * dxb).sum(-1)
    ddt = term1 + af[None, :, None, None] * dtheta
    # (e) the ordered sums
    da = (dts * dtheta).sum((0, 2, 3))
    dd = (dys * xs).sum((0, 2, 3, 4))
    dbm = db_h.sum(1).reshape(b, nc * q, n)[:, :t]
    dcm = dc_h.sum(1).reshape(b, nc * q, n)[:, :t]
    return (dx.reshape(b, h, nc * q, p)[:, :, :t].to(x.dtype),
            ddt.reshape(b, h, nc * q)[:, :, :t], da, dbm.to(bm.dtype),
            dcm.to(c.dtype), dd, dh0)


@functools.partial(jax.jit, static_argnums=(0,))
def _j_vjp(with_h0, ins, cot):
    """jax.vjp of the JAX package's exact scan (h0 omitted without it)."""
    _, vjp = jax.vjp(j_mamba2_ref, *(ins if with_h0 else ins[:6]))
    return vjp(cot)


def _inputs(rng, b, h, t, p, n):
    """The model's ranges (``tests/test_torch_scan_grad.py``
    ``mamba_inputs``): dt a softplus of a wide normal (|dt A| up to ~16 a
    step), A in [-2, -0.5]; h0 and the final-state cotangent drawn too."""
    x = rng.standard_normal((b, h, t, p))
    dt = np.logaddexp(2.0 * rng.standard_normal((b, h, t)), 0.0)
    a = -rng.uniform(0.5, 2.0, h)
    bm, c = (rng.standard_normal((b, t, n)) for _ in range(2))
    d = rng.standard_normal(h)
    h0 = 0.1 * rng.standard_normal((b, h, p, n))
    dy = rng.standard_normal((b, h, t, p))
    dh_t = rng.standard_normal((b, h, p, n))
    return [z.astype(np.float32) for z in (x, dt, a, bm, c, d, h0, dy, dh_t)]


def _gate(got, want):
    """``check_scan_bwd``'s tolerance for one gradient."""
    assert got.dtype == want.dtype and got.shape == want.shape
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-4
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = ulp * w.abs() + 1e-4 * (w.abs().max() if w.numel() else 0.0)
    assert bool((err <= bound).all()), (err.max().item(),
                                        w.abs().max().item())


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("t,p,with_h0,with_dh", [
    (1, 64, False, False), (63, 64, True, False), (64, 32, False, True),
    (65, 64, True, True), (300, 32, True, True)])
def test_chunked_bwd_matches_vjp_and_plain_backward(rng, t, p, with_h0,
                                                    with_dh, split):
    """Every gradient (dx, ddt, dA, dB, dC, dD, dh0) of the chunked
    backward against ``jax.vjp`` of the exact scan and against
    ``mamba2_bwd_ref``: T within one chunk, at and across its boundary,
    and a ragged last chunk.  With ``split`` x, B, C and dy are bf16, as
    the model hands them over, and the oracles take the same values."""
    x, dt, a, bm, c, d, h0, dy, dh_t = (
        torch.from_numpy(z) for z in _inputs(rng, 2, 2, t, p, p))
    if split:
        x, bm, c, dy = (z.bfloat16() for z in (x, bm, c, dy))
    h0 = h0 if with_h0 else None
    dh_t = dh_t if with_dh else None
    got = ssd_chunked_bwd(x, dt, a, bm, c, d, dy, h0, dh_t, split=split)
    plain = mamba2_bwd_ref(x, dt, a, bm, c, d, dy, h0, dh_t)
    ins = [jnp.asarray(z.float().numpy()) for z in
           (x, dt, a, bm, c, d, torch.zeros(1) if h0 is None else h0)]
    cot = (jnp.asarray(dy.float().numpy()),
           jnp.zeros((2, 2, p, p), jnp.float32) if dh_t is None
           else jnp.asarray(dh_t.numpy()))
    vjp = _j_vjp(with_h0, tuple(ins), cot)
    assert (got[6] is None) == (not with_h0)
    for i, (g, w) in enumerate(zip(got, plain)):
        if g is None:
            continue
        _gate(g, w)
        _gate(g, torch.from_numpy(np.array(vjp[i])).to(g.dtype))


def test_split_pieces_carry_sixteen_bits():
    """The two bf16 pieces carry an f32 value to about 2^-16 relative, and
    a bf16 value exactly."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 100
    assert ((_split(v) - v).abs() / v.abs()).max().item() < 2.0 ** -16
    assert torch.equal(_split(v.bfloat16().float()), v.bfloat16().float())
