"""The chunked backward of the bf16 RWKV6 kernels
(``csrc/rwkv6_scan_bwd.cu``), written out in plain torch at the kernels'
chunk and sub-chunk lengths, against ``jax.vjp`` of the JAX package's
exact scan (``rwkv6_ref``) and the port's plain backward
(``rwkv6_bwd_ref``).

The forward is, per (batch, head), ``y_t = r_t^T (S_{t-1} + diag(u) k_t
v_t^T)``, ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``; with ``G_t`` the adjoint
of ``S_t`` the backward is ``dr_t = S_{t-1} dy_t + ...``, ``dk_t = G_t v_t
+ ...``, ``dv_t = G_t^T k_t + ...``, ``dw_t[n] = sum_m G_t[n,m]
S_{t-1}[n,m]`` (``rwkv6_bwd_ref``).  ``rwkv6_chunked_bwd`` below is the
kernels' form, the transpose of the forward's two-level one (chunks of
``CHUNK`` tokens, sub-chunks of ``SUB``):

* over chunks: each chunk's state from zero, ``(k . prod_{tau>t} w)^T v``,
  and local adjoint of its entering state, ``(r . prod_{tau<t} w)^T dy``,
  with its total decay; an element-wise scan gives the state S_0 entering
  every chunk, one run backwards from ``dsT`` the adjoint G_L at every
  chunk's end (and ``ds0``);
* per (chunk, sub-chunk i): the state F_i entering the sub-chunk and the
  adjoint H_i at its end, from S_0 and G_L through the chunk's other
  sub-chunks (``F <- g . F + kloc_j^T v_j``, ``H <- g . H + qloc_j^T
  dy_j``, g a sub-chunk's total decay, kloc and qloc k and r decayed to
  the sub-chunk's end and from its start); then
  ``dr = pre . (dy F_i^T) + intra``, ``dk = post . (v H_i^T) + intra``,
  ``dv = kloc H_i + A^T dy`` with A the forward's diagonal tile (the bonus
  on its diagonal), and dw directly, ``sum_m G_t S_{t-1}`` expanded over
  the sub-chunk: ``pre post <H_i, F_i>`` by rows, plus walks of 16 tokens
  over ``v H_i^T``, ``dy F_i^T`` and ``dy v^T``.  Every decay is a product
  of w's in (0, 1]: no exponential, no division, no cumulative sum of
  differences that could cancel (the log-space route to dw does).

With ``split=True`` every f32 operand that meets the tensor cores is cut
into the two bf16 pieces the kernels multiply, ``hi = bf16(x)`` and ``lo =
bf16(x - hi)``; a product of two such operands drops ``lo . lo``; the
boundary states are stored as such pieces between the kernels.

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

from repro.kernels.rwkv6_scan.ref import rwkv6_ref as j_rwkv6_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import CHUNK, SUB


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pieces(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mm3(x, y):
    """x @ y with both f32 operands in two bf16 pieces (lo . lo dropped)."""
    xh, xl = _pieces(x)
    yh, yl = _pieces(y)
    return xh @ yh + xl @ yh + xh @ yl


def _mm2(x, y):
    """x @ y with x in two bf16 pieces and y exact in bf16."""
    xh, xl = _pieces(x)
    return xh @ y + xl @ y


def _stored(x):
    """A boundary state as the kernels store it: its two bf16 pieces."""
    hi, lo = _pieces(x)
    return hi + lo


def rwkv6_chunked_bwd(r, k, v, w, u, dy, s0=None, ds_t=None, chunk=CHUNK,
                      sub=SUB, split=False):
    """The kernels' chunked backward; arguments and results as
    ``rwkv6_bwd_ref``'s."""
    b, h, t, n = r.shape
    f32 = torch.float32
    mm3 = _mm3 if split else torch.matmul
    mm2 = _mm2 if split else torch.matmul
    keep = _stored if split else (lambda x: x)
    nc, ns = -(-t // chunk), chunk // sub
    pad = nc * chunk - t

    # tokens past T: r = k = v = dy = 0 and w = 1, so they change nothing
    def cut(x, fill):
        return F.pad(x.to(f32), (0, 0, 0, pad), value=fill) \
            .reshape(b, h, nc, chunk, n)
    rs, ks, vs, dys = (cut(x, 0.0) for x in (r, k, v, dy))
    ws = cut(w, 1.0)
    uf = u.to(f32)[None, :, None, None, :]

    def excl(x, dim):
        """Products of w before each token along dim (exclusive)."""
        return torch.cumprod(F.pad(x[..., :-1, :], (0, 0, 1, 0),
                                   value=1.0), dim)

    def after(x):
        """Products of w after each token (exclusive), along dim -2."""
        return torch.flip(excl(torch.flip(x, [-2]), -2), [-2])

    # over chunks: states from zero, local adjoints, total decays
    ds_c = mm2((ks * after(ws)).transpose(-1, -2), vs)    # [b,h,nc,n,n]
    la_c = mm2((rs * excl(ws, -2)).transpose(-1, -2), dys)
    dall = torch.prod(ws, -2)                             # [b,h,nc,n]
    s = torch.zeros((b, h, n, n), dtype=f32) if s0 is None else s0.to(f32)
    s_in = []
    for c in range(nc):
        s_in.append(keep(s))
        s = dall[:, :, c, :, None] * s + ds_c[:, :, c]
    g = torch.zeros((b, h, n, n), dtype=f32) if ds_t is None \
        else ds_t.to(f32)
    g_end = [None] * nc
    for c in reversed(range(nc)):
        g_end[c] = keep(g)
        g = dall[:, :, c, :, None] * g + la_c[:, :, c]
    ds0 = None if s0 is None else g

    # per (chunk, sub-chunk)
    def subs(x):
        return x.reshape(b, h, nc, ns, sub, n)
    rq, kq, vq, wq, dq = (subs(x) for x in (rs, ks, vs, ws, dys))
    pre, post = excl(wq, -2), after(wq)
    gsub = torch.prod(wq, -2)                             # [b,h,nc,ns,n]
    qloc, kloc = rq * pre, kq * post
    outs = [torch.zeros((b, h, nc, ns, sub, n), dtype=f32)
            for _ in range(4)]
    du = torch.zeros((h, n), dtype=f32)
    for c in range(nc):
        for i in range(ns):
            f_i = s_in[c]
            for j in range(i):
                f_i = gsub[:, :, c, j, :, None] * f_i + mm2(
                    kloc[:, :, c, j].transpose(-1, -2), vq[:, :, c, j])
            h_i = g_end[c]
            for j in reversed(range(i + 1, ns)):
                h_i = gsub[:, :, c, j, :, None] * h_i + mm2(
                    qloc[:, :, c, j].transpose(-1, -2), dq[:, :, c, j])
            ci = (h_i * f_i).sum(-1)                      # [b,h,n]
            f_i, h_i = keep(f_i), keep(h_i)
            r_, k_, v_, w_, d_ = (x[:, :, c, i] for x in (rq, kq, vq, wq,
                                                          dq))
            pr, po = pre[:, :, c, i], post[:, :, c, i]
            df_ = mm2(d_, f_i.transpose(-1, -2))          # dy F^T [b,h,s,n]
            vh = mm2(v_, h_i.transpose(-1, -2))           # v H^T
            ap = d_ @ v_.transpose(-1, -2)                # A'[t,s] = dy.v
            # the forward's diagonal tile, A[s,t] for t < s, the bonus on
            # its diagonal
            a_ii = torch.zeros((b, h, sub, sub), dtype=f32)
            for t_ in range(sub):
                kd = k_[:, :, t_]
                for s_ in range(t_ + 1, sub):
                    a_ii[:, :, s_, t_] = (r_[:, :, s_] * kd).sum(-1)
                    kd = kd * w_[:, :, s_]
            vdy = ap.diagonal(dim1=-2, dim2=-1)           # v_t . dy_t
            idx = torch.arange(sub)
            a_ii[:, :, idx, idx] = (r_ * u.to(f32)[None, :, None, :] *
                                    k_).sum(-1)
            dv = mm3(kloc[:, :, c, i], h_i) + \
                mm2(a_ii.transpose(-1, -2), d_)
            # the 16-token walks, each key channel on its own: E[s] =
            # sum_{s'<t} A'[s,s'] k_s' prod_{s'<tau<t} w, carried along t
            e = torch.zeros((b, h, sub, n), dtype=f32)
            bv = torch.zeros((b, h, n), dtype=f32)
            dr, dk, dw = (torch.zeros((b, h, sub, n), dtype=f32)
                          for _ in range(3))
            for t_ in range(sub):
                acc_w = torch.zeros((b, h, n), dtype=f32)
                acc_k = torch.zeros((b, h, n), dtype=f32)
                for s_ in reversed(range(t_ + 1, sub)):   # Horner over s > t
                    acc_w = r_[:, :, s_] * (e[:, :, s_] + pr[:, :, t_] *
                                            df_[:, :, s_]) + \
                        w_[:, :, s_] * acc_w
                    acc_k = r_[:, :, s_] * ap[:, :, s_, t_, None] + \
                        w_[:, :, s_] * acc_k
                dr[:, :, t_] = pr[:, :, t_] * df_[:, :, t_] + e[:, :, t_]
                dk[:, :, t_] = po[:, :, t_] * vh[:, :, t_] + acc_k
                dw[:, :, t_] = pr[:, :, t_] * po[:, :, t_] * ci + \
                    po[:, :, t_] * bv + acc_w
                # carry to t + 1: E[s] and sum_{s'<t} kdec VH[s']
                e = w_[:, :, t_, None] * e + ap[:, :, :, t_, None] * \
                    k_[:, :, t_, None]
                bv = w_[:, :, t_] * bv + k_[:, :, t_] * vh[:, :, t_]
            bonus = vdy[..., None] * uf[:, :, 0]
            outs[0][:, :, c, i] = dr + bonus * k_
            outs[1][:, :, c, i] = dk + bonus * r_
            outs[2][:, :, c, i] = dv
            outs[3][:, :, c, i] = dw
            du += (r_ * k_ * vdy[..., None]).sum((0, 2))
    grads = [x.reshape(b, h, nc * chunk, n)[:, :, :t].to(r.dtype)
             for x in outs]
    return (*grads, du, ds0)


@functools.partial(jax.jit, static_argnums=(0,))
def _j_vjp(with_s0, ins, cot):
    """jax.vjp of the JAX package's exact scan (s0 omitted without it)."""
    _, vjp = jax.vjp(j_rwkv6_ref, *(ins if with_s0 else ins[:5]))
    return vjp(cot)


def _inputs(rng, b, h, t, n, w_lo=0.0113, w_hi=0.9997):
    """``tests/test_torch_scan_grad.py`` ``rwkv_inputs``' ranges: decays
    uniform in the model's [0.0113, 0.9997] by default; s0 and the
    final-state cotangent drawn too."""
    r, k, v = (0.5 * rng.standard_normal((b, h, t, n)) for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (b, h, t, n))
    u = 0.1 * rng.standard_normal((h, n))
    s0 = 0.1 * rng.standard_normal((b, h, n, n))
    dy = rng.standard_normal((b, h, t, n))
    ds_t = rng.standard_normal((b, h, n, n))
    return [z.astype(np.float32) for z in (r, k, v, w, u, s0, dy, ds_t)]


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
@pytest.mark.parametrize("t,n,with_s0,with_ds", [
    (1, 64, False, False), (63, 64, True, False), (64, 32, False, True),
    (65, 64, True, True), (300, 32, True, True)])
def test_chunked_bwd_matches_vjp_and_plain_backward(rng, t, n, with_s0,
                                                    with_ds, split):
    """Every gradient (dr, dk, dv, dw, du, ds0) of the chunked backward
    against ``jax.vjp`` of the exact scan and against ``rwkv6_bwd_ref``,
    at the model's decays: T within one chunk, at and across its boundary,
    and a ragged last chunk.  With ``split`` r, k, v, w and dy are bf16, as
    the model hands them over, and the oracles take the same values."""
    r, k, v, w, u, s0, dy, ds_t = (
        torch.from_numpy(z) for z in _inputs(rng, 2, 2, t, n))
    if split:
        r, k, v, w, dy = (x.bfloat16() for x in (r, k, v, w, dy))
    s0 = s0 if with_s0 else None
    ds_t = ds_t if with_ds else None
    got = rwkv6_chunked_bwd(r, k, v, w, u, dy, s0, ds_t, split=split)
    plain = rwkv6_bwd_ref(r, k, v, w, u, dy, s0, ds_t)
    ins = [jnp.asarray(x.float().numpy()) for x in
           (r, k, v, w, u, torch.zeros(1) if s0 is None else s0)]
    cot = (jnp.asarray(dy.float().numpy()),
           jnp.zeros((2, 2, n, n), jnp.float32) if ds_t is None
           else jnp.asarray(ds_t.numpy()))
    vjp = _j_vjp(with_s0, tuple(ins), cot)
    assert (got[5] is None) == (not with_s0)
    for i, (g, w_) in enumerate(zip(got, plain)):
        if g is None:
            continue
        _gate(g, w_)
        _gate(g, torch.from_numpy(np.array(vjp[i])).to(g.dtype))


@pytest.mark.parametrize("w_lo,w_hi", [(1e-6, 1e-5), (1e-6, 1.0)])
def test_chunked_bwd_extreme_decays(rng, w_lo, w_hi):
    """Decays down to 1e-6 (a sub-chunk's product of decays far below
    f32's range) and exact ones among them: every gradient finite and
    within the gate of the plain backward."""
    r, k, v, w, u, s0, dy, ds_t = (
        torch.from_numpy(z) for z in _inputs(rng, 1, 2, 100, 32, w_lo,
                                              w_hi))
    if w_hi == 1.0:
        w[..., ::3] = 1.0
    got = rwkv6_chunked_bwd(r, k, v, w, u, dy, s0, ds_t)
    for g, w_ in zip(got, rwkv6_bwd_ref(r, k, v, w, u, dy, s0, ds_t)):
        assert torch.isfinite(g).all()
        _gate(g, w_)
