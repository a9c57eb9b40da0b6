"""The two-level chunked RWKV6 algorithm of the bf16 kernel
(``csrc/rwkv6_scan.cu``), written out in plain torch at the kernel's chunk
and sub-chunk lengths, against the port's exact ``rwkv6_ref`` and the JAX
package's exact ``rwkv6_ref``.

The kernel computes the recurrence ``y_t = r_t^T (S + diag(u) k_t v_t^T)``,
``S <- diag(w_t) S + k_t v_t^T`` over chunks of ``CHUNK`` tokens, each cut
into sub-chunks of ``SUB`` tokens.  With ``g`` a sub-chunk's total decay
(the product of its w):

* ``qloc_t = r_t prod_{tau<t} w_tau`` and ``kloc_s = k_s prod_{tau>s} w_tau``,
  the products taken inside the sub-chunk;
* between sub-chunks ``j < i`` of a chunk, ``A_ij = (qloc_i G_ij) kloc_j^T``
  with ``G_ij`` the product of the ``g`` of the sub-chunks in between;
* inside a sub-chunk, ``A[t, s] = sum_n r_t k_s prod_{s < tau < t} w_tau``
  for ``s < t`` (k_s carried along t by running products of w, no
  exponential at all), and the bonus ``sum_n r_t u k_t`` on the diagonal;
* ``y = (qloc_i Gpre_i) S + sum_j A_ij V_j`` and
  ``S <- diag(G_all) S + sum_j (kloc_j Gpost_j)^T V_j``.

Every decay is a product of factors w in (0, 1], as in the recurrence
itself: there is no exponential, so nothing is clamped and nothing
overflows for any w in (0, 1].  With ``split=True`` every f32 operand that meets the tensor
cores is cut into the two bf16 pieces the kernel multiplies, ``hi =
bf16(x)`` and ``lo = bf16(x - hi)``; a product of two such operands drops
``lo . lo``, as the kernel does.

Tolerance: the scan gate of the kernel tests (tests/test_torch_kernels.py
``_assert_scan_close`` and chip_smoke.py ``check_scan``): y within one ulp
of its dtype (2^-7 relative in bf16, 1e-4 in f32) plus 1e-4 of y's scale,
the final state within 1e-4 of its scale.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.rwkv6_scan import ops as j_rops
from repro.kernels.rwkv6_scan.ref import rwkv6_ref as j_rwkv6_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import CHUNK, SUB

_j_rwkv6_ref = jax.jit(j_rwkv6_ref)
_j_rwkv6_chunked = jax.jit(j_rops.rwkv6_chunked, static_argnums=(6,))


def _split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mm3(x, y):
    """x @ y with both f32 operands in two bf16 pieces (lo . lo dropped)."""
    xh, xl = _split(x)
    yh, yl = _split(y)
    return xh @ yh + xl @ yh + xh @ yl


def _mm2(x, y):
    """x @ y with x in two bf16 pieces and y exact in bf16."""
    xh, xl = _split(x)
    return xh @ y + xl @ y


def _prod(g, lo, hi):
    """The product of g[..., l, :] over l in [lo, hi), ones if empty."""
    out = torch.ones_like(g[..., 0, :])
    for i in range(lo, hi):
        out = out * g[..., i, :]
    return out


def rwkv6_two_level(r, k, v, w, u, s0=None, chunk=CHUNK, sub=SUB,
                    split=False):
    """The kernel's algorithm; shapes as in ``rwkv6_ref``.  Returns (y
    [B,H,T,N] in r's dtype, sT [B,H,N,N] f32)."""
    b, h, t, n = r.shape
    f32 = torch.float32
    mm3 = _mm3 if split else torch.matmul
    mm2 = _mm2 if split else torch.matmul
    nc, ns = -(-t // chunk), chunk // sub
    pad = nc * chunk - t

    # tokens past T: r = k = v = 0 and w = 1, so they change nothing
    def cut(x, fill):
        return F.pad(x.to(f32), (0, 0, 0, pad), value=fill) \
            .reshape(b, h, nc, ns, sub, n)
    rs, ks, vs, ws = cut(r, 0.0), cut(k, 0.0), cut(v, 0.0), cut(w, 1.0)
    # the products of w before and after each token, inside its sub-chunk
    pre = torch.cumprod(F.pad(ws[..., :-1, :], (0, 0, 1, 0), value=1.0), -2)
    post = torch.flip(torch.cumprod(torch.flip(
        F.pad(ws[..., 1:, :], (0, 0, 0, 1), value=1.0), [-2]), -2), [-2])
    qloc = rs * pre
    kloc = ks * post
    g = torch.prod(ws, -2)                         # [B,H,nc,ns,N]
    # inside a sub-chunk: k_s carried along t by running products of w
    a_diag = torch.zeros((b, h, nc, ns, sub, sub), dtype=f32)
    for s_ in range(sub):
        kd = ks[..., s_, :]
        for t_ in range(s_ + 1, sub):
            a_diag[..., t_, s_] = (rs[..., t_, :] * kd).sum(-1)
            kd = kd * ws[..., t_, :]
    uf = u.to(f32)[None, :, None, None, None, :]
    idx = torch.arange(sub)
    a_diag[..., idx, idx] = (rs * uf * ks).sum(-1)

    s = torch.zeros((b, h, n, n), dtype=f32) if s0 is None else s0.to(f32)
    ys = []
    for c in range(nc):
        gc = g[:, :, c]                            # [B,H,ns,N]
        for i in range(ns):
            q = qloc[:, :, c, i]                   # [B,H,sub,N]
            yi = mm3(q * _prod(gc, 0, i)[..., None, :], s)
            for j in range(i):
                a = mm3(q * _prod(gc, j + 1, i)[..., None, :],
                        kloc[:, :, c, j].transpose(-1, -2))
                yi = yi + mm2(a, vs[:, :, c, j])
            ys.append(yi + mm2(a_diag[:, :, c, i], vs[:, :, c, i]))
        s = _prod(gc, 0, ns)[..., :, None] * s
        for j in range(ns):
            kdec = kloc[:, :, c, j] * _prod(gc, j + 1, ns)[..., None, :]
            s = s + mm2(kdec.transpose(-1, -2), vs[:, :, c, j])
    y = torch.cat(ys, 2)[:, :, :t] if ys else torch.zeros((b, h, 0, n))
    return y.to(r.dtype), s


def _inputs(rng, b, h, t, n, with_s0, w_lo=0.0113, w_hi=0.9997):
    """Activations at unit scale; decays uniform in [w_lo, w_hi] (the
    model's range by default: exp(-exp(x)) for x clipped to [-8, 1.5])."""
    r, k, v = (0.5 * rng.standard_normal((b, h, t, n)) for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (b, h, t, n))
    u = 0.1 * rng.standard_normal((h, n))
    s0 = 0.1 * rng.standard_normal((b, h, n, n)) if with_s0 else None
    return [None if z is None else z.astype(np.float32)
            for z in (r, k, v, w, u, s0)]


def _torch(args):
    return [None if z is None else torch.from_numpy(z) for z in args]


def _gate(y, ry, st, rst):
    """Whether (y, sT) meet the scan gate against (ry, rsT)."""
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-4
    y, ry = y.float(), ry.float()
    ok_y = bool(torch.all((y - ry).abs() <= ulp * ry.abs() +
                          1e-4 * ry.abs().max())) if y.numel() else True
    return ok_y and (st - rst).abs().max().item() <= \
        1e-4 * rst.abs().max().item()


@pytest.mark.parametrize("t,with_s0", [(1, False), (17, True), (100, False),
                                       (257, True), (128, False)])
def test_two_level_matches_exact_scans(rng, t, with_s0):
    """Model-range decays, ragged T: against the port's and the JAX
    package's exact recurrences."""
    args = _inputs(rng, 1, 2, t, 64, with_s0)
    y, st = rwkv6_two_level(*_torch(args))
    ry, rst = rwkv6_ref(*_torch(args))
    assert _gate(y, ry, st, rst)
    jy, jst = _j_rwkv6_ref(*[None if z is None else jnp.asarray(z)
                             for z in args])
    assert _gate(y, torch.from_numpy(np.array(jy)), st,
                 torch.from_numpy(np.array(jst)))


@pytest.mark.parametrize("w_lo,w_hi", [(1e-6, 1e-5), (1e-6, 1.0),
                                       (1.0, 1.0)])
def test_two_level_extreme_decays_stay_finite(rng, w_lo, w_hi):
    """w down to 1e-6 (a sub-chunk's product of decays near e^-221, past
    e^-87 where f32 underflows) and w = 1.0 exactly: no inf or nan, and the
    gate holds."""
    args = _inputs(rng, 1, 2, 100, 32, True, w_lo, w_hi)
    if w_lo == 1e-6 and w_hi == 1.0:
        args[3][..., ::3] = 1.0               # exact ones among tiny decays
    y, st = rwkv6_two_level(*_torch(args))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    ry, rst = rwkv6_ref(*_torch(args))
    assert _gate(y, ry, st, rst)


@pytest.mark.parametrize("t,n,with_s0", [(1024, 64, True), (1000, 64, False),
                                         (65, 16, True)])
def test_two_piece_split_meets_the_scan_gate(rng, t, n, with_s0):
    """bf16 r, k, v, w as the model hands them over, every f32 operand on
    the tensor cores cut to two bf16 pieces: y (rounded once to bf16) and
    the final state meet the gate against the exact f32 recurrence on the
    same inputs, at the rwkv6-1.6b layer's T and head size."""
    r, k, v, w, u, s0 = _torch(_inputs(rng, 1, 2, t, n, with_s0))
    r, k, v, w = (x.bfloat16() for x in (r, k, v, w))
    y, st = rwkv6_two_level(r, k, v, w, u, s0, split=True)
    ry, rst = rwkv6_ref(r, k, v, w, u, s0)
    assert y.dtype == torch.bfloat16
    assert _gate(y, ry, st, rst)


def test_reference_chunked_form_fails_where_two_level_holds(rng):
    """At model-range decays and the kernel's chunk, the JAX package's
    chunked form (its decay factored as exp(la_prev) exp(min(-la, 30)))
    misses the gate; the two-level form on the same inputs meets it."""
    args = _inputs(rng, 1, 2, 128, 64, False)
    ry, rst = rwkv6_ref(*_torch(args))
    jy, jst = _j_rwkv6_chunked(*[jnp.asarray(z) for z in args[:5]], None,
                               CHUNK)
    assert not _gate(torch.from_numpy(np.array(jy)), ry,
                     torch.from_numpy(np.array(jst)), rst)
    y, st = rwkv6_two_level(*_torch(args))
    assert _gate(y, ry, st, rst)
