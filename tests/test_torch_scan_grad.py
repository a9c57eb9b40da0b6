"""The RWKV6 and Mamba2 scans' backward: the plain backwards
(``rwkv6_bwd_ref``, ``mamba2_bwd_ref``) against autograd of the plain
forwards, the ``autograd.Function``s run with their plain pair, the
dispatchers' routes, and (``cuda``-marked) the CUDA backward kernels
against the plain backwards.  This file does not import JAX: the
reference's ``jax.vjp`` is held in ``tests/test_torch_ssm_train.py``.

Tolerances, with their reasons:

* Plain backward against autograd of the plain forward, f32: 2e-5 of each
  gradient's largest magnitude.  Both run the same f32 recurrence; the
  sums run in other orders (autograd's einsum backward against the
  explicit reverse walk), about T roundings deep.
* The Functions with their plain pair against autograd: the same 2e-5 in
  f32; in bf16 one ulp of the inputs' dtype (2^-7 relative) plus 2e-5 of
  the scale, since each gradient is an f32 sum rounded once to bf16 and
  the two sums may round to neighbouring values.
* CUDA backward against the plain backward: relative L2 1e-5 in f32 (the
  same recurrence, summed in another order) and 1e-2 in bf16 (each output
  rounded once to bf16 from f32 sums that differ in their last bits: a
  value may land on the neighbouring ulp, 2^-8 relative).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.mamba2_ssd import ops as mops
from repro_torch.kernels.mamba2_ssd.ref import mamba2_bwd_ref, mamba2_ref
from repro_torch.kernels.rwkv6_scan import ops as rops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref, rwkv6_ref

F32_TOL = 2e-5
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rwkv_inputs(rng, b, h, t, n):
    """The model's layout ([B,T,H,N] activations seen as [B,H,T,N]) and its
    decay range (down to 0.0113 a token)."""
    def heads(x):
        return torch.from_numpy(x.astype(np.float32)).transpose(1, 2)
    r, k, v = (heads(0.5 * rng.standard_normal((b, t, h, n)))
               for _ in range(3))
    w = heads(rng.uniform(0.0113, 0.9997, (b, t, h, n)))
    u = torch.from_numpy((0.1 * rng.standard_normal((h, n))).astype(
        np.float32))
    s0 = torch.from_numpy((0.1 * rng.standard_normal((b, h, n, n))).astype(
        np.float32))
    dy = heads(rng.standard_normal((b, t, h, n)))
    ds_t = torch.from_numpy(rng.standard_normal((b, h, n, n)).astype(
        np.float32))
    return (r, k, v, w, u, s0), dy, ds_t


def mamba_inputs(rng, b, h, t, p, n):
    """The model's layout (x a transposed [B,T,H,P], dt a transposed
    [B,T,H] softplus, B and C column slices of one tensor)."""
    def f32(x):
        return torch.from_numpy(x.astype(np.float32))
    x = f32(rng.standard_normal((b, t, h, p))).transpose(1, 2)
    dt = f32(np.logaddexp(2.0 * rng.standard_normal((b, t, h)), 0.0)
             ).transpose(1, 2)
    a = f32(-rng.uniform(0.5, 2.0, h))
    bc = f32(rng.standard_normal((b, t, 2 * n + 5)))
    bm, c = bc[..., :n], bc[..., n:2 * n]
    d = f32(rng.standard_normal(h))
    h0 = f32(0.1 * rng.standard_normal((b, h, p, n)))
    dy = f32(rng.standard_normal((b, t, h, p))).transpose(1, 2)
    dh_t = f32(rng.standard_normal((b, h, p, n)))
    return (x, dt, a, bm, c, d, h0), dy, dh_t


def autograd_grads(fwd, ins, dy, ds_t, need):
    """Gradients of <y, dy> (+ <final state, ds_t>) by autograd of the
    plain forward, for the inputs flagged in ``need`` (None elsewhere)."""
    leaves = [x.detach().clone().requires_grad_(bool(f)) if x is not None
              else None for x, f in zip(ins, need)]
    y, s_t = fwd(*leaves)
    loss = (y.float() * dy.float()).sum()
    if ds_t is not None:
        loss = loss + (s_t * ds_t).sum()
    loss.backward()
    return [x.grad if x is not None and f else None
            for x, f in zip(leaves, need)]


def assert_close(got, want, bf16=False):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    bound = F32_TOL * scale + (BF16_ULP * want.float().abs() if bf16 else 0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool((err <= bound).all()), (err.max().item(), scale)


@pytest.mark.parametrize("with_s0,with_ds", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_rwkv6_bwd_ref_matches_autograd(rng, with_s0, with_ds):
    ins, dy, ds_t = rwkv_inputs(rng, 2, 3, 70, 16)
    if not with_s0:
        ins = ins[:5] + (None,)
    ds_t = ds_t if with_ds else None
    want = autograd_grads(rwkv6_ref, ins, dy, ds_t,
                          [1, 1, 1, 1, 1, with_s0])
    got = rwkv6_bwd_ref(*ins[:5], dy, ins[5], ds_t)
    for g, w in zip(got[:5], want[:5]):
        assert_close(g, w)
    if with_s0:
        assert_close(got[5], want[5])
    else:
        assert got[5] is None


@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_mamba2_bwd_ref_matches_autograd(rng, with_h0, with_dh):
    ins, dy, dh_t = mamba_inputs(rng, 2, 3, 70, 8, 16)
    if not with_h0:
        ins = ins[:6] + (None,)
    dh_t = dh_t if with_dh else None
    want = autograd_grads(mamba2_ref, ins, dy, dh_t,
                          [1, 1, 1, 1, 1, 1, with_h0])
    got = mamba2_bwd_ref(*ins[:6], dy, ins[6], dh_t)
    for g, w in zip(got[:6], want[:6]):
        assert_close(g, w)
    if with_h0:
        assert_close(got[6], want[6])
    else:
        assert got[6] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["all", "no_s0_no_u", "state_used"])
def test_rwkv6_function_plain_pair(rng, dtype, case):
    """``RWKV6Scan`` with ``impl="torch"``: the gradients autograd gives the
    plain forward, in each input's dtype; None where no gradient is asked
    for; an unused final state reaches the backward as None."""
    ins, dy, ds_t = rwkv_inputs(rng, 2, 2, 40, 16)
    ins = tuple(x.to(dtype) for x in ins[:4]) + ins[4:]
    need = [1, 1, 1, 1, 1, 1]
    if case == "no_s0_no_u":
        ins, need = ins[:5] + (None,), [1, 0, 1, 1, 0, 0]
    ds_t = ds_t if case == "state_used" else None
    want = autograd_grads(rwkv6_ref, ins, dy.to(dtype), ds_t, need)
    leaves = [x.detach().clone().requires_grad_(bool(f)) if x is not None
              else None for x, f in zip(ins, need)]
    y, s_t = rops.RWKV6Scan.apply(*leaves, "torch")
    loss = (y.float() * dy.to(dtype).float()).sum()
    if ds_t is not None:
        loss = loss + (s_t * ds_t).sum()
    loss.backward()
    for x, w, f in zip(leaves, want, need):
        if not f:
            assert x is None or x.grad is None
            continue
        assert_close(x.grad, w, bf16=dtype == torch.bfloat16 and
                     x.dtype == dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["all", "no_h0_no_d", "state_used"])
def test_mamba2_function_plain_pair(rng, dtype, case):
    """``Mamba2Scan`` with ``impl="torch"``, as the RWKV6 test above; x, B
    and C in ``dtype``, dt, A, D and h0 in f32 as the model hands them."""
    ins, dy, dh_t = mamba_inputs(rng, 2, 3, 40, 8, 16)
    x, dt, a, bm, c, d, h0 = ins
    ins = (x.to(dtype), dt, a, bm.to(dtype), c.to(dtype), d, h0)
    need = [1, 1, 1, 1, 1, 1, 1]
    if case == "no_h0_no_d":
        ins, need = ins[:6] + (None,), [1, 1, 1, 0, 1, 0, 0]
    dh_t = dh_t if case == "state_used" else None
    want = autograd_grads(mamba2_ref, ins, dy.to(dtype), dh_t, need)
    leaves = [z.detach().clone().requires_grad_(bool(f)) if z is not None
              else None for z, f in zip(ins, need)]
    y, h_t = mops.Mamba2Scan.apply(*leaves, "torch")
    loss = (y.float() * dy.to(dtype).float()).sum()
    if dh_t is not None:
        loss = loss + (h_t * dh_t).sum()
    loss.backward()
    for z, w, f in zip(leaves, want, need):
        if not f:
            assert z is None or z.grad is None
            continue
        assert_close(z.grad, w, bf16=dtype == torch.bfloat16 and
                     z.dtype == dtype)


def test_dispatchers_keep_cpu_on_the_plain_forward(rng):
    """On the CPU the dispatchers run the plain forward (autograd
    differentiates it, no Function); ``impl="cuda"`` on a CPU tensor
    raises in the wrapper, with or without autograd recording."""
    ins, _, _ = rwkv_inputs(rng, 1, 2, 8, 16)
    r = ins[0].clone().requires_grad_(True)
    y, _ = rops.rwkv6(r, *ins[1:])
    assert y.grad_fn is not None and "RWKV6Scan" not in type(
        y.grad_fn).__name__
    m_ins, _, _ = mamba_inputs(rng, 1, 2, 8, 8, 16)
    y, _ = mops.mamba2(*m_ins)
    assert y.grad_fn is None
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            with pytest.raises(ValueError):
                rops.rwkv6(r, *ins[1:], impl="cuda")
            with pytest.raises(ValueError):
                mops.mamba2(*m_ins, impl="cuda")


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() /
            b.float().norm().clamp_min(1e-30)).item()


CUDA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 2, 70, 16), (1, 4, 300, 64)])
def test_cuda_rwkv6_bwd_matches_plain(cuda, rng, dtype, shape):
    ins, dy, ds_t = rwkv_inputs(rng, *shape)
    r, k, v, w = (x.to(cuda, dtype) for x in ins[:4])
    u, s0, ds_t = (x.to(cuda) for x in (ins[4], ins[5], ds_t))
    dy = dy.to(cuda, dtype)
    reset_launches()
    got = rops.rwkv6_bwd_cuda(r, k, v, w, u, dy, s0, ds_t)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_scan_bwd"] == 1
    want = rwkv6_bwd_ref(r, k, v, w, u, dy, s0, ds_t)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and g.shape == wt.shape
        assert rel_l2(g, wt) < CUDA_TOL[dtype]
    assert got[0].stride() == r.stride()
    again = rops.rwkv6_bwd_cuda(r, k, v, w, u, dy, s0, ds_t)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 70, 16, 16), (1, 8, 300, 64, 64)])
def test_cuda_mamba2_bwd_matches_plain(cuda, rng, dtype, shape):
    ins, dy, dh_t = mamba_inputs(rng, *shape)
    x, dt, a, bm, c, d, h0 = (z.to(cuda) for z in ins)
    x, bm, c = x.to(dtype), bm.to(dtype), c.to(dtype)
    dy, dh_t = dy.to(cuda, dtype), dh_t.to(cuda)
    reset_launches()
    got = mops.mamba2_bwd_cuda(x, dt, a, bm, c, d, dy, h0, dh_t)
    torch.cuda.synchronize()
    assert LAUNCHES["mamba2_ssd_bwd"] == 1
    want = mamba2_bwd_ref(x, dt, a, bm, c, d, dy, h0, dh_t)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and g.shape == wt.shape
        assert rel_l2(g, wt) < CUDA_TOL[dtype]
    assert got[1].stride() == dt.stride()
    again = mops.mamba2_bwd_cuda(x, dt, a, bm, c, d, dy, h0, dh_t)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again))


@pytest.mark.cuda
def test_cuda_scans_launch_the_backward_only_when_recording(cuda, rng):
    """Under ``torch.no_grad()`` the dispatchers launch the forward kernels
    alone; with an input that needs a gradient, the Function's backward
    launches each backward kernel once."""
    r_ins, dy, _ = rwkv_inputs(rng, 1, 2, 64, 64)
    r_ins = [x.to(cuda) for x in r_ins[:5]]
    m_ins, m_dy, _ = mamba_inputs(rng, 1, 2, 64, 64, 64)
    m_ins = [z.to(cuda) for z in m_ins[:6]]
    reset_launches()
    with torch.no_grad():
        rops.rwkv6(*r_ins)
        mops.mamba2(*m_ins)
    assert (LAUNCHES["rwkv6_scan"], LAUNCHES["mamba2_ssd"],
            LAUNCHES["rwkv6_scan_bwd"], LAUNCHES["mamba2_ssd_bwd"]) == \
        (1, 1, 0, 0)
    r_ins[0].requires_grad_(True)
    m_ins[0].requires_grad_(True)
    y, _ = rops.rwkv6(*r_ins)
    (y * dy.to(cuda)).sum().backward()
    y, _ = mops.mamba2(*m_ins)
    (y * m_dy.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (LAUNCHES["rwkv6_scan"], LAUNCHES["mamba2_ssd"],
            LAUNCHES["rwkv6_scan_bwd"], LAUNCHES["mamba2_ssd_bwd"]) == \
        (2, 2, 1, 1)
