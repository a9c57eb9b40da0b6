"""The port's kernels against the JAX package's.

On the CPU the port's wrappers take their plain torch versions; those are
held against the Pallas kernels run in interpret mode (the JAX package's own
CPU oracle) and against the jnp references.  The CUDA kernels themselves
are held against the plain versions on the card (``cuda`` marker; they skip
without a GPU).  Integer outputs must be bit-equal everywhere; the MoE
float tolerances are those of tests/test_moe_dispatch.py.  The scans' plain
versions are held against the JAX package in tests/test_torch_ssm.py; here
the scan kernels are held against them on the card, y within one ulp of its
dtype (relative 2^-7 for bf16, 1e-4 for f32: the sums run in another
order, so a value may round to the neighbouring ulp) plus 1e-4 of the
output's scale, the final state within 1e-4 of its scale.
"""
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.moe_dispatch.moe_dispatch import (combine_pallas,
                                                     dispatch_pallas)
from repro.kernels.moe_dispatch.ref import combine_ref as j_combine_ref
from repro.kernels.moe_dispatch.ref import dispatch_ref as j_dispatch_ref
from repro.kernels.moe_gating.moe_gating import gating_pallas
from repro.kernels.moe_gating.ref import gating_ref as j_gating_ref
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.moe_dispatch import ops as dops
from repro_torch.kernels.moe_dispatch.ref import combine_ref, dispatch_ref
from repro_torch.kernels.moe_gating import ops as gops
from repro_torch.kernels.moe_gating.ref import gating_ref
from repro_torch.kernels.mamba2_ssd import ops as mops
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ref
from repro_torch.kernels.rwkv6_scan import ops as rops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ------------------------------------------------------------------ gating

@pytest.mark.parametrize("t,e,k", [(8, 16, 2), (32, 8, 2), (24, 64, 8),
                                   (5, 16, 4)])
def test_gating_matches_pallas_and_ref(rng, t, e, k):
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[0] = 0.25                           # row 0: every expert tied
    pw, pe, pc = gating_pallas(jnp.asarray(logits), k, bt=t, interpret=True)
    rw, re_, rc = j_gating_ref(jnp.asarray(logits), k)
    w, ids, counts = gops.gating(_t(logits)[None], k)
    for e_ref, c_ref in ((pe, pc), (re_, rc)):
        np.testing.assert_array_equal(ids[0].numpy(), np.asarray(e_ref))
        np.testing.assert_array_equal(counts[0].numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(w[0].numpy(), np.asarray(pw), atol=1e-5)
    np.testing.assert_allclose(w[0].numpy(), np.asarray(rw), atol=1e-5)
    # ties go to the lowest index, round after round
    np.testing.assert_array_equal(ids[0, 0].numpy(), np.arange(k))


def test_gating_groups_are_independent(rng):
    """[G,T,E] with G groups equals G separate calls: phi per group."""
    logits = _t(rng.standard_normal((3, 6, 16)).astype(np.float32))
    w, ids, counts = gating_ref(logits, 2)
    for g in range(3):
        wg, ig, cg = gating_ref(logits[g:g + 1], 2)
        assert torch.equal(ig[0], ids[g]) and torch.equal(cg[0], counts[g])
        assert torch.equal(wg[0], w[g])
    assert counts.sum() == 3 * 6 * 2


# -------------------------------------------------------- dispatch/combine

def _routing(rng, t, k, s, p_valid, hot):
    """Random routing; ``hot`` concentrates slots so capacity overflows."""
    hi = 3 if hot else s
    slot = rng.integers(0, hi, (t, k)).astype(np.int32)
    valid = (rng.random((t, k)) < p_valid).astype(np.int32)
    w = rng.random((t, k)).astype(np.float32)
    return slot, valid, w


@pytest.mark.parametrize("t,k,s,cap,p_valid,hot", [
    (8, 2, 10, 4, 1.0, False), (32, 2, 10, 4, 1.0, True),
    (24, 4, 6, 5, 0.7, True), (16, 8, 18, 4, 0.9, False)])
def test_dispatch_combine_match_pallas_f32(rng, t, k, s, cap, p_valid, hot):
    d = 32
    v = rng.standard_normal((t, d)).astype(np.float32)
    slot, valid, w = _routing(rng, t, k, s, p_valid, hot)
    pb = dispatch_pallas(jnp.asarray(v), jnp.asarray(w), jnp.asarray(slot),
                         jnp.asarray(valid), s, cap, bt=t, interpret=True)
    rb = j_dispatch_ref(jnp.asarray(v), jnp.asarray(w), jnp.asarray(slot),
                        jnp.asarray(valid), s, cap)
    got = dops.dispatch(_t(v)[None], _t(w)[None], _t(slot)[None],
                        _t(valid)[None], s, cap)
    for ref in (pb, rb):
        for name, a, b in zip(("rank", "keep", "routed", "kept"),
                              got[1:], ref[1:]):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                          err_msg=name)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(pb[0]),
                               atol=1e-5)
    if hot:
        assert int(got[2].sum()) < int(valid.sum())      # something dropped
    out = rng.standard_normal(got[0].shape).astype(np.float32)
    wc = rng.random((t, k)).astype(np.float32)
    args = (jnp.asarray(slot), jnp.asarray(np.asarray(got[1][0])),
            jnp.asarray(np.asarray(got[2][0])))
    py = combine_pallas(jnp.asarray(out[0]), jnp.asarray(wc), *args, bt=t,
                        interpret=True)
    ry = j_combine_ref(jnp.asarray(out[0]), jnp.asarray(wc), *args)
    y = dops.combine(_t(out), _t(wc)[None], _t(slot)[None], got[1], got[2])
    np.testing.assert_allclose(y[0].numpy(), np.asarray(py), atol=1e-5)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(ry), atol=1e-5)


def test_dispatch_bf16_buffer_is_exact_copy(rng):
    """With unit weights the buffer rows are bit copies of the token rows
    (the main path dispatches with w = 1)."""
    t, k, s, cap, d = 8, 2, 10, 4, 64
    v = _t(rng.standard_normal((2, t, d)).astype(np.float32)).bfloat16()
    slot, valid, _ = _routing(rng, 2 * t, k, s, 1.0, False)
    slot, valid = _t(slot).reshape(2, t, k), _t(valid).reshape(2, t, k)
    buf, rank, keep, _, _ = dispatch_ref(v, torch.ones(2, t, k), slot, valid,
                                         s, cap)
    for g in range(2):
        for i in range(t):
            for j in range(k):
                if keep[g, i, j]:
                    assert torch.equal(buf[g, slot[g, i, j], rank[g, i, j]],
                                       v[g, i])


def test_plain_versions_count_no_launches(rng):
    reset_launches()
    logits = _t(rng.standard_normal((2, 4, 8)).astype(np.float32))
    gops.gating(logits, 2)
    v = _t(rng.standard_normal((2, 4, 16)).astype(np.float32))
    slot = torch.zeros((2, 4, 2), dtype=torch.int32)
    ones = torch.ones((2, 4, 2), dtype=torch.int32)
    buf, rank, keep, _, _ = dops.dispatch(v, torch.ones(2, 4, 2), slot, ones,
                                          4, 4)
    dops.combine(buf, torch.ones(2, 4, 2), slot, rank, keep)
    x = torch.rand((1, 2, 5, 16))
    rops.rwkv6(x, x, x, x, torch.rand(2, 16))
    mops.mamba2(x, torch.rand(1, 2, 5), -torch.ones(2), x[0, :1],
                x[0, :1], torch.zeros(2))
    assert all(n == 0 for n in LAUNCHES.values())


def test_cuda_impl_refuses_cpu_tensors():
    x = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError):
        gops.gating(x, 2, impl="cuda")
    with pytest.raises(ValueError):
        dops.dispatch(x, torch.ones(1, 2, 2), torch.zeros((1, 2, 2),
                      dtype=torch.int32), torch.ones((1, 2, 2),
                      dtype=torch.int32), 4, 4, impl="cuda")
    x = torch.zeros((1, 2, 5, 16))
    with pytest.raises(ValueError):
        rops.rwkv6(x, x, x, x, torch.zeros(2, 16), impl="cuda")
    with pytest.raises(ValueError):
        mops.mamba2(x, torch.zeros(1, 2, 5), -torch.ones(2), x[0, :1],
                    x[0, :1], torch.zeros(2), impl="cuda")


# ----------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("g,t,e,k", [(8, 1, 16, 2), (1, 8, 16, 2),
                                     (1, 4096, 16, 2), (3, 700, 16, 2),
                                     (2, 300, 64, 8), (1, 513, 128, 8),
                                     (2, 9000, 16, 2), (1, 4096, 128, 8)])
def test_cuda_gating_matches_plain(cuda, rng, g, t, e, k):
    x = _t(rng.standard_normal((g, t, e)).astype(np.float32)).to(cuda)
    w, ids, cnt = gops.gating(x, k, impl="cuda")
    rw, rids, rcnt = gating_ref(x, k)
    assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)
    assert (w - rw).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("g,t,e,k", [(8, 1, 16, 2), (1, 4096, 16, 2),
                                     (3, 700, 16, 2), (1, 513, 128, 8)])
def test_cuda_gating_one_launch_and_replays(cuda, rng, g, t, e, k):
    """One kernel launch a call and no memset (a CUDA-only trace of one
    call); two calls in a row, and a CUDA graph of one call replayed three
    times, each give phi equal to the plain version's: the ticket counters
    that the last block of a group puts back to 0 hold across launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.moe_gating.moe_gating import gating_cuda
    x = _t(rng.standard_normal((g, t, e)).astype(np.float32)).to(cuda)
    _, rids, rcnt = gating_ref(x, k)
    gating_cuda(x, k)
    torch.cuda.synchronize()
    # a short host pause on each side of the traced call, so that no
    # record of it is lost at the trace's edges (chip_smoke.py
    # device_trace does the same)
    time.sleep(0.05)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gating_cuda(x, k)
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e_.name for e_ in prof.events()
             if e_.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "gating" in names[0], names
    for _ in range(2):
        _, ids, cnt = gating_cuda(x, k)
        assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, ids, cnt = gating_cuda(x, k)
    for _ in range(3):
        cnt.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,t,k,d,s,cap", [(8, 1, 2, 512, 18, 4),
                                           (1, 8, 2, 512, 18, 4),
                                           (3, 130, 8, 96, 80, 6),
                                           # training's microbatch
                                           (1, 4096, 2, 512, 18, 640),
                                           # D off 8: element-wise gathers
                                           (2, 33, 2, 100, 10, 4),
                                           # k past one warp's lanes
                                           (1, 5, 40, 64, 48, 8),
                                           # several tiles a group
                                           (4, 1024, 2, 512, 18, 160),
                                           # T*k off the tile: 256+256+88
                                           (2, 300, 2, 512, 18, 40)])
def test_cuda_dispatch_combine_match_plain(cuda, rng, dtype, g, t, k, d, s,
                                           cap):
    v = _t(rng.standard_normal((g, t, d)).astype(np.float32)).to(cuda, dtype)
    w = _t(rng.random((g, t, k)).astype(np.float32)).to(cuda)
    slot = _t(rng.integers(0, min(s, 3 if t > 4 else s), (g, t, k))
              .astype(np.int32)).to(cuda)
    valid = _t((rng.random((g, t, k)) < 0.9).astype(np.int32)).to(cuda)
    got = dops.dispatch(v, w, slot, valid, s, cap, impl="cuda")
    ref = dispatch_ref(v, w, slot, valid, s, cap)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    y = dops.combine(got[0], w, slot, got[1], got[2], impl="cuda")
    assert torch.equal(y, combine_ref(got[0], w, slot, got[1], got[2]))
    # the experts hand the buffer back as a permuted view of [S,G,C,D]
    perm = got[0].permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
    assert torch.equal(dops.combine(perm, w, slot, got[1], got[2],
                                    impl="cuda"), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dispatch_one_hot_slot(cuda, rng, dtype):
    """Training's microbatch with every assignment in one slot: 640 kept of
    8192, the rest dropped, every other slot's rows zero."""
    g, t, k, d, s, cap = 1, 4096, 2, 512, 18, 640
    v = _t(rng.standard_normal((g, t, d)).astype(np.float32)).to(cuda, dtype)
    w = _t(rng.random((g, t, k)).astype(np.float32)).to(cuda)
    slot = torch.full((g, t, k), 7, dtype=torch.int32, device=cuda)
    valid = torch.ones((g, t, k), dtype=torch.int32, device=cuda)
    got = dops.dispatch(v, w, slot, valid, s, cap, impl="cuda")
    ref = dispatch_ref(v, w, slot, valid, s, cap)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[4].sum()) == cap and int(got[3][0, 7]) == t * k


@pytest.mark.cuda
def test_cuda_combine_backward_dispatch_matches_plain(cuda, rng):
    """Combine's backward is a dispatch of the output's cotangent weighted
    by the routing weights (w != 1): the buffer gradient through the
    kernels equals the plain versions' bit for bit, at the training
    shape."""
    g, t, k, d, s, cap = 1, 4096, 2, 512, 18, 640
    slot = _t(rng.integers(0, 3, (g, t, k)).astype(np.int32)).to(cuda)
    valid = torch.ones((g, t, k), dtype=torch.int32, device=cuda)
    w = _t(rng.random((g, t, k)).astype(np.float32)).to(cuda)
    x = _t(rng.standard_normal((g, t, d)).astype(np.float32)) \
        .to(cuda, torch.bfloat16)
    buf, rank, keep, _, _ = dispatch_ref(x, torch.ones_like(w), slot, valid,
                                         s, cap)
    g_y = _t(rng.standard_normal((g, t, d)).astype(np.float32)) \
        .to(cuda, torch.bfloat16)
    grads = []
    for impl in ("cuda", "torch"):
        b = buf.clone().requires_grad_(True)
        y = dops.Combine.apply(b, w, slot, rank, keep, valid, impl)
        grads.append(torch.autograd.grad(y, b, g_y)[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dispatch_is_deterministic(cuda, rng, dtype):
    """No atomics: two calls at the training shape give the same bits."""
    g, t, k, d, s, cap = 1, 4096, 2, 512, 18, 640
    v = _t(rng.standard_normal((g, t, d)).astype(np.float32)).to(cuda, dtype)
    w = _t(rng.random((g, t, k)).astype(np.float32)).to(cuda)
    slot = _t(rng.integers(0, s, (g, t, k)).astype(np.int32)).to(cuda)
    valid = torch.ones((g, t, k), dtype=torch.int32, device=cuda)
    a = dops.dispatch(v, w, slot, valid, s, cap, impl="cuda")
    b = dops.dispatch(v, w, slot, valid, s, cap, impl="cuda")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _assert_scan_close(y, ry, st, rst):
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-4
    y, ry = y.float(), ry.float()
    if y.numel():
        bound = ulp * ry.abs() + 1e-4 * ry.abs().max()
        assert torch.all((y - ry).abs() <= bound), \
            (y - ry).abs().max().item()
    assert (st - rst).abs().max().item() <= 1e-4 * rst.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,n,with_s0", [
    (1, 2, 1, 16, False), (2, 3, 33, 16, True), (1, 4, 100, 64, True),
    (2, 2, 257, 64, False), (1, 1, 40, 128, True), (1, 2, 0, 32, True),
    # the rwkv6-1.6b layer, a T off the bf16 route's 64-token chunk, and
    # one chunk and a token
    (4, 32, 1024, 64, True), (1, 4, 1000, 64, False), (2, 3, 65, 64, True),
    (1, 2, 300, 128, False), (1, 3, 130, 32, True)])
def test_cuda_rwkv6_matches_plain(cuda, rng, dtype, b, h, t, n, with_s0):
    """Ragged T, every head size, model-range decays; the inputs are
    [B,T,H,N] activations seen through a transpose, as the model hands
    them over."""
    def act(lo=None, hi=None):
        a = rng.uniform(lo, hi, (b, t, h, n)) if lo is not None else \
            0.5 * rng.standard_normal((b, t, h, n))
        return _t(a.astype(np.float32)).to(cuda, dtype).transpose(1, 2)
    r, k, v = act(), act(), act()
    w = act(0.0113, 0.9997)
    u = _t((0.1 * rng.standard_normal((h, n))).astype(np.float32)).to(cuda)
    s0 = _t((0.1 * rng.standard_normal((b, h, n, n))).astype(np.float32)) \
        .to(cuda) if with_s0 else None
    reset_launches()
    y, st = rops.rwkv6(r, k, v, w, u, s0)
    assert LAUNCHES["rwkv6_scan"] == 1
    assert y.dtype == dtype and (t < 2 or y.stride() == r.stride())
    ry, rst = rwkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    _assert_scan_close(y, ry, st, rst)


@pytest.mark.cuda
@pytest.mark.parametrize("w_lo,w_hi", [(1e-6, 1e-5), (1e-6, 1.0),
                                       (1.0, 1.0)])
def test_cuda_rwkv6_extreme_decays(cuda, rng, w_lo, w_hi):
    """bf16 decays down to 1e-6 (a sub-chunk's cumulative log decay near
    -221) and exactly 1.0, at N 64 over several chunks: finite, and within
    the scan gate of the exact recurrence."""
    b, h, t, n = 2, 4, 200, 64
    r, k, v = (_t((0.5 * rng.standard_normal((b, h, t, n)))
                  .astype(np.float32)).to(cuda, torch.bfloat16)
               for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (b, h, t, n))
    if w_lo < w_hi:
        w[..., ::3] = 1.0
    w = _t(w.astype(np.float32)).to(cuda, torch.bfloat16)
    u = _t((0.1 * rng.standard_normal((h, n))).astype(np.float32)).to(cuda)
    s0 = _t((0.1 * rng.standard_normal((b, h, n, n))).astype(np.float32)) \
        .to(cuda)
    y, st = rops.rwkv6(r, k, v, w, u, s0)
    ry, rst = rwkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    _assert_scan_close(y, ry, st, rst)


@pytest.mark.cuda
def test_cuda_rwkv6_is_deterministic(cuda, rng):
    """No atomics: two calls at the rwkv6-1.6b layer give the same bits."""
    b, h, t, n = 4, 32, 1024, 64
    r, k, v = (_t((0.5 * rng.standard_normal((b, t, h, n)))
                  .astype(np.float32)).to(cuda, torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    w = _t(rng.uniform(0.0113, 0.9997, (b, t, h, n)).astype(np.float32)) \
        .to(cuda, torch.bfloat16).transpose(1, 2)
    u = _t((0.1 * rng.standard_normal((h, n))).astype(np.float32)).to(cuda)
    y1, s1 = rops.rwkv6(r, k, v, w, u)
    y2, s2 = rops.rwkv6(r, k, v, w, u)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def _mamba_args(dev, rng, dtype, b, h, t, p, n, with_h0, model_layout):
    """Softplus dt and A in [-2, -0.5]; x and dt seen through transposes
    and B, C as column slices of one tensor.  With ``model_layout`` x, B and
    C are column slices of one activation [B, T, H*P + 2N], x viewed as
    [B, H, T, P], as ``mamba_apply`` hands them over (a stride along T of
    H*P + 2N); else x is a transposed [B, T, H, P] tensor."""
    if model_layout:
        xbc = _t(rng.standard_normal((b, t, h * p + 2 * n))
                 .astype(np.float32)).to(dev, dtype)
        x = xbc[..., :h * p].reshape(b, t, h, p).transpose(1, 2)
        bm, c = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x = _t(rng.standard_normal((b, t, h, p)).astype(np.float32)) \
            .to(dev, dtype).transpose(1, 2)
    dt = _t(np.logaddexp(2.0 * rng.standard_normal((b, t, h)), 0)
            .astype(np.float32)).to(dev).transpose(1, 2)
    if not model_layout:
        bc = _t(rng.standard_normal((b, t, 2 * n)).astype(np.float32)) \
            .to(dev, dtype)
        bm, c = bc[..., :n], bc[..., n:]
    a = -_t(rng.uniform(0.5, 2.0, h).astype(np.float32)).to(dev)
    d = _t(rng.standard_normal(h).astype(np.float32)).to(dev)
    h0 = _t((0.1 * rng.standard_normal((b, h, p, n))).astype(np.float32)) \
        .to(dev) if with_h0 else None
    return x, dt, a, bm, c, d, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,p,n,with_h0,model_layout", [
    (1, 2, 1, 16, 16, False, False), (2, 3, 33, 16, 16, True, False),
    (1, 4, 100, 64, 64, True, False), (2, 2, 257, 64, 64, False, False),
    (1, 2, 40, 32, 128, True, False), (1, 2, 0, 8, 32, True, False),
    # the zamba2-7b layer, and a T off the bf16 route's 64-token chunk
    (2, 112, 1024, 64, 64, False, True), (1, 4, 1000, 64, 64, True, True),
    # two tiles of head channels; P off 8 (element-wise loads), and odd
    # (element-wise stores)
    (1, 3, 130, 80, 16, True, True), (1, 2, 70, 12, 32, False, True),
    (1, 3, 50, 7, 16, True, True)])
def test_cuda_mamba2_matches_plain(cuda, rng, dtype, b, h, t, p, n,
                                   with_h0, model_layout):
    """Ragged T, every state size, softplus dt, strided inputs."""
    x, dt, a, bm, c, d, h0 = _mamba_args(cuda, rng, dtype, b, h, t, p, n,
                                         with_h0, model_layout)
    reset_launches()
    y, hT = mops.mamba2(x, dt, a, bm, c, d, h0)
    assert LAUNCHES["mamba2_ssd"] == 1
    # y in x's layout: x's own strides where x is dense, else the dense
    # [B, T, H, P] order that x is a slice of
    layout = (t * h * p, p, h * p, 1) if model_layout else x.stride()
    assert y.dtype == dtype and (t < 2 or y.stride() == layout)
    ry, rhT = mamba2_ref(x, dt, a, bm, c, d, h0)
    torch.cuda.synchronize()
    _assert_scan_close(y, ry, hT, rhT)


@pytest.mark.cuda
def test_cuda_mamba2_is_deterministic(cuda, rng):
    """No atomics: two calls at the zamba2-7b layer give the same bits."""
    args = _mamba_args(cuda, rng, torch.bfloat16, 2, 112, 1024, 64, 64, True,
                       True)
    y1, h1 = mops.mamba2(*args)
    y2, h2 = mops.mamba2(*args)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
