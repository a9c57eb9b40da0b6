"""The port's MoE kernels against the JAX package's.

On the CPU the port's wrappers take their plain torch versions; those are
held against the Pallas kernels run in interpret mode (the JAX package's own
CPU oracle) and against the jnp references.  The CUDA kernels themselves
are held against the plain versions on the card (``cuda`` marker; they skip
without a GPU).  Integer outputs must be bit-equal everywhere; float
tolerances are those of tests/test_moe_dispatch.py.
"""
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
    assert all(n == 0 for n in LAUNCHES.values())


def test_cuda_impl_refuses_cpu_tensors():
    x = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError):
        gops.gating(x, 2, impl="cuda")
    with pytest.raises(ValueError):
        dops.dispatch(x, torch.ones(1, 2, 2), torch.zeros((1, 2, 2),
                      dtype=torch.int32), torch.ones((1, 2, 2),
                      dtype=torch.int32), 4, 4, impl="cuda")


# ----------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("g,t,e,k", [(8, 1, 16, 2), (1, 8, 16, 2),
                                     (2, 300, 64, 8)])
def test_cuda_gating_matches_plain(cuda, rng, g, t, e, k):
    x = _t(rng.standard_normal((g, t, e)).astype(np.float32)).to(cuda)
    w, ids, cnt = gops.gating(x, k, impl="cuda")
    rw, rids, rcnt = gating_ref(x, k)
    assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)
    assert (w - rw).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,t,k,d,s,cap", [(8, 1, 2, 512, 18, 4),
                                           (1, 8, 2, 512, 18, 4),
                                           (3, 130, 8, 96, 80, 6)])
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
