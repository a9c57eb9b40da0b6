"""The port's MoE layer against the JAX package's ``models.moe``, on
``paper-moe-100m-smoke`` with the reference's own weights.

Integer routing outputs (slots, expert ids, phi, routed/kept counts, drops)
must be bit-equal; float outputs within 1e-5 on f32 activations (the
tolerance of tests/test_moe_dispatch.py) and within a bf16 tolerance on bf16
activations, where the fused combine accumulates in f32 while the JAX CPU
path adds in bf16.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro_torch.configs import get_arch
from repro_torch.models import bridge, moe

ARCH = "paper-moe-100m-smoke"
# jitted reference calls: eager Pallas interpret mode costs seconds a call
_j_route = jax.jit(j_moe.route, static_argnums=(4,))
_j_moe_ffn = jax.jit(j_moe.moe_ffn, static_argnums=(4,))


def _flags(cfg, fused, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, fused_gating=fused, fused_dispatch=fused, **kw))


@lru_cache(maxsize=None)
def _layer0():
    """Layer-0 MoE params of the reference init, both sides (f32)."""
    params = jax.jit(j_lm.init, static_argnums=0)(j_get_arch(ARCH),
                                                  jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], params["moe"])
    return jp, bridge.from_jax(jax.tree.map(np.asarray, jp))


def _plans(cfg_j, cfg_t, hot=False):
    """Identity plans, or (hot) an SBR plan splitting expert 0 over the
    two spare slots with fractions (0.4, 0.7, 1.0)."""
    jplan = j_moe.identity_plan(cfg_j, 1)
    slots, cum = np.asarray(jplan.slots[0]).copy(), \
        np.asarray(jplan.cum[0]).copy()
    if hot:
        e = cfg_j.moe.num_experts
        slots[0, :3] = [0, e, e + 1]
        cum[0, :3] = [0.4, 0.7, 1.0]
    return (jnp.asarray(slots), jnp.asarray(cum)), \
        (torch.from_numpy(slots).long(), torch.from_numpy(cum))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("hot", [False, True])
def test_route_matches_reference(rng, fused, hot):
    cfg_j, cfg_t = _flags(j_get_arch(ARCH), fused), _flags(get_arch(ARCH),
                                                           fused)
    jp, tp = _layer0()
    x = rng.standard_normal((12, cfg_t.d_model)).astype(np.float32)
    (js, jc), (ts, tc) = _plans(cfg_j, cfg_t, hot)
    ref = _j_route(jp["router"], jnp.asarray(x), js, jc, cfg_j, 7)
    got = moe.route(tp["router"], torch.tensor(x)[None], ts, tc, cfg_t,
                    torch.tensor([7]))
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(ref[1]),
                               atol=1e-6)
    if fused:
        np.testing.assert_array_equal(got[4][0].numpy(), np.asarray(ref[4]))
    if hot:
        assert (got[0] >= cfg_t.moe.num_experts).any()   # replicas used


def test_hash_unit_matches_uint32_wraparound():
    idx = np.array([0, 1, 7, 1000, 2 ** 20 + 3, 2 ** 31 - 1])
    np.testing.assert_array_equal(
        moe._hash_unit(torch.tensor(idx)).numpy(),
        np.asarray(j_moe._hash_unit(jnp.asarray(idx, jnp.int32))))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("t,cf", [(24, 1.25), (12, 8.0)])
def test_moe_ffn_matches_reference_f32(rng, fused, t, cf):
    """f32 activations: y within 1e-5, every metric bit-equal (t=24 at the
    default capacity drops assignments; cf=8 drops none)."""
    cfg_j = _flags(j_get_arch(ARCH), fused, capacity_factor=cf)
    cfg_t = _flags(get_arch(ARCH), fused, capacity_factor=cf)
    jp, tp = _layer0()
    x = rng.standard_normal((t, cfg_t.d_model)).astype(np.float32)
    (js, jc), (ts, tc) = _plans(cfg_j, cfg_t)
    y, met = _j_moe_ffn(jp, jnp.asarray(x), js, jc, cfg_j)
    yt, mt = moe.moe_ffn(tp, torch.tensor(x)[None], ts, tc, cfg_t,
                         torch.tensor([0]))
    for k in ("slot_counts", "kept_counts", "dropped", "expert_counts"):
        np.testing.assert_array_equal(mt[k][0].numpy(), np.asarray(met[k]),
                                      err_msg=k)
    if cf == 1.25:
        assert int(mt["dropped"][0]) > 0
    np.testing.assert_allclose(yt[0].numpy(), np.asarray(y), atol=1e-5)
    for k in ("aux_loss", "router_z"):
        np.testing.assert_allclose(mt[k][0].item(), float(met[k]),
                                   rtol=1e-5, atol=1e-6)


def test_moe_ffn_fused_bf16(rng):
    """bf16 activations, both flags on: drops and phi bit-equal, y within
    the bf16 tolerance (f32 combine vs the reference's bf16 adds)."""
    cfg_j, cfg_t = _flags(j_get_arch(ARCH), True), _flags(get_arch(ARCH),
                                                          True)
    jp, tp = _layer0()
    x = jnp.asarray(rng.standard_normal((24, cfg_t.d_model)), jnp.bfloat16)
    (js, jc), (ts, tc) = _plans(cfg_j, cfg_t)
    y, met = _j_moe_ffn(jp, x, js, jc, cfg_j)
    yt, mt = moe.moe_ffn(tp, bridge.from_jax(np.asarray(x))[None], ts, tc,
                         cfg_t, torch.tensor([0]))
    for k in ("slot_counts", "kept_counts", "dropped", "expert_counts"):
        np.testing.assert_array_equal(mt[k][0].numpy(), np.asarray(met[k]),
                                      err_msg=k)
    np.testing.assert_allclose(yt[0].float().numpy(),
                               np.asarray(y.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("t,cap", [(16, 4), (40, 5), (7, 4)])
def test_fused_and_argsort_dispatch_make_identical_drops(rng, t, cap):
    """Inside the port: the fused kernel family and the argsort pipeline
    drop exactly the same assignments and report the same metrics, per
    group, including groups that overflow."""
    g, k, s, d = 3, 2, 6, 8
    x = torch.tensor(rng.standard_normal((g, t, d)), dtype=torch.float32)
    slot = torch.tensor(rng.integers(0, 3, (g, t, k)), dtype=torch.int32)
    weight = torch.tensor(rng.random((g, t, k)), dtype=torch.float32)
    valid = torch.tensor(rng.random((g, t, k)) < 0.85)
    ident = lambda buf: buf * 2.0  # noqa: E731 - any per-row expert
    ya, ma = moe.dispatch_combine(x, slot, weight, ident, s, cap,
                                  valid=valid, fused=True)
    yb, mb = moe.dispatch_combine(x, slot, weight, ident, s, cap,
                                  valid=valid, fused=False)
    for key in ("slot_counts", "kept_counts", "dropped"):
        assert torch.equal(ma[key].long(), mb[key].long()), key
    assert int(ma["dropped"].sum()) > 0
    torch.testing.assert_close(ya, yb, atol=1e-5, rtol=1e-5)


def test_groupings_differ_only_by_capacity(rng):
    """The same tokens as B groups of 1 never drop (capacity 4 >= k) while
    one group of B may; without drops both give the same routing."""
    cfg = _flags(get_arch(ARCH), True)
    _, tp = _layer0()
    ts, tc = _plans(j_get_arch(ARCH), cfg)[1]
    x = torch.tensor(rng.standard_normal((4, 1, cfg.d_model)),
                     dtype=torch.float32)
    y_rows, m_rows = moe.moe_ffn(tp, x, ts, tc, cfg, torch.zeros(4).long())
    y_one, m_one = moe.moe_ffn(tp, x.reshape(1, 4, -1), ts, tc, cfg,
                               torch.zeros(1).long())
    assert int(m_rows["dropped"].sum()) == 0 == int(m_one["dropped"].sum())
    assert torch.equal(m_rows["expert_counts"].sum(0),
                       m_one["expert_counts"][0])
    torch.testing.assert_close(y_rows.reshape(4, -1), y_one[0], atol=1e-6,
                               rtol=1e-6)
