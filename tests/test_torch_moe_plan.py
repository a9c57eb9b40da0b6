"""The MoE routing plan in the port against the JAX package's
(tests/test_moe_plan.py): plan-driven splits, state migration with a plan
swap, and the reshaper on skewed loads, on ``olmoe-1b-7b-smoke`` (8
experts top-2, 2 spare slots) with the reference's own weights.

Integers (slot counts, kept counts, drops, expert ids, plans, migrations)
equal the reference's exactly; the layer's output within 1e-5 on f32
activations (the tolerance of tests/test_torch_moe.py and
tests/test_moe_dispatch.py).  Inside the port, as in the reference: the
identity plan leaves the spare slots empty, an SBR split sends about its
fraction to the replica, migration plus split keeps the function, and the
runtime migrate equals the numpy one.
"""
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core.reshape_moe as j_rm
from repro.configs import get_arch as j_get_arch
from repro.core.skew import SkewParams as JSkewParams
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro_torch.configs import get_arch
from repro_torch.core.reshape_moe import (Migration, MoEReshaper,
                                          SlotLayout, apply_migrations_np)
from repro_torch.core.skew import SkewParams
from repro_torch.models import bridge
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.runtime.train import TrainHyper, build_grad_step

ARCH = "olmoe-1b-7b-smoke"
CFG, CFG_J = get_arch(ARCH), j_get_arch(ARCH)
ATOL = 1e-5
INTS = ("slot_counts", "kept_counts", "dropped", "expert_counts")
_j_moe_ffn = jax.jit(j_moe.moe_ffn, static_argnums=(4,))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def _params():
    """The reference's init (numpy) and the layer-0 MoE params."""
    params = jax.tree.map(np.asarray, jax.jit(
        j_lm.init, static_argnums=0)(CFG_J, jax.random.PRNGKey(0)))
    return params, {k: v[0] for k, v in params["moe"].items()}


def _x(key, t):
    return np.array(jax.random.normal(jax.random.PRNGKey(key),
                                      (t, CFG.d_model)))


def _identity():
    plan = moe_lib.identity_plan(CFG, 1, device="cpu")
    return np.asarray(plan.slots[0]).copy(), np.asarray(plan.cum[0]).copy()


def _both(p, x, slots, cum):
    """The layer on both packages: (port y, port metrics), (ref y, ref
    metrics), after holding the integers equal and y within ATOL."""
    tp = bridge.from_jax(p, device="cpu")
    yt, mt = moe_lib.moe_ffn(tp, torch.from_numpy(x)[None],
                             torch.from_numpy(slots).long(),
                             torch.from_numpy(cum), CFG, torch.tensor([0]))
    yj, mj = _j_moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jnp.asarray(slots), jnp.asarray(cum),
                        CFG_J)
    for k in INTS:
        np.testing.assert_array_equal(mt[k][0].numpy(), np.asarray(mj[k]),
                                      err_msg=k)
    np.testing.assert_allclose(yt[0].numpy(), np.asarray(yj), atol=ATOL)
    return yt[0].numpy(), {k: v[0].numpy() for k, v in mt.items()}


def test_identity_plan_routes_home():
    slots, cum = _identity()
    y, m = _both(_params()[1], _x(1, 64), slots, cum)
    # spare slots (8, 9) receive nothing under the identity plan
    assert m["slot_counts"][8:].sum() == 0
    assert np.isfinite(y).all()


def _split0(slots, cum, frac=0.5):
    """Expert 0 split: ``frac`` of its tokens to spare slot 8, the rest
    home."""
    slots, cum = slots.copy(), cum.copy()
    slots[0, 0], slots[0, 1:] = 8, 0
    cum[0, :] = 1.0
    cum[0, 0] = frac
    return slots, cum


def test_sbr_split_fraction_obeyed():
    slots, cum = _split0(*_identity())
    _, m = _both(_params()[1], _x(2, 512), slots, cum)
    counts = m["slot_counts"]
    routed_0 = counts[0] + counts[8]
    assert routed_0 > 20
    assert 0.3 < counts[8] / routed_0 < 0.7      # ~50% split via hashing


def test_migration_plus_split_preserves_function():
    """SBR correctness: copying expert 0's state into the spare slot and
    splitting its tokens gives the outputs of no mitigation."""
    p = _params()[1]
    p2 = {k: v.copy() for k, v in p.items()}
    for k in ("w_gate", "w_up", "w_down"):
        p2[k][8] = p2[k][0]
    base_slots, base_cum = _identity()
    slots, cum = _split0(base_slots, base_cum)
    x = _x(3, 256)
    y_base, mb = _both(p, x, base_slots, base_cum)
    y_split, ms = _both(p2, x, slots, cum)
    assert int(mb["dropped"]) == 0 and int(ms["dropped"]) == 0
    assert ms["slot_counts"][8] > 0
    np.testing.assert_allclose(y_base, y_split, atol=1e-4, rtol=1e-3)


def test_slot_layout_invariants():
    lay, jlay = SlotLayout(num_experts=64, ep_ranks=16), \
        j_rm.SlotLayout(num_experts=64, ep_ranks=16)
    assert lay.slots_per_rank == jlay.slots_per_rank == 5
    assert lay.num_slots == jlay.num_slots == 80
    for e in range(64):
        s = lay.home_slot(e)
        assert s == jlay.home_slot(e)
        assert lay.rank_of_slot(s) == lay.rank_of_expert(e)
    spares = {lay.spare_slot(r) for r in range(16)}
    assert spares == {jlay.spare_slot(r) for r in range(16)}
    homes = {lay.home_slot(e) for e in range(64)}
    assert not (spares & homes)
    assert len(spares | homes) == 80


def test_reshaper_mitigates_synthetic_skew():
    """The full olmoe-1b-7b's 64 experts over 16 ranks, expert 0 red hot:
    the peak rank load falls and the balance improves, with the reference
    reshaper's plans and migrations step for step."""
    rs = MoEReshaper(get_arch("olmoe-1b-7b"), n_moe_layers=2, ep_ranks=16,
                     params=SkewParams(eta=0.0, tau=0.2), phase1_steps=1)
    jrs = j_rm.MoEReshaper(j_get_arch("olmoe-1b-7b"), n_moe_layers=2,
                           ep_ranks=16,
                           params=JSkewParams(eta=0.0, tau=0.2),
                           phase1_steps=1)
    rng = np.random.default_rng(0)
    e = get_arch("olmoe-1b-7b").moe.num_experts
    before = None
    for step in range(8):
        c = rng.integers(50, 100, (2, e)).astype(float)
        c[:, 0] = 4000.0                 # expert 0 (rank 0) red hot
        rs.observe(c)
        jrs.observe(c)
        slots, cum, migs = rs.step()
        js, jc, jm = jrs.step()
        np.testing.assert_array_equal(slots, js)
        np.testing.assert_array_equal(cum, jc)
        assert [(m.layer, m.src_slot, m.dst_slot) for m in migs] == \
            [(m.layer, m.src_slot, m.dst_slot) for m in jm]
        if step == 0:
            before = rs.rank_loads(0).copy()
            assert migs, "expected a state migration for the hot expert"
    after = rs.rank_loads(0)
    np.testing.assert_array_equal(after, jrs.rank_loads(0))
    assert after.max() < before.max()    # peak load reduced
    assert after.min() / after.max() > before.min() / before.max()


def test_apply_migrations_np():
    leaf = np.arange(2 * 4 * 3).reshape(2, 4, 3).astype(float)
    out = apply_migrations_np(leaf, [Migration(1, 0, 3)])
    np.testing.assert_array_equal(out[1, 3], leaf[1, 0])
    np.testing.assert_array_equal(out[0], leaf[0])
    np.testing.assert_array_equal(
        out, j_rm.apply_migrations_np(leaf, [j_rm.Migration(1, 0, 3)]))


def test_runtime_migrate_matches_numpy():
    """The loop's migrate on the reference's initial state (params and
    AdamW moments): every expert leaf as the numpy migration, the state
    it was given unchanged."""
    params = _params()[0]
    state = {"params": bridge.from_jax(params, device="cpu")}
    state["opt"] = adamw.init(state["params"])
    state["step"] = torch.zeros((), dtype=torch.int32)
    for k in ("w_gate", "w_up", "w_down"):         # distinct moments
        state["opt"].m["moe"][k].copy_(state["params"]["moe"][k] * 2)
    _, _, migrate = build_grad_step(CFG, TrainHyper())
    arr = np.asarray([[0, 1, 9], [1, 2, 8]], np.int32)
    new = migrate(state, arr)
    migs = [Migration(0, 1, 9), Migration(1, 2, 8)]
    for k in ("w_gate", "w_up", "w_down"):
        ref = apply_migrations_np(params["moe"][k], migs)
        np.testing.assert_array_equal(new["params"]["moe"][k].numpy(), ref)
        np.testing.assert_array_equal(
            new["opt"].m["moe"][k].numpy(),
            apply_migrations_np(state["opt"].m["moe"][k].numpy(), migs))
        np.testing.assert_array_equal(state["params"]["moe"][k].numpy(),
                                      params["moe"][k])
