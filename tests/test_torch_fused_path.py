"""The fused step and the vectorised Reshape controller in the port,
against the JAX package's (tests/test_fused_path.py).

* Inside the port (the reference's invariants): the fused and the
  granulated step make the same steps and the same Reshape decisions, the
  step path follows the live interactivity, the routing plan is uploaded
  again only when it changes, and fused gating trains as the unfused
  path.
* Against the reference, exactly (integers, and floats of the same numpy
  code): the microbatch metric merge, the vectorised reshaper and its loop
  specification (plans, migrations, events, backlog) under the same
  observations, and the fused gating route's slots, experts and φ
  histogram on the same inputs and weights (weights within 1e-6, the
  tolerance of tests/test_torch_moe.py).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs.base as j_base
import repro.core.reshape_moe as j_rm
import repro.core.skew as j_skew
from repro.configs import get_arch as j_get_arch
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.runtime.loop import _finalize_metrics as j_finalize
from repro.runtime.loop import _merge_metrics as j_merge
from repro_torch.configs import base as t_base
from repro_torch.configs import get_arch
from repro_torch.core import messages as M
from repro_torch.core import reshape_moe as rm
from repro_torch.core import skew as t_skew
from repro_torch.core.breakpoints import LocalBreakpoint
from repro_torch.core.skew import SkewParams
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import bridge
from repro_torch.models import moe as moe_lib
from repro_torch.runtime.loop import (LoopConfig, TrainLoop,
                                      _finalize_metrics, _merge_metrics)
from repro_torch.runtime.train import TrainHyper


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(cfg, step_path, reshaper=None, mb=2, seed=5, alpha=2.0):
    stream = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=8,
                         seed=seed, class_alpha=alpha)
    return TrainLoop(cfg, stream, TrainHyper(),
                     LoopConfig(microbatches=mb, step_path=step_path,
                                device="cpu"),
                     reshaper=reshaper)


def _reshaper(cfg):
    return rm.MoEReshaper(cfg, 2, ep_ranks=2,
                          params=SkewParams(eta=0.0, tau=0.15),
                          phase1_steps=1)


def test_fused_matches_granulated_with_reshape():
    """The reference's setting (capacity factor 1.0, 8 steps, phase-1 after
    one step): the same losses, loads, plans and Reshape events on both
    step paths (tests/test_torch_train.py holds 4 steps bit for bit)."""
    cfg = get_arch("olmoe-1b-7b-smoke")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    rs_f, rs_g = _reshaper(cfg), _reshaper(cfg)
    lf = _loop(cfg, "fused", rs_f)
    lg = _loop(cfg, "granulated", rs_g)
    hf, hg = lf.run(8), lg.run(8)
    assert int(lf.state["step"]) == int(lg.state["step"]) == 8
    for a, b in zip(hf, hg):
        assert abs(a["loss"] - b["loss"]) < 1e-4
        np.testing.assert_array_equal(a["expert_counts"], b["expert_counts"])
    assert rs_f.iterations == rs_g.iterations > 0
    np.testing.assert_array_equal(lf.plan_slots, lg.plan_slots)
    np.testing.assert_array_equal(lf.plan_cum, lg.plan_cum)
    assert [(e.layer, e.hot_expert) for e in rs_f.events] == \
        [(e.layer, e.hot_expert) for e in rs_g.events]


def test_adaptive_granularity_selection():
    cfg = get_arch("gemma3-1b-smoke")
    stream = TokenStream(vocab=cfg.vocab, seq_len=8, global_batch=2)
    loop = TrainLoop(cfg, stream, TrainHyper(),
                     LoopConfig(microbatches=1, device="cpu"))
    assert loop._fused_eligible()                 # idle controller -> fused
    loop.local_bps.append(LocalBreakpoint("bp", lambda m: False))
    assert not loop._fused_eligible()             # breakpoint -> granulated
    loop.local_bps.clear()
    loop.controller.mailbox.put(M.inspect())
    assert not loop._fused_eligible()             # pending message
    loop.controller.mailbox.get_nowait()
    loop.controller.paused = True
    assert not loop._fused_eligible()             # paused
    loop.controller.paused = False
    loop.lc.step_path = "granulated"
    assert not loop._fused_eligible()             # forced off


def test_plan_cache_reuploads_only_on_change():
    loop = _loop(get_arch("olmoe-1b-7b-smoke"), "auto")
    dev0 = loop._plan_args()
    # same values (fresh copies, as the reshaper returns) -> cache kept
    loop._set_plan(loop.plan_slots.copy(), loop.plan_cum.copy())
    assert loop._plan_args() is dev0
    new_cum = loop.plan_cum.copy()
    new_cum[0, 0, 0] = 0.5
    loop._set_plan(loop.plan_slots.copy(), new_cum)
    dev1 = loop._plan_args()
    assert dev1 is not dev0
    assert float(dev1[1][0, 0, 0]) == 0.5
    assert isinstance(dev1[0], torch.Tensor) and dev1[0].dtype == torch.long


def test_merge_metrics_unbiased_mean():
    mbs = [{"loss": np.float32(v), "n": np.float32(1.0)}
           for v in (1.0, 2.0, 3.0, 4.0)]
    outs = []
    for merge, finalize in ((_merge_metrics, _finalize_metrics),
                            (j_merge, j_finalize)):
        acc = {}
        for m in mbs:
            acc = merge(acc, m)
        outs.append(finalize(acc, len(mbs)))
    assert outs[0] == outs[1]
    assert abs(outs[0]["loss"] - 2.5) < 1e-6      # a running (a+b)/2: 3.125
    assert outs[0]["n"] == 4.0                    # non-mean keys summed


def test_skewparams_default_not_shared():
    cfg = get_arch("olmoe-1b-7b-smoke")
    a = rm.MoEReshaper(cfg, 2, ep_ranks=2)
    default_tau = a.params.tau
    a.params.tau = 99.0                           # what _apply_updates does
    b = rm.MoEReshaper(cfg, 2, ep_ranks=2)
    assert b.params.tau == default_tau
    assert a.params is not b.params


# ------------------------------------------------ vectorised vs loop specs

def _mk_rs(cls, L=4, E=16, R=4, ranks=4, mode="sbr", ref=False):
    base, skew = (j_base, j_skew) if ref else (t_base, t_skew)
    cfg = base.ArchConfig(name="t", family="moe", num_layers=L, d_model=64,
                          n_heads=2, n_kv_heads=2, d_ff=256, vocab=256,
                          moe=base.MoECfg(num_experts=E, top_k=2,
                                          expert_d_ff=256, max_replicas=R))
    return cls(cfg, L, ep_ranks=ranks,
               params=skew.SkewParams(eta=0.0, tau=0.1), phase1_steps=1,
               mode=mode)


def _randomize(rss, rng, steps=3):
    """Drive real mitigation steps on every reshaper in ``rss`` with the
    same loads, so their plans leave the identity state."""
    L, E = rss[0].nl, rss[0].cfg.moe.num_experts
    for _ in range(steps):
        counts = rng.gamma(1.0, 100.0, (L, E)) + np.eye(L, E) * 5000
        dropped = rng.integers(0, 50, L)
        for rs in rss:
            rs.observe(counts, dropped)
            rs.step()


def test_vectorized_methods_match_loop_refs():
    rng = np.random.default_rng(0)
    for (L, E, R, ranks) in [(2, 8, 4, 2), (4, 16, 2, 4), (8, 32, 4, 8)]:
        rs = _mk_rs(rm.MoEReshaper, L, E, R, ranks)
        jrs = _mk_rs(j_rm.MoEReshaper, L, E, R, ranks, ref=True)
        _randomize([rs, jrs], rng)
        np.testing.assert_array_equal(rs.plan_slots, jrs.plan_slots)
        np.testing.assert_array_equal(rs.plan_cum, jrs.plan_cum)
        np.testing.assert_array_equal(rs.rank_loads_all(),
                                      jrs.rank_loads_all())
        for l in range(L):
            np.testing.assert_allclose(
                rs.rank_loads(l), rm.rank_loads_loop(rs, l), rtol=1e-6)
            for e in range(E):
                assert abs(rs._current_frac(l, e) -
                           rm.current_frac_loop(rs, l, e)) < 1e-9
        np.testing.assert_allclose(
            rs.rank_loads_all(),
            np.stack([rm.rank_loads_loop(rs, l) for l in range(L)]),
            rtol=1e-6)
        loads = rs.rank_loads(0)
        hot = int(np.argmax(rs._ema_expert[0]))
        helpers = [h for h in range(ranks)
                   if h != rs.layout.rank_of_expert(hot)][:R - 1]
        if helpers:
            ref_slots, ref_cum = rm.waterfill_row_loop(
                rs, 0, hot, helpers, loads, boost=1.3)
            rs._waterfill(0, hot, helpers, loads, boost=1.3)
            np.testing.assert_array_equal(rs.plan_slots[0, hot], ref_slots)
            np.testing.assert_array_equal(rs.plan_cum[0, hot], ref_cum)


@pytest.mark.parametrize("mode", ["sbr", "sbk"])
def test_full_step_decisions_match_loop_reshaper(mode):
    """The batched step() makes the sequential LoopReshaper's decisions bit
    for bit, and the reference's reshaper makes the same ones."""
    rng = np.random.default_rng(1)
    vec = _mk_rs(rm.MoEReshaper, 8, 32, 4, 8, mode)
    ref = _mk_rs(rm.LoopReshaper, 8, 32, 4, 8, mode)
    jvec = _mk_rs(j_rm.MoEReshaper, 8, 32, 4, 8, mode, ref=True)

    def migs(ms):
        return [(m.layer, m.src_slot, m.dst_slot) for m in ms]

    for _ in range(8):
        counts = rng.gamma(1.0, 100.0, (8, 32)) + np.eye(8, 32) * 4000
        dropped = rng.integers(0, 50, 8)
        outs = []
        for rs in (vec, ref, jvec):
            rs.observe(counts, dropped)
            outs.append(rs.step())
        for ps, pc, mg in outs[1:]:
            np.testing.assert_array_equal(outs[0][0], ps)
            np.testing.assert_array_equal(outs[0][1], pc)
            assert migs(outs[0][2]) == migs(mg)
    for other in (ref, jvec):
        assert vec.active == other.active
        assert vec.spare_owner == other.spare_owner
        np.testing.assert_array_equal(vec.backlog, other.backlog)
        assert [(e.layer, e.hot_expert, e.fraction, e.phase)
                for e in vec.events] == \
            [(e.layer, e.hot_expert, e.fraction, e.phase)
             for e in other.events]


# ------------------------------------------------------- fused gating path

def test_fused_gating_route_matches_topk():
    arch = "olmoe-1b-7b-smoke"
    cfg = get_arch(arch)
    cfg_f = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, fused_gating=True))
    cfg_j = dataclasses.replace(
        j_get_arch(arch),
        moe=dataclasses.replace(j_get_arch(arch).moe, fused_gating=True))
    rng = np.random.default_rng(0)
    t, dm = 64, cfg.d_model
    x = rng.standard_normal((t, dm)).astype(np.float32)
    w = (rng.standard_normal((dm, cfg.moe.num_experts)) * 0.1).astype(
        np.float32)
    plan = moe_lib.identity_plan(cfg, 1, device="cpu")
    off = torch.zeros(1, dtype=torch.long)
    xt, wt = torch.from_numpy(x)[None], torch.from_numpy(w)
    s0, w0, p0, e0, c0 = moe_lib.route(wt, xt, plan.slots[0], plan.cum[0],
                                       cfg, off)
    s1, w1, p1, e1, c1 = moe_lib.route(wt, xt, plan.slots[0], plan.cum[0],
                                       cfg_f, off)
    assert c0 is None and c1 is not None
    assert torch.equal(e0, e1) and torch.equal(s0, s1)
    torch.testing.assert_close(w0, w1, atol=1e-6, rtol=0)
    # the kernel's free histogram == scatter-add over chosen experts
    hist = np.zeros(cfg.moe.num_experts, np.int32)
    np.add.at(hist, e1.numpy().reshape(-1), 1)
    np.testing.assert_array_equal(c1[0].numpy(), hist)

    jplan = j_moe.identity_plan(cfg_j, 1)
    js, jw, _, je, jc = jax.jit(j_moe.route, static_argnums=(4,))(
        jnp.asarray(w), jnp.asarray(x), jplan.slots[0], jplan.cum[0], cfg_j)
    np.testing.assert_array_equal(s1[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(e1[0].numpy(), np.asarray(je))
    np.testing.assert_array_equal(c1[0].numpy(), np.asarray(jc))
    np.testing.assert_allclose(w1[0].numpy(), np.asarray(jw), atol=1e-6)

    # gradients flow to the router through the probs re-gather
    wr = wt.clone().requires_grad_(True)
    _, wgt, probs, _, _ = moe_lib.route(wr, xt, plan.slots[0], plan.cum[0],
                                        cfg_f, off)
    (wgt.sum() + probs.sum()).backward()
    assert float(wr.grad.abs().sum()) > 0


def test_fused_gating_training_matches():
    cfg = get_arch("olmoe-1b-7b-smoke")
    cfg_f = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, fused_gating=True))
    h0 = _loop(cfg, "fused", mb=2, alpha=0.0).run(3)
    h1 = _loop(cfg_f, "fused", mb=2, alpha=0.0).run(3)
    for a, b in zip(h0, h1):
        assert abs(a["loss"] - b["loss"]) < 1e-4
        np.testing.assert_array_equal(a["expert_counts"],
                                      b["expert_counts"])
