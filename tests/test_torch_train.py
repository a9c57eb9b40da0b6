"""The port's training slice against the JAX package's: the dispatch and
combine gradients, ``loss_fn`` and its gradients, ``TrainLoop`` steps,
Reshape's plans, and, inside the port, granulated ≡ fused and recovery.

Reference numerics.  The reference's fused dispatch on the CPU defaults to
its jnp form, whose combine adds the k terms in bf16; the Pallas kernel
that the port's CUDA kernel replaces (and the port's plain version) adds
them in f32 and rounds once.  The parity tests therefore run the
reference's dispatch and combine through its Pallas kernels in interpret
mode (the ``pallas_dispatch`` fixture), as the JAX package's own kernel
tests do on the CPU.  Even so the two frameworks round bf16 at different
points (XLA drops bf16 round trips inside a compiled function, e.g. it
feeds an un-rounded residual to the next RMSNorm), so hidden states past
the first layer differ by bf16 ulps, and a router near-tie inside that
noise can send a token elsewhere (ROADMAP, queue 3).  The model and
inputs below are the reference's own training-parity setup
(``olmoe-1b-7b-smoke``, seq 32, global batch 8, 2 microbatches,
tests/test_moe_dispatch.py), where the first step routes alike in both.

Tolerances: the first step's loss within 1e-3 and its gradient norm within
1e-3 relative; every leaf's gradient within 3e-2 relative L2 error (the
backward runs in bf16 and the two frameworks round it at other points: the
leaves differ by 0.4-2.0 % on these inputs, uniformly across leaves, while
the loss agrees to 1e-4); a three-step trajectory within 2e-2 — 2.5x the
gap of 7.84e-3 that the reference shows against itself over three steps
when only its dispatch implementation changes (a one-ulp parameter
difference flips one capacity drop at step 1).  Run as a script, this
module prints that gap step by step:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_train.py
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.moe_dispatch.ops as j_dops
from repro.configs import get_arch as j_get_arch
from repro.core.reshape_moe import MoEReshaper as JMoEReshaper
from repro.core.skew import SkewParams as JSkewParams
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import moe as j_moe
from repro.runtime import train as j_train
from repro.runtime.loop import LoopConfig as JLoopConfig
from repro.runtime.loop import TrainLoop as JTrainLoop
from repro_torch.configs import get_arch
from repro_torch.core import messages as M
from repro_torch.core.reshape_moe import MoEReshaper
from repro_torch.core.skew import SkewParams
from repro_torch.data.synthetic import TokenStream
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.moe_dispatch import ops as dops
from repro_torch.launch import train as train_cli
from repro_torch.models import bridge
from repro_torch.models import moe
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import train
from repro_torch.runtime.loop import LoopConfig, TrainLoop

ARCH = "olmoe-1b-7b-smoke"
SEQ, BATCH, N_MB, SEED, ALPHA = 32, 8, 2, 5, 2.0


@pytest.fixture
def pallas_dispatch(monkeypatch):
    """The reference's fused dispatch/combine through its Pallas kernels
    (interpret mode); compiled functions traced under it are dropped
    afterwards, so no other test sees them."""
    monkeypatch.setattr(j_dops, "_resolve", lambda impl: "interpret")
    yield
    jax.clear_caches()


def _fused(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, fused_gating=True, fused_dispatch=True))


def _cfgs(arch=ARCH):
    return _fused(j_get_arch(arch)), _fused(get_arch(arch))


def _reshapers(cj, ct):
    return (JMoEReshaper(cj, cj.num_layers, ep_ranks=2,
                         params=JSkewParams(eta=0.0, tau=0.2)),
            MoEReshaper(ct, ct.num_layers, ep_ranks=2,
                        params=SkewParams(eta=0.0, tau=0.2)))


def _loops(cj, ct, step_path="fused", reshape=True):
    """A JAX TrainLoop and a port TrainLoop starting from the JAX state."""
    rj, rt = _reshapers(cj, ct) if reshape else (None, None)
    jl = JTrainLoop(cj, JTokenStream(vocab=cj.vocab, seq_len=SEQ,
                                     global_batch=BATCH, seed=SEED,
                                     class_alpha=ALPHA),
                    j_train.TrainHyper(),
                    JLoopConfig(microbatches=N_MB, step_path=step_path),
                    reshaper=rj)
    tl = TrainLoop(ct, TokenStream(vocab=ct.vocab, seq_len=SEQ,
                                   global_batch=BATCH, seed=SEED,
                                   class_alpha=ALPHA),
                   train.TrainHyper(),
                   LoopConfig(microbatches=N_MB, step_path=step_path,
                              device="cpu"), reshaper=rt)
    tl.state = bridge.state_from_jax(jax.tree.map(np.asarray, jl.state),
                                     device="cpu")
    return jl, tl


# ---------------------------------------------------- dispatch / combine

def _routing(rng, t, k, s, cap):
    slot = rng.integers(0, s, (t, k)).astype(np.int32)
    slot[: t // 2, 0] = 1                       # one hot slot overflows
    valid = (rng.random((t, k)) < 0.9).astype(np.int32)
    return slot, valid


def test_dispatch_combine_gradients_match_reference(rng, pallas_dispatch):
    """dv, dw (combine's weights) and d_buf (the expert buffer's
    cotangent) through the port's Functions, against ``jax.grad`` through
    the reference's ``dispatch_combine``; integers exact."""
    t, d, k, s, cap = 24, 16, 2, 6, 5
    slot, valid = _routing(rng, t, k, s, cap)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.random((t, k)).astype(np.float32)
    z = np.zeros((s, cap, d), np.float32)
    sc = rng.standard_normal((s, 1, 1)).astype(np.float32)
    g = rng.standard_normal((t, d)).astype(np.float32)

    def j_loss(x, w, z):
        y, m = j_dops.dispatch_combine(x, jnp.asarray(slot), w,
                                       lambda b: b * sc + z, s, cap,
                                       valid=jnp.asarray(valid))
        return jnp.sum(y * g), m

    (_, jm), jg = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                             has_aux=True))(
        *map(jnp.asarray, (x, w, z)))
    tx, tw, tz = (torch.from_numpy(a)[None].requires_grad_(True)
                  for a in (x, w, z))
    ts, tv = (torch.from_numpy(a)[None] for a in (slot, valid))
    ones = torch.ones((1, t, k))
    buf, rank, keep, routed, kept = dops.Dispatch.apply(
        tx, ones, ts, tv, s, cap, "torch")
    y = dops.Combine.apply(buf * torch.from_numpy(sc) + tz, tw, ts, rank,
                           keep, tv, "torch")
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(routed[0].numpy(),
                                  np.asarray(jm["slot_counts"]))
    np.testing.assert_array_equal(kept[0].numpy(),
                                  np.asarray(jm["kept_counts"]))
    assert int(valid.sum() - keep.sum()) == int(jm["dropped"])
    for got, ref in zip((tx, tw, tz), jg):
        np.testing.assert_allclose(got.grad[0].numpy(), np.asarray(ref),
                                   atol=1e-5)
    # the plain version under autograd gives the same gradients
    px, pw, pz = (torch.from_numpy(a)[None].requires_grad_(True)
                  for a in (x, w, z))
    py, _ = dops.dispatch_combine(
        px, ts, pw, lambda b: b * torch.from_numpy(sc) + pz, s, cap,
        valid=tv, impl="torch")
    (py * torch.from_numpy(g)).sum().backward()
    for a, b in ((px, tx), (pw, tw), (pz, tz)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-6)


def test_dispatch_weight_gradient_matches_reference(rng, pallas_dispatch):
    """dv and dw of dispatch alone (per-assignment weights that require a
    gradient), against the reference's ``custom_vjp``."""
    t, d, k, s, cap = 20, 8, 2, 5, 6
    slot, valid = _routing(rng, t, k, s, cap)
    v = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.random((t, k)).astype(np.float32)
    g = rng.standard_normal((s, cap, d)).astype(np.float32)
    bt = j_dops.block_rows(t)

    def j_loss(v, w):
        buf = j_dops.dispatch(v, w, jnp.asarray(slot), jnp.asarray(valid),
                              s, cap, "interpret", bt)[0]
        return jnp.sum(buf * g)

    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(v),
                                                   jnp.asarray(w))
    tv_, tw = (torch.from_numpy(a)[None].requires_grad_(True)
               for a in (v, w))
    buf = dops.Dispatch.apply(tv_, tw, torch.from_numpy(slot)[None],
                              torch.from_numpy(valid)[None], s, cap,
                              "torch")[0]
    (buf * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tv_, tw), jg):
        np.testing.assert_allclose(got.grad[0].numpy(), np.asarray(ref),
                                   atol=1e-5)


# ------------------------------------------------------------- loss_fn

def test_loss_and_grads_match_reference(rng, pallas_dispatch):
    cj, ct = _cfgs()
    state = jax.jit(j_train.make_state, static_argnums=0)(
        cj, jax.random.PRNGKey(0))
    # the first microbatch of the TrainLoop tests' first step
    tokens = JTokenStream(vocab=cj.vocab, seq_len=SEQ, global_batch=BATCH,
                          seed=SEED, class_alpha=ALPHA).next()["tokens"]
    tokens = tokens[:BATCH // N_MB]
    jplan = j_moe.identity_plan(cj, cj.num_layers)

    def j_loss(p):
        return j_train.loss_fn(p, {"tokens": jnp.asarray(tokens)}, cj,
                               j_train.TrainHyper(), jplan, 0)

    (jl, jm), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        state["params"])
    tp = bridge.from_jax(jax.tree.map(np.asarray, state["params"]), "cpu")
    tplan = moe.identity_plan(ct, ct.num_layers, device="cpu")
    tl, tm, tg = train.value_and_grad(
        tp, {"tokens": torch.from_numpy(tokens)}, ct, train.TrainHyper(),
        tplan, 0)
    for key in ("expert_counts", "slot_counts", "dropped"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))
    assert abs(float(tl) - float(jl)) < 1e-3
    np.testing.assert_allclose(tm["aux_loss"].numpy(),
                               np.asarray(jm["aux_loss"]), rtol=1e-3)
    for got, ref in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == torch.float32
        err = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
        assert err < 3e-2, err


# ------------------------------------------------------------ TrainLoop

def test_first_step_matches_reference(pallas_dispatch):
    jl, tl = _loops(*_cfgs())
    hj, ht = jl.run(1)[0], tl.run(1)[0]
    for key in ("expert_counts", "slot_counts", "dropped"):
        np.testing.assert_array_equal(ht[key], hj[key])
    assert abs(ht["loss"] - hj["loss"]) < 1e-3
    assert abs(ht["grad_norm"] - hj["grad_norm"]) < 1e-3 * hj["grad_norm"]


def test_three_step_trajectory_tracks_reference(pallas_dispatch):
    jl, tl = _loops(*_cfgs())
    hj, ht = jl.run(3), tl.run(3)
    assert len(hj) == len(ht) == 3
    for a, b in zip(hj, ht):
        assert abs(a["loss"] - b["loss"]) < 2e-2
    assert jl.reshaper.iterations == tl.reshaper.iterations


def test_reshape_plans_match_reference(rng):
    """Given the same phi stream (and drop counts), the copied reshaper
    makes the reference's decisions: plans, migrations and events."""
    cj, ct = _cfgs("paper-moe-100m-smoke")
    rj, rt = _reshapers(cj, ct)
    e = ct.moe.num_experts
    for step in range(12):
        hot = rng.integers(0, e)
        counts = rng.integers(0, 20, (ct.num_layers, e)).astype(np.int32)
        counts[:, hot] += 200 if step < 8 else 0
        dropped = rng.integers(0, 30, (ct.num_layers,)).astype(np.int32)
        rj.observe(counts, dropped)
        rt.observe(counts, dropped)
        (js, jc, jm), (ts, tc, tm) = rj.step(), rt.step()
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tc, jc)
        assert [(m.layer, m.src_slot, m.dst_slot) for m in tm] == \
            [(m.layer, m.src_slot, m.dst_slot) for m in jm]
    assert rt.iterations == rj.iterations > 0
    assert [(ev.layer, ev.hot_expert) for ev in rt.events] == \
        [(ev.layer, ev.hot_expert) for ev in rj.events]


def _port_loop(ct, step_path="auto", ckpt_every=0, ckpt_dir="",
               reshape=True):
    rs = MoEReshaper(ct, ct.num_layers, ep_ranks=2,
                     params=SkewParams(eta=0.0, tau=0.15), phase1_steps=1) \
        if reshape else None
    kw = dict(ckpt_dir=ckpt_dir) if ckpt_dir else {}
    return TrainLoop(ct, TokenStream(vocab=ct.vocab, seq_len=SEQ,
                                     global_batch=BATCH, seed=3,
                                     class_alpha=ALPHA),
                     train.TrainHyper(),
                     LoopConfig(microbatches=N_MB, step_path=step_path,
                                ckpt_every=ckpt_every, device="cpu", **kw),
                     reshaper=rs)


def test_granulated_equals_fused():
    """The two step paths give the same steps bit for bit: the same
    metrics, the same Reshape decisions and the same parameters."""
    ct = _fused(get_arch(ARCH))
    ct = dataclasses.replace(ct, moe=dataclasses.replace(
        ct.moe, capacity_factor=1.0))
    lf, lg = _port_loop(ct, "fused"), _port_loop(ct, "granulated")
    hf, hg = lf.run(4), lg.run(4)
    for a, b in zip(hf, hg):
        assert a["loss"] == b["loss"]
        for key in ("expert_counts", "slot_counts", "dropped"):
            np.testing.assert_array_equal(a[key], b[key])
    assert lf.reshaper.iterations == lg.reshaper.iterations > 0
    np.testing.assert_array_equal(lf.plan_slots, lg.plan_slots)
    for a, b in zip(tree_leaves(lf.state["params"]),
                    tree_leaves(lg.state["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(lf.state["opt"].m),
                    tree_leaves(lg.state["opt"].m)):
        assert torch.equal(a, b)


def _session(loop):
    """A user session, queued before the loop polls: pause, inspect while
    paused, a hot lr update, resume."""
    ctl = loop.controller
    for msg in (M.pause(), M.inspect(), M.update(lr_scale=0.3), M.resume()):
        ctl.send(msg)


def test_pause_update_crash_recover_bit_identical(tmp_path):
    """The port's counterpart of examples/interactive_control.py: run A
    trains 6 steps with a pause, an inspect, a hot lr update and a resume
    after step 2; run B does the same, crashes after step 3, recovers from
    the checkpoint of step 2 and the durable control log (which replays
    the update at its logged point) and finishes: the parameters are bit
    for bit A's.  (As in the reference, a checkpoint carries the routing
    plan but not the reshaper's own history, so the runs train without
    one.)"""
    ct = _fused(get_arch(ARCH))
    a = _port_loop(ct, ckpt_every=2, ckpt_dir=str(tmp_path / "a"),
                   reshape=False)
    a.run(2)
    _session(a)
    a.run(4)
    assert a.lc.lr_scale == 0.3
    assert [r.kind for r in a.controller.log][:4] == \
        ["pause", "inspect", "update", "resume"]

    b = _port_loop(ct, ckpt_every=2, ckpt_dir=str(tmp_path / "b"),
                   reshape=False)
    b.run(2)
    _session(b)
    b.run(1)                                   # crash after step 3
    del b

    c = TrainLoop.recover(ct, TokenStream(vocab=ct.vocab, seq_len=SEQ,
                                          global_batch=BATCH, seed=3,
                                          class_alpha=ALPHA),
                          train.TrainHyper(),
                          LoopConfig(microbatches=N_MB, ckpt_every=2,
                                     ckpt_dir=str(tmp_path / "b"),
                                     device="cpu"))
    assert int(c.state["step"]) == 2
    c.run(4)
    assert int(c.state["step"]) == 6 and c.lc.lr_scale == 0.3
    for x, y in zip(tree_leaves(a.state["params"]),
                    tree_leaves(c.state["params"])):
        assert torch.equal(x, y)


def test_plan_message_round_trips_through_durable_log(tmp_path):
    """A Reshape plan with migrations, logged durably, comes back as the
    reshaper's dataclasses (the controller copy now restores them)."""
    from repro_torch.core.controller import Controller
    from repro_torch.core.reshape_moe import Migration
    ct = _fused(get_arch(ARCH))
    loop = _port_loop(ct, ckpt_every=1, ckpt_dir=str(tmp_path))
    migs = (Migration(layer=1, src_slot=0, dst_slot=4),)
    loop.controller.send(M.set_plan(loop.plan_slots, loop.plan_cum, migs))
    loop.run(1)
    recs = Controller.read_durable_log(str(tmp_path / "control.log"))
    plan = [r for r in recs if r.kind == "plan"][0].payload
    assert list(plan["migrations"]) == list(migs)
    assert all(isinstance(m, Migration) for m in plan["migrations"])


def test_cli_trains_on_cpu(capsys):
    hist = train_cli.main(["--arch", "paper-moe-100m-smoke", "--steps", "2",
                           "--seq-len", "16", "--global-batch", "4",
                           "--reshape", "--fused", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "reshape iterations" in capsys.readouterr().out


def test_plain_training_step_counts_no_launches():
    ct = _fused(get_arch("paper-moe-100m-smoke"))
    loop = _port_loop(ct, reshape=False)
    reset_launches()
    loop.run(1)
    assert all(v == 0 for v in LAUNCHES.values())


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dispatch_combine_gradients_match_plain(cuda, rng, dtype):
    """The Functions on the kernels against autograd of the plain
    versions: the same bits (single-writer rows, f32 sums in j order)."""
    g_, t, d, k, s, cap = 1, 300, 64, 2, 10, 40
    x = torch.from_numpy(rng.standard_normal((g_, t, d)).astype(
        np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.random((g_, t, k)).astype(np.float32)).to(cuda)
    slot = torch.from_numpy(rng.integers(0, s, (g_, t, k)).astype(
        np.int32)).to(cuda)
    sc = torch.from_numpy(rng.standard_normal((s, 1, 1)).astype(
        np.float32)).to(cuda, dtype)
    gy = torch.randn((g_, t, d), device=cuda).to(dtype)
    grads = []
    for impl in ("cuda", "torch"):
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(
            True)
        reset_launches()
        y, m = dops.dispatch_combine(xi, slot, wi, lambda b: b * sc, s, cap,
                                     impl=impl)
        y.backward(gy)
        torch.cuda.synchronize()
        n = 1 if impl == "cuda" else 0
        assert LAUNCHES["moe_dispatch"] == LAUNCHES["moe_combine"] == 2 * n
        grads.append((xi.grad, wi.grad, m["dropped"]))
    assert torch.equal(grads[0][2], grads[1][2])
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_snapshot_restores_the_same_state(cuda):
    """The one-sync snapshot (pinned host copies) of a state on the card
    restores to the same bits."""
    from repro_torch.checkpoint.checkpointer import (to_device_tree,
                                                     to_numpy_tree)
    ct = _fused(get_arch("paper-moe-100m-smoke"))
    state = train.make_state(ct, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    back = to_device_tree(to_numpy_tree(state), cuda)
    for a, b in zip(tree_leaves(state["params"]) + tree_leaves(state["opt"].m),
                    tree_leaves(back["params"]) + tree_leaves(back["opt"].m)):
        assert torch.equal(a, b)
    assert int(back["opt"].count) == 0 and int(back["step"]) == 0


@pytest.mark.cuda
def test_cuda_recover_bit_identical(cuda, tmp_path):
    """Recovery through the kernels, forward and backward: a crashed run
    recovered from its checkpoint and control log finishes with the
    uninterrupted run's parameters, bit for bit."""
    ct = _fused(get_arch("paper-moe-100m-smoke"))

    def loop(d):
        return TrainLoop(ct, TokenStream(vocab=ct.vocab, seq_len=SEQ,
                                         global_batch=BATCH, seed=3,
                                         class_alpha=ALPHA),
                         train.TrainHyper(),
                         LoopConfig(microbatches=N_MB, ckpt_every=2,
                                    ckpt_dir=str(tmp_path / d)))
    a = loop("a")
    a.run(2)
    a.controller.send(M.update(lr_scale=0.3))
    a.run(2)
    b = loop("b")
    b.run(2)
    b.controller.send(M.update(lr_scale=0.3))
    b.run(1)
    del b
    reset_launches()
    c = TrainLoop.recover(ct, TokenStream(vocab=ct.vocab, seq_len=SEQ,
                                          global_batch=BATCH, seed=3,
                                          class_alpha=ALPHA),
                          train.TrainHyper(),
                          LoopConfig(microbatches=N_MB, ckpt_every=2,
                                     ckpt_dir=str(tmp_path / "b")))
    c.run(2)
    assert LAUNCHES["flash_bwd"] > 0 and LAUNCHES["moe_combine"] > 0
    for x, y in zip(tree_leaves(a.state["params"]),
                    tree_leaves(c.state["params"])):
        assert torch.equal(x, y)


def reference_fused_gap(steps=3):
    """The JAX reference against itself: ``steps`` training steps of the
    parity setup above (fused step path) with its argsort ("XLA")
    dispatch and with its fused dispatch, printed as a table of each
    step's losses, gap and drop counts."""
    cfg = j_get_arch(ARCH)
    hists = []
    for c in (cfg, _fused(cfg)):
        stream = JTokenStream(vocab=c.vocab, seq_len=SEQ, global_batch=BATCH,
                              seed=SEED, class_alpha=ALPHA)
        loop = JTrainLoop(c, stream, j_train.TrainHyper(),
                          JLoopConfig(microbatches=N_MB, step_path="fused"))
        hists.append(loop.run(steps))
    print("| step | loss (XLA) | loss (fused) | |gap| | dropped (XLA / "
          "fused) |")
    print("|---|---|---|---|---|")
    for a, b in zip(*hists):
        print(f"| {a['step']} | {a['loss']:.9f} | {b['loss']:.9f} | "
              f"{abs(a['loss'] - b['loss']):.3g} | "
              f"{int(np.sum(a['dropped']))} / {int(np.sum(b['dropped']))} |")


if __name__ == "__main__":
    reference_fused_gap()
