"""The port's Amber control plane against the JAX package's
(tests/test_controller_ft.py): pause, inspect while paused, update and
resume; local and global breakpoints; the global target protocol; the
durable control-replay log and recovery.

* A training session with a fixed message schedule (pause, inspect while
  paused, a hot lr update, a token-budget breakpoint that fires, resumes)
  runs on both packages from the same state: the control log's (kind,
  step, microbatch) records, ``paused_at``, what inspect answers while
  paused, where the breakpoint fires and its count, and the loops' lr
  scale are equal (no tolerance: the schedule and the token counts do not
  depend on the numerics).
* The global target protocol's simulation and the durable log's plan,
  breakpoint and unencodable records are equal to the reference's.
* Inside the port (the reference's own invariants): pause latency within
  one microbatch, breakpoints pause the loop, a durably logged plan lands
  in a recovered loop at its step, and recovery from a checkpoint plus the
  control log gives the uninterrupted run's parameters bit for bit.
"""
import threading
import time
import types
import warnings

import numpy as np
import jax
import pytest
import torch

import repro.configs as j_configs
import repro.core.breakpoints as j_bp
import repro.core.controller as j_ctl
import repro.core.messages as JM
import repro.core.reshape_moe as j_rm
import repro.data.synthetic as j_data
import repro.runtime.loop as j_loop
import repro.runtime.train as j_train
from repro_torch import configs
from repro_torch.core import breakpoints as bp_mod
from repro_torch.core import controller as ctl_mod
from repro_torch.core import messages as M
from repro_torch.core import reshape_moe as rm
from repro_torch.core.breakpoints import (GlobalCountBreakpoint,
                                          LocalBreakpoint,
                                          run_global_target_protocol)
from repro_torch.core.controller import Controller, ReplayingController
from repro_torch.data import synthetic
from repro_torch.models import bridge
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import loop as loop_mod
from repro_torch.runtime import train as train_mod
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.train import TrainHyper

ARCH = "olmoe-1b-7b-smoke"
SEQ, GB, N_MB = 16, 4, 2
WAIT = 60                      # seconds any thread or reply may take

PORT = types.SimpleNamespace(
    configs=configs, M=M, bp=bp_mod, ctl=ctl_mod, rm=rm, data=synthetic,
    loop=loop_mod, train=train_mod, lc=dict(device="cpu"))
REF = types.SimpleNamespace(
    configs=j_configs, M=JM, bp=j_bp, ctl=j_ctl, rm=j_rm, data=j_data,
    loop=j_loop, train=j_train, lc={})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_loop(tmp, arch=ARCH, ckpt_every=0, controller=None, reshaper=None,
            fw=PORT, **lc):
    cfg = fw.configs.get_arch(arch + "-smoke")
    stream = fw.data.TokenStream(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=GB, seed=3)
    return fw.loop.TrainLoop(
        cfg, stream, fw.train.TrainHyper(),
        fw.loop.LoopConfig(microbatches=N_MB, ckpt_every=ckpt_every,
                           ckpt_dir=tmp, **lc, **fw.lc),
        controller=controller, reshaper=reshaper)


def _join(th):
    th.join(WAIT)
    assert not th.is_alive()


# ------------------------------------------------------ against the reference

def _session(loop, fw):
    """Two steps, then a queued session at step 2: pause, inspect while
    paused, lr_scale 0.5, a token budget of 3 microbatches, resume; the
    budget fires at step 3 and a thread resumes it."""
    ctl = loop.controller
    loop.run(2)
    budget = fw.bp.GlobalCountBreakpoint("budget", "tokens",
                                         target=3 * SEQ * GB / N_MB)
    pause = ctl.send(fw.M.pause())
    insp = ctl.send(fw.M.inspect())
    for m in (fw.M.update(lr_scale=0.5), fw.M.set_breakpoint(budget),
              fw.M.resume()):
        ctl.send(m)

    def resumer():
        while not (loop.hit_breakpoints and ctl.paused):
            time.sleep(0.01)
        ctl.send(fw.M.resume()).wait(WAIT)

    th = threading.Thread(target=resumer)
    th.start()
    loop.run(4)
    _join(th)
    info = insp.wait(WAIT)
    return {"log": [(r.kind, r.step, r.microbatch) for r in ctl.log],
            "paused_at": tuple(pause.wait(WAIT)["paused_at"]),
            "inspect": (info["paused"], info["step"], info["stream"]),
            "hit": list(loop.hit_breakpoints),
            "budget": (budget._total, budget.target),
            "lr_scale": loop.lc.lr_scale,
            "steps": [h["step"] for h in loop.history],
            "stream": loop.stream.state()}


def test_session_records_match_reference(tmp_path):
    """Both loops from the reference's initial state, granulated steps
    throughout, so every control point is a microbatch."""
    jl = mk_loop(str(tmp_path / "ref"), fw=REF, step_path="granulated")
    tl = mk_loop(str(tmp_path / "port"), step_path="granulated")
    tl.state = bridge.state_from_jax(jax.tree.map(np.asarray, jl.state),
                                     device="cpu")
    ref = _session(jl, REF)
    got = _session(tl, PORT)
    assert got == ref
    assert got["paused_at"] == (2, 0)
    assert got["log"] == [("pause", 2, 0), ("inspect", 2, 0),
                          ("update", 2, 0), ("breakpoint", 2, 0),
                          ("resume", 2, 0), ("resume", 3, 1)]
    assert got["inspect"][:2] == (True, 2) and got["hit"] == ["budget"]


def _protocol(fn, **kw):
    r = fn(1000, **kw)
    return (r.total_time, r.normal_time, r.sync_time, r.produced,
            r.overshoot, r.rounds)


def test_global_target_protocol_tau_tradeoff():
    # Fig 2.13: higher tau -> more sync time; tiny tau -> best overall
    rates = [10.0, 7.0, 5.0]
    res_small = run_global_target_protocol(1000, rates, tau=0.01)
    res_big = run_global_target_protocol(1000, rates, tau=5.0)
    assert res_small.sync_time < res_big.sync_time
    assert res_small.total_time <= res_big.total_time
    assert res_small.produced >= 1000
    for tau in (0.01, 5.0):
        assert _protocol(run_global_target_protocol, rates=rates,
                         tau=tau) == \
            _protocol(j_bp.run_global_target_protocol, rates=rates, tau=tau)


def test_sum_predicate_single_worker_endgame_reduces_overshoot():
    rates = [10.0, 9.0, 8.0]
    vals = [15.0, 12.0, 10.0]
    kw = [dict(rates=rates, tau=0.1, values_per_tuple=vals,
               single_worker_threshold=t) for t in (50, 0)]
    with_endgame, without = (run_global_target_protocol(1000, **k)
                             for k in kw)
    assert with_endgame.overshoot <= without.overshoot + 1e-9
    for k in kw:
        assert _protocol(run_global_target_protocol, **k) == \
            _protocol(j_bp.run_global_target_protocol, **k)


def _plan_log(fw, path):
    ctl = fw.ctl.Controller()
    ctl.attach_durable_log(path)
    slots = np.arange(8, dtype=np.int32).reshape(1, 2, 4)
    cum = np.linspace(0.25, 1.0, 8, dtype=np.float32).reshape(1, 2, 4)
    migs = (fw.rm.Migration(0, 1, 3), fw.rm.Migration(0, 2, 6))
    ctl.send(fw.M.set_plan(slots, cum, migs))
    ctl.send(fw.M.update(lr_scale=0.5))
    ctl.poll(step=2, microbatch=1, inspect_fn=None)
    records = fw.ctl.Controller.read_durable_log(path)
    r = fw.ctl.ReplayingController(records).poll(step=2, microbatch=1)
    return records, r


def test_durable_log_plan_roundtrip(tmp_path):
    """A 'plan' record (numpy arrays + Migration dataclasses) survives
    attach_durable_log -> crash -> read_durable_log -> replay, as in the
    reference: the same records and the same replayed plan."""
    records, r = _plan_log(PORT, str(tmp_path / "port.log"))
    jrecords, jr = _plan_log(REF, str(tmp_path / "ref.log"))
    assert [(x.kind, x.step, x.microbatch) for x in records] == \
        [(x.kind, x.step, x.microbatch) for x in jrecords] == \
        [("plan", 2, 1), ("update", 2, 1)]
    for got, ref in ((records[0].payload, jrecords[0].payload),
                     (r["plan"], jr["plan"])):
        for k in ("slots", "cum"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]))
            assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype
        assert [(m.layer, m.src_slot, m.dst_slot)
                for m in got["migrations"]] == \
            [(m.layer, m.src_slot, m.dst_slot)
             for m in ref["migrations"]] == [(0, 1, 3), (0, 2, 6)]
        assert all(isinstance(m, rm.Migration) for m in got["migrations"])
    assert r["updates"] == jr["updates"] == {"lr_scale": 0.5}


def _durable(fw, path, msgs, n_warn):
    """``msgs`` through a durably logged controller's poll, which must not
    raise and must warn ``n_warn`` times; the records read back."""
    ctl = fw.ctl.Controller()
    ctl.attach_durable_log(path)
    for m in msgs:
        ctl.send(m)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ctl.poll(step=1, microbatch=0)
    assert sum("durable log" in str(x.message) for x in w) == n_warn
    return fw.ctl.Controller.read_durable_log(path)


def test_durable_log_breakpoint_roundtrip(tmp_path):
    """A GlobalCountBreakpoint restores as the class with its counter
    state; a LocalBreakpoint's lambda cannot be encoded and takes the
    tagged-repr path with a warning: the records equal the reference's."""
    def msgs(fw):
        return [fw.M.set_breakpoint(fw.bp.GlobalCountBreakpoint(
                    "tok", "tokens", target=64.0)),
                fw.M.set_breakpoint(fw.bp.LocalBreakpoint(
                    "nan", lambda m: m["loss"] != 0))]
    recs = _durable(PORT, str(tmp_path / "port.log"), msgs(PORT), 1)
    jrecs = _durable(REF, str(tmp_path / "ref.log"), msgs(REF), 1)
    assert [r.kind for r in recs] == [r.kind for r in jrecs] == \
        ["breakpoint", "breakpoint"]
    bp, jbp = recs[0].payload, jrecs[0].payload
    assert isinstance(bp, GlobalCountBreakpoint)
    assert (bp.name, bp.metric, bp.target, bp._total) == \
        (jbp.name, jbp.metric, jbp.target, jbp._total) == \
        ("tok", "tokens", 64.0, 0.0)
    assert set(recs[1].payload) == set(jrecs[1].payload) == \
        {"__unserializable__"}


def test_durable_log_unserializable_payload_keeps_worker_alive(tmp_path):
    """A payload the encoder cannot model neither kills poll() nor
    vanishes: it is logged as a tagged repr with a warning, as in the
    reference."""
    recs = _durable(PORT, str(tmp_path / "port.log"),
                    [M.update(tags={"a", "b"})], 1)
    jrecs = _durable(REF, str(tmp_path / "ref.log"),
                     [JM.update(tags={"a", "b"})], 1)
    assert [r.kind for r in recs] == [r.kind for r in jrecs] == ["update"]
    assert set(recs[0].payload) == set(jrecs[0].payload) == \
        {"__unserializable__"}
    assert "tags" in recs[0].payload["__unserializable__"]


# ----------------------------------------------------- inside the port

def test_pause_resume_inspect_while_paused(tmp_path):
    loop = mk_loop(str(tmp_path))
    ctl = loop.controller
    seen = {}

    def driver():
        time.sleep(0.3)
        ctl.send(M.pause()).wait(WAIT)
        # inspect WHILE PAUSED (the Amber §2.4.4 capability)
        seen["info"] = ctl.send(M.inspect()).wait(WAIT)
        ctl.send(M.update(lr_scale=0.5)).wait(WAIT)
        ctl.send(M.resume()).wait(WAIT)

    th = threading.Thread(target=driver)
    th.start()
    loop.run(6)
    _join(th)
    assert seen["info"]["paused"]
    assert loop.lc.lr_scale == 0.5
    kinds = [r.kind for r in ctl.log]
    assert kinds.count("pause") == 1 and kinds.count("resume") == 1
    # pause took effect within one microbatch of wall time
    assert ctl.pause_latency and ctl.pause_latency[0] < 30.0


def test_local_breakpoint_pauses():
    cfg = configs.get_arch("gemma3-1b-smoke")
    stream = synthetic.TokenStream(vocab=cfg.vocab, seq_len=8,
                                   global_batch=2)
    loop = TrainLoop(cfg, stream, TrainHyper(),
                     LoopConfig(microbatches=1, device="cpu"))
    ctl = loop.controller
    ctl.send(M.set_breakpoint(LocalBreakpoint("always",
                                              lambda m: m["loss"] > 0)))

    def stopper():
        while not ctl.paused:
            time.sleep(0.02)
        ctl.send(M.stop())

    th = threading.Thread(target=stopper)
    th.start()
    loop.run(10)
    _join(th)
    assert "always" in loop.hit_breakpoints
    assert len(loop.history) < 10


def test_global_count_breakpoint():
    cfg = configs.get_arch("gemma3-1b-smoke")
    stream = synthetic.TokenStream(vocab=cfg.vocab, seq_len=8,
                                   global_batch=2)
    loop = TrainLoop(cfg, stream, TrainHyper(),
                     LoopConfig(microbatches=1, device="cpu"))
    bp = GlobalCountBreakpoint("tokens", "tokens", target=3 * 16)
    loop.global_bps.append(bp)

    def stopper():
        while not loop.controller.paused:
            time.sleep(0.02)
        loop.controller.send(M.stop())

    th = threading.Thread(target=stopper)
    th.start()
    loop.run(20)
    _join(th)
    assert "tokens" in loop.hit_breakpoints
    # paused within one microbatch of the target
    assert bp._total >= bp.target
    assert bp._total - bp.target <= 16


def test_durable_log_plan_recovery_applies_to_loop(tmp_path):
    """A plan message logged durably before a crash reshapes the recovered
    loop's routing plan at its recorded step."""
    d = str(tmp_path / "ckpt")
    loop = mk_loop(d, ckpt_every=2)
    nl = len(loop.plan_slots)
    loop.run(2)                                   # checkpoint at step 2
    new_slots = np.asarray(loop.plan_slots).copy()
    new_slots[0, 0, :] = (new_slots[0, 0, :] + 1) % new_slots.shape[1]
    new_cum = np.asarray(loop.plan_cum).copy()
    assert not np.array_equal(new_slots, np.asarray(loop.plan_slots))
    loop.controller.send(M.set_plan(new_slots, new_cum, ()))
    loop.run(1)                            # plan applied + logged at (2, 0)
    del loop                                      # crash after step 3

    rec = TrainLoop.recover(
        configs.get_arch(ARCH + "-smoke"),
        synthetic.TokenStream(vocab=configs.get_arch(ARCH + "-smoke").vocab,
                              seq_len=SEQ, global_batch=GB, seed=3),
        TrainHyper(), LoopConfig(microbatches=N_MB, ckpt_every=2,
                                 ckpt_dir=d, device="cpu"))
    assert int(rec.state["step"]) == 2
    assert not np.array_equal(np.asarray(rec.plan_slots), new_slots)
    rec.run(2)                                    # replays the plan at step 2
    np.testing.assert_array_equal(np.asarray(rec.plan_slots), new_slots)
    assert nl == len(rec.plan_slots)


def test_fault_tolerance_bit_exact_recovery(tmp_path):
    """Run A: 8 steps with an lr update at step 4 (logged), checkpoint@4.
    Run B: the same, 'crash' after step 6, recover from the checkpoint,
    replay, finish.  Final params bit-identical (the reference's
    schedule; tests/test_torch_train.py holds a shorter one with a pause
    and an inspect)."""
    d = str(tmp_path / "ft")
    loop_a = mk_loop(d + "_a", ckpt_every=4)
    loop_a.run(4)
    loop_a.controller.send(M.update(lr_scale=0.25))
    loop_a.run(4)

    loop_b = mk_loop(d + "_b", ckpt_every=4)
    loop_b.run(4)
    loop_b.controller.send(M.update(lr_scale=0.25))
    loop_b.run(2)                                 # crash "after step 6"
    del loop_b

    cfg = configs.get_arch(ARCH + "-smoke")
    loop_c = TrainLoop.recover(
        cfg, synthetic.TokenStream(vocab=cfg.vocab, seq_len=SEQ,
                                   global_batch=GB, seed=3),
        TrainHyper(), LoopConfig(microbatches=N_MB, ckpt_every=4,
                                 ckpt_dir=d + "_b", device="cpu"))
    assert int(loop_c.state["step"]) == 4
    assert isinstance(loop_c.controller, ReplayingController)
    loop_c.run(4)                    # replays the update at its logged point
    assert loop_c.lc.lr_scale == 0.25
    for a, b in zip(tree_leaves(loop_a.state["params"]),
                    tree_leaves(loop_c.state["params"])):
        assert torch.equal(a, b)
    assert [h["loss"] for h in loop_a.history[6:]] == \
        [h["loss"] for h in loop_c.history[2:]]
