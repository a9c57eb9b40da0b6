"""Serving under the Amber control plane, the port against the JAX package
(tests/test_serve_consistency.py's serve-under-control half), on
``gemma3-1b-smoke`` with the reference's own weights.

* Pause, inspect, update and resume delivered mid-generation leave every
  token as an uninterrupted run's (inside the port, bit for bit), and the
  tokens equal the reference's greedy static loop except from a step where
  its top-2 logit margin is under 2e-2 (ROADMAP's near-tie rule; the
  activations are bf16 and the frameworks round at different points).
* The durable log of a serve-side schedule (pause, an update of two knobs,
  a breakpoint, resume at tick 2; and a token budget that fires) holds
  the same (kind, tick, microbatch) records and payloads as the
  reference's log of the same schedule; a ``ReplayingController`` on a
  fresh engine regenerates the tokens bit for bit, and each replayed
  effect lands at its recorded tick.
* An asynchronous pause lands at a tick boundary, and inspect is answered
  while paused.
"""
import threading
import time
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import messages as JM
from repro.core.breakpoints import GlobalCountBreakpoint as JGlobalCount
from repro.core.controller import Controller as JController
from repro.engine import Engine as JEngine
from repro.engine import ServeEngine as JServeEngine
from repro.models import lm as j_lm
from repro.runtime.serve import build_serve_step
from repro_torch.configs import get_arch
from repro_torch.core import messages as M
from repro_torch.core.breakpoints import GlobalCountBreakpoint
from repro_torch.core.controller import Controller, ReplayingController
from repro_torch.engine import Engine, ServeEngine
from repro_torch.models import bridge

ARCH = "gemma3-1b-smoke"
MAX_LEN = 64
TOL = 2e-2
WAIT = 60


@pytest.fixture(autouse=True)
def _torch_settings():
    """One torch thread (the suite's parallel workers would otherwise
    oversubscribe the cores) and the native GEMM, whose rows do not depend
    on the batch height (see tests/test_torch_compact.py)."""
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


@lru_cache(maxsize=None)
def _setup():
    cfg_j = j_get_arch(ARCH)
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(0))
    return cfg_j, params, bridge.from_jax(jax.tree.map(np.asarray, params),
                                          device="cpu")


def _engine(**kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("slots", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("decode_chunk", 4)
    return ServeEngine(get_arch(ARCH), _setup()[2], device="cpu", **kw)


def _j_engine(**kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("slots", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("decode_chunk", 4)
    cfg_j, params = _setup()[:2]
    return JServeEngine(cfg_j, params, **kw)


def _j_static(prompts, max_new):
    """The reference's greedy static loop with each step's top-2 margin."""
    cfg_j, params = _setup()[:2]
    step = jax.jit(build_serve_step(cfg_j))
    b, plen = prompts.shape
    state = j_lm.init_cache(cfg_j, b, MAX_LEN)
    for i in range(plen):
        logits, state = step(params, state, jnp.asarray(prompts[:, i:i + 1]))
    toks, margins = [], []
    for _ in range(max_new):
        lg = np.asarray(logits)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = lg.argmax(-1).astype(np.int32)
        toks.append(tok)
        logits, state = step(params, state, jnp.asarray(tok[:, None]))
    return np.stack(toks, 1), np.stack(margins, 1)


def _assert_near_tie_rule(got, ref, margins):
    for r in range(ref.shape[0]):
        bad = np.flatnonzero(got[r] != ref[r])
        if bad.size:
            assert margins[r, bad[0]] < TOL, \
                f"row {r} step {bad[0]}: margin {margins[r, bad[0]]}"


def _records(recs):
    out = []
    for r in recs:
        p = r.payload
        if hasattr(p, "target"):                  # a breakpoint
            p = (type(p).__name__, p.name, p.metric, p.target, p._total)
        out.append((r.kind, r.step, r.microbatch, p))
    return out


def test_serve_pause_inspect_resume_between_ticks_keeps_tokens():
    """Pause/Inspect/Update/Resume delivered mid-generation change no
    generated token against an uninterrupted run: the control plane is on
    the tick boundary, outside the data plane."""
    prompts = np.random.default_rng(11).integers(
        1, get_arch(ARCH).vocab, (3, 9)).astype(np.int32)
    ref = _engine().generate(prompts, max_new=12)

    eng = _engine()
    ctl = eng.engine.controller
    reqs = [eng.submit(p, max_new=12) for p in prompts]
    for _ in range(2):
        eng.tick()
    pause = ctl.send(M.pause())
    insp = ctl.send(M.inspect())
    ctl.send(M.update(max_prefill_defer=7))
    ctl.send(M.resume())
    eng.run_until_done()
    info = insp.wait(WAIT)
    assert info["paused"] is True            # answered from inside the pause
    assert info["tick"] == 2 and "slots" in info
    assert pause.wait(WAIT)["paused_at"] == (2, 0)
    assert eng.engine.max_prefill_defer == 7
    got = np.stack([r.output() for r in reqs])
    np.testing.assert_array_equal(got, ref)
    kinds = [r.kind for r in ctl.log]
    assert kinds.count("pause") == 1 and kinds.count("resume") == 1
    _assert_near_tie_rule(got, *_j_static(prompts, 12))


def _durable_schedule(eng, ctl_msgs, prompts):
    """Submit ``prompts``, tick twice, queue the messages, run to the end;
    the outputs and the pause's reply."""
    ctl = eng.engine.controller
    reqs = [eng.submit(p, max_new=10) for p in prompts]
    for _ in range(2):
        eng.tick()
    pause = ctl.send(ctl_msgs[0])
    for m in ctl_msgs[1:]:
        ctl.send(m)
    eng.run_until_done()
    return np.stack([r.output() for r in reqs]), pause.wait(WAIT)


def test_serve_durable_log_replay_of_control_messages(tmp_path):
    """Serve-side pause/update/breakpoint/resume delivered mid-generation
    are durably logged at their tick, as the reference logs them; after a
    'crash', a ReplayingController re-applies the state-effecting records
    at their ticks on a fresh engine, and the regenerated outputs are bit
    for bit the first run's (§2.6.2 recovery, on serving)."""
    prompts = np.random.default_rng(17).integers(
        1, get_arch(ARCH).vocab, (3, 7)).astype(np.int32)
    path = str(tmp_path / "serve_control.log")
    eng = _engine(engine=Engine(durable_log=path))
    ref, paused = _durable_schedule(eng, [
        M.pause(), M.update(max_prefill_defer=6, decode_chunk=2),
        M.set_breakpoint(GlobalCountBreakpoint("budget", "emitted",
                                               target=10 ** 9)),
        M.resume()], prompts)
    del eng                                       # "crash"

    jpath = str(tmp_path / "ref.log")
    jout, jpaused = _durable_schedule(
        _j_engine(engine=JEngine(durable_log=jpath)), [
            JM.pause(), JM.update(max_prefill_defer=6, decode_chunk=2),
            JM.set_breakpoint(JGlobalCount("budget", "emitted",
                                           target=10 ** 9)),
            JM.resume()], prompts)
    assert tuple(paused["paused_at"]) == tuple(jpaused["paused_at"]) == \
        (2, 0)
    records = Controller.read_durable_log(path)
    assert _records(records) == _records(JController.read_durable_log(jpath))
    assert [r.kind for r in records] == ["pause", "update", "breakpoint",
                                         "resume"]
    assert all(r.step == 2 for r in records)      # tick 2's poll point
    assert isinstance(records[2].payload, GlobalCountBreakpoint)
    _assert_near_tie_rule(ref, jout, _j_static(prompts, 10)[1])

    rc = ReplayingController(records)
    eng2 = _engine(engine=Engine(controller=rc))
    reqs2 = [eng2.submit(p, max_new=10) for p in prompts]
    seen = {}
    while eng2.queue or any(r is not None for r in eng2.active):
        eng2.tick()
        seen.setdefault(eng2.decode_chunk, eng2.tick_no)
    np.testing.assert_array_equal(np.stack([r.output() for r in reqs2]), ref)
    # the replayed state effects landed at their recorded tick: the first
    # tick run at decode_chunk 2 is tick 3, after tick 2's poll applied it
    assert seen[2] == 3
    assert eng2.engine.max_prefill_defer == 6
    assert any(getattr(b, "name", "") == "budget"
               for b in eng2.engine.global_bps)


def _budget_run(eng, msgs_mod, bp_cls, prompt):
    """A token budget of 4 (``bp_cls``; None where a replay registers it)
    on a 12-token request, resumed from a thread when it fires."""
    if bp_cls is not None:
        eng.engine.controller.send(msgs_mod.set_breakpoint(
            bp_cls("tok-budget", "emitted", target=4)))
    req = eng.submit(prompt, max_new=12)

    def resumer():
        while not eng.engine.controller.paused:
            time.sleep(0.01)
        eng.engine.controller.send(msgs_mod.resume())

    th = threading.Thread(target=resumer)
    th.start()
    eng.run_until_done()
    th.join(WAIT)
    assert not th.is_alive()
    assert "tok-budget" in eng.hit_breakpoints
    return req.output()


def test_serve_durable_log_replay_with_firing_breakpoint(tmp_path):
    """A token budget that fires mid-generation (pausing the stream) is
    logged where the reference logs it and replays cleanly: the recovered
    engine re-registers it from the log with its logged count, it fires
    again at the same tick, and the tokens are bit-identical."""
    prompt = np.arange(1, 7, dtype=np.int32)
    path = str(tmp_path / "bp.log")
    ref = _budget_run(_engine(engine=Engine(durable_log=path),
                              decode_chunk=2), M, GlobalCountBreakpoint,
                      prompt)
    records = Controller.read_durable_log(path)
    jpath = str(tmp_path / "ref.log")
    _budget_run(_j_engine(engine=JEngine(durable_log=jpath), decode_chunk=2),
                JM, JGlobalCount, prompt)
    assert _records(records) == _records(JController.read_durable_log(jpath))
    kinds = [r.kind for r in records]
    assert kinds == ["breakpoint", "resume"]

    eng2 = _engine(engine=Engine(controller=ReplayingController(records)),
                   decode_chunk=2)
    got = _budget_run(eng2, M, None, prompt)
    np.testing.assert_array_equal(got, ref)
    assert [(r.kind, r.step) for r in eng2.engine.controller.log] == \
        [(r.kind, r.step) for r in records]


def test_serve_pause_latency_is_tick_bounded():
    """An async pause lands at the next tick boundary, and the engine keeps
    answering inspect while paused."""
    eng = _engine(decode_chunk=2)
    ctl = eng.engine.controller
    req = eng.submit(np.arange(1, 8, dtype=np.int32), max_new=20)
    state = {}

    def driver():
        r = ctl.send(M.pause()).wait(WAIT)
        state["paused_at"] = r["paused_at"]
        state["tick"] = eng.tick_no
        state["inspect"] = ctl.send(M.inspect()).wait(WAIT)
        ctl.send(M.resume()).wait(WAIT)

    th = threading.Thread(target=driver)
    th.start()
    time.sleep(0.05)
    eng.run_until_done()
    th.join(WAIT)
    assert not th.is_alive()
    assert state["paused_at"][0] == state["tick"]   # a tick boundary
    assert state["inspect"]["paused"] is True
    assert state["inspect"]["tick"] == state["paused_at"][0]
    assert not eng.queue and all(r is None for r in eng.active)
    assert len(req.output()) == 20
    assert ctl.pause_latency and ctl.pause_latency[0] < WAIT
