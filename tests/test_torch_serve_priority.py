"""The port's multi-pool, priority-class serving against the JAX package's
and inside the port (the reference's tests/test_serve_priority.py).

* Parity: a reference ``ServeEngine`` and the port's get the same config,
  weights (``bridge.from_jax``), prompts, arrival ticks, classes and
  ``class_pools``, each with an ``Engine`` whose CostBook is seeded with
  the same per-pool costs and observes nothing, so that every decision is
  a function of the engine state alone.  Both make the same decisions
  (every record of the decision deque: the (pool, mode) arbitration with
  its scores and aging flag, the compact layout), every request peaks at
  the same ``max_deferred``, and the greedy tokens are equal, except from
  a step where the reference's top-2 logit margin is under 2e-2 (a bf16
  near-tie the two frameworks may resolve apart; the row is compared no
  further).  The inputs are fixed ones (their own seed, independent of
  PYTEST_SEED), as in tests/test_torch_serve.py.
* The weighted-FRT arbitration of the port's ``Engine`` (a copy of the
  reference's) on hand-made candidates.
* Inside the port: the starvation bound (a low-priority prefill under a
  saturating high-priority decode stream is deferred at least once and at
  most its class's ``max_defer``), class routing pins admission, a class's
  full pools do not block other traffic, mixed classes over one and two
  pools equal ``generate_static``, and one pool of the single default
  class keeps the ``choose_serve_tick`` path.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import PriorityClass as JPriorityClass
from repro.engine import Engine as JEngine
from repro.engine import jobs as j_jobs
from repro.engine import serve as j_serve
from repro.models import lm as j_lm
from repro.runtime.serve import build_serve_step
from repro_torch.configs import get_arch
from repro_torch.configs.base import PriorityClass
from repro_torch.engine import Engine, ServeEngine, TickCandidate
from repro_torch.engine import jobs
from repro_torch.models import bridge
from repro_torch.runtime.serve import BatchedServer

ARCH = "gemma3-1b-smoke"
MAX_LEN = 64
TOL = 2e-2
# hi outweighs lo 8:1; lo tolerates sitting out at most 3 scheduled ticks
CLASSES = (PriorityClass("hi", 8.0, 6), PriorityClass("lo", 1.0, 3))
J_CLASSES = (JPriorityClass("hi", 8.0, 6), JPriorityClass("lo", 1.0, 3))


@pytest.fixture(autouse=True)
def _cpu_numerics():
    """One torch thread (smoke-size ops run fastest so, and the suite's
    parallel workers would otherwise oversubscribe the cores), and the
    native GEMM, whose rows do not depend on the batch height (see
    tests/test_torch_compact.py)."""
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


def _prio(cfg, classes):
    return dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, classes=classes))


CFG = get_arch(ARCH)
CFG_PRIO = _prio(CFG, CLASSES)


@lru_cache(maxsize=None)
def _weights():
    params = jax.jit(j_lm.init, static_argnums=0)(j_get_arch(ARCH),
                                                  jax.random.PRNGKey(0))
    return params, bridge.from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")


_ORACLE = {}


def oracle(prompt, max_new):
    key = (tuple(int(t) for t in prompt), int(max_new))
    if key not in _ORACLE:
        srv = BatchedServer(CFG, _weights()[1], max_len=MAX_LEN,
                            device="cpu")
        _ORACLE[key] = srv.generate_static(
            np.asarray(prompt, np.int32)[None], max_new=int(max_new))[0]
    return _ORACLE[key]


@lru_cache(maxsize=None)
def _j_step():
    return jax.jit(build_serve_step(j_get_arch(ARCH)))


def _j_margins(prompt, max_new):
    """The reference's static greedy loop on one prompt: its tokens and
    each step's top-2 logit margin."""
    cfg_j, step, params = j_get_arch(ARCH), _j_step(), _weights()[0]
    state = j_lm.init_cache(cfg_j, 1, MAX_LEN)
    for i in range(len(prompt)):
        logits, state = step(params, state,
                             jnp.asarray(prompt[None, i:i + 1]))
    toks, margins = [], []
    for _ in range(max_new):
        lg = np.asarray(logits)[0]
        top2 = np.sort(lg)[-2:]
        margins.append(top2[1] - top2[0])
        toks.append(int(lg.argmax()))
        logits, state = step(params, state,
                             jnp.asarray([[toks[-1]]], jnp.int32))
    return np.asarray(toks, np.int32), np.asarray(margins)


def _prio_engine(**kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("decode_chunk", 2)
    return ServeEngine(CFG_PRIO, _weights()[1], device="cpu", **kw)


# ------------------------------------------------ parity with the reference

def _frozen(engine_cls, pool_kind, pools):
    """An Engine whose per-pool tick costs are seeded (pool p at
    (p + 1) ms a token) and which observes nothing."""
    e = engine_cls()
    for p in range(pools):
        for kind in ("serve_decode", "serve_prefill"):
            for _ in range(2):
                e.costs.observe(pool_kind(kind, p) + "_per_tok",
                                1e-3 * (p + 1))
    e.observe = lambda job, seconds: None
    return e


# (pools, class_pools, slots): two pools with the hi class routed to pool
# 0, two pools with open routing, and one pool of two classes
PARITY = {"routed": (2, {"hi": (0,), "lo": (0, 1)}, 2),
          "open": (2, None, 2),
          "one-pool": (1, None, 3)}


def _workload():
    """Fixed arrivals: (tick, prompt, max_new, priority)."""
    rng = np.random.default_rng(1234)
    out = []
    for at, plen, new, pr in (
            (0, 3, 12, "hi"), (0, 9, 4, "lo"), (0, 5, 10, "hi"),
            (2, 11, 3, "lo"), (3, 4, 8, "hi"), (5, 7, 5, "lo"),
            (6, 2, 6, "hi"), (9, 10, 4, "lo")):
        out.append((at, rng.integers(1, CFG.vocab, plen).astype(np.int32),
                    new, pr))
    return out


def _drive(eng, work):
    reqs, t = [], 0
    pending = list(work)
    while pending or eng.queue or any(r is not None for r in eng.active):
        while pending and pending[0][0] <= t:
            _, p, n, pr = pending.pop(0)
            reqs.append(eng.submit(p, max_new=n, priority=pr))
        assert eng.tick()
        t += 1
        assert t < 500
    return reqs


@pytest.mark.parametrize("case", sorted(PARITY))
def test_decisions_and_deferrals_match_reference(case):
    pools, class_pools, slots = PARITY[case]
    params_j, params_t = _weights()
    kw = dict(max_len=MAX_LEN, slots=slots, prefill_chunk=4, decode_chunk=2,
              pools=pools, class_pools=class_pools)
    ref = j_serve.ServeEngine(_prio(j_get_arch(ARCH), J_CLASSES), params_j,
                              engine=_frozen(JEngine, j_jobs.pool_kind,
                                             pools), **kw)
    eng = ServeEngine(CFG_PRIO, params_t, device="cpu",
                      engine=_frozen(Engine, jobs.pool_kind, pools), **kw)
    work = _workload()
    ref_reqs = _drive(ref, work)
    reqs = _drive(eng, work)
    got = list(eng.engine.decisions)
    want = list(ref.engine.decisions)
    assert any(d["decision"] == "serve_job" for d in want)
    assert got == want
    assert [r.max_deferred for r in reqs] == \
        [r.max_deferred for r in ref_reqs]
    assert any(r.max_deferred for r in reqs)
    compared = total = 0
    for r, w in zip(reqs, ref_reqs):
        want, margins = _j_margins(w.prompt, w.max_new)
        np.testing.assert_array_equal(w.output(), want)
        bad = np.flatnonzero(r.output() != want)
        if bad.size:
            assert margins[bad[0]] < TOL, \
                f"req {r.rid} step {bad[0]}: margin {margins[bad[0]]}"
        compared += bad[0] if bad.size else len(want)
        total += len(want)
    assert compared >= total * 3 // 4
    assert eng.tick_no == ref.tick_no
    assert eng.compact_ticks == ref.compact_ticks


# ------------------------------------------------------- engine unit tests

def test_weighted_frt_flips_pool_choice_when_weights_flip():
    eng = Engine()

    def cands(w0, w1):
        return [TickCandidate(0, "decode", n_dec=2, chunk=4, weight=w0),
                TickCandidate(1, "decode", n_dec=2, chunk=4, weight=w1)]

    assert eng.choose_serve_job(cands(8.0, 1.0)) == (0, "decode")
    assert eng.choose_serve_job(cands(1.0, 8.0)) == (1, "decode")


def test_weighted_frt_flips_composition_when_weights_flip():
    eng = Engine()

    def cands(w_dec, w_pre):
        return [TickCandidate(0, "decode", n_dec=1, chunk=4, weight=w_dec),
                TickCandidate(0, "prefill", n_dec=1, n_pre=1, pre_toks=4,
                              chunk=4, weight=w_pre)]

    assert eng.choose_serve_job(cands(1.0, 50.0)) == (0, "prefill")
    assert eng.choose_serve_job(cands(50.0, 1.0)) == (0, "decode")


def test_aged_candidates_override_any_weight():
    eng = Engine()
    got = eng.choose_serve_job([
        TickCandidate(0, "decode", n_dec=4, chunk=2, weight=1e6),
        TickCandidate(1, "prefill", n_pre=1, pre_toks=8, chunk=4,
                      weight=1e-3, aged=True)])
    assert got == (1, "prefill") and eng.decisions[-1]["aged"] is True
    got = eng.choose_serve_job([
        TickCandidate(0, "prefill", n_pre=1, pre_toks=4, chunk=4,
                      weight=9.0, aged=True, overdue=0),
        TickCandidate(1, "prefill", n_pre=1, pre_toks=4, chunk=4,
                      weight=1.0, aged=True, overdue=3)])
    assert got == (1, "prefill")


def test_pool_cost_emas_steer_the_arbitration():
    eng = Engine()
    for _ in range(2):
        eng.costs.observe(jobs.pool_kind("serve_decode", 0) + "_per_tok",
                          1e-2)
        eng.costs.observe(jobs.pool_kind("serve_decode", 1) + "_per_tok",
                          1e-3)
    got = eng.choose_serve_job(
        [TickCandidate(0, "decode", n_dec=2, chunk=4, weight=1.0),
         TickCandidate(1, "decode", n_dec=2, chunk=4, weight=1.0)])
    assert got == (1, "decode")


# ----------------------------------------------- serve-engine behaviour

def test_starvation_regression_low_priority_prefill_bounded():
    """A saturating high-priority decode stream defers an admitted
    low-priority prefill at least once and at most its class's
    max_defer."""
    eng = _prio_engine(slots=3, pools=1)
    rng = np.random.default_rng(11)
    hi = [eng.submit(rng.integers(1, CFG.vocab, (3,)).astype(np.int32),
                     max_new=40, priority="hi") for _ in range(2)]
    while any(r.prefilling for r in hi):
        assert eng.tick()
    lo_prompt = rng.integers(1, CFG.vocab, (8,)).astype(np.int32)
    lo = eng.submit(lo_prompt, max_new=2, priority="lo")
    while not lo.done.is_set():
        assert eng.tick()
    bound = dict((c.name, c.max_defer) for c in CLASSES)["lo"]
    assert 1 <= lo.max_deferred <= bound
    assert any(d.get("aged") for d in eng.engine.decisions
               if d["decision"] == "serve_job")
    eng.run_until_done()
    np.testing.assert_array_equal(lo.output(), oracle(lo_prompt, 2))
    for r in hi:
        assert len(r.output()) == 40


def test_class_pool_routing_pins_admission():
    eng = _prio_engine(slots=2, pools=2,
                       class_pools={"hi": (0,), "lo": (1,)})
    rng = np.random.default_rng(5)
    reqs = [eng.submit(rng.integers(1, CFG.vocab, (4,)).astype(np.int32),
                       max_new=2, priority=p)
            for p in ("hi", "lo", "hi", "lo")]
    eng._admit()
    assert [r.pool for r in reqs] == [0, 1, 0, 1]
    pinned = eng.submit(reqs[0].prompt, max_new=2, priority="hi", pool=1)
    eng.run_until_done()
    assert all(r.done.is_set() for r in reqs + [pinned])
    with pytest.raises(ValueError):
        eng.submit(reqs[0].prompt, priority="nope")
    with pytest.raises(ValueError):
        eng.submit(reqs[0].prompt, pool=2)
    with pytest.raises(ValueError):
        _prio_engine(pools=2, class_pools={"hi": (2,)})
    with pytest.raises(ValueError):
        _prio_engine(pools=2, class_pools={"nope": (0,)})


def test_full_class_pools_do_not_block_other_traffic():
    eng = _prio_engine(slots=1, pools=2,
                       class_pools={"hi": (0,), "lo": (1,)})
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, CFG.vocab, (3,)).astype(np.int32)
               for _ in range(3)]
    r_hi0 = eng.submit(prompts[0], max_new=2, priority="hi")
    r_hi1 = eng.submit(prompts[1], max_new=2, priority="hi")
    r_lo = eng.submit(prompts[2], max_new=2, priority="lo")
    eng._admit()
    assert r_hi0.pool == 0 and r_hi1.pool == -1 and r_lo.pool == 1
    eng.run_until_done()
    assert all(r.done.is_set() for r in (r_hi0, r_hi1, r_lo))


@pytest.mark.parametrize("pools", [1, 2])
def test_priority_outputs_equal_static_across_pools(pools):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG.vocab, (n,)).astype(np.int32)
               for n in (2, 7, 11, 4, 9)]
    news = [int(rng.integers(1, 8)) for _ in prompts]
    prios = ["hi", "lo", "hi", "lo", "hi"]
    eng = _prio_engine(slots=2, pools=pools)
    reqs = [eng.submit(p, max_new=n, priority=pr)
            for p, n, pr in zip(prompts, news, prios)]
    eng.run_until_done()
    for p, n, r in zip(prompts, news, reqs):
        np.testing.assert_array_equal(r.output(), oracle(p, n),
                                      err_msg=f"plen={len(p)} new={n}")
    info = eng._inspect("all")
    assert [p["lid"] for p in info["pools"]] == list(range(pools))
    assert info["classes"]["lo"] == {"weight": 1.0, "max_defer": 3}


def test_single_pool_single_class_keeps_choose_serve_tick():
    eng = ServeEngine(CFG, _weights()[1], max_len=MAX_LEN, slots=2,
                      prefill_chunk=4, decode_chunk=2, device="cpu")
    assert eng.single_pool
    eng.submit(np.arange(1, 7, dtype=np.int32), max_new=4)
    eng.run_until_done()
    kinds = {d["decision"] for d in eng.engine.decisions}
    assert "serve_tick" in kinds and "serve_job" not in kinds
    assert not _prio_engine(slots=2, pools=1).single_pool
