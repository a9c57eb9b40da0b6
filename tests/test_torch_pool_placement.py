"""Device-placed slot pools in the port's serve engine: the cases of the
reference's tests/test_pool_placement.py on the CPU, and the port's own.

As the reference's file runs on one device, placements here put both
pools on the one CPU device (``placements={0: "cpu", 1: "cpu"}``), which
still runs the placed code: each pool's mesh, its weights through
``_params_for``, the ``load`` term, placement-aware admission and the
drain's device counts.  Placement and migration may only relocate work:
every greedy output equals the port's own ``generate_static`` token for
token (the reference's one-row oracle parts on an exact bf16 tie, so it
is not the oracle here), across the three cache families, with draft
rows and n-gram tables riding along, and no request drops.

The reference is held where it is sound: its spec functions
(``pool_specs`` on the same leaves, in its ``[slots, n, 1, ...]``
layout), its scheduling units, and its decisions under one frozen
CostBook with both engines placed, which depend on lengths, not on token
values.  The port's own checks: a placement of another device type is
refused, a pool mesh of two devices and a tensor-parallel pool serve
(tests/test_torch_pool_mesh.py holds them in full), and the parallel
group tick's path (plan, then every dispatch, then every host copy) runs
on pools given distinct device-group keys on the one CPU device; that
checks the path's logic and outputs, not an overlap, which needs two
cards.

As in tests/test_torch_pool_migration.py the tests run torch's native CPU
GEMM (``torch.backends.mkldnn`` off), whose rows do not depend on the
batch height.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import scheduler as j_scheduler
from repro.engine import Engine as JEngine
from repro.engine import jobs as j_jobs
from repro.engine import serve as j_serve
from repro.models import lm as j_lm
from repro.runtime import sharding as JS
from repro_torch.configs import get_arch
from repro_torch.core.scheduler import placement_adjusted_frt
from repro_torch.engine import Engine, ServeEngine
from repro_torch.engine import jobs
from repro_torch.engine.draft import truncated_draft_cfg
from repro_torch.engine.serve import SlotPool, SlotTick
from repro_torch.models import bridge, lm
from repro_torch.runtime import sharding as S
from repro_torch.runtime.serve import BatchedServer

MAX_LEN = 64
FAMS = ["gemma3-1b", "rwkv6-1.6b", "zamba2-7b"]
BOTH = {0: "cpu", 1: "cpu"}


@pytest.fixture(autouse=True)
def _cpu_numerics():
    """One torch thread (smoke-size ops run fastest so, and the suite's
    parallel workers would otherwise oversubscribe the cores), and the
    native GEMM, whose rows do not depend on the batch height."""
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


@lru_cache(maxsize=None)
def _own(arch="gemma3-1b"):
    """A family's smoke config, the port's own weights and its static
    oracle."""
    cfg = get_arch(arch + "-smoke")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, BatchedServer(cfg, params, max_len=MAX_LEN,
                                      device="cpu")


_ORACLE = {}


def oracle(arch, prompt, max_new):
    key = (arch, tuple(int(t) for t in prompt), int(max_new))
    if key not in _ORACLE:
        _ORACLE[key] = _own(arch)[2].generate_static(
            np.asarray(prompt, np.int32)[None], max_new=int(max_new))[0]
    return _ORACLE[key]


def _prompts(n, seed=0, vocab=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(4, 14))).tolist()
            for _ in range(n)]


def _engine(arch="gemma3-1b", **kw):
    cfg, params, _ = _own(arch)
    kw.setdefault("slots", 2)
    kw.setdefault("pools", 2)
    kw.setdefault("placements", dict(BOTH))
    return ServeEngine(cfg, params, max_len=MAX_LEN, prefill_chunk=4,
                       decode_chunk=2, device="cpu", **kw)


def _run(eng, reqs, drain_at=None, add_at=None, add_kw=None,
         max_ticks=600):
    """Drive to completion with an optional drain of the first pool and a
    join, each before the tick of that number."""
    for t in range(max_ticks):
        if t == drain_at and len(eng.pools) > 1:
            eng.drain_pool(eng.pools[0].lid)
        if t == add_at:
            eng.add_pool(**(add_kw or {}))
        assert eng.tick()
        if all(len(r.tokens) >= r.max_new for r in reqs):
            return
    raise AssertionError("requests did not finish")


def _assert_oracle(arch, prompts, max_new, reqs):
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        assert r.done.is_set()
        np.testing.assert_array_equal(r.output(), oracle(arch, p, max_new),
                                      err_msg=f"req {i} plen={len(p)}")


def _into_decode(eng, reqs):
    """Tick until a request has emitted a token."""
    for _ in range(200):
        if any(r.tokens for r in reqs):
            return
        assert eng.tick()
    raise AssertionError("no token emitted")


# ------------------------------------------------------------ sharding units

def test_pool_mesh_axes():
    m = S.pool_mesh("cpu")
    assert m.axis_names == ("data", "model") and m.sizes == (1, 1)
    assert m.group == (torch.device("cpu"),) and m.devices == 1
    assert S.axis_size(m, "data") == 1 and S.axis_size(m, "model") == 1
    assert S.pool_mesh(torch.device("cpu")) == S.pool_mesh(["cpu"]) == m
    m2 = S.pool_mesh(["cpu", torch.device("cpu")])
    assert m2.sizes == (2, 1) and S.axis_size(m2, "data") == 2
    m2t = S.pool_mesh(["cpu"] * 2, tp=2)
    assert m2t.sizes == (1, 2) and S.axis_size(m2t, "model") == 2
    assert str(S.pool_mesh(["cpu"] * 4)) == "4x1"
    with pytest.raises(ValueError):
        S.pool_mesh([])
    with pytest.raises(ValueError):
        S.pool_mesh(["cpu"] * 3, tp=2)


def _norm(spec):
    """A spec's entries, a one-axis tuple written as the axis's name (the
    reference's PartitionSpec keeps what it was given)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_layout(path, shape, spec):
    """A port pool leaf's shape and spec in the reference's layout: its
    cache and draft leaves are ``[slots, n, 1, ...]`` (a stack of
    one-slot caches), where the port's are ``[n, slots, ...]``."""
    if path[0] not in ("caches", "draft"):
        return tuple(shape), _norm(spec)
    n, slots, *rest = shape
    s = _norm(spec)
    return (slots, n, 1, *rest), (s[1], s[0], None, *s[2:])


def _leaves(path, tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(path + (k,), tree[k], specs[k])
    else:
        yield path, tree, specs


@pytest.mark.parametrize("arch", FAMS)
@pytest.mark.parametrize("slots", [3, 4])
@pytest.mark.parametrize("sizes", [(1, 1), (2, 1), (1, 2), (4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pool_specs_match_reference(arch, slots, sizes):
    """The slot dim over ``data`` where it divides, else replicated; at
    ``model`` > 1 the first divisible dim past it: leaf for leaf the
    reference's specs on the same leaves (the reference's spec functions
    read only ``axis_names`` and ``shape``)."""
    cfg = get_arch(arch + "-smoke")
    pool = SlotPool(cfg, slots, 16, "cpu", truncated_draft_cfg(cfg, 1))
    data, model = sizes
    mesh = S.pool_mesh(["cpu"] * (data * model), tp=model)
    assert mesh.sizes == sizes
    tree = pool.state()
    assert set(tree) == {"caches", "draft", "ng", "ctx", "pos"}
    got = list(_leaves((), tree, S.pool_specs(mesh, tree)))
    ref_tree, want = {}, {}
    for path, x, spec in got:
        shape, spec_ref = _ref_layout(path, x.shape, spec)
        ref_tree[path] = np.broadcast_to(np.zeros((), np.int8), shape)
        want[path] = spec_ref
    ref = JS.pool_specs(mesh, ref_tree)
    assert {k: _norm(v) for k, v in ref.items()} == want
    # a leaf whose slot count the data axis divides splits; else replicated
    split = [p for p, x, spec in got if spec[1 if p[0] in ("caches", "draft")
                                             else 0]]
    assert bool(split) == (slots % data == 0)


# ---------------------------------------------------------- scheduling units

def test_placement_adjusted_frt_reduces_to_weighted():
    assert placement_adjusted_frt(2.0, 4.0) == \
        placement_adjusted_frt(2.0, 4.0, load=0.0, xfer=0.0) == 0.5
    assert placement_adjusted_frt(2.0, 1.0, load=1.0) == 4.0
    assert placement_adjusted_frt(2.0, 1.0, xfer=3.0) == 5.0
    for args in ((2.0, 4.0, 0.5, 0.0), (1.5, 2.0, 0.25, 0.75)):
        assert placement_adjusted_frt(*args) == \
            j_scheduler.placement_adjusted_frt(*args)


def test_choose_admission_pool_prefers_idle_device_group():
    opts = [{"pool": 0, "free": 1, "busy": 0.9, "devices": 1},
            {"pool": 1, "free": 1, "busy": 0.0, "devices": 1}]
    eng, ref = Engine(), JEngine()
    assert eng.choose_admission_pool(opts) == 1
    assert eng.decisions[-1]["decision"] == "admission_pool"
    ref.choose_admission_pool(opts)
    assert list(eng.decisions) == list(ref.decisions)


def test_choose_migration_dst_prefers_free_capacity():
    opts = [{"pool": 1, "free": 1, "busy": 0.0, "devices": 1},
            {"pool": 2, "free": 4, "busy": 0.0, "devices": 1}]
    eng, ref = Engine(), JEngine()
    assert eng.choose_migration_dst(opts) == 2
    assert eng.decisions[-1]["decision"] == "migration_dst"
    ref.choose_migration_dst(opts)
    assert list(eng.decisions) == list(ref.decisions)


# ------------------------------------------------ placed serving ≡ static

def test_placed_pools_match_oracle_and_unplaced():
    prompts = _prompts(4, seed=1)
    placed = _engine()
    plain = _engine(placements=None)
    rp = [placed.submit(p, max_new=10) for p in prompts]
    ru = [plain.submit(p, max_new=10) for p in prompts]
    _run(placed, rp)
    _run(plain, ru)
    _assert_oracle("gemma3-1b", prompts, 10, rp)
    for a, b in zip(rp, ru):
        np.testing.assert_array_equal(a.output(), b.output())
    ins = placed._inspect("status")
    assert ins["placement"] == {"placed_pools": 2, "migrated_slots": 0,
                                "parallel_group_ticks": 0}
    assert [p["devices"] for p in ins["pools"]] == [["cpu"], ["cpu"]]
    assert plain._inspect("status")["placement"]["placed_pools"] == 0
    assert "admission_pool" in {d["decision"]
                                for d in placed.engine.decisions}
    assert "admission_pool" not in {d["decision"]
                                    for d in plain.engine.decisions}


def test_placed_weights_are_the_engines_until_a_publish():
    """A pool placed on the engine's own device reads the engine's
    tensors, not a copy; the per-group copy is cached by the pool's
    devices and remade when a publish rebinds the weights."""
    cfg, params, _ = _own()
    eng = _engine()
    sp0, sp1 = eng.pools
    p0, _ = eng._params_for(sp0)
    assert eng._params_for(sp1)[0] is p0 and list(eng._pool_params) == \
        [(torch.device("cpu"),)]
    ptrs = {id(t) for v in eng.params.values()
            for t in (v.values() if isinstance(v, dict) else [v])}
    assert {id(t) for v in p0.values()
            for t in (v.values() if isinstance(v, dict) else [v])} == ptrs
    new = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    eng.update(params=new)
    eng.tick()
    assert not eng._pool_params or eng._pool_params[
        (torch.device("cpu"),)]["src"] is eng.params
    assert eng._params_for(sp0)[0]["embed"] is eng.params["embed"]


def test_batched_server_places_its_engine():
    cfg, params, srv = _own()
    prompts = np.asarray(_prompts(3, seed=11)[0])[None].repeat(3, 0)
    psrv = BatchedServer(cfg, params, max_len=MAX_LEN, slots=2, pools=2,
                         prefill_chunk=4, decode_chunk=2,
                         placements={1: "cpu"}, device="cpu")
    out = psrv.generate(prompts, max_new=6)
    eng = psrv.engine()
    assert list(eng.placements) == [1] and eng.pools[0].mesh is None
    assert eng._inspect("status")["placement"]["placed_pools"] == 1
    np.testing.assert_array_equal(
        out, srv.generate_static(prompts, max_new=6))


@pytest.mark.parametrize("arch", FAMS)
def test_migration_roundtrip_bit_identical(arch):
    cfg = _own(arch)[0]
    prompts = _prompts(2, seed=2, vocab=min(cfg.vocab, 100))
    eng = _engine(arch, slots=4)
    reqs = [eng.submit(p, max_new=12, pool=0) for p in prompts]
    _into_decode(eng, reqs)
    eng.drain_pool(0)
    _run(eng, reqs)
    assert eng.migrated_slots >= 1
    assert [sp.lid for sp in eng.pools] == [1]
    assert list(eng.placements) == [1]
    assert eng._inspect("status")["placement"]["migrated_slots"] == \
        eng.migrated_slots
    _assert_oracle(arch, prompts, 12, reqs)


@pytest.mark.parametrize("extra", [{"draft": "self"}, {"spec_decode": True}],
                         ids=["self-draft", "ngram"])
def test_migration_carries_proposer_state(extra):
    """Draft rows and n-gram tables move with the slot between placed
    pools; the forced speculative arm keeps every output exact, each
    pool's ticks reading its group's draft weights."""
    prompts = _prompts(2, seed=3)
    eng = _engine(slots=4, **extra)
    arm = "spec:draft" if "draft" in extra else "spec:ngram"
    eng.spec_decode = True
    orig = eng.engine.choose_serve_job

    def forced(cands):
        pid, mode = orig(cands)
        return pid, arm if mode.startswith(("decode", "spec")) else mode

    eng.engine.choose_serve_job = forced
    reqs = [eng.submit(p, max_new=12, pool=0) for p in prompts]
    _into_decode(eng, reqs)
    eng.drain_pool(0)
    before = eng.spec_ticks
    _run(eng, reqs)
    assert eng.migrated_slots >= 1
    assert eng.spec_ticks > before
    if "draft" in extra:
        assert eng._params_for(eng.pools[0])[1] is not None
    _assert_oracle("gemma3-1b", prompts, 12, reqs)


def test_drain_under_load_zero_dropped():
    prompts = _prompts(7, seed=4)
    eng = _engine()
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    _run(eng, reqs, drain_at=3)
    assert [sp.lid for sp in eng.pools] == [1]
    assert not eng.queue
    _assert_oracle("gemma3-1b", prompts, 8, reqs)


def test_join_while_saturated():
    """A pool added with a placement under backlog serves queued work
    without changing any output."""
    prompts = _prompts(6, seed=5)
    eng = _engine(pools=1, placements={0: "cpu"})
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    served = set()
    for t in range(600):
        if t == 2:
            assert eng.add_pool(placement="cpu", slots=2) == 1
        assert eng.tick()
        served.update(r.pool for r in reqs if r.pool >= 0)
        if all(len(r.tokens) >= r.max_new for r in reqs):
            break
    assert [sp.lid for sp in eng.pools] == [0, 1]
    assert eng.pools[1].mesh is not None and 1 in eng.placements
    assert 1 in served, "the joined pool never served a request"
    _assert_oracle("gemma3-1b", prompts, 8, reqs)


def test_prefix_snapshots_are_host_tensors():
    """Every snapshot leaf is a host tensor, so it seeds any pool, also
    after the pool that took it has drained away."""
    prompts = [[7] * 8 + [i + 1] for i in range(3)]
    eng = _engine(prefix_cache=True)
    reqs = [eng.submit(p, max_new=6, pool=0) for p in prompts]
    _run(eng, reqs)
    snaps = []

    def walk(node):
        if node.snapshot is not None:
            snaps.append(node.snapshot)
        for c in node.children.values():
            walk(c)

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    walk(eng.prefix.root)
    assert snaps, "no snapshots captured"
    for s in snaps:
        for leaf in leaves(s):
            assert isinstance(leaf, torch.Tensor) and leaf.device.type == \
                "cpu"
    eng.drain_pool(0)
    seeded = eng.prefix.seeded
    late = [7] * 8 + [9, 4]
    reqs.append(eng.submit(late, max_new=6))
    _run(eng, reqs[-1:])
    assert eng.prefix.seeded > seeded
    _assert_oracle("gemma3-1b", prompts + [late], 6, reqs)


def test_migration_xfer_term_reaches_candidates():
    prompts = _prompts(4, seed=6)
    eng = _engine()
    reqs = [eng.submit(p, max_new=16) for p in prompts]
    for _ in range(3):
        assert eng.tick()
    eng.drain_pool(0)
    eng._last_mig_dst = 1
    by_pool = {c.pool_id - eng.pool_id: c for c in eng._candidates()}
    assert 1 in by_pool and by_pool[1].xfer > 0
    assert all(c.xfer == 0 for lid, c in by_pool.items() if lid != 1)
    _run(eng, reqs)
    _assert_oracle("gemma3-1b", prompts, 16, reqs)


def test_load_term_reaches_candidates():
    """With placements a candidate's ``load`` is the occupied share of the
    other pools on its devices: > 0 for a pool that shares its device with
    an occupied placed pool, 0 for a pool alone on its group and on an
    engine without placements."""
    prompts = _prompts(4, seed=12)
    for placements in (dict(BOTH), None):
        eng = _engine(placements=placements)
        for i, p in enumerate(prompts):
            eng.submit(p, max_new=6, pool=i % 2)
        eng._admit()
        loads = {c.pool_id: c.load for c in eng._candidates()}
        assert set(loads) == {0, 1}
        if placements:
            assert all(v == 1.0 for v in loads.values())
            eng.pools[1].devices = lambda: ("another group",)
            assert {c.load for c in eng._candidates()} == {0.0}
        else:
            assert all(v == 0.0 for v in loads.values())


# ------------------------------------------- decisions equal the reference

@lru_cache(maxsize=None)
def _shared_weights():
    params = jax.jit(j_lm.init, static_argnums=0)(j_get_arch(
        "gemma3-1b-smoke"), jax.random.PRNGKey(0))
    return params, bridge.from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")


def _frozen(engine_cls, pool_kind, pools):
    """An Engine whose per-pool tick costs are seeded (pool p at (p + 1)
    ms a token) and which observes nothing."""
    e = engine_cls()
    for p in range(pools):
        for kind in ("serve_decode", "serve_prefill"):
            for _ in range(2):
                e.costs.observe(pool_kind(kind, p) + "_per_tok",
                                1e-3 * (p + 1))
    e.observe = lambda job, seconds: None
    return e


def test_placed_decisions_match_reference():
    """Both engines placed on their one device, the same drain (pool 0 at
    tick 3) and placed join (tick 6) under one frozen CostBook: the same
    decisions, every ``admission_pool``, ``migration_dst`` and
    ``serve_job`` record with its scores (the ``load`` term in them), the
    same migrated slots and pools.  The port's tokens are held to its own
    oracle."""
    params_j, params_t = _shared_weights()
    prompts = _prompts(7, seed=4)
    kw = dict(max_len=MAX_LEN, slots=2, prefill_chunk=4, decode_chunk=2,
              pools=2)
    cpu = jax.devices()[:1]
    ref = j_serve.ServeEngine(j_get_arch("gemma3-1b-smoke"), params_j,
                              engine=_frozen(JEngine, j_jobs.pool_kind, 3),
                              placements={0: cpu, 1: cpu}, **kw)
    eng = ServeEngine(get_arch("gemma3-1b-smoke"), params_t, device="cpu",
                      engine=_frozen(Engine, jobs.pool_kind, 3),
                      placements=dict(BOTH), **kw)
    ref_reqs = [ref.submit(p, max_new=8) for p in prompts]
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    _run(ref, ref_reqs, drain_at=3, add_at=6, add_kw={"placement": cpu})
    _run(eng, reqs, drain_at=3, add_at=6, add_kw={"placement": "cpu"})
    want = list(ref.engine.decisions)
    kinds = {d["decision"] for d in want}
    assert {"admission_pool", "migration_dst", "serve_job"} <= kinds
    assert list(eng.engine.decisions) == want
    assert eng.migrated_slots == ref.migrated_slots > 0
    assert [sp.lid for sp in eng.pools] == [sp.lid for sp in ref.pools]
    assert sorted(eng.placements) == sorted(ref.placements)
    assert eng.tick_no == ref.tick_no
    srv = BatchedServer(get_arch("gemma3-1b-smoke"), params_t,
                        max_len=MAX_LEN, device="cpu")
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(np.asarray(p, np.int32)[None],
                                            max_new=8)[0])


# ------------------------------------------------------------------ refusals

def test_refuses_what_does_not_run():
    """A placement on another device type (``"cuda"`` too) and a
    placement of a pool that does not exist raise; nothing falls back.  A
    pool mesh of two devices (the rows split over them) and a
    tensor-parallel pool (``pool_tp=2``) run: each serves to the end, the
    split pool equal to the oracle (its shard's height: the native GEMM's
    rows do not depend on it) and the tensor-parallel one emitting its
    tokens (its split products round otherwise;
    tests/test_torch_pool_mesh.py holds it under the near-tie rule)."""
    cfg, params, _ = _own()
    with pytest.raises(ValueError, match="device type"):
        _engine(placements={0: "cuda:0"})
    eng = _engine(placements=None)
    with pytest.raises(ValueError, match="device type"):
        eng.add_pool(placement=torch.device("cuda", 0))
    # a card without an index is refused by its type, before any card
    # is asked for its index
    with pytest.raises(ValueError, match="device type"):
        eng.add_pool(placement="cuda")
    with pytest.raises(ValueError, match="no such pool"):
        _engine(placements={2: "cpu"})
    assert [sp.lid for sp in eng.pools] == [0, 1] and not eng.placements
    prompts = _prompts(3, seed=5)
    split = eng.add_pool(placement=["cpu", "cpu"])
    tp = eng.add_pool(placement=S.pool_mesh(["cpu"] * 2, tp=2))
    lay = {p["lid"]: p["layout"] for p in eng._inspect("status")["pools"]
           if p["devices"]}
    assert lay[split]["rows"] == "split" and lay[split]["tp"] == 1
    assert lay[tp]["rows"] == "whole" and lay[tp]["tp"] == 2
    reqs = [eng.submit(p, max_new=6, pool=split) for p in prompts[:2]]
    _run(eng, reqs)
    _assert_oracle("gemma3-1b", prompts[:2], 6, reqs)
    reqs = [eng.submit(p, max_new=6, pool=tp) for p in prompts]
    _run(eng, reqs)
    assert all(len(r.output()) == 6 for r in reqs)
    tp2 = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve,
                                                             pool_tp=2))
    eng = ServeEngine(tp2, params, max_len=MAX_LEN, pools=2,
                      placements={0: ["cpu", "cpu"]}, device="cpu")
    assert eng.pools[0].tp == 2 and eng.pools[1].mesh is None
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    _run(eng, reqs)
    assert all(len(r.output()) == 6 for r in reqs)


# ---------------------------------------------------------- the group path

def test_parallel_group_tick_path():
    """The two placed pools given distinct device-group keys on the one
    CPU device: rounds co-tick the other pool, every plan of a round is
    dispatched before any host copy is made, one copy a pool, and every
    output is the oracle's.  This checks plan -> dispatch -> commit; it
    does not measure an overlap (that needs two cards)."""
    prompts = _prompts(4, seed=7)
    eng = _engine()
    for sp in eng.pools:
        sp.devices = lambda lid=sp.lid: (f"group {lid}",)
    events = []
    dispatch, collect = eng._tick.dispatch, SlotTick.collect

    def logged_dispatch(pool, *a, **k):
        events.append(("dispatch", pool.lid))
        return dispatch(pool, *a, **k)

    def logged_collect(out, n_valid):
        events.append(("copy",))
        return collect(out, n_valid)

    eng._tick.dispatch = logged_dispatch
    eng._tick.collect = logged_collect
    reqs = [eng.submit(p, max_new=10) for p in prompts]
    rounds = []
    for _ in range(600):
        events.clear()
        assert eng.tick()
        if events:
            rounds.append(list(events))
        if all(len(r.tokens) >= r.max_new for r in reqs):
            break
    assert eng.parallel_group_ticks > 0
    co = [r for r in rounds if len(r) == 4]
    assert len(co) == eng.parallel_group_ticks
    for r in co:
        assert [e[0] for e in r] == ["dispatch", "dispatch", "copy", "copy"]
        assert {e[1] for e in r[:2]} == {0, 1}
    assert all(len(r) in (2, 4) for r in rounds)
    assert eng._inspect("status")["placement"]["parallel_group_ticks"] == \
        eng.parallel_group_ticks
    _assert_oracle("gemma3-1b", prompts, 10, reqs)
    # with parallel ticks off the same pools run one pool a round
    cfg, params, _ = _own()
    off = ServeEngine(dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, parallel_ticks=False)), params, max_len=MAX_LEN,
        slots=2, pools=2, prefill_chunk=4, decode_chunk=2,
        placements=dict(BOTH), device="cpu")
    for sp in off.pools:
        sp.devices = lambda lid=sp.lid: (f"group {lid}",)
    reqs = [off.submit(p, max_new=10) for p in prompts]
    _run(off, reqs)
    assert off.parallel_group_ticks == 0
    _assert_oracle("gemma3-1b", prompts, 10, reqs)


def test_parallel_group_ticks_on_disjoint_devices():
    """Pools on two cards: rounds co-tick, outputs equal the oracle's, and
    a sampled request moved between the cards keeps its stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices: pools on disjoint cards")
    cfg = get_arch("gemma3-1b-smoke")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cuda:0")
    srv = BatchedServer(cfg, params, max_len=MAX_LEN, device="cuda:0")
    prompts = _prompts(4, seed=7)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=2, pools=2,
                      prefill_chunk=4, decode_chunk=2, device="cuda:0",
                      placements={0: "cuda:0", 1: "cuda:1"})
    reqs = [eng.submit(p, max_new=10) for p in prompts]
    _run(eng, reqs)
    assert eng.parallel_group_ticks > 0
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(np.asarray(p, np.int32)[None],
                                            max_new=10)[0])
    outs = []
    for drain in (False, True):
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4, pools=2,
                          prefill_chunk=4, decode_chunk=2, device="cuda:0",
                          placements={0: "cuda:0", 1: "cuda:1"})
        reqs = [eng.submit(p, max_new=10, temperature=0.9, pool=0)
                for p in prompts[:2]]
        _into_decode(eng, reqs)
        if drain:
            eng.drain_pool(0)
        _run(eng, reqs)
        outs.append([r.output() for r in reqs])
    assert eng.migrated_slots == 2
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_tp_pool_over_two_cards():
    """The MoE smoke model with the fused kernels in a ``pool_tp = 2`` pool
    over ``cuda:0`` and ``cuda:1`` (its step a graph per shard and stage,
    each on its shard's card, the copies between the cards outside): the
    tokens of the same pool over the one card named twice, and, stepped
    from one state, the same logits and argmax at every step."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices: a TP pool across cards")
    from repro_torch.engine.serve import StagedStep, build_decode_step
    from repro_torch.models import tp
    from repro_torch.runtime.serve import serving_params
    base = get_arch("paper-moe-100m-smoke")
    cfg = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, fused_gating=True,
                                      fused_dispatch=True),
        serve=dataclasses.replace(base.serve, pool_tp=2))
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    params = lm.init(cfg, torch.Generator(device=c0).manual_seed(0),
                     device=c0)
    groups = ([c0, c1], [c0, c0])
    prompts = _prompts(6, seed=8)
    outs = []
    for group in groups:
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4,
                          prefill_chunk=4, decode_chunk=2,
                          compact_decode=False, placements={0: group},
                          device=c0)
        reqs = [eng.submit(p, max_new=10) for p in prompts]
        _run(eng, reqs)
        outs.append([r.output() for r in reqs])
        staged = [g for g in eng._tick.graphs.values()
                  if isinstance(g, StagedStep)]
        assert staged and {st.device for st in staged[0].stages} == \
            set(group)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    serving = serving_params(params, c0)
    pools = [SlotPool(cfg, 4, MAX_LEN, None, mesh=S.pool_mesh(g, tp=2))
             for g in groups]
    rng = np.random.default_rng(9)
    rows = {k: v.to(c0) for k, v in pools[1].read_rows(range(4),
                                                      pos=True).items()}
    for k, v in rows.items():
        if v.dtype.is_floating_point:
            rows[k] = torch.randn(v.shape, device=c0).to(v.dtype)
    rows[("pos",)] = torch.as_tensor(rng.integers(0, 20, 4), device=c0)
    runs = []
    for pool in pools:
        pool.write_rows(range(4), rows)
        tick = SlotTick(cfg, c0, graph=True)
        runs.append(tick.runner("step", tp.split_params(
            serving, cfg, 2, pool.group), None, pool))
    assert isinstance(runs[0], StagedStep)
    active = torch.tensor([True, True, False, True], device=c0)
    tok = torch.as_tensor(rng.integers(1, cfg.vocab, 4), device=c0)
    for _ in range(6):
        (la, ga), (lb, gb) = [tuple(t.clone() for t in run(tok, active))
                              for run in runs]
        assert torch.equal(la, lb) and torch.equal(ga, gb)
        tok = ga
    got = [p.read_rows(range(4), pos=True) for p in pools]
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cuda_placed_pools_on_the_graphed_tick():
    """The MoE smoke model with the fused kernels on 2 graphed pools of 4
    slots placed on the card (by two names of it): the tokens of the same
    engine unplaced, bit for bit, through a drain of pool 0 and a placed
    join; each placed pool's weights are the engine's tensors; every
    launch is a replay's or a capture's warm-up step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import LAUNCHES, reset_launches
    cuda = torch.device("cuda")
    base = get_arch("paper-moe-100m-smoke")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, fused_gating=True, fused_dispatch=True))
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 9, 3, 12, 7, 4, 6, 10, 8, 11)]
    outs = []
    for placements in (None, {0: "cuda:0", 1: torch.device("cuda", 0)}):
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4, pools=2,
                          prefill_chunk=8, decode_chunk=2,
                          compact_decode=False, placements=placements,
                          device=cuda)
        reset_launches()
        reqs = [eng.submit(p, max_new=10) for p in prompts]
        graphs = {}
        for _ in range(2000):
            if all(r.done.is_set() for r in reqs):
                break
            if eng._pool(0) is not None \
                    and any(r.tokens for r in reqs if r.pool == 0) \
                    and not eng._pool(0).draining:
                eng.drain_pool(0)
                eng.add_pool(placement=None if placements is None
                             else [torch.device("cuda", 0)])
            assert eng.tick()
            graphs.update(eng._tick.graphs)
        outs.append([r.output() for r in reqs])
        want = {k: sum((g.replays + 1) * g.per_replay[k]
                       for g in graphs.values()) for k in LAUNCHES}
        assert dict(LAUNCHES) == want and want["moe_gating"] > 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert eng.migrated_slots > 0 and sorted(eng.placements) == [1, 2]
    for sp in eng.pools:
        p, _ = eng._params_for(sp)
        assert p["embed"].data_ptr() == eng.params["embed"].data_ptr()
