"""Elastic slot pools and live slot migration in the port's serve engine
(the reference's single-device cases of tests/test_pool_placement.py,
without placements).

A slot's row, position and sampling generator determine its continuation,
so migration may only relocate work: every greedy output equals the
port's own ``generate_static`` token for token, across every cache family
(KV attention with a rolling local cache: gemma3; recurrent state: rwkv6;
SSM + attention: zamba2), with the draft rows and n-gram tables riding
along, and no request drops.  The reference's own version of these tests
is not the oracle: it parts on an exact bf16 tie in its one-row oracle.

Also: the pools addressed by list position (a request served after pool 0
drained away), the ``pool_id`` offset of two engines sharing one
``Engine``, the sampling stream carried across a move, and decision
parity with the reference: one frozen seeded CostBook in both engines,
the same drain and join, the same decisions (every ``migration_dst`` and
``serve_job`` record) and the same ``migrated_slots``.

As in tests/test_torch_compact.py the tests run torch's native CPU GEMM
(``torch.backends.mkldnn`` off), whose rows do not depend on the batch
height.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.engine import Engine as JEngine
from repro.engine import jobs as j_jobs
from repro.engine import serve as j_serve
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.engine import Engine, ServeEngine
from repro_torch.engine import jobs
from repro_torch.models import bridge, lm
from repro_torch.runtime.serve import BatchedServer

MAX_LEN = 64
FAMS = ["gemma3-1b", "rwkv6-1.6b", "zamba2-7b"]


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
    return ServeEngine(cfg, params, max_len=MAX_LEN, prefill_chunk=4,
                       decode_chunk=2, device="cpu", **kw)


def _run(eng, reqs, drain_at=None, add_at=None, max_ticks=600):
    """Drive to completion with an optional drain of the first pool and a
    join, each before the tick of that number."""
    for t in range(max_ticks):
        if t == drain_at and len(eng.pools) > 1:
            eng.drain_pool(eng.pools[0].lid)
        if t == add_at:
            eng.add_pool()
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
    """Tick until a request has emitted a token: a move after it carries
    the consumed prompt and generated tokens in the rows."""
    for _ in range(200):
        if any(r.tokens for r in reqs):
            return
        assert eng.tick()
    raise AssertionError("no token emitted")


# ---------------------------------------------------- migration ≡ static

@pytest.mark.parametrize("arch", FAMS)
def test_migration_roundtrip_bit_identical(arch):
    cfg = _own(arch)[0]
    prompts = _prompts(2, seed=2, vocab=min(cfg.vocab, 100))
    eng = _engine(arch, slots=4)
    reqs = [eng.submit(p, max_new=12, pool=0) for p in prompts]
    _into_decode(eng, reqs)
    eng.drain_pool(0)
    _run(eng, reqs)
    assert eng.migrated_slots == 2
    assert [sp.lid for sp in eng.pools] == [1]
    assert all(r.pool == -1 for r in reqs)
    _assert_oracle(arch, prompts, 12, reqs)


@pytest.mark.parametrize("extra", [{"draft": "self"}, {"spec_decode": True}],
                         ids=["self-draft", "ngram"])
def test_migration_carries_proposer_state(extra):
    """The draft rows and the n-gram tables are row leaves of the pool, so
    they move with the slot; the forced speculative arm keeps every
    output exact and accepts drafts after the move."""
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
    _assert_oracle("gemma3-1b", prompts, 12, reqs)


def test_migration_carries_the_sampling_stream():
    """A sampled request keeps its generator (the same object, not
    re-seeded) across a move: its tokens equal an unmigrated run's."""
    prompts = _prompts(2, seed=8)
    outs = []
    for drain in (False, True):
        eng = _engine(slots=4)
        reqs = [eng.submit(p, max_new=10, temperature=0.9, pool=0)
                for p in prompts]
        _into_decode(eng, reqs)
        gens = [eng._pool(0).gens[r.slot] for r in reqs]
        if drain:
            eng.drain_pool(0)
            assert eng.tick()
            assert [eng._pool(1).gens[r.slot] for r in reqs] == gens
        _run(eng, reqs)
        outs.append([r.output() for r in reqs])
    assert eng.migrated_slots == 2
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_drain_under_load_zero_dropped():
    """A saturated fleet with a backlog, drained mid-run: every request,
    in flight or queued, finishes ≡ the oracle; none drops."""
    prompts = _prompts(7, seed=4)
    eng = _engine()
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    _run(eng, reqs, drain_at=3)
    assert [sp.lid for sp in eng.pools] == [1]
    assert not eng.queue
    _assert_oracle("gemma3-1b", prompts, 8, reqs)


def test_join_while_saturated():
    """A pool added under backlog serves queued work without changing any
    output."""
    prompts = _prompts(6, seed=5)
    eng = _engine(pools=1)
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    served = set()
    for t in range(600):
        if t == 2:
            assert eng.add_pool(slots=2) == 1
        assert eng.tick()
        served.update(r.pool for r in reqs if r.pool >= 0)
        if all(len(r.tokens) >= r.max_new for r in reqs):
            break
    assert [sp.lid for sp in eng.pools] == [0, 1]
    assert 1 in served, "the joined pool never served a request"
    _assert_oracle("gemma3-1b", prompts, 8, reqs)


def test_drain_and_join_refuse_bad_input():
    eng = _engine(pools=1)
    with pytest.raises(ValueError):
        eng.drain_pool(0)                   # the last admissible pool
    with pytest.raises(ValueError):
        eng.drain_pool(3)                   # no such pool
    with pytest.raises(ValueError):
        eng.add_pool(placement="cuda:1")    # another device type
    lid = eng.add_pool()
    eng.drain_pool(0)
    with pytest.raises(ValueError):
        eng.drain_pool(lid)                 # pool 0 is draining already
    with pytest.raises(ValueError):
        eng.submit([1, 2, 3], pool=0)       # a draining pool admits nothing


def test_prefix_snapshots_survive_their_pool_being_drained():
    """Every snapshot leaf is a host tensor, so a snapshot taken on a pool
    seeds another pool after the first has drained away."""
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
    assert [sp.lid for sp in eng.pools] == [1]
    assert eng.prefix.seeded > seeded
    _assert_oracle("gemma3-1b", prompts + [late], 6, reqs)


def test_migration_xfer_term_reaches_candidates():
    """While a drain routes into a pool, that pool's candidates carry the
    pending batches times the serve_migrate cost; the others none."""
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


def test_request_served_after_pool_zero_drained_away():
    """Pools are looked up by lid, not list position: once pool 0 has
    drained away, pool 1 sits at position 0, and a new request must still
    join, evict and equal the oracle.  One pool of one class is left, so
    the tick is back on ``choose_serve_tick``."""
    prompts = _prompts(3, seed=9)
    eng = _engine()
    reqs = [eng.submit(p, max_new=6, pool=1) for p in prompts[:2]]
    eng.drain_pool(0)
    _run(eng, reqs)
    assert [sp.lid for sp in eng.pools] == [1] and eng.single_pool
    assert eng.migrated_slots == 0
    n = len(eng.engine.decisions)
    reqs.append(eng.submit(prompts[2], max_new=6))
    _run(eng, reqs[-1:])
    assert reqs[-1].done.is_set()
    assert "serve_tick" in {d["decision"]
                            for d in list(eng.engine.decisions)[n:]}
    _assert_oracle("gemma3-1b", prompts, 6, reqs)
    pools = eng._inspect("status")["pools"]
    assert pools == [{"id": 1, "lid": 1, "slots": 2, "free": 2,
                      "draining": False, "devices": None}]


def test_pool_id_namespaces_engines_sharing_one_engine():
    """Two ServeEngines on one Engine: pools get cost-kind ids pool_id..,
    so each engine's per-pool EMAs stay its own; routing keeps the lids."""
    shared = Engine()
    a = _engine(pools=2, engine=shared)
    b = _engine(pools=1, engine=shared, pool_id=2)
    prompts = _prompts(4, seed=10)
    ra = [a.submit(p, max_new=6) for p in prompts[:3]]
    rb = [b.submit(prompts[3], max_new=6, pool=0)]
    _run(a, ra)
    _run(b, rb)
    assert [p["id"] for p in b._inspect("status")["pools"]] == [2]
    assert b.add_pool() == 1 and b._pool(1).pool_id == 3
    seen = set(shared.costs.snapshot())
    for pid in (0, 1, 2):
        assert jobs.pool_kind("serve_prefill", pid) + "_per_tok" in seen
    _assert_oracle("gemma3-1b", prompts, 6, ra + rb)


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


def test_drain_decisions_match_reference():
    """The same drain (pool 0 at tick 3) and join (tick 6) under one
    frozen CostBook: the reference and the port make the same decisions,
    every ``migration_dst`` and ``serve_job`` record with its scores, and
    move the same slots.  Scheduling depends on lengths, not on token
    values, so the reference's bf16 tie cannot move a decision; the
    port's tokens are held to its own oracle."""
    params_j, params_t = _shared_weights()
    prompts = _prompts(7, seed=4)
    kw = dict(max_len=MAX_LEN, slots=2, prefill_chunk=4, decode_chunk=2,
              pools=2)
    ref = j_serve.ServeEngine(j_get_arch("gemma3-1b-smoke"), params_j,
                              engine=_frozen(JEngine, j_jobs.pool_kind, 3),
                              **kw)
    eng = ServeEngine(get_arch("gemma3-1b-smoke"), params_t, device="cpu",
                      engine=_frozen(Engine, jobs.pool_kind, 3), **kw)
    ref_reqs = [ref.submit(p, max_new=8) for p in prompts]
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    _run(ref, ref_reqs, drain_at=3, add_at=6)
    _run(eng, reqs, drain_at=3, add_at=6)
    want = list(ref.engine.decisions)
    assert any(d["decision"] == "migration_dst" for d in want)
    assert list(eng.engine.decisions) == want
    assert eng.migrated_slots == ref.migrated_slots > 0
    assert [sp.lid for sp in eng.pools] == [sp.lid for sp in ref.pools]
    assert eng.tick_no == ref.tick_no
    srv = BatchedServer(get_arch("gemma3-1b-smoke"), params_t,
                        max_len=MAX_LEN, device="cpu")
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(np.asarray(p, np.int32)[None],
                                            max_new=8)[0])


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_migration_on_the_graphed_tick(cuda):
    """The MoE smoke model with the fused kernels on 2 graphed pools of 4
    slots: pool 0 drained mid-stream and a pool joined under load give
    the tokens of the same engine left alone, bit for bit; the rows land
    in the destination's tensors (no graph rebound), pool 0's graphs go
    and the pool is freed, the joined pool's graph is captured on first
    use, and every launch is a replay's or a capture's warm-up step."""
    import gc
    import weakref

    from repro_torch.kernels import LAUNCHES, reset_launches
    base = get_arch("paper-moe-100m-smoke")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, fused_gating=True, fused_dispatch=True))
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 9, 3, 12, 7, 4, 6, 10, 8, 11)]
    outs = []
    for drain in (False, True):
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4, pools=2,
                          prefill_chunk=8, decode_chunk=2,
                          compact_decode=False, device=cuda)
        reset_launches()
        reqs = [eng.submit(p, max_new=10) for p in prompts]
        pool0 = weakref.ref(eng._pool(0))
        graphs = {}
        for _ in range(2000):
            if all(r.done.is_set() for r in reqs):
                break
            if drain and eng._pool(0) is not None \
                    and any(r.tokens for r in reqs if r.pool == 0) \
                    and not eng._pool(0).draining:
                eng.drain_pool(0)
                eng.add_pool()
            assert eng.tick()
            graphs.update(eng._tick.graphs)
        outs.append([r.output() for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert eng.migrated_slots > 0
    assert [sp.lid for sp in eng.pools] == [1, 2]
    assert not any(k[0] == 0 for k in eng._tick.graphs)
    assert (2, "step", 4) in eng._tick.graphs
    want = {k: sum((g.replays + 1) * g.per_replay[k]
                   for g in graphs.values()) for k in LAUNCHES}
    assert dict(LAUNCHES) == want and want["moe_gating"] > 0
    graphs.clear()
    gc.collect()
    assert pool0() is None
