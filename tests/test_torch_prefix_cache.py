"""The port's prefix cache and result cache: the radix tree, the result
LRU, the request fingerprint and the workload analyzer against the JAX
package's (``repro.engine.prefix_cache``), call for call; and the engine's
use of them at smoke size.

* A seeded sequence of ``insert``, ``longest_match``, ``lookup``,
  ``acquire``, ``release``, ``pin``, ``flush_versions``, ``result_store``
  and ``result_lookup`` calls drives both caches: every return (a node
  compared by its path, snapshot, version, position, hits, refs and pin)
  and ``stats()`` after every call equal exactly.
* In the port's engine: shared-prefix requests seed their slots, and their
  outputs equal both ``generate_static`` and a prefix-off engine, for the
  MoE family, the recurrent ones and ``gemma3-1b`` (a snapshot copies
  whole rolling ``local`` rings, and the prompts wrap them); an
  exact repeat is answered without a slot or a tick; sampled requests never
  seed or store; the cache toggles hot; a ``params_version`` bump keys the
  result cache and flushes the snapshots.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.engine import prefix_cache as j_pc
from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.engine import prefix_cache as t_pc
from repro_torch.models import lm
from repro_torch.runtime.serve import BatchedServer

ARCHS = ["paper-moe-100m-smoke", "rwkv6-1.6b-smoke", "zamba2-7b-smoke",
         "gemma3-1b-smoke"]
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops run fastest on one thread, and the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _node(n):
    if n is None:
        return None
    path, m = [], n
    while m is not None and m.parent is not None:
        path = list(m.edge) + path
        m = m.parent
    return (tuple(path), n.depth, n.snapshot, n.version, n.pos, n.hits,
            n.refs, n.pinned)


def _drive(cache_mod, seed, n_ops=400):
    """One seeded op sequence over a small vocabulary of shared prefixes
    (so paths split, match and evict); returns every call's result and the
    stats after it."""
    rng = np.random.default_rng(seed)
    pc = cache_mod.PrefixCache(capacity=6, min_len=3, result_entries=5)
    stems = [rng.integers(0, 4, rng.integers(2, 9)) for _ in range(6)]
    acquired, log = [], []

    def toks():
        stem = stems[rng.integers(len(stems))]
        tail = rng.integers(0, 4, rng.integers(0, 6))
        return np.concatenate([stem, tail]).astype(
            [np.int32, np.int64][rng.integers(2)])

    for i in range(n_ops):
        op = rng.choice(["insert", "match", "lookup", "acquire", "release",
                         "pin", "flush", "store", "result"],
                        p=[.25, .2, .1, .08, .08, .04, .03, .12, .1])
        ver = int(rng.integers(0, 2))
        if op == "insert":
            r = _node(pc.insert(toks(), snapshot=(
                None if rng.random() < 0.2 else f"row{i}"), version=ver))
        elif op == "match":
            t = toks()
            limit = None if rng.random() < 0.5 else int(
                rng.integers(1, len(t) + 1))
            n = pc.longest_match(t, limit=limit,
                                 version=None if rng.random() < 0.3 else ver)
            r = _node(n)
            if n is not None and rng.random() < 0.5:
                acquired.append(n)
        elif op == "lookup":
            r = _node(pc.lookup(toks()))
        elif op == "acquire":
            n = pc.lookup(toks())
            if n is not None:
                pc.acquire(n)
                acquired.append(n)
            r = _node(n)
        elif op == "release":
            r = None
            if acquired:
                n = acquired.pop(int(rng.integers(len(acquired))))
                if n.refs:
                    pc.release(n)
                r = _node(n)
        elif op == "pin":
            r = pc.pin(toks())
        elif op == "flush":
            r = pc.flush_versions(ver)
        elif op == "store":
            out = rng.integers(0, 50, rng.integers(1, 8))
            r = pc.result_store(toks(), int(rng.integers(1, 8)),
                                float(rng.choice([-1.0, 0.0, 0.7])), ver,
                                out)
        else:
            r = pc.result_lookup(toks(), int(rng.integers(1, 8)),
                                 float(rng.choice([-1.0, 0.0, 0.7])), ver)
        log.append((str(op), r, pc.stats(), pc.snapshots, pc.pinned))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_matches_reference_call_for_call(seed):
    ref, got = _drive(j_pc, seed), _drive(t_pc, seed)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a == b, f"call {i}: {a} != {b}"
    ops = {op for op, *_ in ref}
    assert len(ops) == 9


def test_fingerprint_and_analyzer_match_reference(rng):
    for _ in range(200):
        toks = rng.integers(0, 100, rng.integers(0, 12))
        toks = toks.astype([np.int32, np.int64][rng.integers(2)])
        if rng.random() < 0.3:
            toks = toks.tolist()
        args = (int(rng.integers(1, 9)),
                float(rng.choice([-1.0, 0.0, 0.5])), int(rng.integers(3)))
        assert t_pc.request_fingerprint(toks, *args) == \
            j_pc.request_fingerprint(toks, *args)
    an = [m.PrefixAnalyzer(min_len=2, pin_count=3, history=40)
          for m in (j_pc, t_pc)]
    stems = [rng.integers(0, 5, 10) for _ in range(4)]
    for i in range(120):
        p = np.concatenate([stems[rng.integers(4)][:rng.integers(2, 11)],
                            rng.integers(0, 5, rng.integers(0, 6))])
        for a in an:
            a.record(p)
        if i % 10 == 9:
            assert an[0].hot_prefixes() == an[1].hot_prefixes()
    assert an[0].hot_prefixes()


def test_to_host_copies():
    row = {"caches": {"moe": {"k": torch.ones(2, 3)}}, "ng": torch.ones(4)}
    host = t_pc.to_host(row)
    row["caches"]["moe"]["k"].zero_()
    assert host["caches"]["moe"]["k"].sum() == 6 and \
        host["ng"].device.type == "cpu"


@lru_cache(maxsize=None)
def _own(arch):
    cfg = get_arch(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, fused_gating=True, fused_dispatch=True))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, BatchedServer(cfg, params, max_len=MAX_LEN,
                                      device="cpu")


def _engine(arch, **kw):
    cfg, params, _ = _own(arch)
    return ServeEngine(cfg, params, max_len=MAX_LEN, slots=2,
                       prefill_chunk=4, decode_chunk=2, device="cpu", **kw)


def _shared_prompts(rng, vocab, n=5):
    shared = rng.integers(1, vocab, 12).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, vocab, k).astype(
        np.int32)]) for k in (3, 5, 2, 6, 4)[:n]]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_seeding_equals_static_and_prefix_off(rng, arch):
    cfg, _, srv = _own(arch)
    prompts = _shared_prompts(rng, cfg.vocab)
    outs = {}
    for on in (False, True):
        eng = _engine(arch, prefix_cache=on)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run_until_done()
        outs[on] = [r.output() for r in reqs]
    st = eng.prefix.stats()
    assert st["seeded"] > 0 and st["tokens_avoided"] > 0
    assert st["snapshots"] > 0
    for p, a, b in zip(prompts, outs[False], outs[True]):
        ref = srv.generate_static(p[None], 8)[0]
        np.testing.assert_array_equal(a, ref)
        np.testing.assert_array_equal(b, ref)


def test_exact_repeat_takes_no_slot(rng):
    arch = ARCHS[0]
    cfg, _, srv = _own(arch)
    eng = _engine(arch, prefix_cache=True)
    prompts = _shared_prompts(rng, cfg.vocab, 3)
    first = eng.generate(prompts, 8)
    ticks = eng.tick_no
    eng.submit(prompts[0], max_new=40)      # longer than stored: a miss
    reqs = [eng.submit(p, n) for p, n in zip(prompts, (8, 5, 1))]
    eng.tick()                              # admits; repeats finish here
    assert all(r.done.is_set() and r.slot == -1 for r in reqs)
    for r, f, n in zip(reqs, first, (8, 5, 1)):
        np.testing.assert_array_equal(r.output(), f[:n])
    assert eng.prefix.result_hits == 3
    eng.run_until_done()
    assert eng.tick_no > ticks              # the longer request ran
    # repeats with nothing else queued: the engine's tick admits them and
    # returns idle, so no work tick runs
    ticks = eng.tick_no
    again = eng.generate(prompts, 8)
    np.testing.assert_array_equal(again, first)
    assert eng.tick_no == ticks
    np.testing.assert_array_equal(
        first[0], srv.generate_static(prompts[0][None], 8)[0])


def test_sampled_requests_never_seed_or_store(rng):
    arch = ARCHS[0]
    cfg, _, _ = _own(arch)
    eng = _engine(arch, prefix_cache=True)
    prompts = _shared_prompts(rng, cfg.vocab, 3)
    eng.generate(prompts, 6, temperature=0.8, seed=3)
    st = eng.prefix.stats()
    assert st["seeded"] == 0 and st["result_entries"] == 0
    assert st["snapshots"] > 0              # prefill boundaries still snap
    eng.generate(prompts, 6, temperature=0.8, seed=3)
    st2 = eng.prefix.stats()
    assert st2["seeded"] == 0 and st2["result_hits"] == 0


def test_prefix_cache_hot_toggle_and_version_keying(rng):
    arch = ARCHS[0]
    cfg, _, srv = _own(arch)
    eng = _engine(arch)
    prompts = _shared_prompts(rng, cfg.vocab, 3)
    eng.update(prefix_cache=True)
    first = eng.generate(prompts, 6)
    assert eng.prefix is not None and eng.prefix.stats()["seeded"] > 0
    assert eng._inspect("x")["prefix_cache"]["enabled"]
    # a version bump: stored answers and snapshots of version 0 no longer
    # serve (same weights here, so the outputs stay the same)
    eng.update(params_version=1)
    eng.tick()
    assert eng.params_version == 1 and eng.prefix.snapshots == 0
    hits = eng.prefix.result_hits
    again = eng.generate(prompts, 6)
    assert eng.prefix.result_hits == hits
    np.testing.assert_array_equal(again, first)
    eng.generate(prompts, 6)
    assert eng.prefix.result_hits == hits + 3   # stored under version 1
    eng.update(prefix_cache=False)
    eng.tick()
    assert eng.prefix is None
    assert eng._inspect("x")["prefix_cache"] == {"enabled": False}
    np.testing.assert_array_equal(eng.generate(prompts, 6), first)
    np.testing.assert_array_equal(
        first[1], srv.generate_static(prompts[1][None], 6)[0])
