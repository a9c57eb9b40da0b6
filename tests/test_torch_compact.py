"""Compact decode in the port's serve engine.

* Greedy output with compact decode forced on, forced off and left to
  ``Engine.choose_compact`` equals ``generate_static`` token for token, on
  the reference's tests/test_moe_dispatch.py compact case (four requests
  of mixed lengths, so that at most half the slots decode on many ticks),
  for the MoE family, the rolling-cache ``local`` block and a recurrent
  family; compact ticks run exactly when compact decode may.
* The tests run torch's native CPU GEMM (``torch.backends.mkldnn``
  off): oneDNN's bf16 GEMM picks its kernel by the row count (one up to 4
  rows, another above, and another path again for one row), and the
  kernels round some rows apart (about 0.2% of the rows of a
  ``[M, 64] @ [64, 16]`` product), which flips near-tie tokens of these
  random-weight models between a tick of 8 rows, a compact tick of 2 and
  the static loop's single row.  The native GEMM gives every row the same
  bits at every height.  The card has the same hazard with cuBLAS
  (``chip_smoke.py`` ``[compact]`` measures it).
* A compact tick writes back only the rows it ran: slots that sit it out
  keep their rows bit for bit and their pending reset flags, a pad row
  (idle, gathered to fill a power-of-two height) comes back unchanged, and
  the stale rows change no participant's tokens.
* ``Engine.choose_compact`` (a copy of the reference's) is a measured
  layout arm: bootstrap, explore, exploit, re-explore.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.engine import Engine, Job, ServeEngine
from repro_torch.engine.jobs import layout_kind
from repro_torch.models import lm
from repro_torch.runtime.serve import BatchedServer

ARCHS = ["paper-moe-100m-smoke", "gemma3-1b-smoke", "rwkv6-1.6b-smoke"]
MAX_LEN = 96


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
def _own(arch):
    """A family's config (the MoE one with both fused flags on), the
    port's own weights and its static oracle."""
    cfg = get_arch(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, fused_gating=True, fused_dispatch=True))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, BatchedServer(cfg, params, max_len=MAX_LEN,
                                      device="cpu")


@pytest.mark.parametrize("mode", [True, False, None])
@pytest.mark.parametrize("arch", ARCHS)
def test_compact_decode_equals_static(arch, mode):
    cfg, params, srv = _own(arch)
    rng = np.random.default_rng(0)
    lens, news = [4, 12, 20, 6], [20, 6, 12, 24]
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in lens]
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=8,
                      prefill_chunk=16, decode_chunk=4,
                      compact_decode=mode, device="cpu")
    reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
    eng.run_until_done()
    for p, n, r in zip(prompts, news, reqs):
        np.testing.assert_array_equal(r.output(),
                                      srv.generate_static(p[None], n)[0],
                                      err_msg=f"plen={len(p)} new={n}")
    layouts = [d["choice"] for d in eng.engine.decisions
               if d["decision"] == "serve_compact"]
    if mode is None:
        assert layouts and eng.compact_ticks == layouts.count("compact")
    else:
        assert not layouts
        assert (eng.compact_ticks > 0) == mode
    assert eng._inspect("all")["compact"] == {"mode": mode,
                                              "ticks": eng.compact_ticks}


def _rows(pool, slots):
    return [c.select(dim, s).clone() for s in slots
            for _, c, dim in pool.row_leaves()]


@pytest.mark.parametrize("arch", ARCHS)
def test_sat_out_slots_keep_rows_and_reset_flags(arch):
    """Three requests decode on 8 slots: the compact tick gathers them and
    one pad (slot 3) into a buffer of 4 rows.  The free slots 3..7 hold
    stale rows (slot 5 with a pending reset): after the tick they are bit
    for bit what they were, the flag still set, and the streams equal an
    engine's whose free slots stayed zero."""
    cfg, params, _ = _own(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (3, 5, 7)]

    def engine():
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=8,
                          prefill_chunk=8, decode_chunk=2,
                          compact_decode=True, device="cpu")
        reqs = [eng.submit(p, max_new=8) for p in prompts]
        assert eng.tick() and not any(r.prefilling for r in reqs)
        assert eng.compact_ticks == 0             # the prefill tick is full
        return eng, reqs

    clean, clean_reqs = engine()
    clean.run_until_done()
    eng, reqs = engine()
    sp = eng.pool
    gen = torch.Generator().manual_seed(2)
    stale = list(range(3, 8))
    for _, c, dim in sp.row_leaves():
        for s in stale:
            row = c.select(dim, s)
            row.copy_(torch.randint(-9, 9, row.shape, generator=gen)
                      .to(row.dtype))
    sp.pos[3:] = 5
    sp.reset[5] = True
    before, pos_before = _rows(sp, stale), sp.pos[3:].clone()
    assert eng.tick()
    assert eng.compact_ticks == 1 and sorted(sp._compact) == [4]
    assert all(torch.equal(a, b) for a, b in zip(_rows(sp, stale), before))
    assert torch.equal(sp.pos[3:], pos_before)
    assert sp.reset.tolist() == [False] * 5 + [True] + [False] * 2
    assert sp.pos_host[:3].tolist() == [10, 10, 10]  # 8 prefill, 2 decode
    eng.run_until_done()
    assert eng.compact_ticks == clean.compact_ticks
    for r, c in zip(reqs, clean_reqs):
        np.testing.assert_array_equal(r.output(), c.output())


def test_choose_compact_is_a_measured_layout_arm():
    eng = Engine()
    assert eng.choose_compact(0) is True
    assert eng.decisions[-1]["why"] == "bootstrap"
    for _ in range(3):
        eng.observe(Job(layout_kind(True, 0), tokens=100), 1.0e-2)
    assert eng.choose_compact(0) is False
    assert eng.decisions[-1]["why"] == "explore"
    for _ in range(3):
        eng.observe(Job(layout_kind(False, 0), tokens=100), 2.0e-2)
    assert eng.choose_compact(0) is True
    s = eng.decisions[-1]["scores"]
    assert s["compact"] < s["full"]
    eng2 = Engine()
    for _ in range(3):
        eng2.observe(Job(layout_kind(True, 0), tokens=100), 3.0e-2)
        eng2.observe(Job(layout_kind(False, 0), tokens=100), 1.0e-2)
    assert eng2.choose_compact(0) is False
    picks = [eng2.choose_compact(0) for _ in range(16)]
    assert picks[:14] == [False] * 14 and picks[14] is True


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_graphs_per_pool_and_height_equal_eager(cuda):
    """Two pools of 4 slots, compact decode forced: the graphed engine
    captures one graph per (pool, height) in one shared memory pool and
    gives the eager engine's tokens bit for bit; every launch is a replay's
    or a capture's warm-up step; a weight publish drops every graph, and
    the graphs captured again still give the eager tokens."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg, params, _ = _own("paper-moe-100m-smoke")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 9, 3, 12, 7, 4)]
    news = [12, 3, 9, 6, 10, 2]
    engs = [ServeEngine(cfg, params, max_len=MAX_LEN, slots=4, pools=2,
                        prefill_chunk=8, decode_chunk=2, compact_decode=True,
                        device=cuda) for _ in range(2)]
    engs[1]._tick.graph = False
    reset_launches()
    outs = []
    for eng in engs:
        reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        eng.run_until_done()
        outs.append([r.output() for r in reqs])
        if eng is engs[0]:
            graphed = dict(LAUNCHES)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    tick = engs[0]._tick
    keys = set(tick.graphs)
    assert {(0, "step", 4), (1, "step", 4)} <= keys
    assert any(rows < 4 for _, _, rows in keys)
    assert tick.captures == len(keys)
    want = {k: sum((g.replays + 1) * g.per_replay[k]
                   for g in tick.graphs.values()) for k in LAUNCHES}
    assert graphed == want and graphed["moe_gating"] > 0
    engs[0].update(params=params)
    reqs = [engs[0].submit(p, max_new=n) for p, n in zip(prompts, news)]
    engs[0].run_until_done()
    assert tick.captures > len(keys)
    for r, b in zip(reqs, outs[1]):
        np.testing.assert_array_equal(r.output(), b)
