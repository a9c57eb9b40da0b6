"""Tensor-parallel serve pools across devices: the TP decode step as a
program of stages (``models.tp.Stages``), each on one shard's device, with
exchanges between them, on the CPU.

* For every family in ``ARCHS`` the staged step run eagerly equals the
  step written as one pass over the shards (tests/tp_inline.py, the form
  the stages replaced in the engine) bit for bit, from one state, over
  several steps with rows masked in and out.  Against the JAX package's
  XLA-partitioned ``decode_step``, tests/test_torch_pool_mesh.py's
  ``test_tp_step_matches_reference_partitioned`` runs the staged step.
  starcoder2-7b's grouped-query split (36 query heads over 4 KV heads)
  gives the unsplit attention's heads bit for bit.  Layer by layer (the
  steps' ``tap``), each TP layer from the unsplit layer's input is within
  ``TOL`` of the unsplit layer.
* Under ``CheckedStages`` (a ``TorchDispatchMode``) every operation that
  reads or writes memory runs inside a stage and touches only the stage's
  shard's tensors: its weights and cache pieces, what its own stages made,
  what an exchange handed it (the pool's other tensors are the first
  shard's); an exchange hands on only what its source shard holds.  That
  is what distinct cards need of the program: a graph captured on one
  card cannot touch another card's memory.  The checker hands every
  exchange on as a copy, as the engine's staging tensors do, and the step
  still gives the eager logits bit for bit.  The engine's whole step
  (n-gram learn, the draft's feed, the positions' write-back, the argmax)
  runs under it too, and a step whose block skips an exchange is caught.
* The engine with a ``pool_tp = 2`` pool over ``["cpu", "cpu:0"]`` (two
  devices to the engine) gives the tokens of the same pool over ``["cpu",
  "cpu"]`` bit for bit, and ``generate_static``'s up to the near-tie rule;
  so do both speculative arms' verify, compact heights, migration into
  and out of that pool, and a 2 x 2 group.
* On the card (``cuda``): a TP pool over the card named twice runs a
  ``StagedStep`` (one graph per TP shard and stage, keyed so; launches =
  replays x per-replay counts) and gives the eager tick's tokens.  The
  test of two cards is tests/test_torch_pool_placement.py's.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import tp_inline
from test_torch_pool_mesh import (ARCHS, MAX_LEN, TOL, _engine,
                                  _into_decode, _near_tie_allowance, _own,
                                  _prompts, _run)
from repro_torch.configs import get_arch
from repro_torch.engine.draft import truncated_draft_cfg
from repro_torch.engine.serve import SlotPool, build_decode_step
from repro_torch.models import blocks as B
from repro_torch.models import lm, tp
from repro_torch.runtime import sharding as S
from repro_torch.runtime.serve import serving_params

DISTINCT = ["cpu", "cpu:0"]
ONE = ["cpu", "cpu"]
STEPS = 5


@pytest.fixture(autouse=True)
def _cpu_numerics():
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


def _key(t):
    st = t.untyped_storage()
    return st.data_ptr() if st.nbytes() else None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class CheckedStages(tp.Stages, TorchDispatchMode):
    """``tp.Stages`` that checks the program: each storage has owners
    (shards); ``owned`` names each shard's tensors before the step, and
    any other tensor that exists before it is the first shard's.  An
    operation's output that does not alias an input belongs to the open
    stage's shard; an exchange's copy to its destination shard.  View
    operations move no data and are not checked.  ``bad`` lists every
    breach; ``stages`` counts each shard's stages, ``exchanges`` the runs
    of copies between two stages and ``copies`` the copies."""

    def __init__(self, devices, owned):
        tp.Stages.__init__(self, devices)
        TorchDispatchMode.__init__(self)
        self.owners = {}
        for j, tensors in owned.items():
            for t in tensors:
                if _key(t) is not None:
                    self.owners.setdefault(_key(t), set()).add(j)
        self.open = None
        self.bad = []
        self.stages = [0] * len(self.devices)
        self.exchanges = self.copies = 0
        self._copying = self._after_copy = False

    def at(self, j):
        if self.open != j:
            self.open = j
            self.stages[j] += 1
            self._after_copy = False

    def to(self, x, src, dst):
        if src not in self.owners.get(_key(x), {0}):
            self.bad.append(("exchange", src, tuple(x.shape)))
        self.open = None
        if src == dst:
            return x
        self.exchanges += not self._after_copy
        self._after_copy = True
        self.copies += 1
        self._copying = True
        try:
            y = x.clone()
        finally:
            self._copying = False
        self.owners[_key(y)] = {dst}
        return y

    def end(self):
        self.open = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._copying or func.is_view:
            return func(*args, **kwargs)
        if self.open is None:
            self.bad.append(("outside a stage", str(func)))
        ins = set()
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor) and _key(a) is not None:
                ins.add(_key(a))
                if self.open not in self.owners.get(_key(a), {0}):
                    self.bad.append((str(func), self.open, tuple(a.shape)))
        out = func(*args, **kwargs)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor) and _key(o) is not None \
                    and _key(o) not in ins:
                self.owners[_key(o)] = {self.open}
        return out


def _setup(arch, tp_n=2):
    cfg, params, _ = _own(arch)
    params = serving_params(params, "cpu")
    devs = [torch.device(d) for d in DISTINCT[:tp_n]]
    return cfg, tp.split_params(params, cfg, tp_n, devs), devs


def _checked_step(shards, caches, pos, tok, cfg, devs, active):
    chk = CheckedStages(devs, {j: list(_leaves(shards[j])) +
                               list(_leaves(caches[j]))
                               for j in range(len(devs))})
    with chk:
        logits, st = tp.decode_step(shards, {"caches": caches, "pos": pos},
                                    tok, cfg, devs, active=active,
                                    stages=chk)
        chk.end()
    return logits, st, chk


def _masks(b):
    return [None, torch.tensor([True, False, True][:b]), None,
            torch.tensor([False, True, True][:b]), None]


@pytest.mark.parametrize("arch", ARCHS)
def test_staged_step_equals_inline_step(arch):
    """From one state, ``STEPS`` steps with rows masked in and out: the
    staged step's logits, positions and every cache piece equal the
    one-pass step's bit for bit, eagerly and under the checker."""
    cfg, shards, devs = _setup(arch)
    toks = np.random.default_rng(11).integers(1, cfg.vocab, (3, STEPS))
    states = [(tp.init_cache(cfg, 3, MAX_LEN, 2, devs),
               torch.zeros(3, dtype=torch.long)) for _ in range(3)]
    for i, active in enumerate(_masks(3)):
        t = torch.as_tensor(toks[:, i:i + 1])
        (c0, p0), (c1, p1), (c2, p2) = states
        l0, s0 = tp_inline.decode_step(shards, {"caches": c0, "pos": p0}, t,
                                       cfg, devs, active=active)
        l1, s1 = tp.decode_step(shards, {"caches": c1, "pos": p1}, t, cfg,
                                devs, active=active)
        l2, s2, chk = _checked_step(shards, c2, p2, t, cfg, devs, active)
        assert not chk.bad, chk.bad[:5]
        for lg, s in ((l1, s1), (l2, s2)):
            assert torch.equal(lg, l0), f"step {i}"
            assert torch.equal(s["pos"], s0["pos"])
        states = [(c0, s0["pos"]), (c1, s1["pos"]), (c2, s2["pos"])]
    for a, b, c in zip(*(list(_leaves(c)) for c, _ in states)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("arch", ARCHS)
def test_tap_layer_by_layer(arch):
    """``tap`` sees the residual stream at the same points of the unsplit
    and the staged step (the embedding's, then each layer's), an identity
    tap changes no logit, and each TP layer run from the unsplit layer's
    input (the tap hands it on), and the TP head from the unsplit final
    stream, are within ``TOL`` of the unsplit ones: the per-layer check
    chip_smoke.py's ``[mesh]`` makes on the card."""
    cfg, params, _ = _own(arch)
    params = serving_params(params, "cpu")
    devs = [torch.device(d) for d in DISTINCT]
    shards = tp.split_params(params, cfg, 2, devs)
    tok = torch.as_tensor(np.random.default_rng(4).integers(1, cfg.vocab,
                                                            (3, 1)))

    def states():
        return ({"caches": lm.init_cache(cfg, 3, MAX_LEN,
                                         device="cpu")["caches"],
                 "pos": torch.zeros(3, dtype=torch.long)},
                {"caches": tp.init_cache(cfg, 3, MAX_LEN, 2, devs),
                 "pos": torch.zeros(3, dtype=torch.long)})

    ref, got = [], []

    def keep(i, x):
        ref.append((i, x.clone()))
        return x

    def swap(i, x):
        assert ref[len(got)][0] == i
        got.append(x.clone())
        return ref[i][1]

    one, split = states()
    plain = (lm.decode_step(params, one, tok, cfg, moe_groups="row")[0],
             tp.decode_step(shards, split, tok, cfg, devs, moe_groups="row")[0])
    one, split = states()
    a = lm.decode_step(params, one, tok, cfg, moe_groups="row", tap=keep)[0]
    b = tp.decode_step(shards, split, tok, cfg, devs, moe_groups="row",
                       tap=swap)[0]
    assert torch.equal(a, plain[0])
    assert len(ref) == len(got) == cfg.num_layers + 1
    for (i, want), x in zip(ref, got):
        np.testing.assert_allclose(x.float().numpy(), want.float().numpy(),
                                   atol=TOL, rtol=TOL, err_msg=f"tap {i}")
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL, rtol=TOL)
    one, split = states()
    c = tp.decode_step(shards, split, tok, cfg, devs, moe_groups="row",
                       tap=lambda i, x: x)[0]
    assert torch.equal(c, plain[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_step_stages_hold_their_shards(arch):
    """The engine's step over a TP pool with a draft, under the checker:
    the n-gram learn, the draft's feed and the write-back join shard 0's
    stages, no stage touches another shard's tensors, and the step gives
    the eager step's logits, argmax and pool state bit for bit; every
    stage of the second shard follows an exchange into it."""
    cfg, shards, devs = _setup(arch)
    draft = truncated_draft_cfg(cfg, 1)
    dparams = serving_params(lm.init(draft, torch.Generator().manual_seed(1),
                                     device="cpu"), "cpu")
    mesh = S.pool_mesh(DISTINCT, tp=2)
    pools = [SlotPool(cfg, 3, MAX_LEN, None, draft, mesh=mesh)
             for _ in range(2)]
    assert pools[0].tp == 2 and pools[0].group == tuple(devs)
    step = build_decode_step(cfg, "cpu", draft)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (3, STEPS))
    for i, active in enumerate(_masks(3)):
        tok = torch.as_tensor(toks[:, i])
        act = torch.ones(3, dtype=torch.bool) if active is None else active
        want = step(shards, dparams, pools[0], tok, act)
        owned = {j: list(_leaves(shards[j])) + list(_leaves(
            pools[1].caches[j])) for j in range(2)}
        chk = CheckedStages(devs, owned)
        with chk:
            got = step(shards, dparams, pools[1], tok, act, stages=chk)
            chk.end()
        assert not chk.bad, chk.bad[:5]
        assert min(chk.stages) > 0 and chk.exchanges >= chk.stages[1]
        for a, b in zip(want, got):
            assert torch.equal(a, b), f"step {i}"
    for (_, a, _), (_, b, _) in zip(pools[0].row_leaves(),
                                    pools[1].row_leaves()):
        assert torch.equal(a, b)
    assert torch.equal(pools[0].pos, pools[1].pos)


def test_tp_gqa_heads_equal_unsplit():
    """starcoder2-7b's grouped-query layout (36 query heads over 4 KV
    heads: each shard 18 query heads over their 2 KV heads) at a small
    width: over several decode steps the shards' attention heads, side by
    side, are the unsplit attention's heads bit for bit, and each shard's
    MLP activations are the unsplit MLP's columns bit for bit."""
    full = get_arch("starcoder2-7b")
    cfg = dataclasses.replace(full, d_model=576, head_dim=64, d_ff=1152,
                              vocab=512, num_layers=1,
                              layer_pattern=full.pattern[:1])
    assert (cfg.n_heads, cfg.n_kv_heads) == (36, 4)
    params = serving_params(lm.init(cfg, torch.Generator().manual_seed(2),
                                    device="cpu"), "cpu")
    devs = [torch.device(d) for d in DISTINCT]
    shards = tp.split_params(params, cfg, 2, devs)
    p = lm._layer_views(params, "attn", 1)[0]
    ps = [lm._layer_views(s_, "attn", 1)[0] for s_ in shards]
    scfg = dataclasses.replace(cfg, n_heads=18, n_kv_heads=2)
    cache = {k: v[0] for k, v in
             lm.init_cache(cfg, 2, MAX_LEN, device="cpu")["caches"]["attn"]
             .items()}
    caches = [{k: v[0] for k, v in c["attn"].items()}
              for c in tp.init_cache(cfg, 2, MAX_LEN, 2, devs)]
    g = torch.Generator().manual_seed(5)
    for step in range(4):
        x = torch.randn((2, 1, cfg.d_model), generator=g).to(torch.bfloat16)
        ctx = {"cfg": cfg, "pos": torch.full((2,), step), "active": None}
        y = B._decode_attention(cfg, p, x, cache, ctx, project=False)
        ys = [B._decode_attention(scfg, pj, x, cj, ctx, project=False)
              for pj, cj in zip(ps, caches)]
        assert torch.equal(torch.cat(ys, -1), y), f"step {step}"
        gu = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        gus = [F.silu(x @ pj["w_gate"]) * (x @ pj["w_up"]) for pj in ps]
        assert torch.equal(torch.cat(gus, -1), gu), f"step {step}"


def test_checker_catches_a_skipped_exchange(monkeypatch):
    """A step whose MLP hands the second shard the first shard's input
    itself (no exchange) is caught, as two cards would refuse it."""
    def mlp(sh, ps, hn):
        parts = []
        for j, p in enumerate(ps):
            sh.rt.at(j)
            gu = F.silu(hn @ p["w_gate"].to(hn.dtype)) * \
                (hn @ p["w_up"].to(hn.dtype))
            parts.append(tp._partial(gu, p["w_down"]))
        return sh.sum(parts).to(hn.dtype)

    cfg, shards, devs = _setup("starcoder2-7b")
    assert tp.split_plan(cfg, 2)["mlp"]
    caches = tp.init_cache(cfg, 2, MAX_LEN, 2, devs)
    tok = torch.tensor([[3], [5]])
    _, _, chk = _checked_step(shards, caches, torch.zeros(2, dtype=torch.long),
                              tok, cfg, devs, None)
    assert not chk.bad
    monkeypatch.setattr(tp, "_mlp", mlp)
    caches = tp.init_cache(cfg, 2, MAX_LEN, 2, devs)
    _, _, chk = _checked_step(shards, caches, torch.zeros(2, dtype=torch.long),
                              tok, cfg, devs, None)
    assert any(b[1] == 1 for b in chk.bad if len(b) == 3), chk.bad[:5]


# ------------------------------------------------------------- the engine

def _tp2(arch):
    cfg = _own(arch)[0]
    return dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve,
                                                              pool_tp=2))


def _serve(arch, group, prompts, max_new=8, **kw):
    eng = _engine(arch, cfg=_tp2(arch), placements={0: group}, **kw)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    _run(eng, reqs)
    return eng, [r.output() for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_pool_over_distinct_devices(arch):
    """``pool_tp = 2`` over two devices: the tokens of the pool over one
    device named twice, bit for bit, and ``generate_static``'s up to the
    near-tie rule."""
    prompts = _prompts(3, seed=6)
    eng, got = _serve(arch, DISTINCT, prompts)
    sp = eng.pools[0]
    assert sp.tp == 2 and sp.group == tuple(map(torch.device, DISTINCT))
    _, want = _serve(arch, ONE, prompts)
    compared = 0
    for p, a, b in zip(prompts, got, want):
        np.testing.assert_array_equal(a, b)
        ref, margins, allow = _near_tie_allowance(arch, p, 8)
        bad = np.flatnonzero(a != ref)
        if bad.size:
            assert margins[bad[0]] <= allow[bad[0]], (bad[0], margins)
        compared += bad[0] if bad.size else len(ref)
    assert compared >= 12


def test_tp_pool_compact_over_distinct_devices():
    """Compact decode forced on a TP pool over two devices: its buffer
    sets of each height split by heads over the same devices, the tokens
    of the pool over one device named twice, bit for bit."""
    arch = "zamba2-7b"
    prompts = _prompts(3, seed=4)
    runs = [_serve(arch, g, prompts, compact_decode=True)
            for g in (DISTINCT, ONE)]
    eng = runs[0][0]
    assert eng.compact_ticks > 0
    subs = eng.pools[0]._compact
    assert subs and all(sub.tp == 2 and sub.group == eng.pools[0].group
                        for sub in subs.values())
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arm", ["ngram", "draft"])
def test_tp_pool_spec_arms_over_distinct_devices(arm):
    """Both speculative arms, forced on every decode tick, verify through
    the TP step over two devices as over one device named twice."""
    from test_torch_spec import force_arm
    arch = "paper-moe-100m"
    prompts = [np.tile([5, 9, 2, 7], 4)[:n].astype(np.int32)
               for n in (5, 9, 13)]
    outs = []
    for group in (DISTINCT, ONE):
        cfg = _tp2(arch)
        cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
            cfg.serve, draft_layers=1))
        eng = _engine(arch, cfg=cfg, placements={0: group}, spec_decode=True,
                      draft="self" if arm == "draft" else None)
        force_arm(eng, f"spec:{arm}")
        reqs = [eng.submit(p, max_new=10) for p in prompts]
        _run(eng, reqs)
        assert eng.spec_arms[arm]["ticks"] > 0
        outs.append([r.output() for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_pool_migration_over_distinct_devices(arch):
    """Requests start on a pool that is not placed (one device, not
    split), move mid-stream into the TP pool over two devices, then out
    into a pool that joins unplaced: the tokens of the same run with the
    TP pool over one device named twice, bit for bit, with slots moved
    both ways."""
    prompts = _prompts(4, seed=2)
    outs = []
    for group in (DISTINCT, ONE):
        eng = _engine(arch, cfg=_tp2(arch), pools=2, placements={0: group})
        assert eng.pools[0].tp == 2 and eng.pools[1].tp == 1
        reqs = [eng.submit(p, max_new=16, pool=1) for p in prompts]
        moved = []
        for src, dst in ((1, 0), (0, None)):
            _into_decode(eng, [r for r in reqs if not r.done.is_set()])
            if dst is None:
                dst = eng.add_pool()
            eng.drain_pool(src)
            for _ in range(20):
                assert eng.tick()
                if eng._pool(src) is None:
                    break
            live = [r for r in reqs if not r.done.is_set()]
            assert live and all(r.pool == dst for r in live)
            moved.append(eng.migrated_slots)
        assert moved[0] > 0 and moved[1] > moved[0]
        _run(eng, reqs)
        outs.append([r.output() for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_tp_pool_2x2_over_distinct_devices():
    """A 2 x 2 group (data 2 x model 2): each data shard's rows split by
    heads over ``cpu`` and ``cpu:0``; the tokens of the group that names
    one device four times, bit for bit."""
    arch = "gemma3-1b"
    prompts = _prompts(5, seed=1)
    eng, got = _serve(arch, DISTINCT * 2, prompts)
    sp = eng.pools[0]
    assert sp.split and sp.tp == 2
    assert all(sh.group == tuple(map(torch.device, DISTINCT))
               for sh in sp.shards)
    _, want = _serve(arch, ONE * 2, prompts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cuda_staged_tp_pool_equals_eager():
    """The MoE smoke model with the fused kernels, a 4-slot pool at
    ``pool_tp = 2`` over the card named twice: the graphed tick runs a
    ``StagedStep`` a height, each stage graph keyed by (pool, step, rows,
    data shard, TP shard, stage) and holding one shard's work, and gives
    the eager tick's tokens; every launch is a replay's (each stage
    graph's per-replay counts) or a capture's warm-up step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.engine import ServeEngine
    from repro_torch.engine.serve import StagedStep
    from repro_torch.kernels import LAUNCHES, reset_launches
    cuda = torch.device("cuda", 0)
    base = get_arch("paper-moe-100m-smoke")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, fused_gating=True, fused_dispatch=True),
        serve=dataclasses.replace(base.serve, pool_tp=2))
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 9, 3, 12, 7, 4)]
    outs = []
    for graph in (True, False):
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4,
                          prefill_chunk=8, decode_chunk=2,
                          placements={0: [cuda, cuda]}, device=cuda)
        eng._tick.graph = graph
        reset_launches()
        reqs = [eng.submit(p, max_new=10) for p in prompts]
        eng.run_until_done()
        outs.append([r.output() for r in reqs])
        if graph:
            tick, launched = eng._tick, dict(LAUNCHES)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    steps = {k: g for k, g in tick.graphs.items() if k[1] == "step"}
    assert steps and all(isinstance(g, StagedStep) for g in steps.values())
    stages = tick.stage_graphs()
    for key, g in steps.items():
        assert set(g.stage_counts()) == {0, 1} and g.copies > 0
        mine = [k for k in stages if k[:3] == key[:3]]
        assert len(mine) == len(g.stages)
        assert {k[4] for k in mine} == {0, 1}
    for st in stages.values():
        assert st.device == cuda
    want = {k: sum((g.replays + 1) * g.per_replay[k]
                   for g in tick.graphs.values()) for k in LAUNCHES}
    assert launched == want and launched["moe_gating"] > 0
    for g in steps.values():
        assert sum(st.replays for st in g.stages) == \
            g.replays * len(g.stages)
        shard0 = [st for st in g.stages if st.shard == 0]
        assert sum(st.per_replay["moe_gating"] for st in shard0) == \
            g.per_replay["moe_gating"]
