"""Serve pools over a device group: rows split over ``data`` and the
tensor-parallel decode step at ``pool_tp`` > 1, on the CPU.

As the JAX package's tests/test_pool_placement.py runs placements on one
device, the groups here name the one CPU device twice (``["cpu", "cpu"]``,
four times for a 2 x 2 mesh): every split, every shard's step and every
cross-shard sum runs; only an overlap between devices does not.

* A split pool (4 slots, 2 a shard) serves every greedy request equal to
  the port's ``generate_static`` at the shard's height (2 copies of the
  prompt), for the three cache families and the MoE model (each slot its
  own MoE group, so a split changes no routing); a slot count that
  ``data`` does not divide keeps the rows whole on the group's first
  device and serves the same.
* Rows move between every layout (one device, split, split by heads,
  both) and through a prefix snapshot bit for bit; a mid-stream migration
  from a split pool into a one-device pool and back gives the tokens of
  the run that never moved, bit for bit.
* The tensor-parallel step's logits are within ``TOL`` (atol and rtol
  2e-2, tests/test_torch_serve.py's: the split products round their bf16
  partial sums before they are added) of the unsplit step's on inputs on
  which both route alike, with every MoE integer equal; the TP MoE layer
  alone gives the unsplit layer's integers exactly.  Engine output at
  ``pool_tp = 2`` equals ``generate_static`` except from a token where the
  oracle's top-2 margin is within the room that bound leaves the two
  logits, the steps held to it along the oracle's own tokens (the
  near-tie rule).  A TP pool over distinct devices is placed; a group of
  two device types is refused.
* Against the JAX package, in a process of its own with four forced host
  devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``):
  its ``decode_step`` jitted with the weights under ``param_specs(...,
  fsdp=False)`` on a ``(1, 2)`` pool mesh against the port's TP step on
  the same weights, within ``TOL``; and its ``ServeEngine`` with two pools
  placed on disjoint 2-device halves against the port's split pools,
  token for token, on fixed prompts on which both frameworks agree.

The tests run torch's native CPU GEMM (``torch.backends.mkldnn`` off),
whose rows do not depend on the batch height, on one thread.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from functools import lru_cache

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.engine.serve import SlotPool
from repro_torch.models import bridge, lm, tp
from repro_torch.models import moe as moe_lib
from repro_torch.runtime import sharding as S
from repro_torch.runtime.serve import BatchedServer, serving_params

FAMS = ["gemma3-1b", "rwkv6-1.6b", "zamba2-7b"]
ARCHS = FAMS + ["paper-moe-100m"]
GROUP = ["cpu", "cpu"]
MAX_LEN = 48
TOL = 2e-2
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the engine comparison with the reference: fixed prompts (their own seed,
# independent of PYTEST_SEED) on which the two frameworks agree
REF_ARCH = "gemma3-1b"
REF_PROMPT_SEED = 3
REF_NEW = 8


@pytest.fixture(autouse=True)
def _cpu_numerics():
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


@lru_cache(maxsize=None)
def _own(arch):
    cfg = get_arch(arch + "-smoke")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, BatchedServer(cfg, params, max_len=MAX_LEN,
                                      device="cpu")


_ORACLE = {}


def oracle(arch, prompt, max_new, rows=1):
    """``generate_static`` on ``rows`` copies of the prompt (a shard's
    height), row 0."""
    key = (arch, tuple(int(t) for t in prompt), int(max_new), rows)
    if key not in _ORACLE:
        batch = np.repeat(np.asarray(prompt, np.int32)[None], rows, 0)
        _ORACLE[key] = _own(arch)[2].generate_static(batch, int(max_new))[0]
    return _ORACLE[key]


def _prompts(n, seed=0, vocab=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(4, 14))).tolist()
            for _ in range(n)]


def _engine(arch, cfg=None, **kw):
    c, params, _ = _own(arch)
    kw.setdefault("slots", 4)
    return ServeEngine(cfg or c, params, max_len=MAX_LEN, prefill_chunk=4,
                       decode_chunk=2, device="cpu", **kw)


def _run(eng, reqs, max_ticks=800):
    for _ in range(max_ticks):
        assert eng.tick()
        if all(len(r.tokens) >= r.max_new for r in reqs):
            return
    raise AssertionError("requests did not finish")


def _into_decode(eng, reqs):
    """Tick until a request has emitted a token."""
    for _ in range(300):
        if any(r.tokens for r in reqs):
            return
        assert eng.tick()
    raise AssertionError("no token emitted")


# ------------------------------------------------------------- the layout

def test_pool_shards():
    """Each data shard's slots and its row of the group: the slots split
    where ``data`` divides them, else whole on the first row."""
    m = S.pool_mesh(["cpu"] * 4, tp=2)
    cpu = torch.device("cpu")
    assert S.pool_shards(m, 4) == [(0, 2, (cpu, cpu)), (2, 4, (cpu, cpu))]
    assert S.pool_shards(m, 3) == [(0, 3, (cpu, cpu))]
    assert S.pool_shards(S.pool_mesh(GROUP), 6) == [(0, 3, (cpu,)),
                                                    (3, 6, (cpu,))]


def test_tp_over_distinct_devices_refused():
    """A tensor-parallel pool over distinct devices (here the CPU under two
    names, ``cpu`` and ``cpu:0``, which the engine keeps apart) is placed:
    its step runs as stages, each on its shard's device
    (tests/test_torch_tp_cards.py serves it); so are 2 x 2 groups (each
    data row one device named twice, or two distinct devices), a join
    over them and a split over them at ``pool_tp = 1``.  What is refused
    is a group of two device types: a CPU and a CUDA device never share a
    pool, at any ``pool_tp``."""
    cfg = _own("gemma3-1b")[0]
    tp2 = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve,
                                                             pool_tp=2))
    eng = _engine("gemma3-1b", cfg=tp2, placements={0: ["cpu", "cpu:0"]})
    sp = eng.pools[0]
    assert not sp.split and sp.tp == 2
    assert sp.group == (torch.device("cpu"), torch.device("cpu", 0))
    for group in (["cpu", "cpu", "cpu:0", "cpu:0"],
                  ["cpu", "cpu:0", "cpu", "cpu:0"]):
        eng = _engine("gemma3-1b", cfg=tp2, placements={0: group})
        assert eng.pools[0].split and eng.pools[0].tp == 2
    lid = eng.add_pool(placement=["cpu:0", "cpu"])
    assert eng._pool(lid).tp == 2
    for group in (["cpu", "cuda:0"], ["cuda:0", "cpu"]):
        with pytest.raises(ValueError, match="device type"):
            _engine("gemma3-1b", cfg=tp2, placements={0: group})
        with pytest.raises(ValueError, match="never share a pool"):
            S.pool_mesh(group, tp=2)
    eng = _engine("gemma3-1b", placements={0: ["cpu", "cpu:0"]})
    assert eng.pools[0].split


# -------------------------------------------------- split pools == static

@pytest.mark.parametrize("arch", ARCHS)
def test_split_pool_matches_static(arch):
    eng = _engine(arch, placements={0: GROUP})
    sp = eng.pools[0]
    assert sp.split and [sh.slots for sh in sp.shards] == [2, 2]
    lay = eng._inspect("status")["pools"][0]["layout"]
    assert lay["rows"] == "split" and lay["shards"][1][:2] == [2, 4]
    prompts = _prompts(5, seed=1)
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    _run(eng, reqs)
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(r.output(), oracle(arch, p, 8, 2))


def test_slots_that_data_does_not_divide_stay_whole():
    arch = "gemma3-1b"
    eng = _engine(arch, slots=3, placements={0: GROUP})
    sp = eng.pools[0]
    assert not sp.split and sp.shards == [sp] and sp.slots == 3
    assert eng._inspect("status")["pools"][0]["layout"]["rows"] == "whole"
    prompts = _prompts(4, seed=4)
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    _run(eng, reqs)
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(r.output(), oracle(arch, p, 6, 3))


# ------------------------------------------------------------- migration

def _fill(pool, seed):
    """Random values in every row of a one-device pool (positions too)."""
    g = torch.Generator().manual_seed(seed)
    for _, c, _ in pool.row_leaves():
        if c.dtype.is_floating_point:
            c.copy_(torch.randn(c.shape, generator=g).to(c.dtype))
        else:
            c.copy_(torch.randint(0, 1000, c.shape, generator=g))
    pool.pos.copy_(torch.randint(0, 40, pool.pos.shape, generator=g))


@pytest.mark.parametrize("arch", FAMS)
def test_rows_round_trip_through_every_layout(arch):
    """One pool's rows moved into a split pool, a pool split by heads and a
    2 x 2 pool, snapshotted and seeded, and back: bit for bit."""
    from repro_torch.engine.draft import truncated_draft_cfg
    cfg = get_arch(arch + "-smoke")
    draft = truncated_draft_cfg(cfg, 1)
    src = SlotPool(cfg, 4, MAX_LEN, "cpu", draft)
    _fill(src, 7)
    want = src.read_rows(range(4), pos=True)
    meshes = [S.pool_mesh(GROUP), S.pool_mesh(GROUP, tp=2),
              S.pool_mesh(["cpu"] * 4, tp=2)]
    pools = [SlotPool(cfg, 4, MAX_LEN, "cpu", draft, mesh=m)
             for m in meshes]
    assert [(p.split, p.tp) for p in pools] == [(True, 1), (False, 2),
                                                (True, 2)]
    order = [3, 0, 2, 1]
    prev = src
    for p in pools:
        prev.move_rows(p, order if prev is src else range(4), range(4))
        prev = p
    back = SlotPool(cfg, 4, MAX_LEN, "cpu", draft)
    prev.move_rows(back, range(4), order)
    got = back.read_rows(range(4), pos=True)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a snapshot of a split-by-heads slot seeds a split pool's slot
    snap = pools[2].snapshot(1)
    pools[0].seed_rows([3], [snap], [5])
    one = pools[0].read_rows([3])
    ref = pools[2].read_rows([1])
    for k in ref:
        assert torch.equal(one[k], ref[k]), k
    # zeroing by slot reaches the right shard and nothing else
    pools[0].zero_rows([2])
    z = pools[0].read_rows([2, 3], pos=True)
    assert all(not v.select(1 if k[0] in ("caches", "draft") else 0, 0)
               .any() for k, v in z.items())
    assert torch.equal(z[("pos",)][1:], torch.tensor([5]))


@pytest.mark.parametrize("arch", FAMS)
def test_migration_round_trip_split_and_one_device(arch):
    """Requests on a split pool move mid-stream into a one-device pool,
    then into a new split pool: the tokens of the run that never moved,
    bit for bit, and the static oracle's."""
    prompts = _prompts(4, seed=2)
    outs = []
    for migrate in (False, True):
        eng = _engine(arch, pools=2, placements={0: GROUP, 1: "cpu"})
        reqs = [eng.submit(p, max_new=16, pool=0) for p in prompts]
        if migrate:
            moved = []
            for src, dst in ((0, 1), (1, None)):
                _into_decode(eng, [r for r in reqs if not r.done.is_set()])
                if dst is None:
                    dst = eng.add_pool(placement=GROUP)
                eng.drain_pool(src)
                for _ in range(20):
                    assert eng.tick()
                    if eng._pool(src) is None:
                        break
                live = [r for r in reqs if not r.done.is_set()]
                assert live and all(r.pool == dst for r in live)
                moved.append(eng.migrated_slots)
            assert moved[0] > 0 and moved[1] > moved[0]
            assert eng._pool(dst).split
        _run(eng, reqs)
        outs.append([r.output() for r in reqs])
    for a, b, p in zip(*outs, prompts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, oracle(arch, p, 16, 2))


# ------------------------------------------------------------ the TP step

def _serving(arch):
    cfg, params, _ = _own(arch)
    return cfg, serving_params(params, "cpu")


def _steps(cfg, params, toks, tp_n=2, groups="row"):
    """Both steps along the same tokens [B, steps]: per step the unsplit
    and the TP logits and MoE metrics."""
    devs = [torch.device("cpu")] * tp_n
    shards = tp.split_params(params, cfg, tp_n, devs)
    b = toks.shape[0]
    st = lm.init_cache(cfg, b, MAX_LEN, device="cpu")
    caches = tp.init_cache(cfg, b, MAX_LEN, tp_n, devs)
    pos = torch.zeros(b, dtype=torch.long)
    out = []
    for i in range(toks.shape[1]):
        t = torch.as_tensor(toks[:, i:i + 1])
        m1, m2 = [], []
        l1, st = lm.decode_step(params, st, t, cfg, moe_groups=groups,
                                metrics=m1)
        l2, s2 = tp.decode_step(shards, {"caches": caches, "pos": pos}, t,
                                cfg, devs, moe_groups=groups, metrics=m2)
        pos = s2["pos"]
        assert torch.equal(pos, st["pos"])
        out.append((l1, l2, m1, m2))
    return out


_INTS = ("slot_counts", "kept_counts", "dropped", "expert_counts")


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_unsplit(arch):
    cfg, params = _serving(arch)
    toks = np.random.default_rng(11).integers(1, cfg.vocab, (3, 8))
    for i, (l1, l2, m1, m2) in enumerate(_steps(cfg, params, toks)):
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=f"step {i}")
        for a, b in zip(m1, m2):
            for k in _INTS:
                assert torch.equal(a[k], b[k]), (i, k)


@pytest.mark.parametrize("fused", [False, True])
def test_tp_moe_layer_integers_equal(fused):
    base = get_arch("paper-moe-100m-smoke")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, fused_gating=fused, fused_dispatch=fused))
    params = serving_params(
        lm.init(cfg, torch.Generator().manual_seed(3), device="cpu"), "cpu")
    devs = [torch.device("cpu")] * 2
    ps = [v[0] for v in (lm._layer_views(s, "moe", 2)
                         for s in tp.split_params(params, cfg, 2, devs))]
    p = lm._layer_views(params, "moe", 2)[0]
    plan = moe_lib.identity_plan(cfg, 1, device="cpu")
    rng = np.random.default_rng(4)
    for g, t in ((1, 16), (5, 1)):
        x = torch.as_tensor(rng.standard_normal((g, t, cfg.d_model)),
                            dtype=torch.bfloat16)
        off = torch.arange(g) * 3
        y1, m1 = moe_lib.moe_ffn(p, x, plan.slots[0], plan.cum[0], cfg, off)
        y2, m2 = tp.moe_ffn(ps, x, plan.slots[0], plan.cum[0], cfg, off,
                            devs)
        for k in _INTS:
            assert torch.equal(m1[k], m2[k]), k
        np.testing.assert_allclose(y2.float().numpy(), y1.float().numpy(),
                                   atol=TOL, rtol=TOL)


def _near_tie_allowance(arch, prompt, max_new):
    """The static loop's greedy tokens after ``prompt`` (one row), each
    step's top-2 margin, and the room the gate leaves that margin: the TP
    step's logits, held within ``TOL`` (atol and rtol) of the unsplit
    step's along those tokens, may move each of the top two by ``TOL * (1
    + |logit|)``."""
    cfg, params = _serving(arch)
    want = oracle(arch, prompt, max_new)
    toks = np.concatenate([np.asarray(prompt), want[:-1]])[None]
    margins, allow = [], []
    for i, (l1, l2, _, _) in enumerate(_steps(cfg, params, toks)):
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=f"step {i}")
        if i >= len(prompt) - 1:
            top = torch.topk(l1[0], 2).values
            margins.append((top[0] - top[1]).item())
            allow.append(TOL * (2 + top.abs().sum().item()))
    return want, np.asarray(margins), np.asarray(allow)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_matches_static_but_near_ties(arch):
    cfg = _own(arch)[0]
    tp2 = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve,
                                                             pool_tp=2))
    eng = _engine(arch, cfg=tp2, placements={0: GROUP})
    assert eng.pools[0].tp == 2 and not eng.pools[0].split
    prompts = _prompts(3, seed=6)
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    _run(eng, reqs)
    compared = 0
    for p, r in zip(prompts, reqs):
        want, margins, allow = _near_tie_allowance(arch, p, 8)
        bad = np.flatnonzero(r.output() != want)
        if bad.size:
            assert margins[bad[0]] <= allow[bad[0]], \
                f"token {bad[0]}: margin {margins[bad[0]]}, room " \
                f"{allow[bad[0]]}"
        compared += bad[0] if bad.size else len(want)
    assert compared >= 12


# ------------------------------------------------------ the JAX reference

REFERENCE = textwrap.dedent('''
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_arch
    from repro.engine.serve import ServeEngine
    from repro.models import lm
    from repro.runtime.sharding import named, param_specs, pool_mesh
    out, toks_src, prompts_src, arch, new = sys.argv[1:6]
    devs = jax.devices()
    res = {}
    toks = np.load(toks_src)
    for a in ("gemma3-1b", "paper-moe-100m"):
        cfg = get_arch(a + "-smoke")
        params = jax.jit(lm.init, static_argnums=0)(cfg,
                                                    jax.random.PRNGKey(0))
        mesh = pool_mesh(devs[:2], tp=2)
        sp = jax.device_put(params, named(mesh, param_specs(cfg, mesh,
                                                            fsdp=False)))
        step = jax.jit(lambda p, st, t: lm.decode_step(p, st, t, cfg))
        st = lm.init_cache(cfg, toks.shape[0], 16)
        for i in range(toks.shape[1]):
            lg, st = step(sp, st, jnp.asarray(toks[:, i:i + 1]))
            res[f"{a}/step{i}"] = np.asarray(lg)
    cfg = get_arch(arch + "-smoke")
    params = jax.jit(lm.init, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    eng = ServeEngine(cfg, params, max_len=48, slots=4, pools=2,
                      prefill_chunk=4, decode_chunk=2,
                      placements={0: devs[:2], 1: devs[2:]})
    prompts = [[int(t) for t in p]
               for p in np.load(prompts_src, allow_pickle=True)]
    reqs = [eng.submit(p, max_new=int(new)) for p in prompts]
    eng.run_until_done()
    res["engine"] = np.stack([r.output() for r in reqs])
    np.savez(out, **res)
''')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pool_mesh")
    toks = np.random.default_rng(5).integers(1, 500, (3, 6))
    np.save(tmp / "toks.npy", toks)
    prompts = _prompts(6, seed=REF_PROMPT_SEED)
    np.save(tmp / "prompts.npy", np.asarray(prompts, dtype=object),
            allow_pickle=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([SRC,
                                           os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", REFERENCE,
                        str(tmp / "ref.npz"), str(tmp / "toks.npy"),
                        str(tmp / "prompts.npy"), REF_ARCH, str(REF_NEW)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(tmp / "ref.npz")), toks, prompts


@lru_cache(maxsize=None)
def _from_reference(arch):
    cfg_j = j_get_arch(arch + "-smoke")
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(0))
    return bridge.from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch", ["gemma3-1b", "paper-moe-100m"])
def test_tp_step_matches_reference_partitioned(reference, arch):
    """The reference's ``decode_step`` partitioned by XLA over a (1, 2)
    pool mesh, the weights under ``param_specs(fsdp=False)``, against the
    port's TP step on the same weights: one MoE group of the batch, every
    row at the batch's position, as the reference's step takes it."""
    ref, toks, _ = reference
    cfg = get_arch(arch + "-smoke")
    params = serving_params(_from_reference(arch), "cpu")
    devs = [torch.device("cpu")] * 2
    shards = tp.split_params(params, cfg, 2, devs)
    caches = tp.init_cache(cfg, toks.shape[0], 16, 2, devs)
    pos = torch.zeros(toks.shape[0], dtype=torch.long)
    for i in range(toks.shape[1]):
        lg, st = tp.decode_step(shards, {"caches": caches, "pos": pos},
                                torch.as_tensor(toks[:, i:i + 1]), cfg,
                                devs, moe_groups="batch")
        pos = st["pos"]
        np.testing.assert_allclose(lg.numpy(), ref[f"{arch}/step{i}"],
                                   atol=TOL, rtol=TOL, err_msg=f"step {i}")


def _margins(cfg, params, prompt, tokens):
    """The top-2 logit margin of one-row greedy decode at each of
    ``tokens`` (the continuation of ``prompt``)."""
    st = lm.init_cache(cfg, 1, MAX_LEN, device="cpu")
    seq = list(prompt) + [int(t) for t in tokens[:-1]]
    out = []
    for i, t in enumerate(seq):
        lg, st = lm.decode_step(params, st, torch.tensor([[t]]), cfg,
                                moe_groups="row")
        if i >= len(prompt) - 1:
            top = torch.topk(lg[0], 2).values
            out.append((top[0] - top[1]).item())
    return np.asarray(out)


def test_split_pools_match_reference_engine(reference):
    """Two pools placed on disjoint 2-device halves in the reference, two
    split pools of the port on the one CPU device twice: every request's
    tokens equal, except from a token where the port's top-2 margin is
    under ``TOL`` (the frameworks' bf16 roundings may pick either side of
    such a near-tie; tests/test_torch_serve.py's rule), and most of the
    streams compared."""
    ref, _, prompts = reference
    cfg = get_arch(REF_ARCH + "-smoke")
    params = _from_reference(REF_ARCH)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=4, pools=2,
                      prefill_chunk=4, decode_chunk=2,
                      placements={0: GROUP, 1: GROUP}, device="cpu")
    assert all(sp.split for sp in eng.pools)
    reqs = [eng.submit(p, max_new=REF_NEW) for p in prompts]
    _run(eng, reqs)
    serving = serving_params(params, "cpu")
    compared = 0
    for p, r, want in zip(prompts, reqs, ref["engine"]):
        got = r.output()
        bad = np.flatnonzero(got != want)
        if bad.size:
            m = _margins(cfg, serving, p, got)
            assert m[bad[0]] < TOL, \
                f"token {bad[0]}: margin {m[bad[0]]} (prompt {p})"
        compared += bad[0] if bad.size else len(want)
    assert compared >= ref["engine"].size // 2
