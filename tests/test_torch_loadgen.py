"""The port's load generator and drive harness against the JAX package's.

* ``generate`` equals the reference's field for field (arrival ticks,
  prompts, response budgets, priorities, temperatures) and the scheduled
  events equal, for every registered scenario and two seeds; every arrival
  sampler equals the reference's on the same generator state.
* ``drive`` runs the port's engine under virtual time: sparse arrivals
  fast-forward the clock (the reference's tests/test_gauntlet.py), a
  replay of one scenario on fresh engines gives identical streams and
  outputs, and both equal the port's static greedy loop.
* ``BatchedServer.submit`` is the ``submit=`` hook: requests carry their
  class through it, and ``summarize`` reports per class.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import PriorityClass as JPriorityClass
from repro.engine import loadgen as j_lg
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.configs.base import PriorityClass
from repro_torch.engine import ServeEngine
from repro_torch.engine import loadgen as lg
from repro_torch.models import bridge
from repro_torch.runtime.serve import BatchedServer

from conftest import PYTEST_SEED

ARCH = "gemma3-1b-smoke"
MAX_LEN = 64
# the reference gauntlet's two-class table for priority_starvation
STARVE_CLASSES = (PriorityClass("interactive", weight=4.0, max_defer=2),
                  PriorityClass("batch", weight=1.0, max_defer=6))


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


@lru_cache(maxsize=None)
def _weights():
    cfg_j = j_get_arch(ARCH)
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(0))
    return bridge.from_jax(jax.tree.map(np.asarray, params), device="cpu")


_ORACLE = {}


def oracle(prompt, max_new):
    key = (tuple(int(t) for t in prompt), int(max_new))
    if key not in _ORACLE:
        srv = BatchedServer(get_arch(ARCH), _weights(), max_len=MAX_LEN,
                            device="cpu")
        _ORACLE[key] = srv.generate_static(
            np.asarray(prompt, np.int32)[None], max_new=int(max_new))[0]
    return _ORACLE[key]


def _mini(spec):
    """The reference gauntlet's smoke scale: at most 12 requests, prompts
    of at most 12 tokens, at most 6 new tokens."""
    clip = lambda ps, hi: tuple((k, min(v, hi) if k == "hi" else v)
                                for k, v in ps)
    return dataclasses.replace(
        spec, n=min(spec.n, 12), plen_params=clip(spec.plen_params, 12),
        max_new_params=clip(spec.max_new_params, 6))


@pytest.mark.parametrize("seed", [PYTEST_SEED, PYTEST_SEED + 17])
@pytest.mark.parametrize("name", sorted(j_lg.SCENARIOS))
def test_generate_equals_reference(name, seed):
    assert sorted(lg.SCENARIOS) == sorted(j_lg.SCENARIOS)
    got = lg.generate(lg.SCENARIOS[name], seed)
    want = j_lg.generate(j_lg.SCENARIOS[name], seed)
    assert len(got) == len(want) == lg.SCENARIOS[name].n
    for g, w in zip(got, want):
        assert (g.at, g.prompt, g.max_new, g.priority, g.temperature) == \
            (w.at, w.prompt, w.max_new, w.priority, w.temperature)
    assert lg.SCENARIOS[name].event_list() == \
        j_lg.SCENARIOS[name].event_list()
    assert [dataclasses.astuple(s) for s in lg.SCENARIOS[name].slos] == \
        [dataclasses.astuple(s) for s in j_lg.SCENARIOS[name].slos]


@pytest.mark.parametrize("kind,params", [
    ("poisson", {"rate": 0.7}),
    ("bursty", {"burst": 3, "gap": 5.0}),
    ("diurnal", {"period": 40.0, "peak_rate": 1.0, "trough_rate": 0.1}),
    ("closed", {}),
])
def test_arrival_offsets_equal_reference(kind, params):
    for seed in (PYTEST_SEED, PYTEST_SEED + 1):
        got = lg.arrival_offsets(kind, 40, np.random.default_rng(seed),
                                 **params)
        want = j_lg.arrival_offsets(kind, 40, np.random.default_rng(seed),
                                    **params)
        np.testing.assert_array_equal(got, want)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for fn in ("heavy_tail_lengths", "uniform_lengths"):
        np.testing.assert_array_equal(
            getattr(lg, fn)(rng_a, 30, 2, 16),
            getattr(j_lg, fn)(rng_b, 30, 2, 16))


def _engine(**kw):
    kw.setdefault("slots", 3)
    return ServeEngine(get_arch(ARCH), _weights(), max_len=MAX_LEN,
                       prefill_chunk=8, decode_chunk=2, seed=0,
                       device="cpu", **kw)


def test_drive_virtual_time_fast_forwards_idle():
    """Sparse arrivals do not burn one engine tick per empty virtual tick:
    the harness fast-forwards the clock to the next arrival."""
    eng = _engine()
    reqs = [lg.GenRequest(at=0, prompt=(5, 6, 7), max_new=2),
            lg.GenRequest(at=500, prompt=(8, 9, 10), max_new=2)]
    res = lg.drive(eng, reqs, max_ticks=5000)
    assert res.idle_skipped > 400, res
    assert res.ticks - res.idle_skipped < 60
    assert all(tr.t_done is not None for tr in res.traces)
    for tr in res.traces:
        np.testing.assert_array_equal(tr.req.output(),
                                      oracle(tr.gen.prompt, tr.gen.max_new))


def test_drive_replay_identical_streams():
    """One scenario and seed driven twice on fresh engines: identical
    request streams and greedy outputs, equal to the static loop."""
    spec = dataclasses.replace(_mini(lg.SCENARIOS["bursty_overload"]), n=6)
    outs = []
    for _ in range(2):
        res = lg.drive(_engine(), lg.generate(spec, PYTEST_SEED),
                       max_ticks=20_000)
        assert all(tr.t_done is not None for tr in res.traces)
        outs.append([tr.req.output().tolist() for tr in res.traces])
        for tr in res.traces:
            np.testing.assert_array_equal(
                tr.req.output(), oracle(tr.gen.prompt, tr.gen.max_new))
    assert outs[0] == outs[1]


def test_drive_through_batched_server_submit_with_priorities():
    """The starvation scenario at smoke scale through
    ``BatchedServer.submit`` on two pools, the interactive class pinned to
    pool 0: every request completes with its class, within its class's
    aging bound, and equals the static loop."""
    cfg = get_arch(ARCH)
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, classes=STARVE_CLASSES))
    assert [dataclasses.astuple(c) for c in STARVE_CLASSES] == [
        dataclasses.astuple(c) for c in (
            JPriorityClass("interactive", weight=4.0, max_defer=2),
            JPriorityClass("batch", weight=1.0, max_defer=6))]
    srv = BatchedServer(cfg, _weights(), max_len=MAX_LEN, slots=2,
                        prefill_chunk=8, decode_chunk=2, pools=2,
                        class_pools={"interactive": (0,)}, device="cpu")
    spec = _mini(lg.SCENARIOS["priority_starvation"])
    gen = lg.generate(spec, PYTEST_SEED)
    res = lg.drive(srv.engine(), gen, max_ticks=20_000, submit=srv.submit)
    m = lg.summarize(res)
    assert m["dropped"] == 0 and m["completed"] == len(gen)
    bound = {c.name: c.max_defer for c in STARVE_CLASSES}
    for tr in res.traces:
        assert tr.req.priority == tr.gen.priority
        assert tr.req.max_deferred <= bound[tr.req.priority]
        np.testing.assert_array_equal(tr.req.output(),
                                      oracle(tr.gen.prompt, tr.gen.max_new))
    assert {"interactive/p50_ttft", "batch/p50_ttft",
            "batch/max_deferred"} <= set(m)
    assert 0 < srv.engine().tick_no <= res.ticks - res.idle_skipped
