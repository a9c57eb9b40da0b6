"""The reference's differential serve harness, run on the port.

The scenarios come from the reference's own seeded generator
(``tests/test_serve_differential.py`` ``gen_scenario``, the same seeds):
random prompts with a shared preamble, response budgets, slot counts,
chunk sizes, ``compact_decode``, ``spec_decode`` and the draft axis
(none, the truncated self-draft, the target as its own draft),
``prefix_cache``, one or two pools, control batches delivered between
ticks (pause/inspect/resume, chunk updates, speculation toggles, a garbage
draft publish, a value-identical weight publish) and loadgen arrival
ticks.  Device placements and ``drain_pool`` are not in the port; the
scenario's ``placements`` and ``drain_at`` draws are ignored.  Each
request's greedy output must equal the port's ``generate_static`` token
for token.  One more case forces every axis at once: two pools, forced
compact decode, the n-gram arm, the prefix cache and bursty arrivals.

As in tests/test_torch_compact.py, the tests run torch's native CPU GEMM
(``torch.backends.mkldnn`` off), whose rows do not depend on the batch
height.
"""
from functools import lru_cache

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.core import messages as M
from repro_torch.engine import ServeEngine
from repro_torch.engine.loadgen import arrival_offsets
from repro_torch.models import bridge
from repro_torch.runtime.serve import BatchedServer

from conftest import PYTEST_SEED
from test_serve_differential import (DECODE_CHUNKS, MAX_LEN, PREFILL_CHUNKS,
                                     gen_scenario)

ARCH = "gemma3-1b-smoke"
CFG = get_arch(ARCH)


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
def _weights():
    params = jax.jit(j_lm.init, static_argnums=0)(j_get_arch(ARCH),
                                                  jax.random.PRNGKey(0))
    return bridge.from_jax(jax.tree.map(np.asarray, params), device="cpu")


_ORACLE = {}


def oracle(prompt, max_new):
    key = (tuple(int(t) for t in prompt), int(max_new))
    if key not in _ORACLE:
        srv = BatchedServer(CFG, _weights(), max_len=MAX_LEN, device="cpu")
        _ORACLE[key] = srv.generate_static(
            np.asarray(prompt, np.int32)[None], max_new=int(max_new))[0]
    return _ORACLE[key]


def _ctl_batch(eng, kind, rng):
    """One control batch into the mailbox (the reference harness's): a
    pause always comes with its resume, since a single-threaded loop
    would otherwise block in the poll."""
    ctl = eng.engine.controller
    if kind == "pause_batch":
        ctl.send(M.pause())
        ctl.send(M.inspect())
        ctl.send(M.update(max_prefill_defer=int(rng.integers(1, 8))))
        ctl.send(M.resume())
    elif kind == "update_chunks":
        ctl.send(M.update(decode_chunk=int(rng.choice(DECODE_CHUNKS)),
                          prefill_chunk=int(rng.choice(PREFILL_CHUNKS))))
    elif kind == "toggle_spec":
        ctl.send(M.update(spec_decode=bool(rng.integers(2))))
    elif kind == "update_draft":
        # garbage draft weights: a draft can only change acceptance
        if eng.draft_params is not None:
            ctl.send(M.update(draft_params=_tree(lambda x: -x,
                                                 eng.draft_params)))
        else:
            ctl.send(M.update(draft_params=None))
    elif kind == "publish_params":
        # value-identical weights under a new version: every invalidation
        # path runs while the outputs stay comparable with the oracle
        ctl.send(M.update(params=_tree(torch.clone, eng.params),
                          params_version=eng.params_version + 1))


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _draft_kwargs(sc, params):
    d = sc.get("draft")
    if d == "self":
        return {"draft": "self"}
    if d == "target":
        return {"draft_cfg": CFG, "draft_params": params}
    return {}


def run_scenario(sc):
    params = _weights()
    eng = ServeEngine(CFG, params, max_len=MAX_LEN, slots=sc["slots"],
                      prefill_chunk=sc["prefill_chunk"],
                      decode_chunk=sc["decode_chunk"],
                      compact_decode=sc["compact"], spec_decode=sc["spec"],
                      pools=sc.get("pools", 1),
                      prefix_cache=sc.get("prefix_cache", False),
                      device="cpu", **_draft_kwargs(sc, params))
    arrival = sc.get("arrival") or [0] * len(sc["prompts"])
    pend = sorted(range(len(sc["prompts"])), key=lambda i: arrival[i])
    reqs: list = [None] * len(sc["prompts"])
    ctl_rng = np.random.default_rng(sc["ctl_seed"])
    ticks = 0
    while pend or eng.queue or any(r is not None for r in eng.active):
        while pend and arrival[pend[0]] <= ticks:
            i = pend.pop(0)
            reqs[i] = eng.submit(sc["prompts"][i], max_new=sc["max_news"][i])
        if ticks in sc["schedule"]:
            _ctl_batch(eng, sc["schedule"][ticks], ctl_rng)
        assert eng.tick(), "engine stopped unexpectedly"
        ticks += 1
        assert ticks < 1000, "serve engine did not drain"
    for i, (p, n, r) in enumerate(zip(sc["prompts"], sc["max_news"], reqs)):
        assert r.done.is_set()
        np.testing.assert_array_equal(
            r.output(), oracle(p, n),
            err_msg=(f"req {i}: plen={len(p)} max_new={n} slots={sc['slots']}"
                     f" pc={sc['prefill_chunk']} dc={sc['decode_chunk']}"
                     f" compact={sc['compact']} spec={sc['spec']}"
                     f" draft={sc.get('draft')} pools={sc.get('pools', 1)}"
                     f" prefix_cache={sc.get('prefix_cache', False)}"
                     f" schedule={sc['schedule']}"))
    return eng


@pytest.mark.parametrize("case", range(8))
def test_differential_seeded(case):
    run_scenario(gen_scenario(np.random.default_rng(PYTEST_SEED * 1009
                                                    + case)))


def test_differential_every_axis_at_once():
    """Two pools, forced compact decode, the n-gram arm and the prefix
    cache on a shared preamble, under bursty arrivals: compact, speculative
    and seeded ticks all run, and every output equals the oracle."""
    rng = np.random.default_rng(PYTEST_SEED + 577)
    shared = rng.integers(1, CFG.vocab, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, CFG.vocab, n)
                               .astype(np.int32)]) for n in (2, 5, 3, 7, 4)]
    sc = {"prompts": prompts, "max_news": [6, 3, 8, 5, 7], "slots": 3,
          "prefill_chunk": 4, "decode_chunk": 2, "compact": True,
          "spec": True, "draft": None, "prefix_cache": True, "pools": 2,
          "schedule": {}, "ctl_seed": 0,
          "arrival": [int(t) for t in np.minimum(arrival_offsets(
              "bursty", len(prompts), rng, burst=2, gap=3.0), 12)]}
    eng = run_scenario(sc)
    assert eng.compact_ticks > 0 and eng.spec_ticks > 0
    assert eng.prefix.seeded + eng.prefix.result_hits > 0
