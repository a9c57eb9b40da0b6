"""Hot weight publish into the port's serve engine, on the CPU at smoke
size (modelled on the reference's tests/test_async_checkpoint.py publish
tests).

* ``update(params=..., params_version=...)`` mid-stream with genuinely
  different weights: every in-flight request completes, requests admitted
  after the boundary equal a fresh engine on the new weights, and neither
  a pre-swap stored answer nor a straddler's hybrid output answers a
  repeat; with a self-draft, the draft follows the swap.
* ``TrainLoop(publish_to=engine)`` publishes every 2 steps while the engine
  serves: no request drops, and requests admitted after the publish equal
  the static loop on the trained weights.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine import ServeEngine, slice_draft_params
from repro_torch.models import lm
from repro_torch.runtime import train
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.serve import BatchedServer, serving_params

MAX_LEN = 48


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops run fastest on one thread, and the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = get_arch("paper-moe-100m-smoke")
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, fused_gating=True,
                                     fused_dispatch=True),
        serve=dataclasses.replace(cfg.serve, draft_layers=1))


def _oracle(cfg, params, prompt, max_new):
    return BatchedServer(cfg, params, max_len=MAX_LEN, device="cpu") \
        .generate_static(np.asarray(prompt, np.int32)[None], max_new)[0]


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _drain(eng, limit=1000):
    ticks = 0
    while eng.queue or any(r is not None for r in eng.pool.active):
        assert eng.tick() and ticks < limit
        ticks += 1


@pytest.mark.parametrize("draft", [None, "self"])
def test_publish_zero_drop_mid_stream(draft):
    cfg = _cfg()
    p1 = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p2 = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(7)
    eng = ServeEngine(cfg, p1, max_len=MAX_LEN, slots=2, prefill_chunk=4,
                      decode_chunk=2, prefix_cache=True, draft=draft,
                      spec_decode=draft is not None, device="cpu")
    shared = rng.integers(1, cfg.vocab, (6,)).astype(np.int32)
    prompts = [np.concatenate([shared,
                               rng.integers(1, cfg.vocab, (n,)).astype(
                                   np.int32)]) for n in (3, 5, 2, 4)]
    # request 0 finishes before the swap (its answer lands in the result
    # cache); request 1 straddles it (admitted old, finished new)
    done_pre = eng.submit(prompts[0], max_new=4)
    while not done_pre.done.is_set():
        assert eng.tick()
    np.testing.assert_array_equal(done_pre.output(),
                                  _oracle(cfg, p1, prompts[0], 4))
    straddler = eng.submit(prompts[1], max_new=12)
    for _ in range(2):
        assert eng.tick()
    assert not straddler.done.is_set()
    eng.update(params=_numpy(p2), params_version=1)
    post = [eng.submit(p, max_new=6) for p in prompts[2:]]
    repeat0 = eng.submit(prompts[0], max_new=4)
    repeat1 = eng.submit(prompts[1], max_new=12)
    _drain(eng)
    assert eng.params_version == 1
    for r in (done_pre, straddler, repeat0, repeat1, *post):
        assert r.done.is_set() and len(r.tokens) >= r.max_new
    for p, r in zip(prompts[2:], post):
        np.testing.assert_array_equal(r.output(), _oracle(cfg, p2, p, 6))
    np.testing.assert_array_equal(repeat0.output(),
                                  _oracle(cfg, p2, prompts[0], 4))
    np.testing.assert_array_equal(repeat1.output(),
                                  _oracle(cfg, p2, prompts[1], 12))
    new = serving_params(p2, "cpu")
    assert all(torch.equal(eng.params[k], new[k]) for k in ("embed",))
    if draft is not None:
        want = slice_draft_params(new, cfg, eng.draft_cfg)
        for t, leaves in want.items():
            for n, v in (leaves.items() if isinstance(leaves, dict)
                         else [(t, leaves)]):
                got = eng.draft_params[t][n] if isinstance(leaves, dict) \
                    else eng.draft_params[t]
                assert torch.equal(got, v), (t, n)


def test_trainloop_publishes_mid_stream():
    cfg = _cfg()
    serve = ServeEngine(cfg, lm.init(cfg, torch.Generator().manual_seed(9),
                                     device="cpu"),
                        max_len=MAX_LEN, slots=2, prefill_chunk=4,
                        decode_chunk=2, prefix_cache=True, device="cpu")
    loop = TrainLoop(cfg, TokenStream(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4, seed=3),
                     train.TrainHyper(),
                     LoopConfig(microbatches=1, step_path="fused",
                                publish_every=2, device="cpu"),
                     publish_to=serve)
    rng = np.random.default_rng(5)
    before = [serve.submit(rng.integers(1, cfg.vocab, (n,)).astype(
        np.int32), max_new=10) for n in (7, 9, 5)]
    for _ in range(3):                  # in flight when the publish lands
        assert serve.tick()
    loop.run(2)
    after_prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
                     for n in (6, 8)]
    after = [serve.submit(p, max_new=5) for p in after_prompts]
    _drain(serve)
    assert serve.params_version == 2
    for r in before + after:
        assert r.done.is_set() and len(r.output()) == r.max_new
    trained = loop.state["params"]
    for p, r in zip(after_prompts, after):
        np.testing.assert_array_equal(r.output(),
                                      _oracle(cfg, trained, p, 5))
