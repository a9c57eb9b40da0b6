"""The port's draft models (``repro_torch.engine.draft``) against the JAX
package's, and the draft arm's state in the port's engine.

* ``truncated_draft_cfg`` and ``small_draft_cfg`` give the reference's
  configs field for field; ``slice_draft_params`` gives the reference's
  slices value for value on the reference's own weights (through
  ``bridge.from_jax``), as fresh tensors.
* Threading a draft through the engine never changes plain outputs; the
  draft's cache rows are zeroed on join with the rest of the pool row,
  carried in prefix snapshots, and seeded back.
* ``distill_draft`` at smoke size trains a small draft whose proposals a
  forced ``spec:draft`` arm accepts at least half the time, with outputs
  equal to the plain engine's (what tests/test_draft.py asks of the
  reference).
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.engine import draft as j_draft
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.engine import draft as t_draft
from repro_torch.models import bridge, lm
from repro_torch.runtime.serve import BatchedServer

ARCH = "paper-moe-100m-smoke"
ARCHS = [ARCH, "rwkv6-1.6b-smoke", "zamba2-7b-smoke"]
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops run fastest on one thread, and the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS + ["paper-moe-100m", "zamba2-7b"])
def test_draft_cfgs_match_reference(arch):
    cj, ct = j_get_arch(arch), get_arch(arch)
    for layers in range(1, ct.num_layers if ct.num_layers < 4 else 3):
        assert dataclasses.asdict(t_draft.truncated_draft_cfg(ct, layers)) \
            == dataclasses.asdict(j_draft.truncated_draft_cfg(cj, layers))
    if ct.num_layers > cj.serve.draft_layers:
        assert dataclasses.asdict(t_draft.truncated_draft_cfg(ct)) == \
            dataclasses.asdict(j_draft.truncated_draft_cfg(cj))
    for kw in ({}, {"layers": 2, "d_model": 48, "n_heads": 4}):
        assert dataclasses.asdict(t_draft.small_draft_cfg(ct, **kw)) == \
            dataclasses.asdict(j_draft.small_draft_cfg(cj, **kw))
    for bad in (0, ct.num_layers):
        with pytest.raises(ValueError):
            t_draft.truncated_draft_cfg(ct, bad)


@pytest.mark.parametrize("arch,layers", [(ARCH, 1), ("zamba2-7b-smoke", 2),
                                         ("zamba2-7b-smoke", 5)])
def test_slice_draft_params_match_reference(arch, layers):
    cj, ct = j_get_arch(arch), get_arch(arch)
    pj = jax.jit(j_lm.init, static_argnums=0)(cj, jax.random.PRNGKey(0))
    pt = bridge.from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    dj = j_draft.slice_draft_params(pj, cj,
                                    j_draft.truncated_draft_cfg(cj, layers))
    dt = t_draft.slice_draft_params(pt, ct,
                                    t_draft.truncated_draft_cfg(ct, layers))
    want = bridge.from_jax(jax.tree.map(np.asarray, dj), device="cpu")
    assert want.keys() == dt.keys()
    for k, w in want.items():
        pairs = [(dt[k][n], w[n]) for n in w] if isinstance(w, dict) \
            else [(dt[k], w)]
        for got, ref in pairs:
            assert got.shape == ref.shape and torch.equal(got, ref), k
    # the stacked groups are fresh tensors, the shared head is reused
    t = ct.pattern[0]
    for n, v in dt[t].items():
        assert v.data_ptr() != pt[t][n].data_ptr()
    assert dt["embed"] is pt["embed"]


@lru_cache(maxsize=None)
def _own(arch):
    cfg = get_arch(arch)
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, draft_layers=1))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, fused_gating=True, fused_dispatch=True))
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


@pytest.mark.parametrize("arch", ARCHS)
def test_threading_a_draft_never_changes_plain_outputs(rng, arch):
    cfg, params = _own(arch)
    dcfg = t_draft.small_draft_cfg(cfg)
    dparams = lm.init(dcfg, torch.Generator().manual_seed(1), device="cpu")
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (4, 11, 7)]
    outs = []
    for kw in ({}, {"draft": "self"},
               {"draft_cfg": dcfg, "draft_params": dparams}):
        eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=2,
                          prefill_chunk=4, decode_chunk=2, device="cpu",
                          **kw)
        outs.append(eng.generate(prompts, 8))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_rows_reset_on_join_and_ride_in_snapshots(rng, arch):
    cfg, params = _own(arch)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=2,
                      prefill_chunk=4, decode_chunk=2, device="cpu",
                      draft="self", spec_decode=True, prefix_cache=True)
    prompt = rng.integers(1, cfg.vocab, (12,)).astype(np.int32)
    eng.generate(prompt[None], max_new=4)
    snaps = [n for n in [eng.prefix.lookup(prompt[:k])
                         for k in range(4, 13)]
             if n is not None and n.snapshot is not None]
    assert snaps, "no prefix snapshot was captured"
    draft_rows = snaps[0].snapshot["draft"]
    assert any(c.any() for leaves in draft_rows.values()
               for c in leaves.values())
    assert snaps[0].snapshot["ctx"].any()
    # a second, prefix-sharing request seeds from it and stays identical
    ext = np.concatenate([prompt, rng.integers(1, cfg.vocab, (3,))
                          .astype(np.int32)])
    ref = BatchedServer(cfg, params, max_len=MAX_LEN, device="cpu") \
        .generate_static(ext[None], 6)
    np.testing.assert_array_equal(eng.generate(ext[None], max_new=6), ref)
    assert eng.prefix.seeded >= 1
    # a tick that resets both slots and runs neither zeroes every row leaf:
    # the caches, the n-gram tables and windows, and the draft rows
    sp = eng.pool
    assert any(c.any() for _, c, _ in sp.row_leaves())
    eng._tick(sp, eng.params, eng.draft_params, np.zeros((2, 1), np.int64),
              np.ones(2, np.int64), np.zeros(2, bool), np.ones(2, bool),
              np.zeros(2, np.float32), sp.gens)
    for path, c, _ in sp.row_leaves():
        assert not c.any(), path
    assert {p[0] for p, _, _ in sp.row_leaves()} == \
        {"caches", "ng", "ctx", "draft"}


def test_distilled_draft_reaches_half_acceptance():
    cfg, params = _own(ARCH)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, (8,)).astype(np.int32)
               for _ in range(6)]
    dcfg = t_draft.small_draft_cfg(cfg)
    dparams = t_draft.distill_draft(cfg, params, dcfg, prompts, max_new=48,
                                    steps=300, seed=0)
    # the teacher streams are the static loop's greedy continuations
    streams = t_draft.greedy_streams(cfg, params, prompts[:3], max_new=8,
                                     max_len=32)
    static = BatchedServer(cfg, params, max_len=32, device="cpu") \
        .generate_static(np.stack(prompts[:3]), 8)
    for s, r in zip(streams, static):
        np.testing.assert_array_equal(s[8:], r)
    eng = ServeEngine(cfg, params, max_len=96, slots=2, prefill_chunk=4,
                      decode_chunk=4, spec_decode=True, draft_cfg=dcfg,
                      draft_params=dparams, device="cpu")
    orig = eng.engine.choose_serve_tick
    eng.engine.choose_serve_tick = lambda *a, **k: (
        "spec:draft" if orig(*a, **k) != "prefill"
        and k.get("spec_len", 0) > 1 else orig(*a, **k))
    outs = eng.generate(np.stack(prompts[:4]), max_new=32)
    ref = ServeEngine(cfg, params, max_len=96, device="cpu").generate(
        np.stack(prompts[:4]), max_new=32)
    np.testing.assert_array_equal(outs, ref)
    st = eng.spec_arms["draft"]
    assert st["proposed"] > 0
    assert st["accepted"] / st["proposed"] >= 0.5, st
