"""The port's ``gemma3-1b`` (sliding-window ``local`` blocks with a rolling
decode cache, 5 local : 1 global) against the JAX package, on the same
numpy inputs and the reference's own weights, and its serving inside the
port.

Tolerances, with their reasons:

* Decode attention in f32 against the reference's: 1e-5 of the output's
  scale (the same products, summed in another order).
* One ``local`` block on bf16 activations: 2e-2 of the output's scale
  (atol 2e-2 · max|ref|, rtol 2e-2), as tests/test_torch_ssm.py's block
  test: the two frameworks round bf16 at different points.
* Whole-model logits against the reference: atol 0.25, rtol 0.1,
  tests/test_torch_ssm.py's ``REF_ATOL``.
* Forward against step-by-step decode inside the port: atol 0.08, rtol
  0.1, as tests/test_serve_consistency.py holds the reference's own two
  paths through ``gemma3-1b-smoke``; the cache holds ``s + 4`` positions,
  so the window-8 rings wrap.
* Serving: greedy ``ServeEngine`` output equals ``generate_static`` token
  for token on prompts longer than the window: here on the reference
  seeding test's prompts and across a mid-stream weight publish; plain and
  with the prefix cache in tests/test_torch_prefix_cache.py, with each
  decode arm forced in tests/test_torch_spec.py (``gemma3-1b-smoke`` is one
  of their families).

The reference's own gemma3 serving tests (tests/test_prefix_cache.py's
seeding test and tests/test_async_checkpoint.py's publish test) fail on
the reference, so the port is held against its own ``generate_static``;
``test_prefix_seeding_on_the_reference_prompts`` runs the reference
seeding test's prompts and engine settings through the port.
"""
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro.models import blocks as j_blocks
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.models import attention, blocks, bridge, lm
from repro_torch.runtime.serve import BatchedServer

from conftest import PYTEST_SEED

ARCH = "gemma3-1b-smoke"
TOL = 2e-2
REF_ATOL = 0.25
DECODE_ATOL = 0.08
MAX_LEN = 48

_j_decode = jax.jit(j_attn.decode_attention,
                    static_argnames=("window", "rolling"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops run fastest on one thread, and the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@lru_cache(maxsize=None)
def _setup():
    """The reference's config and weights, and the port's copy of them."""
    cfg_j = j_get_arch(ARCH)
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(0))
    return cfg_j, params, bridge.from_jax(jax.tree.map(np.asarray, params),
                                          device="cpu")


@lru_cache(maxsize=None)
def _own():
    """The port's own weights and static oracle."""
    cfg = get_arch(ARCH)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, BatchedServer(cfg, params, max_len=MAX_LEN,
                                      device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, err_msg=""):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max(),
                               rtol=TOL, err_msg=err_msg)


def test_config_resolves():
    full, smoke = get_arch("gemma3-1b"), get_arch(ARCH)
    assert (full.num_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab, full.window) == \
        (26, 1152, 4, 1, 256, 6912, 262144, 1024)
    assert full.pattern.count("local") == 22 and full.tie_embeddings
    assert smoke.pattern == ("local",) * 5 + ("attn",)
    assert (smoke.d_model, smoke.hd, smoke.window) == (64, 16, 8)
    caches = lm.init_cache(smoke, 2, 20, device="cpu")["caches"]
    assert caches["local"]["k"].shape == (5, 2, 8, 1, 16)   # a window ring
    assert caches["attn"]["k"].shape == (1, 2, 20, 1, 16)


@pytest.mark.parametrize("smax,window,rolling,pos", [
    # a ring of 8 rows: before the wrap, the last row before it, at it,
    # and well past it
    (8, 8, True, (2, 6, 7, 8, 21)),
    # a plain cache with a window: rows inside, at and past the window
    (16, 5, False, (2, 4, 5, 9, 15))])
def test_decode_attention_matches_reference(rng, smax, window, rolling,
                                            pos):
    b, h, kh, hd = len(pos), 4, 1, 16
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, smax, kh, hd)).astype(np.float32)
            for _ in range(2))
    got = attention.decode_attention(
        *map(torch.from_numpy, (q, k, v)), torch.tensor(pos),
        window=window, rolling=rolling).numpy()
    for r, p in enumerate(pos):
        ref = np.asarray(_j_decode(*(jnp.asarray(x[r:r + 1])
                                     for x in (q, k, v)), p,
                                   window=window, rolling=rolling))
        np.testing.assert_allclose(got[r:r + 1], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"row {r} at pos {p}")


def test_local_block_apply_and_decode_match_reference(rng):
    """One ``local`` block's full-sequence forward past its window, then one
    decode step from a random ring at per-row positions before, at and
    after the wrap; the last row is inactive and keeps its ring."""
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    jp = jax.tree.map(lambda a: a[0], params["local"])
    pp = {k: v[0] for k, v in tp["local"].items()}
    s = 3 * cfg.window
    x = jnp.asarray(rng.standard_normal((2, s, cfg.d_model)), jnp.bfloat16)
    xt = bridge.from_jax(np.asarray(x), device="cpu")
    positions = np.tile(np.arange(s), (2, 1))
    ref = jax.jit(lambda p, x: j_blocks.BLOCKS["local"]["apply"](
        p, x, {"cfg": cfg_j, "positions": jnp.asarray(positions)}))(jp, x)
    _close(blocks.BLOCKS["local"]["apply"](
        pp, xt, {"cfg": cfg, "positions": torch.from_numpy(positions)}),
        ref)

    pos = (3, 7, 8, 19, 30)
    b = len(pos)
    one = j_blocks.BLOCKS["local"]["cache"](cfg_j, b, 64)
    assert one["k"].shape[1] == cfg.window
    jc = {n: jnp.asarray(0.3 * rng.standard_normal(c.shape), c.dtype)
          for n, c in one.items()}
    tc = {n: bridge.from_jax(np.asarray(c), device="cpu")
          for n, c in jc.items()}
    assert tc.keys() == blocks.BLOCKS["local"]["cache"](
        cfg, b, 64, None, "cpu").keys()
    before = {n: c.clone() for n, c in tc.items()}
    xd = jnp.asarray(rng.standard_normal((b, 1, cfg.d_model)), jnp.bfloat16)
    active = torch.tensor([True] * (b - 1) + [False])
    ty = blocks.BLOCKS["local"]["decode"](
        pp, bridge.from_jax(np.asarray(xd), device="cpu"), tc,
        {"cfg": cfg, "pos": torch.tensor(pos), "active": active})
    j_dec = jax.jit(lambda p, x, c, q: j_blocks.BLOCKS["local"]["decode"](
        p, x, c, {"cfg": cfg_j, "pos": q,
                  "positions": jnp.broadcast_to(q, (1, 1))}))
    for r, p in enumerate(pos[:-1]):
        jy, jc_new = j_dec(jp, xd[r:r + 1],
                           {n: c[r:r + 1] for n, c in jc.items()},
                           jnp.int32(p))
        _close(ty[r:r + 1], jy, err_msg=f"row {r} at pos {p}")
        for n in tc:
            _close(tc[n][r], jc_new[n][0], err_msg=f"{n} row {r}")
    for n in tc:
        assert torch.equal(tc[n][-1], before[n][-1]), n


def test_forward_matches_reference():
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 32))
    jl, _ = jax.jit(lambda p, t: j_lm.forward(p, {"tokens": t}, cfg_j))(
        params, jnp.asarray(toks, jnp.int32))
    tl, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert tl.dtype == torch.float32 and aux == {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=REF_ATOL,
                               rtol=0.1)


def test_forward_matches_step_by_step_decode():
    _, _, tp = _setup()
    cfg = get_arch(ARCH)
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, s)))
    ref, _ = lm.forward(tp, {"tokens": toks}, cfg)
    state = lm.init_cache(cfg, b, s + 4, device="cpu")
    assert state["caches"]["local"]["k"].shape[2] == cfg.window < s
    got = []
    for i in range(s):
        lg, state = lm.decode_step(tp, state, toks[:, i:i + 1], cfg)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref.numpy(),
                               atol=DECODE_ATOL, rtol=0.1)
    assert state["pos"].tolist() == [s] * b


def test_prefix_seeding_on_the_reference_prompts():
    """The prompts, weights and engine settings of the reference's
    tests/test_prefix_cache.py seeding test (which fails on the reference),
    through the port: the seeded engine equals the port's static loop."""
    cfg_j, _, tp = _setup()
    cfg = get_arch(ARCH)
    srv = BatchedServer(cfg, tp, max_len=64, device="cpu")
    rng = np.random.default_rng(PYTEST_SEED + 31)
    shared = rng.integers(1, cfg.vocab, 12).astype(np.int32)
    prompts = [np.concatenate([shared,
                               rng.integers(1, cfg.vocab, 3).astype(np.int32)])
               for _ in range(5)]
    eng = ServeEngine(cfg, tp, max_len=64, slots=2, prefill_chunk=4,
                      decode_chunk=2, prefix_cache=True, device="cpu")
    reqs = [eng.submit(p, max_new=5) for p in prompts]
    eng.run_until_done()
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(p[None], 5)[0],
            err_msg=f"req {i}")
    st = eng.prefix.stats()
    assert st["seeded"] >= 1 and st["snapshots"] >= 1
    assert st["tokens_avoided"] >= st["seeded"] * cfg.serve.prefix_min_len


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def test_publish_mid_stream_past_the_window():
    """A weight publish while a request that has wrapped its rings is in
    flight: nothing drops, and requests admitted after it equal the static
    loop on the new weights."""
    cfg, p1, _ = _own()
    p2 = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(7)
    eng = ServeEngine(cfg, p1, max_len=MAX_LEN, slots=2, prefill_chunk=4,
                      decode_chunk=2, prefix_cache=True, device="cpu")
    shared = rng.integers(1, cfg.vocab, (6,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab, (n,))
                               .astype(np.int32)]) for n in (3, 5, 4)]
    straddler = eng.submit(prompts[0], max_new=14)
    for _ in range(4):
        assert eng.tick()
    assert not straddler.done.is_set()
    assert eng.pool.pos_host[straddler.slot] > cfg.window
    eng.update(params=_numpy(p2), params_version=1)
    post = [eng.submit(p, max_new=8) for p in prompts[1:]]
    eng.run_until_done()
    assert eng.params_version == 1
    for r in (straddler, *post):
        assert r.done.is_set() and len(r.output()) == r.max_new
    oracle = BatchedServer(cfg, p2, max_len=MAX_LEN, device="cpu")
    for p, r in zip(prompts[1:], post):
        np.testing.assert_array_equal(
            r.output(), oracle.generate_static(p[None], 8)[0])
