"""The port's M-RoPE (qwen2-vl-7b: the rotary's frequency dims split into
(t, h, w) sections, each rotated by its own position id) against the JAX
package, and ``qwen2-vl-7b-smoke`` through the port: its forward with and
without ``positions3``, its decode, and its serving.

Tolerances, with their reasons:

* ``apply_mrope`` in f32: 1e-4, as tests/test_torch_layers.py's
  ``apply_rope`` (sines and cosines of the same f32 angles).
* Whole-model logits against the reference: atol 0.25, rtol 0.1,
  tests/test_torch_ssm.py's ``REF_ATOL``.
* Forward against step-by-step decode inside the port: atol 0.08, rtol
  0.1, the reference's default in tests/test_serve_consistency.py.
* Serving: greedy ``ServeEngine`` output equals ``generate_static`` token
  for token.
"""
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.models import bridge, layers, lm
from repro_torch.runtime.serve import BatchedServer

ARCH = "qwen2-vl-7b-smoke"
REF_ATOL = 0.25
DECODE_ATOL = 0.08


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


def vision_positions3(b, gh, gw, n_text):
    """[b, gh·gw + n_text, 3] ids: a gh × gw patch grid (t 0, h its row, w
    its column), then text whose three ids all count on from the grid's
    largest extent."""
    i = np.arange(gh * gw)
    grid = np.stack([np.zeros_like(i), i // gw, i % gw], -1)
    text = np.repeat(max(gh, gw) + np.arange(n_text)[:, None], 3, 1)
    return np.broadcast_to(np.concatenate([grid, text]),
                           (b, gh * gw + n_text, 3)).copy()


@pytest.mark.parametrize("hd,bounds", [(16, [2, 5]), (128, [16, 40])])
def test_apply_mrope_matches_reference(rng, hd, bounds):
    assert layers.mrope_bounds(hd // 2) == bounds
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    p3 = rng.integers(0, 500, (2, 7, 3))
    for theta in (10_000.0, 1_000_000.0):
        ref = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(p3), theta)
        got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3),
                                 theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_apply_mrope_with_equal_ids_is_rope(rng):
    """With t = h = w every section rotates by the same id: plain RoPE."""
    x = torch.from_numpy(rng.standard_normal((2, 5, 2, 16)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 300, (2, 5)))
    torch.testing.assert_close(
        layers.apply_mrope(x, pos[..., None].expand(2, 5, 3), 1e6),
        layers.apply_rope(x, pos, 1e6), rtol=0, atol=0)


def test_config_resolves():
    full, smoke = get_arch("qwen2-vl-7b"), get_arch(ARCH)
    assert full.mrope and smoke.mrope
    assert (full.num_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert smoke.hd == 16 and smoke.pattern == ("attn",) * 2


@pytest.mark.parametrize("with_p3", [False, True])
def test_forward_matches_reference(with_p3):
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 16))
    batch = {"tokens": toks}
    if with_p3:
        batch["positions3"] = vision_positions3(2, 3, 4, 4)
    jl, _ = jax.jit(lambda p, bt: j_lm.forward(p, bt, cfg_j))(
        params, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    tl, _ = lm.forward(tp, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=REF_ATOL,
                               rtol=0.1)


def test_positions3_are_read():
    """Without ``positions3`` every id is the token's position; with the
    grid's ids the logits change."""
    _, _, tp = _setup()
    cfg = get_arch(ARCH)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (2, 16)))
    bare, _ = lm.forward(tp, {"tokens": toks}, cfg)
    same = torch.arange(16)[None, :, None].expand(2, 16, 3)
    flat, _ = lm.forward(tp, {"tokens": toks, "positions3": same}, cfg)
    grid, _ = lm.forward(tp, {"tokens": toks, "positions3": torch.from_numpy(
        vision_positions3(2, 3, 4, 4))}, cfg)
    assert torch.equal(bare, flat)
    assert not torch.allclose(bare, grid, atol=1e-3)


def test_decode_matches_forward_and_reference():
    """Step-by-step decode (each row's own position as its three ids)
    against the port's forward, and against the reference's decode."""
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    b, s = 2, 12
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (b, s))
    t = torch.from_numpy(toks)
    ref, _ = lm.forward(tp, {"tokens": t}, cfg)
    state = lm.init_cache(cfg, b, s + 4, device="cpu")
    jstate = j_lm.init_cache(cfg_j, b, s + 4)
    j_step = jax.jit(lambda p, st, x: j_lm.decode_step(p, st, x, cfg_j))
    got, jgot = [], []
    for i in range(s):
        lg, state = lm.decode_step(tp, state, t[:, i:i + 1], cfg)
        jl, jstate = j_step(params, jstate, jnp.asarray(toks[:, i:i + 1],
                                                        jnp.int32))
        got.append(lg)
        jgot.append(np.asarray(jl))
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, ref.numpy(), atol=DECODE_ATOL, rtol=0.1)
    np.testing.assert_allclose(got, np.stack(jgot, 1), atol=REF_ATOL,
                               rtol=0.1)


def test_engine_equals_static():
    cfg = get_arch(ARCH)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = BatchedServer(cfg, params, max_len=48, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 14)]
    eng = ServeEngine(cfg, params, max_len=48, slots=2, prefill_chunk=4,
                      decode_chunk=2, device="cpu")
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run_until_done()
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(p[None], 6)[0],
            err_msg=f"req {i}")
