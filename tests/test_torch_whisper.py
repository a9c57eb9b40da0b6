"""The port's whisper-base encoder-decoder (``enc`` and ``dec`` blocks,
``lm.encode``, ``forward`` over frames, ``decode_step`` against the cross
K/V) against the JAX package, on the same numpy inputs and the reference's
own weights (``whisper-base-smoke``: 2 encoder and 2 decoder layers over 16
frames, d_model 64).

Tolerances, with their reasons:

* ``sinusoidal_positions`` in f32: 1e-6 (the same formula).
* One block, ``encode`` and the cross K/V on bf16 activations: 2e-2 of the
  output's scale (atol 2e-2 · max|ref|, rtol 2e-2), as
  tests/test_torch_gemma3.py's block test: the two frameworks round bf16
  at different points.
* Whole-model logits against the reference: atol 0.25, rtol 0.1,
  tests/test_torch_ssm.py's ``REF_ATOL``.
* Forward against step-by-step decode with the precomputed cross K/V:
  atol 0.15, rtol 0.1, the reference's own tolerance for whisper
  (tests/test_serve_consistency.py).
* ``TrainLoop`` steps: losses within 1e-3 and the gradient norm within
  1e-3 relative, as tests/test_torch_train.py's first step.
"""
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import blocks as j_blocks
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.runtime import train as j_train
from repro.runtime.loop import LoopConfig as JLoopConfig
from repro.runtime.loop import TrainLoop as JTrainLoop
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import blocks, bridge, layers, lm
from repro_torch.runtime import train
from repro_torch.runtime.loop import LoopConfig, TrainLoop

ARCH = "whisper-base-smoke"
TOL = 2e-2
REF_ATOL = 0.25
DECODE_ATOL = 0.15


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
def _inputs():
    """Tokens [2, 12] and frames [2, enc_seq, d_model] (the reference's
    consistency-test recipe)."""
    cfg = get_arch(ARCH)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab, (2, 12))
    frames = (rng.standard_normal((2, cfg.enc_seq, cfg.d_model)) * 0.1) \
        .astype(np.float32)
    return toks, frames


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, err_msg=""):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max(),
                               rtol=TOL, err_msg=err_msg)


def _bf16(rng, shape):
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, bridge.from_jax(np.asarray(j), device="cpu")


def test_config_and_tree_match_reference():
    _, params, tp = _setup()
    cfg = get_arch(ARCH)
    full = get_arch("whisper-base")
    assert (full.num_layers, full.enc_layers, full.enc_seq, full.d_model,
            full.n_heads, full.hd, full.d_ff, full.vocab, full.rope_theta) \
        == (6, 6, 1500, 512, 8, 64, 2048, 51865, 0.0)
    assert full.pattern == ("dec",) * 6 and full.tie_embeddings
    ref = jax.tree.map(lambda a: tuple(a.shape), params)
    got = {k: ({n: tuple(v.shape) for n, v in t.items()}
               if isinstance(t, dict) else tuple(t.shape))
           for k, t in tp.items()}
    assert got == ref
    assert set(tp["dec"]) >= {"cwq", "cwk", "cwv", "cwo", "ln_c"}
    assert tp["enc"]["wq"].shape[0] == cfg.enc_layers


@pytest.mark.parametrize("seq,dim", [(16, 64), (1500, 512)])
def test_sinusoidal_positions_match_reference(seq, dim):
    np.testing.assert_allclose(
        layers.sinusoidal_positions(seq, dim).numpy(),
        np.asarray(j_layers.sinusoidal_positions(seq, dim)), atol=1e-6,
        rtol=0)


def test_enc_and_dec_blocks_match_reference(rng):
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    b, s = 2, 10
    positions = np.tile(np.arange(s), (b, 1))
    jx, tx = _bf16(rng, (b, cfg.enc_seq, cfg.d_model))
    je, te = _bf16(rng, (b, cfg.enc_seq, cfg.d_model))
    pos_e = np.tile(np.arange(cfg.enc_seq), (b, 1))
    jp = jax.tree.map(lambda a: a[1], params["enc"])
    pp = {k: v[1] for k, v in tp["enc"].items()}
    ref = jax.jit(lambda p, x: j_blocks.enc_apply(
        p, x, {"cfg": cfg_j, "positions": jnp.asarray(pos_e)}))(jp, jx)
    _close(blocks.enc_apply(pp, tx, {"cfg": cfg, "positions":
                                     torch.from_numpy(pos_e)}), ref, "enc")
    jd, td = _bf16(rng, (b, s, cfg.d_model))
    jp = jax.tree.map(lambda a: a[0], params["dec"])
    pp = {k: v[0] for k, v in tp["dec"].items()}
    ref = jax.jit(lambda p, x, e: j_blocks.dec_apply(
        p, x, {"cfg": cfg_j, "positions": jnp.asarray(positions),
               "enc_out": e}))(jp, jd, je)
    _close(blocks.dec_apply(pp, td, {"cfg": cfg, "enc_out": te,
                                     "positions":
                                     torch.from_numpy(positions)}),
           ref, "dec")


def test_encode_matches_reference():
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    _, frames = _inputs()
    jf = jnp.asarray(frames).astype(jnp.bfloat16)
    ref = jax.jit(lambda p, f: j_lm.encode(p, f, cfg_j))(params, jf)
    got = lm.encode(tp, bridge.from_jax(np.asarray(jf), device="cpu"), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _close(got, ref)


def test_forward_with_frames_matches_reference():
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    toks, frames = _inputs()
    jl, _ = jax.jit(lambda p, t, f: j_lm.forward(
        p, {"tokens": t, "frames": f}, cfg_j))(
        params, jnp.asarray(toks, jnp.int32), jnp.asarray(frames))
    tl, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks),
                              "frames": torch.from_numpy(frames)}, cfg)
    assert tl.dtype == torch.float32 and aux == {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=REF_ATOL,
                               rtol=0.1)


def _cross_state(cfg, tp, frames, b, smax):
    """A decode state whose ``dec`` caches hold each layer's cross K/V of
    the encoder's output, as a real prefill would write them."""
    state = lm.init_cache(cfg, b, smax, device="cpu")
    enc = lm.encode(tp, torch.from_numpy(frames).to(torch.bfloat16), cfg)
    c = state["caches"]["dec"]
    for li in range(cfg.num_layers):
        k, v = blocks.cross_kv(cfg, {n: w[li] for n, w in tp["dec"].items()},
                               enc)
        c["ck"][li].copy_(k)
        c["cv"][li].copy_(v)
    return state, enc


def test_cross_kv_matches_reference_recipe():
    """The cross K/V as the reference's consistency test computes them
    (f32 weights, then one bf16 cast)."""
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    _, frames = _inputs()
    state, enc = _cross_state(cfg, tp, frames, 2, 16)
    je = j_lm.encode(params, jnp.asarray(frames).astype(jnp.bfloat16), cfg_j)
    for li in range(cfg.num_layers):
        ck = jnp.einsum("bsd,dq->bsq", je, params["dec"]["cwk"][li])
        _close(state["caches"]["dec"]["ck"][li],
               ck.reshape(2, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
               .astype(jnp.bfloat16), f"ck layer {li}")


def test_decode_with_cross_kv_matches_forward():
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    toks, frames = _inputs()
    b, s = toks.shape
    ref, _ = lm.forward(tp, {"tokens": torch.from_numpy(toks),
                             "frames": torch.from_numpy(frames)}, cfg)
    state, _ = _cross_state(cfg, tp, frames, b, s + 4)
    got = []
    t = torch.from_numpy(toks)
    for i in range(s):
        lg, state = lm.decode_step(tp, state, t[:, i:i + 1], cfg)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref.numpy(),
                               atol=DECODE_ATOL, rtol=0.1)
    assert state["pos"].tolist() == [s] * b


def test_dec_decode_matches_reference_step(rng):
    """One ``dec`` decode step from a random cache at per-row positions,
    each row against the reference's scalar-position step."""
    cfg_j, params, tp = _setup()
    cfg = get_arch(ARCH)
    pos = (0, 5, 11)
    b = len(pos)
    one = j_blocks.dec_cache(cfg_j, b, 16)
    jc = {n: jnp.asarray(0.3 * rng.standard_normal(c.shape), c.dtype)
          for n, c in one.items()}
    tc = {n: bridge.from_jax(np.asarray(c), device="cpu")
          for n, c in jc.items()}
    assert tc.keys() == blocks.dec_cache(cfg, b, 16, None, "cpu").keys()
    jp = jax.tree.map(lambda a: a[1], params["dec"])
    pp = {k: v[1] for k, v in tp["dec"].items()}
    jx, tx = _bf16(rng, (b, 1, cfg.d_model))
    ty = blocks.dec_decode(pp, tx, tc, {"cfg": cfg, "pos": torch.tensor(pos)})
    j_dec = jax.jit(lambda p, x, c, q: j_blocks.dec_decode(
        p, x, c, {"cfg": cfg_j, "pos": q}))
    for r, p in enumerate(pos):
        jy, jc_new = j_dec(jp, jx[r:r + 1],
                           {n: c[r:r + 1] for n, c in jc.items()},
                           jnp.int32(p))
        _close(ty[r:r + 1], jy, f"row {r} at pos {p}")
        for n in ("k", "v"):
            _close(tc[n][r], jc_new[n][0], f"{n} row {r}")


def test_train_loop_steps_match_reference():
    """Two fused ``TrainLoop`` steps from the reference's state, with the
    loops' zero frames: the same losses and gradient norms."""
    cfg_j = j_get_arch(ARCH)
    cfg = get_arch(ARCH)
    seq, gb, n_mb = 16, 4, 2
    jl = JTrainLoop(cfg_j, JTokenStream(vocab=cfg_j.vocab, seq_len=seq,
                                        global_batch=gb, seed=3),
                    j_train.TrainHyper(),
                    JLoopConfig(microbatches=n_mb, step_path="fused"))
    tl = TrainLoop(cfg, TokenStream(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=gb, seed=3),
                   train.TrainHyper(),
                   LoopConfig(microbatches=n_mb, step_path="fused",
                              device="cpu"))
    tl.state = bridge.state_from_jax(jax.tree.map(np.asarray, jl.state),
                                     device="cpu")
    hj, ht = jl.run(2), tl.run(2)
    assert len(hj) == len(ht) == 2
    for a, b in zip(hj, ht):
        assert abs(a["loss"] - b["loss"]) < 1e-3
        assert abs(a["grad_norm"] - b["grad_norm"]) < 1e-3 * a["grad_norm"]


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel_l2(a, b):
    return (torch.linalg.vector_norm((a - b).float()) /
            torch.linalg.vector_norm(b.float())).item()


def _tile_rel_l2(got, ref, rows=64):
    """The worst relative L2 error over tiles of ``rows`` sequence rows of
    one batch row and head ([B, S, H, hd]; the last tile of a ragged S is
    short)."""
    pad = -got.shape[1] % rows

    def tiles(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        b, s, h, hd = x.shape
        return x.reshape(b, s // rows, rows, h, hd).square().sum((2, 4))

    return (tiles(got - ref) / tiles(ref).clamp_min(1e-30)).sqrt().max() \
        .item()


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1500, 448, 77])
def test_cuda_flash_not_causal_at_whisper_shapes(cuda, sq):
    """The flash kernels without the causal mask over whisper's 1500 frames
    (not a multiple of the 64-row tile): the encoder's Sq = Sk and the
    cross-attention's Sq != Sk, forward and backward, against the plain
    version (``chunked_attention`` differentiated by autograd), both bf16:
    o, dq, dk and dv within 5e-3 relative L2 and 1e-2 in every 64-row
    tile, or, where the plain version is farther from the f32 oracle than
    the kernel, within those bounds of the oracle (chip_smoke.py's flash
    gates)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, sk, h, hd = 2, 1500, 8, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda)
    k, v = (torch.randn((b, sk, h, hd), generator=gen, device=cuda)
            for _ in range(2))
    do = torch.randn((b, sq, h, hd), generator=gen, device=cuda)
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    outs = {}
    for impl in ("cuda", "torch"):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        reset_launches()
        o = fops.flash_attention(*ts, causal=False, impl=impl)
        o.backward(do)
        torch.cuda.synchronize()
        n = 1 if impl == "cuda" else 0
        assert (LAUNCHES["flash_fwd"], LAUNCHES["flash_bwd"]) == (n, n)
        outs[impl] = [o] + [t.grad for t in ts]
    fs = [x.float().requires_grad_(True) for x in (q, k, v)]
    fo = attention_ref(*(x.transpose(1, 2) for x in fs), causal=False) \
        .transpose(1, 2)
    fo.backward(do.float())
    oracle = [fo] + [x.grad for x in fs]
    for name, got, plain, ref in zip(("o", "dq", "dk", "dv"), outs["cuda"],
                                     outs["torch"], oracle):
        if _rel_l2(got, plain) <= 5e-3 and _tile_rel_l2(got, plain) <= 1e-2:
            continue
        assert _rel_l2(got, ref) < _rel_l2(plain, ref), name
        assert _rel_l2(got, ref) <= 5e-3, name
        assert _tile_rel_l2(got, ref) <= 1e-2, name
