"""The port's SSM and hybrid families (RWKV6, Mamba2 + shared attention)
against the JAX package, on the same numpy inputs and the reference's own
weights.

Tolerances, with their reasons:

* Scans in f32 against the JAX sequential references: atol and rtol 1e-4.
  Both run the same f32 recurrence; only the order of the sums differs.
* Against the JAX chunked forms, the tolerances of tests/test_kernels.py
  (RWKV6 2e-3 / 2e-2, Mamba2 1e-3 / 1e-2).  RWKV6's chunked form is used
  only where its decay clamp is inactive: at the JAX tests' decays in
  [0.9, 0.999] and chunk 16.  At the model's chunk of 128 with model-range
  decays it is wrong (ROADMAP queue 3), so the model-range case is held
  against ``rwkv6_ref`` alone.
* One-token decode steps in f32: 1e-5.
* One block on bf16 activations: 2e-2 of the output's scale (atol 2e-2 ·
  max|ref|, rtol 2e-2), the tolerance of tests/test_torch_serve.py taken
  relative to the block's outputs, which reach 4-8 (where one bf16 ulp is
  2^-5..2^-4): the two frameworks round bf16 at different points.
* Forward against step-by-step decode inside the port: atol 0.08 (rwkv6)
  and 0.25 (zamba2), rtol 0.1, the tolerances with which
  tests/test_serve_consistency.py holds the reference's own two bf16 paths
  through the same model.
* Whole-model logits against the reference: atol 0.25, rtol 0.1 (the
  widest of those) for both families.  Each block agrees to about one bf16
  ulp on the same input (the block test), but the smoke models with the
  reference's weights amplify such differences layer by layer, as the
  reference's own forward and decode paths show.
* The reference's RWKV6 runs with its exact scan (``rwkv6_ref``) in place of
  its chunked form: at layer 1 of the smoke model with the reference's
  weights the decays reach 0.0113 and the cumulative decay in a 16-token
  chunk reaches e^-43, past the chunked form's e^-30 clamp, and its y is
  off by 4.62 of 41.75 (scripts/rwkv6_clamp_check.py).  T is a multiple of
  16, the smoke configs' chunk, so the JAX Mamba2 chunked form runs as it
  does in the reference's own tests.
"""
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels.mamba2_ssd import ops as j_mops
from repro.kernels.mamba2_ssd.ref import mamba2_ref as j_mamba2_ref
from repro.kernels.rwkv6_scan import ops as j_rops
from repro.kernels.rwkv6_scan.ref import rwkv6_ref as j_rwkv6_ref
from repro.models import blocks as j_blocks
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.kernels.mamba2_ssd.ops import mamba2, mamba2_decode_step
from repro_torch.kernels.rwkv6_scan.ops import rwkv6, rwkv6_decode_step
from repro_torch.models import blocks, bridge, lm
from repro_torch.runtime.serve import serving_params

ROOT = Path(__file__).resolve().parents[1]
SCAN_TOL = 1e-4
TOL = 2e-2
MODEL_ATOL = {"rwkv6-1.6b-smoke": 0.08, "zamba2-7b-smoke": 0.25}
REF_ATOL = 0.25

_j_rwkv6_ref = jax.jit(j_rwkv6_ref)
_j_rwkv6_chunked = jax.jit(j_rops.rwkv6_chunked, static_argnums=(6,))
_j_mamba2_ref = jax.jit(j_mamba2_ref)
_j_mamba2_chunked = jax.jit(j_mops.mamba2_chunked, static_argnums=(7,))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def exact_jax_rwkv6(monkeypatch):
    """The reference's blocks with its exact RWKV6 scan (see the module
    docstring); its Mamba2 path is left as it is."""
    monkeypatch.setattr(j_rops, "rwkv6", lambda r, k, v, w, u, s0=None,
                        chunk=64, impl="jnp": j_rwkv6_ref(r, k, v, w, u, s0))


def _close(got, ref, err_msg=""):
    """Within 2e-2 of the reference's scale (bf16 activations)."""
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max(),
                               rtol=TOL, err_msg=err_msg)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rwkv_inputs(rng, b, h, t, n, w_lo, w_hi):
    r, k, v = (0.5 * rng.standard_normal((b, h, t, n)) for _ in range(3))
    w = rng.uniform(w_lo, w_hi, (b, h, t, n))
    u = 0.1 * rng.standard_normal((h, n))
    s0 = 0.1 * rng.standard_normal((b, h, n, n))
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _mamba_inputs(rng, b, h, t, p, n, softplus_dt):
    x = rng.standard_normal((b, h, t, p))
    if softplus_dt:          # the model's dt: softplus of a wide normal
        dt = np.logaddexp(2.0 * rng.standard_normal((b, h, t)), 0.0)
        a = -np.ones(h)
    else:                    # tests/test_kernels.py's ranges
        dt = rng.uniform(0.01, 0.2, (b, h, t))
        a = -rng.uniform(0.5, 2.0, h)
    bm, c = (rng.standard_normal((b, t, n)) for _ in range(2))
    d = 0.1 * rng.standard_normal(h)
    h0 = 0.1 * rng.standard_normal((b, h, p, n))
    return [z.astype(np.float32) for z in (x, dt, a, bm, c, d, h0)]


# ------------------------------------------------------------------ scans

@pytest.mark.parametrize("b,h,t,n,w_lo,w_hi", [
    (2, 2, 128, 32, 0.9, 0.999), (1, 4, 64, 64, 0.9, 0.999),
    (2, 1, 96, 16, 0.9, 0.999),
    # model-range decays over two of the model's 128-token chunks
    (1, 2, 256, 64, 0.0113, 0.9997)])
def test_rwkv6_plain_matches_reference(rng, b, h, t, n, w_lo, w_hi):
    args = _rwkv_inputs(rng, b, h, t, n, w_lo, w_hi)
    y0, s0 = _j_rwkv6_ref(*map(jnp.asarray, args))
    y, s = rwkv6(*map(_t, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y0), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s0), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    if w_lo >= 0.9:          # where the chunked form's clamp is inactive
        y1, s1 = _j_rwkv6_chunked(*map(jnp.asarray, args), 16)
        np.testing.assert_allclose(y.numpy(), np.asarray(y1), atol=2e-3,
                                   rtol=2e-2)
        np.testing.assert_allclose(s.numpy(), np.asarray(s1), atol=2e-3,
                                   rtol=2e-2)


@pytest.mark.parametrize("b,h,t,p,n,softplus_dt", [
    (2, 2, 128, 16, 8, False), (1, 4, 64, 32, 16, False),
    (1, 2, 256, 64, 64, True)])
def test_mamba2_plain_matches_reference(rng, b, h, t, p, n, softplus_dt):
    args = _mamba_inputs(rng, b, h, t, p, n, softplus_dt)
    y0, h0 = _j_mamba2_ref(*map(jnp.asarray, args))
    y1, h1 = _j_mamba2_chunked(*map(jnp.asarray, args), 128)
    y, hT = mamba2(*map(_t, args))
    # the sequential oracle: relative to the output scale (softplus dt
    # reaches ~8, so |y| reaches the hundreds)
    scale = float(np.abs(np.asarray(y0)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(y0),
                               atol=SCAN_TOL * scale, rtol=SCAN_TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h0),
                               atol=SCAN_TOL * scale, rtol=SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y1), atol=1e-3 * scale,
                               rtol=1e-2)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h1),
                               atol=1e-3 * scale, rtol=1e-2)


def test_scans_keep_bf16_outputs_and_take_no_state(rng):
    args = _rwkv_inputs(rng, 1, 2, 20, 16, 0.5, 0.99)
    r, k, v, w = (_t(a).bfloat16() for a in args[:4])
    y, s = rwkv6(r, k, v, w, _t(args[4]))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y_ref, _ = rwkv6(r.float(), k.float(), v.float(), w.float(),
                     _t(args[4]), torch.zeros_like(s))
    assert torch.equal(y, y_ref.bfloat16())
    x, dt, a, bm, c, d, _ = _mamba_inputs(rng, 1, 2, 20, 8, 16, True)
    y, hT = mamba2(_t(x).bfloat16(), _t(dt), _t(a), _t(bm).bfloat16(),
                   _t(c).bfloat16(), _t(d))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32


def test_decode_steps_match_reference(rng):
    b, h, n, p = 2, 3, 16, 8
    state = 0.1 * rng.standard_normal((b, h, n, n)).astype(np.float32)
    r, k, v = (0.5 * rng.standard_normal((b, h, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.0113, 0.9997, (b, h, n)).astype(np.float32)
    u = 0.1 * rng.standard_normal((h, n)).astype(np.float32)
    jy, js = j_rops.rwkv6_decode_step(*map(jnp.asarray,
                                           (r, k, v, w, u, state)))
    ty, ts = rwkv6_decode_step(*map(_t, (r, k, v, w, u, state)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)

    hs = 0.1 * rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, h)), 0).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    bt, ct = (rng.standard_normal((b, n)).astype(np.float32)
              for _ in range(2))
    d = rng.standard_normal(h).astype(np.float32)
    jy, jh = j_mops.mamba2_decode_step(*map(jnp.asarray,
                                            (x, dt, a, bt, ct, d, hs)))
    ty, th = mamba2_decode_step(*map(_t, (x, dt, a, bt, ct, d, hs)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


# ------------------------------------------------------------------ blocks

@lru_cache(maxsize=None)
def _setup(arch, seed=0):
    cfg_j = j_get_arch(arch)
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(seed))
    return cfg_j, params, bridge.from_jax(jax.tree.map(np.asarray, params),
                                          device="cpu")


@pytest.mark.parametrize("arch,t", [("rwkv6-1.6b-smoke", "rwkv"),
                                    ("zamba2-7b-smoke", "mamba")])
def test_block_apply_and_decode_match_reference(rng, exact_jax_rwkv6, arch,
                                                t):
    """One block's full-sequence forward, then one decode step from the
    reference's state after that sequence (and the cache it writes)."""
    cfg_j, params, tp = _setup(arch)
    cfg = get_arch(arch)
    jp = jax.tree.map(lambda a: a[0], params[t])
    pp = {k: v[0] for k, v in tp[t].items()}
    x = jnp.asarray(rng.standard_normal((2, 32, cfg.d_model)), jnp.bfloat16)
    xt = bridge.from_jax(np.asarray(x), device="cpu")
    j_apply = jax.jit(lambda p, x: j_blocks.BLOCKS[t]["apply"](
        p, x, {"cfg": cfg_j, "impl": "jnp"}))
    _close(blocks.BLOCKS[t]["apply"](pp, xt, {"cfg": cfg}), j_apply(jp, x))

    # decode from a random state; row 1 inactive keeps its cache untouched
    one = j_blocks.BLOCKS[t]["cache"](cfg_j, 2, 8)
    jc = {k: jnp.asarray(0.3 * rng.standard_normal(v.shape), v.dtype)
          for k, v in one.items()}
    tc = {k: bridge.from_jax(np.asarray(v), device="cpu")
          for k, v in jc.items()}
    before = {k: v.clone() for k, v in tc.items()}
    xd = x[:, :1]
    jy, jc_new = jax.jit(lambda p, x, c: j_blocks.BLOCKS[t]["decode"](
        p, x, c, {"cfg": cfg_j}))(jp, xd, jc)
    ty = blocks.BLOCKS[t]["decode"](pp, xt[:, :1], tc, {
        "cfg": cfg, "active": torch.tensor([True, False])})
    _close(ty[:1], jy[:1])
    for k in tc:
        assert tc[k].dtype == before[k].dtype
        _close(tc[k][0], jc_new[k][0], err_msg=k)
        assert torch.equal(tc[k][1], before[k][1]), k


@pytest.mark.parametrize("arch", sorted(MODEL_ATOL))
def test_forward_matches_reference(exact_jax_rwkv6, arch):
    cfg_j, params, tp = _setup(arch)
    cfg = get_arch(arch)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 32))
    jl, _ = jax.jit(lambda p, t: j_lm.forward(p, {"tokens": t}, cfg_j))(
        params, jnp.asarray(toks, jnp.int32))
    tl, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert tl.dtype == torch.float32 and aux == {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=REF_ATOL,
                               rtol=0.1)


@pytest.mark.parametrize("arch", sorted(MODEL_ATOL))
def test_forward_matches_step_by_step_decode(arch):
    _, _, tp = _setup(arch)
    cfg = get_arch(arch)
    b, s = 2, 24
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, s)))
    ref, _ = lm.forward(tp, {"tokens": toks}, cfg)
    state = lm.init_cache(cfg, b, s + 4, device="cpu")
    got = []
    for i in range(s):
        lg, state = lm.decode_step(tp, state, toks[:, i:i + 1], cfg)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref.numpy(),
                               atol=MODEL_ATOL[arch], rtol=0.1)
    assert state["pos"].tolist() == [s] * b


def test_zamba2_shares_one_attention_copy():
    """One unstacked shared_attn weight copy (the reference's layout), a
    KV cache per occurrence, and the bridge carries the layout over."""
    cfg_j, params, tp = _setup("zamba2-7b-smoke")
    cfg = get_arch("zamba2-7b-smoke")
    defs = lm.model_defs(get_arch("zamba2-7b"))
    assert defs["shared_attn"]["wq"].shape == (3584, 32 * 112)
    assert defs["mamba"]["in_proj"].shape[0] == 68
    assert tp["shared_attn"]["wq"].shape == params["shared_attn"]["wq"].shape
    assert tp["shared_attn"]["wq"].dim() == 2
    caches = lm.init_cache(cfg, 3, 16, device="cpu")["caches"]
    n_shared = cfg.pattern.count("shared_attn")
    assert caches["shared_attn"]["k"].shape[:2] == (n_shared, 3)
    assert caches["mamba"]["h"].dtype == torch.float32
    assert caches["mamba"]["conv"].dtype == torch.bfloat16


def test_serving_weights_keep_the_f32_leaves():
    """Serving holds weights in bf16 except those a block reads in f32
    (RWKV6's bonus u and decay base w0; Mamba2's dt bias, A and D), so the
    served model computes what ``forward`` computes on the same weights."""
    for arch, t, kept in (("rwkv6-1.6b-smoke", "rwkv", {"u", "w0"}),
                          ("zamba2-7b-smoke", "mamba",
                           {"dt_bias", "a_log", "d_skip"})):
        tp = _setup(arch)[2]
        sp = serving_params(tp, "cpu")
        for name, w in sp[t].items():
            assert w.dtype == (torch.float32 if name in kept
                               else torch.bfloat16), name
            assert torch.equal(w, tp[t][name].to(w.dtype))
        assert sp["embed"].dtype == torch.bfloat16


# --------------------------------------------------------------- hygiene

def test_port_imports_no_jax_and_no_reference():
    """Every module of the port loads without pulling in jax or repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) > 30
