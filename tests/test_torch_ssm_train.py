"""Training of the recurrent families against the JAX package: the plain
scan backwards (``rwkv6_bwd_ref``, ``mamba2_bwd_ref``) against
``jax.vjp`` of the reference's scans, and one training step of
``rwkv6-1.6b-smoke`` and ``zamba2-7b-smoke`` (loss and every gradient
leaf) against the reference's ``value_and_grad`` of its ``loss_fn`` and
its ``build_train_step``, on the reference's own weights
(``bridge.from_jax``) and the same tokens.

Tolerances, with their reasons:

* The scans' gradients against ``jax.vjp`` of the reference's exact scans
  (``rwkv6_ref``, ``mamba2_ref``), f32: 1e-4 of each gradient's largest
  magnitude, ``tests/test_torch_ssm.py``'s scan tolerance (the same f32
  recurrence, summed in another order).  Against ``jax.vjp`` of its
  chunked Mamba2 (``mamba2_chunked``, its training path): 1e-3, the
  chunked form's forward tolerance there (``tests/test_kernels.py``): the
  chunked form reassociates the sums over a chunk.
* The training step, in f32 (both frameworks' casts to bf16 keep f32,
  ``compute`` fixture): the loss within 1e-5 relative, every gradient
  leaf and the gradient norm within 1e-3 relative L2 (sums in other
  orders, and the reference's chunked Mamba2 against the port's exact
  recurrence), each parameter's first AdamW change within 1e-2 (an
  element with a near-zero gradient may move the other way, by 2 lr).
  In the models' bf16 only the loss is held, within 1e-3 relative
  (``chip_smoke.py``'s bound for the kernel step against the plain one):
  the bf16 gradients of these random smoke models are mostly rounding in
  both frameworks (``scripts/bf16_grad_check.py`` prints each one's
  distance from the same step in f64).
* The reference's RWKV6 runs its exact scan (``rwkv6_ref``) in place of
  its chunked form, which is wrong at model-range decays
  (``tests/test_torch_ssm.py``, ``exact_jax_rwkv6``).
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ShapeCfg
from repro.kernels.mamba2_ssd import ops as j_mops
from repro.kernels.mamba2_ssd.ref import mamba2_ref as j_mamba2_ref
from repro.kernels.rwkv6_scan import ops as j_rops
from repro.kernels.rwkv6_scan.ref import rwkv6_ref as j_rwkv6_ref
from repro.models import lm as j_lm
from repro.runtime import train as j_train
from repro_torch.configs import get_arch
from repro_torch.kernels.mamba2_ssd.ref import mamba2_bwd_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref
from repro_torch.models import bridge, lm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import train

SCAN_TOL = 1e-4
CHUNKED_TOL = 1e-3
LOSS_RTOL = {"bf16": 1e-3, "f32": 1e-5}
F32_GRAD_RTOL, F32_STEP_RTOL = 1e-3, 1e-2
ARCHS = ("rwkv6-1.6b-smoke", "zamba2-7b-smoke")
SEQ, BATCH, N_MB = 32, 4, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def exact_jax_rwkv6(monkeypatch):
    """The reference's blocks with its exact RWKV6 scan."""
    monkeypatch.setattr(j_rops, "rwkv6", lambda r, k, v, w, u, s0=None,
                        chunk=64, impl="jnp": j_rwkv6_ref(r, k, v, w, u, s0))


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ------------------------------------------------------- scans vs jax.vjp

def test_rwkv6_bwd_matches_jax_vjp(rng):
    """Model-range decays (down to 0.0113), s0 given, both cotangents."""
    b, h, t, n = 2, 2, 48, 16
    r, k, v = (0.5 * rng.standard_normal((b, h, t, n)) for _ in range(3))
    w = rng.uniform(0.0113, 0.9997, (b, h, t, n))
    u = 0.1 * rng.standard_normal((h, n))
    s0 = 0.1 * rng.standard_normal((b, h, n, n))
    dy = rng.standard_normal((b, h, t, n))
    ds_t = rng.standard_normal((b, h, n, n))
    ins = [x.astype(np.float32) for x in (r, k, v, w, u, s0)]
    dy, ds_t = dy.astype(np.float32), ds_t.astype(np.float32)
    _, vjp = jax.vjp(j_rwkv6_ref, *map(jnp.asarray, ins))
    want = jax.jit(vjp)((jnp.asarray(dy), jnp.asarray(ds_t)))
    got = rwkv6_bwd_ref(*map(torch.from_numpy, ins[:5]),
                        torch.from_numpy(dy), torch.from_numpy(ins[5]),
                        torch.from_numpy(ds_t))
    for g, w_ in zip(got, want):
        _close(g, w_, SCAN_TOL)


@pytest.mark.parametrize("oracle", ["exact", "chunked"])
def test_mamba2_bwd_matches_jax_vjp(rng, oracle):
    """The model's dt (softplus of a wide normal), h0 given, both
    cotangents, against the reference's exact scan and its chunked
    training form (chunk 16, the smoke configs')."""
    b, h, t, p, n = 2, 3, 48, 8, 16
    x = rng.standard_normal((b, h, t, p))
    dt = np.logaddexp(2.0 * rng.standard_normal((b, h, t)), 0.0)
    a = -rng.uniform(0.5, 2.0, h)
    bm, c = (rng.standard_normal((b, t, n)) for _ in range(2))
    d = rng.standard_normal(h)
    h0 = 0.1 * rng.standard_normal((b, h, p, n))
    dy = rng.standard_normal((b, h, t, p))
    dh_t = rng.standard_normal((b, h, p, n))
    ins = [z.astype(np.float32) for z in (x, dt, a, bm, c, d, h0)]
    dy, dh_t = dy.astype(np.float32), dh_t.astype(np.float32)
    if oracle == "exact":
        fn, tol = j_mamba2_ref, SCAN_TOL
    else:
        def fn(*args):
            return j_mops.mamba2_chunked(*args, chunk=16)
        tol = CHUNKED_TOL
    _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    want = jax.jit(vjp)((jnp.asarray(dy), jnp.asarray(dh_t)))
    got = mamba2_bwd_ref(*map(torch.from_numpy, ins[:6]),
                         torch.from_numpy(dy), torch.from_numpy(ins[6]),
                         torch.from_numpy(dh_t))
    for g, w_ in zip(got, want):
        _close(g, w_, tol)


# ------------------------------------------------------- a training step

def _f32_as_bf16(lib):
    """A stand-in for ``lib`` (``jnp`` or ``torch``) whose ``bfloat16`` is
    its f32, so a module's casts to bf16 keep f32."""
    proxy = types.SimpleNamespace(**{k: getattr(lib, k) for k in dir(lib)
                                     if not k.startswith("__")})
    proxy.bfloat16 = lib.float32
    return proxy


@pytest.fixture(params=["f32", "bf16"])
def compute(request, monkeypatch):
    """The activations' dtype of both frameworks' steps: the models' bf16,
    or f32 (their casts to bf16 keep f32), where the comparison of every
    gradient leaf is meaningful (see the module docstring)."""
    if request.param == "f32":
        for module, lib in ((j_lm, jnp), (j_train, jnp)):
            monkeypatch.setattr(module, "jnp", _f32_as_bf16(lib))
        for module in (lm, train):
            monkeypatch.setattr(module, "torch", _f32_as_bf16(torch))
    return request.param


def _setup(arch):
    cj, ct = j_get_arch(arch), get_arch(arch)
    state = jax.jit(j_train.make_state, static_argnums=0)(
        cj, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(5).integers(
        1, cj.vocab, (BATCH, SEQ)).astype(np.int32)
    params = bridge.from_jax(jax.tree.map(np.asarray, state["params"]),
                             "cpu")
    return cj, ct, state, tokens, params


def _leaves_close(got_tree, want_tree, rtol):
    for got, want in zip(tree_leaves(got_tree), jax.tree.leaves(want_tree)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err < rtol, err


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, exact_jax_rwkv6, compute):
    """The loss; in f32 every gradient leaf (in bf16 both frameworks'
    gradients are mostly rounding, see the module docstring)."""
    cj, ct, state, tokens, params = _setup(arch)
    mb = tokens[:BATCH // N_MB]

    def j_loss(p):
        return j_train.loss_fn(p, {"tokens": jnp.asarray(mb)}, cj,
                               j_train.TrainHyper(), None, 0)

    (jl, _), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        state["params"])
    tl, _, tg = train.value_and_grad(params, {"tokens": torch.from_numpy(mb)},
                                     ct, train.TrainHyper(), None, 0)
    assert abs(float(tl) - float(jl)) < LOSS_RTOL[compute] * float(jl)
    if compute == "f32":
        _leaves_close(tg, jg, F32_GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, exact_jax_rwkv6, compute):
    """One step of the reference's ``build_train_step`` (2 microbatches,
    the AdamW update) against the port's fused step from the same state:
    the loss; in f32 also the gradient norm and every parameter's change
    (the first AdamW step moves a parameter by about lr sign(g), so this
    holds the signs of the summed gradients)."""
    cj, ct, state, tokens, params = _setup(arch)
    shape = ShapeCfg("t", SEQ, BATCH, "train", N_MB)
    j_new, jm = jax.jit(j_train.build_train_step(
        cj, shape, j_train.TrainHyper()))(state, {"tokens": jnp.asarray(
            tokens)}, None, None)
    t_state = {"params": params,
               "opt": bridge.opt_from_jax(state["opt"], "cpu"),
               "step": torch.zeros((), dtype=torch.int32)}
    t_new, tm, tom = train.build_fused_step(ct, train.TrainHyper())(
        t_state, {"tokens": torch.from_numpy(tokens)}, None, None, 1.0,
        N_MB)
    assert abs(float(tm["loss"].mean()) - float(jm["loss"])) < \
        LOSS_RTOL[compute] * float(jm["loss"])
    if compute == "bf16":
        return
    np.testing.assert_allclose(float(tom["grad_norm"]),
                               float(jm["grad_norm"]), rtol=F32_GRAD_RTOL)
    # the first AdamW step moves an element by lr g / (|g| + eps): a
    # near-zero gradient whose sign the two sums see differently moves it
    # the other way, so the changes are held within 1e-2
    moved_t = {f"{i:04d}": a - b for i, (a, b) in enumerate(zip(
        tree_leaves(t_new["params"]), tree_leaves(params)))}
    moved_j = [np.asarray(a) - np.asarray(b) for a, b in zip(
        jax.tree.leaves(j_new["params"]), jax.tree.leaves(state["params"]))]
    _leaves_close(moved_t, moved_j, F32_STEP_RTOL)
