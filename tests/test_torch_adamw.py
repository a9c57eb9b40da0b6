"""The in-place AdamW update and the donated training step.

``adamw.apply_`` must give ``adamw.apply``'s parameters and moments bit
for bit (it keeps every rounding point), step after step, and both stay
within the reference's tolerance of the JAX package's ``adamw.apply``
(rtol 1e-6, as ``tests/test_torch_optim.py``).  The fused and the
granulated steps, handed their state (``donate=True``), update the same
buffers in place and give the same bits as the functional steps, and the
fused step given its step as a host int gives the same bits as the one
that reads it from the state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro_torch.configs import get_arch
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import train

ARCH = "paper-moe-100m-smoke"
STEPS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(rng, params, scale):
    return tree_map(lambda p: torch.from_numpy(
        (scale * rng.standard_normal(tuple(p.shape))).astype(np.float32)),
        params)


def _np(tree):
    return jax.tree.map(lambda x: x.numpy(), tree)


def test_apply_in_place_bit_equal_to_apply(rng):
    """Five steps on paper-moe-100m-smoke's tree, clipping on in some steps
    and off in others, in warm-up and past it: ``apply_`` ≡ ``apply`` on
    every leaf of the parameters and both moments, the same count and
    metrics, and both within 1e-6 of the JAX package's update."""
    cfg = get_arch(ARCH)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    t_cfg, j_cfg = adamw.AdamWCfg(**cfg_kw), j_adamw.AdamWCfg(**cfg_kw)
    p_f = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_i = tree_map(torch.clone, p_f)
    s_f, s_i = adamw.init(p_f), adamw.init(p_i)
    j_p = jax.tree.map(jnp.asarray, _np(p_f))
    j_s = j_adamw.init(j_p)
    j_apply = jax.jit(j_adamw.apply, static_argnums=(3,))
    bufs = [x.data_ptr() for x in tree_leaves(p_i) + tree_leaves(s_i.m) +
            tree_leaves(s_i.v)]
    n = sum(x.numel() for x in tree_leaves(p_f))
    for step in range(STEPS):
        # a global norm about 3 (clipped to 1) or about 0.1 (not clipped)
        g = _grads(rng, p_f, (3.0 if step % 2 else 0.1) / n ** 0.5)
        j_p, j_s, j_m = j_apply(j_p, jax.tree.map(jnp.asarray, _np(g)), j_s,
                                j_cfg, 0.5)
        assert (float(j_m["grad_norm"]) > t_cfg.clip_norm) == bool(step % 2)
        p_f, s_f, m_f = adamw.apply(p_f, g, s_f, t_cfg, 0.5)
        count, m_i = adamw.apply_(p_i, tree_map(torch.clone, g), s_i, t_cfg,
                                  0.5)
        s_i = adamw.OptState(s_i.m, s_i.v, count)
        assert torch.equal(s_f.count, count)
        for k in ("grad_norm", "lr"):
            assert torch.equal(m_f[k], m_i[k])
            np.testing.assert_allclose(m_i[k].numpy(), np.asarray(j_m[k]),
                                       rtol=1e-6)
        for tf, ti, tj in ((p_f, p_i, j_p), (s_f.m, s_i.m, j_s.m),
                           (s_f.v, s_i.v, j_s.v)):
            for a, b, c in zip(tree_leaves(tf), tree_leaves(ti),
                               jax.tree.leaves(tj)):
                assert torch.equal(a, b)
                np.testing.assert_allclose(b.numpy(), np.asarray(c),
                                           rtol=1e-6, atol=1e-7)
    assert [x.data_ptr() for x in tree_leaves(p_i) + tree_leaves(s_i.m) +
            tree_leaves(s_i.v)] == bufs


def _step_inputs(cfg, n_mb=2, b=4, s=16):
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)))
    plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg), device="cpu")
    return {"tokens": tokens}, plan.slots, plan.cum, n_mb


def _fused_cfg():
    cfg = get_arch(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, fused_gating=True, fused_dispatch=True))


def _state(cfg):
    return train.make_state(cfg, torch.Generator().manual_seed(1),
                            device="cpu")


def _same_state(a, b):
    for x, y in zip(tree_leaves(a["params"]) + tree_leaves(a["opt"].m) +
                    tree_leaves(a["opt"].v),
                    tree_leaves(b["params"]) + tree_leaves(b["opt"].m) +
                    tree_leaves(b["opt"].v)):
        assert torch.equal(x, y)
    assert torch.equal(a["opt"].count, b["opt"].count)
    assert torch.equal(a["step"], b["step"])


def test_donated_fused_step_bit_equal_and_in_place():
    """Two fused steps handed their state: the same bits as two functional
    steps, in the same buffers; the functional step leaves its input as it
    was; ``step=`` as a host int is the step the state holds."""
    cfg = _fused_cfg()
    hyper = train.TrainHyper()
    fused = train.build_fused_step(cfg, hyper)
    batch, ps, pc, n_mb = _step_inputs(cfg)
    ref, don = _state(cfg), _state(cfg)
    before = tree_map(torch.clone, ref["params"])
    bufs = [x.data_ptr() for x in tree_leaves(don["params"])]
    for i in range(2):
        new, m_ref, _ = fused(ref, batch, ps, pc, 1.0, n_mb)
        if i == 0:
            for x, y in zip(tree_leaves(before), tree_leaves(ref["params"])):
                assert torch.equal(x, y)
        ref = new
        don, m_don, _ = fused(don, batch, ps, pc, 1.0, n_mb, step=i,
                              donate=True)
        for k in m_ref:
            assert torch.equal(m_ref[k], m_don[k])
    _same_state(ref, don)
    assert [x.data_ptr() for x in tree_leaves(don["params"])] == bufs


def test_donated_granulated_equals_fused():
    """Granulated (per-microbatch gradients summed in place, then the
    donated apply) ≡ the donated fused step, bit for bit, over two steps."""
    cfg = _fused_cfg()
    hyper = train.TrainHyper()
    fused = train.build_fused_step(cfg, hyper)
    grad_mb, apply, _ = train.build_grad_step(cfg, hyper)
    batch, ps, pc, n_mb = _step_inputs(cfg)
    tokens = batch["tokens"]
    mb, s = tokens.shape[0] // n_mb, tokens.shape[1]
    a, b = _state(cfg), _state(cfg)
    for step in range(2):
        a, _, _ = fused(a, batch, ps, pc, 1.0, n_mb, step=step, donate=True)
        acc = None
        for i in range(n_mb):
            g, _ = grad_mb(b["params"],
                           {"tokens": tokens[i * mb:(i + 1) * mb]}, ps, pc,
                           (step * n_mb + i) * mb * s)
            acc = g if acc is None else tree_map(lambda x, y: x.add_(y),
                                                 acc, g)
        b, _ = apply(b, acc, n_mb, 1.0, donate=True)
    _same_state(a, b)


def test_tree_unflatten_frees_its_leaves_without_the_collector():
    """``tree_unflatten`` (how ``train.value_and_grad`` shapes a step's
    gradients) keeps no reference cycle: once its tree is dropped, the
    leaves are freed at once, not when the garbage collector next runs,
    so a step's gradients do not outlive their microbatch."""
    import gc
    import weakref
    leaves = tuple(torch.ones(n) for n in (3, 4, 5))
    refs = [weakref.ref(x) for x in leaves]
    gc.disable()
    try:
        tree = adamw.tree_unflatten({"b": {"c": 0, "a": 0}, "a": 0}, leaves)
        assert [tree["a"].numel(), tree["b"]["a"].numel(),
                tree["b"]["c"].numel()] == [3, 4, 5]
        del tree, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
