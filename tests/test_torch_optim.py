"""The port's AdamW against the JAX package's ``optim/adamw.py``.

Same params, same gradients (numpy, from the suite's seed), three steps:
the port must give the same parameters, moments, count, learning rate and
gradient norm within rtol 1e-6 (f32 rounding: the squared-norm sums run in
another order).  The gradients are scaled so that global-norm clipping is
active, and the schedule is in its warm-up (and, in the second case, in its
cosine decay).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro_torch.models import bridge
from repro_torch.optim import adamw

SHAPES = {"embed": (11, 6), "moe": {"w_gate": (2, 3, 6, 5), "ln1": (2, 6)},
          "final_ln": (6,)}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [x.numpy() for x in adamw.tree_leaves(tree)]


@pytest.mark.parametrize("start,warmup,total", [(0, 10, 100),
                                                (40, 5, 60)])
def test_three_steps_match_reference(rng, start, warmup, total):
    cfg_kw = dict(lr=1e-2, warmup_steps=warmup, total_steps=total)
    j_cfg, t_cfg = j_adamw.AdamWCfg(**cfg_kw), adamw.AdamWCfg(**cfg_kw)
    params = _tree(rng, SHAPES)
    j_p = jax.tree.map(jnp.asarray, params)
    j_s = j_adamw.init(j_p)._replace(count=jnp.asarray(start, jnp.int32))
    t_p = bridge.from_jax(params, device="cpu")
    t_s = adamw.init(t_p)._replace(count=torch.tensor(start,
                                                      dtype=torch.int32))
    j_apply = jax.jit(j_adamw.apply, static_argnums=(3,))
    for step in range(3):
        grads = _tree(rng, SHAPES, scale=3.0)       # global norm >> 1
        j_p, j_s, j_m = j_apply(j_p, jax.tree.map(jnp.asarray, grads), j_s,
                                j_cfg, 0.5)
        t_p, t_s, t_m = adamw.apply(t_p, bridge.from_jax(grads, "cpu"),
                                    t_s, t_cfg, 0.5)
        assert float(j_m["grad_norm"]) > t_cfg.clip_norm   # clipping on
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(t_m[k].numpy(), np.asarray(j_m[k]),
                                       rtol=1e-6)
        for tree_t, tree_j in ((t_p, j_p), (t_s.m, j_s.m), (t_s.v, j_s.v)):
            for a, b in zip(_t_leaves(tree_t), _leaves(tree_j)):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert int(t_s.count) == int(j_s.count) == start + step + 1


@pytest.mark.parametrize("step", [0, 3, 9, 10, 55, 99, 150])
def test_schedule_matches_reference(step):
    cfg_kw = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    want = j_adamw.schedule(j_adamw.AdamWCfg(**cfg_kw),
                            jnp.asarray(step, jnp.int32))
    got = adamw.schedule(adamw.AdamWCfg(**cfg_kw),
                         torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_update_is_functional(rng):
    """The update returns new tensors and leaves its inputs as they were
    (a checkpoint snapshot may still be reading them)."""
    params = bridge.from_jax(_tree(rng, SHAPES), device="cpu")
    grads = bridge.from_jax(_tree(rng, SHAPES), device="cpu")
    state = adamw.init(params)
    before = [x.clone() for x in adamw.tree_leaves(params)]
    adamw.apply(params, grads, state, adamw.AdamWCfg())
    for a, b in zip(before, adamw.tree_leaves(params)):
        assert torch.equal(a, b)
    assert int(state.count) == 0


def test_opt_state_bridge_round_trip(rng):
    params = jax.tree.map(jnp.asarray, _tree(rng, SHAPES))
    j_s = j_adamw.init(params)
    j_s = j_adamw.OptState(jax.tree.map(lambda x: x + 1.5, j_s.m),
                           jax.tree.map(lambda x: x + 2.5, j_s.v),
                           jnp.asarray(7, jnp.int32))
    t_s = bridge.opt_from_jax(jax.tree.map(np.asarray, j_s), device="cpu")
    assert int(t_s.count) == 7 and t_s.count.dtype == torch.int32
    for a, b in zip(_t_leaves(t_s.m) + _t_leaves(t_s.v),
                    _leaves(j_s.m) + _leaves(j_s.v)):
        np.testing.assert_array_equal(a, b)
