"""Per-layer weights as views of one ``torch.unbind`` per stacked leaf.

``lm.forward`` takes each block type's layers from its stacked leaves once
a forward (``lm._layer_views``), so the backward stacks the layers'
gradients once.  Held on four smoke configs (the recurrent ``rwkv`` and
``mamba`` + ``shared_attn`` stacks, gemma3's ``local``/``attn`` pattern,
whose block types come in several runs, and the MoE stack):

* in the autograd graph of ``loss_fn``, no ``SelectBackward0`` reaches a
  stacked leaf, and each stacked leaf feeds exactly one
  ``UnbindBackward0`` (through its bf16 cast);
* a fused training step is bit-equal to one with a ``v[li]`` per layer
  swapped in for the views (a ``select`` per layer, whose backward fills a
  zero tensor of the whole stack and adds the layers' together: adding
  zeros is exact), updated parameters and metrics alike.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import train

ARCHS = ("rwkv6-1.6b-smoke", "zamba2-7b-smoke", "gemma3-1b-smoke",
         "paper-moe-100m-smoke")
BATCH, SEQ, N_MB = 4, 16, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    cfg = get_arch(arch)
    state = train.make_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (BATCH, SEQ)))
    nl = lm.n_moe_layers(cfg)
    plan = moe_lib.identity_plan(cfg, nl, device="cpu") if nl else None
    return cfg, state, {"tokens": tokens}, plan


def _stacked(cfg, params):
    """The stacked leaves of ``params``, by (block type, key)."""
    return {(t, k): v for t in lm.type_counts(cfg) if t != "shared_attn"
            for k, v in params[t].items()}


def _consumers(root):
    """Every node of the graph under ``root`` -> the nodes that take its
    output."""
    seen, stack, users = set(), [root], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None:
                users.setdefault(nxt, []).append(node)
                stack.append(nxt)
    return users


@pytest.mark.parametrize("arch", ARCHS)
def test_one_unbind_per_stacked_leaf(arch):
    cfg, state, batch, plan = _setup(arch)
    params = tree_map(lambda p: p.detach().requires_grad_(True),
                      state["params"])
    loss, _ = train.loss_fn(params, batch, cfg, train.TrainHyper(), plan, 0)
    users = _consumers(loss.grad_fn)
    leaves = {}
    for node in users:
        if type(node).__name__ == "AccumulateGrad":
            leaves[id(node.variable)] = node
    for (t, k), leaf in _stacked(cfg, params).items():
        acc = leaves[id(leaf)]
        casts = users[acc]
        assert [type(c).__name__ for c in casts] == ["ToCopyBackward0"], \
            (t, k)
        names = [type(u).__name__ for u in users[casts[0]]]
        assert names == ["UnbindBackward0"], (t, k, names)


def _select_views(params, t, n):
    """The per-layer ``v[li]`` access that ``_layer_views`` replaced."""
    if t == "shared_attn":
        return [params[t]] * n
    return [{k: v[li] for k, v in params[t].items()} for li in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_step_bit_equal_to_select_per_layer(arch, monkeypatch):
    cfg, state, batch, plan = _setup(arch)
    ps, pc = (plan.slots, plan.cum) if plan else (None, None)
    fused = train.build_fused_step(cfg, train.TrainHyper())
    new, metrics, opt_m = fused(state, batch, ps, pc, 1.0, N_MB)
    monkeypatch.setattr(lm, "_layer_views", _select_views)
    old, metrics_old, opt_old = fused(state, batch, ps, pc, 1.0, N_MB)
    for a, b in zip(tree_leaves(new["params"]), tree_leaves(old["params"])):
        assert torch.equal(a, b)
    for k in metrics:
        assert torch.equal(metrics[k], metrics_old[k]), k
    assert torch.equal(opt_m["grad_norm"], opt_old["grad_norm"])
