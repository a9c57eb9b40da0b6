"""AdamW with global-norm clipping and a cosine schedule, over nested dicts
of tensors — the JAX package's ``optim/adamw.py`` written out in torch.

Every operation is the reference's, in the reference's order and in f32:
the schedule reads the count *before* the increment, weight decay applies
to every leaf, and gradients are clipped by their global norm (leaves
summed in sorted-key order, the JAX flatten order).  ``apply`` is
functional: it returns new tensors and leaves its inputs untouched, as the
reference's pure function does, so a step compared with another never sees
a buffer change under it.  ``apply_`` is the same update in place, for a
caller that hands its state over (the reference's donated step reuses the
parameters' and moments' buffers the same way): bit for bit ``apply``'s
result, with one temporary the size of the leaf at a time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor          # int32 scalar


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A nested dict shaped as ``tree`` holding ``leaves`` (an iterable, in
    ``tree_leaves``' sorted-key order)."""
    return _unflatten(tree, iter(leaves))


def _unflatten(tree, it):
    # a module-level recursion: a nested recursive closure would make a
    # reference cycle that keeps ``leaves`` (a step's gradients) alive
    # until the garbage collector runs
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init(params) -> OptState:
    z = tree_map(torch.zeros_like, params)
    device = tree_leaves(params)[0].device
    return OptState(z, tree_map(torch.zeros_like, params),
                    torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWCfg, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def apply(params, grads, state: OptState, cfg: AdamWCfg, lr_scale=1.0):
    """Returns (new_params, new_state, metrics {grad_norm, lr})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = schedule(cfg, state.count) * lr_scale
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        g = (g * scale).float()
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * step).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    return _select(out, 0), OptState(_select(out, 1), _select(out, 2),
                                     count), {"grad_norm": gnorm, "lr": lr}


def apply_(params, grads, state: OptState, cfg: AdamWCfg, lr_scale=1.0):
    """``apply`` in place: the parameters and both moments are updated in
    their own buffers and ``grads`` is consumed (its f32 leaves are used as
    scratch).  Returns (new count, metrics {grad_norm, lr}); the caller's
    new ``OptState`` is ``OptState(state.m, state.v, count)``.

    Every leaf goes through ``apply``'s operations in ``apply``'s order,
    each rounded where ``apply`` rounds it (``b1·m`` and ``(1-b1)·g``
    rounded, then added), so the two agree bit for bit: no fused
    multiply-add (``add_(x, alpha=...)``, ``addcmul_``) that would round
    once where ``apply`` rounds twice."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = schedule(cfg, state.count) * lr_scale
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.mul_(scale) if g.dtype == torch.float32 else \
            (g * scale).float()
        tmp = g * (1 - cfg.b2)
        v.mul_(cfg.b2).add_(tmp.mul_(g))
        m.mul_(cfg.b1).add_(g.mul_(1 - cfg.b1))
        step = torch.div(m, b1c, out=g)                  # mh
        step.div_(torch.div(v, b2c, out=tmp).sqrt_().add_(cfg.eps))
        step.add_(torch.mul(p.float(), cfg.weight_decay, out=tmp))
        step.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(p.float() - step)
    return count, {"grad_norm": gnorm, "lr": lr}


def _select(tree, i):
    """Component ``i`` of the (p, m, v) tuples at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i]
