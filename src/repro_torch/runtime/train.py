"""Train-step builders: forward and backward with microbatch gradient
accumulation, the MoE Reshape plan as a step input, AdamW, and the load
metrics (phi) as free step outputs — the JAX package's
``runtime/train.py`` in torch.

PyTorch runs eagerly, so a "step function" here is a plain closure.  The
two step paths keep the reference's numerics: per-microbatch gradients
are summed in f32 in microbatch order and divided once by the microbatch
count before the AdamW update.  A caller that hands its state over
(``donate=True``, as the training loop does; the reference donates it to
its jitted step) gets the update in place (``adamw.apply_``); otherwise the
old state is left as it was (``adamw.apply``).  Activations are kept for
the backward (no remat); remat policies and the layout arguments belong to
a later multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


# the batch entries the model reads: tokens, whisper's frames and
# qwen2-vl's (t, h, w) position ids
BATCH_KEYS = ("tokens", "frames", "positions3")


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    opt: adamw.AdamWCfg = adamw.AdamWCfg()
    aux_coef: float = 0.01
    z_coef: float = 1e-4


def make_state(cfg: ArchConfig, generator: torch.Generator,
               dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Random f32 weights from ``generator`` (which lives on ``device``),
    zero AdamW moments and step 0."""
    params = lm.init(cfg, generator, dtype, device)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _plan(cfg, plan_slots, plan_cum):
    return moe_lib.RoutingPlan(plan_slots, plan_cum) \
        if lm.n_moe_layers(cfg) else None


def _bf16(params):
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.dtype == torch.float32 else x, params)


def loss_fn(params, batch, cfg: ArchConfig, hyper: TrainHyper, plan,
            token_offset, impl: str = "auto"):
    """Mixed precision as the reference: one bf16 cast of the f32 leaves,
    the forward in bf16, the cross entropy from an f32 log-softmax, plus
    ``aux_coef``·aux + ``z_coef``·z for MoE models.  Returns (loss,
    metrics); integer metrics are per layer ([L,E], [L,S], [L])."""
    params = _bf16(params)
    logits, aux = lm.forward(params, batch, cfg, plan=plan,
                             token_offset=token_offset, impl=impl)
    tokens = batch["tokens"]
    labels = tokens[:, 1:].long()
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    ce = -torch.gather(lp, -1, labels[..., None])[..., 0]
    loss = ce.mean()
    metrics = {"ce": loss}
    if "moe" in aux:
        aux_l = aux["moe"]["aux_loss"].mean()
        z_l = aux["moe"]["router_z"].mean()
        loss = loss + hyper.aux_coef * aux_l + hyper.z_coef * z_l
        metrics["aux_loss"] = aux_l
        metrics["expert_counts"] = aux["moe"]["expert_counts"]   # [L, E]
        metrics["slot_counts"] = aux["moe"]["slot_counts"]       # [L, S]
        metrics["dropped"] = aux["moe"]["dropped"]               # [L]
    metrics["loss"] = loss
    return loss, metrics


def value_and_grad(params, batch, cfg, hyper, plan, token_offset,
                   impl: str = "auto"):
    """(loss, detached metrics, grads) with grads shaped and typed like
    ``params`` (the leaves are differentiated as given: f32 leaves get the
    f32 upcast of their bf16 cotangents)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch, cfg, hyper, plan, token_offset,
                            impl)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    grads = tree_unflatten(leaves, grads)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _update(state, grads, hyper: TrainHyper, lr_scale, donate: bool):
    """The AdamW update of ``state`` by ``grads`` (already divided by the
    microbatch count): in place when the caller donates ``state`` (and
    ``grads``), else into new tensors.  Returns (new state, metrics)."""
    if donate:
        count, m = adamw.apply_(state["params"], grads, state["opt"],
                                hyper.opt, lr_scale)
        params = state["params"]
        opt = adamw.OptState(state["opt"].m, state["opt"].v, count)
    else:
        params, opt, m = adamw.apply(state["params"], grads, state["opt"],
                                     hyper.opt, lr_scale)
    return {"params": params, "opt": opt, "step": state["step"] + 1}, m


def build_fused_step(cfg: ArchConfig, hyper: TrainHyper, impl: str = "auto"):
    """The fused fast path of the interactive loop: every microbatch in
    one call with gradient accumulation, then the optimizer apply, and the
    metrics left on the device for one fetch by the caller, stacked per
    microbatch ``[n_mb, ...]`` so breakpoint predicates can still be
    evaluated at microbatch granularity afterwards.

    Numerics mirror the granulated path exactly: the f32->bf16 cast is
    hoisted out of the microbatch loop and the gradients taken with
    respect to the bf16 leaves, whose f32 upcast is what the cast's
    backward would give; they are summed in place into one f32 buffer per
    leaf in microbatch order (``a + f32(g)``, rounded once) and divided
    once by ``n_mb``.

    ``step`` is the state's step as a host int (read from the state when
    None; the loop knows it, and a trace on the ``meta`` device cannot read
    it); ``donate=True`` updates ``state`` in place (see ``_update``)."""

    def fused(state, batch, plan_slots, plan_cum, lr_scale, n_mb: int,
              step=None, donate: bool = False):
        plan = _plan(cfg, plan_slots, plan_cum)
        tokens = batch["tokens"]
        gb, s = tokens.shape
        mb = gb // n_mb
        step = int(state["step"]) if step is None else step
        params_bf = _bf16(state["params"])
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        state["params"])
        per_mb: List[Dict[str, torch.Tensor]] = []
        for i in range(n_mb):
            mbd = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()
                   if k in BATCH_KEYS}
            offset = (step * n_mb + i) * (mb * s)
            _, metrics, grads = value_and_grad(params_bf, mbd, cfg, hyper,
                                               plan, offset, impl)
            tree_map(lambda a, g: a.add_(g), gacc, grads)
            del grads
            per_mb.append(metrics)
        del params_bf
        tree_map(lambda g: g.div_(n_mb), gacc)
        new, opt_m = _update(state, gacc, hyper, lr_scale, donate)
        mb_metrics = {k: torch.stack([m[k] for m in per_mb])
                      for k in per_mb[0]}
        return new, mb_metrics, opt_m

    return fused


def build_grad_step(cfg: ArchConfig, hyper: TrainHyper, impl: str = "auto"):
    """The interactive-mode pieces: one microbatch's gradient, a separate
    apply (the loop polls control between microbatches, the Amber
    granulated iteration), and ``migrate``."""

    def grad_mb(params, batch, plan_slots, plan_cum, offset):
        _, metrics, grads = value_and_grad(
            params, batch, cfg, hyper, _plan(cfg, plan_slots, plan_cum),
            int(offset), impl)
        return grads, metrics

    def apply(state, grads, n_mb: int, lr_scale, donate: bool = False):
        """``donate=True``: ``state`` and ``grads`` are handed over and
        updated in place (see ``_update``)."""
        grads = tree_map(lambda g: g.div_(n_mb) if donate else g / n_mb,
                         grads)
        return _update(state, grads, hyper, lr_scale, donate)

    def migrate(state, src_dst):
        """Expert state migration: copy slot src -> dst on every
        expert-stacked leaf of the params AND the optimizer moments, one
        (layer, src, dst) row of ``src_dst`` [M,3] after another, as the
        reference's scan does.  Returns a new state; the old one is not
        written."""
        rows = [tuple(int(x) for x in r) for r in src_dst]

        def copy_leaf(leaf):
            leaf = leaf.clone()
            for lyr, src, dst in rows:
                leaf[lyr, dst] = leaf[lyr, src]
            return leaf

        def on_moe(tree):
            return {k: (copy_leaf(v) if k in ("w_gate", "w_up", "w_down")
                        else v) for k, v in tree.items()}

        params = dict(state["params"])
        opt = state["opt"]
        if "moe" in params:
            params["moe"] = on_moe(params["moe"])
            m, v = dict(opt.m), dict(opt.v)
            m["moe"] = on_moe(m["moe"])
            v["moe"] = on_moe(v["moe"])
            opt = adamw.OptState(m, v, opt.count)
        return {"params": params, "opt": opt, "step": state["step"]}

    return grad_mb, apply, migrate
