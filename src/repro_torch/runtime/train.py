"""Train-step builders: forward and backward with microbatch gradient
accumulation, the MoE Reshape plan as a step input, the remat policy,
AdamW, and the load metrics (phi) as free step outputs — the JAX
package's ``runtime/train.py`` in torch.

PyTorch runs eagerly, so a "step function" here is a plain closure.  The
interactive loop's two step paths (``build_fused_step``,
``build_grad_step``) keep the reference's numerics: per-microbatch
gradients are summed in f32 in microbatch order and divided once by the
microbatch count before the AdamW update.  A caller that hands its state
over (``donate=True``, as the training loop does; the reference donates it
to its jitted step) gets the update in place (``adamw.apply_``); otherwise
the old state is left as it was (``adamw.apply``).  ``build_train_step``
is the reference's production step, with its own numerics, over a
``torch.distributed`` mesh or on one device.  ``TrainHyper.remat`` picks
how much of each block's activations the backward recomputes
(``lm.forward(remat=...)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeCfg
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
    remat: str = "none"             # "none" | "full" | "dots"


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
            token_offset, impl: str = "auto", mesh=None, layout: str = "tp"):
    """Mixed precision as the reference: one bf16 cast of the f32 leaves,
    the forward in bf16 under ``hyper.remat``, the cross entropy from an
    f32 log-softmax, plus ``aux_coef``·aux + ``z_coef``·z for MoE models.
    ``mesh``/``layout`` go to ``lm.forward`` (this rank's rows and expert
    slots).  Returns (loss, metrics); integer metrics are per layer ([L,E],
    [L,S], [L])."""
    params = _bf16(params)
    logits, aux = lm.forward(params, batch, cfg, plan=plan,
                             token_offset=token_offset, impl=impl,
                             remat=hyper.remat, mesh=mesh, layout=layout)
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
                   impl: str = "auto", mesh=None, layout: str = "tp"):
    """(loss, detached metrics, grads) with grads shaped and typed like
    ``params`` (the leaves are differentiated as given: f32 leaves get the
    f32 upcast of their bf16 cotangents)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch, cfg, hyper, plan, token_offset,
                            impl, mesh, layout)
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
            return {k: (copy_leaf(v) if k in moe_lib.EXPERT_LEAVES else v)
                    for k, v in tree.items()}

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


# ------------------------------------------------------- the production step

def _is_expert(tree) -> List[bool]:
    """Per leaf of ``tree`` in ``tree_leaves``' order: is it an expert leaf
    (``moe``'s ``moe.EXPERT_LEAVES``, which a mesh shards over
    ``model``)?"""
    return tree_leaves({k: {kk: k == "moe" and kk in moe_lib.EXPERT_LEAVES
                            for kk in v} if isinstance(v, dict) else False
                        for k, v in tree.items()})


def _shards(mesh, layout: str) -> int:
    """How many ranks the batch is cut over: ``data`` under "tp", every
    rank under "dp"."""
    names = tuple(mesh.mesh_dim_names)
    if layout == "dp":
        return mesh.size()
    return mesh.shape[names.index("data")] if "data" in names else 1


def shard_batch(batch, n_mb: int, mesh, layout: str = "tp"):
    """This rank's share of a global ``batch`` for ``build_train_step``:
    of every microbatch, the rows of its data row ("tp") or of its index
    over data x model ("dp"), as the reference's sharded step cuts each
    microbatch."""
    if mesh is None:
        return batch
    n = _shards(mesh, layout)
    names = tuple(mesh.mesh_dim_names)
    row = mesh.get_local_rank("data") if "data" in names else 0
    idx = row * mesh.shape[names.index("model")] + \
        mesh.get_local_rank("model") if layout == "dp" else row

    def cut(x):
        mb = x.shape[0] // n_mb
        return x.reshape((n_mb, n, mb // n) + x.shape[1:])[:, idx] \
            .reshape((n_mb * (mb // n),) + x.shape[1:])
    return {k: cut(v) for k, v in batch.items() if k in BATCH_KEYS}


def _mean_over_ranks(grads, mesh, layout: str):
    """The step's gradient from each rank's: the mean over the ranks that
    hold parts of the global batch.  Under "tp" every leaf is summed over
    ``data`` and divided by its size (the ``model`` ranks of a data row
    hold the same replicated gradients, and each its own slots' complete
    ones).  Under "dp" each rank's replicated gradient is its own rows',
    so those are summed over every rank, and each slot's holds every row
    of its data row that reached it, so those are summed over ``data``;
    both are divided by the number of ranks."""
    names = tuple(mesh.mesh_dim_names)
    data = mesh.get_group("data") if "data" in names and \
        mesh.shape[names.index("data")] > 1 else None
    n = _shards(mesh, layout)
    out = []
    for g, expert in zip(tree_leaves(grads), _is_expert(grads)):
        if layout == "dp" and not expert:
            if n > 1:
                moe_lib._all_reduce(g, None)
        elif data is not None:
            moe_lib._all_reduce(g, data)
        out.append(g / n if n > 1 else g)
    return tree_unflatten(grads, out)


def global_norm(grads, mesh=None) -> torch.Tensor:
    """``adamw.global_norm`` of the whole model's gradients where each
    rank holds its own expert slots: the expert leaves' sums of squares
    summed over ``model`` first (one all-reduce), then every leaf's added
    in ``tree_leaves``' order, so every rank gets the same norm bit for
    bit and clips its replicated leaves as the others do."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(grads)]
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    if mesh is not None and mesh.shape[names.index("model")] > 1:
        idx = [i for i, e in enumerate(_is_expert(grads)) if e]
        if idx:
            part = moe_lib._all_reduce(torch.stack([sq[i] for i in idx]),
                                       mesh.get_group("model"))
            for j, i in enumerate(idx):
                sq[i] = part[j]
    return torch.sqrt(sum(sq))


def build_train_step(cfg: ArchConfig, shape: ShapeCfg, hyper: TrainHyper,
                     mesh=None, layout: str = "tp", impl: str = "auto"):
    """The reference's production step (``build_train_step``): its
    ``shape.microbatches`` microbatches one after another, each
    microbatch's gradient added as ``a + f32(g) / n_mb``, integer metrics
    summed over microbatches and float ones averaged, then
    ``adamw.apply`` into a new state.  Returns ``step(state, batch,
    plan_slots, plan_cum) -> (new_state, metrics)``; a config without MoE
    layers ignores the plan.

    With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``, dims
    ``model`` and optionally ``data``) each rank passes its share of the
    batch (``shard_batch``) and its expert slots (``moe.shard_experts``)
    in ``state``: the MoE layers run expert-parallel in ``layout``, the
    accumulated gradients are averaged over the ranks
    (``_mean_over_ranks``), and AdamW clips by the whole model's norm
    (``global_norm``), so every rank's replicated leaves stay equal bit
    for bit.  Token offsets count global microbatches of every rank's
    rows."""
    n_mb = max(1, shape.microbatches)
    n_shards = 1 if mesh is None else _shards(mesh, layout)

    def step(state, batch, plan_slots, plan_cum):
        plan = _plan(cfg, plan_slots, plan_cum)
        tokens = batch["tokens"]
        gb, s = tokens.shape
        mb = gb // n_mb
        stp = int(state["step"])
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        state["params"])
        per_mb: List[Dict[str, torch.Tensor]] = []
        for i in range(n_mb):
            mbd = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()
                   if k in BATCH_KEYS}
            offset = (stp * n_mb + i) * (mb * n_shards * s)
            _, metrics, grads = value_and_grad(
                state["params"], mbd, cfg, hyper, plan, offset, impl, mesh,
                layout)
            gacc = tree_map(lambda a, g: a + g.float() / n_mb, gacc, grads)
            del grads
            per_mb.append(metrics)
        if mesh is not None:
            gacc = _mean_over_ranks(gacc, mesh, layout)
        metrics = {k: torch.stack([m[k] for m in per_mb]) for k in per_mb[0]}
        metrics = {k: v.mean(0) if v.is_floating_point() else
                   v.sum(0, dtype=v.dtype) for k, v in metrics.items()}
        params, opt, opt_m = adamw.apply(
            state["params"], gacc, state["opt"], hyper.opt,
            gnorm=None if mesh is None else global_norm(gacc, mesh))
        metrics.update(opt_m)
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return step
