"""Draft models for the speculative serve tick.

The speculative tick's accept/commit machinery is proposer-agnostic: any
source of a ``spec_len``-token draft chain works, because the target model
verifies every position and a ``valid`` mask freezes every row past its
first mismatch (``engine.serve.SlotTick``).  This module supplies the
*draft-model* proposer family — a second, much smaller parameter set that
decodes ahead of the target:

* **truncated self-draft** (``truncated_draft_cfg`` + ``slice_draft_params``)
  — the serve model's own first ``cfg.serve.draft_layers`` blocks plus the
  shared embedding/head.  Zero extra weights to ship or train; its agreement
  with the full model is a property of the trained checkpoint (on random
  weights its acceptance is near 0, which exercises the all-reject path).

* **independent small draft** (``small_draft_cfg``) — a separately-specified
  tiny config over the same vocab (default: 1 block of the target's leading
  pattern type at d_model 32).  ``distill_draft`` trains it by
  cross-entropy on the target's own greedy streams: the draft's only job is
  to predict the target's argmax, so the target is the perfect teacher.

Either way the draft's correctness burden is zero: a wrong, stale, or
mid-stream hot-swapped draft can only lower acceptance, never change
output tokens — the target's argmax is what commits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import adamw

# model param groups that are not stacked per-block and are shared with any
# truncation of the layer pattern (the "shared head" of a self-draft)
_SHARED_KEYS = ("embed", "final_ln", "lm_head")


def truncated_draft_cfg(cfg: ArchConfig,
                        layers: Optional[int] = None) -> ArchConfig:
    """The self-draft config: the first ``layers`` blocks of ``cfg``'s
    pattern (default ``cfg.serve.draft_layers``) with every dimension kept —
    the draft IS the target's own bottom, so its params are slices of the
    target's (``slice_draft_params``)."""
    layers = int(cfg.serve.draft_layers if layers is None else layers)
    if not 1 <= layers < cfg.num_layers:
        raise ValueError(f"draft_layers={layers} must be in "
                         f"[1, {cfg.num_layers})")
    pat = cfg.pattern[:layers]
    if "enc" in pat or "dec" in pat:
        raise ValueError("self-draft only truncates decoder-only patterns")
    return dataclasses.replace(cfg, name=f"{cfg.name}-selfdraft{layers}",
                               num_layers=layers, layer_pattern=pat,
                               enc_layers=0)


def slice_draft_params(params, cfg: ArchConfig, draft_cfg: ArchConfig):
    """The truncated self-draft's parameter tree from the target tree:
    per-block-type stacks keep their first ``count-in-prefix`` rows
    (truncation keeps pattern order, so the prefix's occurrences of a type
    are the leading rows of its stack); shared-head groups are reused
    as-is.  The slices are copies, so a later write into the target's
    tensors cannot reach the draft."""
    counts: dict = {}
    for t in draft_cfg.pattern:
        counts[t] = counts.get(t, 0) + 1
    out = {k: params[k] for k in _SHARED_KEYS if k in params}
    for t, n in counts.items():
        if t == "shared_attn":
            out[t] = params[t]             # single shared copy, not stacked
            continue
        out[t] = {k: v[:n].clone() for k, v in params[t].items()}
    return out


def small_draft_cfg(cfg: ArchConfig, layers: int = 1, d_model: int = 32,
                    n_heads: int = 2) -> ArchConfig:
    """An independently-sized draft config over the target's vocab: the
    leading ``layers`` entries of the target's pattern at a much smaller
    width.  Pair with :func:`distill_draft` or externally-trained
    weights."""
    pat = cfg.pattern[:layers]
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-draft{layers}x{d_model}",
        num_layers=layers, layer_pattern=pat, d_model=d_model,
        n_heads=n_heads, n_kv_heads=1, head_dim=d_model // n_heads,
        d_ff=2 * d_model, enc_layers=0)


@torch.no_grad()
def greedy_streams(cfg: ArchConfig, params,
                   prompts: Sequence[np.ndarray], max_new: int = 64,
                   max_len: int = 160) -> List[np.ndarray]:
    """Teacher streams for distillation: each prompt plus the target's
    greedy continuation, rolled out as one batch (prompts must share one
    length) that routes as one MoE group per step, like the reference's
    batched scan."""
    plen = len(prompts[0])
    if any(len(p) != plen for p in prompts):
        raise ValueError("prompts must share a length")
    dev = adamw.tree_leaves(params)[0].device
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.long, device=dev)
    state = lm.init_cache(cfg, toks.shape[0], max_len, device=dev)
    logits = None
    for i in range(plen):
        logits, state = lm.decode_step(params, state, toks[:, i:i + 1], cfg)
    out = []
    for _ in range(max_new):
        nxt = torch.argmax(logits, dim=-1)
        out.append(nxt)
        logits, state = lm.decode_step(params, state, nxt[:, None], cfg)
    gen = torch.stack(out, 1).cpu().numpy().astype(np.int32)
    return [np.concatenate([np.asarray(p, np.int32), g])
            for p, g in zip(prompts, gen)]


def distill_draft(cfg: ArchConfig, params, draft_cfg: ArchConfig,
                  prompts: Sequence[np.ndarray], max_new: int = 64,
                  steps: int = 400, batch: int = 16, seq: int = 24,
                  stride: int = 4, lr: float = 3e-3, seed: int = 7,
                  max_len: int = 160):
    """Train a draft to imitate the target's greedy stream (cross-entropy on
    next-token over windows of the teacher streams) and return its params
    (f32, on the target's device).  The initial draft weights are drawn
    from a ``torch.Generator`` seeded with ``seed``, the windows from a
    numpy generator of the same seed; ``lm.forward`` runs with the port's
    kernels on the card.  Serving keeps running while a newer draft
    distills; ``ServeEngine`` republishes it mid-stream via
    ``update(draft_params=...)`` without dropping requests."""
    streams = greedy_streams(cfg, params, prompts, max_new, max_len)
    xs, ys = [], []
    for st in streams:
        arr = np.asarray(st, np.int64)
        for i in range(0, len(arr) - seq, stride):
            xs.append(arr[i:i + seq])
            ys.append(arr[i + 1:i + seq + 1])
    X, Y = np.stack(xs), np.stack(ys)

    dev = adamw.tree_leaves(params)[0].device
    dparams = lm.init(draft_cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    ocfg = adamw.AdamWCfg(lr=lr, warmup_steps=max(steps // 20, 1),
                          total_steps=steps, weight_decay=0.0)
    ostate = adamw.init(dparams)

    def loss_fn(p, x, y):
        logits, _ = lm.forward(p, {"tokens": x}, draft_cfg)
        ll = torch.log_softmax(logits, dim=-1)
        return -torch.gather(ll, -1, y[..., None]).mean()

    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, len(X), batch)
        leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(True),
                                dparams)
        flat = adamw.tree_leaves(leaves)
        loss = loss_fn(leaves, torch.as_tensor(X[idx], device=dev),
                       torch.as_tensor(Y[idx], device=dev))
        # lm.init builds its dicts in sorted-key order, the order in which
        # tree_leaves flattens them, so the gradients map back leaf by leaf
        it = iter(torch.autograd.grad(loss, flat))
        grads = adamw.tree_map(lambda _: next(it), leaves)
        dparams, ostate, _ = adamw.apply(dparams, grads, ostate, ocfg)
    return dparams

