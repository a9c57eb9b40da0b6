"""Decoder LM over a layer pattern of the port's block types.

Layers are grouped by block type into *stacked* parameter groups with a
leading ``[L, ...]`` layer dim, exactly the JAX package's tree, so weights
carry over key for key (``models.bridge``); ``shared_attn`` keeps a single
unstacked weight copy for all its occurrences but a KV cache per
occurrence.  The reference's ``lax.scan`` over a stack becomes a Python
loop over the layer index.

``decode_step`` differs from the reference in one way the serve engine
needs: ``state["pos"]`` is a per-row position ``[B]``, so one batched call
advances rows at different depths, and ``moe_groups`` says how the MoE
groups the batch (see ``models.moe``).

An encoder-decoder (whisper: ``cfg.enc_layers``) keeps a stacked ``enc``
group and ``enc_ln`` beside its ``dec`` layers; ``encode`` runs it over
frame embeddings, ``forward`` takes them as ``batch["frames"]``, and a
decode reads the cross K/V that the caller wrote into each ``dec`` layer's
cache (``blocks.cross_kv``), as the reference's consistency test does.
"""
from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.blocks import BLOCKS
from repro_torch.models.layers import rms_norm, sinusoidal_positions
from repro_torch.models.params import (ParamDef, abstract_params,
                                       init_params, map_defs, stacked)


# ----------------------------------------------------------------- structure

def pattern_runs(cfg: ArchConfig):
    """[(block_type, count, per-type offset), ...] over cfg.pattern."""
    runs, offsets = [], defaultdict(int)
    for t, grp in itertools.groupby(cfg.pattern):
        c = len(list(grp))
        runs.append((t, c, offsets[t]))
        offsets[t] += c
    return runs


def type_counts(cfg: ArchConfig) -> Dict[str, int]:
    counts: Dict[str, int] = defaultdict(int)
    for t in cfg.pattern:
        counts[t] += 1
    return dict(counts)


def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    unsupported = set(cfg.pattern) - set(BLOCKS)
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: block types {sorted(unsupported)} are not ported")
    d = {"embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           "embed"),
         "final_ln": ParamDef((cfg.d_model,), ("embed",), "ones")}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    for t, n in type_counts(cfg).items():
        bd = BLOCKS[t]["defs"](cfg)
        d[t] = bd if t == "shared_attn" else \
            map_defs(lambda x: stacked(n, x), bd)
    if cfg.enc_layers:
        enc = BLOCKS["enc"]["defs"](cfg)
        d["enc"] = map_defs(lambda x: stacked(cfg.enc_layers, x), enc)
        d["enc_ln"] = ParamDef((cfg.d_model,), ("embed",), "ones")
    return d


def init(cfg: ArchConfig, generator: torch.Generator, dtype=torch.float32,
         device="cuda"):
    """Random weights from ``generator`` (which lives on ``device``)."""
    return init_params(model_defs(cfg), generator, dtype, device)


def abstract(cfg: ArchConfig, dtype=torch.float32):
    """The parameter tree on the ``meta`` device (no storage, no draw)."""
    return abstract_params(model_defs(cfg), dtype)


def _layer_params(params, t: str, li: int):
    """Block type ``t``'s weights for its ``li``-th occurrence."""
    if t == "shared_attn":
        return params[t]
    return {k: v[li] for k, v in params[t].items()}


def n_moe_layers(cfg: ArchConfig) -> int:
    return type_counts(cfg).get("moe", 0)


def _head(params, cfg, x):
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ------------------------------------------------------------------- forward

def encode(params, frames, cfg: ArchConfig, impl: str = "auto"):
    """Whisper's encoder over (stubbed) frame embeddings [B,Se,D]: plus
    sinusoidal positions, the ``enc`` stack (bidirectional attention), then
    ``enc_ln``."""
    b, s, _ = frames.shape
    x = frames + sinusoidal_positions(s, cfg.d_model, frames.device)[None] \
        .to(frames.dtype)
    ctx = {"cfg": cfg, "impl": impl,
           "positions": torch.arange(s, device=frames.device)[None]
           .expand(b, s)}
    for li in range(cfg.enc_layers):
        x = BLOCKS["enc"]["apply"](_layer_params(params, "enc", li), x, ctx)
    return rms_norm(x, params["enc_ln"], cfg.norm_eps)


def forward(params, batch: Dict[str, Any], cfg: ArchConfig, *, plan=None,
            token_offset: int = 0, impl: str = "auto", mesh=None,
            layout: str = "tp"):
    """batch: tokens [B,S], and for whisper frames [B,Se,D], for qwen2-vl
    optionally positions3 [B,S,3] (the (t, h, w) ids; without them every id
    is the token's position).  Returns (logits [B,S,V] f32, aux dict with
    the MoE metrics stacked over layers; the whole batch is one MoE
    group).

    ``impl`` picks the kernels' implementation: ``auto`` is the CUDA kernel
    for tensors on the card and the plain torch version on the CPU (the
    reference's default is its XLA chunked form, which the port does not
    have).

    ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with dims ``model``
    and optionally ``data``) runs every MoE layer expert-parallel, as
    ``layout`` says: "tp" (``moe.moe_ffn_sharded``) with each rank passing
    its data row's share of the batch, "dp" (``moe.moe_ffn_a2a``) with
    each rank passing its share over data x model; ``params`` hold the
    rank's own expert slots (``moe.shard_experts``), and the rest of the
    model runs on each rank as it is."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(torch.bfloat16)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    ctx = {"cfg": cfg, "moe_groups": "batch", "token_offset": token_offset,
           "positions": pos, "moe_metrics": [], "impl": impl, "mesh": mesh,
           "layout": layout}
    if cfg.mrope:
        p3 = batch.get("positions3")
        ctx["positions3"] = pos[..., None].expand(b, s, 3) if p3 is None \
            else p3
    if cfg.enc_layers:
        ctx["enc_out"] = encode(params, batch["frames"].to(torch.bfloat16),
                                cfg, impl)
    if plan is None and n_moe_layers(cfg):
        plan = moe_lib.identity_plan(cfg, n_moe_layers(cfg), device=dev)
    for t, count, off in pattern_runs(cfg):
        apply = BLOCKS[t]["apply"]
        for li in range(off, off + count):
            p_l = _layer_params(params, t, li)
            if t == "moe":
                ctx["plan_slots"], ctx["plan_cum"] = plan.slots[li], \
                    plan.cum[li]
            x = apply(p_l, x, ctx)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = _head(params, cfg, x)
    aux: Dict[str, Any] = {}
    if ctx["moe_metrics"]:
        aux["moe"] = {k: torch.cat([m[k] for m in ctx["moe_metrics"]])
                      for k in ctx["moe_metrics"][0]}
    return logits.float(), aux


# -------------------------------------------------------------------- decode

def init_cache(cfg: ArchConfig, batch: int, smax: int, kv_dtype=None,
               device="cuda"):
    """Per-type stacked caches (a leading dim of one entry per occurrence:
    attention ``k``/``v`` ``[n, B, Smax, KH, hd]``, whisper's cross K/V
    ``ck``/``cv`` ``[n, B, enc_seq, KH, hd]`` (zeros), recurrent states in
    the dtypes their blocks give them) and a per-row position ``[B]``."""
    caches = {}
    for t, n in type_counts(cfg).items():
        one = BLOCKS[t]["cache"](cfg, batch, smax, kv_dtype, device)
        caches[t] = {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                    device=device) for k, v in one.items()}
    return {"caches": caches,
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def decode_step(params, state, token, cfg: ArchConfig, *, plan=None,
                moe_groups: str = "batch", active=None,
                metrics: Optional[list] = None):
    """token [B,1] int; state from init_cache (its caches are updated in
    place).  Returns (logits [B,V] f32, state with ``pos`` advanced).

    ``moe_groups``: "batch" routes the B tokens as one MoE group hashed
    from row 0's position — the reference ``decode_step`` over a batch that
    shares one position; "row" makes every row its own group hashed from
    its own position — the reference engine's vmap over batch-1 slots.
    ``active`` [B] bool (default all): inactive rows leave their caches and
    positions untouched.  ``metrics``, when a list, receives each MoE
    layer's metrics dict."""
    pos = state["pos"]
    b = token.shape[0]
    x = params["embed"][token].to(torch.bfloat16)
    ctx = {"cfg": cfg, "pos": pos, "moe_groups": moe_groups,
           "token_offset": pos[:1], "active": active, "moe_metrics": []}
    if plan is None and n_moe_layers(cfg):
        plan = moe_lib.identity_plan(cfg, n_moe_layers(cfg), device=x.device)
    caches = state["caches"]
    for t, count, off in pattern_runs(cfg):
        decode = BLOCKS[t]["decode"]
        for li in range(off, off + count):
            p_l = _layer_params(params, t, li)
            c_l = {k: v[li] for k, v in caches[t].items()}
            if t == "moe":
                ctx["plan_slots"], ctx["plan_cum"] = plan.slots[li], \
                    plan.cum[li]
            x = decode(p_l, x, c_l, ctx)
    if metrics is not None:
        metrics.extend(ctx["moe_metrics"])
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = _head(params, cfg, x)
    step = torch.ones_like(pos) if active is None else active.long()
    return logits[:, 0].float(), {"caches": caches, "pos": pos + step}
