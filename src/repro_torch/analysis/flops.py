"""Analytic FLOPs / bytes / collective accounting per (arch x shape x mesh).

A copy of the JAX package's ``analysis/flops.py`` (which imports no JAX),
arithmetic unchanged, so the port's step FLOPs, bytes and collective bytes
are the reference's; the hardware constants they are divided by live in
``launch/mesh.py``.  The reference's reasons for counting analytically
follow.

Why analytic: XLA's ``cost_analysis()`` counts ``scan`` (while-loop) bodies
ONCE (verified empirically — see DESIGN.md §3), so for scan-over-layers
programs it under-reports by ~num_layers.  We control every op in the model,
so exact per-block accounting is straightforward; ``cost_analysis()`` on the
unrolled 1–2-layer variants cross-checks these numbers (test_roofline).

Conventions: flops counted as 2*MACs; bf16 compute (2 bytes); fp32 master
params/optimizer.  MODEL_FLOPS follows the 6*N*D (dense) / 6*N_active*D (MoE)
convention; HLO_FLOPS additionally pays attention scores, capacity padding,
and remat recompute — the usefulness ratio MODEL/HLO quantifies that waste.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, ShapeCfg

BF16 = 2
F32 = 4


# ------------------------------------------------------------------ params

def _block_params(cfg: ArchConfig, t: str) -> int:
    d, f = cfg.d_model, cfg.d_ff
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = d * (h + 2 * kh) * hd + h * hd * d
    if t in ("attn", "local", "shared_attn"):
        return attn + 3 * d * f + 2 * d
    if t == "moe":
        m = cfg.moe
        s = m.num_experts + m.spare_slots
        return attn + d * m.num_experts + s * 3 * d * m.expert_d_ff + 2 * d
    if t == "rwkv":
        lora = 64
        # wr wk wv wg wo wcr = 6 d^2; lora pair; wck+wcv; 6 mu + 3 ln + w0;
        # u bonus
        return (6 * d * d + 2 * d * lora + 2 * d * f + 10 * d + h * hd)
    if t == "mamba":
        ssm = cfg.ssm
        di = ssm.expand * d
        nh = di // ssm.head_dim
        n = ssm.state_size
        return (d * (2 * di + 2 * n + nh) + ssm.conv_kernel * (di + 2 * n)
                + di * d + di + 3 * nh + d)
    if t in ("enc", "dec"):
        cross = attn if t == "dec" else 0
        lns = 3 if t == "dec" else 2
        return attn + cross + 2 * d * f + lns * d
    raise KeyError(t)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    total = cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab
    total += cfg.d_model
    from repro_torch.models.lm import type_counts
    for t, n in type_counts(cfg).items():
        cnt = 1 if t == "shared_attn" else n
        p = _block_params(cfg, t)
        if active_only and t == "moe":
            m = cfg.moe
            s = m.num_experts + m.spare_slots
            expert = s * 3 * cfg.d_model * m.expert_d_ff
            p = p - expert + m.top_k * 3 * cfg.d_model * m.expert_d_ff
        total += cnt * p
    if cfg.enc_layers:
        total += cfg.enc_layers * _block_params(cfg, "enc") + cfg.d_model
    return int(total)


# ------------------------------------------------------------------- flops

def _attn_score_flops(cfg: ArchConfig, s_ctx: float) -> float:
    """Per query token: QK^T + PV over s_ctx keys, all heads."""
    return 2 * 2 * s_ctx * cfg.n_heads * cfg.hd


def _block_fwd_flops_per_token(cfg: ArchConfig, t: str, s_ctx: float,
                               padded_moe: bool = True) -> float:
    d, f = cfg.d_model, cfg.d_ff
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn_proj = 2 * d * (h + 2 * kh) * hd + 2 * h * hd * d
    if t in ("attn", "shared_attn", "enc"):
        mlp = 2 * 3 * d * f if t not in ("enc", "dec") else 2 * 2 * d * f
        return attn_proj + _attn_score_flops(cfg, s_ctx) + mlp
    if t == "local":
        return attn_proj + _attn_score_flops(cfg, min(s_ctx, cfg.window)) + \
            2 * 3 * d * f
    if t == "dec":
        return (2 * attn_proj + _attn_score_flops(cfg, s_ctx)
                + _attn_score_flops(cfg, cfg.enc_seq) + 2 * 2 * d * f)
    if t == "moe":
        m = cfg.moe
        router = 2 * d * m.num_experts
        eff_k = m.top_k * (m.capacity_factor if padded_moe else 1.0)
        expert = eff_k * 2 * 3 * d * m.expert_d_ff
        return attn_proj + _attn_score_flops(cfg, s_ctx) + router + expert
    if t == "rwkv":
        n = cfg.hd
        tm = 2 * 4 * d * d + 2 * 2 * d * 64          # r,k,v,g + decay lora
        wkv = 2 * 3 * d * n                          # state upd + r.S per head
        out = 2 * d * d
        cm = 2 * (2 * d * f + d * d)
        return tm + wkv + out + cm
    if t == "mamba":
        ssm = cfg.ssm
        di = ssm.expand * d
        nh = di // ssm.head_dim
        n = ssm.state_size
        q = ssm.chunk
        proj = 2 * d * (2 * di + 2 * n + nh) + 2 * di * d
        conv = 2 * ssm.conv_kernel * (di + 2 * n)
        # chunked SSD per token: C@B^T [Q,N]->[Q,Q] amortized + att@x + state
        ssd = 2 * q * n + 2 * q * ssm.head_dim * nh / max(nh, 1) * nh + \
            4 * di * n
        return proj + conv + ssd
    raise KeyError(t)


def fwd_flops_per_token(cfg: ArchConfig, s_ctx: float,
                        padded_moe: bool = True) -> float:
    from repro_torch.models.lm import type_counts
    total = 2 * cfg.d_model * cfg.vocab              # lm head
    for t, n in type_counts(cfg).items():
        total += n * _block_fwd_flops_per_token(cfg, t, s_ctx, padded_moe)
    return total


@dataclasses.dataclass
class FlopCount:
    model_flops: float      # 6*N*D convention (active params)
    hlo_flops: float        # what the compiled program actually executes


def step_flops(cfg: ArchConfig, shape: ShapeCfg,
               remat: str = "none") -> FlopCount:
    toks = shape.tokens
    if shape.kind == "train":
        n_active = param_count(cfg, active_only=True)
        emb = cfg.vocab * cfg.d_model * (2 if not cfg.tie_embeddings else 1)
        model = 6.0 * (n_active - emb + cfg.d_model * cfg.vocab) * toks
        fwd = fwd_flops_per_token(cfg, shape.seq_len / 2) * toks
        mult = 3.0 + (1.0 if remat == "full" else
                      0.3 if remat == "dots" else 0.0)
        if cfg.enc_layers:
            enc = _block_fwd_flops_per_token(cfg, "enc", cfg.enc_seq) * \
                cfg.enc_layers * shape.global_batch * cfg.enc_seq
            fwd += enc * 1.0
        return FlopCount(model, fwd * mult)
    # decode (one token, cache of seq_len) or prefill
    if shape.kind == "prefill":
        n_active = param_count(cfg, active_only=True)
        model = 2.0 * n_active * toks
        return FlopCount(model, fwd_flops_per_token(cfg, shape.seq_len / 2)
                         * toks)
    n_active = param_count(cfg, active_only=True)
    b = shape.global_batch
    model = 2.0 * n_active * b
    return FlopCount(model, fwd_flops_per_token(cfg, shape.seq_len) * b)


# ------------------------------------------------------------------- bytes

def step_bytes_per_device(cfg: ArchConfig, shape: ShapeCfg, chips: int,
                          model_ways: int, remat: str = "none",
                          kv_bytes: int = BF16,
                          seq_shard_decode: bool = False) -> float:
    """HBM traffic per device per step (weights + activations + caches)."""
    n = param_count(cfg)
    if shape.kind == "train":
        # fwd+bwd read weights twice, write grads once; adam reads/writes
        w = n / chips * (2 * BF16 + 1 * F32 + 4 * F32)
        act_factor = {"none": 14, "dots": 8, "full": 4}[remat]
        from repro_torch.models.lm import type_counts
        acts = shape.tokens / chips * cfg.d_model * BF16 * act_factor * \
            cfg.num_layers
        return w + acts
    if shape.kind == "prefill":
        w = n * BF16 / model_ways       # weights read once, model-sharded
        acts = shape.tokens / chips * cfg.d_model * BF16 * 8 * cfg.num_layers
        return w + acts
    # decode: weights + KV cache stream through HBM once per token.
    # Weights are model-sharded; every device in a data row reads its own
    # copy of the model shard (batch within the row shares the read).
    # decode2d (seq_shard_decode): weights 2-D sharded over ALL chips
    # (weight-stationary), cache sequence-sharded -> both ~1/chips.
    w = n * BF16 / (chips if seq_shard_decode else model_ways)
    cache = _cache_bytes(cfg, shape, kv_bytes) / chips
    act = shape.global_batch * cfg.d_model * BF16 * 12 * cfg.num_layers / chips
    return w + cache + act


def _cache_bytes(cfg: ArchConfig, shape: ShapeCfg,
                 kv_bytes: int = BF16) -> float:
    from repro_torch.models.lm import type_counts
    b, s = shape.global_batch, shape.seq_len
    total = 0.0
    for t, cnt in type_counts(cfg).items():
        if t in ("attn", "moe", "shared_attn", "dec"):
            total += cnt * b * s * 2 * cfg.n_kv_heads * cfg.hd * kv_bytes
        elif t == "local":
            total += cnt * b * min(s, cfg.window) * 2 * cfg.n_kv_heads * \
                cfg.hd * kv_bytes
        elif t == "rwkv":
            total += cnt * b * (cfg.n_heads * cfg.hd * cfg.hd * F32
                                + 2 * cfg.d_model * BF16)
        elif t == "mamba":
            ssm = cfg.ssm
            di = ssm.expand * cfg.d_model
            total += cnt * b * ((di // ssm.head_dim) * ssm.head_dim *
                                ssm.state_size * F32 +
                                (ssm.conv_kernel - 1) * (di + 2 * ssm.state_size) * BF16)
    return total


# -------------------------------------------------------------- collectives

def collective_bytes_per_device(cfg: ArchConfig, shape: ShapeCfg,
                                mesh_shape: Dict[str, int],
                                fsdp: bool = True,
                                layout: str = "tp") -> float:
    """Per-device bytes over ICI per step (ring-collective convention:
    all-reduce of S bytes costs 2*S*(k-1)/k per device; all-gather /
    reduce-scatter cost S*(k-1)/k).

    layout "tp": batch over data, weights Megatron-TP over model (2 act
    all-reduces/layer + MoE psum-combine).  layout "dp": batch over
    data x model (attention/SSM fully local), MoE via all-to-all; weights
    FSDP over both axes (all-gathered per step)."""
    m = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = m * dp
    n = param_count(cfg)
    d = cfg.d_model
    total = 0.0
    if shape.kind == "train" and layout == "dp":
        toks_dev = shape.tokens / chips
        if cfg.moe is not None and m > 1:
            # dispatch + combine a2a of per-device routed tokens
            a2a = toks_dev * cfg.moe.top_k * d * BF16
            total += 2 * cfg.num_layers * a2a * (m - 1) / m
        # experts stay EP-sharded over model (only FSDP'd over data);
        # the DENSE part must be fully gathered per device per step.
        n_exp = 0
        if cfg.moe is not None:
            mo = cfg.moe
            s_slots = mo.num_experts + mo.spare_slots
            n_exp = cfg.num_layers * s_slots * 3 * d * mo.expert_d_ff
        n_dense = n - n_exp
        total += (2 * n_dense * BF16 + n_dense * F32) * (chips - 1) / chips
        if n_exp:
            total += (2 * n_exp * BF16 / m + n_exp * F32 / m) * (dp - 1) / dp
        return total
    if shape.kind == "train":
        toks_dev = shape.tokens / dp            # batch sharded over dp
        # TP: 2 activation all-reduces per layer of [toks_dev, d] bf16
        if m > 1:
            ar = toks_dev * d * BF16
            total += cfg.num_layers * 2 * 2 * ar * (m - 1) / m
        if fsdp and dp > 1:
            shard = n * BF16 / m                # per model-column params
            # all-gather fwd + bwd, reduce-scatter grads (fp32)
            total += (2 * shard + n * F32 / m) * (dp - 1) / dp
        elif dp > 1:
            total += 2 * n * F32 / m * (dp - 1) / dp   # plain DP all-reduce
        if cfg.moe is not None and m > 1:
            # dispatch + combine all-to-alls of k-way routed tokens
            a2a = toks_dev * cfg.moe.top_k * d * BF16
            total += 2 * a2a * (m - 1) / m
    else:
        b_eff = shape.global_batch if shape.kind == "decode" else shape.tokens
        per_dev = max(1.0, b_eff / dp)
        if m > 1:
            ar = per_dev * d * BF16
            total += cfg.num_layers * 2 * 2 * ar * (m - 1) / m
            total += per_dev * cfg.vocab * F32 / m * (m - 1) / m  # logits
        if cfg.moe is not None and m > 1:
            a2a = per_dev * cfg.moe.top_k * d * BF16
            total += 2 * a2a * (m - 1) / m
        if shape.global_batch < dp and shape.kind == "decode":
            # sequence-sharded cache: partial-softmax combine per layer
            total += cfg.num_layers * 2 * cfg.n_heads * 3 * F32 * (dp - 1) / dp
    return total
