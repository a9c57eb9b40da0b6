"""Architecture and shape configuration dataclasses.

Every assigned architecture is expressed as an ``ArchConfig``; heterogeneous
layer stacks (gemma3 local:global, zamba2 mamba+shared-attn) are expressed via
``layer_pattern`` — a tuple of block-type names, one per layer.  Block types:

  "attn"        full-attention decoder block (causal)
  "local"       sliding-window attention decoder block (window = cfg.window)
  "moe"         attention + MoE-FFN decoder block
  "rwkv"        RWKV6 block (time-mix + channel-mix)
  "mamba"       Mamba2 block
  "shared_attn" attention+MLP block whose weights are SHARED across all its
                occurrences (zamba2)
  "enc"         bidirectional encoder block (whisper)
  "dec"         decoder block with cross-attention (whisper)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    # Reshape integration: spare physical expert slots available as helpers.
    spare_slots: int = 2
    # max replicas a single (hot) logical expert may be split across (SBR).
    max_replicas: int = 4
    # route via the fused gating kernel (softmax + top-k + load histogram
    # in one pass): the CUDA kernel on the card, its plain torch version for
    # tensors on the CPU.
    fused_gating: bool = False
    # dispatch/combine via the fused MoE dispatch kernel family (in-segment
    # rank + capacity mask + bucketed scatter in one kernel, weighted-gather
    # combine); the CUDA kernels on the card, their plain torch versions on
    # the CPU.  Drop decisions and Reshape load metrics are bit-identical to
    # the argsort/searchsorted/scatter path.
    fused_dispatch: bool = False


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One serve traffic class in the weighted-FRT objective.

    ``weight`` scales the class's claim on first-response time: the engine
    scores each candidate tick as FRT divided by the summed weight of the
    requests the tick advances, so a weight-4 class wins the arbitration
    against a weight-1 class whenever their raw FRTs are within 4x of each
    other.  ``max_defer`` is the class's aging bound — the maximum number of
    scheduled ticks an *admitted* prefill of this class may sit out before
    the engine is forced to run its prefill, whatever the weighted scores
    say.  Starvation of a low-weight class is therefore bounded by
    construction (regression-tested in the reference's
    tests/test_serve_priority.py)."""
    name: str = "default"
    weight: float = 1.0
    max_defer: int = 4


@dataclasses.dataclass(frozen=True)
class ServeCfg:
    """Serve-side engine knobs (ServeEngine).

    Speculative in-tick decoding: a per-slot n-gram suffix-hash table (living
    in the donated slot pool, no host round-trip) proposes up to ``spec_len``
    tokens per decode tick; the target model verifies them in the same
    chunk-scan dispatch and an in-jit acceptance mask commits the longest
    accepted prefix, so greedy outputs stay bit-identical to plain decode.
    Whether a tick runs the speculative or the plain arm is an *engine*
    decision made from the measured per-pool acceptance-rate EMA
    (``Engine.choose_serve_tick``).

    Priority classes: requests carry a ``priority`` naming one entry of
    ``classes``; the engine arbitrates candidate ticks across every slot
    pool under weighted FRT with per-class aging bounds (see
    :class:`PriorityClass`).  The default single-entry table reproduces the
    pre-priority scheduler exactly."""
    # max tokens proposed+verified per speculative tick (the verify-scan
    # length); <= 1 disables the speculative arm entirely.
    spec_len: int = 4
    # suffix-hash table entries per slot (power of two).  Collisions only
    # produce bad drafts — they cost acceptance, never correctness.
    spec_table: int = 512
    # n-gram context length (tokens hashed to index the table).
    spec_ctx: int = 2
    # truncated self-draft depth: ServeEngine(draft="self") builds the draft
    # proposer from the serve model's own first ``draft_layers`` blocks plus
    # the shared embedding/head (no extra weights to ship).  An independent
    # small draft is passed explicitly via draft_cfg/draft_params instead.
    draft_layers: int = 2
    # priority traffic classes, in declaration order; the FIRST entry is the
    # default class for requests submitted without an explicit priority.
    classes: Tuple[PriorityClass, ...] = (PriorityClass(),)

    # Cross-request prefix cache (ServeEngine(prefix_cache=True)): a radix
    # tree over committed token prefixes whose nodes snapshot donated-pool
    # slot rows, so a joining request that shares a cached prefix seeds its
    # cache state instead of re-prefilling, plus an exact-hit result cache
    # over finished greedy outputs.  Whether a match is used is a measured
    # engine decision (Engine.choose_prefix_admission), not a heuristic.
    # max live prefix snapshots (LRU-evicted beyond this; pinned and
    # in-flight-referenced snapshots are not evictable).
    prefix_cache_nodes: int = 128
    # shortest prefix worth snapshotting/seeding: below this the row copy
    # costs more than the prefill it would save.
    prefix_min_len: int = 4
    # exact-hit result-cache entries (0 disables the result cache).
    result_cache_entries: int = 256
    # also snapshot a request's full committed path (prompt + generated)
    # into the tree when it completes ("commit extends the tree").  Default
    # off: the per-evict row copy only pays off on agent-loop workloads
    # where one response is the next request's prompt prefix.
    snapshot_on_evict: bool = False
    # workload analyzer: a prefix seen >= pin_count times inside the
    # sliding history window is pinned against eviction.
    prefix_pin_count: int = 3
    prefix_history: int = 512
    # on a hot weight publish (ServeEngine.update(params=...) or a bare
    # params_version bump) drop prefix snapshots captured under any other
    # version: they can never match again (longest_match filters by
    # version), so keeping them is pure memory waste.  False keeps them —
    # only useful for workloads that flip back and forth between versions.
    flush_prefix_on_publish: bool = True

    # Device placement (ServeEngine(placements={pool: mesh})): each slot
    # pool may own a real device group; params are replicated (or
    # tensor-parallel at pool_tp > 1) on the pool's mesh and the donated
    # pool state lives there too, so pools on disjoint devices decode
    # concurrently.  tp=1 is the bit-identicality-preserving default — a
    # split matmul reduction reorders float adds.
    pool_tp: int = 1
    # co-dispatch decode ticks for OTHER placed pools in the same
    # scheduling round (async dispatch overlaps them on disjoint devices).
    # Inert without placements; the arbitration winner is unchanged.
    parallel_ticks: bool = True
    # max in-flight slots migrated per pool per drain step: bounds the
    # per-tick migration stall a live drain_pool() injects.
    migrate_batch: int = 4


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state_size: int = 64
    head_dim: int = 64
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ()   # () -> ("attn",) * num_layers  (or moe)
    window: int = 1024               # sliding window for "local" blocks
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl M-RoPE (3-section rotary)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    serve: ServeCfg = dataclasses.field(default_factory=ServeCfg)
    # encoder (whisper): encoder layer count + source length of frame embeddings
    enc_layers: int = 0
    enc_seq: int = 1500
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # activation recompute policy: chosen by the Maestro materialization pass,
    # overridable per-launch.  One of: "none", "full", "dots".
    remat: str = "full"
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern:
            assert len(self.layer_pattern) == self.num_layers, self.name
            return self.layer_pattern
        if self.moe is not None:
            return ("moe",) * self.num_layers
        return ("attn",) * self.num_layers

    def n_params(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        from repro_torch.analysis.flops import param_count
        return param_count(self)

    def n_active_params(self) -> int:
        from repro_torch.analysis.flops import param_count
        return param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"
    # number of gradient-accumulation microbatches for train shapes
    microbatches: int = 1

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k":    ShapeCfg("train_4k", 4096, 256, "train", microbatches=8),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeCfg("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, layers: int = 2, d_model: int = 64,
            vocab: int = 512) -> ArchConfig:
    """A smoke-test-sized config of the same family (pattern preserved)."""
    scale = d_model / cfg.d_model
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(n_heads, cfg.n_kv_heads))
    # preserve the pattern *shape*: keep one occurrence of each block type and
    # the first `layers` entries of the pattern cycle.
    pat = cfg.pattern
    types_seen = []
    small_pat = []
    for t in pat:
        small_pat.append(t)
        if t not in types_seen:
            types_seen.append(t)
        if len(small_pat) >= layers and set(types_seen) == set(pat):
            break
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                  expert_d_ff=4 * d_model, spare_slots=2)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_size=16, head_dim=16, chunk=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=len(small_pat),
        layer_pattern=tuple(small_pat),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=4 * d_model,
        vocab=vocab,
        moe=moe,
        ssm=ssm,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 16),
        window=min(cfg.window, 8),
    )
