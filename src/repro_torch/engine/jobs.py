"""Jobs: the unit the engine schedules, expressed as Maestro regions.

Everything the runtime does — a train step on either control path, a serve
prefill chunk, a decode batch, a checkpoint — is described as a small
region-structured workflow (paper Ch.4) whose operator costs come from the
engine's :class:`~repro.core.estimator.CostBook` (measured online, not
modeled).  The engine then applies the result-aware objectives from
``core.scheduler`` to the workflow:

* ``first_response_time`` — time to the first tuple out of the sink
  (first microbatch metrics for training, first emitted token for serving);
* ``completion_time`` — time to drain every region.

The objectives split by who is waiting: **training decisions minimize
completion time** (nobody reads anything until the whole step lands), while
**serving decisions minimize first-response time** (a user is waiting on the
first token) — weighted by priority class in the multi-pool case.  The
decisions made this way today:

* **train step path** (fused vs granulated): the granulated workflow puts
  every microbatch in its own region with a pipelined edge from the first
  microbatch to the control sink — its FRT is one microbatch, the Amber
  control latency.  The fused workflow is a single region — minimal
  completion time, but the control sink waits for the whole step.
* **serve tick composition** (decode-only vs prefill): prefill is a
  blocking region upstream of decode — admitting a prefill chunk delays
  the first token out of the decode region by the full prefill cost, which
  is exactly why short decode batches preempt long prefills under min-FRT.
* **multi-pool arbitration** (which slot pool ticks next): every pool
  offers its candidate ticks as :class:`TickCandidate` descriptors; the
  engine scores each candidate's ``serve_tick_workflow`` FRT — with the
  pool's *own* measured per-token EMA as the cost term — divided by the
  summed priority-class weight of the requests the tick advances, subject
  to the per-class aging bound (no admitted prefill sits out more than its
  class's ``max_defer`` scheduled ticks).

Invariants the reference's differential harness
(tests/test_serve_differential.py) enforces on everything scheduled from
here: greedy serve outputs are **bit-identical** to the static
``generate_static`` oracle under *every* tick ordering these decisions can
produce (scheduling reorders work, never
changes results — per-slot state is isolated and joins are reset-masked
in-jit), across compact × speculative × multi-pool × priority sweeps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.regions import Op, Workflow


@dataclasses.dataclass(frozen=True)
class Job:
    """One schedulable unit of runtime work.

    ``kind`` doubles as the CostBook key, so every job the engine runs
    refines the cost model used to schedule the next one."""
    kind: str                 # train_step_fused | train_step_granulated |
    #                           serve_prefill | serve_decode |
    #                           serve_spec_decode | serve_seed | checkpoint
    tokens: int = 0           # data-plane size (tokens processed)
    meta: Optional[dict] = None


# ------------------------------------------------------------------ training

def train_step_workflow(path: str, n_mb: int, t_mb: float,
                        t_apply: float) -> Workflow:
    """The training step as a region workflow.

    granulated: mb_0 -> mb_1 -> ... -> apply with *blocking* edges (each
    microbatch is its own region; region boundaries are the Amber control
    points) and a pipelined edge mb_0 -> control (the first metrics/poll
    response leaves after one microbatch).
    fused: one region {step} -> control; nothing escapes until the whole
    scanned step completes.
    """
    wf = Workflow()
    if path == "fused":
        wf.add_op(Op("step", "ml", cost_per_tuple=n_mb * t_mb + t_apply,
                     source_cardinality=1.0))
        wf.add_op(Op("control", "sink", cost_per_tuple=0.0))
        wf.add_edge("step", "control")
        return wf
    assert path == "granulated", path
    for i in range(n_mb):
        wf.add_op(Op(f"mb_{i}", "ml", cost_per_tuple=t_mb,
                     source_cardinality=1.0 if i == 0 else 0.0))
    wf.add_op(Op("apply", "ml", cost_per_tuple=t_apply))
    wf.add_op(Op("control", "sink", cost_per_tuple=0.0))
    for i in range(n_mb - 1):
        wf.add_edge(f"mb_{i}", f"mb_{i + 1}", blocking=True)
    wf.add_edge(f"mb_{n_mb - 1}", "apply", blocking=True)
    wf.add_edge("mb_0", "control")
    return wf


# ------------------------------------------------- MoE dispatch kernel choice

def dispatch_kind(impl: str, tokens: int) -> str:
    """CostBook key for a step executed with one MoE dispatch impl.  Keyed
    per token count so the choice is made *per shape*: the fused kernel's
    advantage depends on T*k (the rank/scatter pipeline is linear in it,
    the argsort is not), so one global EMA would wash shapes together."""
    return f"moe_dispatch_{impl}:t{tokens}"


def moe_dispatch_workflow(impl: str, tokens: int, t_total: float) -> Workflow:
    """The MoE dispatch/combine primitive as a region workflow.

    ``xla`` is the argsort pipeline: rank (sort+searchsorted), bucketed
    scatter, the per-slot expert matmuls, and the gather/combine each run
    as their own launch, so each is its own blocking region.  ``fused``
    collapses rank+mask+scatter into one kernel region and the weighted
    gather into another.  Region costs split the *measured* total for the
    impl (the CostBook EMA), so scoring the two candidates under
    ``completion_time`` — exactly how ``choose_step_path`` scores step
    workflows — picks the cheaper kernel for this shape on this machine.
    """
    if impl == "fused":
        stages = (("dispatch_kernel", 0.3), ("experts", 0.4),
                  ("combine_kernel", 0.3))
    else:
        stages = (("rank_sort", 0.2), ("scatter", 0.2), ("experts", 0.4),
                  ("gather_combine", 0.2))
    wf = Workflow()
    wf.add_op(Op("tokens", "scan", cost_per_tuple=0.0,
                 source_cardinality=1.0))
    prev = "tokens"
    for name, share in stages:
        wf.add_op(Op(name, "ml", cost_per_tuple=share * t_total))
        wf.add_edge(prev, name, blocking=(prev != "tokens"))
        prev = name
    wf.add_op(Op("out", "sink", cost_per_tuple=0.0))
    wf.add_edge(prev, "out")
    return wf


# ------------------------------------------------------------------- serving

def serve_tick_workflow(decode_slots: int, decode_chunk: int,
                        prefill_tokens: int, t_token: float,
                        t_dispatch: float = 0.0) -> Workflow:
    """One serve tick as a region workflow.

    ``prefill_tokens = 0`` models a decode-only tick: the decode region is
    the sink's region and only pays its pipeline fill (one chunk of
    ``decode_chunk`` positions).  With pending prefill work the prefill op
    sits behind a *blocking* edge into decode — the whole prefill chunk is
    paid before the first token streams out.  first_response_time on these
    two candidates is the admission/composition decision.
    """
    wf = Workflow()
    wf.add_op(Op("requests", "scan", cost_per_tuple=0.0,
                 source_cardinality=float(max(decode_slots, 1))))
    wf.add_op(Op("decode", "ml",
                 cost_per_tuple=t_token * decode_chunk + t_dispatch))
    wf.add_op(Op("stream_out", "sink", cost_per_tuple=0.0))
    wf.add_edge("requests", "decode")
    wf.add_edge("decode", "stream_out")
    if prefill_tokens > 0:
        wf.add_op(Op("pending", "scan", cost_per_tuple=0.0,
                     source_cardinality=float(prefill_tokens)))
        wf.add_op(Op("prefill", "ml", cost_per_tuple=t_token))
        wf.add_edge("pending", "prefill")
        wf.add_edge("prefill", "decode", blocking=True)
    return wf


def pool_kind(kind: str, pool_id: int) -> str:
    """CostBook key for a serve tick kind on one slot pool.  Tick jobs are
    recorded under BOTH the global kind and this pool-scoped kind: the
    global EMA bootstraps pools that have not run yet, the per-pool EMA is
    what the multi-pool arbitration scores — it is the parallelism term of
    the weighted-FRT objective (a pool on faster hardware shows a lower
    measured per-token time and wins more ticks)."""
    return f"{kind}:p{pool_id}"


@dataclasses.dataclass
class TickCandidate:
    """One schedulable tick a slot pool offers the engine this round.

    The serving engine builds one candidate per (pool, composition) pair
    that has work — a decode candidate when any slot holds a pending
    sampled token, a prefill candidate when any slot still consumes prompt
    — and ``Engine.choose_serve_job`` arbitrates across all of them.
    ``weight`` is the summed priority-class weight of the requests whose
    first response the candidate advances; ``aged`` marks a candidate
    containing a request past its class's ``max_defer`` bound, which
    removes every non-aged candidate from consideration."""
    pool_id: int
    mode: str                  # "decode" | "prefill"
    n_dec: int = 0             # decode-state participants in the pool
    n_pre: int = 0             # prefilling participants in the pool
    pre_toks: int = 0          # pending prompt tokens behind the tick
    chunk: int = 1             # tick length this candidate would run
    weight: float = 1.0        # summed class weight of advanced requests
    aged: bool = False         # a participant hit its class aging bound
    overdue: int = 0           # ticks past the tightest violated bound
    spec_len: int = 0          # >1: the speculative arm is offered
    arms: tuple = ()           # proposer arms offered ("ngram", "draft", ...)
    # placement terms (0.0 without ServeEngine placements, which reduces
    # the arbitration score to exactly the historical weighted FRT):
    load: float = 0.0          # busy fraction of the pool's device group
    xfer: float = 0.0          # pending migration cost (s) headed at the
    #                            pool — priced from the serve_migrate EMA


def accept_kind(pool_id: int, arm: str = "ngram") -> str:
    """CostBook key for a slot pool's speculative-decode acceptance-rate
    EMA, per proposer arm.  Keyed per pool because pools serve different
    traffic (acceptance is a property of the *workload* flowing through a
    pool, not of the machine) and per arm because proposers fail
    differently — the n-gram table collapses on non-repetitive text where
    a distilled draft model keeps agreeing."""
    return f"serve_accept:{arm}:p{pool_id}"


def spec_kind(arm: str) -> str:
    """CostBook key for the speculative tick run with one proposer arm.
    Per-arm runtimes differ structurally — the draft arm pays the draft
    model's propose scan and per-step cache threading inside the same
    dispatch — so each arm carries its own EMA; the unsuffixed
    ``serve_spec_decode`` aggregate is still recorded as the bootstrap
    fallback for tick-composition pricing."""
    return f"serve_spec_decode:{arm}"


def layout_kind(compact: bool, pool_id: int) -> str:
    """CostBook key for a decode tick's batch layout on one pool: compact
    (participants gathered into a power-of-two batch before the vmap) vs
    full (all slots run, sat-out lanes burn FLOPs).  Recorded only on ticks
    where compaction was *eligible* (>= half the pool sitting out), so the
    two EMAs compare the same occupancy regime and
    ``Engine.choose_compact`` can flip the layout from measurement."""
    return f"serve_tick_{'compact' if compact else 'full'}:p{pool_id}"


def knob_kind(name: str, value) -> str:
    """CostBook key for one (engine knob, arm value) pair — the autotune
    meta-decision's measurement substrate.  Each arm of a tuned knob
    (``spec_len=4``, ``prefill_chunk=16``, ...) accumulates its own
    windowed cost-per-token EMA while it is the live setting, so
    ``Engine.choose_knob`` scores knob values the same way every other
    Maestro decision scores its arms: from measured behavior, not
    assumption.  The value is embedded in the key verbatim (knob values
    are small ints/floats), so distinct arms can never alias."""
    return f"autotune:{name}={value}"


def serve_decode_workflow(arm: str, decode_slots: int, chunk: int,
                          t_token: float, accept: float = 0.0) -> Workflow:
    """One decode-composition tick as a region workflow, per arm.

    ``plain``: the decode op runs ``chunk`` scan steps, each sampling (and
    therefore committing) one token per slot — its selectivity is ``chunk``,
    so the sink's cardinality is exactly the committed-token count.

    ``spec``: one workflow shape for the whole proposer family — the draft
    op produces the chain (n-gram table lookup or draft-model decode; either
    way its cost rides inside the measured verify dispatch, which is why the
    engine prices each arm with its own ``spec_kind(arm)`` runtime EMA and
    ``accept_kind(pool_id, arm)`` acceptance EMA), the verify op pays the
    full ``chunk`` scan steps (selectivity ``chunk``: every verified
    position is a candidate token), and the commit op keeps only the
    accepted prefix:
    its *selectivity* is ``(1 + accept·(chunk-1)) / chunk``, so the sink's
    cardinality is the expected committed-token count.  Region time is paid
    on the verify op regardless of acceptance — exactly the speculative
    gamble.  The engine scores both arms under ``completion_time``
    normalized by expected commits (``Engine._choose_decode_arm``)."""
    wf = Workflow()
    wf.add_op(Op("requests", "scan", cost_per_tuple=0.0,
                 source_cardinality=float(max(decode_slots, 1))))
    if arm == "plain":
        wf.add_op(Op("decode", "ml", cost_per_tuple=t_token * chunk,
                     selectivity=float(chunk)))
        wf.add_op(Op("stream_out", "sink", cost_per_tuple=0.0))
        wf.add_edge("requests", "decode")
        wf.add_edge("decode", "stream_out")
        return wf
    assert arm.startswith("spec"), arm
    committed = 1.0 + accept * max(chunk - 1, 0)
    wf.add_op(Op("draft", "ml", cost_per_tuple=0.0))
    wf.add_op(Op("verify", "ml", cost_per_tuple=t_token * chunk,
                 selectivity=float(chunk)))
    wf.add_op(Op("commit", "ml", cost_per_tuple=0.0,
                 selectivity=committed / max(chunk, 1)))
    wf.add_op(Op("stream_out", "sink", cost_per_tuple=0.0))
    wf.add_edge("requests", "draft")
    wf.add_edge("draft", "verify")
    wf.add_edge("verify", "commit")
    wf.add_edge("commit", "stream_out")
    return wf


def prefill_workflow(prompt_tokens: int, t_token: float) -> Workflow:
    """Admission by recomputation: prefill the WHOLE prompt from token 0.
    The prefill region sits behind a blocking edge into decode — every
    prompt token is paid before the first response token can stream out,
    so the workflow's FRT is ``prompt_tokens * t_token`` plus the decode
    pipeline fill.  This is the baseline ``Engine.choose_prefix_admission``
    prices the cached alternative against."""
    wf = Workflow()
    wf.add_op(Op("prompt", "scan", cost_per_tuple=0.0,
                 source_cardinality=float(max(prompt_tokens, 1))))
    wf.add_op(Op("prefill", "ml", cost_per_tuple=t_token))
    wf.add_op(Op("decode", "ml", cost_per_tuple=t_token))
    wf.add_op(Op("stream_out", "sink", cost_per_tuple=0.0))
    wf.add_edge("prompt", "prefill")
    wf.add_edge("prefill", "decode", blocking=True)
    wf.add_edge("decode", "stream_out")
    return wf


def prefix_seed_workflow(cached_tokens: int, suffix_tokens: int,
                        t_seed: float, t_token: float) -> Workflow:
    """Admission by reuse: copy a cached prefix snapshot into the joining
    slot (one batched row write — ``t_seed``, a *constant* cost set by the
    cache-row size, not by how many tokens the snapshot encodes), then
    prefill only the unshared suffix.  The seed-copy region is the
    materialized intermediate state being read back — Whiz's reuse edge as
    a region — and blocks the suffix prefill exactly as prefill blocks
    decode.  FRT therefore compares ``t_seed + suffix·t_token`` against
    recomputation's ``(cached+suffix)·t_token``: reuse wins whenever the
    copy is cheaper than recomputing the cached tokens, which is the
    result-aware decision in one inequality."""
    wf = Workflow()
    wf.add_op(Op("snapshot", "scan", cost_per_tuple=t_seed,
                 source_cardinality=1.0))
    wf.add_op(Op("seed_copy", "ml", cost_per_tuple=0.0,
                 selectivity=float(max(suffix_tokens, 1))))
    wf.add_op(Op("prefill_suffix", "ml", cost_per_tuple=t_token))
    wf.add_op(Op("decode", "ml", cost_per_tuple=t_token))
    wf.add_op(Op("stream_out", "sink", cost_per_tuple=0.0))
    wf.add_edge("snapshot", "seed_copy")
    wf.add_edge("seed_copy", "prefill_suffix", blocking=True)
    wf.add_edge("prefill_suffix", "decode", blocking=True)
    wf.add_edge("decode", "stream_out")
    return wf


def checkpoint_workflow(t_save: float) -> Workflow:
    """Legacy blocking checkpoint: snapshot AND persist as one blocking
    region between steps (the §2.6 barrier paid in full).  Kept as the
    measured baseline the async split is benchmarked against
    (``LoopConfig(ckpt_async=False)``)."""
    wf = Workflow()
    wf.add_op(Op("snapshot", "ml", cost_per_tuple=t_save,
                 source_cardinality=1.0))
    wf.add_op(Op("durable", "sink", cost_per_tuple=0.0))
    wf.add_edge("snapshot", "durable", blocking=True)
    return wf


def snapshot_workflow(t_snap: float) -> Workflow:
    """The blocking half of the async checkpoint: one device→host copy —
    a single device sync, no I/O.  The blocking edge into the barrier sink
    is the only stall the training loop pays per checkpoint; everything
    downstream of the captured host payload rides ``persist_workflow``."""
    wf = Workflow()
    wf.add_op(Op("snapshot", "ml", cost_per_tuple=t_snap,
                 source_cardinality=1.0))
    wf.add_op(Op("barrier", "sink", cost_per_tuple=0.0))
    wf.add_edge("snapshot", "barrier", blocking=True)
    return wf


def persist_workflow(t_persist: float) -> Workflow:
    """The pipelined half: host→disk serialization + fsync + atomic
    publish + manifest ack, on the checkpointer's worker thread.  The
    PIPELINED edge into the durable sink is the point of the split — the
    persist region overlaps the next train step's regions, and the engine
    prices the overlap from the measured ``ckpt_persist`` EMA (observed
    from the worker thread at completion).  The durable-log barrier rides
    the ack at the end of the region: recovery only restores acknowledged
    checkpoints, so a crash mid-persist replays from the previous one."""
    wf = Workflow()
    wf.add_op(Op("persist", "ml", cost_per_tuple=t_persist,
                 source_cardinality=1.0))
    wf.add_op(Op("durable", "sink", cost_per_tuple=0.0))
    wf.add_edge("persist", "durable")
    return wf


COST_DEFAULTS: Dict[str, float] = {
    # bootstrap priors (seconds) used until the CostBook has measurements;
    # relative order is what matters: fused step < granulated step,
    # decode tick < prefill chunk.
    "train_step_fused": 0.05,
    "train_step_granulated": 0.10,
    "serve_decode": 0.01,
    "serve_spec_decode": 0.01,
    # per-proposer-arm verify-tick priors: the draft arm carries the draft
    # model's propose/threading cost, so its prior sits slightly above the
    # table-lookup arm's
    "serve_spec_decode:ngram": 0.01,
    "serve_spec_decode:draft": 0.012,
    "serve_prefill": 0.05,
    # one batched cache-row copy (prefix-cache seeding); cheaper than a
    # prefill chunk by construction — the bootstrap must favor exploring
    # the seed arm so its real cost gets measured
    "serve_seed": 0.002,
    # one batched cross-pool slot migration (gather + device_put + scatter);
    # prior sits above the same-device seed write — it pays a transfer
    "serve_migrate": 0.004,
    "checkpoint": 0.50,
    # async checkpoint split: the snapshot region (one device→host sync)
    # is an order cheaper than the persist region (serialize+fsync), which
    # is why persisting on the worker thread removes most of the stall
    "ckpt_snapshot": 0.05,
    "ckpt_persist": 0.45,
}
