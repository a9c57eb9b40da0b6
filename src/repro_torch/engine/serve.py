"""ServeEngine: continuous batching under the Amber control plane, over
one or several slot pools arbitrated across priority classes, with compact
decode, speculative decoding, a cross-request prefix and result cache, hot
weight updates and a closed-loop knob autotuner.

Serving runs as engine jobs over a fixed pool of *slots*, each slot holding
one request's cache rows at its own sequence position.  A **tick** advances
every participating slot by ``L`` positions, one batched
``lm.decode_step`` over all slots per position:

* a *prefill* slot consumes up to ``L`` prompt tokens (chunked batched
  prefill);
* a *decode* slot feeds its pending sampled token and keeps sampling on the
  device, emitting up to ``L`` new tokens per tick;
* a slot whose prompt ends mid-tick turns from prefill to decode inside the
  same tick.

Between ticks the engine polls the controller mailbox, so Pause / Inspect /
Update land at tick granularity and Inspect keeps answering while paused.
Tick *composition* (decode-only vs prefill, and plain vs speculative
decode) is the Maestro choice ``Engine.choose_serve_tick`` over the
candidate region workflows (``jobs.serve_tick_workflow``), costed from
measured tick times and acceptance rates.

**Speculative decoding** (``spec_decode=True``): a *proposer*
(:class:`Proposer`) drafts up to ``spec_len`` tokens per decode tick and
the target verifies the chain one ``decode_step`` per token, with a
``valid`` mask that freezes a row at its first mismatch, so greedy outputs
equal plain decode by construction: an accepted draft IS the token greedy
decode would have fed.  Two proposers:

* ``ngram`` — a per-slot n-gram suffix-hash table (``ng``) and its context
  window (``ctx``), int32 tensors in the slot pool that every tick learns
  from each token it feeds (prompt and generated alike, on every arm);
* ``draft`` — a second, smaller parameter set (a truncated *self*-draft
  sliced from the serve model, or an independent ``draft_cfg`` +
  ``draft_params``, ``engine.draft``) whose cache rows live in the pool and
  which every step of every arm advances by the token the target consumes,
  so its state is always the committed stream.  Its propose steps run on
  scratch copies of those rows; a wrong, stale or hot-swapped draft can
  only lower acceptance, never change outputs.

The speculative arms are host-gated to all-greedy participants: verifying a
sampled continuation greedily would change its distribution.

**Prefix cache + result cache** (``prefix_cache=True``): at prefill tick
boundaries a still-prefilling slot's pool row — every cache leaf, its
n-gram table and window, its draft rows, at the frozen position — is
snapshotted (to host tensors) into a radix tree keyed by the consumed
prefix (``engine.prefix_cache``); a joining greedy request that shares a
cached prefix *seeds* its slot from the snapshot with one batched in-place
row write and prefills only the unshared suffix, and an exact repeat of a
finished greedy request is answered from the result cache without taking a
slot.  Whether a match is used is ``Engine.choose_prefix_admission``.
Seeded state equals recomputation: the tick consumes tokens one
``decode_step`` at a time, so the state after P tokens does not depend on
chunking or on which slot ran them.

**Hot updates** (``update(...)``, applied at the next tick boundary):
knobs, the speculative switches, the prefix cache toggle, a draft
republish, and the weight publish ``update(params=..., params_version=...)``
(``TrainLoop(publish_to=engine)`` calls it).  ``params_version`` keys the
result cache and the snapshots: a request that joined under an older
version stores neither.

The reference vmaps a batch-1 ``decode_step`` over its slots; here the
batch dimension is written out: ``lm.decode_step`` takes one position per
row and ``moe_groups="row"``, so every slot is its own MoE group (T=1,
``capacity(cfg, 1)``, hashed from its own position) exactly as under the
vmap, and inactive rows leave their cache rows and positions untouched.

On the card the tick's step — the n-gram learn, the draft's feed and the
target's ``decode_step`` — runs as one CUDA graph (``GraphedStep``),
captured on a pool's first tick at each height and replayed once per
step; the draft's propose step is a second graph over the scratch rows.
A CPU pool runs the same steps eagerly.

Invariants (tests/test_torch_serve.py, test_torch_spec.py,
test_torch_prefix_cache.py, test_torch_draft.py,
test_torch_serve_priority.py, test_torch_compact.py,
test_torch_serve_differential.py):

* **Greedy bit-identicality** — greedy outputs equal the static
  ``BatchedServer.generate_static`` oracle token for token on batches where
  neither grouping drops an assignment, under every arm and with prefix
  seeding.  Scheduling reorders work; it must never change results.
* **Reset-mask join** — a request joins a slot by flagging the row for
  zeroing at the start of the next tick instead of eager per-join writes;
  no stale cache, n-gram, draft or position state leaks between occupants
  of a slot, in any pool, and a slot that sits out a compact tick keeps
  its pending flag.

**Several pools and priority classes** (``pools=``, ``class_pools=``):
every pool is a :class:`SlotPool` of its own, and a request carries a
``priority`` naming one of ``cfg.serve.classes``.  With one pool and the
single default class a tick is ``Engine.choose_serve_tick`` as above;
otherwise every pool with work offers its candidate ticks
(``jobs.TickCandidate``) and ``Engine.choose_serve_job`` picks one (pool,
composition) by weighted first-result time: the candidate's FRT, costed
from the pool's own measured per-token EMA, over the summed class weight
of the requests it advances.  An admitted prefill that has sat out its
class's ``max_defer`` scheduled ticks ages its pool's prefill candidate,
which then wins whatever the weights say.  ``class_pools`` restricts the
pools a class may join; ``submit(pool=)`` pins one.

**Compact decode** (``compact_decode=None|True|False``): a decode tick
whose participants fit in ``int(slots * compact_frac)`` rows may gather
them (padded with idle rows to a power of two) into a persistent buffer
set of that height, run the tick there and write the rows back in place;
``None`` lets ``Engine.choose_compact`` pick compact or full per tick from
the measured ``jobs.layout_kind`` EMAs.  Pad rows run inactive, so their
rows and positions come back as they went.

**Knob autotuner** (``autotune=True`` or a dict of ``AutoTuner``
arguments, ``engine.autotune``): ``spec_len``, ``compact_frac``,
``prefill_chunk`` and the class weights become windowed Maestro decisions,
applied at tick boundaries through the same handlers as ``update``.

**Elastic pools and live slot migration** (``add_pool()``,
``drain_pool(lid)``): a pool can join under load (its graphs captured on
first use, marked cold) and a pool can drain away.  A draining pool admits
nothing; at the top of every tick one batch of at most
``cfg.serve.migrate_batch`` of its in-flight slots moves to the pool
``Engine.choose_migration_dst`` picks — every row leaf, the position, the
pending reset flag and the sampling generator, copied in place into the
destination's tensors, so no graph's tensor is replaced — and an empty
draining pool is retired with its graphs and compact buffer sets.  A
slot's row, position and generator determine its continuation, so greedy
outputs are unchanged by any migration, and no request drops.  While a
drain routes into a pool, that pool's candidates carry the pending
batches times the measured ``serve_migrate`` time (the ``xfer`` term).
Pools are addressed by their stable ``lid`` (``_pool``), never by list
position; ``pool_id`` offsets the pools' cost-kind ids
(``pool_id..pool_id+pools-1``) so that several engines can share one
``Engine``.

**Device-placed pools** (``placements={lid: placement}``,
``add_pool(placement=...)``): a pool may own a device group, a device,
its name or a sequence of them, made a pool mesh at ``serve.pool_tp``
(``runtime.sharding.pool_mesh``).  Its rows lie on the group as
``runtime.sharding.pool_shards`` says: split over ``data`` where it
divides the slots (each shard's rows and its tick on its own row of the
group; a tick enqueues every shard before it makes its one host copy),
else whole on the group's first row; at ``pool_tp`` > 1 a pool's rows
split by heads and its step is ``models.tp``'s tensor-parallel step,
whose ``model`` devices may be distinct cards (on the card a
``StagedStep``: a graph per TP shard and stage on the shard's card, the
copies between them outside).  A group may name one card several times:
every split and every shard's step runs there, one after the other, in
the sequence of calls that distinct cards run.  A placed pool reads the weights
through ``_params_for``: one copy per device group of its rows, made by
``serving_params`` (which keeps a tensor already on the device, so a pool
placed on the engine's own card reads the engine's tensors) or, at
``pool_tp`` > 1, ``tp.split_params``, and dropped with the graphs on
every publish.  Each device has its own ``SlotTick`` (graphed on a card,
eager on the CPU) and graph memory pool.  Placement feeds the decisions:
with placements a candidate carries the ``load`` term (the occupied share
of the other pools on its devices, ``_group_busy``), admission over
several pools is ``Engine.choose_admission_pool``, and the drain's
options carry the device count.  With ``serve.parallel_ticks`` the
round's winner is joined by plain ticks of the other placed pools whose
device groups are disjoint from it and from each other
(``_group_plans``): every tick is enqueued before any is awaited (a
tick's dispatch ends on the device, its commit makes its one host copy),
and each pool's time runs from the round's start.  A migration moves
each row leaf between any two layouts, one copy a piece where the device
differs, and carries a sampled request's generator state into a
generator of the destination shard's device.  A placement on another
device type than the engine's raises.  Without placements every pool
sits on the engine's device and every decision is the one the engine
makes without them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import messages as M
from repro_torch.engine.autotune import AutoTuner
from repro_torch.engine.draft import slice_draft_params, truncated_draft_cfg
from repro_torch.engine.engine import Engine
from repro_torch.engine.jobs import (COST_DEFAULTS, Job, TickCandidate,
                                     layout_kind, pool_kind, spec_kind)
from repro_torch.engine.prefix_cache import (PrefixAnalyzer, PrefixCache,
                                             to_host)
from repro_torch.kernels import LAUNCHES, credit_launches, launches_since
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models import tp as tp_lib
from repro_torch.runtime import sharding as SH
from repro_torch.runtime import tracing
from repro_torch.runtime.serve import serving_params

# xxhash/murmur-style odd multipliers, one per n-gram context position (the
# reference's, so that the tables are bit-identical)
_NG_MULTS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)


def ng_hash(ctx, table: int):
    """Table index of each context window ``ctx`` [..., n_ctx] (int32
    tokens): the reference's uint32 hash — multiply by a per-position odd
    constant, XOR, keep ``table - 1``'s bits — in int64.  The products of
    tokens under 2**31 fit in int64, and the low 32 bits of a product, of a
    XOR and of a mask do not depend on the bits above them, so masking only
    once, with ``table - 1`` (a power of two), keeps the reference's bits."""
    c = ctx.long()
    h = c[..., 0] * _NG_MULTS[0]
    for i in range(1, ctx.shape[-1]):
        h = h ^ (c[..., i] * _NG_MULTS[i])
    return h & (table - 1)


def ng_push(ctx, tok):
    """The window ``ctx`` [B, n_ctx] with ``tok`` [B] (of ``ctx``'s dtype)
    shifted in."""
    return torch.cat([ctx[:, 1:], tok[:, None]], dim=1)


def ng_learn(ng, ctx, tok, active) -> None:
    """In place, on the rows ``active`` [B] selects: write ``tok`` into the
    table ``ng`` [B, T] under the hash of the row's window, then push it
    into the window ``ctx``."""
    tok = tok.to(ng.dtype)
    idx = ng_hash(ctx, ng.shape[1])[:, None]
    ng.scatter_(1, idx, torch.where(active, tok, ng.gather(1, idx)[:, 0])
                [:, None])
    ctx.copy_(torch.where(active[:, None], ng_push(ctx, tok), ctx))


def sample_rows(logits, greedy, temps: np.ndarray, gens: List[Any]):
    """logits [B,V] and their argmax ``greedy`` [B] (ties to the lowest
    index); per-row temperature (host) and generator.  Greedy rows keep
    the argmax; a row with temperature > 0 draws from its own generator,
    so its stream does not depend on which other requests share the tick.
    Returns a new tensor: ``greedy`` may be a graph's static output."""
    out = greedy.clone()
    for r in np.flatnonzero(temps > 0):
        probs = torch.softmax(logits[r] / float(temps[r]), dim=-1)
        out[r] = torch.multinomial(probs, 1, generator=gens[r])[0]
    return out


def _plan(cfg: ArchConfig, device):
    n_moe = lm.n_moe_layers(cfg)
    return moe_lib.identity_plan(cfg, n_moe, device=device) if n_moe \
        else None


def build_decode_step(cfg: ArchConfig, device,
                      draft_cfg: Optional[ArchConfig] = None):
    """The step a tick runs once per position, over every slot of ``pool``
    (a :class:`SlotPool`): the n-gram learn, the draft's feed (with a
    draft) and the target's ``lm.decode_step``, each slot its own MoE group
    (``moe_groups="row"``), then the greedy argmax.  It updates the pool's
    tensors in place — the draft reads ``pos`` before the target's advanced
    positions are copied back into it — so a CUDA graph can capture it over
    them.  The MoE routing plans are built once, here: ``decode_step``
    would build one on every call.

    A pool whose rows split by heads over a group of ``tp`` > 1 devices
    (``SlotPool.tp``) runs the tensor-parallel step ``models.tp``'s, with
    ``params`` its shards' weights (``tp.split_params``), as the program
    of stages ``stages`` (a ``tp.Stages``; by default the eager one): the
    n-gram learn and the draft join shard 0's first stage, the positions'
    write-back and the argmax its last.  The draft runs unsplit on the
    group's first device."""
    plan = _plan(cfg, device)
    dplan = _plan(draft_cfg, device) if draft_cfg is not None else None

    def step(params, dparams, pool, tok, active, stages=None):
        """tok [B] int64, active [B] bool -> (logits [B,V] f32, argmax
        [B])."""
        rt = None
        if pool.tp > 1:
            rt = tp_lib.Stages(pool.group) if stages is None else stages
            rt.at(0)
        try:
            ng_learn(pool.ng, pool.ctx, tok, active)
            if draft_cfg is not None:
                lm.decode_step(dparams, {"caches": pool.draft,
                                         "pos": pool.pos},
                               tok[:, None], draft_cfg, plan=dplan,
                               moe_groups="row", active=active)
            state = {"caches": pool.caches, "pos": pool.pos}
            if rt is not None:
                logits, st = tp_lib.decode_step(
                    params, state, tok[:, None], cfg, pool.group, plan=plan,
                    moe_groups="row", active=active, stages=rt)
            else:
                logits, st = lm.decode_step(params, state, tok[:, None], cfg,
                                            plan=plan, moe_groups="row",
                                            active=active)
            pool.pos.copy_(st["pos"])
            return logits, torch.argmax(logits, dim=-1)
        finally:
            if rt is not None and stages is None:
                rt.end()

    return step


def build_propose_step(draft_cfg: ArchConfig, device):
    """The draft's propose step: one greedy ``decode_step`` of the draft
    over the pool's scratch rows (``pool.scratch``, copies of its draft
    rows and positions), which it advances in place."""
    dplan = _plan(draft_cfg, device)

    def step(dparams, pool, tok, active):
        sc = pool.scratch
        logits, st = lm.decode_step(dparams, sc, tok[:, None], draft_cfg,
                                    plan=dplan, moe_groups="row",
                                    active=active)
        sc["pos"].copy_(st["pos"])
        return logits, torch.argmax(logits, dim=-1)

    return step


class GraphedStep:
    """A ``step(*state, tok, active)`` captured once in a CUDA graph over
    ``state`` (weights and a :class:`SlotPool`, last) with static token and
    active inputs ``[B]``.  A call writes them, replays the graph and
    returns its static logits ``[B,V]`` and argmax ``[B]``, which the next
    call overwrites.

    The graph holds the addresses of every tensor in ``state``, so none may
    be replaced after capture: the pool writes its rows in place, and a
    weight publish drops the graph for a new capture
    (``SlotTick.release``).  A failed capture raises; there is no eager
    fallback on the card.  The kernel wrappers count their launches on the
    host, where a replay runs no wrapper: the capture records one step's
    counts and every replay credits them (``kernels.credit_launches``).

    A graph belongs to one pool's tensors at one height: ``SlotTick`` keys
    its graphs by (pool, step name, rows), and a compact tick runs on the
    pool's persistent buffer set of that height
    (``SlotPool.compact_rows``), so no tensor a graph holds is ever
    replaced.  ``mempool`` (a ``torch.cuda.graph_pool_handle()``) lets the
    graphs of every pool and height share one memory pool: they never run
    concurrently, and a tick consumes a replay's outputs before the next
    replay of any graph."""

    def __init__(self, step, *state, mempool=None):
        pool = state[-1]
        dev = pool.pos.device
        b = pool.pos.shape[0]
        self.rows = b
        self.state = state
        self.tok = torch.zeros((b,), dtype=torch.long, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        # one eager step first, on a side stream as capture wants (kernel
        # libraries loaded, cuBLAS workspaces and the gating scratch made);
        # every row is inactive, so no pool row or position moves
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(*state, self.tok, self.active)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(LAUNCHES)
        # the captured graph is kept beside its executable, so that its
        # nodes can be read (``kernel_nodes``)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, pool=mempool):
            self.logits, self.greedy = step(*state, self.tok, self.active)
        self.graph.instantiate()
        self.per_replay = launches_since(before)
        LAUNCHES.update(before)              # the capture launched nothing
        self.replays = 0

    def kernel_nodes(self):
        """The kernel name of each kernel node of the captured step: what
        every replay launches on the device (``kernels.graphs``)."""
        from repro_torch.kernels.graphs import graph_nodes
        return [name for kind, name in graph_nodes(self.graph)
                if kind == "kernel"]

    def bound_to(self, *state) -> bool:
        return len(state) == len(self.state) and \
            all(a is b for a, b in zip(state, self.state))

    def __call__(self, tok, active):
        self.tok.copy_(tok)
        self.active.copy_(active)
        self.graph.replay()
        credit_launches(self.per_replay)
        self.replays += 1
        return self.logits, self.greedy


@dataclasses.dataclass
class StageGraph:
    """One (TP shard, stage) of a ``StagedStep``: its CUDA graph on the
    shard's device, the kernel launches one replay makes (recorded at
    capture) and its replays."""
    shard: int
    stage: int
    device: torch.device
    graph: Any
    per_replay: Dict[str, int]
    replays: int = 0


class _StageCapture(tp_lib.Stages):
    """``tp.Stages`` that captures each (shard, stage) in a CUDA graph of
    its own: ``at(j)`` ends the open capture and begins one on shard
    ``j``'s device, on that device's capture stream and into its graph
    memory pool; an exchange ends the open capture and allocates the
    destination's staging tensor (outside every graph and every capture),
    recording the copy that a replay makes.  ``ops`` is the step's replay
    order: ``StageGraph``s and (staging tensor, source) copies."""

    def __init__(self, devices, mempools, streams):
        super().__init__(devices)
        self.mempools, self.streams = mempools, streams
        self.ops: List[Any] = []
        self.count = [0] * len(self.devices)
        self._open = None

    def at(self, j: int) -> None:
        if self._open is not None and self._open[0] == j:
            return
        self._close()
        dev = self.devices[j]
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(dev))
        ctx.enter_context(torch.cuda.stream(self.streams[dev]))
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(LAUNCHES)
        try:
            graph.capture_begin(pool=self.mempools[dev])
        except BaseException:
            ctx.close()
            raise
        self._open = (j, graph, ctx, before)

    def _close(self) -> None:
        if self._open is None:
            return
        j, graph, ctx, before = self._open
        self._open = None
        try:
            graph.capture_end()
        finally:
            ctx.close()
        graph.instantiate()
        per = launches_since(before)
        LAUNCHES.update(before)              # the capture launched nothing
        self.ops.append(StageGraph(j, self.count[j], self.devices[j], graph,
                                   per))
        self.count[j] += 1

    def to(self, x, src: int, dst: int):
        self._close()
        if src == dst:
            return x
        staged = torch.empty(x.shape, dtype=x.dtype,
                             device=self.devices[dst])
        self.ops.append((staged, x))
        return staged

    def end(self) -> None:
        self._close()


class StagedStep:
    """A tensor-parallel pool's ``step`` (``build_decode_step`` over a
    pool of ``tp`` > 1, ``models.tp``'s program of stages) captured as one
    CUDA graph per (TP shard, stage), each on its shard's device, with the
    exchanges' copies between them outside every graph: the form that
    runs a pool whose shards sit on distinct cards, and the one every TP
    pool runs, a card named twice included, so that one card runs the
    sequence of calls that two cards run.  Called as ``GraphedStep`` is:
    it writes the static token and active inputs, replays ``ops`` in
    order and returns the last stage's static logits and argmax.

    Capture: one eager step first with every row inactive (no pool row or
    position moves), on a side stream of each of the group's devices
    (kernel libraries loaded, cuBLAS workspaces and the gating scratch
    made); then the step once more under ``_StageCapture``.  Each shard's
    stages capture on that side stream of its device, under
    ``torch.cuda.device(its device)``, into ``mempools[its device]``;
    every staging tensor is allocated then, once, and never replaced (the
    graphs hold their addresses; ``SlotTick.release`` drops them with the
    graphs).  A failed capture raises; there is no fallback.

    Replay: each stage graph under ``torch.cuda.device(its device)``, so
    that it launches on that device's current stream, and each copy as
    ``staging.copy_(source)``, which orders itself after both devices'
    current streams (torch's cross-device copy), so a copy never reads a
    stage's output before the stage has written it, nor overwrites a
    staging tensor a stage still reads.  Each stage graph credits its own
    per-replay launches (``kernels.credit_launches``) and counts its
    replays; ``per_replay`` is their sum over a step, as a
    ``GraphedStep``'s is."""

    def __init__(self, step, *state, mempools):
        pool = state[-1]
        devs = list(pool.group)
        dev = devs[0]
        b = pool.pos.shape[0]
        self.rows = b
        self.state = state
        self.tok = torch.zeros((b,), dtype=torch.long, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        sides = {d: torch.cuda.Stream(d) for d in dict.fromkeys(devs)}
        for d, side in sides.items():
            side.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as ctx:
            for side in sides.values():
                ctx.enter_context(torch.cuda.stream(side))
            warm = tp_lib.Stages(devs)
            try:
                step(*state, self.tok, self.active, stages=warm)
            finally:
                warm.end()
        for d, side in sides.items():
            torch.cuda.current_stream(d).wait_stream(side)
            torch.cuda.synchronize(d)
        cap = _StageCapture(devs, mempools, sides)
        try:
            self.logits, self.greedy = step(*state, self.tok, self.active,
                                            stages=cap)
        finally:
            cap.end()
        self.ops = cap.ops
        self.stages = [op for op in self.ops if isinstance(op, StageGraph)]
        self.copies = len(self.ops) - len(self.stages)
        self.replays = 0

    @property
    def per_replay(self) -> Dict[str, int]:
        out = dict.fromkeys(LAUNCHES, 0)
        for g in self.stages:
            for k, n in g.per_replay.items():
                out[k] += n
        return out

    def stage_counts(self) -> Dict[int, int]:
        """The number of stage graphs of each TP shard."""
        out: Dict[int, int] = {}
        for g in self.stages:
            out[g.shard] = out.get(g.shard, 0) + 1
        return out

    def kernel_nodes(self):
        """The kernel name of each kernel node of every stage graph, in
        replay order: what a step launches on the devices."""
        from repro_torch.kernels.graphs import graph_nodes
        return [name for g in self.stages
                for kind, name in graph_nodes(g.graph) if kind == "kernel"]

    def bound_to(self, *state) -> bool:
        return len(state) == len(self.state) and \
            all(a is b for a, b in zip(state, self.state))

    def __call__(self, tok, active):
        self.tok.copy_(tok)
        self.active.copy_(active)
        for op in self.ops:
            if isinstance(op, StageGraph):
                with torch.cuda.device(op.device):
                    op.graph.replay()
                credit_launches(op.per_replay)
                op.replays += 1
            else:
                op[0].copy_(op[1])
        self.replays += 1
        return self.logits, self.greedy


class Proposer:
    """One speculative-proposer arm: the source of the draft chain the
    target verifies.  ``propose(tick, pool, dparams, first, active, L)``
    returns ``[B, L]`` device tokens, ``first`` (each row's pending
    committed token) then ``L-1`` proposals, and changes **no persistent
    pool state**: the verify re-feeds every token through the pool under
    the valid mask, so a proposer can only affect *acceptance*."""

    name: str = ""

    @staticmethod
    def propose(tick, pool, dparams, first, active, L):
        raise NotImplementedError


class NgramProposer(Proposer):
    """Successor lookups from the slot's n-gram suffix table, on a copy of
    its window."""

    name = "ngram"

    @staticmethod
    def propose(tick, pool, dparams, first, active, L):
        win, tok, chain = pool.ctx, first.to(pool.ctx.dtype), [first]
        for _ in range(L - 1):
            win = ng_push(win, tok)
            tok = pool.ng.gather(1, ng_hash(win, pool.ng.shape[1])[:, None]
                                 )[:, 0]
            chain.append(tok.long())
        return torch.stack(chain, 1)


class DraftProposer(Proposer):
    """Greedy decode of the draft model, ``L-1`` steps ahead of the
    committed stream, from scratch copies of the slot's draft rows and
    position: the overshoot a partly rejected chain leaves behind is
    dropped with them, and the verify advances the persistent rows by
    exactly the committed tokens instead."""

    name = "draft"

    @staticmethod
    def propose(tick, pool, dparams, first, active, L):
        for leaves, src in zip(pool.scratch["caches"].values(),
                               pool.draft.values()):
            for k, c in leaves.items():
                c.copy_(src[k])
        pool.scratch["pos"].copy_(pool.pos)
        run = tick.runner("propose", dparams, pool)
        tok, chain = first, [first]
        for _ in range(L - 1):
            _, greedy = run(tok, active)
            tok = greedy.clone()
            chain.append(tok)
        return torch.stack(chain, 1)


PROPOSERS = {p.name: p for p in (NgramProposer, DraftProposer)}


class SlotTick:
    """A tick: ``L`` batched steps over every slot of a pool.

    Per slot: tokens ``[L]``, ``n_given`` (how many are prompt/pending
    tokens — the rest are sampled on the device), active mask, reset flag,
    temperature and generator.  Emits the ``[slots, L]`` tokens and
    ``n_valid``, the count each row committed: position ``j``'s emission is
    the model's continuation after consuming token ``j``.  Inactive rows
    run (the batch is rectangular) but their pool rows and positions stay
    untouched.  A reset row's pool state and position are zeroed first,
    whether or not it takes part in this tick.

    ``arm`` (``"ngram"`` or ``"draft"``: decode-only, greedy rows) runs the
    speculative tick: the proposer's chain is verified one step per token
    with ``active & valid`` as the step's row mask, and ``valid`` turns
    off at each row's first mismatch, all on the device; ``n_valid`` is
    each row's count of valid steps.  Otherwise every active row commits
    ``L``.

    With ``graph`` (a pool on the card) each step runs as a
    ``GraphedStep``, captured on its first use over each (pool, height):
    a pool's full rows, each shard of a split pool and each compact buffer
    set are separate states.  A tensor-parallel pool's target step runs as
    a ``StagedStep``: a graph per (TP shard, stage), each on its shard's
    device, the copies between them outside, whether the shards sit on
    distinct cards or on one card named twice.  Each device the tick
    captures on has one graph memory pool, which its graphs share.  The
    reset zeroing, the token
    select and the valid mask between steps, sampling and the tick's one
    host copy stay outside the graph.  Without it (a CPU pool) the same
    steps run eagerly.  ``record``, when a list, receives each step's
    logits.  ``dispatch`` enqueues a tick and returns its tokens on the
    device, ``collect`` makes its one host copy; a call does both."""

    def __init__(self, cfg: ArchConfig, device, graph: bool,
                 draft_cfg: Optional[ArchConfig] = None):
        self.steps = {"step": build_decode_step(cfg, device, draft_cfg)}
        if draft_cfg is not None:
            self.steps["propose"] = build_propose_step(draft_cfg, device)
        self.graph = graph
        # (pool lid, step name, rows[, data shard]) -> its graph, or a TP
        # pool's StagedStep (its stage graphs: ``stage_graphs``)
        self.graphs: Dict[tuple, Any] = {}
        self.captures = 0
        self.record: Optional[list] = None
        self._mempools: Dict[torch.device, Any] = {}

    @staticmethod
    def key(pool, name: str) -> tuple:
        """A graph's key: (pool lid, step name, rows), and for a shard of a
        split pool its index (-1 for the split pool's compact buffer
        sets), so that two shards on one card never share a graph."""
        if pool.shard is None:
            return (pool.lid, name, pool.slots)
        return (pool.lid, name, pool.slots, pool.shard)

    def stage_graphs(self) -> Dict[tuple, StageGraph]:
        """Every stage graph of the tick's TP steps, keyed by (pool lid,
        step name, rows, data shard, TP shard, stage): the data shard is
        the split pool's shard index, -1 for its compact buffer sets and
        None for a pool that is not split, so that no two shards on one
        card share a graph."""
        out = {}
        for key, g in self.graphs.items():
            if isinstance(g, StagedStep):
                base = key if len(key) == 4 else key + (None,)
                for st in g.stages:
                    out[base + (st.shard, st.stage)] = st
        return out

    def _mempool(self, dev) -> Any:
        """The graph memory pool of device ``dev``: one a device, shared by
        every graph this tick captures there (they never run concurrently,
        and a tick consumes a replay's outputs before the next replay)."""
        got = self._mempools.get(dev)
        if got is None:
            got = self._mempools[dev] = torch.cuda.graph_pool_handle()
        return got

    @property
    def graphed(self) -> Optional[GraphedStep]:
        """The target step graph at full height of the first live pool that
        has one (a retired pool's graphs are dropped, ``drop_pool``); None
        before any capture."""
        steps = [(k[0], g) for k, g in self.graphs.items()
                 if k[1] == "step"]
        if not steps:
            return None
        first = min(lid for lid, _ in steps)
        return max((g for lid, g in steps if lid == first),
                   key=lambda g: g.rows)

    def capture_pending(self, pool, arm: str = "") -> bool:
        need = ("step", "propose") if arm == "draft" else ("step",)
        return self.graph and any(
            self.key(pool, n) not in self.graphs for n in need)

    def release(self) -> None:
        """Drop every graph of every pool and height: the next tick
        captures again (a weight or draft publish rebinds the weights the
        graphs hold).  The memory pools and a TP step's staging tensors go
        with them."""
        self.graphs.clear()
        self._mempools.clear()

    def drop_pool(self, lid: int) -> None:
        """Drop every graph of pool ``lid``, full and compact heights: a
        retired pool's tensors must not stay alive through the graphs that
        hold their addresses."""
        for key in [k for k in self.graphs if k[0] == lid]:
            del self.graphs[key]

    def runner(self, name: str, *state):
        """``fn(tok, active) -> (logits, argmax)`` of step ``name`` over
        ``state`` (its last element the pool the tick runs on): its graph
        on the card (captured on first use), the step itself on the CPU."""
        step = self.steps[name]
        if not self.graph:
            return lambda tok, active: step(*state, tok, active)
        pool = state[-1]
        key = self.key(pool, name)
        g = self.graphs.get(key)
        if g is None:
            with tracing.span("serve.capture", pool=pool.lid, step=name,
                              rows=pool.slots):
                if name == "step" and pool.tp > 1:
                    g = StagedStep(step, *state, mempools={
                        d: self._mempool(d) for d in pool.group})
                else:
                    g = GraphedStep(step, *state,
                                    mempool=self._mempool(pool.pos.device))
            self.graphs[key] = g
            self.captures += 1
        elif not g.bound_to(*state):
            raise ValueError(f"the tick's {key} graph was captured over "
                             "other weights or another pool")
        return g

    def __call__(self, pool, params, dparams, toks, n_given, active, reset,
                 temps, gens, arm: str = ""):
        return (pool.pos,) + self.collect(*self.dispatch(
            pool, params, dparams, toks, n_given, active, reset, temps, gens,
            arm))

    @staticmethod
    def collect(out, n_valid):
        """A dispatched tick's one host copy: ``(emitted [B, L], n_valid
        [B])`` as numpy."""
        host = out.cpu().numpy()
        if n_valid is None:
            return host[:, :-1], host[:, -1]
        return host, n_valid

    @torch.no_grad()
    def dispatch(self, pool, params, dparams, toks, n_given, active, reset,
                 temps, gens, arm: str = ""):
        """Enqueue a tick on the pool's device without waiting for it:
        returns ``(out, n_valid)``, ``out`` the emitted tokens ``[B, L]``
        on the device and ``n_valid`` on the host, or under an arm ``out``
        ``[B, L+1]``, its last column each row's valid count, and
        ``n_valid`` None."""
        dev = pool.pos.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return self._dispatch(dev, pool, params, dparams, toks, n_given,
                                  active, reset, temps, gens, arm)

    def _dispatch(self, dev, pool, params, dparams, toks, n_given, active,
                  reset, temps, gens, arm):
        if reset.any():
            pool.zero_rows(np.flatnonzero(reset))
        toks = torch.as_tensor(toks, device=dev)
        active_t = torch.as_tensor(active, device=dev)
        run = self.runner("step", params, dparams, pool)
        L = toks.shape[1]
        if arm:
            chain = PROPOSERS[arm].propose(self, pool, dparams, toks[:, 0],
                                           active_t, L)
            valid = active_t
            n_valid = torch.zeros_like(toks[:, 0])
            emitted = []
            for j in range(L):
                logits, greedy = run(chain[:, j], valid)
                if self.record is not None:
                    self.record.append(logits.clone())
                emitted.append(greedy.clone())
                n_valid += valid
                if j + 1 < L:
                    valid = valid & (chain[:, j + 1] == greedy)
            return torch.stack(emitted + [n_valid], 1), None
        n_given_t = torch.as_tensor(n_given, device=dev)
        prev = toks[:, 0]
        emitted = []
        for j in range(L):
            logits, greedy = run(torch.where(j < n_given_t, toks[:, j], prev),
                                 active_t)
            if self.record is not None:
                self.record.append(logits.clone())
            prev = sample_rows(logits, greedy, temps, gens)
            emitted.append(prev)
        return torch.stack(emitted, 1), np.where(active, L, 0)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # [plen] int32
    max_new: int
    temperature: float = 0.0
    seed: int = 0                        # private sampling stream
    priority: str = "default"            # one of cfg.serve.classes
    pin_pool: Optional[int] = None       # admission restricted to this pool
    joined_version: int = 0              # params_version at admission: a
    #                                      request straddling a weight swap
    #                                      stores neither results nor
    #                                      snapshots
    tokens: List[int] = dataclasses.field(default_factory=list)
    pool: int = -1                       # slot pool joined (-1: queued)
    slot: int = -1                       # slot within the pool
    prompt_off: int = 0
    pending_tok: int = -1                # emitted but not yet fed back
    seed_node: Any = None                # prefix-cache node this slot seeded
    #                                      from (ref held until eviction)
    # aging: scheduled ticks this admitted prefill has sat out since it
    # last advanced, and the peak (the starvation bound's witness)
    deferred: int = 0
    max_deferred: int = 0
    # wall-clock marks for first-token and completion latency, and one
    # (time, len(tokens), tick_no) each time the visible tokens grow (the
    # first's time is t_first)
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    marks: List[tuple] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    @property
    def prefilling(self) -> bool:
        return self.prompt_off < len(self.prompt)

    def output(self) -> np.ndarray:
        return np.asarray(self.tokens[:self.max_new], np.int32)


class SlotPool:
    """The slot pool the tick mutates: cache rows ``[n, slots, Smax, ...]``
    per block type, the n-gram tables ``ng [slots, spec_table]`` and their
    windows ``ctx [slots, spec_ctx]`` (int32), with a draft its cache rows
    (``draft``, same layout) and their scratch copies for proposing
    (``scratch``), per-slot positions (on the device, with a host copy that
    needs no device sync), the reset mask, and per-slot sampling
    generators.  Every write is in place: a CUDA graph holds the tensors'
    addresses.

    ``lid`` is the pool's stable engine-local id: requests, routing,
    ``class_pools`` and the graphs' keys address pools by it (list
    position changes as pools drain away, the lid never does).
    ``pool_id`` (``lid`` unless given) is its id in the engine's cost
    kinds (``jobs.pool_kind``, ``TickCandidate``, acceptance EMAs).
    ``draining`` stops admission to it.  ``compact_rows(n)`` is the pool's
    persistent buffer set of height ``n`` for compact ticks.

    ``mesh`` (a ``runtime.sharding.pool_mesh``) places the pool, and
    ``devices()`` is its group.  The rows lie on it as
    ``runtime.sharding.pool_shards`` says: where ``data`` > 1 divides the
    slots, the pool is *split* — ``shards`` are pools of ``slots / data``
    rows each (``shard`` their index), on their own row of the group, and
    this pool keeps only the host state (requests, generators, host
    positions, reset flags) and routes every row operation by slot to
    ``(shard, row)``; otherwise its rows are its own (``shards`` is
    ``[self]``), on the group's first row.  A pool's own rows at
    ``model`` > 1 (``group``, its devices, more than one) split with the
    heads they belong to (``models.tp.cache_pieces``) for the
    tensor-parallel step: ``caches`` is then one cache tree a shard of
    ``models.tp``; the n-gram rows, the positions and a draft's rows (the
    draft runs unsplit) sit on the group's first device.

    Row operations take host slot indices: ``zero_rows``, ``gather_into``
    and ``scatter_from`` (between a pool and its compact buffer sets, which
    have its layout), and ``move_rows``, ``snapshot`` and ``seed_rows``,
    which go through the rows' layout-free form (every leaf whole, as
    ``lm.init_cache`` makes it), so a migration or a prefix snapshot moves
    between pools of any layout."""

    def __init__(self, cfg: ArchConfig, slots: int, max_len: int, device,
                 draft_cfg: Optional[ArchConfig] = None, lid: int = 0,
                 pool_id: Optional[int] = None, mesh=None,
                 shard: Optional[int] = None, group=None):
        self.cfg, self.max_len, self.draft_cfg = cfg, max_len, draft_cfg
        self.mesh = mesh
        self.lid = lid
        self.pool_id = lid if pool_id is None else pool_id
        self.shard = shard
        self.draining = False
        self.slots = slots
        self.pos_host = np.zeros((slots,), np.int64)
        self.reset = np.zeros((slots,), bool)
        self.gens: List[Optional[torch.Generator]] = [None] * slots
        self.active: List[Optional[Request]] = [None] * slots
        self._compact: Dict[int, SlotPool] = {}
        self.shards: List[SlotPool] = [self]
        self.bounds = [(0, slots)]
        if group is None and mesh is not None:
            parts = SH.pool_shards(mesh, slots)
            if len(parts) > 1:
                self.bounds = [(lo, hi) for lo, hi, _ in parts]
                self.shards = [SlotPool(cfg, hi - lo, max_len, None,
                                        draft_cfg, lid, self.pool_id, mesh,
                                        shard=i, group=devs)
                               for i, (lo, hi, devs) in enumerate(parts)]
                self.group = parts[0][2]
                self.caches = self.pos = self.ng = self.ctx = None
                self.draft = self.scratch = None
                return
            group = parts[0][2]
        self.group = tuple(group) if group is not None else (device,)
        dev = self.group[0]
        if len(self.group) > 1:
            self.caches = tp_lib.init_cache(cfg, slots, max_len,
                                            len(self.group), self.group)
            self.pos = torch.zeros((slots,), dtype=torch.long, device=dev)
        else:
            state = lm.init_cache(cfg, slots, max_len, device=dev)
            self.caches, self.pos = state["caches"], state["pos"]
        self.ng = torch.zeros((slots, cfg.serve.spec_table),
                              dtype=torch.int32, device=dev)
        self.ctx = torch.zeros((slots, cfg.serve.spec_ctx),
                               dtype=torch.int32, device=dev)
        self.draft = self.scratch = None
        if draft_cfg is not None:
            self.draft = lm.init_cache(draft_cfg, slots, max_len,
                                       device=dev)["caches"]
            self.scratch = lm.init_cache(draft_cfg, slots, max_len,
                                         device=dev)

    def free_slots(self) -> int:
        return sum(r is None for r in self.active)

    @property
    def split(self) -> bool:
        """Whether the rows are split over ``data`` (held by ``shards``)."""
        return self.shards[0] is not self

    @property
    def tp(self) -> int:
        """The tensor-parallel degree of the pool's own rows."""
        return len(self.shards[0].group)

    @property
    def device(self) -> torch.device:
        """The device of the (first shard's) positions, n-gram rows and
        tick: where the pool's host copies and generators live."""
        return self.shards[0].pos.device

    def shard_of(self, slot: int) -> "SlotPool":
        """The pool holding slot ``slot``'s rows (this one, unless split):
        its device is where the slot's sampling generator lives."""
        for sh, (lo, hi) in zip(self.shards, self.bounds):
            if lo <= slot < hi:
                return sh
        raise IndexError(f"slot {slot} of a pool of {self.slots}")

    def devices(self) -> tuple:
        """The device group the pool's rows live on: its mesh's, or the
        one device of a pool that is not placed.  The key of parallel group
        ticks' disjointness and of the load term."""
        if self.mesh is not None:
            return self.mesh.group
        return (self.pos.device,)

    def put(self, x):
        """``x`` (a tensor, or a nested dict of them) on the pool's
        device."""
        if isinstance(x, dict):
            return {k: self.put(v) for k, v in x.items()}
        return x.to(self.device)

    def state(self) -> Dict[str, Any]:
        """The rows and positions of a pool whose rows are whole on one
        device, as a tree (``pool_specs``'s input): ``caches`` and
        ``draft`` ``[n, slots, ...]``, ``ng``, ``ctx`` and ``pos``
        ``[slots, ...]``."""
        out = {"caches": self.caches, "ng": self.ng, "ctx": self.ctx,
               "pos": self.pos}
        if self.draft is not None:
            out["draft"] = self.draft
        return out

    def compact_rows(self, rows: int) -> "SlotPool":
        """The buffer set a compact tick of ``rows`` rows runs on: a pool
        of ``rows`` slots with this pool's ids and the layout of its (first
        shard's) rows, made on first use and kept, so that the graphs
        captured over it stay bound."""
        sub = self._compact.get(rows)
        if sub is None:
            first = self.shards[0]
            with tracing.span("serve.alloc", pool=self.lid, what="rows",
                              rows=rows):
                sub = self._compact[rows] = SlotPool(
                    self.cfg, rows, self.max_len, None, self.draft_cfg,
                    lid=self.lid, pool_id=self.pool_id, mesh=self.mesh,
                    shard=-1 if self.split else None, group=first.group)
        return sub

    # ------------------------------------------------------------ row ops
    def row_leaves(self):
        """``(path, tensor, slot dim)`` of every per-slot tensor of the
        pool's own rows: the caches and draft rows have the slot at dim 1,
        the n-gram table and window at dim 0.  A cache split by heads
        lists each piece, its path ending with the piece's key and
        shard."""
        out = [(("ng",), self.ng, 0), (("ctx",), self.ctx, 0)]
        caches = self.caches if isinstance(self.caches, list) \
            else [self.caches]
        for j, tree in enumerate(caches):
            for t, leaves in tree.items():
                for k, c in leaves.items():
                    path = ("caches", t, k) if len(caches) == 1 \
                        else ("caches", t, k, j)
                    out.append((path, c, 1))
        for t, leaves in (self.draft or {}).items():
            for k, c in leaves.items():
                out.append((("draft", t, k), c, 1))
        return out

    def _canon(self):
        """``(path, slot dim, pieces)`` of every leaf of the pool's own
        rows in the layout-free form, ``pieces`` ``[(tensor, dim, lo,
        hi)]``: the piece holds the leaf's ``[lo, hi)`` along ``dim``, or
        all of it (``dim`` None)."""
        if not isinstance(self.caches, list):
            return [(p, d, [(c, None, 0, 0)])
                    for p, c, d in self.row_leaves()]
        out = [(("ng",), 0, [(self.ng, None, 0, 0)]),
               (("ctx",), 0, [(self.ctx, None, 0, 0)])]
        for (t, k), pieces in tp_lib.cache_pieces(self.cfg,
                                                  self.tp).items():
            out.append((("caches", t, k), 1,
                        [(self.caches[j][t][key], dim, lo, hi)
                         for j, key, dim, lo, hi in pieces]))
        for t, leaves in (self.draft or {}).items():
            for k, c in leaves.items():
                out.append((("draft", t, k), 1, [(c, None, 0, 0)]))
        return out

    def _routes(self, slots):
        """``[(shard pool, its rows, positions in slots)]`` of host slot
        indices ``slots``; an index tensor (on the device) goes as it is
        to a pool that is not split, so that a row copy can be captured
        in a CUDA graph."""
        if isinstance(slots, torch.Tensor):
            if not self.split:
                return [(self, slots, None)]
            slots = slots.tolist()
        slots = [int(s) for s in slots]
        if not self.split:
            return [(self, slots, list(range(len(slots))))]
        out = []
        for sh, (lo, hi) in zip(self.shards, self.bounds):
            at = [i for i, s in enumerate(slots) if lo <= s < hi]
            if at:
                out.append((sh, [slots[i] - lo for i in at], at))
        return out

    @staticmethod
    def _index(rows, device, memo=None):
        """``rows`` as an index tensor on ``device``, made once a device
        where ``memo`` (a dict) is given."""
        if isinstance(rows, torch.Tensor):
            return rows.to(device)
        if memo is None:
            return torch.as_tensor(rows, dtype=torch.long, device=device)
        got = memo.get(device)
        if got is None:
            got = memo[device] = torch.as_tensor(rows, dtype=torch.long,
                                                 device=device)
        return got

    def zero_rows(self, slots) -> None:
        """Zero the rows and positions of host slot indices ``slots``, in
        place."""
        for sh, rows, _ in self._routes(slots):
            memo = {}
            for _, c, dim in sh.row_leaves():
                c.index_fill_(dim, self._index(rows, c.device, memo), 0)
            sh.pos.index_fill_(0, self._index(rows, sh.pos.device, memo), 0)

    def gather_into(self, sub: "SlotPool", slots) -> None:
        """Copy slots ``slots`` (host indices) of every per-slot tensor and
        their positions into rows ``0..len(slots)-1`` of ``sub`` (a pool of
        this pool's row layout: a compact buffer set), in place."""
        for sh, rows, at in self._routes(slots):
            at = range(len(rows)) if at is None else at
            whole, src, dst = list(at) == list(range(sub.slots)), {}, {}
            for (_, c, dim), (_, cc, _) in zip(
                    sh.row_leaves() + [(None, sh.pos, 0)],
                    sub.row_leaves() + [(None, sub.pos, 0)]):
                v = c.index_select(dim, self._index(rows, c.device, src)) \
                    .to(cc.device)
                if whole:
                    cc.copy_(v)
                else:
                    cc.index_copy_(dim, self._index(list(at), cc.device,
                                                    dst), v)

    def scatter_from(self, sub: "SlotPool", slots) -> None:
        """Write ``sub``'s rows ``0..len(slots)-1`` back into slots
        ``slots``, in place."""
        for sh, rows, at in self._routes(slots):
            at = range(len(rows)) if at is None else at
            whole, src, dst = list(at) == list(range(sub.slots)), {}, {}
            for (_, c, dim), (_, cc, _) in zip(
                    sh.row_leaves() + [(None, sh.pos, 0)],
                    sub.row_leaves() + [(None, sub.pos, 0)]):
                v = cc if whole else cc.index_select(
                    dim, self._index(list(at), cc.device, src))
                c.index_copy_(dim, self._index(rows, c.device, dst),
                              v.to(c.device))

    def read_rows(self, slots, pos: bool = False) -> Dict[tuple, Any]:
        """Slots ``slots``' rows in the layout-free form, ``{path:
        [.., len(slots), ..]}`` on the pool's device (with ``pos`` their
        positions under ``("pos",)``)."""
        routes = self._routes(slots)
        parts = []
        for sh, rows, _ in routes:
            got, memo = {}, {}
            for path, dim, pieces in sh._canon():
                vals = [t.index_select(dim, self._index(rows, t.device, memo))
                        .to(self.device) for t, _, _, _ in pieces]
                got[path] = vals[0] if len(vals) == 1 else \
                    torch.cat(vals, pieces[0][1])
            if pos:
                got[("pos",)] = sh.pos.index_select(
                    0, self._index(rows, sh.pos.device, memo)).to(self.device)
            parts.append(got)
        if len(parts) == 1:
            return parts[0]
        order = [i for _, _, at in routes for i in at]
        back = self._index(np.argsort(order), self.device)
        dims = {p: d for p, d, _ in self.shards[0]._canon()}
        dims[("pos",)] = 0
        return {p: torch.cat([g[p] for g in parts], dims[p])
                .index_select(dims[p], back) for p in parts[0]}

    def write_rows(self, slots, vals: Dict[tuple, Any]) -> None:
        """Write ``vals`` (``read_rows``' form, rows in the order of
        ``slots``) into slots ``slots``, in place, with one copy to each
        piece's device where it is another."""
        dims = {p: d for p, d, _ in self.shards[0]._canon()}
        dims[("pos",)] = 0
        for sh, rows, at in self._routes(slots):
            src, dst = {}, {}

            def mine(p):
                v = vals[p]
                if self.split:
                    v = v.index_select(dims[p],
                                       self._index(at, v.device, src))
                return v

            for path, dim, pieces in sh._canon():
                if path not in vals:
                    continue
                v = mine(path)
                for t, fdim, lo, hi in pieces:
                    part = v if fdim is None else v.narrow(fdim, lo, hi - lo)
                    t.index_copy_(dim, self._index(rows, t.device, dst),
                                  part.to(t.device))
            if ("pos",) in vals:
                sh.pos.index_copy_(0, self._index(rows, sh.pos.device, dst),
                                   mine(("pos",)).to(sh.pos.device))

    def move_rows(self, dst: "SlotPool", src_slots, dst_slots) -> None:
        """Copy slots ``src_slots`` of every per-slot leaf and their
        positions into slots ``dst_slots`` of ``dst`` (host indices; any
        two layouts): one ``index_select`` a piece, one copy to ``dst``'s
        device where it is another, and one in-place ``index_copy_`` a
        piece, so none of ``dst``'s tensors is replaced."""
        dst.write_rows(dst_slots, self.read_rows(src_slots, pos=True))

    def snapshot(self, slot: int) -> Dict[str, Any]:
        """Slot ``slot``'s whole row as host tensors, nested as
        ``{"caches": {type: {leaf}}, "ng", "ctx"[, "draft"]}``."""
        row: Dict[str, Any] = {}
        dims = {p: d for p, d, _ in self.shards[0]._canon()}
        for path, v in self.read_rows([slot]).items():
            node = row
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = v.select(dims[path], 0)
        return to_host(row)

    def seed_rows(self, slots: List[int], rows: List[Dict[str, Any]],
                  pos: List[int]) -> None:
        """Write snapshot ``rows`` into ``slots`` and set their positions,
        one batched in-place copy per piece.  Writing the whole row
        subsumes the reset zeroing: a seeded slot starts from the snapshot
        state as a reset slot starts from zeros."""
        vals = {}
        for path, dim, _ in self.shards[0]._canon():
            leaf = []
            for r in rows:
                for key in path:
                    r = r[key]
                leaf.append(r)
            vals[path] = self.put(torch.stack(leaf, dim))
        vals[("pos",)] = torch.as_tensor(pos, device=self.device)
        self.write_rows(slots, vals)


@dataclasses.dataclass
class _TickPlan:
    """One planned tick: its pool, resolved arm, length, participants, the
    rows it runs (``idx``: the compact gather, or every slot) and job
    records, plus the thunk that enqueues it on the device (``dispatch``)
    and the one that makes its host copy (``finish``: the dispatch's
    result -> ``(pos, emitted [slots, L], n_valid [slots])``).  A round of
    parallel group ticks dispatches every plan before it finishes any."""
    sp: SlotPool
    mode: str
    spec: bool
    arm: str
    L: int
    part: List[Request]
    n_given: np.ndarray
    idx: np.ndarray
    compact: bool
    job: Job
    extras: tuple
    dispatch: Any
    finish: Any


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_len: int = 128,
                 slots: int = 4, prefill_chunk: int = 16,
                 decode_chunk: int = 4, engine: Optional[Engine] = None,
                 seed: int = 0, compact_decode: Optional[bool] = None,
                 spec_decode: bool = False, pool_id: int = 0,
                 pools: int = 1, class_pools: Optional[Dict[str, tuple]] = None,
                 prefix_cache: bool = False, params_version: int = 0,
                 draft: Optional[str] = None,
                 draft_cfg: Optional[ArchConfig] = None, draft_params=None,
                 placements: Optional[Dict[int, Any]] = None,
                 autotune: Any = False, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # the engine's device with its index: a placement's key and the
        # card a placement "cuda" names
        self._home = SH.as_device(self.device)
        self.params = serving_params(params, self.device)
        self.engine = engine or Engine()
        self.max_len = max_len
        self.slots = slots
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self.seed = seed
        # pools get the cost-kind ids pool_id..pool_id+pools-1, so that the
        # per-pool EMAs of several ServeEngines sharing one Engine stay apart
        self.pool_id = pool_id
        # compact decode: None lets Engine.choose_compact pick the layout of
        # each eligible tick from measured per-pool EMAs; True/False pins it
        self.compact_decode = compact_decode
        self.compact_ticks = 0
        # hot-updatable knobs: the live speculative draft length (_tick_len
        # caps a tick by every participant's cache headroom, so a larger
        # value mid-stream only shrinks ticks that cannot host it) and the
        # compaction gate (participants <= int(slots * compact_frac))
        self.spec_len = int(cfg.serve.spec_len)
        self.compact_frac = 0.5
        self.spec_decode = spec_decode
        self.spec_ticks = 0
        self.spec_proposed = 0      # draft tokens offered for verification
        self.spec_accepted = 0      # draft tokens committed
        # per-arm speculative counters ({"ngram": {...}, "draft": {...}})
        self.spec_arms: Dict[str, Dict[str, int]] = {}
        # draft="self" slices a truncated self-draft out of the serve
        # params (cfg.serve.draft_layers blocks + shared head) and re-slices
        # it on every weight publish; an independent draft arrives as
        # draft_cfg + draft_params and is republished with draft_params
        self._self_draft = draft == "self"
        self.draft_cfg: Optional[ArchConfig] = None
        self.draft_params = None
        if draft is not None:
            if draft != "self":
                raise ValueError(f"unknown draft mode {draft!r}")
            if draft_cfg is not None or draft_params is not None:
                raise ValueError("draft='self' derives the draft from the "
                                 "serve params")
            self.draft_cfg = truncated_draft_cfg(cfg)
            self.draft_params = slice_draft_params(self.params, cfg,
                                                   self.draft_cfg)
        elif draft_cfg is not None:
            if draft_params is None:
                raise ValueError("an independent draft_cfg needs "
                                 "draft_params")
            self.draft_cfg = draft_cfg
            self.draft_params = serving_params(draft_params, self.device)
        # priority classes: name -> PriorityClass; the table's first entry
        # is the class of a request submitted without a priority
        self.classes = {c.name: c for c in cfg.serve.classes}
        self._default_class = cfg.serve.classes[0].name
        n_pools = max(int(pools), 1)
        # class -> admissible pool ids; a class not listed joins any pool
        self.class_pools = dict(class_pools or {})
        for cls, pids in self.class_pools.items():
            if cls not in self.classes:
                raise ValueError(f"class_pools names unknown class {cls!r}")
            if not pids or not all(0 <= p < n_pools for p in pids):
                raise ValueError(f"class_pools[{cls!r}]={pids}: pool ids "
                                 f"must be in [0, {n_pools})")
        # device placements: lid -> pool mesh (``_as_mesh``); a pool not
        # listed sits on the engine's device
        self.placements: Dict[int, SH.Mesh] = {}
        for i, plc in (placements or {}).items():
            if not 0 <= int(i) < n_pools:
                raise ValueError(f"placements[{i}]: no such pool "
                                 f"(pools={n_pools})")
            self.placements[int(i)] = self._as_mesh(plc)
        # placed pools' weights, one copy per device group (_params_for)
        self._pool_params: Dict[tuple, Dict[str, Any]] = {}
        # the live pools, in lid order; a drained pool drops out, so pools
        # are looked up by lid (``_pool``), never by list position
        self.pools: List[SlotPool] = [
            SlotPool(cfg, slots, max_len, self.device, self.draft_cfg, lid=i,
                     pool_id=pool_id + i, mesh=self.placements.get(i))
            for i in range(n_pools)]
        self._next_local = n_pools
        # the pool a drain last routed into (its candidates carry ``xfer``)
        self._last_mig_dst: Optional[int] = None
        self.migrated_slots = 0
        self.parallel_group_ticks = 0
        # one tick per device, the engine's made here; a placed pool on
        # another device ticks on that device's own (``_tick_for``)
        self._ticks: Dict[torch.device, SlotTick] = {
            self._home: SlotTick(cfg, self.device,
                                 graph=self.device.type == "cuda",
                                 draft_cfg=self.draft_cfg)}
        # tick shapes (pool, arm, L, rows) and row copies already run once:
        # a first run carries one-time costs (kernel library builds and
        # loads, allocator growth, a graph's capture) and must not enter
        # the cost EMAs
        self._warm: set = set()
        # ``params_version`` keys the result cache and the snapshots: a hot
        # weight swap bumps it so stale answers and states cannot serve
        sc = cfg.serve
        self.params_version = params_version
        self.prefix: Optional[PrefixCache] = PrefixCache(
            sc.prefix_cache_nodes, sc.prefix_min_len,
            sc.result_cache_entries) if prefix_cache else None
        self._analyzer = PrefixAnalyzer(sc.prefix_min_len,
                                        sc.prefix_pin_count,
                                        sc.prefix_history)
        self._n_submitted = 0
        self.queue: Deque[Request] = deque()
        self.tick_no = 0
        self.tokens_out = 0
        self._rid = itertools.count()
        self.hit_breakpoints: List[str] = []
        # the knob autotuner (engine.autotune): True wires the default knob
        # set, a dict passes AutoTuner arguments.  Built last: it reads the
        # live engine state
        self.autotuner: Optional[AutoTuner] = None
        if autotune:
            self.autotuner = AutoTuner(
                self, **(dict(autotune) if isinstance(autotune, dict)
                         else {}))

    # ------------------------------------------------------------- pools
    @property
    def pool(self) -> SlotPool:
        """The first live slot pool (the whole engine when ``pools=1``)."""
        return self.pools[0]

    @property
    def active(self) -> List[Optional[Request]]:
        """Admitted requests across every pool, slot-ordered within pools
        (a read-only view)."""
        return [r for sp in self.pools for r in sp.active]

    @property
    def single_pool(self) -> bool:
        """One pool and the single default class: ticks take
        ``Engine.choose_serve_tick``, decision for decision the engine
        without classes."""
        return len(self.pools) == 1 and len(self.classes) == 1

    def _pool(self, lid: int) -> Optional[SlotPool]:
        """The live pool of id ``lid`` (None once it has drained away)."""
        for sp in self.pools:
            if sp.lid == lid:
                return sp
        return None

    @property
    def _tick(self) -> SlotTick:
        """The engine device's tick (read-only; ``_ticks`` holds them
        all)."""
        return self._ticks[self._home]

    # ------------------------------------------------------------ placement
    def _as_mesh(self, plc) -> SH.Mesh:
        """A placement (a pool mesh, a device, its name or a sequence of
        them) as a pool mesh at ``serve.pool_tp``; a card without an index
        (``"cuda"``) is the engine's own.  A group may name several
        devices, or one device several times (a group on one card: every
        split and every shard's step runs, one after the other); the
        ``model`` devices of a ``data`` row may be distinct cards (the TP
        step's stages run each on its shard's card, ``StagedStep``).
        Every device must be of the engine's type: a sampled request's
        generator moves between pools only within one device type."""
        if isinstance(plc, SH.Mesh):
            raw = plc.group
        else:
            raw = [plc] if isinstance(plc, (str, torch.device)) else plc
        group = []
        for d in map(torch.device, raw):
            if d.type != self.device.type:
                raise ValueError(
                    f"placement on {d} for an engine on {self.device}: a "
                    "pool must sit on the engine's device type (a "
                    "request's sampling generator cannot carry its stream "
                    "between a CPU and a CUDA generator)")
            group.append(self._home if d.index is None else d)
        if isinstance(plc, SH.Mesh):
            return plc._replace(group=tuple(group))
        return SH.pool_mesh(group, self.cfg.serve.pool_tp)

    def _params_for(self, sp: SlotPool):
        """(weights, draft weights) a pool's ticks read: the engine's own
        for a pool that is not placed; for a placed pool's rows (a whole
        pool, a shard of a split one or a compact buffer set) a copy per
        device group of the rows, ``sp.group`` (``serving_params`` keeps a
        tensor already on the device, so a group on the engine's card
        reads the engine's tensors; at ``pool_tp`` > 1 each shard's slices,
        ``tp.split_params``), remade when ``update`` rebinds the weights or
        the draft.  The draft runs unsplit on the group's first device."""
        if sp.mesh is None:
            return self.params, self.draft_params
        ent = self._pool_params.setdefault(sp.group, {})
        dev = sp.group[0]
        if ent.get("src") is not self.params:
            with tracing.span("serve.alloc", pool=sp.lid, what="params"):
                ent["params"] = serving_params(self.params, dev) \
                    if len(sp.group) == 1 else tp_lib.split_params(
                        self.params, self.cfg, len(sp.group), sp.group)
            ent["src"] = self.params
        if self.draft_cfg is not None and \
                ent.get("dsrc") is not self.draft_params:
            with tracing.span("serve.alloc", pool=sp.lid, what="draft"):
                ent["draft"] = serving_params(self.draft_params, dev)
            ent["dsrc"] = self.draft_params
        return ent["params"], ent.get("draft")

    def _group_busy(self, sp: SlotPool) -> float:
        """The occupied share of the slots of the other pools that share a
        device with ``sp``: the contention its ticks meet (admission's and
        the drain's ``busy``, the candidates' ``load``).  Without
        placements every pool shares the engine's device."""
        devs = set(sp.devices())
        tot = occ = 0
        for o in self.pools:
            if o is sp or not devs & set(o.devices()):
                continue
            tot += o.slots
            occ += o.slots - o.free_slots()
        return occ / tot if tot else 0.0

    def _tick_for(self, sp: SlotPool) -> SlotTick:
        """The tick of the device of a pool's rows (a shard's, for a shard
        of a split pool), made on first use: graphed on a card, with a
        graph memory pool of its own, eager on the CPU."""
        dev = sp.device
        tick = self._ticks.get(dev)
        if tick is None:
            with tracing.span("serve.alloc", pool=sp.lid, what="tick"):
                tick = self._ticks[dev] = SlotTick(
                    self.cfg, dev, graph=dev.type == "cuda",
                    draft_cfg=self.draft_cfg)
        return tick

    def _release(self) -> None:
        """Drop every graph of every device and the placed pools' weights:
        a publish rebinds the weights they hold."""
        for tick in self._ticks.values():
            tick.release()
        self._pool_params.clear()

    # --------------------------------------------------------- elasticity
    def add_pool(self, placement=None, slots: Optional[int] = None) -> int:
        """Elastic scale-out: append a pool of ``slots`` slots (by default
        the engine's) under the next lid, admissible at once (also as
        ``submit(pool=...)``); returns its lid.  On the card its graphs are
        captured on first use, marked cold, into the shared graph memory
        pool.  Sampling generators are keyed by request (``_stream_seed``),
        not by pool, so an engine grown to N pools gives each request the
        stream an engine built with N pools gives it.  ``placement`` (as
        ``placements``' values) places the pool."""
        mesh = None if placement is None else self._as_mesh(placement)
        lid = self._next_local
        self._next_local += 1
        self.pools.append(SlotPool(self.cfg, slots or self.slots,
                                   self.max_len, self.device, self.draft_cfg,
                                   lid=lid, pool_id=self.pool_id + lid,
                                   mesh=mesh))
        if mesh is not None:
            self.placements[lid] = mesh
        return lid

    def drain_pool(self, lid: int) -> None:
        """Elastic scale-in, live: stop admitting to pool ``lid`` and move
        its in-flight slots out, one batch of at most
        ``cfg.serve.migrate_batch`` a tick (``_drain_step``), then retire
        the empty pool.  The draining pool keeps ticking its slots until
        the last one leaves, so nothing stops streaming; zero requests
        drop.  Queued requests pinned to it fall back to open routing."""
        sp = self._pool(lid)
        if sp is None:
            raise ValueError(f"no pool {lid}; pools: "
                             f"{[o.lid for o in self.pools]}")
        if not any(o is not sp and not o.draining for o in self.pools):
            raise ValueError(f"draining pool {lid} would leave no "
                             "admissible pool")
        sp.draining = True
        for req in self.queue:
            if req.pin_pool == lid:
                req.pin_pool = None

    def _drain_step(self) -> None:
        """One migration batch per draining pool, to the destination
        ``Engine.choose_migration_dst`` picks among the open pools with
        free slots; a saturated fleet defers the move (the draining pool
        keeps serving).  A draining pool left empty is retired."""
        for src in [sp for sp in self.pools if sp.draining]:
            occ = [(s, r) for s, r in enumerate(src.active) if r is not None]
            if occ:
                opts = [{"pool": o.pool_id, "free": o.free_slots(),
                         "busy": self._group_busy(o),
                         "devices": len(o.devices())}
                        for o in self.pools
                        if o is not src and not o.draining
                        and o.free_slots() > 0]
                if not opts:
                    continue
                dst = self._pool(self.engine.choose_migration_dst(opts)
                                 - self.pool_id)
                self._last_mig_dst = dst.lid
                self._migrate_slots(src, dst, occ[:min(
                    self.cfg.serve.migrate_batch, dst.free_slots())])
            if src.free_slots() == src.slots:
                self._retire(src)

    def _retire(self, sp: SlotPool) -> None:
        """Remove an empty pool with its placement, its graphs, its compact
        buffer sets and a weights copy no live pool reads."""
        self.pools.remove(sp)
        self.placements.pop(sp.lid, None)
        for tick in self._ticks.values():
            tick.drop_pool(sp.lid)
        sp._compact.clear()
        live = {sh.group for o in self.pools if o.mesh is not None
                for sh in o.shards}
        for key in [k for k in self._pool_params if k not in live]:
            del self._pool_params[key]

    def _migrate_slots(self, src: SlotPool, dst: SlotPool,
                       moves: List[tuple]) -> None:
        """Move in-flight slots ``moves`` ([(slot, request)]) from ``src``
        into free slots of ``dst``: every row leaf and the positions in
        one ``index_select`` and one in-place ``index_copy_`` a leaf
        (``SlotPool.move_rows``), then the host position, the pending reset
        flag (a never-ticked join travels as its stale row plus its flag,
        which ``dst``'s next tick zeroes), the sampling generator (the same
        object, not re-seeded) and ``Request.pool/slot``.  A slot's row,
        position and generator determine its continuation, so the outputs
        are those of an unmigrated run.  Between two devices a generator's
        state moves into a generator of the destination, so its stream goes
        on unchanged.  Measured as a ``serve_migrate``
        job (per moved position) and under ``dst``'s pool kind, which
        ``choose_migration_dst`` and the ``xfer`` term read."""
        k = len(moves)
        free = [s for s in range(dst.slots) if dst.active[s] is None]
        assert 0 < k <= len(free)
        dst_slots = free[:k]
        src_slots = [s for s, _ in moves]
        devs = {g for sp in (src, dst) for sh in sp.shards for g in sh.group}
        ntok = max(int(sum(src.pos_host[s] for s, _ in moves)), 1)
        warm = ("migrate", k)
        cold = warm not in self._warm
        self._warm.add(warm)
        job = Job("serve_migrate", tokens=ntok, meta={"cold": cold})
        pjob = Job(pool_kind("serve_migrate", dst.pool_id), tokens=ntok,
                   meta={"cold": cold})

        def thunk():
            src.move_rows(dst, src_slots, dst_slots)
            self._sync(*devs)

        self.engine.run_job(job, thunk, extra=(pjob,))
        for (s, r), d in zip(moves, dst_slots):
            gen = src.gens[s]
            to = dst.shard_of(d).device
            if gen is not None and gen.device != to:
                moved = torch.Generator(device=to)
                moved.set_state(gen.get_state())
                gen = moved
            dst.active[d], src.active[s] = r, None
            dst.gens[d], src.gens[s] = gen, None
            dst.pos_host[d], src.pos_host[s] = src.pos_host[s], 0
            dst.reset[d], src.reset[s] = bool(src.reset[s]), False
            r.pool, r.slot = dst.lid, d
        self.migrated_slots += k

    # ------------------------------------------------------------- requests
    def submit(self, prompt, max_new: int = 16, temperature: float = 0.0,
               seed: Optional[int] = None, priority: Optional[str] = None,
               pool: Optional[int] = None) -> Request:
        """Queue a request.  ``seed`` pins the request's private sampling
        stream; the default derives one from the engine seed and the
        request id.  ``priority`` names a ``cfg.serve.classes`` entry (by
        default the table's first); ``pool`` pins admission to one slot
        pool (by default class routing, then the emptiest pool)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        need = prompt.size + max_new + max(
            self.prefill_chunk, self.decode_chunk,
            self.spec_len if self.spec_decode else 0)
        if need > self.max_len:
            raise ValueError(f"prompt+max_new+chunk={need} exceeds "
                             f"max_len={self.max_len}")
        priority = priority or self._default_class
        if priority not in self.classes:
            raise ValueError(f"unknown priority {priority!r}; classes: "
                             f"{list(self.classes)}")
        if pool is not None and ((sp := self._pool(pool)) is None
                                 or sp.draining):
            raise ValueError(f"no open pool {pool}; pools: "
                             f"{[sp.lid for sp in self.pools]}")
        rid = next(self._rid)
        req = Request(rid, prompt, max_new, temperature,
                      seed=_stream_seed(self.seed, rid) if seed is None
                      else seed, priority=priority, pin_pool=pool,
                      t_submit=time.perf_counter())
        if self.prefix is not None:
            # workload analyzer: count this prompt's grid prefixes and
            # periodically pin the hottest ones against LRU eviction
            self._analyzer.record(prompt)
            self._n_submitted += 1
            if self._n_submitted % 32 == 0:
                for p in self._analyzer.hot_prefixes()[:8]:
                    self.prefix.pin(p)
        self.queue.append(req)
        return req

    def _evict(self, req: Request) -> None:
        sp = self._pool(req.pool)
        # a request that straddled a weight swap ran partly on old weights:
        # its slot state and its output belong to neither version
        fresh = req.joined_version == self.params_version
        if self.prefix is not None:
            if self.cfg.serve.snapshot_on_evict and fresh:
                # "commit extends the tree": snapshot the slot's committed
                # path (prompt + generated) for follow-ups that extend it
                path = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)]
                )[:int(sp.pos_host[req.slot])]
                if len(path) >= self.prefix.min_len and not (
                        (n := self.prefix.lookup(path)) is not None
                        and n.snapshot is not None
                        and n.version == self.params_version):
                    self._snapshot_slot(sp, req.slot, path)
            if req.seed_node is not None:
                self.prefix.release(req.seed_node)
                req.seed_node = None
            # finished greedy outputs become exact-hit answers for repeats
            if fresh:
                self.prefix.result_store(req.prompt, req.max_new,
                                         req.temperature,
                                         self.params_version, req.output())
        sp.active[req.slot] = None
        sp.gens[req.slot] = None
        req.pool = req.slot = -1
        req.t_done = time.perf_counter()
        req.done.set()

    def _finish_from_cache(self, req: Request, tokens: List[int]) -> None:
        """Answer a request straight from the result cache: no slot, no
        prefill, no decode — the first and last token land together."""
        req.tokens = list(tokens)
        now = time.perf_counter()
        req.t_first = req.t_first or now
        req.t_done = now
        req.marks.append((now, len(req.tokens), self.tick_no))
        self.tokens_out += len(req.tokens)
        req.done.set()

    def _sync(self, *devs) -> None:
        """Wait for the card(s) ``devs`` (by default the engine's)."""
        for dev in devs or (self.device,):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _row_job(self, sp: SlotPool, kind: str, tokens: int, fn):
        """Run a row copy (snapshot or seed write) as a measured job, also
        under the pool's kind (the engine's prefix-admission decision reads
        both)."""
        cold = kind not in self._warm
        self._warm.add(kind)
        job = Job(kind, tokens=tokens, meta={"cold": cold})
        pjob = Job(pool_kind(kind, sp.pool_id), tokens=tokens,
                   meta={"cold": cold})

        def thunk():
            out = fn()
            self._sync(*{g for sh in sp.shards for g in sh.group})
            return out

        with tracing.span("serve.rows", pool=sp.lid, kind=kind,
                          tokens=tokens):
            return self.engine.run_job(job, thunk, extra=(pjob,))

    def _snapshot_slot(self, sp: SlotPool, slot: int, path) -> None:
        """Capture one slot's pool row (to host tensors) and commit it into
        the radix tree under ``path`` — the token prefix the slot has
        consumed so far."""
        row = self._row_job(sp, "serve_snapshot", len(path),
                            lambda: sp.snapshot(slot))
        self.prefix.insert(path, snapshot=row, version=self.params_version)

    def _allowed_pools(self, req: Request) -> List[int]:
        if req.pin_pool is not None:
            return [req.pin_pool]
        allowed = self.class_pools.get(req.priority)
        if allowed is not None:
            live = [p for p in allowed
                    if (sp := self._pool(p)) is not None and not sp.draining]
            if live:
                return live
            # every pool the class routes to has drained away: open
            # routing rather than a stranded class
        return [sp.lid for sp in self.pools if not sp.draining]

    def _admit(self) -> int:
        """Join queued requests into free slots.  The row zeroing and
        position reset are deferred into the next tick (the ``reset``
        mask); only the slot's sampling generator is set here.

        Routing: a pinned request joins only its pool; otherwise
        ``class_pools`` restricts the admissible pools, and among those the
        emptiest wins (ties: the lowest id); a draining pool admits
        nothing.  With placements, a choice among several pools is
        ``Engine.choose_admission_pool``'s: per-token EMAs inflated by each
        pool's device-group occupancy.  A request whose admissible pools are
        all full stays queued, in order, without blocking later requests
        bound for a free pool.

        Prefix cache (when enabled): an exact result-cache hit answers the
        request here — it never takes a slot.  Otherwise a greedy request
        looks up its longest snapshotted prompt prefix under the current
        params version, and if ``Engine.choose_prefix_admission`` picks the
        seed path the slot starts from the snapshot: ``prompt_off``/``pos``
        begin at the cached depth and ``reset`` stays False (the seed write
        replaces the whole row).  Sampled requests never seed and never
        hit: their tokens are draws, not facts.  Each pool's seed rows land
        in ONE batched write.  Returns the number of requests that joined
        a slot."""
        seeds: Dict[int, List[tuple]] = {}
        admitted = 0
        remaining: Deque[Request] = deque()
        for req in self.queue:
            if (self.prefix is not None and req.temperature <= 0
                    and (out := self.prefix.result_lookup(
                        req.prompt, req.max_new, req.temperature,
                        self.params_version)) is not None):
                self._finish_from_cache(req, out)
                continue
            cands = [p for p in self._allowed_pools(req)
                     if (c := self._pool(p)) is not None
                     and not c.draining and c.free_slots() > 0]
            if not cands:
                remaining.append(req)
                continue
            if self.placements and len(cands) > 1:
                pid = self.engine.choose_admission_pool(
                    [{"pool": c.pool_id, "free": c.free_slots(),
                      "busy": self._group_busy(c),
                      "devices": len(c.devices())}
                     for c in map(self._pool, cands)]) - self.pool_id
            else:
                pid = max(cands,
                          key=lambda p: (self._pool(p).free_slots(), -p))
            sp = self._pool(pid)
            slot = next(s for s in range(sp.slots) if sp.active[s] is None)
            req.pool, req.slot = pid, slot
            admitted += 1
            req.joined_version = self.params_version
            sp.active[slot] = req
            node = None
            if self.prefix is not None and req.temperature <= 0:
                # >= 1 prompt token must remain to produce the first logits
                node = self.prefix.longest_match(
                    req.prompt, limit=len(req.prompt) - 1,
                    version=self.params_version)
            if node is not None and self.engine.choose_prefix_admission(
                    node.depth, len(req.prompt) - node.depth,
                    pool_id=sp.pool_id) == "seed":
                self.prefix.acquire(node)
                req.seed_node = node
                req.prompt_off = node.depth
                sp.reset[slot] = False
                sp.pos_host[slot] = node.depth
                seeds.setdefault(pid, []).append((slot, node))
                self.prefix.seeded += 1
                self.prefix.tokens_avoided += node.depth
            else:
                if node is not None:
                    self.prefix.seed_declined += 1
                sp.reset[slot] = True
                sp.pos_host[slot] = 0
            if req.temperature > 0:
                sp.gens[slot] = torch.Generator(
                    device=sp.shard_of(slot).device).manual_seed(req.seed)
        self.queue = remaining
        for pid, ss in seeds.items():
            sp = self._pool(pid)
            self._row_job(sp, "serve_seed", sum(n.depth for _, n in ss),
                          lambda: sp.seed_rows([s for s, _ in ss],
                                               [n.snapshot for _, n in ss],
                                               [n.pos for _, n in ss]))
        return admitted

    # -------------------------------------------------------------- control
    def _inspect(self, what: str) -> Dict[str, Any]:
        return {"tick": self.tick_no, "queue_depth": len(self.queue),
                "tokens_out": self.tokens_out,
                "paused": self.engine.controller.paused,
                "spec": {"enabled": self.spec_decode,
                         "ticks": self.spec_ticks,
                         "proposed": self.spec_proposed,
                         "accepted": self.spec_accepted,
                         "draft": None if self.draft_cfg is None
                         else self.draft_cfg.name,
                         "arms": {a: dict(c)
                                  for a, c in self.spec_arms.items()}},
                "compact": {"mode": self.compact_decode,
                            "ticks": self.compact_ticks},
                "decisions": list(self.engine.decisions),
                "prefix_cache": (self.prefix.stats()
                                 if self.prefix is not None
                                 else {"enabled": False}),
                "slots": [None if r is None else
                          {"rid": r.rid, "prompt_off": r.prompt_off,
                           "plen": len(r.prompt), "out": len(r.tokens),
                           "max_new": r.max_new, "priority": r.priority,
                           "deferred": r.deferred}
                          for r in self.active],
                "pools": [self._pool_status(sp) for sp in self.pools],
                "migrated_slots": self.migrated_slots,
                "placement": {"placed_pools": len(self.placements),
                              "migrated_slots": self.migrated_slots,
                              "parallel_group_ticks":
                                  self.parallel_group_ticks},
                "classes": {n: {"weight": c.weight,
                                "max_defer": c.max_defer}
                            for n, c in self.classes.items()},
                "knobs": {"spec_len": self.spec_len,
                          "compact_frac": self.compact_frac,
                          "prefill_chunk": self.prefill_chunk,
                          "decode_chunk": self.decode_chunk,
                          "class_weights": {n: c.weight for n, c in
                                            self.classes.items()}},
                "autotune": (self.autotuner.snapshot()
                             if self.autotuner is not None
                             else {"enabled": False}),
                "engine": self.engine.inspect()}

    @staticmethod
    def _pool_status(sp: SlotPool) -> Dict[str, Any]:
        """A pool's entry in ``_inspect()["pools"]``; a placed pool's
        ``layout`` says how its rows lie on its devices: ``rows`` "split"
        (over ``data``: each shard's slots and devices) or "whole" (on the
        group's first row: one data row, or a slot count that ``data`` does
        not divide), and the tensor-parallel degree ``tp``."""
        out = {"id": sp.pool_id, "lid": sp.lid, "slots": sp.slots,
               "free": sp.free_slots(), "draining": sp.draining,
               "devices": None}
        if sp.mesh is not None:
            out["devices"] = [str(d) for d in sp.devices()]
            out["layout"] = {
                "rows": "split" if sp.split else "whole", "tp": sp.tp,
                "shards": [[lo, hi, [str(d) for d in sh.group]]
                           for sh, (lo, hi) in zip(sp.shards, sp.bounds)]}
        return out

    def _apply_updates(self, updates: Dict[str, Any]) -> None:
        if "max_prefill_defer" in updates:
            self.engine.max_prefill_defer = int(updates["max_prefill_defer"])
        if "decode_chunk" in updates:
            self.decode_chunk = int(updates["decode_chunk"])
        if "prefill_chunk" in updates:
            self.prefill_chunk = int(updates["prefill_chunk"])
        if "spec_decode" in updates:
            self.spec_decode = bool(updates["spec_decode"])
        if "spec_len" in updates:
            self.spec_len = max(int(updates["spec_len"]), 0)
        if "compact_frac" in updates:
            self.compact_frac = min(max(float(updates["compact_frac"]), 0.0),
                                    1.0)
        if "compact_decode" in updates:
            v = updates["compact_decode"]
            self.compact_decode = None if v is None else bool(v)
        if "class_weights" in updates:
            # arbitration-only state: a replace of the frozen class at the
            # tick boundary is the whole swap.  The aging bound (max_defer)
            # is not tunable: it is the starvation guarantee
            for name, w in dict(updates["class_weights"]).items():
                if name not in self.classes:
                    raise ValueError(f"class_weights names unknown class "
                                     f"{name!r}")
                self.classes[name] = dataclasses.replace(
                    self.classes[name], weight=float(w))
        if "autotune" in updates:
            on = updates["autotune"]
            if on and self.autotuner is None:
                self.autotuner = AutoTuner(
                    self, **(dict(on) if isinstance(on, dict) else {}))
            elif not on:
                self.autotuner = None
        if "draft_params" in updates and self.draft_cfg is not None:
            # a draft is acceptance-only state: the swap needs no drain and
            # no re-seed.  Ignored without a draft configured at
            # construction (enabling one would need the pool's draft rows)
            with tracing.span("serve.publish", what="draft"):
                self.draft_params = serving_params(updates["draft_params"],
                                                   self.device)
            self._release()
        if "prefix_cache" in updates:
            on = bool(updates["prefix_cache"])
            if on and self.prefix is None:
                sc = self.cfg.serve
                self.prefix = PrefixCache(sc.prefix_cache_nodes,
                                          sc.prefix_min_len,
                                          sc.result_cache_entries)
            elif not on and self.prefix is not None:
                # in-flight seeded requests keep their (host) refs on the
                # dropped tree; nothing reads it again
                self.prefix = None
        if "params" in updates:
            # the weight publish: the incoming tree (numpy or tensors) is
            # converted once and rebound, and every graph of every pool,
            # height and device, which hold the old weights' addresses, is
            # dropped with the placed pools' weight copies for a capture on
            # its next use.  Rebinding never writes into the
            # old tensors, which the caller may share (BatchedServer hands
            # its own).
            with tracing.span("serve.publish", what="params"):
                self.params = serving_params(updates["params"], self.device)
                if self._self_draft:
                    self.draft_params = slice_draft_params(
                        self.params, self.cfg, self.draft_cfg)
            self._release()
            # an explicit params_version in the same update wins; a bare
            # params swap auto-bumps so stale results can never serve
            self._bump_version(int(updates.get(
                "params_version", self.params_version + 1)))
        elif "params_version" in updates:
            self._bump_version(int(updates["params_version"]))

    def _bump_version(self, version: int) -> None:
        """Move to a new params version: snapshots captured under any other
        version are flushed from the radix tree (``longest_match`` would
        never return them again) unless
        ``serve.flush_prefix_on_publish`` is off.  The result cache needs no
        flush: its keys carry the version."""
        if version == self.params_version:
            return
        self.params_version = int(version)
        if self.prefix is not None and self.cfg.serve.flush_prefix_on_publish:
            self.prefix.flush_versions(self.params_version)

    def update(self, **updates) -> None:
        """Queue a hot update through the controller mailbox, applied at
        the next tick boundary.  ``update(params=..., params_version=...)``
        is the weight-publish entry point (``TrainLoop``'s publish hook
        calls it): requests admitted after the boundary see the new
        weights, and no request drops."""
        self.engine.controller.send(M.update(**updates))

    def _poll(self) -> bool:
        r = self.engine.poll(self.tick_no, 0, self._inspect)
        self._apply_updates(r["updates"])
        return r["stopped"]

    def _check_breakpoints(self, emitted: int) -> None:
        m = {"emitted": float(emitted), "queue": float(len(self.queue)),
             "active": float(sum(r is not None for r in self.active)),
             "tokens_out": float(self.tokens_out)}
        for bp in self.engine.local_bps:
            if bp.check(m):
                self.hit_breakpoints.append(bp.name)
                self.engine.controller.paused = True
        for bp in list(self.engine.global_bps):
            if bp.update([emitted]):
                self.hit_breakpoints.append(bp.name)
                self.engine.controller.paused = True
                self.engine.global_bps.remove(bp)

    # ----------------------------------------------------------------- tick
    def _tick_len(self, sp: SlotPool, act: List[Request], mode: str,
                  chunk: int) -> int:
        """Adaptive tick length: no slot needs more than its remaining
        horizon, so trim the chunk to the longest one (rounded up to a
        power of two, so few distinct lengths run), capped by the tightest
        participant's cache headroom."""
        need, cap = 1, chunk
        for r in act:
            if mode != "prefill" and r.prefilling:
                continue
            h = (len(r.prompt) - r.prompt_off) if r.prefilling \
                else (r.max_new - len(r.tokens))
            need = max(need, min(h, chunk))
            cap = min(cap, self.max_len - int(sp.pos_host[r.slot]))
        L = 1
        while L < need:
            L *= 2
        L = min(L, chunk)
        while L > max(cap, 1):
            L //= 2
        return L

    def _pool_spec_arms(self, act: List[Request]) -> tuple:
        """The proposer arms a decode tick may run, by name: none unless
        speculation is on and every decode participant is greedy
        (verifying sampled continuations greedily would change their
        distribution); ``draft`` only with a draft model loaded."""
        dec = [r for r in act if not r.prefilling]
        if not (self.spec_decode and self.spec_len > 1 and dec
                and all(r.temperature <= 0 for r in dec)):
            return ()
        return ("ngram", "draft") if self.draft_cfg is not None \
            else ("ngram",)

    def _candidates(self) -> List[TickCandidate]:
        """One TickCandidate per (pool, composition) with work: the menu
        ``Engine.choose_serve_job`` arbitrates by weighted FRT.  A prefill
        candidate is ``aged`` once any of its requests has sat out its
        class's ``max_defer`` scheduled ticks.  ``xfer`` is the migration
        traffic about to land on a pool: while a drain routes into it, the
        pending batches times the measured ``serve_migrate`` time.  With
        placements ``load`` is the pool's device-group occupancy
        (``_group_busy``); without them 0, so the scores are the weighted
        FRTs of an engine without placements."""
        cands = []
        draining = any(sp.draining for sp in self.pools)
        for sp in self.pools:
            act = [r for r in sp.active if r is not None]
            if not act:
                continue
            pre = [r for r in act if r.prefilling]
            dec = [r for r in act if not r.prefilling]

            def weight(rs):
                return sum(self.classes[r.priority].weight for r in rs)

            load = self._group_busy(sp) if self.placements else 0.0
            xfer = 0.0
            if draining and self._last_mig_dst == sp.lid:
                pend = sum(o.slots - o.free_slots()
                           for o in self.pools if o.draining)
                t_mig = self.engine.costs.estimate_first(
                    [pool_kind("serve_migrate", sp.pool_id),
                     "serve_migrate"], COST_DEFAULTS["serve_migrate"])
                xfer = -(-pend // max(self.cfg.serve.migrate_batch, 1)) \
                    * t_mig
            if dec:
                arms = self._pool_spec_arms(act)
                cands.append(TickCandidate(
                    sp.pool_id, "decode", n_dec=len(dec), n_pre=len(pre),
                    chunk=self.decode_chunk, weight=weight(dec),
                    spec_len=self.spec_len if arms else 0, arms=arms,
                    load=load, xfer=xfer))
            if pre:
                overdue = max(r.deferred - self.classes[r.priority].max_defer
                              for r in pre)
                cands.append(TickCandidate(
                    sp.pool_id, "prefill", n_dec=len(dec), n_pre=len(pre),
                    pre_toks=sum(len(r.prompt) - r.prompt_off for r in pre),
                    chunk=self.prefill_chunk, weight=weight(pre),
                    aged=overdue >= 0, overdue=max(overdue, 0), load=load,
                    xfer=xfer))
        return cands

    def _age_prefills(self, part: List[Request]) -> None:
        """After a tick: every admitted prefill that did not advance — it
        sat out a decode tick of its pool, or its pool lost the round —
        ages one tick; the participants' counters reset."""
        ran = set(id(r) for r in part)
        for r in self.active:
            if r is None or not r.prefilling:
                continue
            if id(r) in ran:
                r.deferred = 0
            else:
                r.deferred += 1
                r.max_deferred = max(r.max_deferred, r.deferred)

    def _plan_tick(self, sp: SlotPool, act: List[Request],
                   mode: str) -> Optional[_TickPlan]:
        """Resolve the speculative arm, tick length, participants, layout
        (compact or full) and job records of one pool's tick, and close
        over its dispatch and finish thunks and the pool's weights."""
        if mode == "spec":
            # a bare "spec" maps to the strongest proposer this engine has
            mode = "spec:draft" if self.draft_cfg is not None \
                else "spec:ngram"
        spec = mode.startswith("spec:")
        arm = mode.split(":", 1)[1] if spec else ""
        if spec:
            L = self._tick_len(sp, act, mode, self.spec_len)
            if L < 2:
                mode, spec, arm = "decode", False, ""  # nothing to draft
        if not spec:
            chunk = self.prefill_chunk if mode == "prefill" \
                else self.decode_chunk
            L = self._tick_len(sp, act, mode, chunk)
        toks = np.zeros((sp.slots, L), np.int64)
        n_given = np.ones((sp.slots,), np.int64)
        active = np.zeros((sp.slots,), bool)
        temps = np.zeros((sp.slots,), np.float32)
        part: List[Request] = []
        for r in act:
            if mode != "prefill" and r.prefilling:
                continue                      # prefill slots sit this one out
            if int(sp.pos_host[r.slot]) + L > self.max_len:
                continue                      # defensive: never overrun cache
            s = r.slot
            if r.prefilling:
                g = min(len(r.prompt) - r.prompt_off, L)
                toks[s, :g] = r.prompt[r.prompt_off:r.prompt_off + g]
                n_given[s] = g
            else:
                toks[s, 0] = r.pending_tok
            active[s] = True
            temps[s] = r.temperature
            part.append(r)
        if not part:
            return None
        # layout: a decode tick whose participants fit in compact_frac of
        # the pool may run them, padded with idle rows to a power of two,
        # on the pool's buffer set of that height; the config pins the
        # choice or Engine.choose_compact makes it from measured EMAs
        part_slots = [r.slot for r in part]
        # (a split pool's compact tick runs on its first shard's devices,
        # so only where every shard shares them: a sampled row's generator
        # lives on its own shard's device)
        compact_ok = mode != "prefill" \
            and len(part) <= int(sp.slots * self.compact_frac) \
            and (not sp.split or len(set(sp.devices())) == 1)
        compact = compact_ok and (
            self.compact_decode if self.compact_decode is not None
            else self.engine.choose_compact(sp.pool_id))
        idx = np.arange(sp.slots)
        if compact:
            nc = 1
            while nc < len(part):
                nc *= 2
            if nc < sp.slots:
                pads = [s for s in range(sp.slots) if s not in part_slots]
                idx = np.asarray(part_slots + pads[:nc - len(part)])
        # a compact tick as high as the pool runs on the pool itself, and a
        # split pool's full tick on each shard's rows, each on its device
        run_on = sp.compact_rows(len(idx)) if len(idx) < sp.slots else sp
        runs = [(run_on, idx)] if run_on is not sp or not sp.split else \
            [(sh, np.arange(lo, hi)) for sh, (lo, hi) in zip(sp.shards,
                                                              sp.bounds)]
        ticks = [(self._tick_for(r), r, rows) + self._params_for(r)
                 for r, rows in runs]
        warm = (sp.lid, arm, L, len(idx))
        cold = warm not in self._warm or any(
            t.capture_pending(r, arm) for t, r, *_ in ticks)
        self._warm.add(warm)
        kind = "serve_prefill" if mode == "prefill" \
            else spec_kind(arm) if spec else "serve_decode"
        ntok = L * len(part)
        job = Job(kind, tokens=ntok, meta={"cold": cold})
        # the same measurement under the pool's kind, for a speculative
        # tick under the arm-agnostic aggregate, and on a layout-eligible
        # tick under its layout: the inputs of the engine's arbitration,
        # arm, admission and layout decisions
        extras = [Job(pool_kind(kind, sp.pool_id), tokens=ntok,
                      meta={"cold": cold})]
        if spec:
            extras.append(Job("serve_spec_decode", tokens=ntok,
                              meta={"cold": cold}))
        if compact_ok:
            extras.append(Job(layout_kind(compact, sp.pool_id),
                              tokens=ntok, meta={"cold": cold}))
        reset = sp.reset.copy()

        def dispatch():
            # the compact tick: gather the rows into the buffer set, tick
            # it (its reset rows zeroed there), write them back in place;
            # every shard's tick is enqueued before any is awaited
            if run_on is not sp:
                sp.gather_into(run_on, idx)
            outs = [t.dispatch(r, params, dparams, toks[rows], n_given[rows],
                               active[rows], reset[rows], temps[rows],
                               [sp.gens[s] for s in rows], arm=arm)
                    for t, r, rows, params, dparams in ticks]
            if run_on is not sp:
                sp.scatter_from(run_on, idx)
            return outs

        def finish(outs):
            if len(outs) == 1:
                em_r, nv_r = ticks[0][0].collect(*outs[0])
            else:
                # the shards' tokens gathered on the first shard's device:
                # the tick's one host copy
                out = torch.cat([o.to(sp.device) for o, _ in outs])
                nv = None if outs[0][1] is None else \
                    np.concatenate([n for _, n in outs])
                em_r, nv_r = ticks[0][0].collect(out, nv)
            if run_on is sp:
                return sp.pos, em_r, nv_r
            em = np.zeros((sp.slots, L), em_r.dtype)
            em[idx] = em_r
            nv = np.zeros((sp.slots,), np.int64)
            nv[idx] = nv_r
            return sp.pos, em, nv

        return _TickPlan(sp=sp, mode=mode, spec=spec, arm=arm, L=L,
                         part=part, n_given=n_given, idx=idx,
                         compact=compact, job=job, extras=tuple(extras),
                         dispatch=dispatch, finish=finish)

    def _commit_tick(self, plan: _TickPlan, outs) -> int:
        """Write a tick's results back: the reset flags of the rows it ran,
        the host position view, token commits, evictions, prefill
        snapshots and speculative counters.  Returns the new tokens
        emitted."""
        sp, L, part, n_given = plan.sp, plan.L, plan.part, plan.n_given
        _, em, nv = outs
        sp.reset[plan.idx] = False           # zeroing landed in the tick
        if plan.compact:
            self.compact_ticks += 1
        # how far each slot really advanced: L for every active slot on the
        # plain arms, the committed prefix under speculation
        sp.pos_host += nv
        part_slots = [r.slot for r in part]  # an eviction below clears slot
        n_new = 0
        now = time.perf_counter()
        for r in part:
            s, g = r.slot, int(n_given[r.slot])
            if r.prefilling:
                r.prompt_off += g
                if r.prefilling:
                    continue                  # prompt continues next tick
            need = r.max_new - len(r.tokens)
            last = int(nv[s]) if plan.spec else L
            outs_r = em[s, g - 1:last][:need]
            if outs_r.size and r.t_first is None:
                r.t_first = now               # first-token latency mark
            r.tokens.extend(int(t) for t in outs_r)
            if outs_r.size:
                r.marks.append((now, len(r.tokens), self.tick_no))
            n_new += len(outs_r)
            if len(r.tokens) >= r.max_new:
                self._evict(r)
            else:
                r.pending_tok = int(em[s, last - 1])
        if self.prefix is not None and plan.mode == "prefill":
            # a prefill tick boundary where the slot has consumed exactly a
            # prompt prefix (no decode output fed back yet, joined under the
            # current weights) is a reusable state: commit it into the tree
            # unless that path already owns a current snapshot
            for r in part:
                if (r.slot < 0 or r.prompt_off < self.prefix.min_len
                        or int(sp.pos_host[r.slot]) != r.prompt_off
                        or r.joined_version != self.params_version):
                    continue
                path = r.prompt[:r.prompt_off]
                n = self.prefix.lookup(path)
                if n is not None and n.snapshot is not None \
                        and n.version == self.params_version:
                    continue
                self._snapshot_slot(sp, r.slot, path)
        if plan.spec:
            proposed = (L - 1) * len(part)
            accepted = int(sum(int(nv[s]) - 1 for s in part_slots))
            self.spec_ticks += 1
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            st = self.spec_arms.setdefault(
                plan.arm, {"ticks": 0, "proposed": 0, "accepted": 0})
            st["ticks"] += 1
            st["proposed"] += proposed
            st["accepted"] += accepted
            if proposed:
                self.engine.observe_accept(sp.pool_id, accepted / proposed,
                                           arm=plan.arm)
        return n_new

    def _group_plans(self, winner: _TickPlan) -> List[_TickPlan]:
        """The parallel group tick's co-ticks: plain ticks (prefill while
        the pool has prompt left, else decode) of the other placed pools
        whose device groups are disjoint from the winner's and from each
        other's.  They add work to devices that would idle this round; the
        winner and the decisions are unchanged.  Empty without placements
        or with ``serve.parallel_ticks`` off."""
        if not self.cfg.serve.parallel_ticks or winner.sp.mesh is None:
            return []
        used = set(winner.sp.devices())
        out = []
        for sp in self.pools:
            if sp is winner.sp or sp.mesh is None:
                continue
            devs = set(sp.devices())
            if devs & used:
                continue
            act = [r for r in sp.active if r is not None]
            if not act:
                continue
            mode = "prefill" if any(r.prefilling for r in act) else "decode"
            plan = self._plan_tick(sp, act, mode)
            if plan is None:
                continue
            used |= devs
            out.append(plan)
        return out

    def tick(self) -> bool:
        """One engine iteration.  Returns False when stopped, True otherwise
        (including idle ticks).  Control messages land here, between
        ticks; then each draining pool moves one batch of its slots
        (``_drain_step``) and queued requests join.

        With one pool and the single default class the composition is
        ``Engine.choose_serve_tick``; otherwise every pool's candidate
        ticks go to ``Engine.choose_serve_job`` (weighted FRT and the
        per-class aging bounds) and one pool wins the round.  With placed
        pools on disjoint devices the winner's tick is joined by theirs
        (``_group_plans``): every plan is dispatched before any is
        finished, and each pool's time is measured from the round's start,
        as ``Engine.run_job`` measures (a cold shape stays out of the
        EMAs).

        Each call is a ``serve.tick`` span (``runtime.tracing``) whose
        attributes are the round's: ``tick_no``, ``pool``, ``mode``, ``L``,
        ``rows`` (participants over the round's plans; 0 on an idle tick),
        ``height`` (the rows its steps ran at), ``compact``, ``cold``,
        ``group`` (co-ticks) and ``device`` (the engine's device type).
        Inside it: ``serve.poll``, ``serve.admit``, ``serve.plan``,
        ``serve.device`` (from the first dispatch, at the ``t0`` the
        measurements start from, to the end of the last host copy; it
        holds each plan's ``serve.dispatch`` and ``serve.collect``, and in
        a group round the commits of all plans but the last) and
        ``serve.commit`` (a plan's measurements and commit; the last one
        also the aging, breakpoints and autotuner)."""
        with tracing.span("serve.tick", tick_no=self.tick_no, rows=0,
                          device=self.device.type) as span:
            return self._round(span)

    def _round(self, span) -> bool:
        """``tick``'s work, its attributes set on ``span``."""
        with tracing.span("serve.poll", mirror=True):
            if self._poll():
                return False
        self._drain_step()
        with tracing.span("serve.admit", mirror=True) as admit:
            admit.attrs["admitted"] = self._admit()
        with tracing.span("serve.plan", mirror=True):
            if self.single_pool:
                sp = self.pools[0]
                act = [r for r in sp.active if r is not None]
                if not act:
                    return True
                n_pre = sum(r.prefilling for r in act)
                pre_toks = sum(len(r.prompt) - r.prompt_off
                               for r in act if r.prefilling)
                arms = self._pool_spec_arms(act)
                mode = self.engine.choose_serve_tick(
                    len(act) - n_pre, n_pre, pre_toks, self.decode_chunk,
                    self.prefill_chunk,
                    spec_len=self.spec_len if arms else 0,
                    pool_id=sp.pool_id, arms=arms)
            else:
                cands = self._candidates()
                if not cands:
                    return True
                gid, mode = self.engine.choose_serve_job(cands)
                sp = self._pool(gid - self.pool_id)
                act = [r for r in sp.active if r is not None]
            plan = self._plan_tick(sp, act, mode)
            if plan is None:
                return True
            group = self._group_plans(plan)
        plans = [plan] + group
        span.attrs.update(
            pool=plan.sp.lid, mode=plan.mode, L=plan.L,
            rows=sum(len(p.part) for p in plans),
            height=sum(len(p.idx) for p in plans), compact=plan.compact,
            cold=any(p.job.meta["cold"] for p in plans), group=len(group))
        t0 = time.perf_counter()
        device = tracing.span("serve.device").begin(t0)
        live = []
        for p in plans:
            with tracing.span("serve.dispatch"):
                live.append((p, p.dispatch()))
        part, n_new = [], 0
        for i, (p, out) in enumerate(live):
            with tracing.span("serve.collect"):
                outs = p.finish(out)
            t1 = time.perf_counter()
            if i == len(live) - 1:
                device.end(t1)
            commit = tracing.span("serve.commit", mirror=True).begin()
            for j in (p.job,) + p.extras:
                self.engine.observe(j, t1 - t0)
            k = self._commit_tick(p, outs)
            commit.attrs["tokens"] = k
            n_new += k
            part = part + p.part
            if i < len(live) - 1:
                commit.end()
        self.parallel_group_ticks += len(group)
        self._age_prefills(part)
        self.tokens_out += n_new
        self._check_breakpoints(n_new)
        self.tick_no += 1
        if self.autotuner is not None:
            # knob moves at the boundary of work ticks only: idle ticks
            # returned above, so no window accumulates empty time
            self.autotuner.on_tick()
        commit.end()
        return True

    # ----------------------------------------------------------- convenience
    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.tick():
                return
            if not self.queue and all(r is None for r in self.active):
                return
        raise RuntimeError("serve engine did not drain within max_ticks")

    def generate(self, prompts, max_new: int = 16, temperature: float = 0.0,
                 seed: Optional[int] = None, priorities=None) -> np.ndarray:
        """Batch convenience: prompts (rectangular, or a list of mixed
        lengths) in, ``[B, max_new]`` tokens out.  ``seed`` pins every
        request's sampling stream, so repeated calls reproduce;
        ``priorities`` optionally names a traffic class per prompt."""
        reqs = [self.submit(p, max_new, temperature,
                            seed=None if seed is None
                            else _stream_seed(seed, i),
                            priority=None if priorities is None
                            else priorities[i])
                for i, p in enumerate(prompts)]
        self.run_until_done()
        return np.stack([r.output() for r in reqs])


def _stream_seed(base: int, i: int) -> int:
    """A request's sampling seed from a base seed and its index."""
    return (int(base) * 0x9E3779B1 + int(i)) & 0xFFFFFFFFFFFF
