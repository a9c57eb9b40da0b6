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

Device placements, draining a pool and migrating its slots need more than
one device and are not ported yet.
"""
from __future__ import annotations

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
from repro_torch.engine.jobs import (Job, TickCandidate, layout_kind,
                                     pool_kind, spec_kind)
from repro_torch.engine.prefix_cache import (PrefixAnalyzer, PrefixCache,
                                             to_host)
from repro_torch.kernels import LAUNCHES, credit_launches, launches_since
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
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
    would build one on every call."""
    plan = _plan(cfg, device)
    dplan = _plan(draft_cfg, device) if draft_cfg is not None else None

    def step(params, dparams, pool, tok, active):
        """tok [B] int64, active [B] bool -> (logits [B,V] f32, argmax
        [B])."""
        ng_learn(pool.ng, pool.ctx, tok, active)
        if draft_cfg is not None:
            lm.decode_step(dparams, {"caches": pool.draft, "pos": pool.pos},
                           tok[:, None], draft_cfg, plan=dplan,
                           moe_groups="row", active=active)
        logits, st = lm.decode_step(params, {"caches": pool.caches,
                                             "pos": pool.pos},
                                    tok[:, None], cfg, plan=plan,
                                    moe_groups="row", active=active)
        pool.pos.copy_(st["pos"])
        return logits, torch.argmax(logits, dim=-1)

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
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=mempool):
            self.logits, self.greedy = step(*state, self.tok, self.active)
        self.per_replay = launches_since(before)
        LAUNCHES.update(before)              # the capture launched nothing
        self.replays = 0

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
    a pool's full rows and each compact buffer set are separate states.
    All share one graph memory pool.  The reset zeroing, the token
    select and the valid mask between steps, sampling and the tick's one
    host copy stay outside the graph.  Without it (a CPU pool) the same
    steps run eagerly.  ``record``, when a list, receives each step's
    logits."""

    def __init__(self, cfg: ArchConfig, device, graph: bool,
                 draft_cfg: Optional[ArchConfig] = None):
        self.steps = {"step": build_decode_step(cfg, device, draft_cfg)}
        if draft_cfg is not None:
            self.steps["propose"] = build_propose_step(draft_cfg, device)
        self.graph = graph
        # (pool lid, step name, rows) -> its graph
        self.graphs: Dict[tuple, GraphedStep] = {}
        self.captures = 0
        self.record: Optional[list] = None
        self._mempool = None

    @staticmethod
    def key(pool, name: str) -> tuple:
        return (pool.lid, name, pool.slots)

    @property
    def graphed(self) -> Optional[GraphedStep]:
        """Pool 0's target step graph at its full height (None before its
        first full tick)."""
        full = [g for (lid, n, _), g in self.graphs.items()
                if lid == 0 and n == "step"]
        return max(full, key=lambda g: g.rows, default=None)

    def capture_pending(self, pool, arm: str = "") -> bool:
        need = ("step", "propose") if arm == "draft" else ("step",)
        return self.graph and any(self.key(pool, n) not in self.graphs
                                  for n in need)

    def release(self) -> None:
        """Drop every graph of every pool and height: the next tick
        captures again (a weight or draft publish rebinds the weights the
        graphs hold).  The memory pool goes with them."""
        self.graphs.clear()
        self._mempool = None

    def runner(self, name: str, *state):
        """``fn(tok, active) -> (logits, argmax)`` of step ``name`` over
        ``state`` (its last element the pool the tick runs on): its graph
        on the card (captured on first use), the step itself on the CPU."""
        step = self.steps[name]
        if not self.graph:
            return lambda tok, active: step(*state, tok, active)
        key = self.key(state[-1], name)
        g = self.graphs.get(key)
        if g is None:
            if self._mempool is None:
                self._mempool = torch.cuda.graph_pool_handle()
            g = self.graphs[key] = GraphedStep(step, *state,
                                               mempool=self._mempool)
            self.captures += 1
        elif not g.bound_to(*state):
            raise ValueError(f"the tick's {key} graph was captured over "
                             "other weights or another pool")
        return g

    @torch.no_grad()
    def __call__(self, pool, params, dparams, toks, n_given, active, reset,
                 temps, gens, arm: str = ""):
        dev = pool.pos.device
        if reset.any():
            pool.zero_rows(torch.as_tensor(np.flatnonzero(reset),
                                           device=dev))
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
            out = torch.stack(emitted + [n_valid], 1).cpu().numpy()
            return pool.pos, out[:, :L], out[:, L]
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
        n_valid = np.where(active, L, 0)
        return pool.pos, torch.stack(emitted, 1).cpu().numpy(), n_valid


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
    # wall-clock marks for first-token and completion latency
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
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

    ``lid`` is the pool's id: requests and ``class_pools`` address pools
    by it, and the engine's cost kinds carry it (``jobs.pool_kind``).
    ``compact_rows(n)`` is the pool's persistent buffer set of height
    ``n`` for compact ticks."""

    def __init__(self, cfg: ArchConfig, slots: int, max_len: int, device,
                 draft_cfg: Optional[ArchConfig] = None, lid: int = 0):
        self.cfg, self.max_len, self.draft_cfg = cfg, max_len, draft_cfg
        self.lid = lid
        self.slots = slots
        state = lm.init_cache(cfg, slots, max_len, device=device)
        self.caches = state["caches"]
        self.pos = state["pos"]
        self.ng = torch.zeros((slots, cfg.serve.spec_table),
                              dtype=torch.int32, device=device)
        self.ctx = torch.zeros((slots, cfg.serve.spec_ctx),
                               dtype=torch.int32, device=device)
        self.draft = self.scratch = None
        if draft_cfg is not None:
            self.draft = lm.init_cache(draft_cfg, slots, max_len,
                                       device=device)["caches"]
            self.scratch = lm.init_cache(draft_cfg, slots, max_len,
                                         device=device)
        self.pos_host = np.zeros((slots,), np.int64)
        self.reset = np.zeros((slots,), bool)
        self.gens: List[Optional[torch.Generator]] = [None] * slots
        self.active: List[Optional[Request]] = [None] * slots
        self._compact: Dict[int, SlotPool] = {}

    def free_slots(self) -> int:
        return sum(r is None for r in self.active)

    def compact_rows(self, rows: int) -> "SlotPool":
        """The buffer set a compact tick of ``rows`` rows runs on: a pool
        of ``rows`` slots with this pool's ids, made on first use and kept,
        so that the graphs captured over it stay bound."""
        sub = self._compact.get(rows)
        if sub is None:
            sub = self._compact[rows] = SlotPool(
                self.cfg, rows, self.max_len, self.pos.device,
                self.draft_cfg, lid=self.lid)
        return sub

    def gather_into(self, sub: "SlotPool", idx) -> None:
        """Copy rows ``idx`` (a device index tensor) of every per-slot leaf
        and their positions into ``sub``'s tensors, in place."""
        for (_, c, dim), (_, cc, _) in zip(self.row_leaves(),
                                           sub.row_leaves()):
            cc.copy_(c.index_select(dim, idx))
        sub.pos.copy_(self.pos.index_select(0, idx))

    def scatter_from(self, sub: "SlotPool", idx) -> None:
        """Write ``sub``'s rows back into rows ``idx``, in place."""
        for (_, c, dim), (_, cc, _) in zip(self.row_leaves(),
                                           sub.row_leaves()):
            c.index_copy_(dim, idx, cc)
        self.pos.index_copy_(0, idx, sub.pos)

    def row_leaves(self):
        """``(path, tensor, slot dim)`` of every per-slot leaf a snapshot
        holds: the caches and draft rows have the slot at dim 1, the n-gram
        table and window at dim 0."""
        out = [(("ng",), self.ng, 0), (("ctx",), self.ctx, 0)]
        for top, caches in (("caches", self.caches), ("draft", self.draft)):
            for t, leaves in (caches or {}).items():
                for k, c in leaves.items():
                    out.append(((top, t, k), c, 1))
        return out

    def zero_rows(self, rows) -> None:
        """Zero the pool state and positions of ``rows`` (a device index
        tensor), in place."""
        for _, c, dim in self.row_leaves():
            c.index_fill_(dim, rows, 0)
        self.pos.index_fill_(0, rows, 0)

    def snapshot(self, slot: int) -> Dict[str, Any]:
        """Slot ``slot``'s whole row as host tensors, nested as
        ``{"caches": {type: {leaf}}, "ng", "ctx"[, "draft"]}``."""
        row: Dict[str, Any] = {}
        for path, c, dim in self.row_leaves():
            node = row
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = c.select(dim, slot)
        return to_host(row)

    def seed_rows(self, slots: List[int], rows: List[Dict[str, Any]],
                  pos: List[int]) -> None:
        """Write snapshot ``rows`` into ``slots`` and set their positions,
        one batched in-place copy per leaf.  Writing the whole row subsumes
        the reset zeroing: a seeded slot starts from the snapshot state as
        a reset slot starts from zeros."""
        dev = self.pos.device
        idx = torch.as_tensor(slots, device=dev)
        for path, c, dim in self.row_leaves():
            vals = []
            for r in rows:
                for key in path:
                    r = r[key]
                vals.append(r)
            c.index_copy_(dim, idx, torch.stack(vals, dim).to(dev))
        self.pos.index_copy_(0, idx, torch.as_tensor(pos, device=dev))


@dataclasses.dataclass
class _TickPlan:
    """One planned tick: its pool, resolved arm, length, participants, the
    rows it runs (``idx``: the compact gather, or every slot) and job
    records, plus the dispatch thunk that runs it."""
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


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_len: int = 128,
                 slots: int = 4, prefill_chunk: int = 16,
                 decode_chunk: int = 4, engine: Optional[Engine] = None,
                 seed: int = 0, compact_decode: Optional[bool] = None,
                 spec_decode: bool = False, pools: int = 1,
                 class_pools: Optional[Dict[str, tuple]] = None,
                 prefix_cache: bool = False, params_version: int = 0,
                 draft: Optional[str] = None,
                 draft_cfg: Optional[ArchConfig] = None, draft_params=None,
                 autotune: Any = False, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = serving_params(params, self.device)
        self.engine = engine or Engine()
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self.seed = seed
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
        self.pools: List[SlotPool] = [
            SlotPool(cfg, slots, max_len, self.device, self.draft_cfg, lid=i)
            for i in range(n_pools)]
        self._tick = SlotTick(cfg, self.device,
                              graph=self.device.type == "cuda",
                              draft_cfg=self.draft_cfg)
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
        """The first slot pool (the whole engine when ``pools=1``)."""
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
        if pool is not None and not 0 <= pool < len(self.pools):
            raise ValueError(f"no pool {pool}; pools: "
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
        sp = self.pools[req.pool]
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
        self.tokens_out += len(req.tokens)
        req.done.set()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _row_job(self, sp: SlotPool, kind: str, tokens: int, fn):
        """Run a row copy (snapshot or seed write) as a measured job, also
        under the pool's kind (the engine's prefix-admission decision reads
        both)."""
        cold = kind not in self._warm
        self._warm.add(kind)
        job = Job(kind, tokens=tokens, meta={"cold": cold})
        pjob = Job(pool_kind(kind, sp.lid), tokens=tokens,
                   meta={"cold": cold})

        def thunk():
            out = fn()
            self._sync()
            return out

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
            return list(allowed)
        return [sp.lid for sp in self.pools]

    def _admit(self) -> None:
        """Join queued requests into free slots.  The row zeroing and
        position reset are deferred into the next tick (the ``reset``
        mask); only the slot's sampling generator is set here.

        Routing: a pinned request joins only its pool; otherwise
        ``class_pools`` restricts the admissible pools, and among those the
        emptiest wins (ties: the lowest id).  A request whose admissible
        pools are all full stays queued, in order, without blocking later
        requests bound for a free pool.

        Prefix cache (when enabled): an exact result-cache hit answers the
        request here — it never takes a slot.  Otherwise a greedy request
        looks up its longest snapshotted prompt prefix under the current
        params version, and if ``Engine.choose_prefix_admission`` picks the
        seed path the slot starts from the snapshot: ``prompt_off``/``pos``
        begin at the cached depth and ``reset`` stays False (the seed write
        replaces the whole row).  Sampled requests never seed and never
        hit: their tokens are draws, not facts.  Each pool's seed rows land
        in ONE batched write."""
        seeds: Dict[int, List[tuple]] = {}
        remaining: Deque[Request] = deque()
        for req in self.queue:
            if (self.prefix is not None and req.temperature <= 0
                    and (out := self.prefix.result_lookup(
                        req.prompt, req.max_new, req.temperature,
                        self.params_version)) is not None):
                self._finish_from_cache(req, out)
                continue
            cands = [p for p in self._allowed_pools(req)
                     if self.pools[p].free_slots() > 0]
            if not cands:
                remaining.append(req)
                continue
            pid = max(cands, key=lambda p: (self.pools[p].free_slots(), -p))
            sp = self.pools[pid]
            slot = next(s for s in range(sp.slots) if sp.active[s] is None)
            req.pool, req.slot = pid, slot
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
                    pool_id=sp.lid) == "seed":
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
                    device=self.device).manual_seed(req.seed)
        self.queue = remaining
        for pid, ss in seeds.items():
            sp = self.pools[pid]
            self._row_job(sp, "serve_seed", sum(n.depth for _, n in ss),
                          lambda: sp.seed_rows([s for s, _ in ss],
                                               [n.snapshot for _, n in ss],
                                               [n.pos for _, n in ss]))

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
                "pools": [{"lid": sp.lid,
                           "slots": sp.slots, "free": sp.free_slots()}
                          for sp in self.pools],
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
            self.draft_params = serving_params(updates["draft_params"],
                                               self.device)
            self._tick.release()
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
            # converted once and rebound, and every graph of every pool and
            # height, which hold the old weights' addresses, is dropped for
            # a capture on its next use.  Rebinding never writes into the
            # old tensors, which the caller may share (BatchedServer hands
            # its own).
            self.params = serving_params(updates["params"], self.device)
            if self._self_draft:
                self.draft_params = slice_draft_params(
                    self.params, self.cfg, self.draft_cfg)
            self._tick.release()
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
        class's ``max_defer`` scheduled ticks.  Without placements the
        ``load`` and ``xfer`` terms are 0."""
        cands = []
        for sp in self.pools:
            act = [r for r in sp.active if r is not None]
            if not act:
                continue
            pre = [r for r in act if r.prefilling]
            dec = [r for r in act if not r.prefilling]

            def weight(rs):
                return sum(self.classes[r.priority].weight for r in rs)

            if dec:
                arms = self._pool_spec_arms(act)
                cands.append(TickCandidate(
                    sp.lid, "decode", n_dec=len(dec), n_pre=len(pre),
                    chunk=self.decode_chunk, weight=weight(dec),
                    spec_len=self.spec_len if arms else 0, arms=arms))
            if pre:
                overdue = max(r.deferred - self.classes[r.priority].max_defer
                              for r in pre)
                cands.append(TickCandidate(
                    sp.lid, "prefill", n_dec=len(dec), n_pre=len(pre),
                    pre_toks=sum(len(r.prompt) - r.prompt_off for r in pre),
                    chunk=self.prefill_chunk, weight=weight(pre),
                    aged=overdue >= 0, overdue=max(overdue, 0)))
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
        over the dispatch thunk."""
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
        compact_ok = mode != "prefill" \
            and len(part) <= int(sp.slots * self.compact_frac)
        compact = compact_ok and (
            self.compact_decode if self.compact_decode is not None
            else self.engine.choose_compact(sp.lid))
        idx = np.arange(sp.slots)
        if compact:
            nc = 1
            while nc < len(part):
                nc *= 2
            if nc < sp.slots:
                pads = [s for s in range(sp.slots) if s not in part_slots]
                idx = np.asarray(part_slots + pads[:nc - len(part)])
        # a compact tick as high as the pool runs on the pool itself
        run_on = sp.compact_rows(len(idx)) if len(idx) < sp.slots else sp
        warm = (sp.lid, arm, L, len(idx))
        cold = warm not in self._warm or \
            self._tick.capture_pending(run_on, arm)
        self._warm.add(warm)
        kind = "serve_prefill" if mode == "prefill" \
            else spec_kind(arm) if spec else "serve_decode"
        ntok = L * len(part)
        job = Job(kind, tokens=ntok, meta={"cold": cold})
        # the same measurement under the pool's kind, for a speculative
        # tick under the arm-agnostic aggregate, and on a layout-eligible
        # tick under its layout: the inputs of the engine's arbitration,
        # arm, admission and layout decisions
        extras = [Job(pool_kind(kind, sp.lid), tokens=ntok,
                      meta={"cold": cold})]
        if spec:
            extras.append(Job("serve_spec_decode", tokens=ntok,
                              meta={"cold": cold}))
        if compact_ok:
            extras.append(Job(layout_kind(compact, sp.lid), tokens=ntok,
                              meta={"cold": cold}))
        reset = sp.reset.copy()

        def dispatch():
            if run_on is sp:
                return self._tick(sp, self.params, self.draft_params, toks,
                                  n_given, active, reset, temps, sp.gens,
                                  arm=arm)
            # the compact tick: gather the rows into the buffer set, tick
            # it (its reset rows zeroed there), write them back in place
            rows = torch.as_tensor(idx, device=self.device)
            sp.gather_into(run_on, rows)
            _, em_c, nv_c = self._tick(
                run_on, self.params, self.draft_params, toks[idx],
                n_given[idx], active[idx], reset[idx], temps[idx],
                [sp.gens[s] for s in idx], arm=arm)
            sp.scatter_from(run_on, rows)
            em = np.zeros((sp.slots, L), em_c.dtype)
            em[idx] = em_c
            nv = np.zeros((sp.slots,), np.int64)
            nv[idx] = nv_c
            return sp.pos, em, nv

        return _TickPlan(sp=sp, mode=mode, spec=spec, arm=arm, L=L,
                         part=part, n_given=n_given, idx=idx,
                         compact=compact, job=job, extras=tuple(extras),
                         dispatch=dispatch)

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
                self.engine.observe_accept(sp.lid, accepted / proposed,
                                           arm=plan.arm)
        return n_new

    def tick(self) -> bool:
        """One engine iteration.  Returns False when stopped, True otherwise
        (including idle ticks).  Control messages land here, between
        ticks.

        With one pool and the single default class the composition is
        ``Engine.choose_serve_tick``; otherwise every pool's candidate
        ticks go to ``Engine.choose_serve_job`` (weighted FRT and the
        per-class aging bounds) and one pool wins the round."""
        if self._poll():
            return False
        self._admit()
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
                self.prefill_chunk, spec_len=self.spec_len if arms else 0,
                pool_id=sp.lid, arms=arms)
        else:
            cands = self._candidates()
            if not cands:
                return True
            gid, mode = self.engine.choose_serve_job(cands)
            sp = self.pools[gid]
            act = [r for r in sp.active if r is not None]
        plan = self._plan_tick(sp, act, mode)
        if plan is None:
            return True
        outs = self.engine.run_job(plan.job, plan.dispatch,
                                   extra=plan.extras)
        n_new = self._commit_tick(plan, outs)
        self._age_prefills(plan.part)
        self.tokens_out += n_new
        self._check_breakpoints(n_new)
        self.tick_no += 1
        if self.autotuner is not None:
            # knob moves at the boundary of work ticks only: idle ticks
            # returned above, so no window accumulates empty time
            self.autotuner.on_tick()
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
