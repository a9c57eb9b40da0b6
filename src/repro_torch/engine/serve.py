"""ServeEngine: continuous batching under the Amber control plane (plain
decode arm, one slot pool, the default traffic class).

Serving runs as engine jobs over a fixed pool of *slots*, each slot holding
one request's KV cache rows at its own sequence position.  A **tick**
advances every participating slot by ``L`` positions, one batched
``lm.decode_step`` over all slots per position:

* a *prefill* slot consumes up to ``L`` prompt tokens (chunked batched
  prefill);
* a *decode* slot feeds its pending sampled token and keeps sampling on the
  device, emitting up to ``L`` new tokens per tick;
* a slot whose prompt ends mid-tick turns from prefill to decode inside the
  same tick.

Between ticks the engine polls the controller mailbox, so Pause / Inspect /
Update land at tick granularity and Inspect keeps answering while paused.
Tick *composition* (decode-only vs prefill) is the Maestro min-FRT choice
``Engine.choose_serve_tick`` over the two candidate region workflows
(``jobs.serve_tick_workflow``), costed from measured tick times.

The reference vmaps a batch-1 ``decode_step`` over its slots; here the
batch dimension is written out: ``lm.decode_step`` takes one position per
row and ``moe_groups="row"``, so every slot is its own MoE group (T=1,
``capacity(cfg, 1)``, hashed from its own position) exactly as under the
vmap, and inactive slots leave their cache rows and positions untouched.

On the card the decode step runs as a CUDA graph (``GraphedStep``),
captured once per engine on its first tick and replayed ``L`` times a
tick: the port's counterpart of the reference's one jitted tick dispatch.
A CPU pool runs the same step eagerly.

Invariants (tests/test_torch_serve.py):

* **Greedy bit-identicality** — greedy outputs equal the static
  ``BatchedServer.generate_static`` oracle token for token on batches where
  neither grouping drops an assignment.  Scheduling reorders work; it must
  never change results.
* **Reset-mask join** — a request joins a slot by flagging the row for
  zeroing at the start of the next tick instead of eager per-join writes;
  no stale cache or position state leaks between occupants of a slot.

Speculative arms, the prefix/result cache, drafts, several pools with
priority classes, device placements and hot weight updates are later
slices of the port.
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
from repro_torch.engine.engine import Engine
from repro_torch.engine.jobs import Job
from repro_torch.kernels import LAUNCHES, credit_launches, launches_since
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.runtime.serve import serving_params


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


def build_decode_step(cfg: ArchConfig, device):
    """The step a tick runs ``L`` times: one ``lm.decode_step`` over every
    slot, each slot its own MoE group (``moe_groups="row"``), then the
    greedy argmax.  It updates the caches in place and copies the advanced
    positions back into ``pos`` after every read of it, so a CUDA graph can
    capture it over the pool's own tensors.  The MoE routing plan is built
    once, here: ``decode_step`` would build one on every call."""
    n_moe = lm.n_moe_layers(cfg)
    plan = moe_lib.identity_plan(cfg, n_moe, device=device) if n_moe \
        else None

    def step(params, caches, pos, tok, active):
        """tok [B] int64, active [B] bool -> (logits [B,V] f32, argmax
        [B])."""
        logits, st = lm.decode_step(params, {"caches": caches, "pos": pos},
                                    tok[:, None], cfg, plan=plan,
                                    moe_groups="row", active=active)
        pos.copy_(st["pos"])
        return logits, torch.argmax(logits, dim=-1)

    return step


class GraphedStep:
    """A decode ``step`` captured once in a CUDA graph: the pool's own
    caches and positions, and static token and active inputs ``[B]``.  A
    call writes the token, replays the graph and returns its static logits
    ``[B,V]`` and argmax ``[B]``, which the next call overwrites.

    The graph holds the addresses of ``params``, the caches and ``pos``, so
    none of them may be replaced after capture: the port has no hot weight
    update yet, and one that replaces ``params`` must capture again.  A
    failed capture raises; there is no eager fallback on the card.  The
    kernel wrappers count their launches on the host, where a replay runs
    no wrapper: the capture records one step's counts and every replay
    credits them (``kernels.credit_launches``)."""

    def __init__(self, step, params, caches, pos):
        dev = pos.device
        b = pos.shape[0]
        self.params, self.caches, self.pos = params, caches, pos
        self.tok = torch.zeros((b,), dtype=torch.long, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        # one eager step first, on a side stream as capture wants (kernel
        # libraries loaded, cuBLAS workspaces and the gating scratch made);
        # every row is inactive, so no cache row or position moves
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(params, caches, pos, self.tok, self.active)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, self.greedy = step(params, caches, pos, self.tok,
                                            self.active)
        self.per_replay = launches_since(before)
        LAUNCHES.update(before)              # the capture launched nothing
        self.replays = 0

    def bound_to(self, params, caches, pos) -> bool:
        return params is self.params and caches is self.caches and \
            pos is self.pos

    def __call__(self, tok):
        self.tok.copy_(tok)
        self.graph.replay()
        credit_launches(self.per_replay)
        self.replays += 1
        return self.logits, self.greedy


class SlotTick:
    """The plain tick: ``L`` batched decode steps over every slot.

    Per slot: pos, tokens ``[L]``, ``n_given`` (how many are prompt/pending
    tokens — the rest are sampled on the device), active mask, reset flag,
    temperature and generator.  Emits the ``[slots, L]`` sampled tokens plus
    ``n_valid`` (L for active slots, 0 otherwise); position ``j``'s emission
    is the model's continuation after consuming token ``j``.  Inactive slots
    run (the batch is rectangular) but their cache and position updates are
    masked out.  A reset slot's cache rows and position are zeroed first,
    whether or not it takes part in this tick.  ``pos`` is advanced in
    place and returned.

    With ``graph`` (a pool on the card) the step runs as a ``GraphedStep``,
    captured on the first tick and replayed ``L`` times a tick; the reset
    zeroing, the token select between steps, sampling and the tick's one
    host copy stay outside the graph.  Without it (a CPU pool) the same
    step runs eagerly.  ``record``, when a list, receives each step's
    logits."""

    def __init__(self, cfg: ArchConfig, device, graph: bool):
        self.step = build_decode_step(cfg, device)
        self.graph = graph
        self.graphed: Optional[GraphedStep] = None
        self.record: Optional[list] = None

    @property
    def capture_pending(self) -> bool:
        return self.graph and self.graphed is None

    def _runner(self, params, caches, pos, active_t):
        if not self.graph:
            return lambda tok: self.step(params, caches, pos, tok, active_t)
        if self.graphed is None:
            self.graphed = GraphedStep(self.step, params, caches, pos)
        elif not self.graphed.bound_to(params, caches, pos):
            raise ValueError("the tick's graph was captured over other "
                             "params, caches or positions")
        self.graphed.active.copy_(active_t)
        return self.graphed

    @torch.no_grad()
    def __call__(self, params, caches, pos, toks, n_given, active, reset,
                 temps, gens):
        dev = pos.device
        if reset.any():
            rows = torch.as_tensor(np.flatnonzero(reset), device=dev)
            for leaves in caches.values():
                for c in leaves.values():
                    c[:, rows] = 0
            pos.masked_fill_(torch.as_tensor(reset, device=dev), 0)
        toks = torch.as_tensor(toks, device=dev)
        n_given_t = torch.as_tensor(n_given, device=dev)
        active_t = torch.as_tensor(active, device=dev)
        run = self._runner(params, caches, pos, active_t)
        L = toks.shape[1]
        prev = toks[:, 0]
        emitted = []
        for j in range(L):
            logits, greedy = run(torch.where(j < n_given_t, toks[:, j], prev))
            if self.record is not None:
                self.record.append(logits.clone())
            prev = sample_rows(logits, greedy, temps, gens)
            emitted.append(prev)
        n_valid = np.where(active, L, 0)
        return pos, torch.stack(emitted, 1).cpu().numpy(), n_valid


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # [plen] int32
    max_new: int
    temperature: float = 0.0
    seed: int = 0                        # private sampling stream
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1                       # slot joined (-1: queued)
    prompt_off: int = 0
    pending_tok: int = -1                # emitted but not yet fed back
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
    per block type, per-slot positions (on the device, with a host copy
    that needs no device sync), the reset mask, and per-slot sampling
    generators."""

    def __init__(self, cfg: ArchConfig, slots: int, max_len: int, device):
        self.slots = slots
        state = lm.init_cache(cfg, slots, max_len, device=device)
        self.caches = state["caches"]
        self.pos = state["pos"]
        self.pos_host = np.zeros((slots,), np.int64)
        self.reset = np.zeros((slots,), bool)
        self.gens: List[Optional[torch.Generator]] = [None] * slots
        self.active: List[Optional[Request]] = [None] * slots

    def free_slots(self) -> int:
        return sum(r is None for r in self.active)


@dataclasses.dataclass
class _TickPlan:
    """One planned tick: resolved length, participants and job record
    plus the dispatch thunk that runs it."""
    L: int
    part: List[Request]
    n_given: np.ndarray
    job: Job
    dispatch: Any


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_len: int = 128,
                 slots: int = 4, prefill_chunk: int = 16,
                 decode_chunk: int = 4, engine: Optional[Engine] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = serving_params(params, self.device)
        self.engine = engine or Engine()
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self.seed = seed
        self.pool = SlotPool(cfg, slots, max_len, self.device)
        self._tick = SlotTick(cfg, self.device,
                              graph=self.device.type == "cuda")
        # tick lengths already run once: a first run carries one-time costs
        # (kernel library builds and loads, allocator growth, the graph's
        # capture) and must not enter the cost EMAs
        self._warm: set = set()
        self.queue: Deque[Request] = deque()
        self.tick_no = 0
        self.tokens_out = 0
        self._rid = itertools.count()
        self.hit_breakpoints: List[str] = []

    # ------------------------------------------------------------- requests
    def submit(self, prompt, max_new: int = 16, temperature: float = 0.0,
               seed: Optional[int] = None) -> Request:
        """Queue a request.  ``seed`` pins the request's private sampling
        stream; the default derives one from the engine seed and the
        request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        need = prompt.size + max_new + max(self.prefill_chunk,
                                           self.decode_chunk)
        if need > self.max_len:
            raise ValueError(f"prompt+max_new+chunk={need} exceeds "
                             f"max_len={self.max_len}")
        rid = next(self._rid)
        req = Request(rid, prompt, max_new, temperature,
                      seed=_stream_seed(self.seed, rid) if seed is None
                      else seed,
                      t_submit=time.perf_counter())
        self.queue.append(req)
        return req

    def _evict(self, req: Request) -> None:
        self.pool.active[req.slot] = None
        self.pool.gens[req.slot] = None
        req.slot = -1
        req.t_done = time.perf_counter()
        req.done.set()

    def _admit(self) -> None:
        """Join queued requests into free slots, in order.  The cache-row
        zeroing and position reset are deferred into the next tick (the
        ``reset`` mask); only the slot's sampling generator is set here."""
        sp = self.pool
        while self.queue and sp.free_slots():
            req = self.queue.popleft()
            slot = next(s for s in range(sp.slots) if sp.active[s] is None)
            req.slot = slot
            sp.active[slot] = req
            sp.reset[slot] = True
            sp.pos_host[slot] = 0
            if req.temperature > 0:
                sp.gens[slot] = torch.Generator(
                    device=self.device).manual_seed(req.seed)

    # -------------------------------------------------------------- control
    def _inspect(self, what: str) -> Dict[str, Any]:
        return {"tick": self.tick_no, "queue_depth": len(self.queue),
                "tokens_out": self.tokens_out,
                "paused": self.engine.controller.paused,
                "decisions": list(self.engine.decisions),
                "slots": [None if r is None else
                          {"rid": r.rid, "prompt_off": r.prompt_off,
                           "plen": len(r.prompt), "out": len(r.tokens),
                           "max_new": r.max_new}
                          for r in self.pool.active],
                "knobs": {"prefill_chunk": self.prefill_chunk,
                          "decode_chunk": self.decode_chunk},
                "engine": self.engine.inspect()}

    def _apply_updates(self, updates: Dict[str, Any]) -> None:
        # knobs only: the tick's graph holds ``self.params`` and the pool's
        # tensors, so an update that replaces them must capture again
        if "max_prefill_defer" in updates:
            self.engine.max_prefill_defer = int(updates["max_prefill_defer"])
        if "decode_chunk" in updates:
            self.decode_chunk = int(updates["decode_chunk"])
        if "prefill_chunk" in updates:
            self.prefill_chunk = int(updates["prefill_chunk"])

    def _poll(self) -> bool:
        r = self.engine.poll(self.tick_no, 0, self._inspect)
        self._apply_updates(r["updates"])
        return r["stopped"]

    def _check_breakpoints(self, emitted: int) -> None:
        m = {"emitted": float(emitted), "queue": float(len(self.queue)),
             "active": float(sum(r is not None for r in self.pool.active)),
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
    def _tick_len(self, act: List[Request], mode: str, chunk: int) -> int:
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
            cap = min(cap, self.max_len - int(self.pool.pos_host[r.slot]))
        L = 1
        while L < need:
            L *= 2
        L = min(L, chunk)
        while L > max(cap, 1):
            L //= 2
        return L

    def _plan_tick(self, act: List[Request], mode: str) -> Optional[_TickPlan]:
        """Resolve the tick length, participants and job records, and close
        over the dispatch thunk."""
        sp = self.pool
        chunk = self.prefill_chunk if mode == "prefill" else self.decode_chunk
        L = self._tick_len(act, mode, chunk)
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
        cold = L not in self._warm or self._tick.capture_pending
        self._warm.add(L)
        kind = "serve_prefill" if mode == "prefill" else "serve_decode"
        ntok = L * len(part)
        job = Job(kind, tokens=ntok, meta={"cold": cold})
        reset = sp.reset.copy()

        def dispatch():
            return self._tick(self.params, sp.caches, sp.pos, toks, n_given,
                              active, reset, temps, sp.gens)

        return _TickPlan(L=L, part=part, n_given=n_given, job=job,
                         dispatch=dispatch)

    def _commit_tick(self, plan: _TickPlan, outs) -> int:
        """Write a tick's results back: positions (device and host view),
        token commits and evictions.  Returns the new tokens emitted."""
        sp, L, part, n_given = self.pool, plan.L, plan.part, plan.n_given
        sp.pos, em, nv = outs
        sp.reset[:] = False                  # zeroing landed in the tick
        sp.pos_host += nv
        n_new = 0
        now = time.perf_counter()
        for r in part:
            s, g = r.slot, int(n_given[r.slot])
            if r.prefilling:
                r.prompt_off += g
                if r.prefilling:
                    continue                  # prompt continues next tick
            need = r.max_new - len(r.tokens)
            outs_r = em[s, g - 1:L][:need]
            if outs_r.size and r.t_first is None:
                r.t_first = now               # first-token latency mark
            r.tokens.extend(int(t) for t in outs_r)
            n_new += len(outs_r)
            if len(r.tokens) >= r.max_new:
                self._evict(r)
            else:
                r.pending_tok = int(em[s, L - 1])
        return n_new

    def tick(self) -> bool:
        """One engine iteration.  Returns False when stopped, True otherwise
        (including idle ticks).  Control messages land here, between
        ticks."""
        if self._poll():
            return False
        self._admit()
        act = [r for r in self.pool.active if r is not None]
        if not act:
            return True
        n_pre = sum(r.prefilling for r in act)
        pre_toks = sum(len(r.prompt) - r.prompt_off
                       for r in act if r.prefilling)
        mode = self.engine.choose_serve_tick(
            len(act) - n_pre, n_pre, pre_toks, self.decode_chunk,
            self.prefill_chunk, spec_len=0, arms=())
        plan = self._plan_tick(act, mode)
        if plan is None:
            return True
        outs = self.engine.run_job(plan.job, plan.dispatch)
        n_new = self._commit_tick(plan, outs)
        self.tokens_out += n_new
        self._check_breakpoints(n_new)
        self.tick_no += 1
        return True

    # ----------------------------------------------------------- convenience
    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.tick():
                return
            if not self.queue and all(r is None for r in self.pool.active):
                return
        raise RuntimeError("serve engine did not drain within max_ticks")

    def generate(self, prompts, max_new: int = 16, temperature: float = 0.0,
                 seed: Optional[int] = None) -> np.ndarray:
        """Batch convenience: prompts (rectangular, or a list of mixed
        lengths) in, ``[B, max_new]`` tokens out.  ``seed`` pins every
        request's sampling stream, so repeated calls reproduce."""
        reqs = [self.submit(p, max_new, temperature,
                            seed=None if seed is None
                            else _stream_seed(seed, i))
                for i, p in enumerate(prompts)]
        self.run_until_done()
        return np.stack([r.output() for r in reqs])


def _stream_seed(base: int, i: int) -> int:
    """A request's sampling seed from a base seed and its index."""
    return (int(base) * 0x9E3779B1 + int(i)) & 0xFFFFFFFFFFFF
