"""The Engine: one Amber-style executor under training *and* serving.

The engine owns the control plane — the :class:`Controller` mailbox, the
durable control-replay log, and the registered breakpoints — and runs *jobs*
(train step, serve prefill, serve decode batch, checkpoint) expressed as
Maestro region workflows (``engine.jobs``).  Every job it runs is timed and
fed back into a :class:`CostBook`, so the scheduling decisions are made
against measured costs:

* ``choose_step_path`` — fused vs granulated training step.  When any
  interactivity is live (pending or replaying message, registered
  breakpoint, paused) the granulated path is *required* (messages must land
  at their per-microbatch points); otherwise the engine scores both job
  workflows under the ``completion`` objective and takes the cheaper one.
  This subsumes the earlier ``auto`` heuristic: the heuristic's answer falls
  out of the cost model instead of being hard-coded.
* ``choose_serve_tick`` — decode-only vs prefill tick composition for the
  serving engine: min first-response-time with an aging bound so prefills
  cannot starve (§4.5's min-FRT objective applied online).  When the
  serving engine offers the speculative arm, the decode choice further
  splits into plain vs speculative k-token ticks, decided from the pool's
  measured acceptance-rate EMA — acceptance is exactly the kind of
  measured, result-aware signal the CostBook exists for.
* ``choose_serve_job`` — the multi-pool generalization: N slot pools × K
  priority classes offer candidate ticks (``jobs.TickCandidate``) and the
  engine picks ONE (pool, composition) per round under weighted FRT —
  each candidate's ``serve_tick_workflow`` is costed with the pool's own
  measured per-token EMA (the parallelism term: a faster pool shows a
  lower measured time) and its FRT is divided by the summed
  priority-class weight of the requests it advances.  Per-class aging
  bounds hard-override the scores: a candidate carrying a request past
  its class's ``max_defer`` evicts every non-aged candidate from the
  round, so low-priority prefills cannot starve under a saturating
  high-priority stream.

Workers (``TrainLoop``, ``ServeEngine``) are engine *clients*: they hand the
engine their inspect callback and their job thunks and let it decide.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.breakpoints import GlobalCountBreakpoint, LocalBreakpoint
from repro_torch.core.controller import Controller
from repro_torch.core.estimator import CostBook
from repro_torch.core.scheduler import (CostModel, compare_frt, completion_time,
                                  first_response_time,
                                  placement_adjusted_frt,
                                  weighted_first_response_time)
from repro_torch.engine import jobs as J


class Engine:
    def __init__(self, controller: Optional[Controller] = None,
                 durable_log: Optional[str] = None,
                 max_prefill_defer: int = 4):
        self.controller = controller or Controller()
        if durable_log is not None and self.controller.durable_log_path is None:
            self.controller.attach_durable_log(durable_log)
        self.costs = CostBook()
        self.local_bps: List[Any] = []
        self.global_bps: List[Any] = []
        # decision telemetry ring buffer: every choose_* call appends
        # (decision kind, chosen arm, per-arm scores, and the CostBook
        # inputs the scores were computed from).  Bounded so a long-running
        # engine cannot grow without bound; surfaced through inspect() and
        # ServeEngine._inspect()["decisions"] — the explainability
        # substrate.
        self.decisions: Deque[Dict[str, Any]] = deque(maxlen=512)
        self.jobs_run: Dict[str, int] = {}
        self.max_prefill_defer = max_prefill_defer
        self._prefill_defer = 0
        self._dispatch_rounds: Dict[int, int] = {}
        self._serve_rounds: Dict[int, int] = {}
        self._seed_rounds: Dict[int, int] = {}
        self._compact_rounds: Dict[int, int] = {}
        self._knob_rounds: Dict[str, int] = {}
        self._cm = CostModel(parallelism=1.0)

    # ---------------------------------------------------------- control plane
    def poll(self, step: int, microbatch: int,
             inspect_fn: Optional[Callable[[str], Any]] = None
             ) -> Dict[str, Any]:
        r = self.controller.poll(step, microbatch, inspect_fn)
        # breakpoint registrations live on the engine, not the worker
        for bp in self.controller.breakpoints:
            if isinstance(bp, GlobalCountBreakpoint):
                self.global_bps.append(bp)
            elif isinstance(bp, LocalBreakpoint):
                self.local_bps.append(bp)
        self.controller.breakpoints = []
        return r

    def interactive(self) -> bool:
        """Any live control demand that requires mid-step granularity."""
        c = self.controller
        return (c.paused or c.stopped or not c.mailbox.empty()
                or bool(self.local_bps) or bool(self.global_bps)
                or c.is_replaying())

    # ----------------------------------------------------------------- jobs
    def run_job(self, job: J.Job, fn: Callable[[], Any],
                extra: tuple = ()) -> Any:
        """Execute a job thunk, feed its measured runtime back into the cost
        book (per token when the job reports a token count, else per job).
        ``extra`` jobs record the same duration under additional kinds —
        e.g. a train step also measured as a dispatch-impl sample."""
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        self.observe(job, dt)
        for j in extra:
            self.observe(j, dt)
        return out

    def observe(self, job: J.Job, seconds: float) -> None:
        self.jobs_run[job.kind] = self.jobs_run.get(job.kind, 0) + 1
        if self.jobs_run[job.kind] == 1 or (job.meta or {}).get("cold"):
            return          # compile-carrying runs (first per kind, or a
            #                 shape the client knows is freshly specialized)
            #                 must not enter the EMA — a compile-inflated
            #                 cost would wedge the decisions
        self.costs.observe(job.kind, seconds)
        if job.tokens:
            self.costs.observe(job.kind + "_per_tok", seconds / job.tokens)

    def observe_accept(self, pool_id: int, frac: float,
                       arm: str = "ngram") -> None:
        """Feed one speculative tick's acceptance fraction (committed drafts
        / proposed drafts) into the pool's per-arm acceptance-rate EMA.
        Unlike job runtimes there is no compile-warm-up to skip — the first
        tick's acceptance is as real as the hundredth's — so this writes
        straight to the CostBook."""
        self.costs.observe_rate(J.accept_kind(pool_id, arm), frac)

    def _decide(self, kind: str, choice: str, **detail) -> str:
        # the deque's maxlen bounds the audit trail; every entry carries the
        # choice plus whatever scores/inputs the caller passed
        self.decisions.append({"decision": kind, "choice": choice, **detail})
        return choice

    def inspect(self) -> Dict[str, Any]:
        """Engine-level state for Inspect replies."""
        return {"costs": self.costs.snapshot(),
                "jobs_run": dict(self.jobs_run),
                "decisions_tail": list(self.decisions)[-5:],
                "breakpoints": len(self.local_bps) + len(self.global_bps)}

    # ------------------------------------------------------------- decisions
    def choose_step_path(self, forced: str = "auto", n_mb: int = 1) -> str:
        """Fused vs granulated training step (see module docstring)."""
        if forced in ("fused", "granulated"):
            return forced
        if self.interactive():
            # correctness, and also min-FRT: the control sink's first
            # response leaves after one microbatch on the granulated path
            return self._decide("step_path", "granulated",
                                why="interactive")
        t_f = self.costs.estimate("train_step_fused")
        if t_f is None:
            # explore before exploiting: granulated gets measured whenever
            # interactivity forces it, so an unmeasured fused path would
            # otherwise never get a second chance against a measured rival
            return self._decide("step_path", "fused", why="bootstrap")
        t_g = self.costs.estimate("train_step_granulated",
                                  J.COST_DEFAULTS["train_step_granulated"])
        scores = {}
        for path, t_step in (("fused", t_f), ("granulated", t_g)):
            wf = J.train_step_workflow(path, n_mb, t_step / max(n_mb, 1),
                                       t_apply=0.0)
            scores[path] = completion_time(wf, self._cm)
        best = min(scores, key=scores.get)
        return self._decide("step_path", best, scores=scores)

    def choose_dispatch_impl(self, tokens: int, forced: str = "auto") -> str:
        """Fused vs argsort MoE dispatch kernel, per shape (the step's
        adaptive path choice extended from loop granularity down to kernel
        choice).  Both impls run as alternative step workflows: the client
        tags each step it executes with a ``dispatch_kind`` job, so the
        CostBook accumulates a measured EMA per (impl, token-count) pair.
        Bootstrap explores fused first, then the XLA arm, then scores the
        two ``moe_dispatch_workflow`` candidates under ``completion_time``
        — the same objective the step-path decision uses.  (Each arm needs
        two runs before it is measured: the first carries the fresh jit
        specialization and is skipped by ``observe``.)"""
        if forced in ("fused", "xla"):
            return forced
        t_f = self.costs.estimate(J.dispatch_kind("fused", tokens))
        if t_f is None:
            return self._decide("dispatch_impl", "fused", why="bootstrap",
                                tokens=tokens)
        t_x = self.costs.estimate(J.dispatch_kind("xla", tokens))
        if t_x is None:
            return self._decide("dispatch_impl", "xla", why="explore",
                                tokens=tokens)
        scores = {}
        for impl, t_step in (("fused", t_f), ("xla", t_x)):
            wf = J.moe_dispatch_workflow(impl, tokens, t_step)
            scores[impl] = completion_time(wf, self._cm)
        best = min(scores, key=scores.get)
        # periodic re-explore: only the chosen impl runs (and refreshes its
        # EMA), so without this a stale or noise-poisoned measurement of
        # the loser would wedge the choice forever
        self._dispatch_rounds[tokens] = \
            self._dispatch_rounds.get(tokens, 0) + 1
        if self._dispatch_rounds[tokens] % 16 == 0:
            loser = "xla" if best == "fused" else "fused"
            return self._decide("dispatch_impl", loser, why="re-explore",
                                tokens=tokens, scores=scores)
        return self._decide("dispatch_impl", best, tokens=tokens,
                            scores=scores)

    def choose_serve_tick(self, decode_slots: int, prefill_slots: int,
                          prefill_tokens: int, decode_chunk: int,
                          prefill_chunk: int, spec_len: int = 0,
                          pool_id: int = 0,
                          arms: Tuple[str, ...] = ("ngram",)) -> str:
        """Tick composition: 'decode' (short, decode-state slots only),
        'prefill' (long, every active slot advances a prefill_chunk), or —
        when the serving engine offers it (``spec_len > 1``) — a speculative
        k-token decode arm ``spec:<proposer>`` from ``arms``.  The
        decode-vs-prefill choice is min-FRT with an aging bound; the
        plain-vs-spec-vs-spec split is a separate throughput decision over
        measured per-arm acceptance (``_choose_decode_arm``) taken only once
        a decode-composition tick has won."""
        if prefill_slots == 0:
            return self._choose_decode_arm(decode_slots, decode_chunk,
                                           spec_len, pool_id, arms)
        if decode_slots == 0:
            self._prefill_defer = 0
            return self._decide("serve_tick", "prefill", why="no_decoders")
        if self._prefill_defer >= self.max_prefill_defer:
            self._prefill_defer = 0
            return self._decide("serve_tick", "prefill", why="aging")
        t_tok = self.costs.estimate(
            "serve_decode_per_tok",
            self.costs.estimate(
                "serve_spec_decode_per_tok",
                self.costs.estimate("serve_prefill_per_tok", 1e-3)))
        chunk_now = min(prefill_tokens, prefill_chunk * prefill_slots)
        wf_d = J.serve_tick_workflow(decode_slots, decode_chunk, 0, t_tok)
        wf_p = J.serve_tick_workflow(decode_slots, prefill_chunk,
                                     chunk_now, t_tok)
        frt_d = first_response_time(wf_d, frozenset(), self._cm)
        frt_p = first_response_time(wf_p, frozenset(), self._cm)
        if frt_d <= frt_p:
            self._prefill_defer += 1
            self._decide("serve_tick", "decode",
                         frt={"decode": frt_d, "prefill": frt_p},
                         inputs={"t_tok": t_tok},
                         defer=self._prefill_defer)
            return self._choose_decode_arm(decode_slots, decode_chunk,
                                           spec_len, pool_id, arms)
        self._prefill_defer = 0
        return self._decide("serve_tick", "prefill",
                            frt={"decode": frt_d, "prefill": frt_p},
                            inputs={"t_tok": t_tok})

    def _pool_t_tok(self, pool_id: int) -> float:
        """Per-token tick cost for one pool: the pool's own measured EMAs
        first (``jobs.pool_kind`` — the weighted-FRT parallelism term), the
        fleet-wide EMAs as bootstrap for a pool that has not ticked yet,
        then the static prior."""
        tick_kinds = ("serve_decode", "serve_spec_decode:ngram",
                      "serve_spec_decode:draft", "serve_spec_decode",
                      "serve_prefill")
        chain = [J.pool_kind(k, pool_id) + "_per_tok" for k in tick_kinds]
        chain += [k + "_per_tok" for k in tick_kinds]
        return self.costs.estimate_first(chain, 1e-3)

    def choose_serve_job(self, cands: List[J.TickCandidate]
                         ) -> tuple[int, str]:
        """Pick the next tick across every slot pool: the Maestro decision
        over ``jobs.serve_tick_workflow`` candidates under weighted FRT.

        Each candidate is scored as the FRT of its tick workflow — costed
        with the candidate pool's measured per-token EMA — divided by its
        summed priority-class weight (``scheduler.weighted_first_response_time``),
        and the minimum wins.  Aged candidates (a participant past its
        class's ``max_defer``) pre-empt the scoring entirely: when any
        exist, only they are scored, so the aging bound is a hard
        guarantee, not a weight the arbitration could trade away.  A
        winning decode candidate that offers the speculative arm then runs
        the per-pool plain-vs-spec decision (``_choose_decode_arm``).

        Returns ``(pool_id, mode)`` with mode one of
        ``decode | prefill | spec``."""
        assert cands, "choose_serve_job needs at least one candidate"
        aged = [c for c in cands if c.aged]
        if aged:
            # several pools aged in the same round: the executor is serial,
            # so serve the most-overdue bound first (ties fall through to
            # the weighted scoring below)
            worst = max(c.overdue for c in aged)
            aged = [c for c in aged if c.overdue == worst]
        pool_scores: Dict[str, float] = {}
        best, best_score = None, float("inf")
        for c in (aged or cands):
            t_tok = self._pool_t_tok(c.pool_id)
            chunk_now = min(c.pre_toks, c.chunk * max(c.n_pre, 1)) \
                if c.mode == "prefill" else 0
            wf = J.serve_tick_workflow(c.n_dec, c.chunk, chunk_now, t_tok)
            frt = first_response_time(wf, frozenset(), self._cm)
            # placement terms: device-group contention inflates the FRT, a
            # pending migration headed at the pool adds the transfer the
            # tick must wait behind.  Both are zero for unplaced pools, so
            # this reduces exactly to weighted_first_response_time there.
            s = placement_adjusted_frt(frt, c.weight, c.load, c.xfer)
            pool_scores[f"{c.mode}@p{c.pool_id}"] = s
            if s < best_score:
                best, best_score = c, s
        self._decide("serve_job", f"{best.mode}@p{best.pool_id}",
                     scores=pool_scores, aged=bool(aged))
        if best.mode == "decode" and best.spec_len > 1:
            return best.pool_id, self._choose_decode_arm(
                best.n_dec, best.chunk, best.spec_len, best.pool_id,
                best.arms or ("ngram",))
        return best.pool_id, best.mode

    def choose_admission_pool(self, opts: List[dict]) -> int:
        """Placement-aware admission: pick which device-placed pool a newly
        admitted request's slot lives on.  Each option is
        ``{"pool": local_id, "free": int, "busy": float, "devices": int}``;
        the score is the pool's measured per-token EMA inflated by its
        device-group occupancy (``t_tok * (busy + 1)``) — the expected time
        the new slot waits per token on that hardware — so a fast idle pool
        beats a fast contended one, and a pool whose devices are shared
        beats nothing for free.  Ties break on free slots (desc) then pool
        id (asc), which reduces to the legacy most-free rule when no EMAs
        separate the pools yet."""
        assert opts, "choose_admission_pool needs at least one option"
        scores = {}
        best, best_key = None, None
        for o in opts:
            t_tok = self._pool_t_tok(o["pool"])
            s = t_tok * (max(o.get("busy", 0.0), 0.0) + 1.0)
            scores[f"p{o['pool']}"] = s
            key = (s, -o.get("free", 0), o["pool"])
            if best_key is None or key < best_key:
                best, best_key = o["pool"], key
        self._decide("admission_pool", f"p{best}", scores=scores)
        return best

    def choose_migration_dst(self, opts: List[dict]) -> int:
        """Where a draining pool's in-flight slots land: the same
        occupancy-inflated per-token score as admission, plus the measured
        per-row migration cost (``serve_migrate`` EMA) of moving INTO the
        candidate — a destination on the source's own devices copies for
        near-free, a cross-mesh one pays the transfer."""
        assert opts, "choose_migration_dst needs at least one option"
        scores = {}
        best, best_key = None, None
        for o in opts:
            t_tok = self._pool_t_tok(o["pool"])
            t_mig = self.costs.estimate_first(
                [J.pool_kind("serve_migrate", o["pool"]), "serve_migrate"],
                J.COST_DEFAULTS["serve_migrate"])
            s = t_tok * (max(o.get("busy", 0.0), 0.0) + 1.0) \
                + t_mig / max(o.get("free", 1), 1)
            scores[f"p{o['pool']}"] = s
            key = (s, -o.get("free", 0), o["pool"])
            if best_key is None or key < best_key:
                best, best_key = o["pool"], key
        self._decide("migration_dst", f"p{best}", scores=scores)
        return best

    def choose_prefix_admission(self, cached_tokens: int,
                                suffix_tokens: int,
                                pool_id: int = 0) -> str:
        """Reuse a cached prefix snapshot or recompute the prefill — the
        result-aware admission decision (returns ``"seed"`` or
        ``"prefill"``).

        Both alternatives are priced as region workflows under min-FRT
        (``scheduler.compare_frt``): ``jobs.prefix_seed_workflow`` pays one
        cache-row copy (the pool's measured ``serve_seed`` EMA — constant
        in the prefix length) plus the unshared suffix at the pool's
        per-token prefill EMA; ``jobs.prefill_workflow`` pays every prompt
        token.  "Copy what we already know" therefore wins exactly when the
        copy is cheaper than recomputing the cached tokens *on this pool's
        measured hardware*, not by assumption.  Bootstrap explores the seed
        arm (the only way its copy cost gets measured), and when prefill
        keeps winning the seed arm is re-explored every 16th decision so a
        stale or compile-poisoned copy EMA cannot wedge reuse off forever.
        """
        assert cached_tokens > 0 and suffix_tokens > 0
        t_seed = self.costs.estimate_first(
            [J.pool_kind("serve_seed", pool_id), "serve_seed"])
        if t_seed is None:
            return self._decide("prefix_admission", "seed", why="bootstrap",
                                pool=pool_id, cached=cached_tokens)
        t_tok = self.costs.estimate_first(
            [J.pool_kind("serve_prefill", pool_id) + "_per_tok",
             "serve_prefill_per_tok"], 1e-3)
        best, scores = compare_frt(
            {"seed": J.prefix_seed_workflow(cached_tokens, suffix_tokens,
                                            t_seed, t_tok),
             "prefill": J.prefill_workflow(cached_tokens + suffix_tokens,
                                           t_tok)}, self._cm)
        self._seed_rounds[pool_id] = self._seed_rounds.get(pool_id, 0) + 1
        if best == "prefill" and self._seed_rounds[pool_id] % 16 == 0:
            return self._decide("prefix_admission", "seed",
                                why="re-explore", pool=pool_id,
                                cached=cached_tokens, scores=scores)
        return self._decide("prefix_admission", best, pool=pool_id,
                            cached=cached_tokens, suffix=suffix_tokens,
                            scores=scores)

    def _choose_decode_arm(self, decode_slots: int, decode_chunk: int,
                           spec_len: int, pool_id: int,
                           arms: Tuple[str, ...] = ("ngram",)) -> str:
        """The decode arm family, per slot pool: plain multi-token decode vs
        one speculative arm per offered proposer (``spec:ngram``,
        ``spec:draft``, ...).

        Every arm is scored as a ``jobs.serve_decode_workflow`` region
        workflow under ``completion_time``, normalized by the tokens a tick
        is *expected to commit*: ``decode_chunk`` for the plain arm (every
        scan step commits a token), ``1 + a·(spec_len-1)`` for a speculative
        arm, with ``a`` that arm's measured per-pool acceptance-rate EMA
        (``jobs.accept_kind(pool_id, arm)``) and its verify-tick cost that
        arm's own runtime EMA (``jobs.spec_kind(arm)``) — the draft arm pays
        the draft model's propose scan inside the dispatch, so its per-step
        cost is measured higher and only its higher acceptance can win the
        score back.  Each speculative arm is bootstrap-explored until both
        its EMAs exist (acceptance can only be measured by running the arm);
        afterwards the losing arms rotate through a re-explore slot every
        16th round so a stale acceptance or runtime EMA cannot wedge the
        choice — workloads drift between repetitive and incompressible
        text, and a draft republish changes acceptance mid-stream."""
        if spec_len <= 1 or not arms:
            return "decode"
        per: Dict[str, tuple] = {}
        for arm in arms:
            a = self.costs.estimate(J.accept_kind(pool_id, arm))
            t_s = self.costs.estimate(J.spec_kind(arm) + "_per_tok")
            if a is None or t_s is None:
                return self._decide("serve_decode_arm", f"spec:{arm}",
                                    why="bootstrap", pool=pool_id)
            per[arm] = (a, t_s)
        t_p = self.costs.estimate("serve_decode_per_tok")
        if t_p is None:
            return self._decide("serve_decode_arm", "decode", why="explore",
                                pool=pool_id)
        inputs: Dict[str, float] = {"t_plain": t_p}
        scores = {"decode": completion_time(
            J.serve_decode_workflow("plain", decode_slots, decode_chunk,
                                    t_p), self._cm) / max(decode_chunk, 1)}
        for arm, (a, t_s) in per.items():
            wf = J.serve_decode_workflow("spec", decode_slots, spec_len,
                                         t_s, accept=a)
            scores[f"spec:{arm}"] = completion_time(wf, self._cm) / max(
                1.0 + a * (spec_len - 1), 1e-9)
            inputs[f"accept:{arm}"] = a
            inputs[f"t_spec:{arm}"] = t_s
        best = min(scores, key=scores.get)
        self._serve_rounds[pool_id] = self._serve_rounds.get(pool_id, 0) + 1
        r = self._serve_rounds[pool_id]
        if r % 16 == 0:
            # rotate through the losers so every arm's EMAs stay fresh even
            # with 3+ arms in the family
            losers = sorted(k for k in scores if k != best)
            loser = losers[(r // 16 - 1) % len(losers)]
            return self._decide("serve_decode_arm", loser, why="re-explore",
                                pool=pool_id, scores=scores, inputs=inputs)
        return self._decide("serve_decode_arm", best, pool=pool_id,
                            scores=scores, inputs=inputs)

    def choose_knob(self, name: str, values: Tuple[Any, ...]) -> Any:
        """Pick the next arm for one tuned engine knob (autotune's
        meta-decision): the same bootstrap → exploit → re-explore
        discipline every other choice here follows, over the windowed
        cost-per-token EMAs the AutoTuner records under
        ``jobs.knob_kind(name, value)``.

        Bootstrap visits every unmeasured arm in listed order (a knob
        value's cost can only be learned by living under it for a
        window); once all arms carry an EMA the cheapest wins; and every
        16th round the losers rotate through a re-explore slot — knob
        costs are workload-dependent, so a value that lost under
        yesterday's traffic must keep getting re-measured under today's.
        The chosen arm lands in the decision deque like every ``choose_*``
        call, so ``dump_decisions`` explains knob moves with the same
        scores/inputs schema."""
        assert values, f"knob {name} offers no values"
        scores: Dict[str, float] = {}
        for v in values:
            t = self.costs.estimate(J.knob_kind(name, v))
            if t is None:
                self._decide("autotune_knob", str(v), knob=name,
                             why="bootstrap")
                return v
            scores[str(v)] = t
        best = min(scores, key=scores.get)
        self._knob_rounds[name] = self._knob_rounds.get(name, 0) + 1
        r = self._knob_rounds[name]
        if r % 16 == 0 and len(values) > 1:
            losers = sorted(k for k in scores if k != best)
            loser = losers[(r // 16 - 1) % len(losers)]
            self._decide("autotune_knob", loser, knob=name,
                         why="re-explore", scores=scores, inputs=scores)
            return next(v for v in values if str(v) == loser)
        self._decide("autotune_knob", best, knob=name, scores=scores,
                     inputs=scores)
        return next(v for v in values if str(v) == best)

    def choose_compact(self, pool_id: int) -> bool:
        """Compact vs full batch layout for an eligible decode tick (at
        least half the pool sitting out), per slot pool — the promotion of
        the old default-off ``compact_decode`` flag to a measured CostBook
        arm.

        Both layouts advance the same participants by the same chunk, so
        the cheaper *measured per-token tick time* (``jobs.layout_kind``,
        recorded only on eligible ticks so both EMAs cover the same
        occupancy regime) wins directly — no workflow shape differs between
        them.  Bootstrap explores compact first (the gather/scatter cost
        can only be measured by running it), then full, and the losing
        layout is re-explored every 16th eligible tick so a drifting
        machine or pool shape cannot wedge the choice.  The config override
        (``ServeEngine(compact_decode=True/False)``) bypasses this decision
        entirely."""
        t_c = self.costs.estimate(J.layout_kind(True, pool_id) + "_per_tok")
        if t_c is None:
            return self._decide("serve_compact", "compact", why="bootstrap",
                                pool=pool_id) == "compact"
        t_f = self.costs.estimate(J.layout_kind(False, pool_id) + "_per_tok")
        if t_f is None:
            return self._decide("serve_compact", "full", why="explore",
                                pool=pool_id) == "compact"
        scores = {"compact": t_c, "full": t_f}
        best = min(scores, key=scores.get)
        self._compact_rounds[pool_id] = \
            self._compact_rounds.get(pool_id, 0) + 1
        if self._compact_rounds[pool_id] % 16 == 0:
            loser = "full" if best == "compact" else "compact"
            return self._decide("serve_compact", loser, why="re-explore",
                                pool=pool_id, scores=scores,
                                inputs=scores) == "compact"
        return self._decide("serve_compact", best, pool=pool_id,
                            scores=scores, inputs=scores) == "compact"
