"""Scenario-diverse workload generation + the virtual-time drive harness.

A copy of the JAX package's ``engine/loadgen.py`` (it imports no JAX):
every decision surface the engine has — priority arbitration, prefix
admission, the spec-arm family, compact decode — needs more than a
single-scenario smoke bench.  Benchmark-
suite work on big-data frameworks (BigBench on Hive/Spark; the Inoubli et
al. experimental survey) shows single-workload evaluation systematically
hides tail-latency and adaptivity failures; this module is the diverse,
parameterized workload source that exposes them.

Three layers, all seeded and deterministic:

* **Samplers** — arrival processes (Poisson, bursty, diurnal ramp,
  closed), heavy-tail length distributions (bounded Pareto), priority
  mixes, and prompt populations (disjoint vs shared-preamble, the latter
  exercising the prefix cache).
* **Scenarios** — a :class:`ScenarioSpec` composes samplers into a named
  workload; :data:`SCENARIOS` registers the gauntlet's families, including
  the adversarial ones (priority starvation, chunk thrash, hot-swap
  storm).  ``generate(spec, seed)`` expands a spec into a concrete request
  stream; the same (spec, seed) always yields the identical stream — the
  replay property the property tests pin.
* **Drive harness** — :func:`drive` plays a stream against a live
  :class:`~repro_torch.engine.serve.ServeEngine` under **virtual time**: the
  clock is the engine's tick count, arrivals due at virtual tick ``t``
  are submitted before tick ``t`` runs, and idle gaps fast-forward to the
  next arrival instead of burning empty ticks.  TTFT/completion are
  recorded in virtual ticks (scheduling quality, host-speed independent)
  alongside the engine's own wall-clock marks.

The grading vocabulary (``percentile``, :class:`ServeSLO`, ``grade_slo``)
lives in :mod:`repro_torch.core.scheduler` with the other scoring primitives;
``summarize`` here produces the metrics dict those graders consume.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler import ServeSLO, percentile

__all__ = [
    "GenRequest", "ScenarioSpec", "SCENARIOS", "scenario", "generate",
    "arrival_offsets", "drive", "DriveResult", "summarize",
    "poisson_arrivals", "bursty_arrivals", "diurnal_arrivals",
    "closed_arrivals", "heavy_tail_lengths", "uniform_lengths",
]


# ------------------------------------------------------------------ stream

@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One generated request: ``at`` is its arrival in virtual ticks.
    ``prompt`` is a tuple (hashable → usable as an oracle memo key)."""
    at: int
    prompt: Tuple[int, ...]
    max_new: int
    priority: str = "default"
    temperature: float = 0.0


# ---------------------------------------------------------------- arrivals
# Every sampler takes a ``numpy.random.Generator`` and returns ``n`` sorted
# integer virtual-tick offsets starting at 0.  Rates are requests/tick.

def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate: float) -> np.ndarray:
    """Memoryless arrivals: exponential inter-arrival gaps at ``rate``
    requests per virtual tick, floored onto the tick grid."""
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def bursty_arrivals(rng: np.random.Generator, n: int, burst: int,
                    gap: float) -> np.ndarray:
    """Bursts of ``burst`` simultaneous arrivals, burst starts separated
    by exponential gaps of mean ``gap`` ticks — the overload pattern: each
    burst lands as one queue spike the admission path must absorb."""
    n_bursts = -(-n // burst)
    starts = np.floor(np.cumsum(
        rng.exponential(max(gap, 1e-9), size=n_bursts))).astype(np.int64)
    return np.repeat(starts, burst)[:n]


def diurnal_arrivals(rng: np.random.Generator, n: int, period: float,
                     peak_rate: float, trough_rate: float) -> np.ndarray:
    """Diurnal ramp: a non-homogeneous Poisson process whose rate swings
    sinusoidally between ``trough_rate`` and ``peak_rate`` over ``period``
    ticks, sampled by thinning against the peak rate.  Exercises the
    adaptivity story: EMAs tuned during the trough meet the peak."""
    lo, hi = min(trough_rate, peak_rate), max(trough_rate, peak_rate)
    out, t = [], 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / max(hi, 1e-9))
        lam = lo + (hi - lo) * 0.5 * (1 + np.sin(2 * np.pi * t / period))
        if rng.random() < lam / hi:
            out.append(int(t))
    return np.asarray(out[:n], np.int64)


def closed_arrivals(rng: np.random.Generator, n: int) -> np.ndarray:
    """Closed-loop: everything arrives at tick 0 (the classic drain-a-
    batch workload every pre-gauntlet bench measured)."""
    return np.zeros(n, np.int64)


_ARRIVALS: Dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
    "closed": closed_arrivals,
}


def arrival_offsets(kind: str, n: int, rng: np.random.Generator,
                    **params) -> np.ndarray:
    """Dispatch by name — the hook the differential harness's arrival axis
    uses so a scenario dict stays plain data."""
    return _ARRIVALS[kind](rng, n, **params)


# ----------------------------------------------------------------- lengths

def heavy_tail_lengths(rng: np.random.Generator, n: int, lo: int, hi: int,
                       alpha: float = 1.3) -> np.ndarray:
    """Bounded Pareto lengths on [lo, hi]: most requests short, a heavy
    tail of long ones — the distribution that makes uniform chunk sizes
    and naive batching look good in the mean and terrible at p99."""
    u = rng.random(size=n)
    la, ha = float(lo) ** alpha, float(hi) ** alpha
    x = (-(u * (ha - la) - ha) / (ha * la)) ** (-1.0 / alpha)
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def uniform_lengths(rng: np.random.Generator, n: int, lo: int,
                    hi: int) -> np.ndarray:
    return rng.integers(lo, hi + 1, size=n, dtype=np.int64)


_LENGTHS = {"heavy_tail": heavy_tail_lengths, "uniform": uniform_lengths}


# --------------------------------------------------------------- scenarios

@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named workload family.  Everything is plain data so specs can be
    replaced (``dataclasses.replace``) to miniaturize for the fast suite.

    ``events`` schedules hot control actions at virtual ticks — each entry
    ``(tick, updates)`` is applied via ``engine.update(**updates)`` just
    before that tick runs (the hot-swap-storm / knob-thrash ingredient).
    ``slos`` grades the drive (see ``scheduler.grade_slo``)."""
    name: str
    n: int                                  # requests in the stream
    arrival: str = "poisson"                # _ARRIVALS key
    arrival_params: Tuple[Tuple[str, Any], ...] = ()
    plen: str = "uniform"                   # _LENGTHS key (prompt lengths)
    plen_params: Tuple[Tuple[str, Any], ...] = (("lo", 4), ("hi", 12))
    max_new: str = "uniform"                # _LENGTHS key (response lengths)
    max_new_params: Tuple[Tuple[str, Any], ...] = (("lo", 4), ("hi", 8))
    mix: Tuple[Tuple[str, float], ...] = (("default", 1.0),)
    population: str = "disjoint"            # "disjoint" | "shared"
    n_preambles: int = 2                    # shared: distinct preambles
    preamble_frac: float = 0.5              # shared: prefix share of plen
    vocab: int = 97                         # token id range (kept tiny so
    #                                         shared prefixes actually repeat)
    events: Tuple[Tuple[int, Tuple[Tuple[str, Any], ...]], ...] = ()
    slos: Tuple[ServeSLO, ...] = ()
    description: str = ""

    def event_list(self) -> List[Tuple[int, Dict[str, Any]]]:
        return [(t, dict(kv)) for t, kv in self.events]


def generate(spec: ScenarioSpec, seed: int) -> List[GenRequest]:
    """Expand a spec into its concrete request stream.  Deterministic in
    (spec, seed): the rng is seeded from the caller's seed plus a stable
    digest of the spec name, so two scenarios sharing one suite seed still
    draw independent streams, and replay is exact."""
    tag = int.from_bytes(spec.name.encode()[:8].ljust(8, b"\0"), "little")
    rng = np.random.default_rng(np.random.SeedSequence([seed, tag]))
    at = arrival_offsets(spec.arrival, spec.n, rng,
                         **dict(spec.arrival_params))
    plens = _LENGTHS[spec.plen](rng, spec.n, **dict(spec.plen_params))
    mnews = _LENGTHS[spec.max_new](rng, spec.n,
                                   **dict(spec.max_new_params))
    names = [m[0] for m in spec.mix]
    probs = np.asarray([m[1] for m in spec.mix], np.float64)
    classes = rng.choice(len(names), size=spec.n, p=probs / probs.sum())
    preambles = [tuple(int(x) for x in rng.integers(
        1, spec.vocab, size=max(int(dict(spec.plen_params)["hi"]
                                    * spec.preamble_frac), 1)))
                 for _ in range(spec.n_preambles)]
    reqs = []
    for i in range(spec.n):
        L = int(plens[i])
        if spec.population == "shared":
            pre = preambles[int(rng.integers(0, spec.n_preambles))]
            head = pre[:max(int(L * spec.preamble_frac), 1)]
            tail = tuple(int(x) for x in rng.integers(
                1, spec.vocab, size=max(L - len(head), 0)))
            prompt = head + tail
        else:
            prompt = tuple(int(x) for x in rng.integers(1, spec.vocab,
                                                        size=L))
        reqs.append(GenRequest(at=int(at[i]), prompt=prompt,
                               max_new=int(mnews[i]),
                               priority=names[int(classes[i])]))
    reqs.sort(key=lambda r: r.at)
    return reqs


# The gauntlet's scenario families.  Sizes are bench-scale; the fast suite
# miniaturizes with ``dataclasses.replace(spec, n=...)``.  SLO thresholds
# are deliberately generous — they are regression tripwires for gross
# scheduling failures (starvation, collapse under overload), not
# performance targets (docs/STRESS_TESTS.md records the reference's margins).

SCENARIOS: Dict[str, ScenarioSpec] = {}


def scenario(spec: ScenarioSpec) -> ScenarioSpec:
    assert spec.name not in SCENARIOS, f"duplicate scenario {spec.name}"
    SCENARIOS[spec.name] = spec
    return spec


scenario(ScenarioSpec(
    name="steady_poisson", n=24,
    arrival="poisson", arrival_params=(("rate", 0.5),),
    slos=(ServeSLO(p50_ttft=40, p99_ttft=160, min_goodput=0.25),),
    description="Memoryless moderate load: the baseline every other "
                "scenario's grades are read against."))

scenario(ScenarioSpec(
    name="bursty_overload", n=32,
    arrival="bursty", arrival_params=(("burst", 8), ("gap", 24.0)),
    plen="heavy_tail", plen_params=(("lo", 4), ("hi", 14), ("alpha", 1.2)),
    slos=(ServeSLO(p99_ttft=280, min_goodput=0.2, max_deferred=48),),
    description="Queue spikes over slot capacity: admission + aging under "
                "overload; goodput must not collapse between bursts."))

scenario(ScenarioSpec(
    name="heavy_tail", n=24,
    arrival="poisson", arrival_params=(("rate", 0.4),),
    plen="heavy_tail", plen_params=(("lo", 4), ("hi", 16), ("alpha", 1.1)),
    max_new="heavy_tail",
    max_new_params=(("lo", 2), ("hi", 10), ("alpha", 1.3)),
    slos=(ServeSLO(p50_ttft=48, p99_ttft=240),),
    description="Pareto prompt AND response lengths: long-tail residents "
                "must not starve short arrivals (chunked prefill test)."))

scenario(ScenarioSpec(
    name="priority_starvation", n=32,
    arrival="bursty", arrival_params=(("burst", 6), ("gap", 12.0)),
    mix=(("interactive", 0.75), ("batch", 0.25)),
    slos=(ServeSLO(scope="interactive", p50_ttft=56, p99_ttft=240),
          ServeSLO(scope="batch", max_deferred=24, p99_ttft=400)),
    description="Adversarial: heavy interactive flood against a batch "
                "trickle — the per-class aging bound must keep batch "
                "prefills from starving (max_deferred is the tripwire)."))

scenario(ScenarioSpec(
    name="shared_preamble", n=24,
    arrival="poisson", arrival_params=(("rate", 0.6),),
    population="shared", n_preambles=2, preamble_frac=0.6,
    plen_params=(("lo", 8), ("hi", 14)),
    slos=(ServeSLO(p50_ttft=40, p99_ttft=200, min_goodput=0.25),),
    description="Agent-loop population: most prompts share one of two "
                "preambles — prefix-cache admission should win here, and "
                "winning must not cost correctness or tail latency."))

scenario(ScenarioSpec(
    name="diurnal_ramp", n=28,
    arrival="diurnal",
    arrival_params=(("period", 80.0), ("peak_rate", 1.0),
                    ("trough_rate", 0.05)),
    slos=(ServeSLO(p50_ttft=48, p99_ttft=280),),
    description="Rate swings trough→peak: cost EMAs and knob choices "
                "tuned in the quiet phase meet the rush."))

scenario(ScenarioSpec(
    name="hot_swap_storm", n=24,
    arrival="poisson", arrival_params=(("rate", 0.5),),
    events=tuple((t, (("params_version", 1000 + t),))
                 for t in range(8, 200, 16)),
    slos=(ServeSLO(p99_ttft=280, max_dropped=0),),
    description="Weight-publish storm: a params_version bump lands every "
                "16 ticks mid-flight — zero drops, stale results must "
                "never serve, tails must stay bounded."))

scenario(ScenarioSpec(
    name="chunk_thrash", n=24,
    arrival="bursty", arrival_params=(("burst", 4), ("gap", 10.0)),
    plen="heavy_tail", plen_params=(("lo", 4), ("hi", 14), ("alpha", 1.2)),
    events=tuple((t, (("prefill_chunk", 1 if (t // 12) % 2 else 16),
                      ("spec_decode", bool((t // 12) % 2))))
                 for t in range(6, 200, 12)),
    slos=(ServeSLO(p99_ttft=320, max_dropped=0),),
    description="Adversarial knob thrash: prefill_chunk and spec_decode "
                "flip every 12 ticks under bursty load — hot updates must "
                "stay safe (no overruns, no drops) however ill-timed."))


# ------------------------------------------------------------------- drive

@dataclasses.dataclass
class ReqTrace:
    """Virtual-tick life of one request, paired with the engine's own
    wall-clock marks after the drive completes."""
    gen: GenRequest
    req: Any                                # live engine Request
    t_submit: int = 0
    t_first: Optional[int] = None
    t_done: Optional[int] = None

    @property
    def ttft(self) -> float:
        return (float("inf") if self.t_first is None
                else float(self.t_first - self.t_submit))


@dataclasses.dataclass
class DriveResult:
    traces: List[ReqTrace]
    ticks: int                              # virtual ticks consumed
    idle_skipped: int                       # ticks fast-forwarded over
    wall_s: float
    tokens_out: int
    events_applied: int

    def outputs(self) -> List[np.ndarray]:
        return [t.req.output() for t in self.traces]


def drive(engine, reqs: Sequence[GenRequest], max_ticks: int = 5000,
          events: Sequence[Tuple[int, Dict[str, Any]]] = (),
          submit: Optional[Callable[..., Any]] = None) -> DriveResult:
    """Play a generated stream against a live engine under virtual time.

    The virtual clock is the engine tick count ``t``.  Before tick ``t``
    runs, every request with ``at <= t`` is submitted (through ``submit``
    when given — the ``BatchedServer.submit`` entry point — else
    ``engine.submit``) and every scheduled event with ``tick <= t`` is
    applied via ``engine.update``.  When the engine is fully idle and work
    is still coming, the clock fast-forwards to the next arrival instead
    of spinning empty ticks, so sparse tails cost nothing.

    First-token/completion are detected host-side between ticks (a token
    list turning non-empty / ``t_done`` set), so TTFT lands in virtual
    ticks — the deterministic-across-hosts unit the SLO grades use."""
    import time
    reqs = sorted(reqs, key=lambda r: r.at)
    events = sorted(events, key=lambda e: e[0])
    sub = submit or engine.submit
    traces: List[ReqTrace] = []
    pending = list(reqs)
    pend_ev = list(events)
    live: List[ReqTrace] = []
    t = 0
    idle_skipped = 0
    n_ev = 0
    t0 = time.perf_counter()
    for _ in range(max_ticks):
        while pend_ev and pend_ev[0][0] <= t:
            engine.update(**pend_ev[0][1])
            pend_ev.pop(0)
            n_ev += 1
        while pending and pending[0].at <= t:
            g = pending.pop(0)
            r = sub(np.asarray(g.prompt, np.int32), g.max_new,
                    g.temperature, priority=g.priority)
            tr = ReqTrace(gen=g, req=r, t_submit=t)
            traces.append(tr)
            live.append(tr)
        if not traces and not pending and not pend_ev:
            break
        alive = engine.tick()
        for tr in list(live):
            if tr.t_first is None and (tr.req.tokens
                                       or tr.req.t_first is not None):
                tr.t_first = t
            if tr.req.done.is_set():
                tr.t_done = tr.t_done if tr.t_done is not None else t
                live.remove(tr)
        t += 1
        if not alive:
            break
        if not live and not engine.queue:
            if pending or pend_ev:
                nxt = min(([pending[0].at] if pending else [])
                          + ([pend_ev[0][0]] if pend_ev else []))
                if nxt > t:
                    idle_skipped += nxt - t
                    t = nxt
            else:
                break
    return DriveResult(traces=traces, ticks=t, idle_skipped=idle_skipped,
                       wall_s=time.perf_counter() - t0,
                       tokens_out=sum(len(tr.req.tokens)
                                      for tr in traces),
                       events_applied=n_ev)


# --------------------------------------------------------------- summarize

def summarize(res: DriveResult) -> Dict[str, float]:
    """Flatten a drive into the metrics dict ``scheduler.grade_slo``
    consumes: pooled ``p50_ttft``/``p99_ttft``/``goodput``/``max_deferred``
    /``dropped`` plus the same per priority class under ``<cls>/`` keys.
    Goodput counts only tokens of COMPLETED requests over busy (non-fast-
    forwarded) virtual ticks — half-finished work is not goodput."""
    busy = max(res.ticks - res.idle_skipped, 1)
    done = [tr for tr in res.traces if tr.t_done is not None]
    out: Dict[str, float] = {
        "n": float(len(res.traces)),
        "completed": float(len(done)),
        "dropped": float(sum(1 for tr in res.traces
                             if tr.t_done is None)),
        "goodput": sum(min(len(tr.req.tokens), tr.req.max_new)
                       for tr in done) / busy,
        "ticks": float(res.ticks),
        "busy_ticks": float(busy),
        "wall_s": res.wall_s,
    }
    by_cls: Dict[str, List[ReqTrace]] = {}
    for tr in res.traces:
        by_cls.setdefault(tr.gen.priority, []).append(tr)
    scopes: List[Tuple[Optional[str], List[ReqTrace]]] = \
        [(None, res.traces)] + sorted(by_cls.items())
    for scope, trs in scopes:
        pre = f"{scope}/" if scope else ""
        ttfts = [tr.ttft for tr in trs if tr.t_first is not None]
        out[pre + "p50_ttft"] = percentile(ttfts, 50)
        out[pre + "p99_ttft"] = percentile(ttfts, 99)
        out[pre + "max_deferred"] = float(max(
            (tr.req.max_deferred for tr in trs), default=0))
        if scope:
            out[pre + "dropped"] = float(sum(1 for tr in trs
                                             if tr.t_done is None))
            out[pre + "goodput"] = sum(
                min(len(tr.req.tokens), tr.req.max_new)
                for tr in trs if tr.t_done is not None) / busy
    return out
