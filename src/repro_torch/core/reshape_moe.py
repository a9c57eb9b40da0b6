"""Reshape -> MoE expert-parallel integration (Tier B, DESIGN.md §2).

The paper's abstractions mapped onto synchronous expert-parallel training:

  worker            = EP rank (device column of the "model" mesh axis)
  partition         = the logical experts whose *home slot* lives on a rank
  workload phi      = EMA of tokens routed to a rank per step (from the free
                      in-layer metrics) + overflow backlog counter
  partitioning logic= the RoutingPlan arrays (jittable step inputs)
  SBR               = split a hot expert's tokens between its home slot and a
                      replica in a helper rank's spare slot
  SBK               = move a whole expert into a helper rank's spare slot
  state migration   = copying the expert's weights (+ optimizer moments) into
                      the spare slot; cost enters tau' (§3.6.1)
  phase 1           = boosted redirect fraction while the skewed rank drains
                      its overflow backlog; phase 2 = estimator-based fraction

Slot layout interleaves one spare per rank:  rank d owns slots
[d*(epd+1), (d+1)*(epd+1)); the last one is its spare.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.adaptive import TauAdjuster, tau_prime
from repro_torch.core.skew import SkewParams


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    num_experts: int
    ep_ranks: int

    @property
    def experts_per_rank(self) -> int:
        assert self.num_experts % self.ep_ranks == 0
        return self.num_experts // self.ep_ranks

    @property
    def slots_per_rank(self) -> int:
        return self.experts_per_rank + 1          # one spare per rank

    @property
    def num_slots(self) -> int:
        return self.slots_per_rank * self.ep_ranks

    def home_slot(self, e: int) -> int:
        epd = self.experts_per_rank
        return (e // epd) * self.slots_per_rank + (e % epd)

    def spare_slot(self, rank: int) -> int:
        return rank * self.slots_per_rank + self.experts_per_rank

    def rank_of_slot(self, s: int) -> int:
        return s // self.slots_per_rank

    def rank_of_expert(self, e: int) -> int:
        return e // self.experts_per_rank


def _cum_to_fracs(cum: np.ndarray) -> np.ndarray:
    """Cumulative split fractions -> per-replica fractions along the last
    axis, in float64.  Negative diffs (malformed rows) contribute 0, matching
    the ``frac > 0`` guard of the loop formulation.  Hand-rolled instead of
    ``np.diff(..., prepend=0)`` — this sits on the controller's decision hot
    path and np.diff's prepend allocation costs ~10x the subtraction."""
    c = cum.astype(np.float64)
    f = np.empty_like(c)
    f[..., 0] = c[..., 0]
    f[..., 1:] = c[..., 1:] - c[..., :-1]
    np.maximum(f, 0.0, out=f)
    return f


@dataclasses.dataclass
class Migration:
    layer: int
    src_slot: int
    dst_slot: int


@dataclasses.dataclass
class MitigationEvent:
    layer: int
    skewed_rank: int
    helper_rank: int
    hot_expert: int
    fraction: float
    phase: int
    migration: Optional[Migration]


class MoEReshaper:
    """Host-side controller logic: observe per-step metrics, emit new plans
    + expert-state migrations between steps (the fast control path)."""

    def __init__(self, cfg: ArchConfig, n_moe_layers: int, ep_ranks: int,
                 params: Optional[SkewParams] = None,
                 ema_beta: float = 0.8, adaptive: Optional[TauAdjuster] = None,
                 phase1_steps: int = 2, mode: str = "sbr",
                 migration_steps: float = 0.0):
        self.cfg = cfg
        self.nl = n_moe_layers
        self.layout = SlotLayout(cfg.moe.num_experts, ep_ranks)
        # fresh instance per reshaper: a shared default would leak tau
        # updates (TrainLoop._apply_updates mutates params.tau in place)
        # into every reshaper constructed afterwards
        self.params = params if params is not None \
            else SkewParams(eta=0.0, tau=0.25)  # tau as FRACTION of mean load
        self.ema_beta = ema_beta
        self.adaptive = adaptive
        self.phase1_steps = phase1_steps
        self.mode = mode
        self.migration_steps = migration_steps
        e, r = cfg.moe.num_experts, cfg.moe.max_replicas
        self.plan_slots = np.zeros((n_moe_layers, e, r), np.int32)
        for le in range(e):
            self.plan_slots[:, le, :] = self.layout.home_slot(le)
        self.plan_cum = np.ones((n_moe_layers, e, r), np.float32)
        self._ema_expert = None               # [L, E]
        self._ema_var = None
        self.backlog = np.zeros((n_moe_layers, ep_ranks), np.float64)
        # spare-slot ownership: (layer, rank) -> expert replica hosted there
        self.spare_owner: Dict[Tuple[int, int], int] = {}
        # experts under active mitigation: (layer, expert) -> phase1 steps left
        self.active: Dict[Tuple[int, int], int] = {}
        self.events: List[MitigationEvent] = []
        self.iterations = 0
        self._replica_map: Optional[Dict] = None   # per-step index, see step()
        self._loads_cache: Optional[np.ndarray] = None  # set by observe()
        self._plan_cache = None   # (fracs, flat rank idx); see _plan_derived

    # ------------------------------------------------------------- observe
    def observe(self, expert_counts: np.ndarray,
                dropped_per_layer: Optional[np.ndarray] = None) -> None:
        """expert_counts [L, E] tokens routed per logical expert this step."""
        x = np.asarray(expert_counts, np.float64)
        if self._ema_expert is None:
            self._ema_expert = x.copy()
            self._ema_var = np.zeros_like(x)
        else:
            d = x - self._ema_expert
            self._ema_expert = self.ema_beta * self._ema_expert + \
                (1 - self.ema_beta) * x
            self._ema_var = self.ema_beta * self._ema_var + \
                (1 - self.ema_beta) * d * d
        self._loads_cache = None
        if dropped_per_layer is not None:
            # attribute overflow to the currently-loaded rank
            loads = self.rank_loads_all()                     # [L, ranks]
            top = np.argmax(loads, axis=1)
            self.backlog[np.arange(self.nl), top] += np.asarray(
                dropped_per_layer, np.float64)
            # plan and EMA are untouched between here and the next step(),
            # so these loads double as its pre-maintain loads
            self._loads_cache = loads

    def _plan_derived(self):
        """Plan-dependent arrays for rank_loads_all, cached until the next
        plan write (every plan mutation goes through a method that clears
        ``_plan_cache``): per-replica fracs [L, E, R] and the flattened
        layer-major rank index for bincount."""
        if self._plan_cache is None:
            nr = self.layout.ep_ranks
            fracs = _cum_to_fracs(self.plan_cum)              # [L, E, R]
            ranks = self.plan_slots // self.layout.slots_per_rank
            l_idx = (np.arange(self.nl) * nr)[:, None, None]
            self._plan_cache = (fracs, (l_idx + ranks).ravel())
        return self._plan_cache

    def rank_loads_all(self) -> np.ndarray:
        """Predicted tokens/step per EP rank [L, ranks] under the CURRENT
        plan — one whole-array pass over [L, E, R], no Python loops."""
        nr = self.layout.ep_ranks
        fracs, flat = self._plan_derived()
        w = self._ema_expert[:, :, None] * fracs
        return np.bincount(flat, weights=w.ravel(),
                           minlength=self.nl * nr).reshape(self.nl, nr)

    def rank_loads(self, layer: int) -> np.ndarray:
        """Single-layer view of :meth:`rank_loads_all`."""
        nr = self.layout.ep_ranks
        fracs = _cum_to_fracs(self.plan_cum[layer])           # [E, R]
        ranks = self.plan_slots[layer] // self.layout.slots_per_rank
        w = self._ema_expert[layer][:, None] * fracs
        return np.bincount(ranks.ravel(), weights=w.ravel(), minlength=nr)

    # ------------------------------------------------------------ mitigate
    def _current_frac(self, layer: int, expert: int) -> float:
        """TOTAL fraction of this expert's tokens currently redirected away
        from its home slot (0 under the identity plan)."""
        home = self.layout.home_slot(expert)
        fracs = _cum_to_fracs(self.plan_cum[layer, expert])
        return float(fracs[self.plan_slots[layer, expert] != home].sum())

    def _set_split(self, layer: int, expert: int, helper_slot: int,
                   frac: float) -> None:
        home = self.layout.home_slot(expert)
        r = self.plan_slots.shape[2]
        self._plan_cache = None
        self._loads_cache = None
        self.plan_slots[layer, expert, 0] = helper_slot
        self.plan_slots[layer, expert, 1:] = home
        cum = np.ones(r, np.float32)
        cum[0] = frac
        self.plan_cum[layer, expert] = cum

    def _move_expert(self, layer: int, expert: int, dst_slot: int) -> None:
        self._plan_cache = None
        self._loads_cache = None
        self.plan_slots[layer, expert, :] = dst_slot
        self.plan_cum[layer, expert, :] = 1.0

    def step(self) -> Tuple[np.ndarray, np.ndarray, List[Migration]]:
        """Run detection/mitigation; returns (plan_slots, plan_cum,
        migrations to apply to params/opt state *before* the next step).

        Layers are independent (each touches only its own plan rows, backlog
        row and loads row), so the maintain phase is batched across ALL
        active mitigations of all layers in one whole-array re-waterfill,
        followed by per-layer detection against post-maintain loads."""
        migrations: List[Migration] = []
        if self._ema_expert is None:
            return self.plan_slots, self.plan_cum, migrations
        # per-step replica index: one spare_owner pass instead of one scan
        # per _replicas_of call.  Valid for the whole step: detection only
        # ADDS (layer, rank) keys for its own layer, and each layer reads
        # its replicas before writing them.
        self._replica_map = {}
        for (ll, rank), owner in self.spare_owner.items():
            self._replica_map.setdefault((ll, owner), []).append(rank)
        try:
            loads_all = self._loads_cache if self._loads_cache is not None \
                else self.rank_loads_all()
            self._loads_cache = None
            means = np.maximum(loads_all.mean(1), 1e-9)
            self._maintain_active(loads_all, means)
            loads_all = self.rank_loads_all()
            eps_all = np.sqrt(self._ema_var.mean(1)) / means
            deferred: list = []
            pending_events: list = []
            # cross-layer precheck of eq 3.1/3.2 (exact complement of the
            # per-layer skip test).  Invalid with an adaptive adjuster: its
            # tau mutates as earlier layers fire.
            fire = None
            if self.adaptive is None:
                tau = self.params.tau
                if self.migration_steps:
                    tau = max(0.01, tau_prime(tau, 0.6, 0.4, 1.0,
                                              self.migration_steps))
                lmax = loads_all.max(1)
                fire = (lmax >= self.params.eta) & \
                    ((lmax - loads_all.min(1)) / means >= tau)
            for l in range(self.nl):
                if fire is not None and not fire[l]:
                    continue
                migrations.extend(self._detect_layer(
                    l, loads_all[l], means[l], eps_all[l], deferred,
                    pending_events))
            if deferred:
                self._waterfill_batch(deferred, loads_all)
            for (l, s, h, hot, phase, mig) in pending_events:
                self.events.append(MitigationEvent(
                    l, s, h, hot, float(self.plan_cum[l, hot, 0]), phase,
                    mig))
        finally:
            self._replica_map = None
        return self.plan_slots.copy(), self.plan_cum.copy(), migrations

    def _maintain_active(self, loads_all: np.ndarray,
                         means: np.ndarray) -> None:
        """Re-waterfill every active mitigation with its stable helper set;
        phase-1 boost while that rank's backlog drains (two phases).  All
        entries are gathered first, then written by one batched waterfill.
        Entries of the same (layer, rank) drain the shared backlog
        sequentially in ``active`` insertion order, so each entry's boost
        sees the backlog left by its predecessors — matching the sequential
        formulation (see ``LoopReshaper``) bit for bit."""
        if not self.active:
            return
        entries = []
        drained: Dict[Tuple[int, int], int] = {}
        for (l, hot), left in list(self.active.items()):
            s = self.layout.rank_of_expert(hot)
            helpers = self._replicas_of(l, hot)
            if not helpers:
                del self.active[(l, hot)]
                continue
            j = drained.get((l, s), 0)
            boost = 1.5 if (left > 0 and
                            self.backlog[l, s] - j * means[l] > 0) else 1.0
            drained[(l, s)] = j + 1
            entries.append((l, hot, helpers, boost))
            self.active[(l, hot)] = max(0, left - 1)
        for (l, s), k in drained.items():
            self.backlog[l, s] = max(0.0, self.backlog[l, s] - k * means[l])
        if entries:
            self._waterfill_batch(entries, loads_all)

    def _waterfill_batch(self, entries, loads_all: np.ndarray) -> None:
        """Vectorized ``_waterfill`` over N (layer, hot, helpers, boost)
        entries — each entry reads and writes only its own [R] plan row, so
        the batch is order-independent; every arithmetic step mirrors the
        per-entry version in the same reduction order (bit-exact)."""
        lay = self.layout
        r = self.plan_slots.shape[2]
        n = len(entries)
        h_max = max(len(e[2]) for e in entries)
        l_arr = np.fromiter((e[0] for e in entries), np.int64, n)
        hot = np.fromiter((e[1] for e in entries), np.int64, n)
        boost = np.fromiter((e[3] for e in entries), np.float64, n)
        n_h = np.fromiter((len(e[2]) for e in entries), np.int64, n)
        hr = np.zeros((n, h_max), np.int64)
        for i, e in enumerate(entries):
            hr[i, :len(e[2])] = e[2]
        valid = np.arange(h_max)[None, :] < n_h[:, None]
        phi = np.maximum(self._ema_expert[l_arr, hot], 1e-9)
        rows_s = self.plan_slots[l_arr, hot]                  # [N, R]
        fracs = _cum_to_fracs(self.plan_cum[l_arr, hot])      # [N, R]
        s_rank = hot // lay.experts_per_rank
        home = s_rank * lay.slots_per_rank + hot % lay.experts_per_rank
        redirected = ((rows_s != home[:, None]) * fracs).sum(1)
        base_s = loads_all[l_arr, s_rank] - phi * (1.0 - redirected)
        spare = hr * lay.slots_per_rank + lay.experts_per_rank  # [N, H]
        on_spare = rows_s[:, None, :] == spare[:, :, None]      # [N, H, R]
        contrib = phi[:, None] * (on_spare * fracs[:, None, :]).sum(-1)
        bases = np.where(valid, loads_all[l_arr[:, None], hr] - contrib, 0.0)
        total = phi + base_s + bases.sum(1)
        per = total / (1.0 + n_h)
        f = np.maximum(0.0, per[:, None] - bases) / phi[:, None]
        f = np.where(valid, np.minimum(1.0, f * boost[:, None]), 0.0)
        ftot = f.sum(1)
        over = ftot > 1.0
        f = np.where(over[:, None], f / np.where(over, ftot, 1.0)[:, None], f)
        # plan rows: [spare(h1), ..., spare(h_nsp), home, home, ...]
        n_sp = np.minimum(n_h, r - 1)
        kcols = min(h_max, r - 1)                 # n_sp <= kcols always
        use = np.arange(kcols)[None, :] < n_sp[:, None]
        slots_row = np.empty((n, r), np.int32)
        slots_row[:] = home[:, None]
        np.copyto(slots_row[:, :kcols], spare[:, :kcols], where=use)
        cum_row = np.ones((n, r), np.float32)
        np.copyto(cum_row[:, :kcols],
                  np.minimum(1.0, np.cumsum(f[:, :kcols], axis=1)),
                  where=use)
        self._plan_cache = None
        self._loads_cache = None
        self.plan_slots[l_arr, hot] = slots_row
        self.plan_cum[l_arr, hot] = cum_row

    def _replicas_of(self, l: int, e: int) -> List[int]:
        """Spare-slot ranks currently hosting a replica of expert e."""
        if self._replica_map is not None:
            return list(self._replica_map.get((l, e), ()))
        return [rank for (ll, rank), owner in self.spare_owner.items()
                if ll == l and owner == e]

    def _waterfill(self, l: int, hot: int, helper_ranks: List[int],
                   loads: np.ndarray, boost: float = 1.0) -> None:
        """Split the hot expert across its home rank + helper spares so all
        participating ranks approach the common level (§3.6.2 extended to
        SBR fractions).  ``boost`` > 1 over-redirects (phase-1 catch-up).
        Single-entry wrapper over ``_waterfill_batch`` — one copy of the
        numerically delicate waterfill math."""
        loads_all = np.zeros((l + 1, loads.shape[0]))
        loads_all[l] = loads
        self._waterfill_batch([(l, hot, list(helper_ranks), boost)],
                              loads_all)

    def _detect_layer(self, l: int, loads: np.ndarray, mean: float,
                      eps: float, deferred: list,
                      pending_events: list) -> List[Migration]:
        """Detect new skew on layer ``l`` (eq 3.1/3.2 at rank granularity)
        against post-maintain ``loads``; ``mean``/``eps`` come from the
        pre-maintain loads, matching the sequential formulation.  The SBR
        waterfill is appended to ``deferred`` (one batched write in
        ``step``) — layers never read each other's plan rows, so deferral
        is observationally identical to writing in place."""
        out: List[Migration] = []
        tau = self.adaptive.tau if self.adaptive else self.params.tau
        if self.migration_steps:
            tau = max(0.01, tau_prime(tau, 0.6, 0.4, 1.0,
                                      self.migration_steps))
        max_helpers = self.plan_slots.shape[2] - 1
        s = int(np.argmax(loads))
        if loads[s] < self.params.eta or (loads[s] - loads.min()) / mean < tau:
            return out
        # experts homed on rank s are contiguous: [s*epd, (s+1)*epd)
        epd = self.layout.experts_per_rank
        seg = self._ema_expert[l, s * epd:(s + 1) * epd]
        hot = int(s * epd + np.argmax(seg))
        if self.adaptive:
            self.adaptive.adjust(loads[s] / mean, loads.min() / mean, eps)
        self.iterations += 1

        if self.mode == "sbk":
            # move the smallest expert worth ~the gap (cannot split the hot
            # key — the Flux-style limitation the paper contrasts with)
            move = int(s * epd + np.argmin(seg))
            h = int(np.argmin(loads))
            if (l, h) not in self.spare_owner:
                spare = self.layout.spare_slot(h)
                self.spare_owner[(l, h)] = move
                out.append(Migration(l, self.layout.home_slot(move), spare))
                self._move_expert(l, move, spare)
                self.events.append(MitigationEvent(l, s, h, move, 1.0, 2,
                                                   out[-1]))
            return out

        # ---- SBR: (re)build the helper set for the hot expert — reuse its
        # existing replicas, extend with least-loaded ranks w/ free spares
        helpers = self._replicas_of(l, hot)
        order = [int(h) for h in np.argsort(loads) if int(h) != s]
        phi = max(self._ema_expert[l, hot], 1e-9)
        for h in order:
            if len(helpers) >= max_helpers:
                break
            if h in helpers:
                continue
            if self.spare_owner.get((l, h)) not in (None, hot):
                continue                      # spare already hosts another
            # does adding this helper reduce the common level? (chi logic)
            if loads[h] >= loads[s]:
                break
            helpers.append(h)
            if (phi + sum(loads[x] for x in helpers + [s])) / \
                    (len(helpers) + 1) <= mean * (1 + tau / 2):
                break
        if not helpers:
            return out
        for h in helpers:
            if self.spare_owner.get((l, h)) != hot:
                self.spare_owner[(l, h)] = hot
                out.append(Migration(l, self.layout.home_slot(hot),
                                     self.layout.spare_slot(h)))
        has_backlog = self.backlog[l, s] > 0
        deferred.append((l, hot, helpers,
                         1.5 if has_backlog else 1.0))
        self.active[(l, hot)] = self.phase1_steps if has_backlog else 0
        pending_events.append((l, s, helpers[0], hot,
                               1 if has_backlog else 2,
                               out[-1] if out else None))
        return out


# ----------------------------------------------------------- loop references
# Loop-based formulations of the vectorized hot-path methods above, kept as
# the executable spec: the regression tests assert the whole-array versions
# match these on randomized plans, and the reshaper-latency benchmark uses
# them as the pre-vectorization baseline.  They read reshaper state but never
# mutate it.

def rank_loads_loop(rs: "MoEReshaper", layer: int) -> np.ndarray:
    loads = np.zeros(rs.layout.ep_ranks)
    e = rs.cfg.moe.num_experts
    for le in range(e):
        pred = rs._ema_expert[layer, le]
        cum_prev = 0.0
        for r in range(rs.plan_slots.shape[2]):
            cum = float(rs.plan_cum[layer, le, r])
            frac = cum - cum_prev
            if frac > 0:
                rank = rs.layout.rank_of_slot(
                    int(rs.plan_slots[layer, le, r]))
                loads[rank] += pred * frac
            cum_prev = cum
    return loads


def current_frac_loop(rs: "MoEReshaper", layer: int, expert: int) -> float:
    home = rs.layout.home_slot(expert)
    prev, redirected = 0.0, 0.0
    for slot, cum in zip(rs.plan_slots[layer, expert],
                         rs.plan_cum[layer, expert]):
        frac = float(cum) - prev
        prev = float(cum)
        if frac > 0 and int(slot) != home:
            redirected += frac
    return redirected


def waterfill_row_loop(rs: "MoEReshaper", l: int, hot: int,
                       helper_ranks: List[int], loads: np.ndarray,
                       boost: float = 1.0):
    """Returns the (slots_row, cum_row) that ``_waterfill`` would write."""
    s = rs.layout.rank_of_expert(hot)
    phi = max(rs._ema_expert[l, hot], 1e-9)
    base_s = loads[s] - phi * (1.0 - current_frac_loop(rs, l, hot))
    bases = []
    cur_slots = list(rs.plan_slots[l, hot])
    cur_cum = list(rs.plan_cum[l, hot])
    for h in helper_ranks:
        contrib = 0.0
        prev = 0.0
        for slot, cum in zip(cur_slots, cur_cum):
            frac = float(cum) - prev
            prev = float(cum)
            if frac > 0 and rs.layout.rank_of_slot(int(slot)) == h and \
                    int(slot) == rs.layout.spare_slot(h):
                contrib += phi * frac
        bases.append(loads[h] - contrib)
    total = phi + base_s + sum(bases)
    per = total / (1 + len(helper_ranks))
    f_helpers = [max(0.0, (per - b)) / phi for b in bases]
    f_helpers = [min(1.0, f * boost) for f in f_helpers]
    ftot = sum(f_helpers)
    if ftot > 1.0:
        f_helpers = [f / ftot for f in f_helpers]
    r = rs.plan_slots.shape[2]
    slots = [rs.layout.spare_slot(h) for h in helper_ranks]
    slots = slots[: r - 1] + [rs.layout.home_slot(hot)] * \
        (r - min(len(slots), r - 1))
    cum, acc = [], 0.0
    for f in f_helpers[: r - 1]:
        acc = min(1.0, acc + f)
        cum.append(acc)
    cum += [1.0] * (r - len(cum))
    return np.asarray(slots[:r], np.int32), np.asarray(cum[:r], np.float32)


class LoopReshaper(MoEReshaper):
    """``MoEReshaper`` with the pre-vectorization implementation swapped in:
    the original sequential per-layer ``step`` loop plus the loop-based
    method bodies (modulo uniform float64 frac arithmetic — the original
    mixed f32/f64, see the reference functions).  Same decisions at the old
    cost; baseline for ``bench_reshaper_latency`` and the full-step
    regression tests."""

    def rank_loads_all(self) -> np.ndarray:
        return np.stack([rank_loads_loop(self, l) for l in range(self.nl)])

    def rank_loads(self, layer: int) -> np.ndarray:
        return rank_loads_loop(self, layer)

    def _current_frac(self, layer: int, expert: int) -> float:
        return current_frac_loop(self, layer, expert)

    def _waterfill(self, l: int, hot: int, helper_ranks: List[int],
                   loads: np.ndarray, boost: float = 1.0) -> None:
        slots, cum = waterfill_row_loop(self, l, hot, helper_ranks, loads,
                                        boost)
        self._plan_cache = None
        self._loads_cache = None
        self.plan_slots[l, hot] = slots
        self.plan_cum[l, hot] = cum

    def _replicas_of(self, l: int, e: int) -> List[int]:
        return [rank for (ll, rank), owner in self.spare_owner.items()
                if ll == l and owner == e]

    def step(self) -> Tuple[np.ndarray, np.ndarray, List[Migration]]:
        # verbatim pre-vectorization step: sequential per-layer sweep, loads
        # recomputed per layer, no caches
        migrations: List[Migration] = []
        if self._ema_expert is None:
            return self.plan_slots, self.plan_cum, migrations
        self._loads_cache = None
        for l in range(self.nl):
            migrations.extend(self._step_layer(l))
        return self.plan_slots.copy(), self.plan_cum.copy(), migrations

    def _step_layer(self, l: int) -> List[Migration]:
        out: List[Migration] = []
        loads = self.rank_loads(l)
        mean = max(loads.mean(), 1e-9)
        eps = float(np.sqrt(self._ema_var[l].mean())) / mean
        tau = self.adaptive.tau if self.adaptive else self.params.tau
        if self.migration_steps:
            tau = max(0.01, tau_prime(tau, 0.6, 0.4, 1.0,
                                      self.migration_steps))
        max_helpers = self.plan_slots.shape[2] - 1

        # maintain active mitigations (sequential re-waterfill)
        for (ll, hot), left in list(self.active.items()):
            if ll != l:
                continue
            s = self.layout.rank_of_expert(hot)
            helpers = self._replicas_of(l, hot)
            if not helpers:
                del self.active[(l, hot)]
                continue
            boost = 1.5 if (left > 0 and self.backlog[l, s] > 0) else 1.0
            self._waterfill(l, hot, helpers, loads, boost)
            self.active[(l, hot)] = max(0, left - 1)
            self.backlog[l, s] = max(0.0, self.backlog[l, s] - mean)

        # detect new skew
        loads = self.rank_loads(l)
        s = int(np.argmax(loads))
        if loads[s] < self.params.eta or (loads[s] - loads.min()) / mean < tau:
            return out
        cands = [e for e in range(self.cfg.moe.num_experts)
                 if self.layout.rank_of_expert(e) == s]
        hot = int(max(cands, key=lambda e: self._ema_expert[l, e]))
        if self.adaptive:
            self.adaptive.adjust(loads[s] / mean, loads.min() / mean, eps)
        self.iterations += 1

        if self.mode == "sbk":
            move = min(cands, key=lambda e: self._ema_expert[l, e])
            h = int(np.argmin(loads))
            if (l, h) not in self.spare_owner:
                spare = self.layout.spare_slot(h)
                self.spare_owner[(l, h)] = move
                out.append(Migration(l, self.layout.home_slot(move), spare))
                self._move_expert(l, move, spare)
                self.events.append(MitigationEvent(l, s, h, move, 1.0, 2,
                                                   out[-1]))
            return out

        helpers = self._replicas_of(l, hot)
        order = [int(h) for h in np.argsort(loads) if int(h) != s]
        phi = max(self._ema_expert[l, hot], 1e-9)
        for h in order:
            if len(helpers) >= max_helpers:
                break
            if h in helpers:
                continue
            if self.spare_owner.get((l, h)) not in (None, hot):
                continue
            if loads[h] >= loads[s]:
                break
            helpers.append(h)
            if (phi + sum(loads[x] for x in helpers + [s])) / \
                    (len(helpers) + 1) <= mean * (1 + tau / 2):
                break
        if not helpers:
            return out
        for h in helpers:
            if self.spare_owner.get((l, h)) != hot:
                self.spare_owner[(l, h)] = hot
                out.append(Migration(l, self.layout.home_slot(hot),
                                     self.layout.spare_slot(h)))
        has_backlog = self.backlog[l, s] > 0
        self._waterfill(l, hot, helpers, loads,
                        boost=1.5 if has_backlog else 1.0)
        self.active[(l, hot)] = self.phase1_steps if has_backlog else 0
        self.events.append(MitigationEvent(
            l, s, helpers[0], hot, float(self.plan_cum[l, hot, 0]),
            1 if has_backlog else 2, out[-1] if out else None))
        return out


def apply_migrations_np(expert_leaf: np.ndarray,
                        migrations: List[Migration]) -> np.ndarray:
    """Reference (numpy) state migration on a [L, S, ...] stacked leaf."""
    out = expert_leaf.copy()
    for m in migrations:
        out[m.layer, m.dst_slot] = out[m.layer, m.src_slot]
    return out
