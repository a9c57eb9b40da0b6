"""Skew-mitigation strategies on the pipelined simulator: Reshape (the
paper's), plus the two baselines it is evaluated against (Flux §3.1.1-style
SBK-only, Flow-Join-style one-shot SBR) and no-mitigation."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import transfer
from repro_torch.core.adaptive import TauAdjuster, tau_prime
from repro_torch.core.estimator import MeanModelEstimator
from repro_torch.core.skew import SkewParams, detect
from repro_torch.core.worker import PipelinedSim


class NoMitigation:
    def on_metrics(self, tick, sim, workloads):
        pass


@dataclasses.dataclass
class FluxStrategy:
    """SBK only, cannot split a hot key (paper §3.1.1 / §3.7.4)."""
    params: SkewParams = dataclasses.field(default_factory=SkewParams)
    initial_delay: int = 2
    done_pairs: set = dataclasses.field(default_factory=set)

    def on_metrics(self, tick, sim: PipelinedSim, workloads):
        if tick < self.initial_delay:
            return
        for s, h in detect(workloads, self.params):
            if (s, h) in self.done_pairs:
                continue
            self.done_pairs.add((s, h))
            key_loads = dict(sim.processed_key)
            target = (workloads[s] - workloads[h]) / 2.0
            sim.set_logic_with_migration(
                lambda logic, s=s, h=h: transfer.sbk_plan(
                    key_loads, s, h, logic, target), [h])


@dataclasses.dataclass
class FlowJoinStrategy:
    """One-shot: detect heavy hitters in an initial window, then split each
    50/50 with a helper forever (no iteration, no load awareness)."""
    detect_window: int = 2
    top_n: int = 2
    fired: bool = False

    def on_metrics(self, tick, sim: PipelinedSim, workloads):
        if self.fired or tick < self.detect_window:
            return
        self.fired = True
        heavy = sorted(sim.processed_key.items(), key=lambda kv: -kv[1])
        order = sorted(workloads, key=lambda w: workloads[w])
        for i, (key, _) in enumerate(heavy[: self.top_n]):
            owner = sim.logic.assignment[key][0][0]
            helper = next((w for w in order
                           if w != owner and workloads[w] < workloads[owner]),
                          None)
            if helper is None:
                helper = next(w for w in order if w != owner)

            def mutate(logic, key=key, owner=owner, helper=helper):
                logic.assignment[key] = [(helper, 0.5), (owner, 1.0)]
            sim.set_logic_with_migration(mutate, [helper])


@dataclasses.dataclass
class ReshapeStrategy:
    """The paper's strategy: iterative two-phase SBR (or SBK), workload
    estimation, optional adaptive tau, migration-time-aware tau'."""
    params: SkewParams = dataclasses.field(default_factory=SkewParams)
    mode: str = "sbr"                      # "sbr" | "sbk"
    first_phase: bool = True
    adaptive_tau: Optional[TauAdjuster] = None
    helpers_per_skewed: int = 1
    initial_delay: int = 2
    # Detection uses queue size phi (§3.2); the phase-2 split fraction uses
    # estimated future INPUT rates (§3.3.1 "percentage load": redirect 9/26 of
    # J6's input).  We estimate per-KEY arrival rates and aggregate them over
    # each worker's owned partition, so the estimate is partition-change-proof.
    key_est: MeanModelEstimator = dataclasses.field(
        default_factory=MeanModelEstimator)
    # (skewed, helper) -> phase; 1 = catching up, 2 = steady
    active: Dict[Tuple[int, int], int] = dataclasses.field(default_factory=dict)
    iterations: int = 0
    migrations: int = 0          # iterations that moved state (phase-1 / SBK)
    _last_key_arr: Dict[object, float] = dataclasses.field(default_factory=dict)

    def _params_now(self, sim: PipelinedSim) -> SkewParams:
        tau = self.adaptive_tau.tau if self.adaptive_tau else self.params.tau
        if sim.migration_ticks:
            # start earlier so migration completes by the time gap == tau
            tau = max(1.0, tau_prime(tau, 0.7, 0.3, sim.proc_rate * sim.n,
                                     sim.migration_ticks))
        return SkewParams(eta=self.params.eta, tau=tau)

    @staticmethod
    def _owner(logic, key) -> int:
        return logic.assignment[key][-1][0]    # remainder-taker = owner

    def _partition_rate(self, sim, worker) -> Tuple[float, float]:
        """(predicted natural input rate of worker's owned keys, eps)."""
        rate, var = 0.0, 0.0
        for k in sim.logic.assignment:
            if self._owner(sim.logic, k) == worker:
                r, e = self.key_est.predict(k)
                rate += r
                if e != float("inf"):
                    var += e * e
        return rate, var ** 0.5

    def on_metrics(self, tick, sim: PipelinedSim, workloads):
        # per-key arrival-rate samples
        sample = {}
        for k in sim.logic.assignment:
            cur = sim.arrived_key.get(k, 0.0)
            sample[k] = cur - self._last_key_arr.get(k, 0.0)
            self._last_key_arr[k] = cur
        if tick > 0:
            self.key_est.add(sample)
        if tick < self.initial_delay:
            return

        # Algorithm 1 runs at every metric collection: steer tau from the
        # current prediction error of the active pairs
        if self.adaptive_tau is not None:
            for (s, h) in list(self.active) or []:
                rs_, es_ = self._partition_rate(sim, s)
                rh_, eh_ = self._partition_rate(sim, h)
                self.adaptive_tau.adjust(workloads[s], workloads[h],
                                         max(es_, eh_))

        # phase 1 -> phase 2 transitions for active pairs
        for (s, h), phase in list(self.active.items()):
            if phase == 1 and workloads[h] >= workloads[s] * 0.95:
                self._start_phase2(sim, s, h)
                self.active[(s, h)] = 2

        p = self._params_now(sim)
        pairs = detect({w: v for w, v in workloads.items()
                        if not any(w in sh for sh in self.active)}, p)
        for s, h in pairs:
            if self.adaptive_tau:
                rs, es = self._partition_rate(sim, s)
                rh, eh = self._partition_rate(sim, h)
                self.adaptive_tau.adjust(workloads[s], workloads[h],
                                         max(es, eh))
            self.iterations += 1
            if self.mode == "sbk":
                target = (workloads[s] - workloads[h]) / 2.0
                key_loads = dict(sim.processed_key)
                sim.set_logic_with_migration(
                    lambda logic, s=s, h=h: transfer.sbk_plan(
                        key_loads, s, h, logic, target), [h])
                self.active[(s, h)] = 2
            elif self.first_phase:
                self.migrations += 1
                sim.set_logic_with_migration(
                    lambda logic, s=s, h=h: transfer.phase1_apply(
                        logic, s, h), [h])
                self.active[(s, h)] = 1
            else:
                self._start_phase2(sim, s, h, migrate=True)
                self.active[(s, h)] = 2

        # steady-state pairs: on re-divergence run another mitigation
        # iteration on the SAME pair with a fresh rate estimate (Fig 3.9).
        # If the helper side is now the hot one (distribution shift), the
        # redirect drops to zero and the pair dissolves so general detection
        # can re-pair both workers.
        for (s, h), phase in list(self.active.items()):
            if phase == 2 and abs(workloads[s] - workloads[h]) >= p.tau:
                self.iterations += 1
                frac = self._start_phase2(sim, s, h)
                if frac <= 0.0:
                    del self.active[(s, h)]

    def _start_phase2(self, sim: PipelinedSim, s: int, h: int,
                      migrate: bool = False) -> None:
        rs, _ = self._partition_rate(sim, s)
        rh, _ = self._partition_rate(sim, h)
        frac = transfer.sbr_fraction(max(rs, 1e-9), rh)
        # paper §3.4.3.1: the next iteration's sample window starts at the
        # last equal-load point — reset so shifts are seen promptly
        self.key_est.reset()

        def mutate(logic, s=s, h=h, frac=frac):
            transfer.sbr_apply(logic, s, h, frac)
        if migrate:
            # state was not moved by a first phase -> pay migration now
            sim.set_logic_with_migration(mutate, [h])
        else:
            sim.change_logic(mutate)
        return frac
