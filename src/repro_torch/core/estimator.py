"""Workload estimation (paper §3.3.2, §3.4.3.2).

The mean-model estimator predicts a worker's future per-interval workload as
the mean of its sampled history; its standard error of prediction is
    eps = d * sqrt(1 + 1/n)
(d = sample standard deviation, n = sample size) — the quantity Algorithm 1
steers into the user's [eps_l, eps_u] band by adjusting tau.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple


class MeanModelEstimator:
    def __init__(self):
        self._samples: Dict[int, List[float]] = defaultdict(list)

    def add(self, workloads: Dict[int, float]) -> None:
        for w, v in workloads.items():
            self._samples[w].append(float(v))

    def reset(self, worker: int | None = None) -> None:
        if worker is None:
            self._samples.clear()
        else:
            self._samples.pop(worker, None)

    def n(self, worker: int) -> int:
        return len(self._samples[worker])

    def predict(self, worker: int) -> Tuple[float, float]:
        """Returns (phi_hat, eps) — predicted workload and standard error."""
        xs = self._samples[worker]
        if not xs:
            return 0.0, float("inf")
        n = len(xs)
        mean = sum(xs) / n
        if n < 2:
            return mean, float("inf")
        var = sum((x - mean) ** 2 for x in xs) / (n - 1)
        eps = math.sqrt(var) * math.sqrt(1.0 + 1.0 / n)
        return mean, eps

    def predict_pair(self, s: int, h: int) -> Tuple[float, float, float]:
        """(phi_hat_S, phi_hat_H, eps) — eps pooled over the pair."""
        ps, es = self.predict(s)
        ph, eh = self.predict(h)
        eps = max(es, eh)
        return ps, ph, eps


class CostBook:
    """Online per-job-kind cost estimates for the engine layer.

    The engine measures every job it runs (train step on either path, serve
    prefill/decode ticks, checkpoints) and feeds the wall time back here; the
    Maestro decision code reads the estimates out as region ``cost_per_tuple``
    values, so scheduling choices track the machine actually being run on
    instead of a static model.  Backed by per-kind ``EMAEstimator``s — the
    same mean/eps estimator family as the Reshape workload model (§3.3.2),
    applied to job runtimes."""

    def __init__(self, beta: float = 0.6):
        self._beta = beta
        self._est: Dict[str, "EMAEstimator"] = {}

    def observe(self, kind: str, seconds: float) -> None:
        if kind not in self._est:
            self._est[kind] = EMAEstimator(self._beta)
        self._est[kind].add(seconds)

    def observe_rate(self, kind: str, frac: float) -> None:
        """Rates — e.g. a slot pool's speculative-decode acceptance fraction
        — live next to the runtime EMAs under the same estimator family, but
        are clamped to [0, 1] on the way in: a single mis-counted tick must
        not push an estimate outside the quantity's domain, where the
        decision code (expected commits = ``1 + a·(k-1)``) would extrapolate
        nonsense."""
        self.observe(kind, min(max(float(frac), 0.0), 1.0))

    def estimate(self, kind: str, default: float | None = None):
        """EMA of measured runtimes for ``kind``; ``default`` when unmeasured
        (the engine's bootstrap: decide with priors until jobs have run)."""
        est = self._est.get(kind)
        if est is None or est.value is None:
            return default
        return float(est.value)

    def estimate_first(self, kinds, default: float | None = None):
        """First measured estimate along a fallback chain of kinds.

        The multi-pool serving engine keys tick runtimes per pool
        (``serve_decode:p<id>_per_tok``) *and* globally (``serve_decode_per_tok``):
        a pool that has run ticks is scored on its own measured speed — the
        per-pool EMA is the scheduler's parallelism term, since a pool on
        faster or more-parallel hardware simply shows a lower per-token time
        — while a pool that has not run yet borrows the fleet-wide estimate
        instead of a static prior."""
        for kind in kinds:
            v = self.estimate(kind)
            if v is not None:
                return v
        return default

    def n_kinds(self) -> int:
        return len(self._est)

    def snapshot(self) -> Dict[str, float]:
        """JSON-safe view for Inspect replies / perf artifacts."""
        return {k: float(e.value) for k, e in self._est.items()
                if e.value is not None}


class EMAEstimator:
    """Streaming variant used by the MoE runtime (per-slot EMAs)."""

    def __init__(self, beta: float = 0.8):
        self.beta = beta
        self.value = None
        self._var = None

    def add(self, x):
        import numpy as np
        x = np.asarray(x, dtype=float)
        if self.value is None:
            self.value = x
            self._var = x * 0.0
        else:
            delta = x - self.value
            self.value = self.beta * self.value + (1 - self.beta) * x
            self._var = self.beta * self._var + (1 - self.beta) * delta ** 2

    def predict(self):
        import numpy as np
        if self.value is None:
            return None, float("inf")
        eps = float(np.sqrt(np.mean(self._var)))
        return self.value, eps
