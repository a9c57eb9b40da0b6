"""Synthetic data substrate: token streams with controllable key skew.

Provides (a) LM token batches (checkpointable iterator state), (b) skewed
key streams for the Tier-A simulator benchmarks (Zipf / tweets-like /
shifting distributions, paper §3.7.1 Fig 3.15), and (c) a class-structured
token stream where the token's leading id encodes a "class" (location-like)
so result-representativeness (CA:AZ curves) is measurable on the MoE runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np


def zipf_weights(n: int, alpha: float = 1.2) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** alpha
    return w / w.sum()


def tweets_like_rates(n_keys: int = 50, hot: float = 26.0,
                      mid: float = 6.5, low: float = 3.8) -> Dict[int, float]:
    """Tweet-location-like distribution (CA=26M, IL=6.5M, AZ=3.8M scaled)."""
    rates = {k: 1.0 for k in range(n_keys)}
    rates[6] = hot          # "CA"
    rates[17] = mid         # "IL"
    rates[4] = low          # "AZ"
    if n_keys > 48:
        rates[48] = hot * 0.6   # "TX"
    return rates


def shifting_rates(change_tick: int, before: Dict[int, float],
                   after: Dict[int, float]) -> Callable[[int], Dict[int, float]]:
    return lambda t: before if t < change_tick else after


@dataclasses.dataclass
class TokenStream:
    """Deterministic, checkpointable LM batch source.

    ``class_skew``: if set, tokens are drawn per-sequence from a "class"
    whose vocab slice is Zipf-hot — creating the routing skew Reshape
    mitigates, with measurable per-class throughput.
    """
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0
    n_classes: int = 8
    class_alpha: float = 0.0          # 0 = uniform tokens, >0 = skewed
    shift_at: Optional[int] = None    # distribution shift step (Fig 3.24)

    def class_probs(self) -> np.ndarray:
        if self.class_alpha <= 0:
            return np.full(self.n_classes, 1.0 / self.n_classes)
        p = zipf_weights(self.n_classes, self.class_alpha)
        if self.shift_at is not None and self.step >= self.shift_at:
            p = np.roll(p, self.n_classes // 2)
        return p

    def next(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + self.step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        probs = self.class_probs()
        cls = rng.choice(self.n_classes, size=(b,), p=probs)
        lo = (cls * (v // self.n_classes))[:, None]
        tokens = lo + rng.integers(1, v // self.n_classes,
                                   size=(b, s))
        self.step += 1
        return {"tokens": tokens.astype(np.int32),
                "classes": cls.astype(np.int32)}

    # checkpointable iterator state (recovery replays from here)
    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict) -> "TokenStream":
        self.seed, self.step = state["seed"], state["step"]
        return self
