"""The one traffic generator: a mix's data file in, a request stream out.

A mix (``bench/traffic/<mix>.json``) is a closed loop of ``clients``
clients: all send their first request at once, and each sends its next
when its last one finished.  Its prompt and output lengths are bounded
Pareto (``{"kind": "bounded_pareto", "lo", "hi", "alpha"}``).

Draws are stratified by block: each block of ``block`` requests takes the
lengths at the midpoints of ``block`` equal strata of each distribution,
prompt and output lengths paired by one fixed permutation, each block's
pairs in an order of one fixed draw.  Pairing and order are the same for
every seed, so every seed offers the same requests, size for size and in
the same order (a closed loop's work depends on the order): the seed
draws the token ids and the weights, not the amount of work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from benchkit import samplers

# stream tags: independent draws from one seed
STREAMS = {"measured": 1, "ladder": 3, "weights": 4, "sample": 5,
           "pairing": 6}


def rng_for(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                STREAMS[stream]]))


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Item:
    """One request of a stream: its prompt and output length."""
    prompt: np.ndarray
    max_new: int


def _lengths(spec: Dict, u: np.ndarray) -> np.ndarray:
    if spec["kind"] != "bounded_pareto":
        raise ValueError(f"unknown length distribution {spec['kind']!r}")
    return samplers.bounded_pareto(u, spec["lo"], spec["hi"], spec["alpha"])


class Stream:
    """The requests of one stream of a mix, made block by block on demand
    from ``rng_for(seed, tag)``."""

    def __init__(self, mix: Dict, vocab: int, seed: int, tag: str):
        self.mix = mix
        self.vocab = int(vocab)
        self.rng = rng_for(seed, tag)
        self.block = int(mix["block"])
        self.items: List[Item] = []
        u = (np.arange(self.block) + 0.5) / self.block
        # the same pairs and order for every seed: one fixed draw
        self.fixed = rng_for(0, "pairing")
        pair = self.fixed.permutation(self.block)
        self.sizes = list(zip(_lengths(mix["prompt_len"], u).tolist(),
                              _lengths(mix["output_len"], u[pair]).tolist()))

    def _grow(self) -> None:
        for i in self.fixed.permutation(self.block):
            plen, out = self.sizes[i]
            prompt = self.rng.integers(0, self.vocab, size=plen)
            self.items.append(Item(prompt.astype(np.int32), int(out)))

    def __getitem__(self, i: int) -> Item:
        while i >= len(self.items):
            self._grow()
        return self.items[i]
