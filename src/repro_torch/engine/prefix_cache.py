"""Cross-request prefix cache + result-aware request caching.

The result-aware thesis applied to serving state: the engine should price
what it *already knows* against what it would *recompute*.  At serving
scale, what it already knows is the KV/SSM state of every prefix it has
ever prefilled — millions of users share system prompts and few-shot
preambles, yet a naive engine re-prefills every request from token 0.
This module makes that intermediate state a first-class, reusable artifact
(the Whiz/F² position) behind two data structures:

* :class:`PrefixCache` — a radix tree over **committed token sequences**.
  A node's path is a token prefix; a node may own a *snapshot*: one
  slot-pool row (every cache leaf — KV rows, recurrent/conv state, n-gram
  table, draft rows — plus the frozen ``pos``) captured at a tick boundary
  where the slot had consumed exactly that prefix.  ``longest_match`` finds
  the deepest snapshotted ancestor of a new prompt, and the serving engine
  seeds the joining slot from it with one batched in-place row write, so
  prefill cost drops from ``O(len(prompt))`` to ``O(unshared suffix)``.
  Snapshots are **bit-identical** to recomputation: the tick scans
  ``lm.decode_step`` token by token, so the state after P tokens does not
  depend on chunking, slot index, or which pool ran it — seeding is
  replay, not approximation.

* an **exact-hit result cache** — finished greedy outputs keyed by a
  canonical request fingerprint (:func:`request_fingerprint`: tokens +
  max_new + temperature + params-version).  An exact hit skips the slot
  pools entirely.  Greedy decoding is prefix-stable, so a cached response
  also answers any shorter ``max_new`` for the same prompt by truncation —
  result-awareness, not just memoization.  Sampled requests
  (temperature > 0) never store and never hit: their outputs are draws,
  not facts.

Whether a matched prefix is *used* is not a heuristic — it is a measured
Maestro decision (``Engine.choose_prefix_admission``): the engine scores a
``jobs.prefix_seed_workflow`` (copy the cached row, then prefill only the
suffix) against ``jobs.prefill_workflow`` (recompute from token 0) under
first-response time, with the copy cost and per-token prefill cost coming
from per-pool CostBook EMAs.

Memory safety: the tree is capacity-bounded (``cfg.serve`` knobs) with LRU
eviction over snapshot bytes; a node is *not evictable* while a request
seeded from it is in flight (ref-count) or while the workload analyzer has
pinned it.  :class:`PrefixAnalyzer` mines the recent request history for
hot prefixes worth pinning — the serving analog of a materialized-view
advisor: canonicalize → fingerprint → reuse → suggest materializations.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import torch


def to_host(tree):
    """A nested dict of tensors -> the same nested dict of **host copies**
    (CPU tensors: numpy has no bfloat16) — the form every prefix snapshot
    is stored in.  A host snapshot holds no device memory while cached, and
    a seed write copies it into whichever pool it seeds.  Every leaf is a
    fresh copy, also one that already lives on the CPU, so the snapshot
    never aliases a pool row that the next tick writes."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def request_fingerprint(tokens, max_new: int, temperature: float,
                        params_version: int) -> Optional[tuple]:
    """Canonical identity of a request's *answer*, or None when the answer
    is not a deterministic function of the request.

    Canonicalization rules (held against the JAX package's own function in
    tests/test_torch_prefix_cache.py):

    * tokens are canonicalized to a tuple of python ints — the same prompt
      hashes identically whether it arrived as list, np.int32 or np.int64;
    * every ``temperature <= 0`` means greedy and collapses to ``0.0``, so
      ``-1.0`` and ``0.0`` share one cache line;
    * ``temperature > 0`` returns **None** — sampled outputs are draws from
      a distribution, not cacheable facts, so they must MISS;
    * ``params_version`` is part of the key — a hot weight swap must not
      serve answers computed under the old weights.

    ``max_new`` is NOT part of the returned key: the result cache stores
    the longest known greedy continuation per (tokens, params_version) and
    answers shorter requests by truncation (greedy is prefix-stable).
    """
    if temperature > 0:
        return None
    return (tuple(int(t) for t in tokens), int(params_version))


@dataclasses.dataclass
class _Node:
    """One radix-tree node.  ``edge`` is the compressed token run from the
    parent; ``depth`` is the total path length (tokens from root).  A node
    with ``snapshot is not None`` is a reusable prefix state."""
    edge: Tuple[int, ...]
    depth: int
    parent: Optional["_Node"] = None
    children: Dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    snapshot: Any = None          # pool row (host tensors) or None
    pos: int = 0                  # tokens consumed by the snapshot ( == depth)
    version: int = 0              # params_version the snapshot was captured
    #                               under: state computed by OLD weights must
    #                               never seed a slot serving NEW weights
    last_use: int = 0             # LRU clock value of the last hit/insert
    hits: int = 0
    refs: int = 0                 # in-flight requests seeded from this node
    pinned: bool = False          # analyzer-protected from eviction


class PrefixCache:
    """Radix tree of snapshotted prefixes + the exact-hit result cache.

    Pure host-side bookkeeping: device work (row gather for snapshots, row
    scatter for seeding) stays in the serving engine — this class only
    holds references to the captured rows and decides what to keep.
    ``capacity`` bounds the number of live snapshots (the unit the slot
    pools actually pay for); the result cache is bounded separately
    in entries.  Not thread-safe by design: the serving engine mutates it
    between ticks only, like every other piece of scheduler state.
    """

    def __init__(self, capacity: int = 128, min_len: int = 4,
                 result_entries: int = 256):
        assert capacity >= 1 and min_len >= 1 and result_entries >= 0
        self.capacity = capacity
        self.min_len = min_len
        self.result_entries = result_entries
        self.root = _Node(edge=(), depth=0)
        self._clock = 0
        self._snapshots = 0
        # counters surfaced through ServeEngine._inspect("prefix_cache")
        self.hits = 0               # longest_match found a usable snapshot
        self.misses = 0             # no snapshot (or too short) for a prompt
        self.evictions = 0          # snapshots dropped by the LRU bound
        self.result_hits = 0
        self.result_misses = 0
        self.tokens_avoided = 0     # prefill tokens skipped via seeding
        self.seeded = 0             # requests admitted through a seed write
        self.seed_declined = 0      # matches the engine priced out
        # result cache: fingerprint -> (max_new_known, tokens tuple); LRU
        self._results: "OrderedDict[tuple, Tuple[int, Tuple[int, ...]]]" = \
            OrderedDict()
        self._pinned_paths: set = set()

    # ------------------------------------------------------------ radix tree
    def _tick_clock(self) -> int:
        self._clock += 1
        return self._clock

    def longest_match(self, tokens, limit: Optional[int] = None,
                      version: Optional[int] = None) -> Optional[_Node]:
        """Deepest snapshotted node whose path is a prefix of ``tokens``,
        at most ``limit`` tokens deep (the serving engine passes
        ``len(prompt) - 1``: at least one real prompt token must remain to
        produce the first output logits).  ``version`` (not None) restricts
        matches to snapshots captured under that params version — after a
        hot weight swap, old-version KV state must never seed a slot that
        will decode under the new weights (it would replay stale state and
        break greedy bit-identicality).  Touches the LRU clock of the
        returned node only — intermediate structural nodes carry no state
        worth aging."""
        toks = tuple(int(t) for t in tokens)
        limit = len(toks) if limit is None else min(limit, len(toks))
        node, i, best = self.root, 0, None
        while i < limit:
            child = node.children.get(toks[i])
            if child is None:
                break
            edge = child.edge
            if child.depth > limit or \
                    toks[i:i + len(edge)] != edge:
                break
            node, i = child, child.depth
            if node.snapshot is not None and node.depth >= self.min_len \
                    and (version is None or node.version == version):
                best = node
        if best is None:
            self.misses += 1
            return None
        best.last_use = self._tick_clock()
        best.hits += 1
        self.hits += 1
        return best

    def lookup(self, tokens) -> Optional[_Node]:
        """Exact-path node (snapshot or not), no counters touched — the
        snapshot-dedupe path: the engine skips re-capturing a prefix whose
        node already owns a snapshot."""
        toks = tuple(int(t) for t in tokens)
        node, i = self.root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None or toks[i:i + len(child.edge)] != child.edge:
                return None
            node, i = child, child.depth
        return node if node.depth == len(toks) else None

    def _split(self, node: _Node, at: int) -> _Node:
        """Split ``node``'s edge after ``at`` tokens; returns the new
        intermediate parent (snapshotless — state stays with the deep
        half, whose path is unchanged)."""
        assert 0 < at < len(node.edge)
        upper = _Node(edge=node.edge[:at],
                      depth=node.depth - len(node.edge) + at,
                      parent=node.parent)
        node.parent.children[upper.edge[0]] = upper
        node.edge = node.edge[at:]
        node.parent = upper
        upper.children[node.edge[0]] = node
        return upper

    def insert(self, tokens, snapshot=None, version: int = 0
               ) -> Optional[_Node]:
        """Commit a token path into the tree, attaching ``snapshot`` (a
        captured pool row, normalized to host tensors via
        :func:`to_host` by the capturing engine) at its end, tagged with the
        ``version`` of the params it was computed under.  Paths shorter than
        ``min_len`` are not worth a node; re-inserting an existing path
        refreshes its snapshot/version/LRU slot.  Returns the node (None
        when the path was rejected as too short)."""
        toks = tuple(int(t) for t in tokens)
        if len(toks) < self.min_len:
            return None
        node, i = self.root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                child = _Node(edge=toks[i:], depth=len(toks), parent=node)
                node.children[toks[i]] = child
                node, i = child, len(toks)
                break
            edge = child.edge
            common = 0
            while common < len(edge) and i + common < len(toks) and \
                    edge[common] == toks[i + common]:
                common += 1
            if common < len(edge):
                upper = self._split(child, common)
                if i + common == len(toks):
                    node, i = upper, len(toks)
                    break
                rest = _Node(edge=toks[i + common:], depth=len(toks),
                             parent=upper)
                upper.children[rest.edge[0]] = rest
                node, i = rest, len(toks)
                break
            node, i = child, child.depth
        assert node.depth == len(toks)
        if snapshot is not None:
            if node.snapshot is None:
                self._snapshots += 1
            node.snapshot = snapshot
            node.pos = len(toks)
            node.version = int(version)
            node.last_use = self._tick_clock()
            if toks in self._pinned_paths:
                node.pinned = True
            self._enforce_capacity()
        return node

    def acquire(self, node: _Node) -> None:
        node.refs += 1

    def release(self, node: _Node) -> None:
        assert node.refs > 0, "release without acquire"
        node.refs -= 1

    def _snapshot_nodes(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.snapshot is not None:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _prune(self, node: _Node) -> None:
        """Remove snapshotless leaf chains so evicted paths do not leave
        structural litter behind."""
        while (node is not self.root and node.snapshot is None
               and not node.children):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    def _enforce_capacity(self) -> None:
        """LRU eviction over snapshots.  Pinned nodes and nodes with live
        refs are not evictable — if everything is protected the cache runs
        over capacity rather than corrupting an in-flight seed (the bound
        is restored as soon as refs drain)."""
        while self._snapshots > self.capacity:
            victims = [n for n in self._snapshot_nodes()
                       if n.refs == 0 and not n.pinned]
            if not victims:
                return
            victim = min(victims, key=lambda n: n.last_use)
            victim.snapshot = None
            self._snapshots -= 1
            self.evictions += 1
            self._prune(victim)

    def flush_versions(self, keep: int) -> int:
        """Drop every snapshot whose version differs from ``keep`` — the
        weight-publish hook: after a hot swap nothing captured under the old
        weights can ever match again (``longest_match`` filters by version),
        so the bytes are pure waste.  Nodes with live refs keep their
        snapshot until the in-flight seed drains (the seeded request itself
        joined under the old version and is version-gated out of
        re-snapshotting).  Returns the number of snapshots dropped."""
        dropped = 0
        for n in self._snapshot_nodes():
            if n.version != keep and n.refs == 0:
                n.snapshot = None
                self._snapshots -= 1
                self.evictions += 1
                dropped += 1
                self._prune(n)
        return dropped

    def pin(self, tokens) -> bool:
        """Protect a prefix from eviction (analyzer-driven).  Pins the node
        if it exists now and remembers the path so a later snapshot of it
        is born pinned."""
        toks = tuple(int(t) for t in tokens)
        self._pinned_paths.add(toks)
        node = self.lookup(toks)
        if node is not None:
            node.pinned = True
            return True
        return False

    @property
    def pinned(self) -> int:
        return sum(1 for n in self._snapshot_nodes() if n.pinned)

    @property
    def snapshots(self) -> int:
        return self._snapshots

    # ---------------------------------------------------------- result cache
    def result_lookup(self, tokens, max_new: int, temperature: float,
                      params_version: int) -> Optional[List[int]]:
        """Exact-hit answer for a request, or None.  A stored continuation
        longer than ``max_new`` answers by truncation (greedy is
        prefix-stable); a shorter one is NOT enough and misses."""
        fp = request_fingerprint(tokens, max_new, temperature,
                                 params_version)
        if fp is None or self.result_entries == 0:
            self.result_misses += 1
            return None
        entry = self._results.get(fp)
        if entry is None or entry[0] < max_new:
            self.result_misses += 1
            return None
        self._results.move_to_end(fp)
        self.result_hits += 1
        return list(entry[1][:max_new])

    def result_store(self, tokens, max_new: int, temperature: float,
                     params_version: int, output) -> bool:
        """Record a finished request's output.  Only deterministic
        (greedy) results store; a longer continuation for the same
        fingerprint replaces a shorter one."""
        fp = request_fingerprint(tokens, max_new, temperature,
                                 params_version)
        if fp is None or self.result_entries == 0:
            return False
        out = tuple(int(t) for t in output)
        prev = self._results.get(fp)
        if prev is not None and prev[0] >= len(out):
            self._results.move_to_end(fp)
            return False
        self._results[fp] = (len(out), out)
        self._results.move_to_end(fp)
        while len(self._results) > self.result_entries:
            self._results.popitem(last=False)
        return True

    # -------------------------------------------------------------- counters
    def stats(self) -> Dict[str, Any]:
        return {"enabled": True, "nodes": len(self._snapshot_nodes()),
                "snapshots": self._snapshots, "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "pinned": self.pinned,
                "seeded": self.seeded, "seed_declined": self.seed_declined,
                "tokens_avoided": self.tokens_avoided,
                "result_hits": self.result_hits,
                "result_misses": self.result_misses,
                "result_entries": len(self._results)}


class PrefixAnalyzer:
    """Workload analyzer: mines the recent request history for hot shared
    prefixes worth pinning in the :class:`PrefixCache`.

    Canonicalize → fingerprint → count → suggest: each submitted prompt is
    truncated to candidate prefix lengths on a coarse grid (powers of two
    of ``min_len`` — the same boundaries prefill-tick snapshots land on,
    so suggestions map onto nodes the tree can actually hold), counted in a
    bounded sliding window, and any prefix seen at least ``pin_count``
    times is reported hot.  The serving engine pins the suggestions, which
    exempts those snapshots from LRU eviction — the serving analog of a
    materialized-view advisor promoting a hot subplan."""

    def __init__(self, min_len: int = 4, pin_count: int = 3,
                 history: int = 512):
        self.min_len = max(min_len, 1)
        self.pin_count = max(pin_count, 1)
        self.history = max(history, 1)
        self._window: deque = deque()
        self._counts: Counter = Counter()

    def _grid(self, plen: int):
        L = self.min_len
        while L <= plen - 1:          # a seed must leave >= 1 prompt token
            yield L
            L *= 2

    def record(self, tokens) -> None:
        toks = tuple(int(t) for t in tokens)
        prefixes = [toks[:L] for L in self._grid(len(toks))]
        self._window.append(prefixes)
        for p in prefixes:
            self._counts[p] += 1
        while len(self._window) > self.history:
            for p in self._window.popleft():
                self._counts[p] -= 1
                if self._counts[p] <= 0:
                    del self._counts[p]

    def hot_prefixes(self) -> List[Tuple[int, ...]]:
        """Hot prefixes, longest first — pinning the longest shared run
        dominates pinning its own prefixes (a match at depth d covers every
        shallower boundary)."""
        hot = [p for p, c in self._counts.items() if c >= self.pin_count]
        hot.sort(key=len, reverse=True)
        return hot
