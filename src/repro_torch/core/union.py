"""Self-adjusted window union (§5.2): host-side load balancing and
incremental window folds.

Two mechanisms, mapped from threads to shards:

1. **On-the-fly load balancing** — a static hash of keys onto workers (the
   Flink baseline) collapses under skew.  ``LoadBalancer`` tracks per-key
   processing cost (a float64 EMA of tuples folded per key) and
   recomputes the key->worker map with greedy LPT bin-packing; hot keys
   may be *split* across several workers (each folds a partial state,
   partials merge by the leaf monoid).

2. **Incremental computation** — ``SlidingAggregator`` keeps a running
   window fold per key and, on each arriving tuple, evicts expired rows
   by prefix difference (Subtract-and-Evict [58]) instead of re-folding
   the window: O(1) amortized per tuple vs O(window).

``storage.timestore.ShardedOnlineStore`` owns a ``LoadBalancer`` over
its hash-route slots: ``rebalance()`` re-runs the greedy LPT over the
observed ingest load and migrates resident rows (and the engine its
pre-agg planes) to the new owners.  The store moves keys *whole*: the
split-key fan-out is only sound for order-insensitive merges, while the
sharded request path's bit-exactness relies on one shard holding a key's
full ordered history.  Host numpy throughout; the EMA, the LPT order and
its tie-breaking are those of the reference, so a rebalance routes every
slot to the same shard in both packages.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch

from .functions import AddLeaf, EWLeaf, Leaf
from .hll import splitmix64

__all__ = ["LoadBalancer", "SlidingAggregator", "static_hash_assign"]


def static_hash_assign(n_keys: int, n_workers: int) -> np.ndarray:
    """The rigid baseline: key -> worker by hash (Flink-style)."""
    keys = np.arange(n_keys, dtype=np.uint64)
    return (splitmix64(keys) % np.uint64(n_workers)).astype(np.int32)


class LoadBalancer:
    """Dynamic key->worker assignment from observed load."""

    def __init__(self, n_keys: int, n_workers: int, ema: float = 0.5,
                 split_threshold: float = 1.5):
        self.n_keys = n_keys
        self.n_workers = n_workers
        self.ema = ema
        self.split_threshold = split_threshold
        self.load = np.zeros(n_keys, dtype=np.float64)
        self.assignment = static_hash_assign(n_keys, n_workers)
        # keys allowed to fan out over several workers (hot keys)
        self.split_keys: Dict[int, int] = {}

    def observe(self, key_counts: np.ndarray):
        """Update the per-key cost EMA with a batch's tuple counts."""
        self.load = self.ema * key_counts + (1 - self.ema) * self.load

    def rebalance(self) -> np.ndarray:
        """Greedy LPT: heaviest key to the least-loaded worker; keys
        heavier than ``split_threshold`` * mean worker load are split."""
        order = np.argsort(-self.load)
        worker_load = np.zeros(self.n_workers, dtype=np.float64)
        assign = np.zeros(self.n_keys, dtype=np.int32)
        self.split_keys.clear()
        total = float(self.load.sum())
        fair = total / self.n_workers if self.n_workers else 0.0
        for k in order:
            cost = float(self.load[k])
            if fair > 0 and cost > self.split_threshold * fair:
                # split a hot key across ceil(cost/fair) workers
                n_split = min(self.n_workers, int(np.ceil(cost / fair)))
                ws = np.argsort(worker_load)[:n_split]
                worker_load[ws] += cost / n_split
                assign[k] = int(ws[0])
                self.split_keys[int(k)] = n_split
            else:
                w = int(np.argmin(worker_load))
                worker_load[w] += cost
                assign[k] = w
        self.assignment = assign
        return assign

    def imbalance(self, key_counts: np.ndarray,
                  assignment: Optional[np.ndarray] = None) -> float:
        """max-worker-load / mean-worker-load under an assignment,
        accounting for split keys (their load spreads evenly)."""
        assign = self.assignment if assignment is None else assignment
        loads = np.zeros(self.n_workers, dtype=np.float64)
        for k in range(self.n_keys):
            c = float(key_counts[k])
            n_split = self.split_keys.get(k, 1) if assignment is None else 1
            if n_split > 1:
                ws = np.argsort(loads)[:n_split]
                loads[ws] += c / n_split
            else:
                loads[assign[k]] += c
        mean = loads.mean() if loads.mean() > 0 else 1.0
        return float(loads.max() / mean)


class SlidingAggregator:
    """Per-key incremental window state (Subtract-and-Evict).

    Keeps, per key, a deque of (ts, lifted state) plus the fold of every
    row ever pushed and the fold of the expired prefix; the window fold
    is ``invert_prefix(total, evicted)``.  A new tuple costs one combine,
    an eviction one more.  Only invertible leaves qualify — callers fall
    back to re-folding otherwise, the paper's constraint.  Streaming
    combines run in numpy for ``AddLeaf`` and ``EWLeaf`` (per-tuple
    device dispatch would dominate; the algebra is the leaves'), through
    the leaf's torch combine otherwise.
    """

    def __init__(self, leaf: Leaf, window_ms: int):
        if not leaf.invertible:
            raise ValueError("Subtract-and-Evict needs an invertible leaf")
        self.leaf = leaf
        self.window_ms = window_ms
        self._buf: Dict[int, collections.deque] = {}
        self._total: Dict[int, np.ndarray] = {}
        self._evicted: Dict[int, np.ndarray] = {}
        self._comb, self._inv = self._np_ops()
        self._ident = leaf.identity().numpy()
        self.combines = 0  # work counter (benchmarks compare vs re-fold)

    def push(self, key: int, ts: int, lifted: np.ndarray) -> np.ndarray:
        """Add one tuple, evict expired rows, return the window fold."""
        comb = self._comb
        buf = self._buf.setdefault(key, collections.deque())
        total = comb(self._total.get(key, self._ident), np.asarray(lifted))
        evicted = self._evicted.get(key, self._ident)
        self.combines += 1
        buf.append((ts, lifted))
        horizon = ts - self.window_ms
        while buf and buf[0][0] < horizon:
            _, old = buf.popleft()
            evicted = comb(evicted, np.asarray(old))
            self.combines += 1
        self._total[key] = total
        self._evicted[key] = evicted
        self.combines += 1
        return self._inv(total, evicted)

    def _np_ops(self):
        """numpy implementations of the leaf algebra for hot streaming."""
        if isinstance(self.leaf, AddLeaf):
            return (lambda a, b: a + b), (lambda t, e: t - e)
        if isinstance(self.leaf, EWLeaf):
            d = self.leaf.decay

            def comb(a, b):
                s = d ** b[..., 2]
                return np.stack([b[..., 0] + s * a[..., 0],
                                 b[..., 1] + s * a[..., 1],
                                 a[..., 2] + b[..., 2]], axis=-1)

            def inv(t, e):
                n = t[..., 2] - e[..., 2]
                s = d ** n
                return np.stack([t[..., 0] - s * e[..., 0],
                                 t[..., 1] - s * e[..., 1], n], axis=-1)

            return comb, inv
        leaf = self.leaf
        return (lambda a, b: leaf.combine(torch.as_tensor(a),
                                          torch.as_tensor(b)).numpy(),
                lambda t, e: leaf.invert_prefix(torch.as_tensor(t),
                                                torch.as_tensor(e)).numpy())

    def window_fold(self, key: int) -> np.ndarray:
        total = self._total.get(key, self._ident)
        evicted = self._evicted.get(key, self._ident)
        return self.leaf.invert_prefix(torch.as_tensor(total),
                                       torch.as_tensor(evicted)).numpy()
