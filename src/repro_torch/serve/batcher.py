"""Deadline-aware request batching for online serving.

Groups incoming requests into fixed-size batches (padding the tail) and
decides WHEN to launch: the standard online-serving trade — larger
batches amortize per-call costs (host->device transfer, jit dispatch,
kernel launch), the flush deadline bounds tail latency.  The paper's
workloads (200M req/min) live or die on this amortization; its §7.2
tail-latency numbers live or die on the flush policy.

Flush policy (``ready``): a batch launches when EITHER

  * it is full (``len(queue) >= batch_size``), or
  * the earliest *flush point* among queued requests has passed.  Each
    request's flush point is ``min(enqueued_at + max_wait_ms,
    deadline_at)`` — the max-wait term bounds staleness (no request
    waits in the queue longer than ``max_wait_ms``), the deadline term
    makes batching *deadline-aware*: a request submitted with a tight
    ``deadline_ms`` (or inheriting the batcher's default SLO budget
    ``slo_ms``) pulls its batch's launch forward instead of burning its
    whole latency budget waiting for peers.

``max_wait_ms=None`` disables the time-based flush entirely (flush on
count only) — kept as the measurable baseline the deadline policy beats
at sparse load (benchmarks/bench_serve_loop.py, docs/benchmarks.md).

Choosing ``batch_size``: per-request cost on the batched feature path
falls roughly as 1/B until the device is compute-bound (see
benchmarks/bench_online_batch.py).  Under heavy traffic large batches
are nearly free (the queue fills faster than any deadline); under
sparse traffic the flush points dominate and ``max_wait_ms ~ p99
budget - service time`` keeps tails bounded.  Padded slots (tail
batches) recompute the last real request — wasted work that the
``padded_slots`` counter makes observable.

All time-dependent methods take an explicit ``now`` (seconds) so the
batcher can run against an injected ``serve.clock.Clock`` — flush
decisions become a pure function of (queue state, now), which is what
makes them property-testable (tests/test_batcher_props.py) and
replayable (serve/trace.py).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Deque, List, Optional, Tuple

__all__ = ["RequestBatcher"]


@dataclasses.dataclass
class _Pending:
    request_id: int
    payload: Any
    enqueued_at: float
    deadline_at: float       # absolute seconds; +inf = no deadline

    def flush_at(self, max_wait_ms: Optional[float]) -> float:
        """The instant this request forces its batch to launch."""
        wait_cap = (self.enqueued_at + max_wait_ms * 1e-3
                    if max_wait_ms is not None else math.inf)
        return min(wait_cap, self.deadline_at)


class RequestBatcher:
    def __init__(self, batch_size: int, max_wait_ms: Optional[float] = 5.0,
                 slo_ms: Optional[float] = None):
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.slo_ms = slo_ms
        self.queue: Deque[_Pending] = collections.deque()
        self._next_id = 0
        self.batches_emitted = 0
        self.padded_slots = 0
        self.size_flushes = 0
        self.deadline_flushes = 0

    def submit(self, payload: Any, now: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Enqueue a request.  ``deadline_ms`` is the request's latency
        budget relative to ``now`` (defaults to the batcher's ``slo_ms``;
        None with no ``slo_ms`` means no deadline)."""
        rid = self._next_id
        self._next_id += 1
        now = now if now is not None else time.perf_counter()
        budget = deadline_ms if deadline_ms is not None else self.slo_ms
        deadline_at = now + budget * 1e-3 if budget is not None else math.inf
        self.queue.append(_Pending(rid, payload, now, deadline_at))
        return rid

    def next_flush_at(self) -> float:
        """Earliest flush point among queued requests (+inf if empty or
        count-only with no deadlines) — the serving loop's next wakeup."""
        if not self.queue:
            return math.inf
        return min(p.flush_at(self.max_wait_ms) for p in self.queue)

    def ready(self, now: Optional[float] = None) -> bool:
        if not self.queue:
            return False
        if len(self.queue) >= self.batch_size:
            return True
        now = now if now is not None else time.perf_counter()
        return now >= self.next_flush_at()

    def next_batch(self, pad_with: Any = None,
                   now: Optional[float] = None
                   ) -> Tuple[List[int], List[Any], int]:
        """Returns (request ids, payloads padded to batch_size, n_real).

        An empty queue yields ``([], [], 0)`` — nothing to pad from (and
        with ``pad_with=None`` there is no last payload to replicate).
        """
        n = min(self.batch_size, len(self.queue))
        if n == 0:
            return [], [], 0
        if len(self.queue) >= self.batch_size:
            self.size_flushes += 1
        else:
            self.deadline_flushes += 1
        items = [self.queue.popleft() for _ in range(n)]
        ids = [it.request_id for it in items]
        payloads = [it.payload for it in items]
        n_real = len(payloads)
        while len(payloads) < self.batch_size:
            payloads.append(pad_with if pad_with is not None
                            else payloads[-1])
            self.padded_slots += 1
        self.batches_emitted += 1
        return ids, payloads, n_real
