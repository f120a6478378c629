"""Event-driven serving loop: tail-latency SLOs around the feature engine.

``FeatureEngine`` is a synchronous call surface; this module is the
*service* the paper measures in §7.2 (TP-50/99/999 under mixed request +
ingest traffic).  ``ServeLoop`` wraps an engine with three mechanisms
that bound the tail, and the discipline that makes the tail testable:

* **Deadline-aware batching** — requests queue in a ``RequestBatcher``
  and a batch launches when it is full or at its earliest flush point:
  each request carries a deadline (``deadline_ms`` or the loop's
  ``slo_ms``) and flushes by ``min(enqueued + max_wait_ms, deadline)``.
  Under load batches fill; at sparse load the deadline flushes early
  instead of spending the budget waiting for peers.

* **Admission control** — the request queue is bounded (``max_queue``):
  past it ``submit`` sheds with a typed ``AdmissionError`` (shed
  requests never reach the fold path).  The ingest queue is bounded too
  (``ingest_queue_rows``): past it the writer pays, applying pending
  ingest inline, while requests keep reading the snapshot.

* **Snapshot double buffer** — every flush serves from an
  ``EngineSnapshot`` (the store's tables and the pre-agg states; O(#
  tables) to cut, because no mutation writes a tensor in place).
  ``ingest_many`` and compaction run on the live store, and the snapshot
  swaps only *between* flushes, so a write or a retention pass never
  stalls, or leaks into, a batch.

* **Virtual clock + record/replay** — every decision reads the injected
  ``Clock`` (``serve.clock``), and with ``recorder=`` every external
  stimulus (submit/ingest/step/flush/drain) is logged with its clock
  time; ``serve.trace.replay`` re-drives a fresh loop through the same
  interleaving under a ``VirtualClock``, reproducing every batching,
  shedding and swap decision and every served byte.

The loop is single-threaded and event-driven: "async" means the request
path never waits on the write path, as an explicit interleaving the
clock determines.  A flush's service time runs from the call to the
features copied back to the host (``request_batch`` ends with that copy,
which waits for the card).
"""

from __future__ import annotations

import collections
import math
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, \
    Tuple

import numpy as np

from .batcher import RequestBatcher
from .clock import Clock, SystemClock, VirtualClock
from .engine import FeatureEngine

__all__ = ["ServeLoop", "AdmissionError"]


class AdmissionError(RuntimeError):
    """Typed load-shed rejection: the loop's bounded request queue is
    full.  The request never reached the fold path."""

    def __init__(self, queued: int, max_queue: int):
        self.queued = queued
        self.max_queue = max_queue
        super().__init__(
            f"request shed: admission queue full ({queued} queued >= "
            f"max_queue={max_queue}); retry after a flush or raise "
            f"max_queue")


class ServeLoop:
    """Deadline-batched, admission-controlled, snapshot-serving loop.

    Parameters
    ----------
    engine : the deployed ``FeatureEngine``.
    clock : injected time source; defaults to ``SystemClock``.  Pass a
        ``VirtualClock`` for deterministic tests and replay.
    slo_ms : default per-request latency budget; a request's deadline is
        ``submit time + slo_ms`` unless it carries ``deadline_ms``.  Used
        for flush scheduling and ``deadline_misses`` accounting.
    max_wait_ms : queue-staleness bound of the batcher (None = flush on
        count only, the baseline the deadline policy is measured
        against).
    batch_size : flush width (defaults to the engine's batcher width).
    max_queue : admission bound on queued requests; past it ``submit``
        raises ``AdmissionError``.
    ingest_queue_rows : backpressure bound on buffered ingest rows; past
        it pending ingest is applied inline.
    recorder : optional ``serve.trace.TraceRecorder``, which logs every
        external stimulus for replay.
    service_model : optional ``f(n_real) -> service_ms``.  With a
        ``VirtualClock`` the clock advances by the modelled service time
        at each flush instead of sampling the wall, so latencies are
        deterministic too.
    """

    def __init__(self, engine: FeatureEngine, clock: Optional[Clock] = None,
                 slo_ms: float = 25.0, max_wait_ms: Optional[float] = 5.0,
                 batch_size: Optional[int] = None, max_queue: int = 256,
                 ingest_queue_rows: int = 4096,
                 recorder=None,
                 service_model: Optional[Callable[[int], float]] = None):
        self.engine = engine
        self.clock = clock if clock is not None else SystemClock()
        self.slo_ms = float(slo_ms)
        self.batch_size = int(batch_size or engine.batcher.batch_size)
        self.batcher = RequestBatcher(self.batch_size,
                                      max_wait_ms=max_wait_ms,
                                      slo_ms=slo_ms)
        self.max_queue = int(max_queue)
        self.ingest_queue_rows = int(ingest_queue_rows)
        self.recorder = recorder
        self.service_model = service_model
        self.snap = engine.snapshot()
        self._ingest_q: Deque[Tuple[str, List[Dict[str, Any]]]] = \
            collections.deque()
        self._ingest_q_rows = 0
        self._submit_t: Dict[int, float] = {}
        self._deadline_at: Dict[int, float] = {}
        self.results: Dict[int, Dict[str, np.ndarray]] = {}
        self.latencies: List[float] = []
        self.stats = {"accepted": 0, "shed": 0, "served": 0,
                      "size_flushes": 0, "deadline_flushes": 0,
                      "forced_flushes": 0, "deadline_misses": 0,
                      "ingest_rows": 0, "ingest_applies": 0,
                      "snapshot_swaps": 0, "backpressure_applies": 0}

    # ------------------------------------------------------------ intake
    def _now(self, now: Optional[float]) -> float:
        return now if now is not None else self.clock.now()

    def submit(self, row: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               now: Optional[float] = None) -> int:
        """Enqueue one request; returns its id.  Sheds with a typed
        ``AdmissionError`` when the bounded queue is full: the shed
        request is recorded (replay reproduces the rejection) but never
        enters the batcher."""
        now = self._now(now)
        if self.recorder is not None:
            self.recorder.record("request", now, row=row,
                                 deadline_ms=deadline_ms)
        if len(self.batcher.queue) >= self.max_queue:
            self.stats["shed"] += 1
            raise AdmissionError(len(self.batcher.queue), self.max_queue)
        rid = self.batcher.submit(row, now=now, deadline_ms=deadline_ms)
        budget = deadline_ms if deadline_ms is not None else self.slo_ms
        self._submit_t[rid] = now
        self._deadline_at[rid] = (now + budget * 1e-3
                                  if budget is not None else math.inf)
        self.stats["accepted"] += 1
        return rid

    def ingest(self, table: str, rows: Sequence[Dict[str, Any]],
               now: Optional[float] = None) -> None:
        """Queue rows for application to the live store.  They become
        visible to requests only after an apply (``step`` with no flush
        due, ``drain_ingest``, or backpressure) swaps the snapshot.  Past
        ``ingest_queue_rows`` buffered rows the writer pays: pending
        batches are applied inline until the queue fits."""
        now = self._now(now)
        if self.recorder is not None:
            self.recorder.record("ingest", now, table=table,
                                 rows=list(rows))
        self._ingest_q.append((table, list(rows)))
        self._ingest_q_rows += len(rows)
        while self._ingest_q_rows > self.ingest_queue_rows:
            self.stats["backpressure_applies"] += 1
            self._apply_one_ingest()

    # ------------------------------------------------------------- drive
    def step(self, now: Optional[float] = None
             ) -> Dict[int, Dict[str, np.ndarray]]:
        """One loop iteration: flush a due batch, else apply one queued
        ingest (+ snapshot swap), else nothing.  Requests outrank ingest.
        Returns the requests completed this step ({rid: features})."""
        now = self._now(now)
        if self.recorder is not None:
            self.recorder.record("step", now)
        if self.batcher.ready(now):
            return self._flush_one(now)
        if self._ingest_q:
            self._apply_one_ingest()
        return {}

    def flush(self, now: Optional[float] = None
              ) -> Dict[int, Dict[str, np.ndarray]]:
        """Force-drain the whole request queue now (deadline or not), as
        at shutdown; recorded so replay keeps the batch boundaries."""
        now = self._now(now)
        if self.recorder is not None:
            self.recorder.record("flush", now)
        out: Dict[int, Dict[str, np.ndarray]] = {}
        while self.batcher.queue:
            self.stats["forced_flushes"] += 1
            out.update(self._flush_one(now, forced=True))
        return out

    def drain_ingest(self, now: Optional[float] = None) -> int:
        """Apply every queued ingest batch to the live store and swap the
        snapshot; returns the rows applied.  After it, new requests
        observe all prior ingest."""
        now = self._now(now)
        if self.recorder is not None:
            self.recorder.record("drain", now)
        applied = 0
        while self._ingest_q:
            applied += self._apply_one_ingest()
        return applied

    def run_until_idle(self, max_wall_s: float = 60.0
                       ) -> Dict[int, Dict[str, np.ndarray]]:
        """Drive the loop until every queued request is served and every
        queued ingest applied, advancing the clock to the next flush
        point when nothing is due.  A count-only partial tail batch
        (``max_wait_ms=None``) has no flush point and is force-flushed.
        Not recorded: with no new arrivals the order is fixed by the
        queues, so replaying the recorded stimuli reproduces it."""
        out: Dict[int, Dict[str, np.ndarray]] = {}
        t_end = time.perf_counter() + max_wall_s
        while self.batcher.queue or self._ingest_q:
            if time.perf_counter() > t_end:
                raise TimeoutError("run_until_idle exceeded "
                                   f"{max_wall_s}s wall budget")
            now = self.clock.now()
            if self.batcher.ready(now):
                out.update(self._flush_one(now))
            elif self._ingest_q:
                self._apply_one_ingest()
            else:
                nxt = self.batcher.next_flush_at()
                if math.isinf(nxt):          # count-only partial tail
                    self.stats["forced_flushes"] += 1
                    out.update(self._flush_one(now, forced=True))
                else:
                    self.clock.wait_until(nxt)
        return out

    # ---------------------------------------------------------- internals
    def _flush_one(self, now: float, forced: bool = False
                   ) -> Dict[int, Dict[str, np.ndarray]]:
        size_flush = len(self.batcher.queue) >= self.batch_size
        ids, payloads, n_real = self.batcher.next_batch(now=now)
        if n_real == 0:
            return {}
        if not forced:
            key = "size_flushes" if size_flush else "deadline_flushes"
            self.stats[key] += 1
        t0 = time.perf_counter()
        feats = self.engine.request_batch(payloads[:n_real],
                                          snapshot=self.snap)
        svc_ms = (self.service_model(n_real) if self.service_model
                  is not None else (time.perf_counter() - t0) * 1e3)
        if self.service_model is not None and \
                isinstance(self.clock, VirtualClock):
            self.clock.advance(svc_ms * 1e-3)
        done_t = now + svc_ms * 1e-3
        out: Dict[int, Dict[str, np.ndarray]] = {}
        for rid, f in zip(ids, feats):
            self.results[rid] = f
            out[rid] = f
            self.latencies.append((done_t - self._submit_t.pop(rid)) * 1e3)
            if done_t > self._deadline_at.pop(rid):
                self.stats["deadline_misses"] += 1
        self.stats["served"] += n_real
        return out

    def _apply_one_ingest(self) -> int:
        """Apply one queued ingest batch to the LIVE store (retention and
        compaction and the pre-agg fold run inside ``ingest_many``), then
        swap the snapshot."""
        table, rows = self._ingest_q.popleft()
        self._ingest_q_rows -= len(rows)
        self.engine.ingest_many(table, rows)
        self.snap.refresh()
        self.stats["ingest_rows"] += len(rows)
        self.stats["ingest_applies"] += 1
        self.stats["snapshot_swaps"] += 1
        return len(rows)

    # ------------------------------------------------------------- stats
    def poll(self, rid: int) -> Optional[Dict[str, np.ndarray]]:
        return self.results.get(rid)

    def latency_percentiles(self) -> Dict[str, float]:
        """End-to-end (submit -> completion) request percentiles,
        queueing included: the §7.2 TP-50/99/999 view.  {} when nothing
        was served."""
        if not self.latencies:
            return {}
        arr = np.asarray(self.latencies)
        return {"TP50": float(np.percentile(arr, 50)),
                "TP99": float(np.percentile(arr, 99)),
                "TP999": float(np.percentile(arr, 99.9)),
                "max_ms": float(arr.max())}

    def reset_stats(self):
        """Drop warm-up samples before measuring; queue state and results
        are kept."""
        self.latencies.clear()
        for k in self.stats:
            self.stats[k] = 0
        self.engine.reset_stats()
