"""Record-and-replay for the serving loop.

A serving run is determined by the engine's deployment (script, tables,
configuration) and the interleaved stream of external stimuli: requests,
ingest batches and the instants the loop was driven, because every
decision of ``ServeLoop`` reads the injected clock and the fold is
deterministic.  A *trace* is that stimulus stream with clock times;
replaying it through a fresh loop under a ``VirtualClock`` restamped
from the recorded times reproduces every batching, shedding and
snapshot-swap decision and every served byte, mid-trace eviction and
compaction included (they are re-triggered by the same ingest stream).

Traces serialize to JSON (``save_trace`` / ``load_trace``) in the JAX
package's format, so a trace recorded by either package replays in the
other.

``record_consistency_trace`` drives an engine through the canonical
consistency interleaving (rows of every table in the offline (ts, rank,
arrival) order; each base row served as a request *before* it is
ingested) under a recording loop: the serving-loop mirror of
``core.consistency.replay_online``, whose outputs
``verify_consistency(bitwise=True, online_outputs=...)`` gates against
``offline()``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .clock import VirtualClock
from .engine import FeatureEngine
from .loop import AdmissionError, ServeLoop

__all__ = ["TraceEvent", "TraceRecorder", "save_trace", "load_trace",
           "replay", "record_consistency_trace", "outputs_in_base_order",
           "store_state_arrays"]


def _plain(v):
    """JSON-safe scalar: numpy -> python, arrays -> lists."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


@dataclasses.dataclass
class TraceEvent:
    """One external stimulus: op in {request, ingest, step, flush,
    drain}, stamped with the loop clock's time at arrival."""

    op: str
    t: float
    row: Optional[Dict[str, Any]] = None          # request payload
    deadline_ms: Optional[float] = None           # request budget
    table: Optional[str] = None                   # ingest target
    rows: Optional[List[Dict[str, Any]]] = None   # ingest payload

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"op": self.op, "t": self.t}
        if self.row is not None:
            d["row"] = {k: _plain(v) for k, v in self.row.items()}
        if self.deadline_ms is not None:
            d["deadline_ms"] = float(self.deadline_ms)
        if self.table is not None:
            d["table"] = self.table
        if self.rows is not None:
            d["rows"] = [{k: _plain(v) for k, v in r.items()}
                         for r in self.rows]
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TraceEvent":
        return TraceEvent(op=d["op"], t=float(d["t"]), row=d.get("row"),
                          deadline_ms=d.get("deadline_ms"),
                          table=d.get("table"), rows=d.get("rows"))


class TraceRecorder:
    """Passed as ``ServeLoop(recorder=...)``: collects the stimulus
    stream (one append per event; payloads are made JSON-safe only when
    saved)."""

    def __init__(self):
        self.events: List[TraceEvent] = []

    def record(self, op: str, t: float, **kw) -> None:
        self.events.append(TraceEvent(op=op, t=t, **kw))

    def to_json(self) -> List[Dict[str, Any]]:
        return [e.to_json() for e in self.events]


def save_trace(events: Sequence[TraceEvent], path: str) -> None:
    with open(path, "w") as f:
        json.dump([e.to_json() for e in events], f)


def load_trace(path: str) -> List[TraceEvent]:
    with open(path) as f:
        return [TraceEvent.from_json(d) for d in json.load(f)]


def replay(events: Sequence[TraceEvent],
           engine_factory: Callable[[], FeatureEngine],
           **loop_kwargs) -> ServeLoop:
    """Re-drive a fresh loop through a recorded stimulus stream under a
    ``VirtualClock`` restamped from each event's time; shed requests
    shed again (the ``AdmissionError`` is swallowed, as the recording
    client did).  Returns the loop: ``loop.results`` holds the served
    features by request id (ids follow submit order, so they match the
    recording run) and ``loop.engine`` the final live state."""
    clock = VirtualClock()
    loop = ServeLoop(engine_factory(), clock=clock, **loop_kwargs)
    for ev in events:
        clock.set(ev.t)
        if ev.op == "request":
            try:
                loop.submit(ev.row, deadline_ms=ev.deadline_ms, now=ev.t)
            except AdmissionError:
                pass                        # replayed shed
        elif ev.op == "ingest":
            loop.ingest(ev.table, ev.rows, now=ev.t)
        elif ev.op == "step":
            loop.step(now=ev.t)
        elif ev.op == "flush":
            loop.flush(now=ev.t)
        elif ev.op == "drain":
            loop.drain_ingest(now=ev.t)
        else:
            raise ValueError(f"unknown trace op {ev.op!r}")
    return loop


def store_state_arrays(engine: FeatureEngine
                       ) -> List[Tuple[str, np.ndarray]]:
    """The engine's live store state as host arrays with stable labels
    (``table/cols/<name>``, ``table/count``, ``table/keys``,
    ``table/ts``; tables, leaves and columns in sorted order, as the JAX
    package flattens its state), for bitwise final-state comparisons.
    The derived ``comp`` column is left out."""
    out: List[Tuple[str, np.ndarray]] = []
    for t in sorted(engine.store.tables):
        st = engine.store.tables[t]
        for c in sorted(st["cols"]):
            out.append((f"{t}/cols/{c}", st["cols"][c].cpu().numpy()))
        for k in ("count", "keys", "ts"):
            out.append((f"{t}/{k}", st[k].cpu().numpy()))
    return out


def record_consistency_trace(engine: FeatureEngine,
                             tables: Dict[str, Any],
                             slo_ms: float = 1e6
                             ) -> Tuple[ServeLoop, List[TraceEvent],
                                        List[int]]:
    """Drive ``engine`` through the canonical consistency interleaving
    under a recording ``ServeLoop``; returns (loop, events, rids).

    Events follow ``core.consistency._event_stream`` (all tables merged
    by the offline (ts, rank, arrival) tie-break); each base row is
    submitted and flushed as a request BEFORE it is ingested, and every
    ingest is drained (applied + snapshot swap) before the next event,
    so request k sees exactly the rows the offline fold gives it.
    Virtual time is the event's timestamp (ms -> s).  Evictions of a
    retention engine are not events: the same ingest stream re-triggers
    the same retention ticks on replay."""
    from ..core.consistency import _event_stream

    rec = TraceRecorder()
    clock = VirtualClock()
    loop = ServeLoop(engine, clock=clock, recorder=rec, batch_size=1,
                     max_wait_ms=0.0, slo_ms=slo_ms,
                     max_queue=max(4, len(tables[engine.cs.script
                                          .base_table])))
    base = engine.cs.script.base_table
    rids: List[int] = []
    for ts, _, i, tname in _event_stream(engine.cs, tables):
        table = tables[tname]
        row = {c: table.columns[c][i]
               for c in table.schema.column_names}
        t = ts * 1e-3
        clock.set(t)
        if tname == base:
            rids.append(loop.submit(row, now=t))
            loop.flush(now=t)
        loop.ingest(tname, [row], now=t)
        loop.drain_ingest(now=t)
    return loop, rec.events, rids


def outputs_in_base_order(loop: ServeLoop, rids: Sequence[int],
                          tables: Dict[str, Any], cs
                          ) -> Dict[str, np.ndarray]:
    """A consistency-trace run's results in offline row order: ``rids``
    are in replay (ts, arrival) order; invert the same lexsort
    ``replay_online`` uses so the arrays align with ``cs.offline``."""
    base = cs.script.base_table
    base_ts = tables[base].columns[cs.script.order_column]
    n_base = len(tables[base])
    replay_order = np.lexsort((np.arange(n_base), base_ts))
    inv = np.empty(n_base, dtype=np.int64)
    inv[replay_order] = np.arange(n_base)
    out: Dict[str, np.ndarray] = {}
    for name in loop.results[rids[0]]:
        arr = np.stack([np.asarray(loop.results[r][name]) for r in rids])
        out[name] = arr[inv]
    return out
