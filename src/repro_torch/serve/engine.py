"""Online serving engine on the card.

``FeatureEngine`` is the paper's online request mode as a service: a
deployed feature script + live store behind ``request_batch()``, with
§8.2 memory guarding.  The store lives on ``device`` (the card by
default; ``device="cpu"`` runs the plain versions of the kernels), and
every batch goes through the fused path: one unit-fold kernel launch per
window group for the whole batch, and the feature-hash kernel for
``discrete()``.

``submit_request()`` enqueues a request into a ``RequestBatcher`` and
``flush()`` drains the queue through the batched path.  ``latencies_ms``
holds real request completion samples only: every request of a batch
completed when its batch call returned (the call ends by copying the
features to the host, which waits for the card).

Options that are not ported yet raise ``NotImplementedError`` naming the
option: pre-aggregation, sharding, replication, checkpoints, retention /
TTL eviction and the staged (non-fused) fold path.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.compiler import CompiledScript, compile_script
from ..core.types import Table
from ..storage.memest import MemoryGuard
from ..storage.timestore import OnlineStore
from .batcher import RequestBatcher

__all__ = ["FeatureEngine"]


def _not_ported(name: str):
    raise NotImplementedError(f"FeatureEngine option {name!r} is not "
                              f"ported to repro_torch yet")


def resolve_device(device) -> torch.device:
    """The engine's device; a CUDA device without a card raises (no
    silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available; pass device='cpu' to run the "
                           f"plain versions on the CPU")
    return dev


class FeatureEngine:
    """Deployed feature script + online store (paper Figure 3, right)."""

    def __init__(self, script_sql: str, tables: Dict[str, Table],
                 capacity: int = 4096, use_preagg: bool = False,
                 ttl_ms: int = 0, time_unit: str = "ms",
                 max_memory_bytes: int = 1 << 34,
                 batch_size: int = 64, max_wait_ms: float = 5.0,
                 latency_window: int = 16384,
                 mesh=None, n_shards: Optional[int] = None,
                 retention=None, replication: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 fused_fold: bool = False, device="cuda"):
        for name, on in (("use_preagg", use_preagg), ("ttl_ms", ttl_ms),
                         ("mesh", mesh is not None),
                         ("n_shards", (n_shards or 0) > 1),
                         ("retention", retention is not None),
                         ("replication", replication),
                         ("checkpoint_dir", checkpoint_dir)):
            if on:
                _not_ported(name)
        if not fused_fold:
            raise NotImplementedError(
                "FeatureEngine option 'fused_fold=False' (the staged fold "
                "path) is not ported to repro_torch yet; pass "
                "fused_fold=True")
        self.device = resolve_device(device)
        from ..core.sql import parse

        self.cs: CompiledScript = compile_script(
            parse(script_sql, time_unit=time_unit), tables=tables)
        self.store = OnlineStore(capacity=capacity, device=self.device)
        self.guard = MemoryGuard(max_memory_bytes)
        part_cols = sorted({w.node.spec.partition_by
                            for w in self.cs.windows})
        if len(part_cols) > 1:
            raise ValueError(
                f"script partitions windows by multiple columns "
                f"{part_cols}; one shared key column is required")
        self.key_col: Optional[str] = part_cols[0] if part_cols else None
        need = self.cs.required_store_columns()
        for tname, cols in need.items():
            table = tables[tname]
            specs = {}
            for c in cols:
                dd = table.schema.column(c).ctype.device_dtype
                specs[c] = np.float32 if dd.kind == "f" else np.int32
            self.store.create_table(tname, specs)
        self._need = need
        self.dicts = {name: t.dicts for name, t in tables.items()}
        self.tables = tables
        self.batcher = RequestBatcher(batch_size, max_wait_ms=max_wait_ms)
        self.n_requests = 0
        self.latencies_ms: Deque[float] = collections.deque(
            maxlen=latency_window)
        self.ingest_ms: Deque[float] = collections.deque(
            maxlen=latency_window)
        self.rows_ingested = 0

    # ------------------------------------------------------------- ingest
    def ingest(self, table: str, row: Dict[str, Any]):
        """Insert one event (Put path)."""
        self.ingest_many(table, [row])

    def ingest_many(self, table: str, rows: Sequence[Dict[str, Any]]):
        """Bulk insert of N events with one store sort-merge."""
        if not rows:
            return
        t0 = time.perf_counter()
        kc = self._key_col()
        keys = np.asarray([self._encode(table, kc, r[kc]) for r in rows],
                          np.int32)
        ts = np.asarray([int(r[self.cs.script.order_column])
                         for r in rows], np.int32)
        cols = {c: np.asarray([float(self._encode(table, c, r[c]))
                               for r in rows], np.float32)
                for c in self._need[table]}
        nbytes = len(rows) * (64 + 8 * len(cols))
        self.guard.charge(nbytes)
        try:
            self.store.put_many(table, keys, ts, cols)
        except Exception:
            self.guard.release(nbytes)   # nothing was stored
            raise
        self.ingest_ms.append((time.perf_counter() - t0) * 1e3)
        self.rows_ingested += len(rows)

    def bulk_load(self, table: str, rows_table: Table):
        """LOAD DATA: ingest a whole historical table at once."""
        cols = {c: rows_table.columns[c].astype(np.float32)
                for c in self._need[table]}
        self.store.bulk_load(table, rows_table.columns[self._key_col()],
                             rows_table.columns[self.cs.script.order_column],
                             cols)
        self.guard.charge(len(rows_table) * (64 + 8 * len(cols)))

    def load_store_from(self, numpy_states: Dict[str, Dict]) -> None:
        """Take every table's store state as numpy arrays (``keys``,
        ``ts``, ``cols``, ``count``), e.g. a reference engine's
        ``{t: jax.tree.map(np.asarray, st) for t, st in
        store.tables.items()}``."""
        for table, st in numpy_states.items():
            self.store.load_state(table, st)

    # ------------------------------------------------------------ request
    def request_batch(self, rows: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, np.ndarray]]:
        """Features for B requests in one fused batched call."""
        if not rows:
            return []
        t0 = time.perf_counter()
        enc = [self._encode_request(r) for r in rows]
        keys = [e[0] for e in enc]
        ts = [e[1] for e in enc]
        values = {c: [e[2][c] for e in enc]
                  for c in self._need[self.cs.script.base_table]}
        feats = self.cs.online_batch_fast(self.store, keys, ts, values)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.n_requests += len(rows)
        # the batch wall time IS each request's real service latency
        self.latencies_ms.extend([dt_ms] * len(rows))
        return [{k: v[i] for k, v in feats.items()}
                for i in range(len(rows))]

    def submit_request(self, row: Dict[str, Any]) -> int:
        """Enqueue a request for batched execution; returns its id."""
        return self.batcher.submit(row)

    def flush(self) -> Dict[int, Dict[str, np.ndarray]]:
        """Drain the request queue through the batched path; returns
        {request_id: features}.  Only real requests are served."""
        out: Dict[int, Dict[str, np.ndarray]] = {}
        while self.batcher.queue:
            ids, payloads, n_real = self.batcher.next_batch()
            feats = self.request_batch(payloads[:n_real])
            for rid, f in zip(ids, feats):
                out[rid] = f
        return out

    # ------------------------------------------------------------ helpers
    def _key_col(self) -> str:
        if self.key_col is None:
            raise ValueError("script has no window partition column; "
                             "store ingest needs a key")
        return self.key_col

    def _encode_request(self, row: Dict[str, Any]):
        base = self.cs.script.base_table
        key = self._encode(base, self._key_col(), row[self._key_col()])
        ts = int(row[self.cs.script.order_column])
        values = {c: float(self._encode(base, c, row[c]))
                  for c in self._need[base]}
        return key, ts, values

    def _encode(self, table: str, col: str, v):
        d = self.dicts.get(table, {}).get(col)
        if d is not None and isinstance(v, str):
            return d.encode(v)
        return v

    def latency_percentiles(self) -> Dict[str, float]:
        """Percentiles over request completion samples ({} when none)."""
        if not self.latencies_ms:
            return {}
        arr = np.asarray(self.latencies_ms)
        return {f"TP{p}": float(np.percentile(arr, p))
                for p in (50, 90, 95, 99)}

    def reset_stats(self):
        """Drop warm-up samples before measuring percentiles."""
        self.latencies_ms.clear()
        self.ingest_ms.clear()
        self.rows_ingested = 0
        self.n_requests = 0
