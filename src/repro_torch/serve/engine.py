"""Online serving engine on the card.

``FeatureEngine`` is the paper's online request mode as a service: a
deployed feature script + live store + pre-aggregation states behind
``request()`` / ``request_batch()``, with §8.2 memory guarding.  The
store lives on ``device`` (the card by default; ``device="cpu"`` runs
the plain versions of the kernels).  ``fused_fold=True`` folds every
window group through one unit-fold kernel launch per batch;
``fused_fold=False`` (the reference's default) folds through the staged
per-leaf build/query in plain torch, with the same bits.  ``discrete()``
runs the feature-hash kernel either way.  With ``use_preagg`` every long
window (``OPTIONS(long_windows=...)``) keeps §5.1 bucket planes, folded
on every ingest and bulk load, and requests read them
(``CompiledScript.online_batch``); a fused engine without pre-agg serves
through ``online_batch_fast``.

``offline()`` materializes the script's training features over the
tables, on the engine's device, through the same unit fold.
``submit_request()`` enqueues a request into a ``RequestBatcher`` and
``flush()`` drains the queue through the batched path.  ``latencies_ms``
holds real request completion samples only: every request of a batch
completed when its batch call returned (the call ends by copying the
features to the host, which waits for the card).  Write-path timing
lives apart, in ``ingest_ms`` / ``ingest_stats()``.

Retention lifecycle: ``ttl_ms`` evicts below (newest ingested ts -
``ttl_ms``) on every ingest; ``retention="auto"`` derives each table's
horizon from the widest ROWS_RANGE window span sourcing it (an int is a
floor on that span), and every ``compact_every`` ingested rows of a
table evicts + compacts it below (its high-watermark ts - horizon) and
truncates the binlog below the consumed offset, so resident rows and
the binlog stay bounded by the window span, not by total ingest.

Snapshot double buffer: ``snapshot()`` cuts an ``EngineSnapshot`` (the
store's tables and the pre-agg states, O(#tables), no tensor copies:
every mutation replaces tensors) and ``request_batch(...,
snapshot=snap)`` serves from it while ``ingest_many`` and compaction
mutate the live store; ``serve.loop.ServeLoop`` swaps it between
flushes.

Sharded serving (paper §5 tablets): ``n_shards=S`` swaps the store for
a ``ShardedOnlineStore`` that hash-partitions keys over S shards stacked
on the engine's device, keeps per-shard pre-agg planes, and routes
``request`` / ``request_batch`` / ``flush`` / ``ingest_many`` /
``bulk_load`` / ``offline`` through the sharded drivers
(``CompiledScript.online_sharded_batch`` / ``offline_sharded``), bitwise
equal to the unsharded engine.  ``rebalance()`` migrates hot keys between
shards (``core.union.LoadBalancer`` greedy LPT) together with their
pre-agg planes.  With ``mesh=`` (a ``distributed.sharding.Mesh``, e.g.
``key_shard_mesh()``; S is the size of its axis ``shard_axis``) shard s's
rows and pre-agg planes live on the mesh's device s and its requests and
offline units run there; ``offline()`` reuses the serving mesh, and
followers go to other mesh devices.  The mesh is single-controller: this
process drives every device, and ``device`` is then the first shard's.

Replicated serving: ``replication=R`` attaches R follower replicas per
shard (``storage.replication.ReplicationManager``) fed from the store
binlog every ``ship_every`` ingested rows, a ``FailoverController`` that
promotes the most-caught-up follower when a shard dies, and a pre-agg
recovery snapshot (with ``checkpoint_dir=``, also a checkpoint on disk).
``kill_shard()`` / ``heal()`` inject a failure and recover from it;
serving after ``heal`` is bitwise that of an engine never killed.
Eviction is a replication barrier, and binlog truncation never passes
the least acked follower offset or the snapshot's watermark.

``ServingEngine`` wraps a model's prefill/decode for batched requests —
the "online ML" consumer of the features (every model family): the
SSM prefill runs the linear-scan kernel, every decode step the
flash-decode kernel in every GQA layer; it also serves params placed in
pieces over a mesh's cards (tensor parallelism, ``models.tensor_parallel``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.compiler import CompiledScript, compile_script
from ..core.types import Table
from ..distributed.fault import CheckpointManager
from ..distributed.sharding import Placed, place_stacked
from ..kernels.dispatch import resolve_device
from ..models import tensor_parallel as tp
from ..models.model import (decode_step, forward_prefill,
                            init_decode_state, kv_head_mesh)
from ..storage.memest import MemoryGuard
from ..storage.replication import (FailoverController, PromotionRecord,
                                   ReplicationManager,
                                   recover_preagg_shard)
from ..storage.timestore import OnlineStore, ShardedOnlineStore
from .batcher import RequestBatcher

__all__ = ["FeatureEngine", "EngineSnapshot", "ServingEngine"]


class EngineSnapshot:
    """Point-in-time view of what the request path reads: the store
    (``StoreSnapshot``: frozen tables and, when sharded, frozen routing)
    and the pre-aggregation states.  The states'
    tensors are never written in place, but the engine rebinds planes in
    its ``pre_states`` dict, so the snapshot keeps a shallow copy of the
    dict.  ``refresh()`` re-cuts both from the live engine; readers see
    the old view or the new one, never a mix."""

    def __init__(self, engine: "FeatureEngine"):
        self._engine = engine
        self.store = engine.store.snapshot()
        self.pre_states = _copy_states(engine.pre_states)
        self.version = 0

    def refresh(self) -> int:
        """Re-cut from the live engine; returns the new version."""
        self.store.refresh()
        self.pre_states = _copy_states(self._engine.pre_states)
        self.version += 1
        return self.version


def _copy_states(pre_states):
    return dict(pre_states) if pre_states is not None else None


class FeatureEngine:
    """Deployed feature script + online store (paper Figure 3, right)."""

    def __init__(self, script_sql: str, tables: Dict[str, Table],
                 capacity: int = 4096, use_preagg: bool = False,
                 ttl_ms: int = 0, time_unit: str = "ms",
                 max_memory_bytes: int = 1 << 34,
                 batch_size: int = 64, max_wait_ms: float = 5.0,
                 latency_window: int = 16384,
                 mesh=None, n_shards: Optional[int] = None,
                 shard_axis: str = "shard", route_slots: int = 1024,
                 retention=None, compact_every: int = 256,
                 replication: int = 0, ship_every: int = 64,
                 checkpoint_dir: Optional[str] = None,
                 heartbeat_timeout_s: float = 60.0,
                 fused_fold: bool = False, device="cuda"):
        from ..core.sql import parse

        self.cs: CompiledScript = compile_script(
            parse(script_sql, time_unit=time_unit), tables=tables,
            fused_unit_fold=fused_fold)
        self.use_preagg = use_preagg
        self.ttl_ms = ttl_ms
        self.sharded = mesh is not None or (n_shards or 0) > 1
        if self.sharded:
            ok, why = self.cs.sharded_eligible()
            if not ok:
                raise ValueError(f"script not shardable by key: {why}")
            self.store = ShardedOnlineStore(
                capacity=capacity, n_shards=n_shards, mesh=mesh,
                axis=shard_axis, n_route_slots=route_slots,
                device=device if mesh is not None else resolve_device(device))
        else:
            self.store = OnlineStore(capacity=capacity,
                                     device=resolve_device(device))
        self.device = self.store.device
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
        if not use_preagg:
            self.pre_states = None
        elif self.sharded:
            self.pre_states = self._place_pre(
                self.cs.init_preagg_states_sharded(self.store.n_shards,
                                                   self.device))
        else:
            self.pre_states = self.cs.init_preagg_states(self.device)
        self.dicts = {name: t.dicts for name, t in tables.items()}
        self.tables = tables
        self.batcher = RequestBatcher(batch_size, max_wait_ms=max_wait_ms)
        self.compact_every = max(1, int(compact_every))
        self.retention_ms = self._derive_retention(retention)
        self._pending_rows: Dict[str, int] = {t: 0 for t in need}
        self._hwm_ts: Dict[str, int] = {t: -(2**31) for t in need}
        self._consumed_offset = 0
        self.n_requests = 0
        self.latencies_ms: Deque[float] = collections.deque(
            maxlen=latency_window)
        self.ingest_ms: Deque[float] = collections.deque(
            maxlen=latency_window)
        self.rows_ingested = 0
        # ---- replication (per-shard followers + failover) ------------
        self.replication = int(replication)
        if self.replication and not self.sharded:
            raise ValueError("replication=R needs a sharded engine "
                             "(n_shards=); an unsharded store has no shard "
                             "to replicate")
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.failovers: List[PromotionRecord] = []
        self.repl = self.controller = None
        if self.replication:
            self.repl = ReplicationManager(self.store, self.replication)
            self.controller = FailoverController(
                self.repl, timeout_s=heartbeat_timeout_s)
            self.ship_every = max(1, int(ship_every))
            self._rows_since_ship = 0
            # pre-agg recovery snapshot: (binlog watermark, planes at it);
            # planes are never written in place, so a shallow copy of the
            # dict is a point-in-time snapshot
            self._snapshot = (0, _copy_states(self.pre_states))

    # ---------------------------------------------------------- retention
    def _derive_retention(self, retention) -> Dict[str, Optional[int]]:
        """Per-table retention horizon (ms): the widest ROWS_RANGE span
        among the windows sourcing the table (rows older than the
        high-watermark minus it can enter no window again).  Tables read
        by a ROWS frame or a LAST JOIN get ``None`` (no time horizon); a
        numeric ``retention`` only ever widens a span."""
        if retention is None:
            return {}
        fixed = None if retention == "auto" else int(retention)
        join_tables = {js.right_table for js in self.cs.script.last_joins}
        spans: Dict[str, Optional[int]] = {}
        for t in self._need:
            if t in join_tables:
                spans[t] = None
                continue
            span: Optional[int] = None
            for w in self.cs.windows:
                if t not in w.sources:
                    continue
                spec = w.node.spec
                if spec.frame_rows:
                    span = None
                    break
                span = max(span or 0, min(spec.preceding, 2**30))
            if span is not None and fixed is not None:
                span = max(span, fixed)
            spans[t] = span
        return spans

    def _evict_release(self, table: str, horizon_ts: int):
        """Evict + compact below ``horizon_ts`` and credit the memory
        guard for the dropped rows.  With replicas it is a replication
        barrier: shipping replays puts only, so every follower first
        applies the log to its head and then runs the same eviction (a
        lagging follower could otherwise keep a row the leader dropped,
        and promotion would not be bitwise)."""
        before = self.store.n_rows(table)
        self.store.evict(table, horizon_ts)
        evicted = before - self.store.n_rows(table)
        if evicted > 0:
            self.guard.release(evicted * (64 + 8 * len(self._need[table])))
        if self.repl is not None:
            self.repl.ship()
            self.repl.evict(table, horizon_ts)

    def _after_ingest(self, table: str, n_rows: int, max_ts: int):
        """Scheduled retention tick on the ingest path: pre-aggregation
        folds at ingest, so the written binlog is consumed; every
        ``compact_every`` rows of a table evict + compact it and truncate
        the binlog below the durable offset.  With replicas, every
        ``ship_every`` rows ship the log to the followers."""
        self._hwm_ts[table] = max(self._hwm_ts[table], max_ts)
        self._consumed_offset = self.store._binlog_offset
        if self.repl is not None:
            self._rows_since_ship += n_rows
            if self._rows_since_ship >= self.ship_every:
                self._rows_since_ship = 0
                self.repl.ship()
                self.controller.beat()
        if not self.retention_ms:
            return
        self._pending_rows[table] += n_rows
        if self._pending_rows[table] < self.compact_every:
            return
        self._pending_rows[table] = 0
        horizon = self.retention_ms[table]
        if horizon is not None:
            self._evict_release(table, self._hwm_ts[table] - horizon)
        self.store.truncate_binlog(self._durable_offset())

    def _durable_offset(self) -> int:
        """Binlog truncation low-watermark: entries below it are folded
        into the pre-agg planes (consumed), applied by every follower
        (``ReplicationLog.safe_offset``) and below the recovery
        snapshot's watermark — so no catch-up, promotion replay or
        snapshot + replay recovery can need a truncated entry."""
        off = self._consumed_offset
        if self.repl is not None:
            off = min(off, self.repl.log.safe_offset(), self._snapshot[0])
        return off

    # ------------------------------------------------------------- ingest
    def ingest(self, table: str, row: Dict[str, Any]):
        """Insert one event (Put path)."""
        self.ingest_many(table, [row])

    def ingest_many(self, table: str, rows: Sequence[Dict[str, Any]]):
        """Bulk insert of N events with one store sort-merge (and, with
        pre-agg, one batched bucket fold, ``PreAgg.update_many``)."""
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
        if self.use_preagg:
            self._fold_preagg(table, keys, ts, cols)
        max_ts = int(ts.max())
        if self.ttl_ms:
            self._evict_release(table, max_ts - self.ttl_ms)
        self._after_ingest(table, len(rows), max_ts)
        self.ingest_ms.append((time.perf_counter() - t0) * 1e3)
        self.rows_ingested += len(rows)

    def bulk_load(self, table: str, rows_table: Table):
        """LOAD DATA: ingest a whole historical table at once.  With
        pre-agg the loaded rows fold into the bucket planes too (one
        ``update_many``), or long windows would be served from empty
        planes over the loaded history."""
        cols = {c: rows_table.columns[c].astype(np.float32)
                for c in self._need[table]}
        keys = rows_table.columns[self._key_col()]
        ts = rows_table.columns[self.cs.script.order_column]
        self.store.bulk_load(table, keys, ts, cols)
        self.guard.charge(len(rows_table) * (64 + 8 * len(cols)))
        if self.use_preagg:
            self._fold_preagg(table, np.asarray(keys, np.int32),
                              np.asarray(ts, np.int32), cols)
        if len(ts):
            # high-watermark and consumed offset, no pending-row tick
            self._after_ingest(table, 0, int(np.max(ts)))
        if self.repl is not None:
            # a load is a snapshot barrier: it overwrites store state and
            # logs its rows in sorted, not arrival, order, so no replay
            # may cross it — followers re-seed from the loaded leaders and
            # the recovery watermark moves past the load
            self.repl.resync()
            self.checkpoint()

    def _fold_preagg(self, table: str, keys, ts, cols):
        """Fold ingested rows into the pre-agg planes (per-shard planes
        under the ownership masks when sharded)."""
        if self.sharded:
            self.pre_states = self.cs.preagg_update_many_sharded(
                self.pre_states, table, keys, ts, cols,
                self._preagg_owned())
        else:
            self.pre_states = self.cs.preagg_update_many(
                self.pre_states, table, keys, ts, cols)

    def load_store_from(self, numpy_states: Dict[str, Dict]) -> None:
        """Take every table's store state as numpy arrays (``keys``,
        ``ts``, ``cols``, ``count``), e.g. a reference engine's
        ``{t: jax.tree.map(np.asarray, st) for t, st in
        store.tables.items()}``."""
        for table, st in numpy_states.items():
            self.store.load_state(table, st)

    # ------------------------------------------------------------ request
    def request(self, row: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Online request mode: features for one (virtually inserted)
        tuple of the base table."""
        if self.sharded:   # a one-request batch through the shard routing
            return self.request_batch([row])[0]
        t0 = time.perf_counter()
        key, ts, values = self._encode_request(row)
        feats = self.cs.online(self.store, key, ts, values,
                               preagg_states=self.pre_states)
        self.n_requests += 1
        self.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return feats

    def request_batch(self, rows: Sequence[Dict[str, Any]],
                      snapshot: Optional[EngineSnapshot] = None
                      ) -> List[Dict[str, np.ndarray]]:
        """Features for B requests in one batched call: a sharded engine
        through ``online_sharded_batch``, a fused engine without pre-agg
        through the fast path (``online_batch_fast``), every other one
        through ``online_batch`` (the staged fold and/or the pre-agg
        planes).  With ``snapshot=`` the batch reads the frozen
        ``EngineSnapshot`` instead of the live store and states."""
        if not rows:
            return []
        t0 = time.perf_counter()
        enc = [self._encode_request(r) for r in rows]
        keys = [e[0] for e in enc]
        ts = [e[1] for e in enc]
        values = {c: [e[2][c] for e in enc]
                  for c in self._need[self.cs.script.base_table]}
        store = self.store if snapshot is None else snapshot.store
        pre = self.pre_states if snapshot is None else snapshot.pre_states
        if self.sharded:
            feats = self.cs.online_sharded_batch(store, keys, ts, values,
                                                 preagg_states=pre)
        elif not self.use_preagg and self.cs.ctx.fused_unit_fold:
            feats = self.cs.online_batch_fast(store, keys, ts, values)
        else:
            feats = self.cs.online_batch(store, keys, ts, values,
                                         preagg_states=pre)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.n_requests += len(rows)
        # the batch wall time IS each request's real service latency
        self.latencies_ms.extend([dt_ms] * len(rows))
        return [{k: v[i] for k, v in feats.items()}
                for i in range(len(rows))]

    def snapshot(self) -> EngineSnapshot:
        """Cut a frozen view of (store, pre-agg states) for the
        double-buffered serving loop (O(#tables); no tensor copies)."""
        return EngineSnapshot(self)

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

    # ---------------------------------------------------------- rebalance
    def rebalance(self) -> bool:
        """Hot-key rebalancing for the sharded engine: recompute the key ->
        shard map from the observed ingest load (greedy LPT over the
        ``LoadBalancer`` cost EMA) and migrate both the resident rows and
        the per-shard pre-agg planes to the new owners.  Returns True if
        any key moved; served features do not change."""
        if not self.sharded:
            return False
        store: ShardedOnlineStore = self.store
        n_keys = {wi: w.preagg.n_keys for wi, w in enumerate(self.cs.windows)
                  if w.preagg is not None and self.use_preagg}
        old_owner = {wi: store.owner_of_keys(np.arange(nk))
                     for wi, nk in n_keys.items()}
        if not store.rebalance():
            return False
        if self.use_preagg:
            pre = dict(self.pre_states)
            for wi, nk in n_keys.items():
                pre[wi] = self.cs.windows[wi].preagg.migrate_state_sharded(
                    pre[wi], old_owner[wi], store.owner_of_keys(
                        np.arange(nk)))
            self.pre_states = pre
        if self.repl is not None:
            # ownership changed under shipped history: followers re-seed
            # from the migrated leaders and the recovery snapshot is re-cut,
            # so no replay crosses a rebalance
            self.repl.resync()
            self.checkpoint()
        return True

    # --------------------------------------------------------- replication
    def _require_replication(self):
        if self.repl is None:
            raise ValueError("engine was built without replication=R")

    def ship_replicas(self) -> int:
        """Ship the unacked binlog tail to every follower now (the ingest
        path does so every ``ship_every`` rows)."""
        self._require_replication()
        n = self.repl.ship()
        self.controller.beat()
        return n

    def checkpoint(self) -> int:
        """Cut a recovery snapshot at the current binlog offset: the pre-agg
        planes in memory and, with ``checkpoint_dir=``, the stacked store
        tables and planes on disk (step == binlog watermark, so cold
        recovery is restore + replay of the tail).  Returns the
        watermark."""
        wm = self.store._binlog_offset
        pre = _copy_states(self.pre_states)
        if self.repl is not None:
            self._snapshot = (wm, pre)
        if self.ckpt is not None:
            self.ckpt.save(wm, {"tables": dict(self.store.tables),
                                "pre": pre})
        return wm

    def kill_shard(self, shard: int) -> Dict[str, Any]:
        """Fault injection: shard ``shard`` dies — its resident rows and
        pre-agg planes are wiped and the controller marks it dead.  Serving
        continues (its keys read empty) until ``heal()``.  Returns the
        replication lag at the moment of death (entries each follower was
        behind)."""
        self._require_replication()
        end = self.store._binlog_offset
        lag = {r: int(v) for r, v in enumerate(
            self.repl.log.lag(end)[shard])}
        self.store.wipe_shard(shard)
        if self.pre_states is not None:
            empty = self.cs.init_preagg_states_sharded(self.store.n_shards,
                                                       self.device)
            pre = dict(self.pre_states)
            for wi in empty:
                pre[wi] = self.cs.windows[wi].preagg.restore_shard_plane(
                    pre[wi], empty[wi], shard)
            self.pre_states = pre
        self.controller.mark_dead(shard)
        return {"shard": shard, "leader_offset": end, "lag_at_kill": lag}

    def heal(self) -> List[PromotionRecord]:
        """Fail over every dead shard: promote its most-caught-up follower
        (unacked tail replayed through the same ordered apply) into the
        leader slot, and rebuild its pre-agg planes from the snapshot plus
        a binlog replay restricted to the shard.  ``recovery_s`` covers
        both."""
        self._require_replication()
        healed = []
        for shard in self.controller.dead_shards():
            t0 = time.perf_counter()
            rec = self.controller.failover(shard)
            if self.pre_states is not None:
                wm, snap = self._snapshot
                self.pre_states = recover_preagg_shard(
                    self.cs, dict(self.pre_states), snap, wm, self.store,
                    shard, self._preagg_owned())
            self._synchronize()
            rec.recovery_s = time.perf_counter() - t0
            healed.append(rec)
        self.failovers.extend(healed)
        return healed

    def replication_stats(self) -> Dict[str, Any]:
        """Lag and recovery observability."""
        if self.repl is None:
            return {"n_replicas": 0}
        st = self.repl.stats()
        st["snapshot_watermark"] = self._snapshot[0]
        st["dead_shards"] = self.controller.dead_shards()
        st["failovers"] = [dataclasses.asdict(r) for r in self.failovers]
        return st

    def _synchronize(self) -> None:
        """Wait for every card the store's shards live on."""
        devices = self.store.devices or [self.device]
        for d in {str(d): d for d in devices}.values():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _place_pre(self, pre_states):
        """Co-locate stacked pre-agg planes with their store shards: on a
        mesh, shard s's planes move to the mesh's device s."""
        if self.store.mesh is None:
            return pre_states
        return {wi: place_stacked(p, self.store.devices)
                for wi, p in pre_states.items()}

    def _preagg_owned(self):
        """Per-window ownership masks, cached against the store's
        rebalance count (they change only on rebalance)."""
        ver = self.store.n_rebalances
        cached = getattr(self, "_owned_cache", None)
        if cached is None or cached[0] != ver:
            cached = (ver, self.cs.preagg_owned_masks(
                self.store.owner_of_keys, self.store.n_shards))
            self._owned_cache = cached
        return cached[1]

    # ------------------------------------------------------------- offline
    def offline(self, tables: Optional[Dict[str, Table]] = None
                ) -> Dict[str, np.ndarray]:
        """Offline (training-set) feature materialization for this
        deployment's script, on the engine's device: the same fold that
        serves the requests computes the training features.  A sharded
        engine materializes through ``offline_sharded`` over its shard
        count, on its serving mesh if it has one, bitwise equal to
        ``offline``."""
        tables = tables or self.tables
        if self.sharded:
            return self.cs.offline_sharded(
                tables, mesh=self.store.mesh, n_shards=self.store.n_shards,
                axis=self.store.axis, device=self.device)
        return self.cs.offline(tables, device=self.device)

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

    def ingest_stats(self) -> Dict[str, float]:
        """Write-path timing, apart from request latencies: wall times of
        the ``ingest`` / ``ingest_many`` calls and the rows ingested ({}
        when none)."""
        if not self.ingest_ms:
            return {}
        arr = np.asarray(self.ingest_ms)
        return {"rows": float(self.rows_ingested),
                "calls": float(arr.size),
                "TP50": float(np.percentile(arr, 50)),
                "TP99": float(np.percentile(arr, 99)),
                "max_ms": float(arr.max())}

    def reset_stats(self):
        """Drop warm-up samples before measuring percentiles."""
        self.latencies_ms.clear()
        self.ingest_ms.clear()
        self.rows_ingested = 0
        self.n_requests = 0


class ServingEngine:
    """Model serving: prefill once, then batched decode steps.

    ``params`` (``models.init_params`` / ``params_from_jax``) are moved to
    ``device`` as they are; their dtype is the compute dtype.  ``dtype``
    is the cache dtype of ``init_decode_state``.  ``use_kernel`` is passed
    to the kernels (``None``: the CUDA kernels on the card, the plain
    versions on the CPU; ``False``: the plain versions anywhere, the
    reference the kernels are held against).  Logits come back as float32
    numpy arrays (the exact values of bfloat16 logits).

    A params tree placed in pieces (``device_put(params,
    named_shardings(param_pspecs(...), mesh))``) is taken as it is: no
    leaf is gathered, the engine's device is the tree's home (mesh entry
    0's device; ``device`` is not read) and prefill, decode and
    ``generate_greedy`` run through the pieces (``models.model``).
    """

    def __init__(self, cfg, params, max_len: int = 2048,
                 dtype=torch.bfloat16, device="cuda",
                 use_kernel: Optional[bool] = None):
        self.cfg = cfg
        home = tp.tree_home(params)
        self.device = resolve_device(device) if home is None else home
        self.params = _to_device(params, self.device)
        self.mesh = kv_head_mesh(cfg, self.params)
        self.max_len = max_len
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.state = None

    def init_state(self, batch_size: int) -> Dict[str, Any]:
        """An empty decode state at this engine's capacity and dtype (GQA
        K/V in KV-head pieces where the params' heads run in groups)."""
        return init_decode_state(self.cfg, batch_size, self.max_len,
                                 dtype=self.dtype, device=self.device,
                                 mesh=self.mesh)

    def prefill(self, batch) -> np.ndarray:
        """Prefill ``batch["tokens"]`` (B, S), behind ``patches`` (VLM) or
        beside ``frames`` (audio), each moved to the engine's device, into
        this engine's own ``init_state`` (KV or MLA latent caches of
        ``max_len`` positions in the engine's dtype, in KV-head pieces on
        a placed engine's head route: ``forward_prefill(..., state=)``
        writes each layer into them, a block of rows at a time where the
        batch's activations would not fit); keeps that state and returns
        the last logits.  The previous state is released first, so one
        state's caches are held at a time."""
        self.state = None
        inputs = {"tokens": self._tokens(batch["tokens"])}
        for name in ("patches", "frames"):
            if name in batch:
                inputs[name] = torch.as_tensor(batch[name]).to(self.device)
        logits, self.state = forward_prefill(
            self.cfg, self.params, inputs, cache_capacity=self.max_len,
            use_kernel=self.use_kernel,
            state=self.init_state(inputs["tokens"].shape[0]))
        return _host(logits)

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for every sequence: tokens (B, 1)."""
        logits, self.state = decode_step(
            self.cfg, self.params, self.state, self._tokens(tokens),
            use_kernel=self.use_kernel)
        return _host(logits)

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        return tokens.to(device=self.device, dtype=torch.int32)

    def generate_greedy(self, batch, n_tokens: int) -> np.ndarray:
        """Greedy decoding: argmax over ``vocab_padded`` (padded ids are
        not masked, as in the reference) -> (B, n_tokens) int32."""
        logits = self.prefill(batch)
        out = []
        tok = np.argmax(logits, axis=-1)[:, None].astype(np.int32)
        for _ in range(n_tokens):
            out.append(tok)
            logits = self.decode(tok)
            tok = np.argmax(logits, axis=-1)[:, None].astype(np.int32)
        return np.concatenate(out, axis=1)


def _to_device(tree, device):
    """Every tensor of ``tree`` on ``device``; ``Placed`` leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree if isinstance(tree, Placed) else tree.to(device)


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.to(torch.float32).cpu().numpy()
