"""Per-shard replication, failover and bitwise recovery for the sharded
serving path (paper §5 deployment: replicated tablets).

Every shard of a ``ShardedOnlineStore`` gets R FOLLOWER replicas:
unstacked per-shard states on the store's device, or on a mesh store on
devices distinct from their leader's (``(s + 1 + r) % n_devices`` of the
mesh's devices, so a card loss never takes a shard and all its replicas
together).  The leader (slot s — the
only replica the serving path reads) applies the writes, and the store
binlog is the shipping stream: ``ReplicationManager.ship`` reads each
follower's unacked log tail, keeps the entries its shard owns, and applies
them through the same ordered ``insert_many`` merge the leader ran.  Any
batching of a row sequence merges to the same rows, so a fully shipped
follower is bitwise equal to its leader's slice.  ``ReplicationLog``
tracks per-follower acked offsets and lag.

Failure handling:

  * ``FailoverController`` (a ``distributed.fault.HeartbeatMonitor``
    with shards as hosts) detects a dead shard, promotes its
    most-caught-up follower (``distributed.fault.most_caught_up``),
    replays the follower's unacked tail and installs the result into
    the leader slot (``ShardedOnlineStore.install_shard``); routing is
    untouched and serving resumes bitwise.
  * Cold recovery (no follower): ``cold_recover_shard`` restores the
    shard's slices from a ``CheckpointManager`` snapshot cut at a binlog
    watermark and replays the tail past it.  Pre-aggregation planes
    recover the same way (``recover_preagg_shard``: the snapshot plane,
    then the tail replayed with the ownership mask restricted to the
    shard).

Consistency barriers: shipping replays puts only, so every operation that
changes leader state outside the log is a barrier — ``bulk_load`` and
``rebalance`` re-seed the followers (``resync``), and eviction ships
every follower to the log head before applying the same eviction
(``evict``).  Binlog truncation must never pass ``safe_offset()``, the
least acked offset.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.fault import (CheckpointManager, HeartbeatMonitor,
                                 most_caught_up, tree_map)
from .timestore import (ShardedOnlineStore, StoreState, evict_before,
                        insert_many, make_state, unstack_shard)

__all__ = ["ReplicationLog", "ReplicationManager", "FailoverController",
           "PromotionRecord", "apply_entries", "cold_recover_shard",
           "recover_preagg_shard"]

# a binlog entry: (table, key, ts, {col: value})
Entry = Tuple[str, int, int, Dict[str, float]]


class ReplicationLog:
    """Per-(shard, follower) acked offsets over the store's binlog.

    Offsets are ABSOLUTE binlog offsets (stable across truncation);
    ``acked[s, r]`` is the offset through which follower r of shard s
    has applied every entry shard s owns.  Lag is counted in log
    entries, the unit a failover replay pays for."""

    def __init__(self, n_shards: int, n_replicas: int):
        self.n_shards = int(n_shards)
        self.n_replicas = int(n_replicas)
        self.acked = np.zeros((n_shards, n_replicas), np.int64)

    def ack(self, shard: int, replica: int, offset: int) -> None:
        self.acked[shard, replica] = max(self.acked[shard, replica],
                                         int(offset))

    def lag(self, leader_offset: int) -> np.ndarray:
        """(n_shards, n_replicas) entries each follower is behind."""
        return np.maximum(0, int(leader_offset) - self.acked)

    def max_lag(self, leader_offset: int) -> int:
        return int(self.lag(leader_offset).max(initial=0))

    def safe_offset(self) -> int:
        """Truncation low-watermark: the binlog below min(acked) has been
        applied by EVERY follower and may be dropped."""
        return int(self.acked.min())

    def most_caught_up(self, shard: int) -> int:
        """Promotion choice for one shard."""
        return most_caught_up({r: int(self.acked[shard, r])
                               for r in range(self.n_replicas)})


@dataclasses.dataclass
class PromotionRecord:
    """What one failover did (the recovery and lag stats surface)."""

    shard: int
    replica: int
    acked_at_promotion: int        # follower offset before the tail replay
    replayed_entries: int          # unacked tail applied at promotion
    recovery_s: float


def _table_runs(entries: Sequence[Entry]):
    """Maximal runs of consecutive same-table entries, order kept, as
    (table, keys, ts, cols) host arrays.  Batching per run (not per table)
    keeps the cross-table interleaving: a UNION window's pre-agg buckets
    fold rows of several tables into one slot, and their combines are
    order-sensitive."""
    i, n = 0, len(entries)
    while i < n:
        j = i
        table = entries[i][0]
        while j < n and entries[j][0] == table:
            j += 1
        run = entries[i:j]
        keys = np.asarray([e[1] for e in run], np.int32)
        ts = np.asarray([e[2] for e in run], np.int32)
        cols = {c: np.asarray([e[3].get(c, 0.0) for e in run], np.float32)
                for c in {c for e in run for c in e[3]}}
        yield table, keys, ts, cols
        i = j


def apply_entries(tables: Dict[str, StoreState],
                  col_specs: Dict[str, Dict[str, Any]],
                  entries: Sequence[Entry]) -> Dict[str, StoreState]:
    """Apply binlog entries to per-shard (unstacked) states through the
    one ordered ``insert_many`` merge the leader's routed ``put_many``
    runs, so the result is bitwise the leader's slice however the
    entries are batched.  Values take the column's dtype on the host,
    as ``put_many`` casts them."""
    for table, keys, ts, cols in _table_runs(entries):
        dev = tables[table]["keys"].device
        vals = {name: torch.from_numpy(np.asarray(cols[name], dtype)).to(
            dev) for name, dtype in col_specs[table].items() if name in cols}
        tables[table] = insert_many(
            tables[table], torch.from_numpy(keys).to(dev),
            torch.from_numpy(ts).to(dev), vals, keys.shape[0])
    return tables


@dataclasses.dataclass
class _Follower:
    replica: int
    device: torch.device
    tables: Dict[str, StoreState]


class ReplicationManager:
    """R follower replicas per shard, fed from the store binlog.
    ``followers[(shard, replica)].tables`` holds per-shard table states
    outside the serving layout, on the follower's ``device``: the store's
    device, or on a mesh store the mesh device ``(s + 1 + r) %
    n_devices``."""

    def __init__(self, store: ShardedOnlineStore, n_replicas: int = 1):
        if n_replicas < 1:
            raise ValueError("replication needs >= 1 follower per shard")
        self.store = store
        self.n_replicas = int(n_replicas)
        self.log = ReplicationLog(store.n_shards, n_replicas)
        devices = (list(store.mesh.devices.flat) if store.mesh is not None
                   else [store.device])
        self.followers: Dict[Tuple[int, int], _Follower] = {
            (s, r): _Follower(r, devices[(s + 1 + r) % len(devices)], {})
            for s in range(store.n_shards) for r in range(n_replicas)}
        self.n_shipped = 0
        self.max_lag_seen = 0
        self._ensure_tables()

    def _ensure_tables(self) -> None:
        """Provision empty follower states for every store table missing
        one (tables created after the manager attaches included)."""
        for name, specs in self.store.col_specs.items():
            for f in self.followers.values():
                if name not in f.tables:
                    f.tables[name] = make_state(self.store.capacity, specs,
                                                f.device)

    def _observe_lag(self) -> None:
        self.max_lag_seen = max(self.max_lag_seen,
                                self.log.max_lag(self.store._binlog_offset))

    def ship(self, shard: Optional[int] = None,
             replica: Optional[int] = None) -> int:
        """Ship the unacked binlog tail to followers (the asynchronous
        replication tick); returns the entries applied.  Each follower
        reads from its OWN acked offset, keeps the entries its shard owns
        under the current assignment, applies them, and acks the log
        head."""
        self._ensure_tables()
        self._observe_lag()
        applied = 0
        shards = range(self.store.n_shards) if shard is None else [shard]
        for s in shards:
            replicas = (range(self.n_replicas) if replica is None
                        else [replica])
            for r in replicas:
                entries, end = self.store.read_binlog(
                    int(self.log.acked[s, r]))
                mine = _owned_entries(self.store, entries, s)
                if mine:
                    apply_entries(self.followers[(s, r)].tables,
                                  self.store.col_specs, mine)
                    applied += len(mine)
                self.log.ack(s, r, end)
        self.n_shipped += applied
        return applied

    def resync(self, shard: Optional[int] = None) -> None:
        """Re-seed followers from the leader slices and ack them to the
        log head: the barrier for every leader mutation that bypasses the
        binlog (``bulk_load``, ``rebalance``) and for re-provisioning
        after a promotion."""
        self._ensure_tables()
        end = self.store._binlog_offset
        shards = range(self.store.n_shards) if shard is None else [shard]
        for s in shards:
            for r in range(self.n_replicas):
                f = self.followers[(s, r)]
                for name in self.store.tables:
                    f.tables[name] = tree_map(
                        lambda x, d=f.device: x.to(d),
                        self.store.shard_state(name, s))
                self.log.acked[s, r] = end

    def evict(self, table: str, horizon_ts: int) -> None:
        """Mirror a leader TTL eviction on every follower.  Callers
        ``ship()`` first: evicting a lagging follower out of log order
        could keep a row the leader dropped."""
        for f in self.followers.values():
            f.tables[table] = evict_before(f.tables[table], horizon_ts)

    def promote(self, shard: int) -> Tuple[int, int, Dict[str, StoreState]]:
        """Promote the most-caught-up follower of a dead shard: replay its
        unacked tail (the same ordered apply) and return (replica, acked
        before the replay, tables).  The caller installs the tables into
        the leader slot and ``resync(shard)``s."""
        r = self.log.most_caught_up(shard)
        acked_before = int(self.log.acked[shard, r])
        self.ship(shard=shard, replica=r)
        return r, acked_before, self.followers[(shard, r)].tables

    def stats(self) -> Dict[str, Any]:
        end = self.store._binlog_offset
        return {
            "n_replicas": self.n_replicas,
            "leader_offset": end,
            "acked": self.log.acked.tolist(),
            "lag_entries": self.log.lag(end).tolist(),
            "max_lag_entries": self.log.max_lag(end),
            "max_lag_seen": max(self.max_lag_seen, self.log.max_lag(end)),
            "safe_offset": self.log.safe_offset(),
            "n_shipped": self.n_shipped,
        }


class FailoverController:
    """Detect dead shards and drive promotion.  Shards are the
    ``HeartbeatMonitor``'s hosts: a shard whose beats lapse past the
    timeout, or that fault injection marked dead, is failed over —
    promote, replay the unacked tail, install into the leader slot,
    re-provision the followers."""

    def __init__(self, manager: ReplicationManager, timeout_s: float = 5.0,
                 monitor: Optional[HeartbeatMonitor] = None,
                 now: Optional[float] = None):
        self.manager = manager
        self.monitor = monitor or HeartbeatMonitor(
            manager.store.n_shards, timeout_s=timeout_s)
        self._killed: set = set()
        self.records: List[PromotionRecord] = []
        for s in range(manager.store.n_shards):
            self.monitor.beat(s, now=now)      # provision = register

    def beat(self, shard: Optional[int] = None,
             now: Optional[float] = None) -> None:
        """Heartbeat one shard (or every shard not killed)."""
        shards = (range(self.manager.store.n_shards) if shard is None
                  else [shard])
        for s in shards:
            if s not in self._killed:
                self.monitor.beat(s, now=now)

    def mark_dead(self, shard: int) -> None:
        self._killed.add(shard)

    def dead_shards(self, now: Optional[float] = None) -> List[int]:
        return sorted(set(self.monitor.dead(now=now)) | self._killed)

    def failover(self, shard: int,
                 now: Optional[float] = None) -> PromotionRecord:
        """Promote + install + re-provision for one dead shard."""
        t0 = time.perf_counter()
        replica, acked_before, tables = self.manager.promote(shard)
        self.manager.store.install_shard(shard, tables)
        self.manager.resync(shard)         # fresh replicas of the leader
        self._killed.discard(shard)
        self.monitor.beat(shard, now=now)
        rec = PromotionRecord(
            shard=shard, replica=replica, acked_at_promotion=acked_before,
            replayed_entries=self.manager.store._binlog_offset
            - acked_before,
            recovery_s=time.perf_counter() - t0)
        self.records.append(rec)
        return rec

    def check(self, now: Optional[float] = None) -> List[PromotionRecord]:
        """Fail over every shard that is dead now."""
        return [self.failover(s, now=now)
                for s in self.dead_shards(now=now)]


def _owned_entries(store: ShardedOnlineStore, entries: Sequence[Entry],
                   shard: int) -> List[Entry]:
    if not entries:
        return []
    own = store.owner_of_keys(np.asarray([e[1] for e in entries])) == shard
    return [e for e, o in zip(entries, own) if o]


def cold_recover_shard(store: ShardedOnlineStore, ckpt: CheckpointManager,
                       shard: int, watermark: Optional[int] = None) -> int:
    """Checkpoint-restore + binlog-replay recovery of one shard's store
    slices when NO follower survives: restore every table from the
    checkpoint cut at binlog offset == step, install shard ``shard``'s
    slices after replaying the tail past the watermark through the same
    ordered apply.  Returns the replayed entries."""
    step = watermark if watermark is not None else ckpt.latest_step()
    restored = ckpt.restore(dict(store.tables), step=step)
    slices = {t: unstack_shard(restored[t], shard) for t in restored}
    entries, _ = store.read_binlog(int(step))
    mine = _owned_entries(store, entries, shard)
    if mine:
        apply_entries(slices, store.col_specs, mine)
    store.install_shard(shard, slices)
    return len(mine)


def recover_preagg_shard(cs, pre_states: Dict[int, Any],
                         snapshot: Dict[int, Any], watermark: int,
                         store: ShardedOnlineStore, shard: int,
                         owned_masks: Dict[int, np.ndarray]
                         ) -> Dict[int, Any]:
    """Recover one shard's pre-aggregation planes from a snapshot cut at
    binlog offset ``watermark``: restore the shard's planes from the
    snapshot (``PreAgg.restore_shard_plane``; other shards' live planes
    untouched), then replay the binlog tail through the same
    ``update_many_sharded`` fold with the ownership mask restricted to
    the recovering shard.  The slot-seeded fold is batch-boundary
    independent, so the recovered planes are bitwise the lost ones."""
    for wi, w in enumerate(cs.windows):
        if w.preagg is None:
            continue
        pre_states[wi] = w.preagg.restore_shard_plane(
            pre_states[wi], snapshot[wi], shard)
    masks_s = {}
    for wi, m in owned_masks.items():
        only = np.zeros_like(np.asarray(m))
        only[shard] = np.asarray(m)[shard]
        masks_s[wi] = only
    entries, _ = store.read_binlog(int(watermark))
    for table, keys, ts, cols in _table_runs(entries):
        pre_states = cs.preagg_update_many_sharded(
            pre_states, table, keys, ts, cols, masks_s)
    return pre_states
