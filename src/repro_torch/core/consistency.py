"""Online/offline consistency verification (the paper's headline claim).

OpenMLDB's unified plan guarantees that a feature script produces the
same values in offline (training) and online (serving) execution.  Both
executors here run the one unit fold over the same rows at the same unit
positions, so the guarantee holds by construction; this module checks
it: replay the historical tables through the online store row by row
(each base row is a request, then it is ingested) and compare with the
offline batch output, bit for bit.

Replay contract: events are presented in the offline tie-break order —
(ts, table-rank, arrival) — which is exactly the order the store's
insert-after-peers policy reconstructs.

The replay runs unsharded or key-sharded (``n_shards``, or ``mesh`` for
one shard per mesh device: the offline side through ``offline_sharded``,
the online side through a ``ShardedOnlineStore`` served by
``online_sharded_batch``), raw or pre-aggregated (``use_preagg``: every
ingested row folds into the §5.1 bucket planes, which serve the long
windows), and with ``replication`` and ``kill_shard_at`` through a
mid-replay shard failure and failover.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..distributed.sharding import place_stacked
from ..kernels.dispatch import resolve_device
from ..storage.replication import (FailoverController, ReplicationManager,
                                   recover_preagg_shard)
from ..storage.timestore import OnlineStore, ShardedOnlineStore
from .compiler import CompiledScript
from .types import Table

__all__ = ["replay_online", "verify_consistency", "ConsistencyReport"]


@dataclasses.dataclass
class ConsistencyReport:
    """Consistency contract (one fold engine): raw serving must be
    **bitwise equal** to the offline fold, floats included — the gate is
    ``array_equal``, not allclose.  ``bitwise_gate`` records which
    contract this report was held to (tolerance otherwise)."""

    n_rows: int
    n_features: int
    n_exact: int                   # features that matched bitwise
    max_abs_diff: float
    max_rel_diff: float
    passed: bool
    mismatched: List[str]
    bitwise_gate: bool = False

    @property
    def bitwise_equal(self) -> bool:
        return self.n_exact == self.n_features

    def __str__(self):
        gate = "array_equal" if self.bitwise_gate else "tolerance"
        status = "BITWISE-EQUAL" if self.bitwise_equal else (
            f"{self.n_exact}/{self.n_features} bitwise, "
            f"max|d|={self.max_abs_diff:.2e} rel={self.max_rel_diff:.2e} "
            f"-> {'PASS' if self.passed else 'FAIL'}")
        return (f"consistency[{gate}]: {self.n_rows} rows x "
                f"{self.n_features} features -> {status}"
                + (f"; mismatched: {self.mismatched}" if self.mismatched
                   else ""))


def _event_stream(cs: CompiledScript, tables: Dict[str, Table]):
    """All rows of all tables merged in (ts, rank, arrival) order.

    rank: union tables in source order, base table last — mirrors the
    offline sort's tie-break.
    """
    base = cs.script.base_table
    order_col = cs.script.order_column
    needed = set(cs.required_store_columns())
    tables = {k: v for k, v in tables.items() if k in needed}
    names = list(tables)
    rank = {t: (len(names) if t == base else i)
            for i, t in enumerate(n for n in names if n != base)}
    rank[base] = len(names)
    events = []
    for tname, table in tables.items():
        ts = table.columns[order_col]
        for i in range(table.n_rows):
            events.append((int(ts[i]), rank[tname], i, tname))
    events.sort()
    return events


def replay_online(cs: CompiledScript, tables: Dict[str, Table],
                  capacity: Optional[int] = None, use_preagg: bool = False,
                  n_shards: Optional[int] = None, mesh=None,
                  replication: int = 0,
                  kill_shard_at: Optional[int] = None,
                  ship_every: int = 3,
                  device="cuda") -> Dict[str, np.ndarray]:
    """Feed rows through an online store on ``device`` in arrival order;
    collect the request-mode features of every base-table row, in base
    row order.  With ``use_preagg`` every replayed row is also folded
    into the pre-aggregation planes, which serve the long windows.

    With ``n_shards`` (or ``mesh``, a ``distributed.sharding.Mesh``: one
    shard per device of its ``shard`` axis, ``device`` then unused) the
    replay drives the key-sharded serving path: a ``ShardedOnlineStore``
    with routed ingest, per-shard pre-agg planes (beside their shards on
    a mesh), and every request served by ``online_sharded_batch``.  With
    ``replication=R`` it also runs R followers per shard, shipped every
    ``ship_every`` events, and ``kill_shard_at=k`` kills the shard owning
    base request k's key just before serving it (rows and planes wiped),
    fails it over (follower promoted, binlog tail replayed, planes
    recovered from the watermark-0 snapshot) and serves the request from
    the promoted leader."""
    base = cs.script.base_table
    need = cs.required_store_columns()
    tables = {k: v for k, v in tables.items() if k in need}
    total = sum(len(t) for t in tables.values())
    cap = capacity or max(64, total + 8)
    sharded = n_shards is not None or mesh is not None
    if sharded:
        store = ShardedOnlineStore(
            capacity=cap, n_shards=n_shards, mesh=mesh,
            device=device if mesh is not None else resolve_device(device))
    else:
        store = OnlineStore(capacity=cap, device=resolve_device(device))
    dev = store.device
    for tname, cols in need.items():
        table = tables[tname]
        specs = {}
        for c in cols:
            dd = table.schema.column(c).ctype.device_dtype
            specs[c] = np.float32 if dd.kind == "f" else np.int32
        store.create_table(tname, specs)
    owned = None
    if not use_preagg:
        pre_states = None
    elif sharded:
        pre_states = cs.init_preagg_states_sharded(store.n_shards, dev)
        if mesh is not None:
            pre_states = {wi: place_stacked(p, store.devices)
                          for wi, p in pre_states.items()}
        owned = cs.preagg_owned_masks(store.owner_of_keys, store.n_shards)
    else:
        pre_states = cs.init_preagg_states(dev)

    repl = controller = snap = None
    if replication:
        if not sharded:
            raise ValueError("replication needs a sharded replay "
                             "(n_shards= or mesh=)")
        repl = ReplicationManager(store, replication)
        controller = FailoverController(repl)
        # the replay never truncates its binlog, so the recovery snapshot
        # is the identity planes at watermark 0
        snap = dict(pre_states) if pre_states is not None else None
    elif kill_shard_at is not None:
        raise ValueError("kill_shard_at needs replication >= 1 "
                         "(no follower to promote)")

    n_base = len(tables[base])
    outputs: Dict[str, List[np.ndarray]] = {}
    part_keys = {w.node.spec.partition_by for w in cs.windows}
    join_keys = {j.left_key for j in cs.script.last_joins}
    # the store key column: the partition key (single-key scripts)
    key_col = next(iter(part_keys)) if part_keys else next(iter(join_keys))
    n_events = n_served = 0

    for ts, _, i, tname in _event_stream(cs, tables):
        table = tables[tname]
        key = int(table.columns[key_col][i])
        values = {c: float(table.columns[c][i]) for c in need[tname]}
        if tname == base:
            if controller is not None and n_served == kill_shard_at:
                shard = int(store.owner_of_keys(np.asarray([key]))[0])
                store.wipe_shard(shard)
                if pre_states is not None:
                    empty = cs.init_preagg_states_sharded(store.n_shards,
                                                          dev)
                    for wi in empty:
                        pre_states[wi] = cs.windows[
                            wi].preagg.restore_shard_plane(
                                pre_states[wi], empty[wi], shard)
                controller.mark_dead(shard)
                controller.failover(shard)
                if pre_states is not None:
                    pre_states = recover_preagg_shard(
                        cs, pre_states, snap, 0, store, shard, owned)
            if sharded:
                feats = {k: v[0] for k, v in cs.online_sharded_batch(
                    store, [key], [ts], {c: [v] for c, v in values.items()},
                    preagg_states=pre_states).items()}
            else:
                feats = cs.online(store, key, ts, values,
                                  preagg_states=pre_states)
            for k, v in feats.items():
                outputs.setdefault(k, []).append(np.asarray(v))
            n_served += 1
        store.put(tname, key, ts, values)
        if use_preagg and sharded:
            pre_states = cs.preagg_update_many_sharded(
                pre_states, tname, np.asarray([key], np.int32),
                np.asarray([ts], np.int32),
                {c: np.asarray([v], np.float32) for c, v in values.items()},
                owned)
        elif use_preagg:
            pre_states = cs.preagg_update(pre_states, tname, key, ts, values)
        n_events += 1
        if repl is not None and n_events % max(1, ship_every) == 0:
            repl.ship()

    # rows were replayed in ts order; restore original base-row order
    base_ts = tables[base].columns[cs.script.order_column]
    replay_order = np.lexsort((np.arange(n_base), base_ts))
    inv = np.empty(n_base, dtype=np.int64)
    inv[replay_order] = np.arange(n_base)
    return {k: np.stack(vs)[inv] for k, vs in outputs.items()}


def verify_consistency(cs: CompiledScript, tables: Dict[str, Table],
                       use_preagg: bool = False, atol: float = 1e-3,
                       rtol: float = 1e-4, n_shards: Optional[int] = None,
                       mesh=None, bitwise: Optional[bool] = None,
                       replication: int = 0,
                       kill_shard_at: Optional[int] = None,
                       ship_every: int = 3,
                       online_outputs: Optional[Dict[str, np.ndarray]]
                       = None, device="cuda") -> ConsistencyReport:
    """Offline-vs-online replay gate on ``device`` (the card unless the
    caller asks for the CPU).

    ``bitwise`` selects the gate: ``array_equal`` on every feature
    (floats included) vs reduction-order tolerance (``atol``/``rtol``).
    Default: bitwise for raw serving, tolerance with ``use_preagg``
    (bucket partials re-bracket float combines); pass ``bitwise=True``
    with pre-agg for order-insensitive-in-float workloads (min/max,
    integer-valued sums).  ``online_outputs`` supplies
    precomputed online-side feature arrays (already in offline row
    order) instead of running ``replay_online`` — the hook that lets
    another serving harness be held to the same gate.

    With ``n_shards`` or ``mesh`` BOTH executors run sharded
    (``offline_sharded`` and the sharded replay, on the mesh when one is
    given); ``replication`` + ``kill_shard_at`` run the
    online side through a shard failure and failover (see
    ``replay_online``) that the offline side never sees, so a bitwise
    pass shows the recovery is exact.
    """
    if bitwise is None:
        bitwise = not use_preagg
    offline = (cs.offline_sharded(tables, mesh=mesh, n_shards=n_shards,
                                  device=device)
               if n_shards is not None or mesh is not None
               else cs.offline(tables, device=device))
    online = (online_outputs if online_outputs is not None
              else replay_online(cs, tables, use_preagg=use_preagg,
                                 n_shards=n_shards, mesh=mesh,
                                 replication=replication,
                                 kill_shard_at=kill_shard_at,
                                 ship_every=ship_every, device=device))
    mism: List[str] = []
    max_abs = 0.0
    max_rel = 0.0
    n_exact = 0
    for name in offline:
        a = np.asarray(offline[name], dtype=np.float64)
        b = np.asarray(online[name], dtype=np.float64)
        if a.shape != b.shape:
            b = b.reshape(a.shape)
        if a.size == 0:
            n_exact += 1
            continue
        d = np.abs(a - b)
        dmax = float(d.max())
        rel = float((d / np.maximum(np.abs(a), 1.0)).max())
        max_abs = max(max_abs, dmax)
        max_rel = max(max_rel, rel)
        if dmax == 0.0:
            n_exact += 1
        elif bitwise or not (dmax <= atol or rel <= rtol):
            mism.append(name)
    return ConsistencyReport(
        n_rows=len(tables[cs.script.base_table]),
        n_features=len(offline), n_exact=n_exact, max_abs_diff=max_abs,
        max_rel_diff=max_rel, passed=not mism, mismatched=mism,
        bitwise_gate=bitwise)
