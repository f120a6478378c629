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

Ported: unsharded serving, raw and pre-aggregated (``use_preagg``: the
replay folds every ingested row into the §5.1 bucket planes and serves
long windows from them).  Sharding, replication and fault injection are
not ported yet and raise ``NotImplementedError`` naming the option.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..kernels.dispatch import resolve_device
from ..storage.timestore import OnlineStore
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


def _not_ported(**options) -> None:
    for name, on in options.items():
        if on:
            raise NotImplementedError(
                f"consistency option {name!r} is not ported to repro_torch "
                f"yet")


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
                  device="cuda") -> Dict[str, np.ndarray]:
    """Feed rows through an online store on ``device`` in arrival order;
    collect the request-mode features of every base-table row, in base
    row order.  With ``use_preagg`` every replayed row is also folded
    into the pre-aggregation planes (``preagg_update``), which serve the
    long windows."""
    _not_ported(n_shards=n_shards is not None,
                mesh=mesh is not None, replication=replication,
                kill_shard_at=kill_shard_at is not None)
    dev = resolve_device(device)
    base = cs.script.base_table
    need = cs.required_store_columns()
    tables = {k: v for k, v in tables.items() if k in need}
    total = sum(len(t) for t in tables.values())
    store = OnlineStore(capacity=capacity or max(64, total + 8),
                        device=dev)
    for tname, cols in need.items():
        table = tables[tname]
        specs = {}
        for c in cols:
            dd = table.schema.column(c).ctype.device_dtype
            specs[c] = np.float32 if dd.kind == "f" else np.int32
        store.create_table(tname, specs)
    pre_states = cs.init_preagg_states(dev) if use_preagg else None

    n_base = len(tables[base])
    outputs: Dict[str, List[np.ndarray]] = {}
    part_keys = {w.node.spec.partition_by for w in cs.windows}
    join_keys = {j.left_key for j in cs.script.last_joins}
    # the store key column: the partition key (single-key scripts)
    key_col = next(iter(part_keys)) if part_keys else next(iter(join_keys))

    for ts, _, i, tname in _event_stream(cs, tables):
        table = tables[tname]
        key = int(table.columns[key_col][i])
        values = {c: float(table.columns[c][i]) for c in need[tname]}
        if tname == base:
            for k, v in cs.online(store, key, ts, values,
                                  preagg_states=pre_states).items():
                outputs.setdefault(k, []).append(np.asarray(v))
        store.put(tname, key, ts, values)
        if use_preagg:
            pre_states = cs.preagg_update(pre_states, tname, key, ts, values)

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
    """
    _not_ported(n_shards=n_shards is not None,
                mesh=mesh is not None, replication=replication,
                kill_shard_at=kill_shard_at is not None)
    if bitwise is None:
        bitwise = not use_preagg
    offline = cs.offline(tables, device=device)
    online = (online_outputs if online_outputs is not None
              else replay_online(cs, tables, use_preagg=use_preagg,
                                 device=device))
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
