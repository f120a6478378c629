"""Online time-series store — the refined skiplist's invariant, dense.

The paper's §7.2 structure is a two-level skiplist: level 1 sorted by
key, level 2 per-key lists sorted by timestamp.  The store keeps the
*invariant* (rows pre-ranked by (key, ts), so online access is a seek +
contiguous scan) in dense device tensors:

    keys : (capacity,) int32   sorted ascending; padding = INT32_MAX
    ts   : (capacity,) int32   sorted within each key run; padding = MAX
    cols : {name: (capacity,) float32/int32}
    count: ()        int32     live rows
    comp : (capacity,) int64   (key << 32) | (ts + 2^31), derived

``comp`` orders rows exactly as (key, ts) does, so a seek is one
``torch.searchsorted`` and a sorted merge is one stable sort.  Keys,
timestamps and positions stay int32; they become int64 only where a
torch sort, search or gather needs it.  Every mutation replaces a
table's state dict with new tensors (nothing is written in place), so a
shallow copy of ``tables`` is a consistent snapshot.  ``evict_before``
is the batch TTL deletion (§7.2): one stable compaction that keeps the
live rows with ``ts >= horizon``, in order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

INT_MAX = np.int32(2**31 - 1)
INT_MIN = -(2**31)

__all__ = ["StoreState", "OnlineStore", "StoreSnapshot", "make_state",
           "insert_many", "evict_before", "range_bounds", "gather_window",
           "gather_key_unit", "composite", "next_pow2"]

StoreState = Dict


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, (n - 1).bit_length())


def composite(keys: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """int64 sort key with the (key, ts) lexicographic order."""
    return (keys.to(torch.int64) << 32) | (ts.to(torch.int64) + 2**31)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.float32 if np.dtype(dtype).kind == "f" else torch.int32


def make_state(capacity: int, col_specs: Dict[str, np.dtype],
               device) -> StoreState:
    keys = torch.full((capacity,), int(INT_MAX), dtype=torch.int32,
                      device=device)
    ts = torch.full((capacity,), int(INT_MAX), dtype=torch.int32,
                    device=device)
    return {
        "keys": keys, "ts": ts,
        "cols": {name: torch.zeros((capacity,), dtype=_torch_dtype(dt),
                                   device=device)
                 for name, dt in col_specs.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "comp": composite(keys, ts),
    }


def insert_many(state: StoreState, keys: torch.Tensor, ts: torch.Tensor,
                values: Dict[str, torch.Tensor], n_new: int) -> StoreState:
    """Sorted insert of a batch of rows with ONE merge.

    Rows land after existing (key, ts) peers and keep their arrival
    order among themselves — the order of M sequential inserts, and of
    the reference's ``lexsort((rank, ts, keys))``: one stable sort of the
    composite key over [existing rows, new rows] in rank order gives the
    same permutation.  Rows sorted beyond ``capacity`` are dropped — the
    host wrapper guarantees they are padding only.
    """
    cap = state["keys"].shape[0]
    keys = keys.to(torch.int32)
    ts = ts.to(torch.int32)
    all_keys = torch.cat([state["keys"], keys])
    all_ts = torch.cat([state["ts"], ts])
    all_comp = torch.cat([state["comp"], composite(keys, ts)])
    perm = torch.sort(all_comp, stable=True).indices[:cap]
    m = keys.shape[0]
    new_cols = {}
    for name, arr in state["cols"].items():
        v = values.get(name)
        v = (torch.zeros((m,), dtype=arr.dtype, device=arr.device)
             if v is None else v.to(arr.dtype))
        new_cols[name] = torch.cat([arr, v])[perm]
    return {
        "keys": all_keys[perm], "ts": all_ts[perm], "cols": new_cols,
        "count": state["count"] + int(n_new), "comp": all_comp[perm],
    }


def evict_before(state: StoreState, horizon_ts: int) -> StoreState:
    """Batch TTL eviction (§7.2): a new state without the rows whose ts
    is below ``horizon_ts``.  One stable compaction: the kept live rows
    are gathered in order into fresh padded tensors (padding ``INT_MAX``
    keys and ts, zero values), ``comp`` is rebuilt from them, and the
    tensors of ``state`` are left as they were (a snapshot may hold
    them)."""
    horizon = int(np.int32(horizon_ts))
    keys, ts = state["keys"], state["ts"]
    cap = keys.shape[0]
    live = torch.arange(cap, device=keys.device) < state["count"]
    kept = torch.nonzero(live & (ts >= horizon)).flatten()
    n = kept.shape[0]

    def compact(arr, fill):
        pad = torch.full((cap - n,), fill, dtype=arr.dtype, device=arr.device)
        return torch.cat([arr[kept], pad])

    new_keys = compact(keys, int(INT_MAX))
    new_ts = compact(ts, int(INT_MAX))
    return {
        "keys": new_keys, "ts": new_ts,
        "cols": {k: compact(v, 0) for k, v in state["cols"].items()},
        "count": torch.tensor(n, dtype=torch.int32, device=keys.device),
        "comp": composite(new_keys, new_ts),
    }


def range_bounds(state: StoreState, key: torch.Tensor, t0: torch.Tensor,
                 t1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) of rows with keys==key and ts in [t0, t1], batched over
    (B,) requests (peers at t1 included — the querying row inserts after
    its peers).  Two searches of the composite key, O(log capacity)."""
    n = state["count"]
    comp = state["comp"]
    lo = torch.searchsorted(comp, composite(key, t0)).to(torch.int32)
    hi = torch.searchsorted(comp, composite(key, t1),
                            right=True).to(torch.int32)
    lo = torch.minimum(lo, n)
    hi = torch.minimum(hi, n)
    return torch.minimum(lo, hi), hi


def gather_window(state: StoreState, lo: torch.Tensor, hi: torch.Tensor,
                  max_rows: int, col_names: List[str]
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                             torch.Tensor]:
    """Gather the newest ``max_rows`` rows of each [lo, hi) into fixed
    (B, max_rows) buffers: (cols, ts, valid), rows in time order."""
    start = torch.maximum(lo, hi - max_rows)
    idx = start[:, None] + torch.arange(max_rows, dtype=torch.int32,
                                        device=lo.device)
    valid = idx < hi[:, None]
    safe = idx.clamp(0, state["keys"].shape[0] - 1).long()
    cols = {c: state["cols"][c][safe] for c in col_names}
    return cols, state["ts"][safe], valid


def gather_key_unit(state: StoreState, key: torch.Tensor, ts: torch.Tensor,
                    max_rows: int, col_names: List[str]
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                               torch.Tensor]:
    """One key's WHOLE history up to ``ts`` (peers included), newest
    ``max_rows`` rows, for each of (B,) requests — the unit-layout
    adapter the fused gather consumes."""
    lo, hi = range_bounds(state, key, torch.full_like(ts, INT_MIN), ts)
    return gather_window(state, lo, hi, max_rows, col_names)


class StoreSnapshot:
    """Point-in-time read view of a store: every mutation replaces whole
    table entries, so a shallow copy of ``tables`` is a frozen view.
    ``refresh()`` re-cuts it from the live store in one rebind."""

    def __init__(self, store):
        self._store = store
        self.capacity = store.capacity
        self.device = store.device
        self.col_specs = store.col_specs
        self.version = -1
        self.refresh()

    def refresh(self) -> int:
        self.tables = dict(self._store.tables)
        self.version += 1
        return self.version

    def n_rows(self, table: str) -> int:
        return int(self.tables[table]["count"])


class _BinlogMixin:
    """Bounded binlog: ``self.binlog`` holds entries [``_binlog_base``,
    ``_binlog_offset``); offsets stay stable across truncation."""

    def read_binlog(self, from_offset: int):
        if from_offset < self._binlog_base:
            raise ValueError(
                f"binlog offset {from_offset} was truncated (log now "
                f"starts at {self._binlog_base}); consumers must keep "
                f"their read offset at or above the truncation "
                f"low-watermark")
        return (self.binlog[from_offset - self._binlog_base:],
                self._binlog_offset)

    def truncate_binlog(self, below_offset: int) -> int:
        """Drop binlog entries below ``below_offset`` (clamped to the
        written end); returns the number dropped."""
        upto = min(int(below_offset), self._binlog_offset)
        drop = upto - self._binlog_base
        if drop <= 0:
            return 0
        del self.binlog[:drop]
        self._binlog_base = upto
        return drop


class OnlineStore(_BinlogMixin):
    """Host-facing wrapper: one StoreState per table on ``device`` + a
    binlog (monotone offsets, host side)."""

    def __init__(self, capacity: int, device="cuda"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.tables: Dict[str, StoreState] = {}
        self.col_specs: Dict[str, Dict[str, np.dtype]] = {}
        self.binlog: List[Tuple[str, int, int, Dict[str, float]]] = []
        self._binlog_offset = 0
        self._binlog_base = 0

    def create_table(self, name: str, col_specs: Dict[str, np.dtype]):
        self.tables[name] = make_state(self.capacity, col_specs,
                                       self.device)
        self.col_specs[name] = dict(col_specs)

    def _to_device(self, arr, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(arr, dtype), device=self.device)

    def _set_rows(self, table: str, keys: np.ndarray, ts: np.ndarray,
                  cols: Dict[str, np.ndarray]) -> StoreState:
        n = keys.shape[0]
        st = make_state(self.capacity, self.col_specs[table], self.device)
        st["keys"][:n] = self._to_device(keys, np.int32)
        st["ts"][:n] = self._to_device(ts, np.int32)
        for name, arr in st["cols"].items():
            arr[:n] = self._to_device(cols[name],
                                      self.col_specs[table][name])
        st["count"] = torch.tensor(n, dtype=torch.int32, device=self.device)
        st["comp"] = composite(st["keys"], st["ts"])
        self.tables[table] = st
        return st

    def bulk_load(self, table: str, keys, ts, cols: Dict[str, np.ndarray]
                  ) -> int:
        """LOAD DATA path: sort once by (key, ts, arrival) on the host and
        overwrite the table state (paper Figure 3's offline->online
        sync); every loaded row is recorded in the binlog."""
        keys = np.asarray(keys, np.int32)
        ts = np.asarray(ts, np.int32)
        n = keys.shape[0]
        if n > self.capacity:
            raise ValueError(f"bulk load of {n} rows exceeds capacity "
                             f"{self.capacity}")
        order = np.lexsort((np.arange(n), ts, keys))
        co = {c: np.asarray(cols[c])[order] for c in cols}
        self._set_rows(table, keys[order], ts[order], co)
        ko, tso = keys[order].tolist(), ts[order].tolist()
        cl = {c: v.astype(np.float64).tolist() for c, v in co.items()}
        names = list(cl)
        self.binlog.extend(
            (table, ko[i], tso[i], {c: cl[c][i] for c in names})
            for i in range(n))
        self._binlog_offset += n
        return n

    def load_state(self, table: str, state_np: Dict) -> None:
        """Take a store table state held as numpy arrays (``keys``,
        ``ts``, ``cols``, ``count``), e.g. the reference package's state
        via ``jax.tree.map(np.asarray, store.tables[t])``.  The binlog
        is not part of a state and stays as it is."""
        count = int(np.asarray(state_np["count"]))
        keys = np.asarray(state_np["keys"], np.int32)
        if keys.shape[0] != self.capacity:
            raise ValueError(f"state capacity {keys.shape[0]} != store "
                             f"capacity {self.capacity}")
        st = self._set_rows(
            table, keys, np.asarray(state_np["ts"], np.int32),
            {c: np.asarray(v) for c, v in state_np["cols"].items()})
        st["count"] = torch.tensor(count, dtype=torch.int32,
                                   device=self.device)

    def put(self, table: str, key: int, ts: int,
            values: Dict[str, float]) -> int:
        """Insert one row + append it to the binlog; returns its offset."""
        return self.put_many(table, [key], [ts],
                             {c: [v] for c, v in values.items()})

    def put_many(self, table: str, keys, ts,
                 cols: Dict[str, np.ndarray]) -> int:
        """Bulk insert of N rows with one sort-merge; returns the first
        binlog offset.  Equivalent to inserting the rows in order."""
        keys = np.asarray(keys, np.int32)
        ts = np.asarray(ts, np.int32)
        n = keys.shape[0]
        if n == 0:
            return self._binlog_offset
        if self.n_rows(table) + n > self.capacity:
            raise ValueError(f"bulk put of {n} rows overflows capacity "
                             f"{self.capacity}")
        specs = self.col_specs[table]
        vals = {name: self._to_device(cols[name], dtype)
                for name, dtype in specs.items() if name in cols}
        self.tables[table] = insert_many(
            self.tables[table], self._to_device(keys, np.int32),
            self._to_device(ts, np.int32), vals, n)
        off = self._binlog_offset
        kl, tl = keys.tolist(), ts.tolist()
        self.binlog.extend(
            (table, kl[i], tl[i],
             {c: float(cols[c][i]) for c in cols}) for i in range(n))
        self._binlog_offset += n
        return off

    def evict(self, table: str, horizon_ts: int) -> None:
        """Batch TTL eviction + slot compaction (one pass, §7.2)."""
        self.tables[table] = evict_before(self.tables[table], horizon_ts)

    def n_rows(self, table: str) -> int:
        return int(self.tables[table]["count"])

    def snapshot(self) -> StoreSnapshot:
        """Cut an immutable point-in-time read view (O(#tables))."""
        return StoreSnapshot(self)
