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

``ShardedOnlineStore`` partitions tables by key (the paper's tablets, §5,
§7.2) into a STACKED layout on one device: every leaf gains a leading
shard dimension — ``keys: (n_shards, capacity)`` etc., ``count:
(n_shards,)`` — and all rows of one key live on one shard.  The reads
take such a state directly: a (S·b,) request batch laid out shard-major
(request i reads shard i // b) seeks with one batched
``torch.searchsorted`` over the (S, capacity) composite and gathers
from the flattened columns at ``s * capacity + pos``, so a sharded batch
runs the same launches as an unsharded one of S·b requests.  On a device
mesh (``mesh=``) a table is instead a tuple of such stacked states of
one shard each, shard s's on the mesh's device s.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

INT_MAX = np.int32(2**31 - 1)
INT_MIN = -(2**31)

__all__ = ["StoreState", "OnlineStore", "ShardedOnlineStore",
           "StoreSnapshot", "make_state", "make_state_stacked",
           "insert", "insert_pos", "insert_many", "insert_many_stacked", "evict_before",
           "evict_before_stacked", "range_bounds", "gather_window",
           "gather_key_unit", "composite", "next_pow2", "route_slots",
           "shard_counts", "unstack_shard"]

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


def insert_pos(state: StoreState, key, ts) -> torch.Tensor:
    """First index i with (keys[i], ts[i]) > (key, ts), at most ``count``
    (a 0-d int32 tensor): a new row lands *after* its peers, which keeps
    arrival order among equal timestamps."""
    dev = state["keys"].device
    c = composite(torch.as_tensor(key, device=dev).to(torch.int32),
                  torch.as_tensor(ts, device=dev).to(torch.int32))
    pos = torch.searchsorted(state["comp"], c.reshape(1), right=True)[0]
    return torch.minimum(pos, state["count"].to(torch.int64)).to(torch.int32)


def insert(state: StoreState, key, ts,
           values: Dict[str, object]) -> StoreState:
    """Sorted insert of one row: every column shifted one place right
    from ``insert_pos`` on (the last row falls off a full store), the row
    written there, ``count`` + 1.  No host read of the position."""
    pos = insert_pos(state, key, ts)
    dev = state["keys"].device
    idx = torch.arange(state["keys"].shape[0], dtype=torch.int32,
                       device=dev)

    def shifted(arr, new_val):
        out = torch.where(idx > pos, torch.roll(arr, 1), arr)
        new = torch.as_tensor(new_val, device=dev).to(arr.dtype)
        return torch.where(idx == pos, new, out)

    keys = shifted(state["keys"], key)
    tss = shifted(state["ts"], ts)
    return {
        "keys": keys, "ts": tss,
        "cols": {name: shifted(arr, values.get(name, 0))
                 for name, arr in state["cols"].items()},
        "count": state["count"] + 1,
        "comp": shifted(state["comp"], composite(
            torch.as_tensor(key).to(torch.int32),
            torch.as_tensor(ts).to(torch.int32))),
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


def make_state_stacked(n_shards: int, capacity: int,
                       col_specs: Dict[str, np.dtype], device) -> StoreState:
    """(n_shards, capacity) empty tables: every leaf of ``make_state``
    with a leading shard dimension."""
    base = make_state(capacity, col_specs, device)

    def stack(t):
        return t.expand((n_shards,) + tuple(t.shape)).contiguous()

    return {"keys": stack(base["keys"]), "ts": stack(base["ts"]),
            "cols": {c: stack(v) for c, v in base["cols"].items()},
            "count": stack(base["count"]), "comp": stack(base["comp"])}


def insert_many_stacked(state: StoreState, keys: torch.Tensor,
                        ts: torch.Tensor, values: Dict[str, torch.Tensor],
                        n_new: torch.Tensor) -> StoreState:
    """``insert_many`` for every shard at once: ``keys``/``ts`` are
    (S, M) blocks whose unused slots hold INT_MAX padding (composite
    2^63 - 1, the capacity padding's), ``n_new`` (S,) the real rows per
    shard.  One batched stable sort along the rows merges every shard;
    per shard it is the permutation ``insert_many`` takes."""
    cap = state["keys"].shape[1]
    keys = keys.to(torch.int32)
    ts = ts.to(torch.int32)
    all_keys = torch.cat([state["keys"], keys], dim=1)
    all_ts = torch.cat([state["ts"], ts], dim=1)
    all_comp = torch.cat([state["comp"], composite(keys, ts)], dim=1)
    perm = torch.sort(all_comp, dim=1, stable=True).indices[:, :cap]
    new_cols = {}
    for name, arr in state["cols"].items():
        v = values.get(name)
        v = (torch.zeros(keys.shape, dtype=arr.dtype, device=arr.device)
             if v is None else v.to(arr.dtype))
        new_cols[name] = torch.gather(torch.cat([arr, v], dim=1), 1, perm)
    return {
        "keys": torch.gather(all_keys, 1, perm),
        "ts": torch.gather(all_ts, 1, perm), "cols": new_cols,
        "count": state["count"] + n_new.to(torch.int32),
        "comp": torch.gather(all_comp, 1, perm),
    }


def evict_before_stacked(state: StoreState, horizon_ts: int) -> StoreState:
    """``evict_before`` on every shard: one stable compaction of the
    (S, capacity) rows into fresh tensors (kept rows in order, then
    padding)."""
    horizon = int(np.int32(horizon_ts))
    keys, ts = state["keys"], state["ts"]
    s, cap = keys.shape
    pos = torch.arange(cap, device=keys.device)
    keep = (pos < state["count"][:, None]) & (ts >= horizon)
    dest = torch.cumsum(keep, dim=1) - 1
    base = torch.arange(s, device=keys.device)[:, None] * cap
    src = torch.nonzero(keep.reshape(-1)).flatten()
    to = (dest + base).reshape(-1)[src]

    def compact(arr, fill):
        out = torch.full((s * cap,), fill, dtype=arr.dtype, device=arr.device)
        out[to] = arr.reshape(-1)[src]
        return out.view(s, cap)

    new_keys = compact(keys, int(INT_MAX))
    new_ts = compact(ts, int(INT_MAX))
    return {
        "keys": new_keys, "ts": new_ts,
        "cols": {k: compact(v, 0) for k, v in state["cols"].items()},
        "count": keep.sum(dim=1, dtype=torch.int32),
        "comp": composite(new_keys, new_ts),
    }


def route_slots(keys, n_route_slots: int) -> np.ndarray:
    """Key -> route slot: splitmix64 of the key as uint64, modulo the
    slot count (the hash-bounded key universe the balancer works on)."""
    from ..core.hll import splitmix64

    k = np.atleast_1d(np.asarray(keys)).astype(np.uint64)
    return (splitmix64(k) % np.uint64(n_route_slots)).astype(np.int64)


def range_bounds(state: StoreState, key: torch.Tensor, t0: torch.Tensor,
                 t1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) of rows with keys==key and ts in [t0, t1], batched over
    (B,) requests (peers at t1 included — the querying row inserts after
    its peers).  Two searches of the composite key, O(log capacity).

    On a stacked (S, capacity) state the requests are laid out
    shard-major, request i of the (S·b,) batch seeking in shard i // b:
    the searches run batched over the shards, each result is clamped to
    its shard's ``count`` and returned as a position in the flattened
    (S·capacity) columns."""
    n = state["count"]
    comp = state["comp"]
    if comp.dim() == 2:
        s, cap = comp.shape
        q0 = composite(key, t0).view(s, -1)
        q1 = composite(key, t1).view(s, -1)
        lo = torch.searchsorted(comp, q0).to(torch.int32)
        hi = torch.searchsorted(comp, q1, right=True).to(torch.int32)
        lo = torch.minimum(lo, n[:, None])
        hi = torch.minimum(hi, n[:, None])
        base = (torch.arange(s, dtype=torch.int32, device=comp.device)
                * cap)[:, None]
        return ((torch.minimum(lo, hi) + base).view(-1),
                (hi + base).view(-1))
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
    (B, max_rows) buffers: (cols, ts, valid), rows in time order.
    Positions index the flattened columns (a stacked state's
    ``range_bounds`` returns them so)."""
    start = torch.maximum(lo, hi - max_rows)
    idx = start[:, None] + torch.arange(max_rows, dtype=torch.int32,
                                        device=lo.device)
    valid = idx < hi[:, None]
    safe = idx.clamp(0, state["keys"].numel() - 1).long()
    cols = {c: state["cols"][c].reshape(-1)[safe] for c in col_names}
    return cols, state["ts"].reshape(-1)[safe], valid


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
    table entries, so a shallow copy of ``tables`` is a frozen view.  A
    sharded store's routing (``assignment``) is frozen with it, so a
    later ``rebalance()`` cannot route the snapshot's requests to shards
    that no longer hold their rows.  ``refresh()`` re-cuts it from the
    live store in one rebind per field."""

    def __init__(self, store):
        self._store = store
        self.capacity = store.capacity
        self.device = store.device
        self.col_specs = store.col_specs
        self.sharded = isinstance(store, ShardedOnlineStore)
        if self.sharded:
            self.n_shards = store.n_shards
            self.n_route_slots = store.n_route_slots
            self.mesh, self.devices = store.mesh, store.devices
        self.version = -1
        self.refresh()

    def refresh(self) -> int:
        self.tables = dict(self._store.tables)
        if self.sharded:
            self.assignment = self._store.assignment.copy()
        self.version += 1
        return self.version

    def owner_of_keys(self, keys) -> np.ndarray:
        """Key -> owning shard under the FROZEN assignment."""
        return self.assignment[route_slots(keys, self.n_route_slots)
                               ].astype(np.int64)

    def n_rows_per_shard(self, table: str) -> np.ndarray:
        return shard_counts(self.tables[table])

    def n_rows(self, table: str) -> int:
        return int(shard_counts(self.tables[table]).sum())


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


class ShardedOnlineStore(_BinlogMixin):
    """Key-sharded online store: the paper's tablet partitioning (§5,
    §7.2).

    Every table's state leaf gains a leading shard dimension — ``keys:
    (n_shards, capacity)``, ``count: (n_shards,)`` etc. — and all rows of
    one partition key live on exactly one shard, so window folds over a
    key never cross shards.  Each shard keeps its rows in stable (key,
    ts, arrival) order, as an ``OnlineStore`` does.

    Layout: with ``mesh=None`` every table is ONE stacked state on
    ``device``.  With ``mesh`` (a ``distributed.sharding.Mesh``; the
    shard count is the size of its axis ``axis``) shard s's state lives
    on the mesh's device s (``stacked_store_sharding``): a table is a
    tuple of stacked states of one shard each, every mutation runs shard
    by shard on the shard's device with the stacked code at S = 1, and
    requests are served shard by shard (``CompiledScript.
    online_sharded_batch``).  The mesh is single-controller: this process
    drives every device, and the cross-shard steps (``rebalance``,
    follower promotion) are explicit copies.  Both layouts hold the same
    rows in the same order, so they serve the same bits.  ``device`` is
    the home device of a mesh store: its first shard's.

    Routing: key -> route slot (splitmix64 mod ``n_route_slots``) ->
    shard (the host-side ``assignment``).  The assignment starts as the
    static hash and is recomputed from the observed per-slot load by
    ``core.union.LoadBalancer``'s greedy LPT on ``rebalance()``, which
    migrates resident rows to their new owners.  Keys always move whole
    (hot-slot splitting is off).

    ``capacity`` is PER SHARD: a skewed key distribution needs headroom.

    Replication (``storage.replication``): slot s of the layout is shard
    s's LEADER, the only replica the serving path reads; ``shard_state``
    / ``install_shard`` / ``wipe_shard`` expose the slices followers are
    seeded from and promoted into, and the binlog (every entry carries
    table, key, ts and values) is the shipping stream.

    Every mutation builds new tensors (nothing is written in place, and a
    mesh table is a new tuple), so a snapshot cut earlier keeps its
    bytes.
    """

    def __init__(self, capacity: int, n_shards: Optional[int] = None,
                 mesh=None, axis: str = "shard",
                 n_route_slots: int = 1024, device="cuda"):
        from ..core.union import LoadBalancer

        self.devices: Optional[List[torch.device]] = None
        if mesh is not None:
            from ..distributed.sharding import (canonical_device,
                                                stacked_store_sharding)
            from ..kernels.dispatch import resolve_device

            if axis not in mesh.shape:
                raise ValueError(f"mesh has no axis {axis!r}")
            mesh_n = mesh.shape[axis]
            if n_shards is not None and n_shards != mesh_n:
                raise ValueError(f"n_shards={n_shards} != mesh axis "
                                 f"{axis!r} size {mesh_n}")
            n_shards = mesh_n
            self.devices = [canonical_device(resolve_device(d))
                            for d in stacked_store_sharding(mesh, axis)]
            device = self.devices[0]
        if not n_shards or n_shards < 1:
            raise ValueError("need n_shards >= 1 or a mesh")
        self.capacity = capacity
        self.n_shards = int(n_shards)
        self.mesh = mesh
        self.axis = axis
        self.n_route_slots = n_route_slots
        self.device = torch.device(device)
        # split_threshold=inf: hot-slot splitting stays OFF so the LPT's
        # load accounting matches the whole-key moves rebalance() makes
        self.balancer = LoadBalancer(n_route_slots, self.n_shards,
                                     split_threshold=float("inf"))
        self.assignment = self.balancer.assignment.copy()
        self._slot_counts = np.zeros(n_route_slots, np.float64)
        self.tables: Dict[str, StoreState] = {}
        self.col_specs: Dict[str, Dict[str, np.dtype]] = {}
        self.binlog: List[Tuple[str, int, int, Dict[str, float]]] = []
        self._binlog_offset = 0
        self._binlog_base = 0
        self.n_rebalances = 0

    # ----------------------------------------------------------- routing
    def route_slots(self, keys) -> np.ndarray:
        """Key -> route slot (hash-bounded key universe for balancing)."""
        return route_slots(keys, self.n_route_slots)

    def owner_of_keys(self, keys) -> np.ndarray:
        """Key -> owning shard under the current assignment."""
        return self.assignment[self.route_slots(keys)].astype(np.int64)

    def _owners_on_device(self, keys: torch.Tensor,
                          assignment: np.ndarray) -> torch.Tensor:
        """Owner of every device key under ``assignment``: the distinct
        keys are routed on the host, the rows index their owner."""
        uniq, inv = torch.unique(keys, return_inverse=True)
        own = assignment[self.route_slots(uniq.cpu().numpy())]
        return torch.from_numpy(own.astype(np.int64)).to(keys.device)[inv]

    # ------------------------------------------------------------ tables
    def create_table(self, name: str, col_specs: Dict[str, np.dtype]):
        if self.mesh is None:
            self.tables[name] = make_state_stacked(
                self.n_shards, self.capacity, col_specs, self.device)
        else:
            self.tables[name] = tuple(
                make_state_stacked(1, self.capacity, col_specs, d)
                for d in self.devices)
        self.col_specs[name] = dict(col_specs)

    def n_rows_per_shard(self, table: str) -> np.ndarray:
        return shard_counts(self.tables[table])

    def n_rows(self, table: str) -> int:
        return int(self.n_rows_per_shard(table).sum())

    def _to_device(self, arr, dtype, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(
            device or self.device)

    # ------------------------------------------------------------ ingest
    def put(self, table: str, key: int, ts: int,
            values: Dict[str, float]) -> int:
        """Single-row insert: a 1-row ``put_many`` (same routing path)."""
        cols = {c: np.asarray([v], np.float32) for c, v in values.items()}
        return self.put_many(table, np.asarray([key], np.int32),
                             np.asarray([ts], np.int32), cols)

    def put_many(self, table: str, keys, ts,
                 cols: Dict[str, np.ndarray]) -> int:
        """Bulk insert routed by key: rows are grouped per owning shard
        (arrival order kept within a shard) into (S, M) blocks padded
        with INT_MAX rows and merged by one ``insert_many_stacked`` (on a
        mesh, one per shard that receives rows, on its device); returns
        the first binlog offset."""
        keys = np.asarray(keys, np.int32)
        ts = np.asarray(ts, np.int32)
        n = keys.shape[0]
        if n == 0:
            return self._binlog_offset
        slots = self.route_slots(keys)
        owner = self.assignment[slots].astype(np.int64)
        counts = np.bincount(owner, minlength=self.n_shards)
        live = self.n_rows_per_shard(table)
        over = np.flatnonzero(live + counts > self.capacity)
        if over.size:
            s = int(over[0])
            raise ValueError(
                f"bulk put overflows shard {s}: {int(live[s])} live + "
                f"{int(counts[s])} new > per-shard capacity "
                f"{self.capacity}")
        m = next_pow2(int(max(1, counts.max())))
        pos = _rank_within(owner, counts)
        k_blk = np.full((self.n_shards, m), INT_MAX, np.int32)
        t_blk = np.full((self.n_shards, m), INT_MAX, np.int32)
        k_blk[owner, pos] = keys
        t_blk[owner, pos] = ts
        v_blk = {}
        for name, dtype in self.col_specs[table].items():
            if name in cols:
                v = np.zeros((self.n_shards, m), dtype)
                v[owner, pos] = np.asarray(cols[name], dtype)
                v_blk[name] = v
        specs = self.col_specs[table]

        def merge(state, rows, dev):
            return insert_many_stacked(
                state, self._to_device(k_blk[rows], np.int32, dev),
                self._to_device(t_blk[rows], np.int32, dev),
                {c: self._to_device(v[rows], specs[c], dev)
                 for c, v in v_blk.items()},
                self._to_device(counts[rows], np.int32, dev))

        if self.mesh is None:
            self.tables[table] = merge(self.tables[table], slice(None),
                                       self.device)
        else:
            parts = list(self.tables[table])
            for s in np.flatnonzero(counts):
                parts[s] = merge(parts[s], slice(s, s + 1), self.devices[s])
            self.tables[table] = tuple(parts)
        self._slot_counts += np.bincount(slots, minlength=self.n_route_slots)
        off = self._binlog_offset
        kl, tl = keys.tolist(), ts.tolist()
        self.binlog.extend(
            (table, kl[i], tl[i],
             {c: float(cols[c][i]) for c in cols}) for i in range(n))
        self._binlog_offset += n
        return off

    def bulk_load(self, table: str, keys, ts,
                  cols: Dict[str, np.ndarray]) -> int:
        """LOAD DATA: route once, sort every shard at once, overwrite the
        table; the loaded rows enter the binlog in (key, ts, arrival)
        order."""
        keys = np.asarray(keys, np.int32)
        ts = np.asarray(ts, np.int32)
        n = keys.shape[0]
        slots = self.route_slots(keys)
        owner = self.assignment[slots].astype(np.int64)
        specs = self.col_specs[table]
        self.tables[table] = self._build_state(
            table, self._to_device(keys, np.int32),
            self._to_device(ts, np.int32),
            {c: self._to_device(cols[c], specs[c]) for c in specs
             if c in cols},
            self._to_device(owner, np.int64))
        # after _build_state: a per-shard overflow must not leave phantom
        # load in the balancer
        self._slot_counts += np.bincount(slots, minlength=self.n_route_slots)
        order = np.lexsort((np.arange(n), ts, keys))
        ko, tso = keys[order].tolist(), ts[order].tolist()
        co = {c: np.asarray(cols[c])[order].astype(np.float64).tolist()
              for c in cols}
        names = list(co)
        self.binlog.extend(
            (table, ko[i], tso[i], {c: co[c][i] for c in names})
            for i in range(n))
        self._binlog_offset += n
        return n

    def _build_state(self, table: str, keys: torch.Tensor, ts: torch.Tensor,
                     cols: Dict[str, torch.Tensor], owner: torch.Tensor):
        """A table's state from rows given in arrival order (one device):
        the stacked state, or on a mesh the tuple of per-shard states,
        each shard's rows selected in order and laid out on its device."""
        counts = torch.bincount(owner, minlength=self.n_shards)
        if int(counts.max()) > self.capacity:
            sh = int(torch.argmax(counts))
            raise ValueError(f"shard {sh} gets {int(counts[sh])} rows > "
                             f"per-shard capacity {self.capacity}")
        specs = self.col_specs[table]
        if self.mesh is None:
            return _stack_rows(keys, ts, cols, owner, counts, self.capacity,
                               specs, self.device)
        parts = []
        for s, dev in enumerate(self.devices):
            sel = torch.nonzero(owner == s).flatten()
            parts.append(_stack_rows(
                keys[sel].to(dev), ts[sel].to(dev),
                {c: v[sel].to(dev) for c, v in cols.items()},
                torch.zeros(sel.shape[0], dtype=torch.int64, device=dev),
                counts[s:s + 1].to(dev), self.capacity, specs, dev))
        return tuple(parts)

    def evict(self, table: str, horizon_ts: int) -> None:
        """Per-shard batch TTL eviction + slot compaction (one pass)."""
        st = self.tables[table]
        self.tables[table] = (
            evict_before_stacked(st, horizon_ts) if self.mesh is None
            else tuple(evict_before_stacked(p, horizon_ts) for p in st))

    # --------------------------------------------------------- rebalance
    def rebalance(self) -> bool:
        """Hot-key rebalancing (§5.2 mapped to shards): fold the
        accumulated per-slot load into the LoadBalancer EMA, recompute
        the slot -> shard map with greedy LPT, and migrate the resident
        rows whose owner changed.  Returns True if the assignment
        changed (the engine then migrates its pre-agg planes too).

        Two-phase: every table's migrated state is built before anything
        is committed, so a per-shard capacity overflow mid-migration
        leaves routing and tables as they were.  The live rows are
        collected on one device (the home device on a mesh) in shard
        order: a row's arrival is its global source position
        ``s * capacity + i`` (all rows of one key live on one source
        shard, so per-key arrival order holds)."""
        self.balancer.observe(self._slot_counts)
        # counts are folded into the EMA exactly once: zero them NOW so a
        # retry after a failed migration does not double-count the load
        self._slot_counts[:] = 0.0
        new_assign = self.balancer.rebalance().copy()
        if np.array_equal(new_assign, self.assignment):
            return False
        new_tables: Dict[str, StoreState] = {}
        for table, st in self.tables.items():
            keys, ts, cols = _live_rows(st, self.device)
            new_tables[table] = self._build_state(
                table, keys, ts, cols,
                self._owners_on_device(keys, new_assign))
        self.tables.update(new_tables)
        self.assignment = new_assign
        self.n_rebalances += 1
        return True

    # ------------------------------------------------------- replication
    def shard_state(self, table: str, shard: int) -> StoreState:
        """Unstacked copy of one shard's slice of ``table`` — the leader's
        state, used to seed and resync follower replicas."""
        return unstack_shard(self.tables[table], shard)

    def install_shard(self, shard: int,
                      tables: Dict[str, StoreState]) -> None:
        """Put per-shard states into slot ``shard`` (follower promotion:
        the promoted replica becomes the leader of the shard's key range;
        routing is untouched).  Builds new tensors, on the slot's
        device."""
        dev = self.device if self.mesh is None else self.devices[shard]
        idx = torch.tensor([shard], device=dev)

        def put(full, part):
            return full.index_copy(0, idx, part.to(full.device)[None])

        for name, part in tables.items():
            part = dict(part, comp=composite(part["keys"], part["ts"]))
            st = self.tables[name]
            if self.mesh is None:
                self.tables[name] = {
                    "keys": put(st["keys"], part["keys"]),
                    "ts": put(st["ts"], part["ts"]),
                    "cols": {c: put(v, part["cols"][c])
                             for c, v in st["cols"].items()},
                    "count": put(st["count"], part["count"]),
                    "comp": put(st["comp"], part["comp"]),
                }
                continue
            parts = list(st)
            parts[shard] = {
                "keys": part["keys"].to(dev, copy=True)[None],
                "ts": part["ts"].to(dev, copy=True)[None],
                "cols": {c: part["cols"][c].to(dev, copy=True)[None]
                         for c in st[shard]["cols"]},
                "count": part["count"].to(dev, copy=True)[None],
                "comp": part["comp"].to(dev, copy=True)[None],
            }
            self.tables[name] = tuple(parts)

    def wipe_shard(self, shard: int) -> None:
        """Fault injection: shard ``shard`` loses all resident rows (its
        slot reads as a freshly provisioned, empty store until a replica
        is promoted into it)."""
        self.install_shard(shard, {
            name: make_state(self.capacity, self.col_specs[name],
                             self.device) for name in self.tables})

    def snapshot(self) -> StoreSnapshot:
        """Cut a frozen read view: tables AND routing."""
        return StoreSnapshot(self)


def shard_counts(state) -> np.ndarray:
    """Rows per shard of a sharded table: a stacked state or a mesh
    store's tuple of one-shard states."""
    if isinstance(state, tuple):
        return np.concatenate([p["count"].cpu().numpy() for p in state])
    return state["count"].cpu().numpy()


def unstack_shard(state, shard: int) -> StoreState:
    """Unstacked copy of shard ``shard`` of a sharded table (stacked, or
    a mesh store's tuple), on the shard's device."""
    if isinstance(state, tuple):
        state, shard = state[shard], 0
    return {"keys": state["keys"][shard].clone(),
            "ts": state["ts"][shard].clone(),
            "cols": {c: v[shard].clone() for c, v in state["cols"].items()},
            "count": state["count"][shard].clone(),
            "comp": state["comp"][shard].clone()}


def _live_rows(state, device):
    """The live rows of a sharded table on ``device``, shard by shard in
    slot order: (keys, ts, cols)."""
    parts = state if isinstance(state, tuple) else (state,)
    keys, ts, cols = [], [], {c: [] for c in parts[0]["cols"]}
    for st in parts:
        cap = st["keys"].shape[1]
        live = (torch.arange(cap, device=st["keys"].device)
                < st["count"][:, None]).reshape(-1)
        src = torch.nonzero(live).flatten()   # ascending s*cap + i
        keys.append(st["keys"].reshape(-1)[src].to(device))
        ts.append(st["ts"].reshape(-1)[src].to(device))
        for c, v in st["cols"].items():
            cols[c].append(v.reshape(-1)[src].to(device))
    return (torch.cat(keys), torch.cat(ts),
            {c: torch.cat(v) for c, v in cols.items()})


def _stack_rows(keys: torch.Tensor, ts: torch.Tensor,
                cols: Dict[str, torch.Tensor], owner: torch.Tensor,
                counts: torch.Tensor, cap: int,
                specs: Dict[str, np.dtype], device) -> StoreState:
    """Stacked state of ``counts.shape[0]`` shards from device rows given
    in arrival order: a stable sort by composite key, then a stable sort
    by owner, lays every shard's rows out in (key, ts, arrival) order —
    the order per-shard sequential inserts produce — and one scatter
    places them at ``owner * capacity + rank``."""
    s = counts.shape[0]
    keys = keys.to(torch.int32)
    ts = ts.to(torch.int32)
    perm = torch.sort(composite(keys, ts), stable=True).indices
    perm = perm[torch.sort(owner[perm], stable=True).indices]
    own_s = owner[perm]
    starts = torch.cumsum(counts, 0) - counts
    dest = own_s * cap + (torch.arange(perm.shape[0], device=perm.device)
                          - starts[own_s])
    st = make_state_stacked(s, cap, specs, device)

    def place(arr, src):
        out = arr.reshape(-1).clone()
        out[dest] = src[perm].to(out.dtype)
        return out.view(s, cap)

    new_keys = place(st["keys"], keys)
    new_ts = place(st["ts"], ts)
    return {
        "keys": new_keys, "ts": new_ts,
        "cols": {c: place(v, cols[c]) if c in cols else v
                 for c, v in st["cols"].items()},
        "count": counts.to(torch.int32),
        "comp": composite(new_keys, new_ts),
    }


def _rank_within(owner: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Each row's position among the rows of its owner, in arrival
    order."""
    order = np.argsort(owner, kind="stable")
    starts = np.cumsum(counts) - counts
    pos = np.empty(owner.shape[0], np.int64)
    pos[order] = np.arange(owner.shape[0]) - starts[owner[order]]
    return pos
