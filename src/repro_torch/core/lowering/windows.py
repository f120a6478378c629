"""Window-fold lowering: the one place fold semantics are defined.

Every window fold runs through the *unit fold core* (``fold_unit``): one
padded unit of (key, ts, rank, arrival)-sorted rows, one shared structure
per deduplicated leaf (§4.2 cycle binding), one bounds computation, one
query program:

* invertible leaves   — inclusive combine-scan + prefix difference
                        (§5.2 subtract-and-evict);
* idempotent leaves   — sparse-table min/max: any window in two lookups;
* order-sensitive     — ordered segment trees (§5.1's structure).

``fold_impl(ctx)`` picks the executor: ``None`` runs the STAGED per-leaf
build/query below (``unit_leaf_build`` / ``unit_leaf_query``, plain torch
over ``core.window``), a fused impl sends the whole group to
``kernels.unit_fold`` — one dispatch, the same bits.  Both take a batched
(U, R) block of units; the reference vmaps one unit at a time.

The two executors differ only in how they GATHER rows into that layout:

* **offline unit engine** (``lower_group_offline`` -> ``GroupLowering``,
  ``fold_units``) — the offline input is merged ONCE per window group,
  (key, ts, rank, arrival)-sorted by one stable sort of a composite key,
  cut into partition units by ``core.skew`` (whole cold keys; hot keys
  time-sliced with halo rows), bucketed into power-of-two width classes,
  and folded as dense (units, rows) blocks at every row;
* **online unit gather** (``gather_unit``, or the scatter-merge
  ``gather_unit_fused`` on the fused path) — each request key's whole
  history is gathered from the live store into the same layout (same
  merge order, same sentinel padding, the request row appended after its
  peers) and the unit fold is queried at the request position.  The
  prefix scans are anchored at the key segment's first row, so the
  result equals the offline fold's bit for bit whenever the gather buffer
  covers the key's history and the offline plan did not time-slice the
  key.

``gather_unit`` merges by one stable sort of the timestamps (the sources
are concatenated in rank order, each in arrival order, so that is the
reference's (ts, rank, arrival) lexsort).  ``gather_unit_fused`` merges
without a sort: each buffer is already time-sorted with its valid rows as
a prefix, so every valid row's merged position is its index plus, per
other source, a searchsorted row count; one scatter builds the
source-row index per unit slot, and every column fills by gather.
``gather_edges`` (bounded raw-edge gathers for §5.1 pre-aggregation) is
the only other store-read path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels.unit_fold import ops as unit_fold_ops
from ...storage import timestore
from .. import skew
from ..expr import ColumnRef, collect_columns
from ..functions import Aggregator, Leaf, build_aggregator
from ..plan import FeaturePlan, FeatureScript, WindowAgg
from ..preagg import PreAgg
from ..window import (associative_scan, first_geq, prefix_window_fold,
                      sparse_levels, sparse_query, take_rows, tree_levels,
                      tree_query)

__all__ = ["LoweredWindow", "lower_windows", "unique_leaves",
           "group_windows", "group_leaf_set", "UnitBlock", "GroupLowering",
           "lower_group_offline", "fold_impl", "fused_prelift",
           "unit_leaf_build", "unit_leaf_query", "unit_bounds", "fold_unit",
           "fold_units", "gather_unit", "gather_unit_fused", "gather_edges",
           "INT_MIN"]

INT_MIN = -(2**31) + 2
INT_MAX = 2**31 - 1


def unique_leaves(aggs: Sequence[Aggregator]) -> Dict[str, Leaf]:
    """Leaf-level CSE (§4.2 cycle binding): aggregators over the same
    column share one accumulator state."""
    uniq: Dict[str, Leaf] = {}
    for a in aggs:
        for leaf in a.leaves:
            uniq.setdefault(leaf.key, leaf)
    return uniq


@dataclasses.dataclass
class LoweredWindow:
    """Everything the drivers need for one physical window."""

    node: WindowAgg
    aggs: List[Aggregator]
    feature_names: List[str]
    sources: Tuple[str, ...]        # union tables first, base LAST
    needed_cols: Tuple[str, ...]    # agg-arg columns (value columns)
    online_buffer: int
    preagg: Optional[PreAgg] = None


def lower_windows(plan: FeaturePlan, script: FeatureScript, ctx
                  ) -> List[LoweredWindow]:
    """Static analysis of every physical window node; a long window
    (``OPTIONS(long_windows=...)``) also gets its §5.1 ``PreAgg``, with
    one bucket plane per key of the partition column's compile-time
    cardinality (``ctx.cardinality``)."""
    out: List[LoweredWindow] = []
    for node in plan.physical_windows:
        spec = node.spec
        aggs, names = [], []
        for fname, call in node.agg_items:
            aggs.append(build_aggregator(call, ctx))
            names.append(fname)
        needed = set()
        for _, call in node.agg_items:
            for a in call.args:
                needed |= collect_columns(a)
        needed.discard(spec.partition_by)
        needed.discard(spec.order_by)
        # the gather is anchored at the key segment's FIRST row, so the
        # buffer sizes for the key's history, never below
        # ctx.online_buffer, and only grows for wide ROWS frames or
        # MAXSIZE caps
        buf = ctx.online_buffer
        if spec.frame_rows:
            buf = max(buf, min(4096, spec.preceding + 1))
        elif spec.maxsize:
            buf = max(buf, spec.maxsize)
        preagg = None
        if node.long_window_bucket_ms > 0 and not spec.frame_rows:
            preagg = PreAgg(
                spec=spec, leaves=unique_leaves(aggs),
                bucket_ms=node.long_window_bucket_ms,
                n_keys=ctx.cardinality(ColumnRef(spec.partition_by)),
                window_ms=spec.preceding,
                value_cols=tuple(sorted(needed)))
        out.append(LoweredWindow(
            node=node, aggs=aggs, feature_names=names,
            sources=tuple(spec.union_tables) + (script.base_table,),
            needed_cols=tuple(sorted(needed)), online_buffer=buf,
            preagg=preagg))
    return out


def fold_impl(ctx) -> Optional[Tuple[bool, Optional[bool]]]:
    """The context's fold-implementation selector as a hashable key
    component: ``None`` = the staged per-leaf fold; ``(True,
    use_kernel)`` = the fused unit fold (``kernels.unit_fold``) with its
    kernel selector (``None`` follows the tensors' device), bitwise equal
    to the staged fold."""
    if not ctx.fused_unit_fold:
        return None
    return (True, ctx.unit_fold_kernel)


def group_windows(windows: Sequence[LoweredWindow]
                  ) -> List[List[LoweredWindow]]:
    """Group physical windows that share one gathered unit layout."""
    groups: Dict[Tuple, List[LoweredWindow]] = {}
    for w in windows:
        spec = w.node.spec
        k = (spec.partition_by, spec.order_by, w.sources)
        groups.setdefault(k, []).append(w)
    return list(groups.values())


def group_leaf_set(members: Sequence[LoweredWindow]) -> Dict[str, Leaf]:
    group_leaves: Dict[str, Leaf] = {}
    for m in members:
        for k, leaf in unique_leaves(m.aggs).items():
            group_leaves.setdefault(k, leaf)
    return group_leaves


# ---------------------------------------------------------------------------
# OFFLINE unit engine: host plan (merge, sort, units) + device fold
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UnitBlock:
    """One padded (units, rows) class of a window group's partition units.

    Units are bucketed by row count into power-of-two width classes so
    block padding stays below 2x even when unit sizes are skewed.  The
    class boundaries depend only on unit sizes (data-derived), so every
    schedule buckets identically.
    """

    unit_ids: np.ndarray            # (U,) indices into the group's units
    idx: np.ndarray                 # (U, R) flat-row index (n_flat = pad)
    valid: np.ndarray               # (U, R) row present
    emit: np.ndarray                # (U, R) row emits output
    sizes: np.ndarray               # (U,) real rows per unit


@dataclasses.dataclass
class GroupLowering:
    """One window GROUP lowered against concrete tables.

    Windows sharing (partition column, order column, sources) share ONE
    merged sort, ONE §6.2 unit plan (halos cover the widest member
    window), ONE gathered dense layout, and one lift/structure build per
    deduplicated leaf; only the per-row frame bounds and the queries are
    member-specific (§6.1 window parallelism as data-pass sharing).
    """

    members: List[LoweredWindow]
    cols: Dict[str, np.ndarray]     # flat sorted value columns (+ pad row)
    key: np.ndarray                 # flat sorted partition column (int32)
    ts: np.ndarray                  # flat sorted order column (int32)
    orig: np.ndarray                # flat sorted base-row index (n_base=none)
    blocks: List[UnitBlock]
    n_sliced_units: int
    _dev: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict, repr=False)

    def device_args(self, device) -> Dict[str, Any]:
        """The plan's arrays on ``device``, cached per device: repeated
        offline calls over the same tables reuse resident buffers.  Each
        block also carries ``rows``, the base rows its emitted slots fill
        (each base row is emitted by exactly one unit)."""
        dev = torch.device(device)
        hit = self._dev.get(str(dev))
        if hit is None:
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            hit = {
                "cols": {c: put(v) for c, v in self.cols.items()},
                "ts": put(self.ts),
                "blocks": [{"idx": put(b.idx), "valid": put(b.valid),
                            "emit": put(b.emit),
                            "rows": put(self.orig[b.idx][b.emit]
                                        .astype(np.int64))}
                           for b in self.blocks],
            }
            self._dev[str(dev)] = hit
        return hit


def lower_group_offline(members: Sequence[LoweredWindow],
                        arrays: Dict[str, Dict[str, Any]],
                        base_table: str, n_base: int,
                        target_rows: int = 1024, max_slices: int = 8
                        ) -> GroupLowering:
    """Merge the group's sources, sort, and cut into partition units.

    The order is (key, ts, rank, arrival) with the base table ranking
    LAST among equal timestamps — the tie-break the online store's
    insert-after-peers policy reconstructs, which keeps replay consistent
    (``core.consistency``).  It is one stable sort of the composite
    (key, ts) key over the sources concatenated in rank order, each in
    arrival order, as the store merges.
    """
    w = members[0]
    spec = w.node.spec
    cols_needed = sorted(
        set().union(*(m.needed_cols for m in members)) -
        {spec.partition_by, spec.order_by})

    key_p, ts_p, orig_p = [], [], []
    col_p: Dict[str, List[np.ndarray]] = {c: [] for c in cols_needed}
    for rank, tname in enumerate(w.sources):
        cols = arrays[tname]
        n_t = next(iter(cols.values())).shape[0]
        is_base = tname == base_table and rank == len(w.sources) - 1
        key_p.append(np.asarray(cols[spec.partition_by], np.int64))
        ts_p.append(np.asarray(cols[spec.order_by], np.int64))
        orig_p.append(np.arange(n_t, dtype=np.int32) if is_base
                      else np.full((n_t,), n_base, np.int32))
        for c in cols_needed:
            col_p[c].append(np.asarray(cols[c]))

    key = np.concatenate(key_p)
    ts = np.concatenate(ts_p)
    orig = np.concatenate(orig_p)
    perm = np.argsort((key << 32) + (ts + 2**31), kind="stable")

    key_s = key[perm]
    ts_s = ts[perm].astype(np.int32)
    orig_s = orig[perm]
    cols_s = {c: np.concatenate(col_p[c])[perm] for c in cols_needed}

    units = skew.plan_window_units(
        key_s, ts_s,
        constraints=[(m.node.spec.frame_rows,
                      min(m.node.spec.preceding, 2**30))
                     for m in members],
        target_rows=target_rows, max_slices=max_slices)

    n_flat = key_s.shape[0]
    # bucket units into power-of-two width classes (bounded <2x padding)
    classes: Dict[int, List[int]] = {}
    for ui, u in enumerate(units):
        r = 16
        while r < u.n_rows:
            r *= 2
        classes.setdefault(r, []).append(ui)
    if not classes:
        classes = {16: []}

    blocks: List[UnitBlock] = []
    for r_pad in sorted(classes):
        uids = classes[r_pad]
        u_count = max(1, len(uids))
        idx = np.full((u_count, r_pad), n_flat, np.int64)
        valid = np.zeros((u_count, r_pad), bool)
        emit = np.zeros((u_count, r_pad), bool)
        sizes = np.zeros((len(uids),), np.int64)
        for bi, ui in enumerate(uids):
            u = units[ui]
            n_u = u.n_rows
            idx[bi, :n_u] = np.arange(u.lo, u.hi)
            valid[bi, :n_u] = True
            emit[bi, u.emit_lo - u.lo:n_u] = True
            # emit only base-table rows (union rows are fold context)
            emit[bi, :n_u] &= orig_s[u.lo:u.hi] < n_base
            sizes[bi] = n_u
        blocks.append(UnitBlock(
            unit_ids=np.asarray(uids, np.int64), idx=idx, valid=valid,
            emit=emit, sizes=sizes))

    # one sentinel pad row keeps the device gather branch-free
    ts_pad = np.concatenate([ts_s, [np.int32(2**31 - 1)]])
    orig_pad = np.concatenate([orig_s, [np.int32(n_base)]])
    cols_pad = {c: np.concatenate([v, np.zeros((1,), v.dtype)])
                for c, v in cols_s.items()}
    key_pad = np.concatenate([key_s.astype(np.int32), [np.int32(-1)]])
    return GroupLowering(
        members=list(members), cols=cols_pad, key=key_pad, ts=ts_pad,
        orig=orig_pad, blocks=blocks,
        n_sliced_units=sum(1 for u in units if u.sliced))


def fused_prelift(members: Sequence[LoweredWindow], dev: Dict[str, Any]
                  ) -> Tuple:
    """Lift a group lowering's FLAT pad-appended columns into the fused
    op's lane layout, once for ALL of the group's unit blocks.  The flat
    ``__valid__`` follows from the sentinel invariant (every row but the
    last, the pad row, is valid)."""
    spec0 = members[0].node.spec
    n = dev["ts"].shape[0]
    flat_env: Dict[str, Any] = dict(dev["cols"])
    flat_env[spec0.order_by] = dev["ts"]
    flat_env["__valid__"] = torch.arange(n, device=dev["ts"].device) < n - 1
    return unit_fold_ops.prelift_blocks(
        [m.node.spec for m in members], group_leaf_set(members),
        flat_env, order_by=spec0.order_by,
        member_keys=[tuple(unique_leaves(m.aggs)) for m in members])


# ---------------------------------------------------------------------------
# The unit fold core — the ONE implementation of every leaf program
# ---------------------------------------------------------------------------


def unit_leaf_build(leaf: Leaf, lifted: torch.Tensor):
    """Build one leaf's shared fold structure over padded units
    (U, R, *S), once per (unit, deduplicated leaf), queried by every
    member window and request row.  Each structure's combine tree
    depends only on row values and unit positions, never on the padded
    width."""
    if leaf.invertible:
        # §5.2 subtract-and-evict: inclusive combine-scan; prefix[i]
        # depends on rows [0, i] only
        return associative_scan(leaf.combine, lifted,
                                axis=lifted.dim() - 1 - len(leaf.shape))
    if leaf.idempotent:
        return sparse_levels(leaf, lifted)
    return tuple(tree_levels(leaf, lifted))


def unit_leaf_query(leaf: Leaf, built, start: torch.Tensor,
                    end: torch.Tensor) -> torch.Tensor:
    """Fold [start, end) (unit coordinates, (U, Q) each) from the built
    structure: prefix difference / sparse lookup / ordered tree walk."""
    if leaf.invertible:
        return prefix_window_fold(leaf, built, start, end,
                                  torch.zeros_like(start))
    if leaf.idempotent:
        return sparse_query(leaf, built, start, end)
    return tree_query(leaf, list(built), start, end)


def unit_bounds(spec, ts_unit: torch.Tensor, pos: torch.Tensor, r: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[start, end) frame bounds for query rows at unit positions ``pos``
    (U, Q) of units ``ts_unit`` (U, R) — the one bounds computation both
    executors share."""
    pos = pos.to(torch.int32)
    end = pos + 1
    if spec.frame_rows:
        start = torch.clamp_min(pos - min(spec.preceding, r), 0)
    else:
        target = take_rows(ts_unit, pos) - min(spec.preceding, 2**30)
        start = first_geq(ts_unit, target, torch.zeros_like(pos), end)
    if spec.maxsize:
        start = torch.maximum(start, end - spec.maxsize)
    if spec.instance_not_in_window:
        end = torch.minimum(end, pos)
        start = torch.minimum(start, end)
    return start, end


def fold_unit(members: Sequence[LoweredWindow], env: Dict[str, Any],
              queries: Optional[torch.Tensor] = None, impl=None
              ) -> List[Dict[str, torch.Tensor]]:
    """THE unit fold core: fold a (U, R) block of padded units for every
    member window.

    ``env`` holds the units' (key, ts, rank, arrival)-sorted columns —
    the order column, every needed value column, and ``__valid__``
    (padding rows lift to identity); ``queries`` (U, Q) are the unit
    positions to emit (default: every row).  Lifts and structure builds
    happen once per deduplicated leaf ACROSS the member windows; each
    member pays only its own bounds + queries.  Returns one
    ``{leaf key: (U, Q, *S)}`` dict per member.  ``impl`` (from
    ``fold_impl``) selects the executor: ``None`` runs the staged
    build/query, a fused impl the ``kernels.unit_fold`` op."""
    spec0 = members[0].node.spec
    ts_unit = env[spec0.order_by]
    u, r = ts_unit.shape
    if queries is None:
        queries = torch.arange(r, dtype=torch.int32,
                               device=ts_unit.device).expand(u, r)
    if impl is not None:
        fused = unit_fold_ops.unit_fold(
            [m.node.spec for m in members], group_leaf_set(members), env,
            queries, order_by=spec0.order_by,
            member_keys=[tuple(unique_leaves(m.aggs)) for m in members],
            use_kernel=impl[1])
        return [{k: fused[mi][k] for k in unique_leaves(m.aggs)}
                for mi, m in enumerate(members)]
    built = {k: unit_leaf_build(leaf, leaf.lift(env))
             for k, leaf in group_leaf_set(members).items()}
    out: List[Dict[str, torch.Tensor]] = []
    for m in members:
        start, end = unit_bounds(m.node.spec, ts_unit, queries, r)
        out.append({k: unit_leaf_query(leaf, built[k], start, end)
                    for k, leaf in unique_leaves(m.aggs).items()})
    return out


def fold_units(members: Sequence[LoweredWindow], dev: Dict[str, Any],
               impl=None, prelift=None) -> List[Dict[str, torch.Tensor]]:
    """Offline execution of the unit core over one (U, R) block.  The
    gather through ``idx`` IS the §6.2 halo expansion: a hot key's later
    time slices pull their window context rows into the unit.  Staged
    (``impl`` None): the block's columns are gathered and ``fold_unit``
    folds every row of every unit.  Fused: the flat lanes (``prelift``,
    shared by the group's blocks) and the (U, R) gather index go
    straight to ``kernels.unit_fold.unit_fold_blocks``."""
    spec0 = members[0].node.spec
    if impl is None:
        idx = dev["idx"].long()
        env = {c: v[idx] for c, v in dev["cols"].items()}
        env["__valid__"] = dev["valid"]
        env[spec0.order_by] = dev["ts"][idx]
        return fold_unit(members, env)
    if prelift is None:
        prelift = fused_prelift(members, dev)
    fused = unit_fold_ops.unit_fold_blocks(
        [m.node.spec for m in members], group_leaf_set(members),
        {}, dev["idx"], order_by=spec0.order_by, use_kernel=impl[1],
        prelift=prelift)
    return [{k: fused[mi][k] for k in unique_leaves(m.aggs)}
            for mi, m in enumerate(members)]


# ---------------------------------------------------------------------------
# ONLINE unit gather (request mode against the live store)
# ---------------------------------------------------------------------------


def _merge_sorted(cols_p, ts_p, valid_p):
    """Merge per-source (B, n_i) buffers, concatenated in rank order, by
    one stable sort of the timestamps (invalid rows carry the INT_MAX
    sentinel and fall to the dead tail) — the reference's
    ``lexsort((arrival, rank, ts))``, since rank and arrival already
    increase along the concatenation."""
    ts_all = torch.cat(ts_p, dim=1)
    valid = torch.cat(valid_p, dim=1)
    sort_ts = torch.where(valid, ts_all, INT_MAX)
    perm = torch.sort(sort_ts, dim=1, stable=True).indices
    env = {c: torch.gather(torch.cat([p[c] for p in cols_p], dim=1), 1,
                           perm) for c in cols_p[0]}
    env["__valid__"] = torch.gather(valid, 1, perm)
    return env, torch.gather(sort_ts, 1, perm), valid


def gather_unit(states, members: Sequence[LoweredWindow],
                keys: torch.Tensor, ts: torch.Tensor,
                values: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Gather (B,) requests' rows into (B, n_sources*buf + 1) units: the
    online counterpart of ``lower_group_offline``'s merge.  Every
    source's rows for the request key up to its insert-after-peers
    position (the key's WHOLE history, because the prefix scans are
    anchored at the key segment's first row), merged in the same (ts,
    rank, arrival) order with the same INT_MAX sentinel padding, and the
    request row appended after its peers (rank n_sources).  Returns
    ``(env, p)``: the unit columns and each request row's position."""
    w0 = members[0]
    spec = w0.node.spec
    buf = max(m.online_buffer for m in members)
    needed = sorted(set().union(*(m.needed_cols for m in members)))
    b = keys.shape[0]
    dev = keys.device
    cols_p, ts_p, valid_p = [], [], []
    for tname in w0.sources:
        cols, ts_arr, valid = timestore.gather_key_unit(
            states[tname], keys, ts, buf, needed)
        cols_p.append(cols)
        ts_p.append(ts_arr)
        valid_p.append(valid)
    req = {}
    for c in needed:
        dt = cols_p[0][c].dtype
        v = values.get(c)
        req[c] = (torch.zeros((b, 1), dtype=dt, device=dev) if v is None
                  else v.to(dt)[:, None])
    cols_p.append(req)
    ts_p.append(ts.to(torch.int32)[:, None])
    valid_p.append(torch.ones((b, 1), dtype=torch.bool, device=dev))
    env, sort_ts, valid = _merge_sorted(cols_p, ts_p, valid_p)
    env[spec.order_by] = sort_ts
    p = valid.sum(dim=1, dtype=torch.int32) - 1
    return env, p


def gather_edges(states, w: LoweredWindow, keys: torch.Tensor,
                 t0: torch.Tensor, t1: torch.Tensor) -> Dict[str, Any]:
    """Raw rows with ts in [t0, t1) across sources for (B,) requests (the
    pre-agg edge buckets, §5.1): at most ``max_bucket_rows`` per source,
    merged in (ts, rank, arrival) order."""
    cols_p, ts_p, valid_p = [], [], []
    for tname in w.sources:
        st = states[tname]
        lo, hi = timestore.range_bounds(st, keys, t0, t1 - 1)
        cols, ts_arr, valid = timestore.gather_window(
            st, lo, hi, w.preagg.max_bucket_rows, list(w.needed_cols))
        cols_p.append(cols)
        ts_p.append(ts_arr)
        valid_p.append(valid)
    env, _, _ = _merge_sorted(cols_p, ts_p, valid_p)
    return env


def gather_unit_fused(states, members: Sequence[LoweredWindow],
                      keys: torch.Tensor, ts: torch.Tensor,
                      values: Dict[str, torch.Tensor]
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Gather (B,) requests' rows into (B, n_sources*buf + 1) units.

    Unhit slots keep the pad index: timestamps read the INT_MAX sentinel
    and values zero, and ``__valid__`` masks them to identity in every
    lift.  Returns ``(env, p)``: the unit columns and each request row's
    unit position.  Integer math end to end.
    """
    w0 = members[0]
    spec = w0.node.spec
    n_src = len(w0.sources)
    buf = max(m.online_buffer for m in members)
    needed = sorted(set().union(*(m.needed_cols for m in members)))
    total = n_src * buf + 1
    b = keys.shape[0]
    dev = keys.device

    cols_p, ts_eff_p, valid_p = [], [], []
    for tname in w0.sources:
        cols, ts_arr, valid = timestore.gather_key_unit(
            states[tname], keys, ts, buf, needed)
        cols_p.append(cols)
        ts_eff_p.append(torch.where(valid, ts_arr, INT_MAX))
        valid_p.append(valid)

    base = torch.arange(buf, dtype=torch.int32, device=dev)
    pos_p = []
    for r in range(n_src):
        pos = base.expand(b, buf)              # within-source index
        for q in range(n_src):
            if q == r:
                continue
            # equal timestamps of a lower-rank source sort before
            pos = pos + torch.searchsorted(
                ts_eff_p[q], ts_eff_p[r], right=q < r).to(torch.int32)
        # invalid rows land on the extra slot ``total``, sliced off below
        pos_p.append(torch.where(valid_p[r], pos, total))

    pos_all = torch.cat(pos_p, dim=1).long()
    p = sum(v.sum(dim=1, dtype=torch.int32) for v in valid_p)

    n_rows = n_src * buf
    src_idx = torch.full((b, total + 1), n_rows, dtype=torch.int64,
                         device=dev)
    src_idx.scatter_(1, pos_all, torch.arange(
        n_rows, dtype=torch.int64, device=dev).expand(b, n_rows))
    src_idx[torch.arange(b, device=dev), p.long()] = n_rows + 1
    src_idx = src_idx[:, :total]

    env: Dict[str, torch.Tensor] = {}
    for c in needed:
        dt = cols_p[0][c].dtype
        req = values.get(c)
        req = (torch.zeros((b,), dtype=dt, device=dev) if req is None
               else req.to(dt))
        vals = torch.cat([cp[c] for cp in cols_p]
                         + [torch.zeros((b, 1), dtype=dt, device=dev),
                            req[:, None]], dim=1)
        env[c] = torch.gather(vals, 1, src_idx)
    ts_all = torch.cat(ts_eff_p + [
        torch.full((b, 1), INT_MAX, dtype=torch.int32, device=dev),
        ts.to(torch.int32)[:, None]], dim=1)
    env[spec.order_by] = torch.gather(ts_all, 1, src_idx)
    valid_all = torch.cat(valid_p + [
        torch.zeros((b, 1), dtype=torch.bool, device=dev),
        torch.ones((b, 1), dtype=torch.bool, device=dev)], dim=1)
    env["__valid__"] = torch.gather(valid_all, 1, src_idx)
    return env, p
