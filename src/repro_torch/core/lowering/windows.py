"""Window-fold lowering: the one place fold semantics are defined.

Every window fold runs through the *unit fold* (``kernels.unit_fold``):
one padded unit of (key, ts, rank, arrival)-sorted rows, one shared
structure per deduplicated leaf (§4.2 cycle binding), one bounds
computation, one query program.  The two executors differ only in how
they GATHER rows into that layout:

* **offline unit engine** (``lower_group_offline`` -> ``GroupLowering``,
  ``fold_units``) — the offline input is merged ONCE per window group,
  (key, ts, rank, arrival)-sorted by one stable sort of a composite key,
  cut into partition units by ``core.skew`` (whole cold keys; hot keys
  time-sliced with halo rows), bucketed into power-of-two width classes,
  and folded as dense (units, rows) blocks at every row;
* **online unit gather** (``gather_unit_fused``) — each request key's
  whole history is gathered from the live store into the same layout
  (same merge order, same sentinel padding, the request row appended
  after its peers) and the unit fold is queried at the request position.
  The prefix scans are anchored at the key segment's first row, so the
  result equals the offline fold's bit for bit whenever the gather buffer
  covers the key's history and the offline plan did not time-slice the
  key.

``gather_unit_fused`` merges the per-source buffers without a sort: each
buffer is already time-sorted with its valid rows as a prefix, so every
valid row's merged position is its index plus, per other source, a
searchsorted row count.  One scatter builds the source-row index per
unit slot, and every column fills by gather.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels.unit_fold import ops as unit_fold_ops
from ...storage import timestore
from .. import skew
from ..expr import collect_columns
from ..functions import Aggregator, Leaf, build_aggregator
from ..plan import FeaturePlan, FeatureScript, WindowAgg

__all__ = ["LoweredWindow", "lower_windows", "unique_leaves",
           "group_windows", "group_leaf_set", "UnitBlock", "GroupLowering",
           "lower_group_offline", "fold_impl", "fused_prelift",
           "fold_units", "gather_unit_fused", "INT_MIN"]

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


def lower_windows(plan: FeaturePlan, script: FeatureScript, ctx
                  ) -> List[LoweredWindow]:
    """Static analysis of every physical window node.  Long windows
    (pre-aggregation) are not part of this port yet and raise."""
    out: List[LoweredWindow] = []
    for node in plan.physical_windows:
        spec = node.spec
        if node.long_window_bucket_ms > 0 and not spec.frame_rows:
            raise NotImplementedError(
                f"long window {spec.name!r} (pre-aggregation) is not "
                f"ported yet")
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
        out.append(LoweredWindow(
            node=node, aggs=aggs, feature_names=names,
            sources=tuple(spec.union_tables) + (script.base_table,),
            needed_cols=tuple(sorted(needed)), online_buffer=buf))
    return out


def fold_impl(ctx) -> Tuple[bool, Optional[bool]]:
    """The context's fold-implementation selector as a hashable key
    component: ``(True, use_kernel)`` = the fused unit fold
    (``kernels.unit_fold``) with its kernel selector (``None`` follows
    the tensors' device).  The staged per-leaf fold is not ported, so
    every context is fused."""
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
                "blocks": [{"idx": put(b.idx), "emit": put(b.emit),
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


def fold_units(members: Sequence[LoweredWindow], dev: Dict[str, Any],
               impl=None, prelift=None) -> List[Dict[str, torch.Tensor]]:
    """Offline execution of the unit core over one (U, R) block, through
    ``kernels.unit_fold.unit_fold_blocks``: the flat lanes (``prelift``,
    shared by the group's blocks) and the block's (U, R) gather index go
    straight to the fused op.  The gather through ``idx`` IS the §6.2
    halo expansion: a hot key's later time slices pull their window
    context rows into the unit.  ``impl`` is ``fold_impl(ctx)``; only
    the fused fold is ported."""
    if impl is None:
        raise NotImplementedError(
            "the staged fold_units (per-leaf build/query) is not ported to "
            "repro_torch yet; pass impl=fold_impl(ctx)")
    spec0 = members[0].node.spec
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
