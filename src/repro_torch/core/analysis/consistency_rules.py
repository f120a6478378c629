"""Static per-column consistency classification (rule IDs ``C-*``).

The one-fold-engine contract makes raw serving bitwise-equal to
``offline()`` *by construction* — both executors run the same traced
unit fold over the same rows at the same unit positions.  Every known
departure from that contract is a statically recognizable plan
property.  This module walks them:

``C-BUF``
    A key's history can exceed the online gather buffer.  The request
    gather is anchored at the key segment's FIRST row; truncation moves
    that anchor, re-bracketing the prefix scans (float-sensitive).
``C-SLICE``
    §6.2 hot-key time slicing: offline units for keys with more rows
    than ``offline_slice_rows`` start mid-history, moving the scan
    anchor relative to the online gather.
``C-PREAGG-FLOAT``
    Pre-aggregated serving re-brackets float combines into bucket
    partials (§5.1).  Idempotent leaves (min/max/HLL) and statically
    integer-valued sums (count, one-hot histograms, condition counts)
    stay bitwise; everything else is tolerance-only.
``C-PREAGG-EDGE``
    Rows per (key, fine bucket) can exceed the bounded edge-scan
    buffer (``max_bucket_rows``): edge rows would be dropped.
``C-KEYCARD``
    A partition key value can reach the pre-agg plane's ``n_keys``
    bound; out-of-range keys clip onto the last slot and collide.
``C-HLL``
    HLL sketch leaves are *approximate* (advisory): offline == online
    stays bitwise — both fold the same sketch — but the served value
    estimates the true distinct count.

Classification is conservative: with no table statistics, data-
dependent rules (C-BUF, C-SLICE, C-PREAGG-EDGE, C-KEYCARD) report the
hazard and the column degrades to ``tolerance``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..functions import AddLeaf, Aggregator, HLLLeaf, Leaf
from ..lowering.windows import group_windows

__all__ = ["CONSISTENCY_RULES", "RuleHit", "ColumnClass",
           "classify_consistency", "preagg_exact_leaf"]

CONSISTENCY_RULES: Dict[str, str] = {
    "C-BUF": "key history can exceed the online gather buffer "
             "(truncated anchor re-brackets prefix scans)",
    "C-SLICE": "offline §6.2 hot-key time slicing can move the scan "
               "anchor vs the online gather",
    "C-PREAGG-FLOAT": "pre-agg bucket partials re-bracket a "
                      "float-sensitive combine",
    "C-PREAGG-EDGE": "rows per (key, fine bucket) can exceed the "
                     "bounded pre-agg edge-scan buffer",
    "C-KEYCARD": "partition key values can exceed the pre-agg plane's "
                 "key-cardinality bound (clip collision)",
    "C-HLL": "HLL sketch output is approximate (offline == online "
             "stays bitwise)",
}

BITWISE = "bitwise"
TOLERANCE = "tolerance"


@dataclasses.dataclass(frozen=True)
class RuleHit:
    rule: str
    mode: str        # "raw" | "preagg" | "advisory"
    detail: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ColumnClass:
    column: str
    window: Optional[str]          # None for scalar / LAST JOIN columns
    raw: str                       # BITWISE | TOLERANCE
    preagg: str                    # class under pre-aggregated serving
    approximate: bool
    hits: List[RuleHit]

    def to_dict(self) -> Dict[str, object]:
        return {"column": self.column, "window": self.window,
                "raw": self.raw, "preagg": self.preagg,
                "approximate": self.approximate,
                "rules": [h.to_dict() for h in self.hits]}


def preagg_exact_leaf(leaf: Leaf) -> bool:
    """True iff re-bracketing this leaf's combine into bucket partials
    is float-exact under ANY grouping.

    Idempotent commutative combines (min/max, HLL register-max) are
    exact in every order.  ``AddLeaf`` is exact only when its lifted
    values are statically integer-valued: ``count`` (ones), ``hist``
    (one-hots), ``cate_cnt`` (condition-masked one-hots) — integer f32
    sums are exact below 2**24.  Value-carrying sums (``sum``,
    ``sumsq``, ``cate_sum``), EW decay rescaling, and drawdown's
    in-combine division are order-sensitive in floats.
    """
    if getattr(leaf, "idempotent", False):
        return True
    if isinstance(leaf, AddLeaf):
        kind = leaf.key.split(":", 1)[0]
        return kind in ("count", "hist", "cate_cnt")
    return False


def _per_key_counts(table, key_col: str) -> Optional[np.ndarray]:
    cols = getattr(table, "columns", None)
    if not cols or key_col not in cols:
        return None
    keys = np.asarray(cols[key_col], np.int64)
    if keys.size == 0:
        return np.zeros((0,), np.int64)
    return np.unique(keys, return_counts=True)[1]


def _max_key_value(table, key_col: str) -> Optional[int]:
    cols = getattr(table, "columns", None)
    if not cols or key_col not in cols:
        return None
    keys = np.asarray(cols[key_col], np.int64)
    return int(keys.max()) if keys.size else -1


def _max_bucket_rows(tables, sources, key_col, order_col,
                     bucket_ms: int) -> Optional[int]:
    """Largest merged row count in any (key, fine bucket) cell."""
    worst = 0
    for tname in sources:
        t = tables.get(tname)
        cols = getattr(t, "columns", None)
        if not cols or key_col not in cols or order_col not in cols:
            return None
        keys = np.asarray(cols[key_col], np.int64)
        ts = np.asarray(cols[order_col], np.int64)
        if keys.size == 0:
            continue
        cell = keys * (int(ts.max()) // bucket_ms + 2) + ts // bucket_ms
        worst = max(worst, int(np.unique(cell, return_counts=True)[1]
                               .max()))
    return worst


def _group_raw_hits(cs, members, tables, capacity, n_sliced
                    ) -> List[RuleHit]:
    """C-BUF / C-SLICE hazards shared by every member of one window
    group (they share one gather layout and one §6.2 unit plan)."""
    hits: List[RuleHit] = []
    spec = members[0].node.spec
    sources = members[0].sources
    buf = max(m.online_buffer for m in members)

    # --- C-BUF: per-source per-key history vs the group gather buffer
    if tables is None:
        if capacity is not None and capacity <= buf:
            pass  # the whole store fits in the gather buffer
        else:
            hits.append(RuleHit(
                "C-BUF", "raw",
                f"no table statistics: key history is unbounded vs "
                f"gather buffer {buf} (pass tables= or capacity<= "
                f"{buf} to discharge)"))
    else:
        for tname in sources:
            counts = _per_key_counts(tables.get(tname), spec.partition_by)
            if counts is None:
                hits.append(RuleHit(
                    "C-BUF", "raw",
                    f"table {tname!r}: no {spec.partition_by!r} "
                    f"statistics — history unbounded vs buffer {buf}"))
                continue
            worst = int(counts.max()) if counts.size else 0
            if capacity is not None:
                worst = min(worst, capacity)
            if worst > buf:
                hits.append(RuleHit(
                    "C-BUF", "raw",
                    f"table {tname!r}: hottest key has {worst} rows > "
                    f"online gather buffer {buf}"))

    # --- C-SLICE: §6.2 hot-key slicing in the offline unit plan
    if cs.ctx.offline_max_slices <= 1:
        pass  # slicing disabled: one unit per key, anchors always align
    elif n_sliced is not None:
        if n_sliced:
            hits.append(RuleHit(
                "C-SLICE", "raw",
                f"offline unit plan time-slices hot keys "
                f"({n_sliced} sliced units; threshold "
                f"{cs.ctx.offline_slice_rows} rows)"))
    elif tables is None:
        hits.append(RuleHit(
            "C-SLICE", "raw",
            f"no table statistics: keys above "
            f"{cs.ctx.offline_slice_rows} rows would be time-sliced"))
    else:
        # merged per-key run length: union sources share one sorted run
        parts = []
        for tname in sources:
            cols = getattr(tables.get(tname), "columns", None)
            if not cols or spec.partition_by not in cols:
                parts = None
                break
            parts.append(np.asarray(cols[spec.partition_by], np.int64))
        worst = 0
        if parts is not None and any(p.size for p in parts):
            merged_keys = np.concatenate([p for p in parts if p.size])
            worst = int(np.unique(merged_keys,
                                  return_counts=True)[1].max())
        if parts is None or worst > cs.ctx.offline_slice_rows:
            hits.append(RuleHit(
                "C-SLICE", "raw",
                f"hottest key has {worst} rows > slice threshold "
                f"{cs.ctx.offline_slice_rows}: offline plan may "
                f"time-slice it"))
    return hits


def _agg_preagg_hits(w, agg: Aggregator, tables) -> List[RuleHit]:
    """Per-aggregator hazards under pre-aggregated serving."""
    hits: List[RuleHit] = []
    pa = w.preagg
    spec = w.node.spec
    inexact = [lf.key for lf in agg.leaves if not preagg_exact_leaf(lf)]
    if inexact:
        hits.append(RuleHit(
            "C-PREAGG-FLOAT", "preagg",
            f"leaves {inexact} re-bracket float combines into bucket "
            f"partials (exact only for integer-valued inputs, which "
            f"is not statically provable)"))

    if tables is None:
        hits.append(RuleHit(
            "C-PREAGG-EDGE", "preagg",
            f"no table statistics: rows per (key, {pa.bucket_ms}ms "
            f"bucket) unbounded vs edge buffer {pa.max_bucket_rows}"))
        hits.append(RuleHit(
            "C-KEYCARD", "preagg",
            f"no table statistics: key values unbounded vs plane "
            f"cardinality {pa.n_keys}"))
        return hits

    worst = _max_bucket_rows(tables, w.sources, spec.partition_by,
                             spec.order_by, pa.bucket_ms)
    if worst is None or worst > pa.max_bucket_rows:
        hits.append(RuleHit(
            "C-PREAGG-EDGE", "preagg",
            f"densest (key, bucket) cell has "
            f"{'unknown' if worst is None else worst} rows > edge "
            f"buffer {pa.max_bucket_rows}"))
    kmax = max((v for v in (_max_key_value(tables.get(t),
                                           spec.partition_by)
                            for t in w.sources) if v is not None),
               default=None)
    if kmax is None or kmax >= pa.n_keys:
        hits.append(RuleHit(
            "C-KEYCARD", "preagg",
            f"max key value {'unknown' if kmax is None else kmax} >= "
            f"plane cardinality {pa.n_keys} (out-of-range keys clip "
            f"and collide)"))
    return hits


def classify_consistency(cs, tables=None, capacity: Optional[int] = None,
                         n_sliced_per_group: Optional[List[int]] = None
                         ) -> Dict[str, object]:
    """Per-column static consistency classification.

    ``tables`` supplies the data statistics that discharge the
    data-dependent rules (defaults to the compile-time tables on
    ``cs.ctx``); ``capacity`` optionally bounds per-key history by the
    store size.  ``n_sliced_per_group`` injects the exact §6.2 slice
    counts (one per window group, from ``plan_offline``) — without it
    C-SLICE falls back to per-key row counts.
    """
    if tables is None:
        tables = cs.ctx.tables
    tables = tables or None        # empty compile-time dict != evidence
    groups = group_windows(cs.windows)
    columns: Dict[str, ColumnClass] = {}

    for gi, members in enumerate(groups):
        n_sliced = (n_sliced_per_group[gi]
                    if n_sliced_per_group is not None else None)
        raw_hits = _group_raw_hits(cs, members, tables, capacity,
                                   n_sliced)
        raw_cls = TOLERANCE if raw_hits else BITWISE
        for w in members:
            for name, agg in zip(w.feature_names, w.aggs):
                hits = list(raw_hits)
                approx = any(isinstance(lf, HLLLeaf) for lf in agg.leaves)
                if approx:
                    hits.append(RuleHit(
                        "C-HLL", "advisory",
                        "HLL sketch estimate: offline == online bitwise, "
                        "value approximates the true distinct count"))
                if w.preagg is not None:
                    pre_hits = _agg_preagg_hits(w, agg, tables)
                    hits.extend(pre_hits)
                    # pre-agg serving replays the same degradation
                    # surface PLUS bucket re-bracketing; raw hazards
                    # (anchor moves) only affect the raw gather path,
                    # but C-SLICE also moves the OFFLINE anchor, which
                    # inexact leaves observe under either serving mode
                    slice_hits = [h for h in raw_hits
                                  if h.rule == "C-SLICE"]
                    pre_cls = (TOLERANCE if pre_hits or slice_hits
                               else BITWISE)
                else:
                    pre_cls = raw_cls
                columns[name] = ColumnClass(
                    column=name, window=w.node.spec.name, raw=raw_cls,
                    preagg=pre_cls, approximate=approx, hits=hits)

    # scalar select items and LAST JOIN columns: point lookups /
    # row-local expressions — both executors evaluate the same traced
    # expression on the same resolved row, bitwise by construction
    for name in cs.feature_names:
        if name not in columns:
            columns[name] = ColumnClass(
                column=name, window=None, raw=BITWISE, preagg=BITWISE,
                approximate=False, hits=[])

    ordered = {n: columns[n] for n in cs.feature_names}
    return {
        "columns": {n: c.to_dict() for n, c in ordered.items()},
        "raw_bitwise": all(c.raw == BITWISE for c in ordered.values()),
        "preagg_bitwise": all(c.preagg == BITWISE
                              for c in ordered.values()),
        "evidence": "tables" if tables is not None else (
            "capacity" if capacity is not None else "none"),
    }
