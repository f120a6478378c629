"""Time-aware data-skew resolving for offline window computation (§6.2).

Salting breaks window correctness (same-key rows land on different
partitions, out of order).  The paper's alternative: timestamp
percentiles split each hot key's rows into time slices, and each slice
after the first is prepended with the rows of earlier slices that fall
inside the window span of its earliest rows (the *halo*), so every slice
folds its own rows exactly.

The paper's own pipeline is kept as host code around any fold:
``assign_part_ids`` gives every row its PART_ID (time slice),
``expand_partitions`` ships halo rows to the later slices that can see
them (EXPANDED_ROW), and ``skewed_window_fold`` folds each slice on its
halo-expanded rows and stitches the non-expanded outputs back.

The **unit planner** (``plan_window_units`` / ``assign_units_lpt``) turns
one (key, ts)-sorted window input into *partition units* (whole cold
keys; hot keys split into time slices with halo rows), the schedulable
atoms of the offline engine (``core.lowering.drivers``).  Units are
derived from the data alone — never from the device count — so every
schedule folds the same units with the same padded shapes.  The halo
gather itself happens on the device (``lowering.windows``).  Host numpy
only; the plan is the reference package's unit for unit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .hll import HyperLogLog

__all__ = ["SkewPlan", "plan_partitions", "assign_part_ids",
           "expand_partitions", "skewed_window_fold", "detect_skew", "Unit",
           "plan_time_slices", "plan_window_units", "assign_units_lpt"]


@dataclasses.dataclass
class SkewPlan:
    quantile: int                  # number of time slices
    boundaries: np.ndarray         # (quantile-1,) ts percentiles
    est_n_keys: float              # HLL estimate
    hot_keys: np.ndarray           # keys whose rows exceed the threshold


def detect_skew(keys: np.ndarray, threshold: float = 2.0) -> np.ndarray:
    """Keys holding more than ``threshold``× the mean per-key row count."""
    uniq, counts = np.unique(keys, return_counts=True)
    mean = counts.mean()
    return uniq[counts > threshold * mean]


def plan_partitions(keys: np.ndarray, ts: np.ndarray, quantile: int,
                    sample: int = 65536, seed: int = 0) -> SkewPlan:
    """Percentile boundaries from a bounded sample (the paper avoids full
    scans via sketches; cardinality comes from HLL and percentiles from a
    uniform sample)."""
    hll = HyperLogLog(p=12)
    hll.add(keys.astype(np.uint64))
    rng = np.random.default_rng(seed)
    if ts.shape[0] > sample:
        idx = rng.choice(ts.shape[0], size=sample, replace=False)
        ts_s = ts[idx]
    else:
        ts_s = ts
    qs = np.linspace(0, 100, quantile + 1)[1:-1]
    boundaries = np.percentile(ts_s, qs).astype(ts.dtype)
    return SkewPlan(quantile=quantile, boundaries=boundaries,
                    est_n_keys=hll.estimate(),
                    hot_keys=detect_skew(keys))


def assign_part_ids(ts: np.ndarray, plan: SkewPlan) -> np.ndarray:
    """PART_ID = index of the time slice containing the row."""
    return np.searchsorted(plan.boundaries, ts, side="right"
                           ).astype(np.int32)


def expand_partitions(keys: np.ndarray, ts: np.ndarray,
                      part_id: np.ndarray, window_ms: int, plan: SkewPlan
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Return (row_index, target_part) pairs including halo duplicates.

    A row r with PART_ID=p is also shipped to partition q > p when some row
    of slice q could still see r in its window: i.e. r.ts >= slice_q_start
    - window_ms.  EXPANDED_ROW = (target_part != PART_ID).
    """
    idx_all: List[np.ndarray] = []
    part_all: List[np.ndarray] = []
    n = keys.shape[0]
    base = np.arange(n, dtype=np.int64)
    idx_all.append(base)
    part_all.append(part_id.astype(np.int32))

    starts = np.concatenate([[np.iinfo(ts.dtype).min], plan.boundaries])
    for q in range(1, plan.quantile):
        slice_start = starts[q]
        halo = (part_id < q) & (ts >= slice_start - window_ms)
        if halo.any():
            idx_all.append(base[halo])
            part_all.append(np.full(int(halo.sum()), q, np.int32))
    return np.concatenate(idx_all), np.concatenate(part_all)


def skewed_window_fold(keys: np.ndarray, ts: np.ndarray,
                       values: np.ndarray, window_ms: int, quantile: int,
                       fold_fn, seed: int = 0) -> np.ndarray:
    """Full §6.2 pipeline around a single-partition window fold.

    ``fold_fn(keys, ts, values) -> per-row window aggregates`` is the
    ordinary (unpartitioned) computation; it runs independently per
    PART_ID partition on halo-expanded data and the non-expanded outputs
    are stitched back.  Output order matches the input rows.
    """
    plan = plan_partitions(keys, ts, quantile, seed=seed)
    part_id = assign_part_ids(ts, plan)
    row_idx, target = expand_partitions(keys, ts, part_id, window_ms, plan)
    expanded = target != part_id[row_idx]

    out = np.zeros(values.shape[0], dtype=np.float64)
    for q in range(plan.quantile):
        sel = target == q
        if not sel.any():
            continue
        rid = row_idx[sel]
        exp = expanded[sel]
        # fold over the augmented slice (the halo gives left context)
        vals = fold_fn(keys[rid], ts[rid], values[rid])
        keep = ~exp
        out[rid[keep]] = np.asarray(vals)[keep]
    return out


@dataclasses.dataclass(frozen=True)
class Unit:
    """One schedulable partition unit of a window input.

    ``lo``/``hi`` index the (key, ts)-sorted flat row array; rows in
    [lo, emit_lo) are halo (folded for context, never emitted), rows in
    [emit_lo, hi) are the unit's own slice.  A cold key is one unit with
    ``lo == emit_lo``; a hot key contributes one unit per time slice.
    """

    lo: int
    emit_lo: int
    hi: int
    sliced: bool = False

    @property
    def n_rows(self) -> int:
        return self.hi - self.lo


def plan_time_slices(ts_run: np.ndarray, max_slices: int,
                     target_rows: int) -> np.ndarray:
    """Timestamp-percentile boundaries for one hot key's sorted run.

    Returns the (possibly empty) increasing boundary array; a row belongs
    to slice q iff ``#(boundaries <= ts) == q``.  Duplicate percentiles
    are deduplicated and boundaries at or below the run's first timestamp
    dropped, so degenerate runs yield fewer (or zero) slices.
    """
    n = ts_run.shape[0]
    q = int(min(max_slices, -(-n // max(1, target_rows))))
    if q <= 1 or n == 0:
        return np.empty((0,), ts_run.dtype)
    cut_pos = (np.arange(1, q, dtype=np.int64) * n) // q
    bounds = np.unique(ts_run[cut_pos])
    return bounds[bounds > ts_run[0]]


def _run_units(lo: int, hi: int, ts_run: np.ndarray,
               constraints: Sequence[Tuple[bool, int]], max_slices: int,
               target_rows: int) -> List[Unit]:
    """Units for one key's sorted run occupying flat rows [lo, hi).

    ``constraints`` is one (frame_rows, preceding) pair per window
    sharing this layout; a slice's halo must cover the widest of them.
    """
    n = hi - lo
    if n <= target_rows or max_slices <= 1:
        return [Unit(lo, lo, hi)]
    bounds = plan_time_slices(ts_run, max_slices, target_rows)
    if bounds.shape[0] == 0:
        return [Unit(lo, lo, hi)]
    # slice starts: first row with ts >= boundary (boundary rows open the
    # upper slice)
    starts = np.searchsorted(ts_run, bounds, side="left").astype(np.int64)
    starts = np.unique(starts)
    starts = starts[(starts > 0) & (starts < n)]
    edges = np.concatenate([[0], starts, [n]])
    units: List[Unit] = []
    for s0, s1 in zip(edges[:-1], edges[1:]):
        halo = int(s0)
        for frame_rows, preceding in constraints:
            if frame_rows:
                halo = min(halo, max(0, int(s0) - int(preceding)))
            else:
                halo = min(halo, int(np.searchsorted(
                    ts_run, ts_run[s0] - preceding, side="left")))
        units.append(Unit(lo + halo, lo + int(s0), lo + int(s1),
                          sliced=True))
    # if halos drag whole prefixes along (window span ~ run span), slicing
    # buys no padding reduction and only duplicates work: one unit
    if max(u.n_rows for u in units) >= n:
        return [Unit(lo, lo, hi)]
    return units


def plan_window_units(key_sorted: np.ndarray, ts_sorted: np.ndarray,
                      frame_rows=False, preceding: int = 0,
                      target_rows: int = 1024, max_slices: int = 8,
                      constraints: Optional[Sequence[Tuple[bool, int]]]
                      = None) -> List[Unit]:
    """Partition units of one window layout's (key, ts)-sorted input.

    ``constraints`` carries (frame_rows, preceding) for every window
    sharing the layout (defaults to the single pair given positionally).
    Deterministic in the data and parameters only.
    """
    if constraints is None:
        constraints = [(frame_rows, preceding)]
    n = key_sorted.shape[0]
    if n == 0:
        return []
    run_start = np.flatnonzero(np.concatenate(
        [[True], key_sorted[1:] != key_sorted[:-1]]))
    run_end = np.concatenate([run_start[1:], [n]])
    units: List[Unit] = []
    for lo, hi in zip(run_start.tolist(), run_end.tolist()):
        units.extend(_run_units(lo, hi, ts_sorted[lo:hi], constraints,
                                max_slices, target_rows))
    return units


def assign_units_lpt(sizes: Sequence[int], n_shards: int) -> np.ndarray:
    """Greedy LPT unit -> shard assignment (largest unit first onto the
    least-loaded shard; ties break on lowest unit id / shard id, so the
    assignment is deterministic)."""
    sizes = np.asarray(sizes, np.int64)
    owner = np.zeros(sizes.shape[0], np.int32)
    load = np.zeros(max(1, n_shards), np.int64)
    order = np.argsort(-sizes, kind="stable")
    for u in order:
        s = int(np.argmin(load))
        owner[u] = s
        load[s] += int(sizes[u])
    return owner
