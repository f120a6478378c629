"""Window specifications and the staged window-fold primitives.

Frame semantics (matching OpenMLDB SQL):

  * ``ROWS BETWEEN k PRECEDING AND CURRENT ROW``       (count frame)
  * ``ROWS_RANGE BETWEEN <interval> PRECEDING AND CURRENT ROW`` (time frame;
    peers — rows with equal timestamp — are included, standard SQL RANGE)
  * optional ``MAXSIZE n`` row cap, optional ``UNION table, ...``.

The staged machinery is vectorized torch with the reference's bracketing:

  * per-row binary search (``first_geq``) for time-frame bounds,
  * segmented inclusive scans + prefix differencing for invertible leaves
    (§5.2 subtract-and-evict),
  * sparse tables for idempotent leaves (min/max),
  * ordered segment trees for order-sensitive leaves (§5.1's structure,
    reused by pre-aggregation).

``associative_scan`` copies ``jax.lax.associative_scan``: the prefix of
rows ``[0, e)`` is the left fold, most significant bit first, of the
position-aligned power-of-two blocks of ``e``, each block one node of the
pair-combine levels (``scan_levels``) — the bracketing the reference's
recursion produces for every length, odd ones included
(``prefix_walk``, which the unit fold's plain version shares).

Every row-indexed primitive takes optional leading batch dimensions:
state arrays are ``(*B, n, *S)``, per-row integer vectors ``(*B, n)`` or
``(*B, Q)``, where ``S`` is the leaf's state shape.  The reference runs
one unit per call under ``vmap``; here a (U, R) block of units folds in
one call, and every unit gets the bits it would alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .functions import Aggregator, Leaf, floor_log2

__all__ = [
    "WindowSpec", "parse_interval_ms", "first_geq", "segment_starts",
    "window_bounds", "segmented_inclusive_scan", "SegmentTree",
    "fold_windows", "sorted_perm", "tree_fold", "tree_levels",
    "tree_query", "sparse_levels", "sparse_query", "associative_scan",
    "scan_levels", "prefix_walk", "prefix_window_fold", "take_rows",
]

_UNITS_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
             "d": 86_400_000}


def parse_interval_ms(text: str) -> int:
    """``"3s" -> 3000``; bare integers are milliseconds."""
    t = text.strip().lower()
    for suffix in ("ms", "s", "m", "h", "d"):
        if t.endswith(suffix):
            head = t[: -len(suffix)]
            if head and head.replace(".", "", 1).isdigit():
                return int(float(head) * _UNITS_MS[suffix])
    return int(t)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    name: str
    partition_by: str
    order_by: str
    preceding: int                 # rows (ROWS) or milliseconds (ROWS_RANGE)
    frame_rows: bool = False       # True = ROWS, False = ROWS_RANGE
    union_tables: Tuple[str, ...] = ()
    maxsize: int = 0               # 0 = unlimited
    instance_not_in_window: bool = False

    def canonical(self) -> str:
        """Fingerprint used for window merging (§4.2 parsing optimization):
        windows with identical canonical forms share one physical window."""
        return (
            f"p={self.partition_by}|o={self.order_by}|"
            f"f={'rows' if self.frame_rows else 'range'}:{self.preceding}|"
            f"u={','.join(sorted(self.union_tables))}|m={self.maxsize}|"
            f"x={int(self.instance_not_in_window)}"
        )


# --------------------------------------------------------------------------
# Row-axis helpers
# --------------------------------------------------------------------------


def _bshape(flag: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Broadcast a (*B, rows) flag against (*B, rows, *state_shape)."""
    extra = state.dim() - flag.dim()
    return flag.reshape(tuple(flag.shape) + (1,) * extra)


def _row_axis(leaf: Leaf, x: torch.Tensor) -> int:
    return x.dim() - 1 - len(leaf.shape)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: ``x`` (*B, n, *S), ``idx`` (*B, Q) -> (*B, Q, *S)
    (``jnp.take(x, idx, axis=0)`` per batch element)."""
    nb = idx.dim() - 1
    idx = idx.long()
    if nb <= 0:
        return x[idx]
    tail = tuple(x.shape[nb + 1:])
    flat = x.reshape(tuple(x.shape[:nb + 1]) + (-1,))
    ix = idx[..., None].expand(tuple(idx.shape) + (flat.shape[-1],))
    return torch.gather(flat, nb, ix).reshape(tuple(idx.shape) + tail)


def _narrow(x: torch.Tensor, axis: int, start: int, stop: Optional[int],
            step: int = 1) -> torch.Tensor:
    sl = [slice(None)] * x.dim()
    sl[axis] = slice(start, stop, step)
    return x[tuple(sl)]


def _ident_rows(leaf: Leaf, like: torch.Tensor, n: int, axis: int
                ) -> torch.Tensor:
    shape = list(like.shape)
    shape[axis] = n
    return torch.broadcast_to(leaf.identity().to(like.device),
                              tuple(shape))


# --------------------------------------------------------------------------
# associative_scan with JAX's bracketing
# --------------------------------------------------------------------------


def _tmap(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tmap(fn, t) for t in tree)
    return fn(tree)


def _tmap2(fn, a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_tmap2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def scan_levels(fn: Callable, elems, axis: int = 0) -> List:
    """Pair-combine levels: level k+1 node i = fn(level k node 2i,
    level k node 2i+1); an odd last node does not pair (it is JAX's
    ``reduced_elems``).  Level k node i covers rows [i*2^k, (i+1)*2^k)."""
    levels = [elems]
    cur = elems
    while _leaves(cur)[0].shape[axis] >= 2:
        n2 = _leaves(cur)[0].shape[axis] // 2 * 2
        cur = fn(_tmap(lambda x: _narrow(x, axis, 0, n2, 2), cur),
                 _tmap(lambda x: _narrow(x, axis, 1, n2, 2), cur))
        levels.append(cur)
    return levels


def prefix_walk(fn: Callable, node_at: Callable, e: torch.Tensor,
                n_bits: int):
    """Fold of rows [0, e) for every entry of ``e`` (all >= 1): the left
    fold, most significant bit first, of e's set-bit blocks, each block
    the position-aligned node ``node_at(k, i)`` (level k, node i) — the
    bracketing of ``jax.lax.associative_scan``.  ``node_at`` may be
    handed indices past a level's end for bits that are not taken; it
    must clamp them.  Blocks are combined with ``fn``; ``first`` marks
    entries whose fold has not started, so no identity is combined in."""
    pos = torch.zeros_like(e)
    acc = None
    first = torch.ones(e.shape, dtype=torch.bool, device=e.device)
    for k in range(n_bits - 1, -1, -1):
        taken = ((e >> k) & 1) == 1
        node = node_at(k, pos >> k)
        if acc is None:
            acc = node
        else:
            comb = fn(acc, node)
            acc = _tmap2(lambda a, c: torch.where(
                _bshape(taken & ~first, a), c, a), acc, comb)
            acc = _tmap2(lambda a, nd: torch.where(
                _bshape(taken & first, a), nd, a), acc, node)
        first = first & ~taken
        pos = pos + torch.where(taken, 1 << k, 0).to(pos.dtype)
    return acc


def associative_scan(fn: Callable, elems, reverse: bool = False,
                     axis: int = 0):
    """Inclusive scan of ``elems`` (a tensor or a tuple of tensors) along
    ``axis`` with ``jax.lax.associative_scan``'s bracketing, every
    length included; ``reverse`` scans from the end (flip, scan, flip,
    with ``fn``'s operand order unchanged, as JAX does)."""
    if reverse:
        elems = _tmap(lambda x: torch.flip(x, (axis,)), elems)
    n = _leaves(elems)[0].shape[axis]
    if n < 2:
        out = elems
    else:
        levels = scan_levels(fn, elems, axis)
        lead = _leaves(elems)[0].shape[:axis]
        e = torch.arange(1, n + 1, dtype=torch.int64,
                         device=_leaves(elems)[0].device)
        e = e.reshape((1,) * len(lead) + (n,)).expand(tuple(lead) + (n,))

        def node_at(k, i):
            lvl = levels[k]
            m = _leaves(lvl)[0].shape[axis]
            i = i.clamp(0, m - 1)
            return _tmap(lambda x: take_rows(x, i) if axis else x[i], lvl)

        out = prefix_walk(fn, node_at, e, n.bit_length())
    if reverse:
        out = _tmap(lambda x: torch.flip(x, (axis,)), out)
    return out


# --------------------------------------------------------------------------
# Vector machinery
# --------------------------------------------------------------------------


def sorted_perm(key: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by (key, ts), ties in row order — the
    timestore pre-ranking (one stable sort of the composite key)."""
    comp = (key.to(torch.int64) << 32) | (ts.to(torch.int64) + 2**31)
    return torch.sort(comp, stable=True).indices


def segment_starts(key_sorted: torch.Tensor) -> torch.Tensor:
    """For each sorted row, the index of its key-segment's first row."""
    n = key_sorted.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=key_sorted.device)
    is_start = torch.ones(key_sorted.shape, dtype=torch.bool,
                          device=key_sorted.device)
    is_start[..., 1:] = key_sorted[..., 1:] != key_sorted[..., :-1]
    return associative_scan(torch.maximum,
                            torch.where(is_start, idx, 0).to(torch.int32),
                            axis=key_sorted.dim() - 1)


def first_geq(ts_sorted: torch.Tensor, targets: torch.Tensor,
              lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Vectorized per-row binary search: smallest i in [lo, hi) with
    ts_sorted[i] >= target (hi if none).  Each row gets its own [lo, hi);
    the reference's fixed ceil(log2 n)+1 steps, converged rows staying
    put.  ``ts_sorted`` is (*B, n), the rest (*B, Q)."""
    n = ts_sorted.shape[-1]
    steps = max(1, (max(n, 2) - 1).bit_length()) + 1
    lo_ = lo.to(torch.int32)
    hi_ = hi.to(torch.int32)
    for _ in range(steps):
        mid = torch.div(lo_ + hi_, 2, rounding_mode="floor")
        v = take_rows(ts_sorted, mid.clamp(0, n - 1))
        go_right = (v < targets) & (lo_ < hi_)
        lo_ = torch.where(go_right, mid + 1, lo_)
        hi_ = torch.where(go_right | (lo_ >= hi_), hi_, mid)
    return lo_


def window_bounds(spec: WindowSpec, key_sorted: torch.Tensor,
                  ts_sorted: torch.Tensor,
                  seg_start: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row half-open [start, end) window bounds in sorted coordinates.
    ``end`` is position-based (the current row inclusive), so a row's
    window sees exactly the rows that arrived before it."""
    n = key_sorted.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=key_sorted.device)
    if seg_start is None:
        seg_start = segment_starts(key_sorted)
    end = idx + 1
    if spec.frame_rows:
        start = torch.maximum(seg_start, idx - min(spec.preceding, n))
    else:
        # windows wider than the representable span saturate to "all
        # history"
        pre = min(spec.preceding, 2**30)
        target = ts_sorted - pre
        start = first_geq(ts_sorted, target, seg_start, idx + 1)
    if spec.maxsize:
        start = torch.maximum(start, end - spec.maxsize)
    if spec.instance_not_in_window:
        end = torch.minimum(end, idx)
        start = torch.minimum(start, end)
    return start.to(torch.int32), end.to(torch.int32)


def _segment_end(key_sorted: torch.Tensor) -> torch.Tensor:
    """Exclusive end of each row's key segment."""
    n = key_sorted.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=key_sorted.device)
    is_end = torch.ones(key_sorted.shape, dtype=torch.bool,
                        device=key_sorted.device)
    is_end[..., :-1] = key_sorted[..., 1:] != key_sorted[..., :-1]
    ends = torch.where(is_end, idx + 1, n).to(torch.int32)
    return associative_scan(torch.minimum, ends, reverse=True,
                            axis=key_sorted.dim() - 1)


# --------------------------------------------------------------------------
# Invertible path: segmented scan + prefix difference (subtract-and-evict)
# --------------------------------------------------------------------------


def segmented_inclusive_scan(leaf: Leaf, lifted: torch.Tensor,
                             seg_flag: torch.Tensor) -> torch.Tensor:
    """Inclusive combine-scan that resets at segment starts: carry
    (flag, state); when the right element starts a new segment its
    state wins outright."""

    def comb(a, b):
        fa, sa = a
        fb, sb = b
        state = torch.where(_bshape(fb, sb), sb, leaf.combine(sa, sb))
        return fa | fb, state

    _, states = associative_scan(comb, (seg_flag.to(torch.bool), lifted),
                                 axis=seg_flag.dim() - 1)
    return states


def prefix_window_fold(leaf: Leaf, inclusive: torch.Tensor,
                       start: torch.Tensor, end: torch.Tensor,
                       seg_start: torch.Tensor) -> torch.Tensor:
    """fold(rows[start:end]) via prefix difference (invertible leaves)."""
    last = take_rows(inclusive, torch.clamp_min(end - 1, 0))
    prev = take_rows(inclusive, torch.clamp_min(start - 1, 0))
    ident = leaf.identity().to(inclusive.device)
    prev = torch.where(_bshape(start <= seg_start, prev),
                       torch.broadcast_to(ident, prev.shape), prev)
    folded = leaf.invert_prefix(last, prev)
    return torch.where(_bshape(end <= start, folded),
                       torch.broadcast_to(ident, folded.shape), folded)


def _pad_pow2(leaf: Leaf, lifted: torch.Tensor, axis: int) -> torch.Tensor:
    n = lifted.shape[axis]
    n_pad = 1 << max(1, (n - 1).bit_length())
    if n_pad > n:
        lifted = torch.cat([lifted, _ident_rows(leaf, lifted, n_pad - n,
                                                axis)], dim=axis)
    return lifted


def tree_fold(leaf: Leaf, lifted: torch.Tensor) -> torch.Tensor:
    """Ordered log-depth tree reduction over the row axis (the total fold
    only — the online request case and the pre-aggregation raw edges)."""
    axis = _row_axis(leaf, lifted)
    lifted = _pad_pow2(leaf, lifted, axis)
    while lifted.shape[axis] > 1:
        lifted = leaf.combine(_narrow(lifted, axis, 0, None, 2),
                              _narrow(lifted, axis, 1, None, 2))
    return lifted.select(axis, 0)


# --------------------------------------------------------------------------
# Non-invertible path: ordered segment tree (§5.1's structure)
# --------------------------------------------------------------------------


def tree_levels(leaf: Leaf, lifted: torch.Tensor) -> List[torch.Tensor]:
    """Bottom-up segment-tree levels over lifted leaf states (built once
    per (window group, leaf); shared by every query)."""
    axis = _row_axis(leaf, lifted)
    level = _pad_pow2(leaf, lifted, axis)
    levels: List[torch.Tensor] = [level]
    while level.shape[axis] > 1:
        level = leaf.combine(_narrow(level, axis, 0, None, 2),
                             _narrow(level, axis, 1, None, 2))
        levels.append(level)
    return levels


def tree_query(leaf: Leaf, levels: Sequence[torch.Tensor],
               start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Vectorized ordered fold over [start, end) for a batch of ranges
    (left accumulator grows rightward, right accumulator leftward, so
    order-sensitive combines stay exact).  The walk includes the root
    level: a query spanning the whole tree only resolves there."""
    axis = start.dim() - 1
    ident = leaf.identity().to(levels[0].device)
    res_l = torch.broadcast_to(ident, tuple(start.shape) + tuple(ident.shape))
    res_r = res_l
    l = start.to(torch.int32)
    r = end.to(torch.int32)
    for level in levels:
        m = level.shape[axis]
        active = l < r
        take_l = active & ((l & 1) == 1)
        take_r = active & ((r & 1) == 1)
        node_l = take_rows(level, l.clamp(0, m - 1))
        node_r = take_rows(level, (r - 1).clamp(0, m - 1))
        res_l = torch.where(_bshape(take_l, res_l),
                            leaf.combine(res_l, node_l), res_l)
        res_r = torch.where(_bshape(take_r, res_r),
                            leaf.combine(node_r, res_r), res_r)
        l = (l + take_l.to(torch.int32)) >> 1
        r = (r - take_r.to(torch.int32)) >> 1
    return leaf.combine(res_l, res_r)


def sparse_levels(leaf: Leaf, lifted: torch.Tensor) -> torch.Tensor:
    """Sparse-table levels for IDEMPOTENT leaves (min/max), stacked
    (*B, L, n, *S) with ``T[j, i] = fold(rows[i : i + 2^j))`` (clamped at
    the right edge); any [start, end) fold is then two overlapping
    lookups."""
    axis = _row_axis(leaf, lifted)
    n = lifted.shape[axis]
    levels = [lifted]
    j = 1
    while (1 << j) <= max(n, 1):
        prev = levels[-1]
        off = 1 << (j - 1)
        pad = _ident_rows(leaf, lifted, min(off, n), axis)
        shifted = _narrow(torch.cat([_narrow(prev, axis, off, None), pad],
                                    dim=axis), axis, 0, n)
        levels.append(leaf.combine(prev, shifted))
        j += 1
    return torch.stack(levels, dim=axis)


def sparse_query(leaf: Leaf, table: torch.Tensor, start: torch.Tensor,
                 end: torch.Tensor) -> torch.Tensor:
    """Fold [start, end) from a sparse table: combine the 2^j-row folds
    anchored at ``start`` and ``end - 2^j`` (j = floor(log2(span)))."""
    axis = start.dim() - 1
    n_lvl, n = table.shape[axis], table.shape[axis + 1]
    flat = table.reshape(tuple(table.shape[:axis]) + (n_lvl * n,)
                         + tuple(table.shape[axis + 2:]))
    span = torch.clamp_min(end - start, 1).to(torch.int32)
    j = floor_log2(span).to(torch.int32)
    lo = start.clamp(0, n - 1)
    hi = (end - torch.bitwise_left_shift(torch.ones_like(j), j)
          ).clamp(0, n - 1)
    a = take_rows(flat, j * n + lo)
    b = take_rows(flat, j * n + hi)
    out = leaf.combine(a, b)
    ident = leaf.identity().to(out.device)
    return torch.where(_bshape(end <= start, out),
                       torch.broadcast_to(ident, out.shape), out)


class SegmentTree:
    """Ordered (non-commutative-safe) segment tree over lifted leaf
    states: built once per (window, leaf), any [start, end) fold in
    O(log n) combines.  A thin wrapper over ``tree_levels`` /
    ``tree_query``."""

    def __init__(self, leaf: Leaf, lifted: torch.Tensor):
        self.leaf = leaf
        self.n = lifted.shape[_row_axis(leaf, lifted)]
        self.levels = tree_levels(leaf, lifted)

    def query(self, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
        return tree_query(self.leaf, self.levels, start, end)


# --------------------------------------------------------------------------
# Full window fold for a set of aggregators (one physical window)
# --------------------------------------------------------------------------


def fold_windows(aggs: Sequence[Aggregator], env: Dict[str, torch.Tensor],
                 start: torch.Tensor, end: torch.Tensor,
                 seg_start: torch.Tensor, seg_flag: torch.Tensor,
                 ) -> List[torch.Tensor]:
    """Every aggregator's finalized output for each row's window.  ``env``
    holds the SORTED columns; leaves are deduplicated by key (§4.2 cycle
    binding)."""
    unique: Dict[str, Leaf] = {}
    for agg in aggs:
        for leaf in agg.leaves:
            unique.setdefault(leaf.key, leaf)
    folded: Dict[str, torch.Tensor] = {}
    for key, leaf in unique.items():
        lifted = leaf.lift(env)
        if leaf.invertible:
            inclusive = segmented_inclusive_scan(leaf, lifted, seg_flag)
            folded[key] = prefix_window_fold(leaf, inclusive, start, end,
                                             seg_start)
        else:
            folded[key] = SegmentTree(leaf, lifted).query(start, end)
    return [agg.finalize(folded) for agg in aggs]
