"""Window-fold lowering for the fused request path.

Every request's window group is served by the *unit fold*: the
request key's whole history is gathered from the live store into one
padded unit of (ts, rank, arrival)-ordered rows with the request row
appended after its peers, and ``kernels.unit_fold`` folds every member
window and every deduplicated leaf of the group in one dispatch for the
whole batch.  The prefix scans are anchored at the key segment's first
row, so the result equals the offline unit fold's (same rows, same unit
positions).

``gather_unit_fused`` merges the per-source buffers without a sort: each
buffer is already time-sorted with its valid rows as a prefix, so every
valid row's merged position is its index plus, per other source, a
searchsorted row count.  One scatter builds the source-row index per
unit slot, and every column fills by gather.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from ...storage import timestore
from ..expr import collect_columns
from ..functions import Aggregator, Leaf, build_aggregator
from ..plan import FeaturePlan, FeatureScript, WindowAgg

__all__ = ["LoweredWindow", "lower_windows", "unique_leaves",
           "group_windows", "group_leaf_set",
           "gather_unit_fused", "INT_MIN"]

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
