"""LAST JOIN lowering — the request path's point-in-time lookup.

A LAST JOIN resolves, per request row, the newest right-table row with
the same key and order value <= the request's timestamp.  The store is
pre-ranked by (key, ts), so that row is one range lookup, batched over
the request rows.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ...storage import timestore
from ..expr import ColumnRef, Expr
from ..plan import FeaturePlan, FeatureScript, LastJoinSpec
from .windows import INT_MIN

__all__ = ["join_columns", "resolve_last", "online_last_join"]


def join_columns(plan: FeaturePlan, script: FeatureScript
                 ) -> Dict[str, List[str]]:
    """Columns each LAST JOIN must expose (referenced as table.col)."""
    out: Dict[str, List[str]] = {}
    for item in plan.scalar_items:
        for e in _walk(item.expr):
            if isinstance(e, ColumnRef) and e.table and \
                    e.table != script.base_table:
                out.setdefault(e.table, []).append(e.name)
    for js in script.last_joins:
        out.setdefault(js.right_table, [])
    return out


def _walk(e: Expr):
    yield e
    for attr in ("lhs", "rhs", "operand"):
        child = getattr(e, attr, None)
        if child is not None:
            yield from _walk(child)
    for a in getattr(e, "args", ()) or ():
        yield from _walk(a)


def resolve_last(right_table: str, cols: Dict[str, torch.Tensor],
                 wanted: List[str], pos, lo, n_rows: int
                 ) -> Dict[str, torch.Tensor]:
    """Lookup tail: ``pos`` is the candidate row (already the newest
    in-range position), valid iff it did not fall below ``lo``.
    Unmatched rows read zeros plus a ``__matched__`` flag."""
    valid = pos >= lo
    safe = pos.clamp(0, max(n_rows - 1, 0)).long()
    out: Dict[str, torch.Tensor] = {}
    for col in wanted:
        v = cols[col][safe]
        out[f"{right_table}.{col}"] = torch.where(valid, v,
                                                  torch.zeros_like(v))
    out[f"{right_table}.__matched__"] = valid
    return out


def online_last_join(states, js: LastJoinSpec, join_cols, env, key, ts):
    """Request executor over (B,) request rows: the newest in-range row
    of the pre-ranked store is one range lookup."""
    st = states[js.right_table]
    jk = env.get(js.left_key)
    jk = key if jk is None else jk.to(torch.int32)
    lo, hi = timestore.range_bounds(st, jk, torch.full_like(ts, INT_MIN),
                                    ts)
    return resolve_last(js.right_table, st["cols"],
                        join_cols.get(js.right_table, []), hi - 1, lo,
                        int(st["keys"].shape[0]))
