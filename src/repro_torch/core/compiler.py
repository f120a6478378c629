"""Query plan compiler (§4) — one plan, one lowering, a thin driver.

A FeaturePlan lowers ONCE (``core.lowering``) to per-window folds, LAST
JOIN resolution and scalar evaluation; the fused request driver
(``lowering.drivers``) is a thin executor over that lowering.
Compilation-level optimizations from §4.2: window merging
(``plan.build_plan``), cycle binding (``lowering.windows.unique_leaves``)
and the plan cache (``lowering.cache``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .expr import ColumnRef, Expr
from .lowering import drivers as _drv
from .lowering import windows as _lw
from .lowering.cache import cache_stats, clear_cache  # noqa: F401
from .lowering.joins import join_columns
from .plan import FeaturePlan, FeatureScript, build_plan
from .types import Table

__all__ = ["CompileContext", "CompiledScript", "compile_script",
           "cache_stats", "clear_cache"]


class CompileContext:
    """Static compile-time info: category cardinalities, buffer sizes."""

    def __init__(self, tables: Optional[Dict[str, Table]] = None,
                 default_cardinality: int = 32,
                 max_cardinality: int = 256,
                 online_buffer: int = 256,
                 cardinality_overrides: Optional[Dict[str, int]] = None,
                 distinct_hll_p: Optional[int] = None,
                 distinct_hll_min_card: int = 64,
                 fused_unit_fold: bool = True):
        # the port folds every window group through the fused unit fold
        # (kernels/unit_fold); the staged fold path is not ported
        if not fused_unit_fold:
            raise NotImplementedError(
                "CompileContext option 'fused_unit_fold=False' (the staged "
                "fold path) is not ported to repro_torch yet")
        self.tables = tables or {}
        self.default_cardinality = default_cardinality
        self.max_cardinality = max_cardinality
        self.online_buffer = online_buffer
        self.overrides = dict(cardinality_overrides or {})
        # optional mergeable-sketch leaf for distinct_count over wide key
        # universes (functions.HLLLeaf)
        self.distinct_hll_p = distinct_hll_p
        self.distinct_hll_min_card = distinct_hll_min_card

    def cardinality(self, expr: Expr) -> int:
        if isinstance(expr, ColumnRef):
            if expr.name in self.overrides:
                return self.overrides[expr.name]
            for t in self.tables.values():
                d = t.dicts.get(expr.name)
                if d is not None:
                    c = max(8, len(d))
                    return min(self.max_cardinality, _round8(c))
        return self.default_cardinality


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


class CompiledScript:
    """A deployed feature script and its fused request driver."""

    def __init__(self, script: FeatureScript, ctx: CompileContext):
        self.script = script
        self.ctx = ctx
        self.plan: FeaturePlan = build_plan(script)
        self._fingerprint = script.fingerprint()   # hashed once
        self._online_fns: Dict[Tuple, Any] = {}
        self.windows: List[_lw.LoweredWindow] = _lw.lower_windows(
            self.plan, script, ctx)
        self.join_cols: Dict[str, List[str]] = join_columns(self.plan,
                                                            script)

    @property
    def fingerprint(self) -> str:
        return self._fingerprint

    @property
    def feature_names(self) -> List[str]:
        return [it.name for it in self.script.select]

    def describe_plan(self) -> str:
        return self.plan.describe()

    def required_store_columns(self) -> Dict[str, List[str]]:
        """Which columns each table's online store must retain."""
        need: Dict[str, set] = {}
        for w in self.windows:
            spec = w.node.spec
            for t in w.sources:
                s = need.setdefault(t, set())
                s |= set(w.needed_cols)
                s.add(spec.partition_by)
        for js in self.script.last_joins:
            s = need.setdefault(js.right_table, set())
            s |= set(self.join_cols.get(js.right_table, []))
            s.add(js.right_key)
        need.setdefault(self.script.base_table, set())
        return {t: sorted(cs - {"ts"}) for t, cs in need.items()}

    def fast_batch_eligible(self) -> Tuple[bool, str]:
        """Whether the fused batch path can serve this script.  The unit
        fold covers every leaf family and frame type, so every script is
        eligible; the method remains for callers that gate on it."""
        return True, ""

    def online_batch_fast(self, store, keys: Sequence[int],
                          ts: Sequence[int],
                          values: Dict[str, Sequence[float]]
                          ) -> Dict[str, np.ndarray]:
        """Fused fast path (see ``lowering.drivers``): one
        ``kernels.unit_fold`` dispatch per window group serves the whole
        batch, through the kernels on a CUDA store and the plain versions
        on a CPU store."""
        return _drv.online_batch_fast(self, store, keys, ts, values)


def compile_script(script_or_sql, tables: Optional[Dict[str, Table]] = None,
                   **ctx_kwargs) -> CompiledScript:
    """Front door: SQL text or FeatureScript -> CompiledScript."""
    if isinstance(script_or_sql, str):
        from .sql import parse

        script = parse(script_or_sql)
    else:
        script = script_or_sql
    ctx = CompileContext(tables=tables, **ctx_kwargs)
    return CompiledScript(script, ctx)
