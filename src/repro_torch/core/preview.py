"""Online Preview Mode (paper Figure 3, §3.2 mode (2)).

Tests newly developed feature scripts on a *limited* slice of online data
without impacting serving: results come from a bounded cache and query
complexity is constrained (the paper limits e.g. the number of key
columns).  Enforced constraints:

  * row budget per table (most recent rows only),
  * window count / union-source / cardinality ceilings,
  * LAST JOIN count ceiling,
  * results served from a preview cache keyed by script fingerprint.

A script that passes preview is deployable as-is — same CompiledScript,
same plan, so preview results equal production results on the same data.
The features come from ``CompiledScript.offline`` over the slice, on the
card unless the caller asks for the CPU (the unit-fold kernel, and the
feature-hash kernel where the script calls ``discrete()``).

The cache key is the JAX package's — the script fingerprint, the row
budget and each slice's row count — plus the device.  It does not hash
the slices' content, so a second preview over other rows with the same
counts returns the first call's features, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..kernels.dispatch import resolve_device
from .compiler import CompiledScript, compile_script
from .types import Table

__all__ = ["PreviewLimits", "PreviewResult", "preview"]


@dataclasses.dataclass(frozen=True)
class PreviewLimits:
    max_rows_per_table: int = 1000
    max_windows: int = 8
    max_union_sources: int = 4
    max_joins: int = 4
    max_cardinality: int = 128


@dataclasses.dataclass
class PreviewResult:
    features: Dict[str, np.ndarray]
    n_rows: int
    truncated: bool
    violations: List[str]
    cache_hit: bool

    @property
    def ok(self) -> bool:
        return not self.violations


_PREVIEW_CACHE: Dict[str, Dict[str, np.ndarray]] = {}


def _check(cs: CompiledScript, limits: PreviewLimits) -> List[str]:
    v = []
    if len(cs.windows) > limits.max_windows:
        v.append(f"too many physical windows ({len(cs.windows)} > "
                 f"{limits.max_windows})")
    for w in cs.windows:
        n_src = len(w.sources)
        if n_src > limits.max_union_sources:
            v.append(f"window {w.node.spec.name!r} unions {n_src} "
                     f"sources (> {limits.max_union_sources})")
        for agg in w.aggs:
            for leaf in agg.leaves:
                shape = getattr(leaf, "shape", ())
                if shape and shape[-1] > limits.max_cardinality:
                    v.append(f"aggregate {agg.name!r} state width "
                             f"{shape[-1]} (> {limits.max_cardinality})")
    if len(cs.script.last_joins) > limits.max_joins:
        v.append(f"too many LAST JOINs ({len(cs.script.last_joins)})")
    return v


def _tail(table: Table, n: int, order_col: str) -> Table:
    if table.n_rows <= n:
        return table
    order = np.argsort(table.columns[order_col], kind="stable")[-n:]
    order = np.sort(order)
    cols = {c: v[order] for c, v in table.columns.items()}
    return Table(table.schema, cols, table.dicts,
                 {k: v[order] for k, v in table.nulls.items()})


def preview(script_or_sql, tables: Dict[str, Table],
            limits: Optional[PreviewLimits] = None,
            use_cache: bool = True, device="cuda") -> PreviewResult:
    """Run a feature script in preview mode on ``device``: the card
    unless the caller asks for the CPU; a CUDA device without a card
    raises."""
    dev = resolve_device(device)
    limits = limits or PreviewLimits()
    cs = script_or_sql if isinstance(script_or_sql, CompiledScript) \
        else compile_script(script_or_sql, tables=tables)

    violations = _check(cs, limits)
    if violations:
        return PreviewResult(features={}, n_rows=0, truncated=False,
                             violations=violations, cache_hit=False)

    order_col = cs.script.order_column
    sliced = {name: _tail(t, limits.max_rows_per_table, order_col)
              for name, t in tables.items()}
    truncated = any(sliced[n].n_rows < tables[n].n_rows for n in tables)

    key = (cs._fingerprint
           + f":{limits.max_rows_per_table}"
           + ":".join(f"{n}={t.n_rows}" for n, t in sorted(
               sliced.items()))
           + f"@{dev}")
    if use_cache and key in _PREVIEW_CACHE:
        feats = _PREVIEW_CACHE[key]
        return PreviewResult(features=feats,
                             n_rows=sliced[cs.script.base_table].n_rows,
                             truncated=truncated, violations=[],
                             cache_hit=True)

    feats = cs.offline(sliced, dev)
    _PREVIEW_CACHE[key] = feats
    return PreviewResult(features=feats,
                         n_rows=sliced[cs.script.base_table].n_rows,
                         truncated=truncated, violations=[],
                         cache_hit=False)
