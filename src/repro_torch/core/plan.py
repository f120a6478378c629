"""Logical plan IR — the unified query plan generator's data model (§4, §6.1).

A ``FeatureScript`` (parsed SQL or built programmatically) lowers to a plan
DAG with exactly the node types the paper introduces:

    Scan -> SimpleProject(+index column) -> {WindowAgg_i} -> ConcatJoin
         -> LastJoin* -> Output

Window merging (§4.2 parsing optimization) happens here: AggCalls whose
named windows share a canonical ``WindowSpec`` fingerprint are grouped into
one physical ``WindowAgg`` node.  The per-branch index column (``__idx__``)
is the §6.1 mechanism that lets branches run in parallel regardless of
partition order, then re-align on ConcatJoin.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

from .expr import AggCall, Expr, collect_columns
from .window import WindowSpec

__all__ = [
    "SelectItem", "LastJoinSpec", "FeatureScript",
    "PlanNode", "Scan", "SimpleProject", "WindowAgg", "ConcatJoin",
    "LastJoin", "Output", "FeaturePlan", "build_plan",
]

INDEX_COLUMN = "__idx__"


@dataclasses.dataclass(frozen=True)
class SelectItem:
    name: str
    expr: Expr


@dataclasses.dataclass(frozen=True)
class LastJoinSpec:
    """LAST JOIN right table: latest right row per left row (§4.1)."""

    right_table: str
    left_key: str
    right_key: str
    order_by: Optional[str] = None     # right-table time column
    point_in_time: bool = True         # right.order_by <= left.order ts


@dataclasses.dataclass(frozen=True)
class FeatureScript:
    base_table: str
    select: Tuple[SelectItem, ...]
    windows: Dict[str, WindowSpec]
    last_joins: Tuple[LastJoinSpec, ...] = ()
    options: Dict[str, str] = dataclasses.field(default_factory=dict)
    order_column: str = "ts"

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        h.update(self.base_table.encode())
        for it in self.select:
            h.update(f"{it.name}={it.expr.fingerprint()};".encode())
        for name in sorted(self.windows):
            h.update(f"{name}:{self.windows[name].canonical()};".encode())
        for j in self.last_joins:
            h.update(repr(j).encode())
        for k in sorted(self.options):
            h.update(f"{k}={self.options[k]};".encode())
        return h.hexdigest()[:16]

    def long_window_names(self) -> Dict[str, int]:
        """Parse OPTIONS(long_windows="w1:1d,w2:12h") -> {name: bucket_ms}."""
        from .window import parse_interval_ms

        spec = self.options.get("long_windows", "")
        div = 1000 if self.options.get("time_unit") == "s" else 1
        out = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            name, _, gran = part.partition(":")
            out[name.strip()] = (max(1, parse_interval_ms(gran) // div)
                                 if gran else 0)
        return out


# --------------------------------------------------------------------------
# Plan nodes (§6.1 vocabulary)
# --------------------------------------------------------------------------


class PlanNode:
    children: Tuple["PlanNode", ...] = ()

    def describe(self, depth=0) -> str:
        pad = "  " * depth
        lines = [f"{pad}{self!r}"]
        for c in self.children:
            lines.append(c.describe(depth + 1))
        return "\n".join(lines)


@dataclasses.dataclass(repr=False)
class Scan(PlanNode):
    table: str
    columns: Tuple[str, ...]
    children: Tuple[PlanNode, ...] = ()

    def __repr__(self):
        return f"Scan({self.table}, cols={list(self.columns)})"


@dataclasses.dataclass(repr=False)
class SimpleProject(PlanNode):
    """Marks the start of a parallel segment; injects the index column."""

    child: PlanNode = None
    add_index: bool = True

    @property
    def children(self):
        return (self.child,)

    def __repr__(self):
        return f"SimpleProject(add_index={self.add_index})"


@dataclasses.dataclass(repr=False)
class WindowAgg(PlanNode):
    """One *physical* window: a merged WindowSpec + its aggregate calls."""

    spec: WindowSpec = None
    agg_items: Tuple[Tuple[str, AggCall], ...] = ()   # (feature name, call)
    child: PlanNode = None
    long_window_bucket_ms: int = 0                     # >0 => pre-aggregated

    @property
    def children(self):
        return (self.child,)

    def __repr__(self):
        names = [n for n, _ in self.agg_items]
        lw = f", long_window={self.long_window_bucket_ms}ms" \
            if self.long_window_bucket_ms else ""
        return f"WindowAgg({self.spec.name}: {names}{lw})"


@dataclasses.dataclass(repr=False)
class ConcatJoin(PlanNode):
    """Concatenate parallel window branches on the index column (§6.1)."""

    branches: Tuple[PlanNode, ...] = ()
    join_key: str = INDEX_COLUMN

    @property
    def children(self):
        return tuple(self.branches)

    def __repr__(self):
        return f"ConcatJoin(on={self.join_key}, n={len(self.branches)})"


@dataclasses.dataclass(repr=False)
class LastJoin(PlanNode):
    spec: LastJoinSpec = None
    child: PlanNode = None

    @property
    def children(self):
        return (self.child,)

    def __repr__(self):
        s = self.spec
        return (f"LastJoin({s.right_table} on {s.left_key}={s.right_key}"
                f" order {s.order_by})")


@dataclasses.dataclass(repr=False)
class Output(PlanNode):
    names: Tuple[str, ...] = ()
    child: PlanNode = None

    @property
    def children(self):
        return (self.child,)

    def __repr__(self):
        return f"Output({list(self.names)})"


@dataclasses.dataclass
class FeaturePlan:
    script: FeatureScript
    root: Output
    physical_windows: List[WindowAgg]
    scalar_items: List[SelectItem]
    n_merged_windows: int          # named windows merged away (§4.2 stat)

    def describe(self) -> str:
        return self.root.describe()


def build_plan(script: FeatureScript) -> FeaturePlan:
    """Lower a FeatureScript to the plan DAG, applying window merging."""
    # ---- split select items: scalar vs aggregate -------------------------
    agg_items: List[Tuple[str, AggCall]] = []
    scalar_items: List[SelectItem] = []
    for item in script.select:
        if isinstance(item.expr, AggCall):
            agg_items.append((item.name, item.expr))
        else:
            scalar_items.append(item)

    # ---- window merging: canonical spec -> one physical window ----------
    canon_to_specs: Dict[str, WindowSpec] = {}
    canon_to_items: Dict[str, List[Tuple[str, AggCall]]] = {}
    for name, call in agg_items:
        if call.window not in script.windows:
            raise KeyError(f"feature {name!r} references undefined window "
                           f"{call.window!r}")
        spec = script.windows[call.window]
        canon = spec.canonical()
        canon_to_specs.setdefault(canon, spec)
        canon_to_items.setdefault(canon, []).append((name, call))
    n_named_used = len({c.window for _, c in agg_items})
    n_merged = n_named_used - len(canon_to_specs)

    # ---- assemble the DAG ------------------------------------------------
    needed = set([script.order_column])
    for _, call in agg_items:
        for a in call.args:
            needed |= collect_columns(a)
    for it in scalar_items:
        needed |= collect_columns(it.expr)
    for spec in canon_to_specs.values():
        needed.add(spec.partition_by)
        needed.add(spec.order_by)

    scan = Scan(script.base_table, tuple(sorted(needed)))
    project = SimpleProject(child=scan, add_index=True)

    long_windows = script.long_window_names()
    branches: List[WindowAgg] = []
    for canon, spec in canon_to_specs.items():
        # a physical window is "long" if ANY of its named aliases was
        # declared in OPTIONS(long_windows=...)
        bucket = 0
        for name, s in script.windows.items():
            if s.canonical() == canon and name in long_windows:
                bucket = long_windows[name] or _default_bucket(s)
        branches.append(WindowAgg(
            spec=spec, agg_items=tuple(canon_to_items[canon]),
            child=project, long_window_bucket_ms=bucket))

    node: PlanNode
    node = ConcatJoin(branches=tuple(branches)) if branches else project
    for js in script.last_joins:
        node = LastJoin(spec=js, child=node)

    out_names = tuple(it.name for it in script.select)
    root = Output(names=out_names, child=node)
    return FeaturePlan(script=script, root=root, physical_windows=branches,
                       scalar_items=scalar_items, n_merged_windows=n_merged)


def _default_bucket(spec: WindowSpec) -> int:
    """Default pre-agg bucket: ~1/64 of the window span, min 1s."""
    if spec.frame_rows:
        return 0
    return max(1000, spec.preceding // 64)
