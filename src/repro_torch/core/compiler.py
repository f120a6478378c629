"""Query plan compiler (§4) — one plan, one lowering, thin drivers.

A FeaturePlan lowers ONCE (``core.lowering``) to per-window folds, LAST
JOIN resolution and scalar evaluation; the offline schedules (fused,
serial, the seed baseline) and the request drivers (single, batched,
fused fast path) are thin executors over that lowering
(``lowering.drivers``), which is what makes the online features equal
the offline ones (``core.consistency``).  Long windows keep §5.1
pre-aggregation planes (``core.preagg``), maintained from the ingest
path through ``preagg_update`` / ``preagg_update_many`` and read by
``online`` / ``online_batch`` with ``preagg_states``.  Key-sharded
deployments (§5 tablets) serve through ``online_sharded_batch`` and
materialize through ``offline_sharded``, with per-shard planes
(``init_preagg_states_sharded``, ``preagg_update_many_sharded``).
Compilation-level optimizations from §4.2: window merging
(``plan.build_plan``), cycle binding (``lowering.windows.unique_leaves``)
and the plan cache (``lowering.cache``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.dispatch import resolve_device
from .expr import ColumnRef, Expr
from .lowering import drivers as _drv
from .lowering import windows as _lw
from .lowering.cache import cache_stats, clear_cache  # noqa: F401
from .lowering.joins import join_columns
from .plan import FeaturePlan, FeatureScript, build_plan
from .types import Table

__all__ = ["CompileContext", "CompiledScript", "compile_script",
           "cache_stats", "clear_cache"]

INT_MIN = _lw.INT_MIN


class CompileContext:
    """Static compile-time info: category cardinalities, buffer sizes."""

    def __init__(self, tables: Optional[Dict[str, Table]] = None,
                 default_cardinality: int = 32,
                 max_cardinality: int = 256,
                 online_buffer: int = 256,
                 cardinality_overrides: Optional[Dict[str, int]] = None,
                 offline_slice_rows: int = 1024,
                 offline_max_slices: int = 8,
                 distinct_hll_p: Optional[int] = None,
                 distinct_hll_min_card: int = 64,
                 fused_unit_fold: bool = True,
                 unit_fold_kernel: Optional[bool] = None):
        self.tables = tables or {}
        self.default_cardinality = default_cardinality
        self.max_cardinality = max_cardinality
        self.online_buffer = online_buffer
        self.overrides = dict(cardinality_overrides or {})
        # §6.2 unit planning: hot keys with more than offline_slice_rows
        # rows are cut into at most offline_max_slices time slices.  The
        # parameters are part of the plan, so every offline schedule
        # folds identical units.
        self.offline_slice_rows = offline_slice_rows
        self.offline_max_slices = offline_max_slices
        # fused_unit_fold routes every driver's fold through one
        # kernels.unit_fold dispatch per window group; False runs the
        # staged per-leaf build/query (plain torch), with the same bits.
        # The fused fold's kernel selector (kernels.dispatch.resolve):
        # None follows the tensors' device, True forces the CUDA kernel,
        # False runs the plain version (the kernel's reference)
        self.fused_unit_fold = fused_unit_fold
        self.unit_fold_kernel = unit_fold_kernel
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
    """A deployed feature script: offline + online drivers sharing one
    lowering."""

    def __init__(self, script: FeatureScript, ctx: CompileContext):
        self.script = script
        self.ctx = ctx
        self.plan: FeaturePlan = build_plan(script)
        self._fingerprint = script.fingerprint()   # hashed once
        self._online_fns: Dict[Tuple, Any] = {}
        self._offline_plan_cache: Dict[Tuple, Any] = {}
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

    # ======================================================================
    # OFFLINE driver (batch over whole tables)
    # ======================================================================

    def offline(self, tables: Dict[str, Table], device="cuda"
                ) -> Dict[str, np.ndarray]:
        """Default offline schedule (fused window-parallel groups) on
        ``device``: the card unless the caller asks for the CPU; a CUDA
        device without a card raises."""
        return _drv.offline_fused(self, tables, resolve_device(device))

    def offline_serial(self, tables: Dict[str, Table], device="cuda"
                       ) -> Dict[str, np.ndarray]:
        """Serialized-branch schedule (same folds, a barrier between
        window groups)."""
        return _drv.offline_serial(self, tables, resolve_device(device))

    def offline_sharded(self, tables: Dict[str, Table], mesh=None,
                        n_shards: Optional[int] = None,
                        axis: str = "shard", device="cuda"
                        ) -> Dict[str, np.ndarray]:
        """Key-partitioned, skew-aware offline execution over
        ``n_shards`` shards stacked on ``device``, or with ``mesh`` over
        the shards of its axis ``axis``, shard s's units folded on its
        device (``device`` is then not used).  Bitwise equal to
        ``offline``; see ``lowering.drivers.offline_sharded``."""
        if mesh is None:
            return _drv.offline_sharded(self, tables, resolve_device(device),
                                        int(n_shards or 1))
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}")
        if n_shards is not None and n_shards != mesh.shape[axis]:
            raise ValueError(f"n_shards={n_shards} != mesh axis {axis!r} "
                             f"size {mesh.shape[axis]}")
        return _drv.offline_sharded(self, tables, None, mesh.shape[axis],
                                    mesh=mesh, axis=axis)

    # ======================================================================
    # ONLINE driver (request mode against the live store)
    # ======================================================================

    def online(self, store, key: int, ts: int, values: Dict[str, float],
               preagg_states: Optional[Dict[int, Any]] = None
               ) -> Dict[str, np.ndarray]:
        """Features for one request tuple (virtually inserted), on the
        store's device; long windows read ``preagg_states`` when given."""
        return _drv.online(self, store, key, ts, values,
                           preagg_states=preagg_states)

    def online_batch(self, store, keys: Sequence[int], ts: Sequence[int],
                     values: Dict[str, Sequence[float]],
                     preagg_states: Optional[Dict[int, Any]] = None
                     ) -> Dict[str, np.ndarray]:
        """Features for B requests in one batched call (the script's fold
        selector, plus the pre-aggregated windows when ``preagg_states``
        is given); bitwise equal to B single ``online`` calls."""
        return _drv.online_batch(self, store, keys, ts, values,
                                 preagg_states=preagg_states)

    # -- key-sharded serving -------------------------------------------------
    def sharded_eligible(self) -> Tuple[bool, str]:
        """Whether the script can serve from a key-sharded store: every
        row a request touches must live on the request key's shard, i.e.
        all windows partition by one column and every LAST JOIN routes by
        that same column."""
        part = {w.node.spec.partition_by for w in self.windows}
        if not part:
            return False, "no window partition column to shard by"
        if len(part) > 1:
            return (False,
                    f"windows partition by multiple columns "
                    f"{sorted(part)}: requests can only be routed by "
                    f"one key")
        for js in self.script.last_joins:
            if js.left_key not in part:
                return (False,
                        f"LAST JOIN keys on {js.left_key!r}, not the "
                        f"window partition column {sorted(part)[0]!r}: "
                        f"the joined row may live on another shard")
        return True, ""

    def online_sharded_batch(self, store, keys: Sequence[int],
                             ts: Sequence[int],
                             values: Dict[str, Sequence[float]],
                             preagg_states: Optional[Dict[int, Any]] = None
                             ) -> Dict[str, np.ndarray]:
        """Features for B requests against a ``ShardedOnlineStore`` (or
        its snapshot), on the store's device: host key-routing, one run
        of the request trace over the shard blocks, request-order
        reassembly; bitwise equal to the unsharded path."""
        return _drv.online_sharded_batch(self, store, keys, ts, values,
                                         preagg_states=preagg_states)

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

    def _observe_queries(self, ts_list: Sequence[int]):
        """§5.1 adaptive hierarchy: host-side per-query level stats."""
        for w in self.windows:
            if w.preagg is None:
                continue
            for t in ts_list:
                w.preagg.observe_query(int(t))

    # -- pre-aggregation plumbing -------------------------------------------
    def init_preagg_states(self, device="cuda") -> Dict[int, Any]:
        """Identity bucket planes of every long window, on ``device``."""
        dev = resolve_device(device)
        return {wi: w.preagg.init_state(dev)
                for wi, w in enumerate(self.windows) if w.preagg is not None}

    def init_preagg_states_sharded(self, n_shards: int, device="cuda"
                                   ) -> Dict[int, Any]:
        """Per-shard bucket planes (a leading shard dimension on every
        plane), on ``device``."""
        dev = resolve_device(device)
        return {wi: w.preagg.init_state_stacked(n_shards, dev)
                for wi, w in enumerate(self.windows) if w.preagg is not None}

    def preagg_owned_masks(self, owner_fn, n_shards: int
                           ) -> Dict[int, np.ndarray]:
        """Per-window one-hot (n_shards, n_keys) host ownership masks:
        ``owner_fn`` (the store's ``owner_of_keys``) evaluated over each
        window's key universe [0, n_keys).  They change only on
        rebalance, so callers cache them."""
        masks = {}
        for wi, w in enumerate(self.windows):
            if w.preagg is None:
                continue
            nk = w.preagg.n_keys
            owned = np.zeros((n_shards, nk), bool)
            owned[np.asarray(owner_fn(np.arange(nk))), np.arange(nk)] = True
            masks[wi] = owned
        return masks

    def preagg_update_many_sharded(self, pre_states: Dict[int, Any],
                                   table: str, keys, ts,
                                   values: Dict[str, Any],
                                   owned_masks: Dict[int, Any]):
        """Batched pre-agg maintenance on key-sharded planes: each
        window's ownership mask restricts the scatter to the planes each
        shard owns (see ``PreAgg.update_many_sharded``)."""
        for wi, w in enumerate(self.windows):
            if w.preagg is None or table not in w.sources:
                continue
            pre_states[wi] = w.preagg.update_many_sharded(
                pre_states[wi], keys, ts, values, owned_masks[wi])
        return pre_states

    def preagg_update(self, pre_states: Dict[int, Any], table: str,
                      key: int, ts: int, values: Dict[str, float]):
        """Fold one ingested row into every relevant window's buckets —
        driven from the store binlog (§5.1)."""
        for wi, w in enumerate(self.windows):
            if w.preagg is None or table not in w.sources:
                continue
            pre_states[wi] = w.preagg.update(pre_states[wi], key, ts, values)
        return pre_states

    def preagg_update_many(self, pre_states: Dict[int, Any], table: str,
                           keys, ts, values: Dict[str, Any]):
        """Batched pre-agg maintenance: fold N ingested rows per window
        with one ordered fold + scatter (see ``PreAgg.update_many``)."""
        for wi, w in enumerate(self.windows):
            if w.preagg is None or table not in w.sources:
                continue
            pre_states[wi] = w.preagg.update_many(pre_states[wi], keys, ts,
                                                  values)
        return pre_states


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
