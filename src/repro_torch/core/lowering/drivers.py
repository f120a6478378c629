"""Execution drivers — thin executors over the shared lowering.

OFFLINE (batch over whole tables).  One host-side plan (merge + sort +
§6.2 partition units per window GROUP, ``lower_group_offline``) feeds
the schedules:

* ``offline_fused``  — every window group, then the LAST JOINs and
                       scalar items, in one pass with no barrier (§6.1
                       window-parallel, the default);
* ``offline_serial`` — window groups one by one with a device barrier in
                       between;
* ``offline_branch`` — one window branch alone (ConcatJoin alignment);
* ``offline_reference_serial`` — the SEED algorithm (per-window merge +
                       sort + global segmented-scan / segment-tree fold,
                       ``core.window.fold_windows``) with a barrier
                       between windows, kept as the measured baseline.

The plan is host numpy, cached per table-set content on the script, and
its arrays are placed once on the chosen device (``GroupLowering.
device_args``).  Each unit block folds through ``windows.fold_units``:
the staged per-leaf build/query, or ONE ``kernels.unit_fold`` dispatch
under a fused ``fold_impl``; emitted rows are scattered back into
base-row order on the device, and features reach the host once, at the
end.  PyTorch runs eagerly, so where the reference jits one program per
plan signature, the port runs one pass over the groups.

ONLINE (request mode).  ``online_fn`` serves a (B,) request batch: per
raw-served window group one batched gather and one fold at the request
positions (``online_window_unit``: ``gather_unit`` + the staged
``fold_unit``, or ``gather_unit_fused`` + one ``kernels.unit_fold``
dispatch), per pre-aggregated window one batched ``PreAgg.fold_online``,
then the LAST JOIN lookups and the scalar tail (``discrete()`` through
the feature-hash kernel).  ``online_batch`` follows the script's fold
selector and takes pre-agg states; ``online_batch_fast`` always takes the
fused fold and serves every window raw; ``online`` is ``online_batch``
at B = 1.  Batches are padded to a power-of-two pad class, and a
per-(store, pad class) cache keeps each group's fold plan and its
identity vectors on the device.  Every request row's computation is
independent of the others', so a batch gives the bits of B single
requests.  Offline and online are two gathers over one fold: raw request
results equal ``offline()`` bit for bit (``core.consistency``).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...kernels.unit_fold import ops as unit_fold_ops
from ...storage import timestore
from ..window import (fold_windows, segment_starts, sorted_perm,
                      window_bounds)
from . import joins, scalars
from .windows import (GroupLowering, LoweredWindow, fold_impl, fold_unit,
                      fold_units, fused_prelift, gather_edges, gather_unit,
                      gather_unit_fused, group_leaf_set, group_windows,
                      lower_group_offline, unique_leaves)

__all__ = ["plan_offline", "offline_fused", "offline_serial",
           "offline_branch", "offline_reference_serial", "pad_batch",
           "batch_plan", "online_window_unit", "online_fn",
           "online_batch", "online_batch_fast", "online"]


# ===========================================================================
# OFFLINE
# ===========================================================================


def _np_arrays(tables) -> Dict[str, Dict[str, np.ndarray]]:
    return {name: {c: np.asarray(v)
                   for c, v in t.device_columns().items()}
            for name, t in tables.items()}


def _tables_sig(tables) -> Tuple:
    """Cache key for a table set: schema/length signature PLUS a content
    fingerprint — in-place column mutation or a recycled dict id must
    miss the plan cache, never serve stale features."""
    sig = []
    for name, t in sorted(tables.items()):
        h = hashlib.blake2b(digest_size=8)
        for c in sorted(t.schema.column_names):
            h.update(np.ascontiguousarray(t.columns[c]).tobytes())
        sig.append((name, len(t), tuple(sorted(t.schema.column_names)),
                    h.hexdigest()))
    return tuple(sig)


def plan_offline(cs, tables) -> Tuple[List[GroupLowering],
                                      Dict[str, Dict[str, np.ndarray]], int]:
    """Host-side offline plan: merged + sorted + §6.2-partitioned window
    inputs for every group.  Derived from the data and the compile
    context only — the same plan backs every schedule.

    Cached per table-set content fingerprint on the CompiledScript, one
    plan at a time: repeated offline calls over the same tables skip the
    re-plan and keep the plan's device buffers resident.
    """
    cache = cs._offline_plan_cache
    key = _tables_sig(tables)
    hit = cache.get(key)
    if hit is not None:
        return hit
    arrays = _np_arrays(tables)
    n_base = len(tables[cs.script.base_table])
    lws = [lower_group_offline(
        members, arrays, cs.script.base_table, n_base,
        target_rows=cs.ctx.offline_slice_rows,
        max_slices=cs.ctx.offline_max_slices)
        for members in group_windows(cs.windows)]
    cache.clear()          # keep at most one resident plan per script
    cache[key] = (lws, arrays, n_base)
    return lws, arrays, n_base


def _arrays_on(arrays, device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {t: {c: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for c, v in cols.items()}
            for t, cols in arrays.items()}


def _join_scalar_fn(cs):
    """LAST JOIN + scalar tail over whole tables on the device."""
    script, plan, join_cols = cs.script, cs.plan, cs.join_cols

    def fn(arrays_dev):
        env = dict(arrays_dev[script.base_table])
        for js in script.last_joins:
            env.update(joins.offline_last_join(arrays_dev, js, script,
                                               join_cols))
        return scalars.eval_scalar_items(plan, env)
    return fn


def _group_feats(members: List[LoweredWindow], dev, impl
                 ) -> List[Dict[str, torch.Tensor]]:
    """Finalized features per unit block of one group (leaf folds shared
    across member windows; under a fused impl the flat lane lifts are
    built once here and shared by every block)."""
    prelift = fused_prelift(members, dev) if impl is not None else None
    out = []
    for blk in dev["blocks"]:
        per_member = fold_units(members, dict(dev, **blk), impl=impl,
                                prelift=prelift)
        feats: Dict[str, torch.Tensor] = {}
        for m, folded in zip(members, per_member):
            for name, agg in zip(m.feature_names, m.aggs):
                feats[name] = agg.finalize(folded)
        out.append(feats)
    return out


def _scatter_group(dev, feats: List[Dict[str, torch.Tensor]], n_base: int,
                   out: Dict[str, torch.Tensor]):
    """ConcatJoin on the device: place emitted unit rows back in base-row
    order (each base row is emitted by exactly one unit)."""
    for blk, bf in zip(dev["blocks"], feats):
        for name, feat in bf.items():
            buf = out.get(name)
            if buf is None:
                buf = torch.zeros((n_base,) + tuple(feat.shape[2:]),
                                  dtype=feat.dtype, device=feat.device)
                out[name] = buf
            buf[blk["rows"]] = feat[blk["emit"]]


def _to_host(cs, out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return scalars.select_outputs(
        cs.script, {k: v.cpu().numpy() for k, v in out.items()})


def offline_fused(cs, tables, device) -> Dict[str, np.ndarray]:
    """Default offline schedule: all groups + joins + scalars, no
    barrier until the features are copied to the host."""
    lws, arrays, n_base = plan_offline(cs, tables)
    impl = fold_impl(cs.ctx)
    out: Dict[str, torch.Tensor] = {}
    for gl in lws:
        dev = gl.device_args(device)
        _scatter_group(dev, _group_feats(gl.members, dev, impl), n_base,
                       out)
    out.update(_join_scalar_fn(cs)(_arrays_on(arrays, device)))
    return _to_host(cs, out)


def offline_branch(cs, tables, wi: int, device) -> Dict[str, np.ndarray]:
    """One window branch alone (ConcatJoin alignment checks)."""
    lws, _, n_base = plan_offline(cs, tables)
    target = cs.windows[wi]
    gl = next(g for g in lws if target in g.members)
    dev = gl.device_args(device)
    out: Dict[str, torch.Tensor] = {}
    _scatter_group(dev, _group_feats(gl.members, dev, fold_impl(cs.ctx)),
                   n_base, out)
    return {name: out[name].cpu().numpy() for name in target.feature_names}


def offline_serial(cs, tables, device) -> Dict[str, np.ndarray]:
    """Serialized schedule: window groups one by one with a device
    barrier between them; the gap to ``offline_fused`` is scheduling
    only, the folds are the same."""
    lws, arrays, n_base = plan_offline(cs, tables)
    impl = fold_impl(cs.ctx)
    out: Dict[str, torch.Tensor] = {}
    for gl in lws:
        dev = gl.device_args(device)
        _scatter_group(dev, _group_feats(gl.members, dev, impl), n_base,
                       out)
        _sync(device)                               # hard barrier
    out.update(_join_scalar_fn(cs)(_arrays_on(arrays, device)))
    return _to_host(cs, out)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def offline_reference_serial(cs, tables, device) -> Dict[str, np.ndarray]:
    """The SEED offline path, kept as the measured baseline: per window,
    merge the sources, sort by (key, ts, rank, arrival), and fold every
    row with a global segmented scan / segment tree
    (``core.window.fold_windows``), with a device barrier between
    windows — no shared layout, no §6.2 units, every window re-sorts the
    whole input.  Integer features equal the unit engine's bitwise; its
    sums are differences of two float32 prefixes over a key's whole
    history, so they carry that history's rounding."""
    _, arrays, n_base = plan_offline(cs, tables)
    arrays_dev = _arrays_on(arrays, device)
    base = cs.script.base_table
    out: Dict[str, torch.Tensor] = {}
    for w in cs.windows:                   # one full pass PER WINDOW
        spec = w.node.spec
        need = set(w.needed_cols) | {spec.partition_by, spec.order_by}
        parts = []
        for rank, tname in enumerate(w.sources):
            cols = arrays_dev[tname]
            n_t = next(iter(cols.values())).shape[0]
            part = {c: cols[c] for c in need}
            part["__orig__"] = (
                torch.arange(n_t, dtype=torch.int32, device=device)
                if tname == base and rank == len(w.sources) - 1 else
                torch.full((n_t,), n_base, dtype=torch.int32,
                           device=device))
            parts.append(part)
        merged = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        key_col = merged[spec.partition_by].to(torch.int32)
        ts_col = merged[spec.order_by].to(torch.int32)
        # sources are concatenated in rank order, each in arrival order,
        # so one stable (key, ts) sort is the (key, ts, rank, arrival)
        # lexsort
        perm = sorted_perm(key_col, ts_col)
        env = {k: v[perm] for k, v in merged.items()}
        key_s, ts_s = key_col[perm], ts_col[perm]
        n = key_s.shape[0]
        seg_start = segment_starts(key_s)
        seg_flag = torch.arange(n, dtype=torch.int32,
                                device=key_s.device) == seg_start
        start, end = window_bounds(spec, key_s, ts_s, seg_start)
        feats = fold_windows(w.aggs, env, start, end, seg_start, seg_flag)
        orig = env["__orig__"].long()
        emit = orig < n_base
        for name, f in zip(w.feature_names, feats):
            buf = torch.zeros((n_base,) + tuple(f.shape[1:]), dtype=f.dtype,
                              device=f.device)
            buf[orig[emit]] = f[emit]
            out[name] = buf
        _sync(device)                        # hard barrier
    out.update(_join_scalar_fn(cs)(arrays_dev))
    return _to_host(cs, out)


# ===========================================================================
# ONLINE
# ===========================================================================


def pad_batch(keys, ts, values):
    """Pad a request batch to the next power of two by replicating the
    last request (per-request computations are independent, so padding
    never changes real rows' results, and shapes stay per pad class).
    Returns (keys, ts, values, b_real)."""
    keys = np.asarray(keys, np.int32)
    tsa = np.asarray(ts, np.int32)
    b = keys.shape[0]
    if b == 0:
        raise ValueError("empty request batch")
    b_pad = timestore.next_pow2(b)
    vals = {k: np.asarray(v, np.float32) for k, v in values.items()}
    if b_pad > b:
        pad = [(0, b_pad - b)]
        keys = np.pad(keys, pad, mode="edge")
        tsa = np.pad(tsa, pad, mode="edge")
        vals = {k: np.pad(v, pad, mode="edge") for k, v in vals.items()}
    return keys, tsa, vals, b


def batch_plan(cs, store, b_pad: int, impl, use_pre: bool = False
               ) -> List[Dict[str, Any]]:
    """Per-(store, pad class, fold impl, pre-agg mode) cache of what every
    batch of that class reuses: the raw-served window groups (all of
    them, or those without a pre-agg plane when ``use_pre``), each with
    its members and, under a fused impl, its fold plan and the plan's
    identity vectors resident on the store's device (``plan_for``).
    Bounded by the number of pad classes, logarithmic in the largest
    batch."""
    key = (id(store), store.capacity, str(store.device), b_pad, impl,
           use_pre)
    groups = cs._online_fns.get(key)
    if groups is None:
        raw = [w for w in cs.windows if not (use_pre and w.preagg)]
        groups = []
        for members in group_windows(raw):
            g = {"members": members}
            if impl is not None:
                g["plan"], g["idents"] = unit_fold_ops.plan_for(
                    [m.node.spec for m in members], group_leaf_set(members),
                    members[0].node.spec.order_by,
                    [tuple(unique_leaves(m.aggs)) for m in members],
                    device=store.device)
            groups.append(g)
        cs._online_fns[key] = groups
    return groups


def online_window_unit(states, group: Dict[str, Any], keys: torch.Tensor,
                       ts: torch.Tensor, values: Dict[str, torch.Tensor],
                       impl=None) -> List[Dict[str, torch.Tensor]]:
    """Serve one window GROUP (a ``batch_plan`` entry) for (B,) requests
    through the unit core: gather each request key's history into the
    offline unit layout and fold it at the request position — staged
    (``gather_unit`` + ``fold_unit``) when ``impl`` is None, else the
    scatter-merge gather and one ``kernels.unit_fold`` dispatch.  There
    is no online-only fold algebra.  Returns one ``{leaf key: (B, *S)}``
    dict per member."""
    members = group["members"]
    if impl is None:
        env, p = gather_unit(states, members, keys, ts, values)
        folded = fold_unit(members, env, queries=p[:, None])
    else:
        env, p = gather_unit_fused(states, members, keys, ts, values)
        folded = unit_fold_ops.fold_env(group["plan"], group["idents"], env,
                                        p[:, None], use_kernel=impl[1])
    return [{k: f[k][:, 0] for k in unique_leaves(m.aggs)}
            for m, f in zip(members, folded)]


def online_fn(cs, states, keys: torch.Tensor, ts: torch.Tensor,
              values: Dict[str, torch.Tensor],
              groups: List[Dict[str, Any]], impl=None,
              preagg_states=None) -> Dict[str, torch.Tensor]:
    """The request trace every online driver shares: a whole (B,) batch —
    one ``PreAgg.fold_online`` per pre-aggregated window (when
    ``preagg_states`` is given), one gather and one fold per raw-served
    window group (``groups`` from ``batch_plan``), then LAST JOINs and
    scalar items."""
    out: Dict[str, torch.Tensor] = {}
    if preagg_states is not None:
        for wi, w in enumerate(cs.windows):
            if w.preagg is None:
                continue
            folded = w.preagg.fold_online(states, w, keys, ts, values,
                                          preagg_states[wi],
                                          gather=gather_edges)
            for name, agg in zip(w.feature_names, w.aggs):
                out[name] = agg.finalize(folded)
    for g in groups:
        per_member = online_window_unit(states, g, keys, ts, values,
                                        impl=impl)
        for m, folded in zip(g["members"], per_member):
            for name, agg in zip(m.feature_names, m.aggs):
                out[name] = agg.finalize(folded)

    env = dict(values)
    env[cs.script.order_column] = ts
    for js in cs.script.last_joins:
        env.update(joins.online_last_join(states, js, cs.join_cols, env,
                                          keys, ts))
    out.update(scalars.eval_scalar_items(cs.plan, env))
    return scalars.select_outputs(cs.script, out)


def _serve(cs, store, keys, ts, values, impl, preagg_states=None):
    """Pad the batch, run ``online_fn`` on the store's device, and return
    host arrays of the real rows (plus the padded timestamps)."""
    keys, tsa, vals_np, b = pad_batch(keys, ts, values)
    dev = store.device
    use_pre = preagg_states is not None
    groups = batch_plan(cs, store, keys.shape[0], impl, use_pre)
    vals = {k: torch.from_numpy(v).to(dev) for k, v in vals_np.items()}
    out = online_fn(cs, store.tables, torch.from_numpy(keys).to(dev),
                    torch.from_numpy(tsa).to(dev), vals, groups, impl=impl,
                    preagg_states=preagg_states)
    if use_pre:
        cs._observe_queries(tsa[:b].tolist())
    return {k: v[:b].cpu().numpy() for k, v in out.items()}


def online_batch(cs, store, keys, ts, values, preagg_states=None
                 ) -> Dict[str, np.ndarray]:
    """Features for B requests in one batched call, through the script's
    fold selector (staged or fused raw groups) plus the pre-aggregated
    windows when ``preagg_states`` is given; bitwise equal to B single
    ``online`` calls."""
    return _serve(cs, store, keys, ts, values, fold_impl(cs.ctx),
                  preagg_states)


def online_batch_fast(cs, store, keys, ts, values) -> Dict[str, np.ndarray]:
    """Features for B requests through the fused path (one
    ``kernels.unit_fold`` dispatch per window group, every window served
    raw), on the store's device (the kernels on a CUDA store, the plain
    versions on a CPU store); returns host arrays of the real rows."""
    return _serve(cs, store, keys, ts, values,
                  (True, cs.ctx.unit_fold_kernel))


def online(cs, store, key: int, ts: int, values: Dict[str, float],
           preagg_states=None) -> Dict[str, np.ndarray]:
    """Features for one request tuple (virtually inserted): the request
    trace at B = 1."""
    out = online_batch(cs, store, [key], [ts],
                       {c: [v] for c, v in values.items()},
                       preagg_states=preagg_states)
    return {k: v[0] for k, v in out.items()}
