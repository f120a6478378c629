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
* ``offline_sharded`` — every group's partition units LPT-assigned to
                       shards and re-blocked into (S, U_pad, R) stacks
                       with all-invalid padding units, each stack folded
                       as one (S·U_pad, R) block: the units and their
                       folds are ``offline_fused``'s, so the result is
                       bitwise equal for any shard count, with one fold
                       launch per block class as there (on a device
                       mesh, shard s's slice of each class folds on its
                       device);
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
at B = 1; ``online_sharded_batch`` serves a ``ShardedOnlineStore``:
requests are routed on the host into (S, b_pad) shard blocks and the
same trace runs once over the shard-major (S·b_pad,) batch, whose seeks
run batched over the stacked (S, capacity) tables
(``timestore.range_bounds``), so a sharded batch launches the fold and
hash kernels as often as an unsharded one (a mesh store runs the trace
once per shard with requests, on the shard's device).  Batches are
padded to a
power-of-two pad class, and a
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
from .. import skew
from ..window import (fold_windows, segment_starts, sorted_perm,
                      window_bounds)
from . import joins, scalars
from .windows import (GroupLowering, LoweredWindow, fold_impl, fold_unit,
                      fold_units, fused_prelift, gather_edges, gather_unit,
                      gather_unit_fused, group_leaf_set, group_windows,
                      lower_group_offline, unique_leaves)

__all__ = ["plan_offline", "offline_fused", "offline_serial",
           "offline_branch", "offline_sharded", "offline_reference_serial",
           "pad_batch", "batch_plan", "online_window_unit", "online_fn",
           "online_batch", "online_batch_fast", "online_sharded_batch",
           "online"]


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


def _group_feats(members: List[LoweredWindow], dev, impl, prelift=None
                 ) -> List[Dict[str, torch.Tensor]]:
    """Finalized features per unit block of one group (leaf folds shared
    across member windows; under a fused impl the flat lane lifts are
    built once — here unless the caller passes them — and shared by
    every block)."""
    if impl is not None and prelift is None:
        prelift = fused_prelift(members, dev)
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
                   out: Dict[str, torch.Tensor], home=None):
    """ConcatJoin on the device: place emitted unit rows back in base-row
    order (each base row is emitted by exactly one unit).  The output
    lives on ``home`` (default: the features' device); a mesh shard's
    rows are copied there."""
    for blk, bf in zip(dev["blocks"], feats):
        for name, feat in bf.items():
            buf = out.get(name)
            if buf is None:
                buf = torch.zeros((n_base,) + tuple(feat.shape[2:]),
                                  dtype=feat.dtype,
                                  device=feat.device if home is None
                                  else home)
                out[name] = buf
            buf[blk["rows"].to(buf.device)] = feat[blk["emit"]].to(
                buf.device)


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


def _stack_window(gl: GroupLowering, n_shards: int
                  ) -> List[Dict[str, np.ndarray]]:
    """LPT-assign one group's units to shards and re-block every unit
    class into per-shard stacks (S, U_pad, R), flattened to (S·U_pad, R):
    padding units index the sentinel pad row and are all-invalid, so
    they emit nothing."""
    n_units = sum(b.unit_ids.size for b in gl.blocks)
    sizes = np.zeros(max(1, n_units), np.int64)
    for b in gl.blocks:
        sizes[b.unit_ids] = b.sizes
    owner = skew.assign_units_lpt(sizes, n_shards)
    n_flat = gl.ts.shape[0] - 1
    stacked = []
    for b in gl.blocks:
        b_owner = owner[b.unit_ids] if b.unit_ids.size else \
            np.zeros((0,), np.int32)
        u, r = b.idx.shape
        counts = np.bincount(b_owner, minlength=n_shards)
        u_pad = max(1, int(counts.max()))
        idx = np.full((n_shards, u_pad, r), n_flat, b.idx.dtype)
        valid = np.zeros((n_shards, u_pad, r), bool)
        emit = np.zeros((n_shards, u_pad, r), bool)
        for s in range(n_shards):
            sel = np.flatnonzero(b_owner == s)
            idx[s, :sel.size] = b.idx[sel]
            valid[s, :sel.size] = b.valid[sel]
            emit[s, :sel.size] = b.emit[sel]
        stacked.append({"idx": idx.reshape(-1, r),
                        "valid": valid.reshape(-1, r),
                        "emit": emit.reshape(-1, r)})
    return stacked


def _sharded_device_args(gl: GroupLowering, n_shards: int, device
                         ) -> Dict[str, Any]:
    """``device_args`` with the shard-stacked blocks, cached on the
    lowering per (device, shard count)."""
    key = f"{torch.device(device)}/shards={n_shards}"
    hit = gl._dev.get(key)
    if hit is None:
        base = gl.device_args(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        hit = dict(base, blocks=[
            {"idx": put(b["idx"]), "valid": put(b["valid"]),
             "emit": put(b["emit"]),
             "rows": put(gl.orig[b["idx"]][b["emit"]].astype(np.int64))}
            for b in _stack_window(gl, n_shards)])
        gl._dev[key] = hit
    return hit


def _mesh_key(mesh, axis: str) -> str:
    """Stable mesh identity for the placement caches: its devices, axes
    and the shard axis (two same-size meshes over different devices
    never share placements; ``id(mesh)`` can alias after gc)."""
    return (f"mesh={[str(d) for d in mesh.devices.flat]}/"
            f"{mesh.axis_names}/{axis}")


def _mesh_device_args(gl: GroupLowering, devices, key: str
                      ) -> List[Dict[str, Any]]:
    """Per mesh shard s, ``device_args`` on ``devices[s]`` with shard s's
    (U_pad, R) slice of every stacked unit class; a class in which the
    shard emits no row is left out (it would fold padding only).  Cached
    on the lowering per mesh."""
    hit = gl._dev.get(key)
    if hit is None:
        n = len(devices)
        stacked = _stack_window(gl, n)
        hit = []
        for s, d in enumerate(devices):
            def put(a, d=d):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)

            blocks = []
            for b in stacked:
                u = b["idx"].shape[0] // n
                part = {k: v[s * u:(s + 1) * u] for k, v in b.items()}
                if not part["emit"].any():
                    continue
                blocks.append(dict(
                    {k: put(v) for k, v in part.items()},
                    rows=put(gl.orig[part["idx"]][part["emit"]].astype(
                        np.int64))))
            hit.append(dict(gl.device_args(d), blocks=blocks))
        gl._dev[key] = hit
    return hit


def offline_sharded(cs, tables, device, n_shards: int, mesh=None,
                    axis: str = "shard") -> Dict[str, np.ndarray]:
    """Key-partitioned offline execution (§6).  Every group's partition
    units (whole cold keys; hot keys time-sliced with halo rows —
    ``core.skew``) are LPT-assigned to ``n_shards`` shards.  Stacked on
    ``device`` (``mesh`` None), each unit class folds as one (S·U_pad, R)
    block; on a ``mesh`` (the shards of its axis ``axis``; ``device`` is
    then its first shard's) shard s's (U_pad, R) blocks fold on its
    device, and the emitted rows are copied to the first shard's device.
    Either way every unit folds with the same per-unit program
    ``offline_fused`` runs, so the features are bitwise equal for every
    shard count and placement.  LAST JOINs and scalar items are
    per-base-row lookups with no window state; they run once, on
    ``device``."""
    lws, arrays, n_base = plan_offline(cs, tables)
    impl = fold_impl(cs.ctx)
    out: Dict[str, torch.Tensor] = {}
    if mesh is None:
        for gl in lws:
            dev = _sharded_device_args(gl, max(1, int(n_shards)), device)
            _scatter_group(dev, _group_feats(gl.members, dev, impl), n_base,
                           out)
    else:
        from ...distributed.sharding import stacked_store_sharding

        devices = stacked_store_sharding(mesh, axis)
        device = devices[0]
        key = _mesh_key(mesh, axis)
        for gl in lws:
            prelift: Dict[str, Any] = {}     # one per distinct device
            for dev in _mesh_device_args(gl, devices, key):
                d = str(dev["ts"].device)
                if impl is not None and d not in prelift:
                    prelift[d] = fused_prelift(gl.members, dev)
                _scatter_group(dev, _group_feats(gl.members, dev, impl,
                                                 prelift.get(d)),
                               n_base, out, home=device)
    out.update(_join_scalar_fn(cs)(_arrays_on(arrays, device)))
    return _to_host(cs, out)


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


def batch_plan(cs, store, b_pad: int, impl, use_pre: bool = False,
               device=None) -> List[Dict[str, Any]]:
    """Per-(store, pad class, fold impl, pre-agg mode) cache of what every
    batch of that class reuses: the raw-served window groups (all of
    them, or those without a pre-agg plane when ``use_pre``), each with
    its members and, under a fused impl, its fold plan and the plan's
    identity vectors resident on ``device`` (the store's unless a mesh
    shard's is given; ``plan_for``).  Bounded by the number of pad
    classes (times the mesh's distinct devices), logarithmic in the
    largest batch."""
    device = store.device if device is None else device
    key = (id(store), store.capacity, str(device), b_pad, impl, use_pre)
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
                    device=device)
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


def _route(owner: np.ndarray, n_shards: int):
    """(S, b_pad) request blocks from each request's owner shard: the
    per-shard sub-batch is padded to a power of two while small, then to
    a multiple of 32 (near-balanced routing would waste up to 2x under
    pure pow2 padding).  Returns ``(req_idx, pick)``: which request each
    block slot computes — padding repeats the shard's last request, an
    empty shard computes request 0; both are discarded — and where each
    request's result lies in the flattened (S·b_pad,) batch."""
    counts = np.bincount(owner, minlength=n_shards)
    c_max = int(max(1, counts.max()))
    b_pad = (timestore.next_pow2(c_max) if c_max <= 32
             else ((c_max + 31) // 32) * 32)
    b = owner.shape[0]
    order = np.argsort(owner, kind="stable")
    slot = np.empty(b, np.int64)
    slot[order] = np.arange(b) - (np.cumsum(counts) - counts)[owner[order]]
    req_idx = np.zeros((n_shards, b_pad), np.int64)
    req_idx[owner, slot] = np.arange(b)
    last = req_idx[np.arange(n_shards), np.maximum(counts - 1, 0)]
    req_idx = np.where(np.arange(b_pad) < counts[:, None], req_idx,
                       last[:, None])
    return req_idx.reshape(-1), owner * b_pad + slot


def online_sharded_batch(cs, store, keys, ts, values, preagg_states=None
                         ) -> Dict[str, np.ndarray]:
    """Features for B requests against a ``ShardedOnlineStore`` (or its
    snapshot): host key-routing into (S, b_pad) shard blocks, ONE run of
    the request trace over the shard-major (S·b_pad,) batch — every seek
    reads its own shard of the stacked tables, every pre-agg query its
    owner shard's planes — and reassembly in request order.  Window
    folds never gather across shards, so the features are bitwise those
    of the unsharded path, and each window group folds in one launch as
    there.  On a mesh store block s runs shard s's trace on its device
    (a shard without a request runs nothing), and the host reassembles
    the blocks in request order."""
    ok, why = cs.sharded_eligible()
    if not ok:
        raise ValueError(f"script not shardable by key: {why}")
    keys = np.asarray(keys, np.int32)
    tsa = np.asarray(ts, np.int32)
    if keys.shape[0] == 0:
        raise ValueError("empty request batch")
    use_pre = preagg_states is not None
    if use_pre:
        # the sharded pre-agg update's bounded-universe contract: a key
        # >= n_keys would read another shard's alias plane
        nks = [w.preagg.n_keys for w in cs.windows if w.preagg is not None]
        if nks and (int(keys.max()) >= min(nks) or int(keys.min()) < 0):
            raise ValueError(
                f"request key outside the pre-agg key universe "
                f"[0, {min(nks)}) — not servable bit-exactly from "
                f"key-sharded bucket planes")
    owner = store.owner_of_keys(keys)
    flat, pick = _route(owner, store.n_shards)
    impl = fold_impl(cs.ctx)
    vals_np = {k: np.asarray(v, np.float32)[flat] for k, v in values.items()}
    if store.mesh is not None:
        out = _serve_mesh(cs, store, keys[flat], tsa[flat], vals_np,
                          np.bincount(owner, minlength=store.n_shards),
                          flat, impl, preagg_states)
    else:
        dev = store.device
        groups = batch_plan(cs, store, flat.shape[0], impl, use_pre)
        vals = {k: torch.from_numpy(v).to(dev) for k, v in vals_np.items()}
        res = online_fn(cs, store.tables,
                        torch.from_numpy(keys[flat]).to(dev),
                        torch.from_numpy(tsa[flat]).to(dev), vals, groups,
                        impl=impl, preagg_states=preagg_states)
        pick_t = torch.from_numpy(pick).to(dev)
        out = {k: v[pick_t].cpu().numpy() for k, v in res.items()}
    if use_pre:
        cs._observe_queries(tsa.tolist())
    return out


def _serve_mesh(cs, store, keys: np.ndarray, ts: np.ndarray,
                values: Dict[str, np.ndarray], counts: np.ndarray,
                flat: np.ndarray, impl, preagg_states
                ) -> Dict[str, np.ndarray]:
    """The routed (S·b_pad,) batch over a mesh store: shard s's block
    runs the request trace on the shard's device against its one-shard
    tables and planes (every shard's work is launched before any result
    is read, so distinct cards overlap); the real rows of every block
    go back to their requests' places on the host."""
    b_pad = flat.shape[0] // store.n_shards
    use_pre = preagg_states is not None
    launched = []
    for s in np.flatnonzero(counts):
        dev = store.devices[s]
        blk = slice(s * b_pad, (s + 1) * b_pad)

        def put(a, dev=dev):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        res = online_fn(
            cs, {t: st[s] for t, st in store.tables.items()}, put(keys[blk]),
            put(ts[blk]), {c: put(v[blk]) for c, v in values.items()},
            batch_plan(cs, store, b_pad, impl, use_pre, device=dev),
            impl=impl, preagg_states=None if not use_pre else
            {wi: p[s] for wi, p in preagg_states.items()})
        launched.append((s, res))
    out: Dict[str, np.ndarray] = {}
    for s, res in launched:
        rows = flat[s * b_pad:s * b_pad + counts[s]]
        for k, v in res.items():
            v = v[:counts[s]].cpu().numpy()
            if k not in out:
                out[k] = np.empty((int(counts.sum()),) + v.shape[1:],
                                  v.dtype)
            out[k][rows] = v
    return out


def online(cs, store, key: int, ts: int, values: Dict[str, float],
           preagg_states=None) -> Dict[str, np.ndarray]:
    """Features for one request tuple (virtually inserted): the request
    trace at B = 1."""
    out = online_batch(cs, store, [key], [ts],
                       {c: [v] for c, v in values.items()},
                       preagg_states=preagg_states)
    return {k: v[0] for k, v in out.items()}
