"""Execution drivers — thin executors over the shared lowering.

OFFLINE (batch over whole tables).  One host-side plan (merge + sort +
§6.2 partition units per window GROUP, ``lower_group_offline``) feeds
the schedules:

* ``offline_fused``  — every window group, then the LAST JOINs and
                       scalar items, in one pass with no barrier (§6.1
                       window-parallel, the default);
* ``offline_serial`` — window groups one by one with a device barrier in
                       between;
* ``offline_branch`` — one window branch alone (ConcatJoin alignment).

The plan is host numpy, cached per table-set content on the script, and
its arrays are placed once on the chosen device (``GroupLowering.
device_args``).  Each unit block folds through ONE ``kernels.unit_fold``
dispatch at every row; emitted rows are scattered back into base-row
order on the device, and features reach the host once, at the end.
PyTorch runs eagerly, so where the reference jits one program per plan
signature, the port runs one pass over the groups.

ONLINE (request mode).  ``online_fn`` serves a (B,) request batch: per
window group one batched scatter-merge gather (``gather_unit_fused``) and
ONE ``kernels.unit_fold`` dispatch at the request positions
(``online_window_unit``), then the LAST JOIN lookups and the scalar tail
(``discrete()`` through the feature-hash kernel).  ``online_batch_fast``
pads the batch to a power-of-two pad class and keeps a per-(store, pad
class) cache of each group's fold plan and its identity vectors on the
device; ``online`` is the same trace at B = 1.  Offline and online are
two gathers over one fold: raw request results equal ``offline()`` bit
for bit (``core.consistency``).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...kernels.unit_fold import ops as unit_fold_ops
from ...storage import timestore
from . import joins, scalars
from .windows import (GroupLowering, LoweredWindow, fold_impl, fold_units,
                      fused_prelift, gather_unit_fused, group_leaf_set,
                      group_windows, lower_group_offline, unique_leaves)

__all__ = ["plan_offline", "offline_fused", "offline_serial",
           "offline_branch", "offline_reference_serial", "pad_batch",
           "batch_plan", "online_window_unit", "online_fn",
           "online_batch_fast", "online"]


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
    across member windows; the flat lane lifts are built once here and
    shared by every block)."""
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
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)          # hard barrier
    out.update(_join_scalar_fn(cs)(_arrays_on(arrays, device)))
    return _to_host(cs, out)


def offline_reference_serial(cs, tables, device=None):
    """The reference's seed-algorithm baseline (per-branch lexsort +
    global folds) needs the staged window primitives, which are not
    ported yet."""
    raise NotImplementedError(
        "offline_reference_serial (the seed-algorithm offline baseline) "
        "needs the staged fold primitives and is not ported to "
        "repro_torch yet")


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


def batch_plan(cs, store, b_pad: int) -> List[Dict[str, Any]]:
    """Per-(store, pad class) cache of what every batch of that class
    reuses: per window group its members, its fold plan and the plan's
    identity vectors resident on the store's device (``plan_for``).
    Bounded by the number of pad classes, logarithmic in the largest
    batch."""
    key = (id(store), store.capacity, str(store.device), b_pad)
    groups = cs._online_fns.get(key)
    if groups is None:
        groups = []
        for members in group_windows(cs.windows):
            plan, idents = unit_fold_ops.plan_for(
                [m.node.spec for m in members], group_leaf_set(members),
                members[0].node.spec.order_by,
                [tuple(unique_leaves(m.aggs)) for m in members],
                device=store.device)
            groups.append({"members": members, "plan": plan,
                           "idents": idents})
        cs._online_fns[key] = groups
    return groups


def online_window_unit(states, group: Dict[str, Any], keys: torch.Tensor,
                       ts: torch.Tensor, values: Dict[str, torch.Tensor],
                       use_kernel=None) -> List[Dict[str, torch.Tensor]]:
    """Serve one window GROUP (a ``batch_plan`` entry) for (B,) requests
    through the unit core: gather each request key's history into the
    offline unit layout and fold it at the request position.  There is
    no online-only fold algebra.  Returns one ``{leaf key: (B, *S)}``
    dict per member."""
    members = group["members"]
    env, p = gather_unit_fused(states, members, keys, ts, values)
    fused = unit_fold_ops.fold_env(group["plan"], group["idents"], env,
                                   p[:, None], use_kernel=use_kernel)
    return [{k: f[k][:, 0] for k in unique_leaves(m.aggs)}
            for m, f in zip(members, fused)]


def online_fn(cs, states, keys: torch.Tensor, ts: torch.Tensor,
              values: Dict[str, torch.Tensor],
              groups: List[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """The request trace every online driver shares: a whole (B,) batch
    with ONE ``kernels.unit_fold`` dispatch per window group (``groups``
    from ``batch_plan``), then LAST JOINs and scalar items."""
    use_kernel = fold_impl(cs.ctx)[1]
    out: Dict[str, torch.Tensor] = {}
    for g in groups:
        per_member = online_window_unit(states, g, keys, ts, values,
                                        use_kernel=use_kernel)
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


def online_batch_fast(cs, store, keys, ts, values) -> Dict[str, np.ndarray]:
    """Features for B requests through the fused path, on the store's
    device (the kernels on a CUDA store, the plain versions on a CPU
    store); returns host arrays of the real rows."""
    keys, tsa, vals_np, b = pad_batch(keys, ts, values)
    dev = store.device
    groups = batch_plan(cs, store, keys.shape[0])
    vals = {k: torch.from_numpy(v).to(dev) for k, v in vals_np.items()}
    out = online_fn(cs, store.tables, torch.from_numpy(keys).to(dev),
                    torch.from_numpy(tsa).to(dev), vals, groups)
    return {k: v[:b].cpu().numpy() for k, v in out.items()}


def online(cs, store, key: int, ts: int, values: Dict[str, float]
           ) -> Dict[str, np.ndarray]:
    """Features for one request tuple (virtually inserted): the request
    trace at B = 1."""
    out = online_batch_fast(cs, store, [key], [ts],
                            {c: [v] for c, v in values.items()})
    return {k: v[0] for k, v in out.items()}
