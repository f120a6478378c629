"""The fused request driver — serve a batch of feature requests.

``online_batch_fast`` pads the batch to a power-of-two pad class
(``pad_batch``), moves it to the store's device, and runs
``online_fast_fn``: per window group one batched scatter-merge gather
(``windows.gather_unit_fused``) and ONE ``kernels.unit_fold`` dispatch
for the whole batch — every member window, every deduplicated leaf —
then the LAST JOIN lookups and the scalar tail (``discrete()`` through
the feature-hash kernel).  PyTorch runs eagerly, so where the reference
jits one executable per pad class, the port keeps a per-(store, pad
class) cache of each window group's fold plan and its identity vectors
on the device.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ...kernels.unit_fold import ops as unit_fold_ops
from ...storage import timestore
from . import joins, scalars
from .windows import gather_unit_fused, group_leaf_set, group_windows, \
    unique_leaves

__all__ = ["pad_batch", "online_fast_fn", "online_batch_fast",
           "batch_plan"]


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


def online_fast_fn(cs, states, keys: torch.Tensor, ts: torch.Tensor,
                   values: Dict[str, torch.Tensor],
                   groups: List[Dict[str, Any]]
                   ) -> Dict[str, torch.Tensor]:
    """Serve a whole (B,) request batch with ONE ``kernels.unit_fold``
    dispatch per window group (``groups`` from ``batch_plan``)."""
    out: Dict[str, torch.Tensor] = {}
    for g in groups:
        env, p = gather_unit_fused(states, g["members"], keys, ts, values)
        fused = unit_fold_ops.fold_env(g["plan"], g["idents"], env,
                                       p[:, None])
        for m, f in zip(g["members"], fused):
            folded = {k: f[k][:, 0] for k in unique_leaves(m.aggs)}
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
    out = online_fast_fn(cs, store.tables, torch.from_numpy(keys).to(dev),
                         torch.from_numpy(tsa).to(dev), vals, groups)
    return {k: v[:b].cpu().numpy() for k, v in out.items()}
