"""Public entry for the fused unit-fold op.

``unit_fold(specs, leaves, env, queries)`` folds one window group over a
batched (U, R) block of padded units — every member window, every
deduplicated leaf — in one dispatch: the CUDA kernel for tensors on the
card, the plain PyTorch version for tensors on the CPU
(``kernels.dispatch``).  Rows are padded to a power of two with identity
values and INT_MAX timestamps, which changes no real query's fold.

``UnitFoldPlan`` construction (leaf stacking + per-lane identity
vectors) is cached in ``core.lowering.cache`` per static group signature
and device, so repeated folds of one script (every request batch, every
pad class) reuse one plan and its identity vectors resident on the
device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import dispatch
from . import ref as _ref
from .kernel import unit_fold_cuda

__all__ = ["unit_fold", "plan_for", "fold_env", "pad_rows"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _leaf_sig(key: str, leaf) -> Tuple:
    # the key embeds the argument expression fingerprint (and HLL p), so
    # (key, type, shape, decay) pins the leaf's lift/combine semantics
    return (key, type(leaf).__name__, tuple(leaf.shape),
            float(getattr(leaf, "decay", 0.0) or 0.0))


def plan_for(specs: Sequence[Any], leaves: Dict[str, Any], order_by: str,
             member_keys: Optional[Sequence[Sequence[str]]] = None,
             device: torch.device = torch.device("cpu")
             ) -> Tuple[_ref.UnitFoldPlan, Tuple[torch.Tensor, ...]]:
    """Cached ``(UnitFoldPlan, per-group identity vectors on device)``
    for one window group."""
    from ...core.lowering.cache import cached

    mk = (None if member_keys is None
          else tuple(tuple(ks) for ks in member_keys))
    if mk is not None and len(mk) != len(specs):
        raise ValueError(f"member_keys covers {len(mk)} members, plan has "
                         f"{len(specs)}")
    key = ("unit_fold_plan", order_by, str(device),
           tuple(s.canonical() for s in specs),
           tuple(_leaf_sig(k, l) for k, l in leaves.items()), mk)

    def build():
        plan = _ref.build_plan(specs, leaves, order_by, member_keys=mk)
        ident = tuple(_ref.group_identity(g).to(device).contiguous()
                      for g in plan.groups)
        return plan, ident

    return cached(key, build)


def _unstack_batched(plan: _ref.UnitFoldPlan,
                     folded_groups: Sequence[torch.Tensor]
                     ) -> List[Dict[str, torch.Tensor]]:
    """Scatter per-group (U, Mg, Q, F) fold blocks into per-member
    ``{leaf key: (U, Q, *S)}`` dicts (rows in ``members_ix`` order)."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in plan.specs]
    for grp, folded in zip(plan.groups, folded_groups):
        for row, mi in enumerate(grp.members_ix):
            fm = folded[:, row]                # (U, Q, F)
            off = 0
            for key, leaf, size in zip(grp.keys, grp.leaves, grp.sizes):
                out[mi][key] = fm[..., off:off + size].reshape(
                    tuple(fm.shape[:2]) + tuple(leaf.shape))
                off += size
    return out


def pad_rows(ident_list: Sequence[torch.Tensor],
             data_list: Sequence[torch.Tensor], ts: torch.Tensor
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pad (U, R, F) lane blocks and the (U, R) order column to a
    power-of-two row count with identity rows and INT_MAX timestamps —
    the layout both fold versions take; no real query's fold changes."""
    u, r = ts.shape
    rp = max(2, _next_pow2(r))
    if rp > r:
        data_list = [torch.cat([d, torch.broadcast_to(
            iv, (u, rp - r, d.shape[-1]))], dim=1)
            for d, iv in zip(data_list, ident_list)]
        ts = torch.cat([ts, torch.full((u, rp - r), _ref.INT_MAX,
                                       dtype=torch.int32,
                                       device=ts.device)], dim=1)
    return ([d.contiguous() for d in data_list],
            ts.to(torch.int32).contiguous())


def fold_env(plan: _ref.UnitFoldPlan, ident_list: Sequence[torch.Tensor],
             env: Dict[str, Any], queries: torch.Tensor,
             use_kernel: Optional[bool] = None
             ) -> List[Dict[str, torch.Tensor]]:
    """Fold a (U, R) unit env with a ready plan (``plan_for``): lift each
    leaf group, pad rows, run the kernel (CUDA tensors) or the plain
    version (CPU tensors), and split the groups back into per-member
    ``{leaf key: (U, Q, *S)}`` dicts."""
    ts = env[plan.order_by]
    u, r = ts.shape
    data_list, ts = pad_rows(
        ident_list, [_ref.lift_group(g, env, (u, r)) for g in plan.groups],
        ts)
    queries = queries.to(torch.int32).contiguous()
    fold = (unit_fold_cuda if dispatch.resolve(use_kernel, ts)
            else _ref.unit_fold_plain)
    return _unstack_batched(
        plan, fold(plan, data_list, ident_list, ts, queries, r))


def unit_fold(specs: Sequence[Any], leaves: Dict[str, Any],
              env: Dict[str, Any], queries: Optional[torch.Tensor] = None,
              *, order_by: str,
              member_keys: Optional[Sequence[Sequence[str]]] = None,
              use_kernel: Optional[bool] = None
              ) -> List[Dict[str, torch.Tensor]]:
    """Fused fold of one window group over a (U, R) block of units.

    ``specs`` are the member WindowSpecs, ``leaves`` the group's
    deduplicated ``{key: Leaf}`` set, ``env`` the padded (U, R) unit
    columns (incl. ``order_by`` and ``__valid__``), ``queries`` the (U,
    Q) unit positions to emit (default: every row).  Returns one
    ``{leaf key: (U, Q, *S)}`` dict per member; with ``member_keys``
    each member's dict covers (at least) its own leaf usage.
    """
    ts = env[order_by]
    if ts.dim() != 2:
        raise ValueError(f"unit_fold takes a batched (U, R) block, got "
                         f"{order_by} of shape {tuple(ts.shape)}")
    u, r = ts.shape
    plan, ident_list = plan_for(specs, leaves, order_by, member_keys,
                                device=ts.device)
    if queries is None:
        queries = torch.arange(r, dtype=torch.int32,
                               device=ts.device).expand(u, r)
    return fold_env(plan, ident_list, env, queries, use_kernel=use_kernel)
