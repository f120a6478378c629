"""Public entry for the fused unit-fold op.

``unit_fold(specs, leaves, env, queries)`` folds one window group over a
batched (U, R) block of padded units — every member window, every
deduplicated leaf — in one dispatch: the CUDA kernel for tensors on the
card, the plain PyTorch version for tensors on the CPU
(``kernels.dispatch``).  The plain version takes rows padded to a power
of two with identity values and INT_MAX timestamps (``pad_rows``), which
changes no real query's fold; the kernel reads the rows unpadded and
makes those rows itself.

``UnitFoldPlan`` construction (leaf stacking + per-lane identity
vectors) is cached in ``core.lowering.cache`` per static group signature
and device, so repeated folds of one script (every request batch, every
pad class) reuse one plan and its identity vectors resident on the
device.

The offline engine's entry is ``unit_fold_blocks``: the group's flat
(key, ts, rank, arrival)-sorted rows are lifted once (``prelift_blocks``)
and every §6.2 unit block gathers its (U, R) lane block from them through
its flat-row index, then folds every row of every unit (Q = R).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import dispatch
from . import ref as _ref
from .kernel import unit_fold_cuda

__all__ = ["unit_fold", "plan_for", "fold_env", "pad_rows",
           "prelift_blocks", "unit_fold_blocks", "cost"]

# combine operations per lane of each family (the bound's operation count)
_FAMILY_OPS = {"add": 1, "min": 1, "max": 1, "drawdown": 6, "ew": 8}


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


def cost(plan: _ref.UnitFoldPlan, u: int, rows: int,
         nq: int) -> dispatch.KernelCost:
    """Least work of one fold of ``u`` units of ``rows`` rows at ``nq``
    queries a unit: the order column, the queries and each group's lanes
    read once, the folds and identities written or read once; combine
    operations of the structure build (a scan's rows - 1, a sparse
    table's levels x rows) and of the queries (2 lookups, or 2 walks of
    levels + 1 steps).  No contraction."""
    levels = max(1, (rows - 1).bit_length())
    nbytes = u * rows * 4 + u * nq * 4
    ops = 0
    for g in plan.groups:
        mg, f = len(g.members_ix), g.width
        nbytes += u * rows * f * 4 + u * mg * nq * f * 4 + f * 4
        build = levels * rows if g.kind == "sparse" else rows - 1
        query = 2 if g.kind == "sparse" else 2 * (levels + 1)
        ops += u * f * _FAMILY_OPS[g.family] * (build + mg * nq * query)
    return dispatch.KernelCost(nbytes, ops, 0)


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
    the layout the plain version takes (the CUDA kernel makes those rows
    itself); no real query's fold changes."""
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
    leaf group, run the kernel (CUDA tensors) or the plain version (CPU
    tensors), and split the groups back into per-member
    ``{leaf key: (U, Q, *S)}`` dicts."""
    ts = env[plan.order_by]
    u, r = ts.shape
    return _fold_lanes(
        plan, ident_list,
        [_ref.lift_group(g, env, (u, r)) for g in plan.groups], ts,
        queries, use_kernel)


def _fold_lanes(plan: _ref.UnitFoldPlan,
                ident_list: Sequence[torch.Tensor],
                data_list: Sequence[torch.Tensor], ts: torch.Tensor,
                queries: torch.Tensor, use_kernel: Optional[bool]
                ) -> List[Dict[str, torch.Tensor]]:
    """Fold lifted (U, R, F) lane blocks through the kernel (CUDA
    tensors: the unpadded rows) or the plain version (CPU tensors: rows
    padded to rp by ``pad_rows``), or make outputs of the right shape
    (``meta``), and split the groups back into per-member dicts."""
    u, r = ts.shape
    nq = queries.shape[1]
    with dispatch.kernel_cost("unit_fold", cost(plan, u, r, nq)
                              if u and nq else None):
        queries = queries.to(torch.int32).contiguous()
        if dispatch.is_meta(ts):
            folded = [ts.new_empty((u, len(g.members_ix), nq, g.width),
                                   dtype=torch.float32)
                      for g in plan.groups]
        elif dispatch.resolve(use_kernel, ts):
            folded = unit_fold_cuda(
                plan, [d.contiguous() for d in data_list], ident_list,
                ts.to(torch.int32).contiguous(), queries)
        else:
            data_list, ts = pad_rows(ident_list, data_list, ts)
            folded = _ref.unit_fold_plain(plan, data_list, ident_list, ts,
                                          queries, r)
    return _unstack_batched(plan, folded)


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


def prelift_blocks(specs: Sequence[Any], leaves: Dict[str, Any],
                   flat_env: Dict[str, Any], *, order_by: str,
                   member_keys: Optional[Sequence[Sequence[str]]] = None
                   ) -> Tuple:
    """What every unit block of one group lowering shares: the cached
    plan and identity vectors, every leaf group's lanes lifted ONCE over
    the flat pad-appended rows, and the flat order column.  (The
    reference lifts narrow groups per unit instead, an XLA layout choice;
    lifts are row-local, so the lanes are the same bits either way.)"""
    flat_ts = flat_env[order_by]
    plan, ident_list = plan_for(specs, leaves, order_by, member_keys,
                                device=flat_ts.device)
    n = flat_ts.shape[0]
    flat_data = [_ref.lift_group(g, flat_env, (n,)) for g in plan.groups]
    return plan, ident_list, flat_data, flat_ts


def unit_fold_blocks(specs: Sequence[Any], leaves: Dict[str, Any],
                     flat_env: Dict[str, Any], idx: torch.Tensor, *,
                     order_by: str,
                     member_keys: Optional[Sequence[Sequence[str]]] = None,
                     use_kernel: Optional[bool] = None,
                     prelift: Optional[Tuple] = None
                     ) -> List[Dict[str, torch.Tensor]]:
    """Fold one window group over a §6.2 unit block at every row.

    ``flat_env`` holds the group's FLAT pad-appended columns — the
    merged (key, ts, rank, arrival)-sorted rows plus one sentinel row
    (``order_by`` = INT_MAX, ``__valid__`` = False) — and ``idx`` the
    (U, R) flat-row gather index of the block (pad slots point at the
    sentinel, which lifts to identity).  Each leaf group's (U, R, F) lane
    block is one gather of its flat lanes (``prelift``, built once per
    lowering); every row of every unit is queried (Q = R).  Returns one
    ``{leaf key: (U, R, *S)}`` dict per member.
    """
    if prelift is None:
        prelift = prelift_blocks(specs, leaves, flat_env,
                                 order_by=order_by,
                                 member_keys=member_keys)
    plan, ident_list, flat_data, flat_ts = prelift
    idx = idx.long()
    ts = flat_ts[idx]                                       # (U, R)
    u, r = ts.shape
    queries = torch.arange(r, dtype=torch.int32,
                           device=ts.device).expand(u, r)
    return _fold_lanes(plan, ident_list, [fd[idx] for fd in flat_data], ts,
                       queries, use_kernel)
