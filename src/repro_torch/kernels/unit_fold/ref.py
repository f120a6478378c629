"""Unit-fold plan and its plain PyTorch version.

One window group's ENTIRE unit fold — frame bounds, invertible
combine-scan + prefix difference, idempotent sparse-table build +
2-lookup query, ordered tree walk — over a batched (U, rp) block of
identity-padded units.  The plain version is written in the *value form*
of the reference's TPU kernel (packed balanced-tree levels, an MSB-first
prefix walk, a sparse table with a ``floor(log2)`` level, a two-sided
tree walk), which needs no torch copy of ``associative_scan`` and is
bitwise equal to it: scan prefix ``[0, e)`` is the MSB-first left fold of
the position-aligned power-of-two blocks of ``[0, e)``.  It is the CPU
path and the version the CUDA kernel (``csrc/unit_fold.cu``) is held
against, bit for bit, on the card.

Leaf stacking is what keeps one structure per leaf family: every
``AddLeaf`` stacks into one (rows, F) lane block folded by one scan,
every ``MinLeaf`` into one sparse table, ``MaxLeaf``/``HLLLeaf`` into
another; order-sensitive leaves (``DrawdownLeaf``, ``EWLeaf``) mix their
state lanes and keep their own structure.  That gives five combine
families, which the CUDA kernel switches over (``FAMILIES``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ...core.functions import (AddLeaf, DrawdownLeaf, EWLeaf, HLLLeaf, Leaf,
                               MaxLeaf, MinLeaf, floor_log2)

__all__ = ["LeafGroup", "UnitFoldPlan", "build_plan", "lift_group",
           "group_identity", "unit_fold_plain", "member_rows", "FAMILIES",
           "KINDS", "INT_MAX"]

INT_MAX = 2**31 - 1
# combine families and structure kinds, numbered as the CUDA kernel's
FAMILIES = {"add": 0, "min": 1, "max": 2, "drawdown": 3, "ew": 4}
KINDS = {"scan": 0, "sparse": 1, "tree": 2}


class _StackLeaf:
    """Leaf-shaped proxy over a stacked (rows, F) lane block:
    elementwise combine, per-lane identity."""

    def __init__(self, combine, ident, invert=None):
        self._combine = combine
        self._ident = ident
        self._invert = invert

    def identity(self):
        return self._ident

    def combine(self, a, b):
        return self._combine(a, b)

    def invert_prefix(self, p_end, p_start):
        return self._invert(p_end, p_start)


@dataclasses.dataclass
class LeafGroup:
    """One fold structure shared by one or more stacked leaves."""

    kind: str                            # 'scan' | 'sparse' | 'tree'
    family: str                          # key of FAMILIES
    keys: Tuple[str, ...]                # leaf keys in lane order
    leaves: Tuple[Leaf, ...]
    sizes: Tuple[int, ...]               # flat lane width per leaf
    proxy: Any                           # combine/identity/invert driver
    stacked: bool                        # lanes flattened from several leaves
    members_ix: Tuple[int, ...] = ()     # member rows querying this group

    @property
    def width(self) -> int:
        return sum(self.sizes)

    @property
    def log_decay(self) -> float:
        """The EW family's log(decay) (0 for every other family)."""
        return self.leaves[0].log_decay if self.family == "ew" else 0.0


@dataclasses.dataclass
class UnitFoldPlan:
    """Static fold plan for one window group: member specs + leaf
    groups, derived from compile-time metadata only — the plain version
    and the CUDA kernel execute this same plan."""

    specs: Tuple[Any, ...]               # member WindowSpecs
    order_by: str
    groups: Tuple[LeafGroup, ...]
    member_need: Optional[Tuple[frozenset, ...]] = None
    # per-shape launch data the kernel wrapper derives from the plan
    launch_cache: Dict[Tuple, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)


def _flat(leaf: Leaf) -> int:
    n = 1
    for d in leaf.shape:
        n *= d
    return n


def _leaf_ident_vec(leaf: Leaf) -> torch.Tensor:
    return torch.broadcast_to(leaf.identity().to(torch.float32),
                              leaf.shape).reshape(-1)


def _stack_group(kind: str, family: str, items, combine,
                 invert=None) -> LeafGroup:
    keys = tuple(k for k, _ in items)
    leaves = tuple(l for _, l in items)
    ident = torch.cat([_leaf_ident_vec(l) for l in leaves])
    return LeafGroup(kind=kind, family=family, keys=keys, leaves=leaves,
                     sizes=tuple(_flat(l) for l in leaves),
                     proxy=_StackLeaf(combine, ident, invert), stacked=True)


def build_plan(specs: Sequence[Any], leaves: Dict[str, Leaf],
               order_by: str,
               member_keys: Optional[Sequence[Sequence[str]]] = None
               ) -> UnitFoldPlan:
    """Partition the group's deduplicated leaves into fold structures.

    Exact-type checks (not isinstance) gate the stacks: stacking is only
    bitwise-safe when the combine really is the elementwise add/min/max
    these classes define.  ``DrawdownLeaf`` folds by tree and ``EWLeaf``
    by scan on their own; any other leaf type has no fused fold and
    raises — there is no fallback.  ``member_keys`` (one leaf-key
    collection per member window) restricts each group's queries to the
    members that use it (``members_ix``).
    """
    add, mn, mx, solo = [], [], [], []
    for k, leaf in leaves.items():
        if type(leaf) is AddLeaf:
            add.append((k, leaf))
        elif type(leaf) is MinLeaf:
            mn.append((k, leaf))
        elif type(leaf) in (MaxLeaf, HLLLeaf):
            mx.append((k, leaf))
        elif type(leaf) in (DrawdownLeaf, EWLeaf):
            solo.append((k, leaf))
        else:
            raise ValueError(f"no fused fold for leaf type "
                             f"{type(leaf).__name__} ({k!r})")
    all_members = tuple(range(len(specs)))

    def members_for(keys: Tuple[str, ...]) -> Tuple[int, ...]:
        if member_keys is None:
            return all_members
        need = set(keys)
        return tuple(mi for mi, ks in enumerate(member_keys)
                     if need.intersection(ks)) or all_members

    groups: List[LeafGroup] = []
    stacks = (
        (add, "scan", "add", lambda a, b: a + b, lambda e, s: e - s),
        (mn, "sparse", "min", torch.minimum, None),
        (mx, "sparse", "max", torch.maximum, None),
    )
    for items, kind, family, combine, invert in stacks:
        if items:
            g = _stack_group(kind, family, items, combine, invert)
            groups.append(dataclasses.replace(
                g, members_ix=members_for(g.keys)))
    for k, leaf in solo:
        ew = type(leaf) is EWLeaf
        groups.append(LeafGroup(
            kind="scan" if ew else "tree", family="ew" if ew else "drawdown",
            keys=(k,), leaves=(leaf,), sizes=(_flat(leaf),), proxy=leaf,
            stacked=False, members_ix=members_for((k,))))
    need = (None if member_keys is None
            else tuple(frozenset(ks) for ks in member_keys))
    return UnitFoldPlan(specs=tuple(specs), order_by=order_by,
                        groups=tuple(groups), member_need=need)


def group_identity(group: LeafGroup) -> torch.Tensor:
    """The group's identity as a flat (F,) float32 lane vector."""
    if group.stacked:
        return group.proxy.identity()
    return _leaf_ident_vec(group.leaves[0])


def lift_group(group: LeafGroup, env: Dict[str, Any],
               rows_shape: Tuple[int, ...]) -> torch.Tensor:
    """Lift a unit env (columns of shape ``rows_shape``) into the group's
    flat lane layout ``rows_shape + (F,)``.  Row masking (padding rows
    lift to each leaf's fill value) happens inside ``leaf.lift``."""
    mats = [leaf.lift(env).reshape(tuple(rows_shape) + (-1,))
            for leaf in group.leaves]
    return mats[0] if len(mats) == 1 else torch.cat(mats, dim=-1)


def member_rows(specs: Sequence[Any], r_real: int) -> List[Tuple[int, ...]]:
    """Per-member frame parameters as the kernel takes them:
    (frame_rows, preceding, maxsize, exclude_current_row), with a ROWS
    member's preceding clipped to the real row count and a RANGE
    member's to 2^30 (the reference's clips)."""
    out = []
    for s in specs:
        pre = min(s.preceding, r_real) if s.frame_rows else \
            min(s.preceding, 2**30)
        out.append((int(s.frame_rows), int(pre), int(s.maxsize),
                    int(s.instance_not_in_window)))
    return out


# ---------------------------------------------------------------------------
# Plain version, value form; every stage is batched over the unit axis
# ---------------------------------------------------------------------------


def _bounds(rows: Sequence[Tuple[int, ...]], ts: torch.Tensor,
            q: torch.Tensor, rp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U, M, Q) [start, end) frame bounds: ROWS arithmetic, the RANGE
    binary search run ceil(log2(rp))+1 steps over the padded row
    (converged rows stay put), MAXSIZE and EXCLUDE CURRENT_ROW."""
    end0 = q + 1
    range_ix = [i for i, r in enumerate(rows) if not r[0]]
    found = {}
    if range_ix:
        tsq = torch.gather(ts, 1, q.long())                       # (U, Q)
        pres = torch.tensor([rows[i][1] for i in range_ix],
                            dtype=torch.int32, device=ts.device)
        targets = tsq[:, None, :] - pres[None, :, None]           # (U, Mr, Q)
        lo = torch.zeros_like(targets)
        hi = torch.broadcast_to(end0[:, None, :], targets.shape).clone()
        u = ts.shape[0]
        for _ in range(max(1, (rp - 1).bit_length()) + 1):
            mid = (lo + hi) >> 1
            v = torch.gather(ts, 1, mid.clamp(0, rp - 1).reshape(u, -1)
                             .long()).reshape(mid.shape)
            go_right = (v < targets) & (lo < hi)
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right | (lo >= hi), hi, mid)
        for row, i in enumerate(range_ix):
            found[i] = lo[:, row]
    starts, ends = [], []
    for i, (frame_rows, pre, maxsize, exclude) in enumerate(rows):
        end = end0
        start = (torch.clamp_min(q - pre, 0) if frame_rows else found[i])
        if maxsize:
            start = torch.maximum(start, end - maxsize)
        if exclude:
            end = torch.minimum(end, q)
            start = torch.minimum(start, end)
        starts.append(start)
        ends.append(end)
    return (torch.stack(starts, 1).to(torch.int32),
            torch.stack(ends, 1).to(torch.int32))


def _level_offsets(rp: int) -> List[int]:
    offs, off, n = [], 0, rp
    while n >= 1:
        offs.append(off)
        off += n
        n //= 2
    return offs


def _pack_levels(proxy, data: torch.Tensor) -> torch.Tensor:
    """Balanced-tree levels (pair combines) packed into (U, 2rp-1, F)."""
    levels = [data]
    cur = data
    while cur.shape[1] > 1:
        cur = proxy.combine(cur[:, 0::2], cur[:, 1::2])
        levels.append(cur)
    return torch.cat(levels, dim=1)


def _gather_nodes(lvl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(U, M, Q) row gather out of packed (U, rows, F) levels."""
    u, m, q = idx.shape
    f = lvl.shape[-1]
    flat = idx.reshape(u, m * q, 1).long().expand(u, m * q, f)
    return torch.gather(lvl, 1, flat).reshape(u, m, q, f)


def _prefix_at(proxy, lvl: torch.Tensor, offs: List[int], e: torch.Tensor,
               rp: int) -> torch.Tensor:
    """Scan prefix of rows [0, e) (e >= 1): MSB-first left fold of e's
    set-bit blocks, each block the position-aligned tree node covering
    it — the bracketing of ``associative_scan``."""
    pos = torch.zeros_like(e)
    acc = torch.zeros(tuple(e.shape) + (lvl.shape[-1],), dtype=lvl.dtype,
                      device=lvl.device)
    first = torch.ones(e.shape, dtype=torch.bool, device=e.device)
    for k in range(rp.bit_length() - 1, -1, -1):
        taken = ((e >> k) & 1) == 1
        node = _gather_nodes(lvl, offs[k] + (pos >> k))
        cand = torch.where(first[..., None], node, proxy.combine(acc, node))
        acc = torch.where(taken[..., None], cand, acc)
        first = first & ~taken
        pos = pos + torch.where(taken, 1 << k, 0).to(pos.dtype)
    return acc


def _scan_group(grp: LeafGroup, data, ident, starts, ends, rp: int):
    """Tree build + two prefix walks + prefix difference, with the
    identity at the segment start and on empty ranges."""
    lvl = _pack_levels(grp.proxy, data)
    offs = _level_offsets(rp)
    last = _prefix_at(grp.proxy, lvl, offs, torch.clamp_min(ends, 1), rp)
    prev = _prefix_at(grp.proxy, lvl, offs, torch.clamp_min(starts, 1), rp)
    prev = torch.where((starts <= 0)[..., None], ident, prev)
    folded = grp.proxy.invert_prefix(last, prev)
    return torch.where((ends <= starts)[..., None], ident, folded)


def _sparse_group(grp: LeafGroup, data, ident, starts, ends, rp: int):
    """Sparse table (concat-shift combine per level) + two lookups."""
    u, _, f = data.shape
    levels = [data]
    cur = data
    j = 1
    while (1 << j) <= rp:
        off = 1 << (j - 1)
        pad = torch.broadcast_to(ident, (u, off, f))
        cur = grp.proxy.combine(cur, torch.cat([cur[:, off:], pad], dim=1))
        levels.append(cur)
        j += 1
    table = torch.cat(levels, dim=1)                       # (U, L*rp, F)
    span = torch.clamp_min(ends - starts, 1)
    jlev = floor_log2(span).to(torch.int32)
    lo = starts.clamp(0, rp - 1)
    hi = (ends - torch.bitwise_left_shift(torch.ones_like(jlev), jlev)
          ).clamp(0, rp - 1)
    a = _gather_nodes(table, jlev * rp + lo)
    b = _gather_nodes(table, jlev * rp + hi)
    out = grp.proxy.combine(a, b)
    return torch.where((ends <= starts)[..., None], ident, out)


def _tree_group(grp: LeafGroup, data, ident, starts, ends, rp: int):
    """Two-sided segment-tree walk (left accumulator grows rightward,
    right leftward), clamp for clamp as the reference's ``tree_query``."""
    lvl = _pack_levels(grp.proxy, data)
    res_l = torch.broadcast_to(ident, tuple(starts.shape) + ident.shape)
    res_r = res_l
    l, r = starts, ends
    for k, off in enumerate(_level_offsets(rp)):
        m_nodes = rp >> k
        active = l < r
        take_l = active & ((l & 1) == 1)
        take_r = active & ((r & 1) == 1)
        node_l = _gather_nodes(lvl, off + l.clamp(0, m_nodes - 1))
        node_r = _gather_nodes(lvl, off + (r - 1).clamp(0, m_nodes - 1))
        res_l = torch.where(take_l[..., None],
                            grp.proxy.combine(res_l, node_l), res_l)
        res_r = torch.where(take_r[..., None],
                            grp.proxy.combine(node_r, res_r), res_r)
        l = (l + take_l.to(torch.int32)) >> 1
        r = (r - take_r.to(torch.int32)) >> 1
    return grp.proxy.combine(res_l, res_r)


_FOLDS = {"scan": _scan_group, "sparse": _sparse_group, "tree": _tree_group}


def unit_fold_plain(plan: UnitFoldPlan, data_list: Sequence[torch.Tensor],
                    ident_list: Sequence[torch.Tensor], ts: torch.Tensor,
                    queries: torch.Tensor, r_real: int
                    ) -> List[torch.Tensor]:
    """Fold identity-padded (U, rp, F_g) lane blocks: ``ts`` (U, rp)
    int32 INT_MAX-padded with rp a power of two, ``queries`` (U, Q)
    int32 unit positions.  Returns one (U, Mg, Q, F_g) block per group,
    member rows in ``members_ix`` order."""
    rp = ts.shape[1]
    starts, ends = _bounds(member_rows(plan.specs, r_real), ts, queries, rp)
    outs = []
    for grp, data, ident in zip(plan.groups, data_list, ident_list):
        ix = torch.tensor(grp.members_ix, dtype=torch.long,
                          device=ts.device)
        outs.append(_FOLDS[grp.kind](grp, data, ident.to(data.device),
                                     starts[:, ix], ends[:, ix], rp))
    return outs
