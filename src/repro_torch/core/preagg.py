"""Long-window pre-aggregation (§5.1).

Aggregators are maintained at two time granularities (fine bucket ``g`` ms
and coarse bucket ``g * fanout`` ms — the paper's daily/monthly
hierarchy).  On ingest (driven from the store binlog), each row's lifted
leaf state is combined into its (key, fine bucket) and (key, coarse
bucket) slots.

An online query over ``[t0 = ts - W, ts]`` is decomposed as in the
paper's Figure 4:

    raw left edge  | fine buckets | coarse buckets | fine buckets | raw right edge (+ request row)
    [t0, fb0*g)      [fb0, cb0*f)   [cb0, cb1)       [cb1*f, fbr)    [fbr*g, ts]

and folded in time order (the drawdown and ew_avg combines are
order-sensitive), replacing an O(window) scan with O(fanout + W/(g*fanout))
combines plus two bounded edge scans.

Buckets live in ring buffers indexed by absolute bucket id modulo
capacity; a per-slot ``epoch`` array stores the absolute id, so stale
slots read as identity.  Bucket ids use floor division and a
non-negative remainder, as ``jnp``'s ``//`` and ``%`` do: a window as
long as the data's horizon starts before time 0, and its ids are
negative.

The state keeps the reference's layout (one plane per leaf).  The work
is stacked per combine family, the unit fold's leaf groups
(``kernels.unit_fold.ref.build_plan``: every additive leaf in one lane
block, min in one, max and HLL in one, drawdown and EW each alone), and
batched over the (B,) requests, so launches grow with neither leaves nor
B.  Every combine keeps the reference's order: the update is a left fold
per (key, bucket) group seeded from the slot, the query a left fold over
each bucket range from the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..kernels.unit_fold import ref as _uf
from .functions import Leaf
from .window import WindowSpec, sorted_perm, tree_fold

__all__ = ["PreAgg"]


class _Family:
    """One combine family's stacked lanes as a leaf: (F,) state, the
    group's identity vector and combine (``tree_fold`` folds it)."""

    def __init__(self, group):
        self.group = group
        self.shape = (group.width,)
        self._ident = _uf.group_identity(group)

    def identity(self) -> torch.Tensor:
        return self._ident

    def combine(self, a, b):
        return self.group.proxy.combine(a, b)

    def lift(self, env, rows_shape) -> torch.Tensor:
        return _uf.lift_group(self.group, env, rows_shape)

    def stack(self, planes: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-leaf (n_keys, slots, *S) planes -> one (n_keys, slots, F)."""
        mats = [planes[k].reshape(tuple(planes[k].shape[:2]) + (-1,))
                for k in self.group.keys]
        return mats[0] if len(mats) == 1 else torch.cat(mats, dim=-1)

    def split(self, lanes: torch.Tensor, lead: Tuple[int, ...]
              ) -> Dict[str, torch.Tensor]:
        """(*lead, F) lanes -> per-leaf (*lead, *S) states."""
        out, off = {}, 0
        for k, leaf, size in zip(self.group.keys, self.group.leaves,
                                 self.group.sizes):
            out[k] = lanes[..., off:off + size].reshape(
                tuple(lead) + tuple(leaf.shape))
            off += size
        return out


@dataclasses.dataclass
class PreAgg:
    spec: WindowSpec
    leaves: Dict[str, Leaf]
    bucket_ms: int                 # fine granularity g
    window_ms: int                 # W
    n_keys: int
    value_cols: Tuple[str, ...]
    fanout: int = 16               # coarse = g * fanout
    max_bucket_rows: int = 128     # edge-scan buffer bound

    def __post_init__(self):
        self.coarse_ms = self.bucket_ms * self.fanout
        # ring capacities: enough fine slots to cover one window + slack
        self.n_fine = max(4, self.window_ms // self.bucket_ms
                          + 2 * self.fanout)
        self.n_coarse = max(4, self.window_ms // self.coarse_ms + 4)
        # static count of coarse buckets a window can span
        self.max_coarse_q = self.window_ms // self.coarse_ms + 2
        plan = _uf.build_plan([self.spec], self.leaves, self.spec.order_by)
        self.families: List[_Family] = [_Family(g) for g in plan.groups]
        # §5.1 "aggregator hierarchy enhancement": per-level query stats
        self.query_stats = {"fine": 0, "coarse": 0, "raw_edge": 0,
                            "queries": 0}

    # -------------------------------------------------------- adaptivity
    def observe_query(self, ts: int):
        """Record which levels a query at time ``ts`` touches (host-side
        bookkeeping; the paper adjusts the hierarchy from such stats)."""
        g, f = self.bucket_ms, self.fanout
        t0 = ts - self.window_ms
        fb0 = -(-t0 // g)
        fbr = ts // g
        cb0 = -(-fb0 // f)
        cb1 = fbr // f
        n_coarse = max(0, cb1 - cb0)
        n_fine = max(0, (min(cb0 * f, fbr) - fb0)) + \
            max(0, fbr - max(cb1 * f, fb0))
        self.query_stats["queries"] += 1
        self.query_stats["coarse"] += n_coarse
        self.query_stats["fine"] += n_fine
        self.query_stats["raw_edge"] += 2

    def suggest_hierarchy(self) -> dict:
        """Adaptive-hierarchy advice (§5.1): if coarse buckets are rarely
        used the level is wasted maintenance; if fine-per-query is high a
        coarser/extra level would shrink query work."""
        q = max(1, self.query_stats["queries"])
        fine_pq = self.query_stats["fine"] / q
        coarse_pq = self.query_stats["coarse"] / q
        advice = "keep"
        if coarse_pq < 0.5 and q >= 16:
            advice = "drop-coarse-level"
        elif coarse_pq > 4 * self.fanout or fine_pq > 4 * self.fanout:
            advice = "add-coarser-level"
        return {"fine_per_query": fine_pq, "coarse_per_query": coarse_pq,
                "advice": advice}

    # ------------------------------------------------------------------ state
    def init_state(self, device="cuda") -> Dict[str, Any]:
        """Identity bucket planes on ``device``: the card unless the caller
        asks for the CPU; a CUDA device without a card raises."""
        device = resolve_device(device)
        fine, coarse = {}, {}
        for k, leaf in self.leaves.items():
            ident = leaf.identity().to(device)
            fine[k] = torch.broadcast_to(
                ident, (self.n_keys, self.n_fine) + tuple(ident.shape)
            ).contiguous()
            coarse[k] = torch.broadcast_to(
                ident, (self.n_keys, self.n_coarse) + tuple(ident.shape)
            ).contiguous()
        return {
            "fine": fine, "coarse": coarse,
            "fine_epoch": torch.full((self.n_keys, self.n_fine), -1,
                                     dtype=torch.int32, device=device),
            "coarse_epoch": torch.full((self.n_keys, self.n_coarse), -1,
                                       dtype=torch.int32, device=device),
        }

    def plane_bytes(self, state) -> int:
        """Bytes of the bucket planes and their epochs."""
        return sum(t.numel() * t.element_size()
                   for lvl in ("fine", "coarse")
                   for t in list(state[lvl].values())
                   + [state[f"{lvl}_epoch"]])

    # ----------------------------------------------------------------- update
    def update(self, state, key, ts, values):
        """Fold ONE ingested row into the buckets: the batched path at
        M = 1, so sequential and batched updates of the same in-order rows
        give the same bits."""
        return self.update_many(
            state, [int(key)], [int(ts)],
            {c: [np.float32(values[c])] for c in self.value_cols
             if c in values})

    @staticmethod
    def _batch_in_order(keys: np.ndarray, ts: np.ndarray) -> bool:
        """True iff every key's timestamps are non-decreasing in arrival
        order within the batch — the precondition under which the
        one-shot batched fold replays the sequential combine sequence."""
        n = keys.shape[0]
        if n <= 1:
            return True
        order = np.lexsort((np.arange(n), keys))   # stable: key, arrival
        k_s, t_s = keys[order], ts[order]
        same_key = k_s[1:] == k_s[:-1]
        return not bool(np.any(same_key & (t_s[1:] < t_s[:-1])))

    @staticmethod
    def _ordered_run_cuts(keys: np.ndarray, ts: np.ndarray):
        """Arrival-order cut points splitting a batch into maximal
        in-order runs: a cut lands on every row whose timestamp regresses
        against its key's previous occurrence, so each run satisfies
        ``_batch_in_order``."""
        n = keys.shape[0]
        order = np.lexsort((np.arange(n), keys))
        k_s, t_s = keys[order], ts[order]
        viol = order[1:][(k_s[1:] == k_s[:-1]) & (t_s[1:] < t_s[:-1])]
        return [0] + sorted(int(i) for i in viol) + [n]

    def update_many(self, state, keys, ts, values: Dict[str, Any]):
        """Fold M ingested rows into the buckets with one ordered fold +
        one scatter per level and family.

        Per (key, bucket) the rows are combined in (ts, arrival) order by
        a left fold seeded from the slot's pre-batch value (identity if
        stale) — exactly the combine sequence M sequential updates
        perform — so results are bitwise those of sequential updates
        whenever rows arrive in timestamp order.  A batch whose rows
        regress in timestamp within a key is split at the regressions,
        and each in-order run folds on top of the previous one.  When a
        batch spans more bucket ids than the ring holds, the newest
        bucket aliasing each slot wins.
        """
        keys = np.asarray(keys, np.int32)
        ts = np.asarray(ts, np.int32)
        n = keys.shape[0]
        if n == 0:
            return state
        vals = {c: np.asarray(values[c], np.float32)
                for c in self.value_cols if c in values}
        if not self._batch_in_order(keys, ts):
            cuts = self._ordered_run_cuts(keys, ts)
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                state = self.update_many(
                    state, keys[lo:hi], ts[lo:hi],
                    {c: v[lo:hi] for c, v in vals.items()})
            return state
        dev = state["fine_epoch"].device
        env = {c: torch.from_numpy(vals[c]).to(dev) if c in vals
               else torch.zeros((n,), dtype=torch.float32, device=dev)
               for c in self.value_cols}
        return self._update_many_impl(
            state, torch.from_numpy(keys).to(dev),
            torch.from_numpy(ts).to(dev), env)

    def _update_many_impl(self, state, keys: torch.Tensor, ts: torch.Tensor,
                          env: Dict[str, torch.Tensor]):
        m = keys.shape[0]
        env = dict(env)
        env[self.spec.order_by] = ts
        # a key past the plane's cardinality clips onto the last plane
        # (the reference's rule C-KEYCARD)
        key_eff = keys.clamp(0, self.n_keys - 1)
        # one (key, ts, arrival) sort serves both levels: bucket ids are
        # monotone in ts, so buckets are contiguous within each key run
        perm = sorted_perm(key_eff, ts)
        k_s = key_eff[perm]
        ts_s = ts[perm]
        lifted = [fam.lift(env, (m,))[perm] for fam in self.families]
        out = dict(state)
        for lvl, ms, cap in (("fine", self.bucket_ms, self.n_fine),
                             ("coarse", self.coarse_ms, self.n_coarse)):
            b_s = torch.div(ts_s, ms, rounding_mode="floor")
            info = _group_info(k_s, b_s, cap, self.n_keys)
            out[lvl] = _scatter_level(state[lvl], state[f"{lvl}_epoch"],
                                      self.families, lifted, info)
            out[f"{lvl}_epoch"] = _scatter_epoch(state[f"{lvl}_epoch"],
                                                 info)
        return out

    # ------------------------------------------------------------------ query
    def fold_online(self, states, w, keys: torch.Tensor, ts: torch.Tensor,
                    values: Dict[str, torch.Tensor], pre_state,
                    gather: Callable) -> Dict[str, torch.Tensor]:
        """Ordered fold over [ts-W, ts] for (B,) requests: raw left edge,
        fine, coarse and fine bucket ranges, raw right edge with the
        request row.  Returns ``{leaf key: (B, *S)}``."""
        g, f = self.bucket_ms, self.fanout
        b = keys.shape[0]
        ts = ts.to(torch.int32)
        t0 = ts - self.window_ms

        def fdiv(x, d):
            return torch.div(x, d, rounding_mode="floor")

        fbr = fdiv(ts, g)                    # current (partial) fine bucket
        fb0 = torch.minimum(fdiv(t0 + g - 1, g), fbr)  # first full fine
        cb1 = fdiv(fbr, f)                   # end (exclusive) coarse bucket
        cb0 = torch.minimum(fdiv(fb0 + f - 1, f), cb1)
        has_coarse = cb1 > cb0
        # without any coarse bucket, the fine range is just [fb0, fbr)
        fine_l_end = torch.where(has_coarse, cb0 * f, fbr)
        fine_r_start = torch.where(has_coarse, cb1 * f, fbr)
        key_c = keys.clamp(0, self.n_keys - 1).long()

        env_l = gather(states, w, keys, t0, fb0 * g)
        env_r = _append_request(
            gather(states, w, keys, fbr * g, ts + 1), self.spec,
            self.value_cols, values)
        ranges = (("fine", fb0, fine_l_end, 2 * f),
                  ("coarse", cb0, cb1, self.max_coarse_q),
                  ("fine", fine_r_start, fbr, f + 1))
        slot_ok = self._bucket_slots(pre_state, key_c, ranges)
        out: Dict[str, torch.Tensor] = {}
        for fam in self.families:
            fine_a, coarse, fine_b = self._fold_bucket_range(
                fam, pre_state, key_c, slot_ok).split(b)
            acc = fam.combine(_fold_env(fam, env_l), fine_a)
            acc = fam.combine(acc, coarse)
            acc = fam.combine(acc, fine_b)
            out.update(fam.split(fam.combine(acc, _fold_env(fam, env_r)),
                                 (b,)))
        return out

    def _bucket_slots(self, pre_state, key_c: torch.Tensor, ranges):
        """Per bucket range (level, b0, b1, max_q): the ring slots of ids
        b0 .. b0 + max_q - 1 and whether each is in [b0, b1) with a
        current epoch, every range front-padded to the longest chain
        (pad slots are not ok)."""
        n_chain = max(r[3] for r in ranges)
        caps = {"fine": self.n_fine, "coarse": self.n_coarse}
        out = []
        for lvl, b0, b1, max_q in ranges:
            j = torch.arange(n_chain, dtype=torch.int32,
                             device=key_c.device) - (n_chain - max_q)
            ids = b0[:, None] + j
            slots = torch.remainder(ids, caps[lvl]).long()
            ep = pre_state[f"{lvl}_epoch"][key_c[:, None], slots]
            ok = (j >= 0) & (ids < b1[:, None]) & (ep == ids)
            out.append((lvl, slots, ok))
        return out

    def _fold_bucket_range(self, fam: _Family, pre_state,
                           key_c: torch.Tensor, slot_ok) -> torch.Tensor:
        """Ordered combine, from the identity, of each range's buckets
        (stale or out-of-range slots read as identity): the ranges fold
        as one (ranges*B,) batch of left folds of the longest chain's
        length.  A shorter range's chain is front-padded with identities,
        and combine(identity, identity) == identity in every family, so
        each range gets the reference's exact chain."""
        ident = fam.identity().to(key_c.device)
        planes = {lvl: fam.stack(pre_state[lvl]) for lvl in ("fine",
                                                             "coarse")}
        st = torch.cat([
            torch.where(ok[..., None], planes[lvl][key_c[:, None], slots],
                        ident)
            for lvl, slots, ok in slot_ok], dim=0)     # (ranges*B, L, F)
        acc = torch.broadcast_to(ident, (st.shape[0], ident.shape[0]))
        for i in range(st.shape[1]):                   # static, small
            acc = fam.combine(acc, st[:, i])
        return acc


def _group_info(k_s: torch.Tensor, b_s: torch.Tensor, capacity: int,
                n_keys: int) -> Dict[str, torch.Tensor]:
    """Group structure of (key, bucket)-sorted rows for one bucket level:
    each group's first row and length, its key, bucket and ring slot,
    and ``win``, the single scatter winner per (key, slot) — the last
    (newest-bucket) group aliasing it — so no destination repeats."""
    m = k_s.shape[0]
    dev = k_s.device
    seg = torch.ones((m,), dtype=torch.bool, device=dev)
    seg[1:] = (k_s[1:] != k_s[:-1]) | (b_s[1:] != b_s[:-1])
    starts = torch.nonzero(seg).flatten()
    n_grp = starts.shape[0]
    lengths = torch.diff(starts, append=torch.tensor([m], device=dev))
    keys = k_s[starts].long()
    buckets = b_s[starts]
    slots = torch.remainder(buckets, capacity).long()
    dest = keys * capacity + slots
    order = torch.arange(n_grp, device=dev)
    last = torch.full((n_keys * capacity,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce(0, dest, order, "amax")
    return {"starts": starts, "lengths": lengths, "keys": keys,
            "buckets": buckets, "slots": slots, "win": last[dest] == order}


def _scatter_level(planes: Dict[str, torch.Tensor], epochs: torch.Tensor,
                   families: List[_Family], lifted: List[torch.Tensor],
                   info) -> Dict[str, torch.Tensor]:
    """Ordered slot-seeded fold + one scatter per family for one level.

    Each group's running state starts from the slot's pre-batch value
    (identity when the epoch says the slot is stale) and combines the
    group's rows left to right, one position at a time across all
    groups — the exact left fold ``((cur ⊕ x1) ⊕ x2) ⊕ ...`` a row-by-row
    sequence of updates produces.  The winners are installed by one
    index_put per family with no repeated destination."""
    k, s, win = info["keys"], info["slots"], info["win"]
    stale = epochs[k, s] != info["buckets"]
    starts, lengths = info["starts"], info["lengths"]
    n_pos = int(lengths.max())
    out: Dict[str, torch.Tensor] = {}
    for fam, x in zip(families, lifted):
        plane = fam.stack(planes)
        ident = fam.identity().to(plane.device)
        acc = torch.where(stale[:, None], ident, plane[k, s])
        for p in range(n_pos):
            live = lengths > p
            row = x[torch.clamp_max(starts + p, x.shape[0] - 1)]
            acc = torch.where(live[:, None], fam.combine(acc, row), acc)
        new = plane.clone()
        new[k[win], s[win]] = acc[win]
        out.update(fam.split(new, tuple(new.shape[:2])))
    return out


def _scatter_epoch(epochs: torch.Tensor, info) -> torch.Tensor:
    win = info["win"]
    out = epochs.clone()
    out[info["keys"][win], info["slots"][win]] = info["buckets"][win]
    return out


def _fold_env(fam: _Family, env: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Tree fold of a (B, n) edge env's lifted family lanes -> (B, F)."""
    rows = tuple(env["__valid__"].shape)
    return tree_fold(fam, fam.lift(env, rows))


def _append_request(env: Dict[str, torch.Tensor], spec: WindowSpec,
                    value_cols, values: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Append the request row after the right-edge rows (it is the newest
    element of its window — ordering matches the offline stable sort)."""
    valid = env["__valid__"]
    b = valid.shape[0]
    out = {}
    for c in value_cols:
        v = env[c]
        req = values.get(c)
        req = (torch.zeros((b,), dtype=v.dtype, device=v.device)
               if req is None else req.to(v.dtype))
        out[c] = torch.cat([v, req[:, None]], dim=1)
    out["__valid__"] = torch.cat([valid, torch.full(
        (b, 1), not spec.instance_not_in_window, dtype=torch.bool,
        device=valid.device)], dim=1)
    return out
