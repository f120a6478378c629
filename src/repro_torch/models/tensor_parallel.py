"""Products on weights in pieces: the model side of a parameter tree
placed by ``param_pspecs`` (``distributed.sharding.device_put``).

The reference has no counterpart: it jits its steps on a tree placed by
``named_shardings(param_pspecs(...))`` and XLA's partitioner splits each
product and inserts the collectives.  The port is single-controller (one
process drives every card of the mesh, as in ``models.sharded_decode``),
so the splits are explicit here, each on the pieces that
``sharding.axis_pieces`` reads along the mesh axis ``model``.  The
weights stay in pieces and the activations move:

* **the product route** (``matmul``, ``columns``): ``x @ W`` for a leaf
  split along ``model`` -- by column (its last dim): ``x`` copied once to
  each card (``spread``), ``x @ W_k`` there, the outputs copied to the
  home card and concatenated in entry order (exact); by row (its first
  dim): card k gets the column slice of ``x`` that its rows read, and
  the partial products are summed by ``row_sum``.  Every family's
  projections take it: RWKV6's ``wr|wk|wv|wg|ww|cm_r`` and ``wo``,
  hymba's SSM ``in_proj`` (its ``[xi | z]`` halves come back in order),
  ``w_b|w_c`` and ``out_proj``, MLA's ``q_up|k_up|v_up`` and ``wo``, the
  audio encoder's and cross-attention's ``wq|wk|wv|wo``, and a GQA
  block whose KV heads the entries do not divide (hymba-1.5b's 5 on
  four);
* **column / row pairs** (``column_row``): ``act(x @ U_k) @ D_k`` on card
  k, the partial products summed by ``row_sum``, the activation never
  leaving its card (``w_gate|w_up`` / ``w_down``,
  ``shared_gate|shared_up`` / ``shared_down``, the audio MLP's ``w_up``
  / ``w_down`` with each card's slice of ``b_up``, RWKV6's ``cm_k`` /
  ``cm_v``; a GQA head group's ``wq|wk|wv`` / ``wo`` the same way,
  ``layers._gqa_heads``);
* **head-wise products** (``by_head``): a product that reads a weight as
  ``(r, heads, c)`` -- MLA's absorbed decode through ``k_up`` / ``v_up``
  -- runs card k's head group on its piece, the outputs joined along
  the heads in entry order;
* **row-parallel reduction** (``row_sum``): the partial ``(..., d)``
  products of the cards summed on the home card in entry order ``0 ..
  n-1``, accumulated in float32 and cast once: a fixed order, no
  atomics, no collective library;
* **vocab-parallel embedding** (``embedding``): each card looks up the
  ids in its row range and zeroes the others; the home card sums in
  entry order, which is exact (one nonzero term per element);
* **vocab-parallel logits** (``logits``): ``lm_head``'s column pieces, or
  ``embed.T``'s where the embeddings are tied, concatenated on the home
  card;
* **gather at use** (``whole``) for two kinds of leaf only: those that
  another axis of size > 1 splits too (``data`` under
  ``megatron_zero``: no entry along ``model`` holds a whole block), and
  those that no product reads (hymba's ``log_a``, split along its
  channels by ``auto_pspec`` and read elementwise): the leaf is whole on
  the computing card for the call that reads it and freed after it, the
  ZeRO-3 way.  Replicated leaves (norms, RWKV6's ``mu|w0|u_bonus``, the
  SSM's ``w_dt|b_dt|d_skip``) are read from the computing card's own
  piece (``on``), no copy.

Recurrences and attention stay on the home card, on whole activations:
RWKV6's WKV loop (``layers.rwkv_time_mix``), the SSM scan through the
``linear_scan`` kernel, prefill attention, and decode through the
``decode_partials`` kernel (the head route of a GQA layer whose KV heads
the entries divide runs card k's group on card k, ``layers._gqa_heads``).
The port has one controller and is host-bound (~22 us a launch on the
H100): running the WKV loop on every card would multiply its four
launches a token by the number of entries.  A per-card recurrence can
come with a WKV kernel.  (A decode state that is itself placed, by
``cache_pspecs``, is the other way round: its ``S`` and SSM state are
updated piece by piece on their own cards, ``models.sharded_decode``.)

The backward of every split is fixed as its forward is: ``spread``'s
gradient is the cards' gradients summed on the home card in entry order
in float32 (autograd alone would add them in the order its per-device
threads deliver them), ``row_sum``'s hands each card its copy of the
output gradient, and the concatenations' and the vocab-parallel
embedding's and logits' land on the cards that hold the pieces
(autograd's, through the cross-card copies).  A train step
(``train.steps.loss_and_grads``) differentiates each piece where it
lives; ``whole``'s gather carries the gradient back to the pieces it
read.  No float atomics, no collective library, and no route that
falls back to ``whole`` for a leaf split along ``model`` alone.

The home card is the one the activations live on: mesh entry 0's device
(``home``).  Entries that name one device more than once run every piece
on that device, which is how the CPU tests and a one-card host exercise
the route.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.fault import tree_flatten
from ..distributed.sharding import (Mesh, NamedSharding, PartitionSpec,
                                    Placed, axis_mesh, axis_pieces,
                                    canonical_device, gather, home,
                                    map_pieces)

__all__ = ["AXIS", "HEAD_SPEC", "home", "tree_home", "split", "spread",
           "row_sum", "matmul", "columns", "column_row", "by_head",
           "embedding", "logits", "whole", "on", "placed_along",
           "map_pieces", "head_mesh"]

AXIS = "model"
# a (B, S, Hkv, D) KV cache split by KV head: card k holds heads
# [k Hkv/n, (k + 1) Hkv/n), the head group its attention computes
HEAD_SPEC = PartitionSpec(None, None, AXIS, None)


def tree_home(tree) -> Optional[torch.device]:
    """Mesh entry 0's device of the first ``Placed`` leaf of ``tree``
    (None where no leaf is placed)."""
    for x in tree_flatten(tree)[0]:
        if isinstance(x, Placed):
            return home(x)
    return None


def _pieces_of(x, dim: int) -> Optional[List[torch.Tensor]]:
    """The pieces of ``x`` along ``model`` where ``model`` splits it along
    ``dim`` alone (None otherwise: a tensor, a replicated leaf, another
    split)."""
    if not isinstance(x, Placed):
        return None
    layout = axis_pieces(x, AXIS)
    if layout is None or layout[0] != dim:
        return None
    return layout[1]


def split(leaves: Sequence, dims: Sequence[int]
          ) -> Optional[List[List[torch.Tensor]]]:
    """The pieces of every leaf when each is split by ``model`` along its
    dimension of ``dims`` over the same devices in the same order; None
    where any is not (the caller gathers)."""
    out = [_pieces_of(x, d) for x, d in zip(leaves, dims)]
    if any(p is None for p in out):
        return None
    devs = [[canonical_device(t.device) for t in p] for p in out]
    if any(d != devs[0] for d in devs[1:]):
        return None
    return out


class _Spread(torch.autograd.Function):
    """``spread`` with its backward pinned: the cards' gradients summed on
    x's card in entry order ``0 .. n-1``, in float32, cast once (the
    mirror of ``row_sum``'s forward).  Autograd's own sum of the copies'
    gradients runs one thread per device and adds them as they arrive,
    in an order that varies from run to run."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.home, ctx.dtype = x.device, x.dtype
        copies: Dict[torch.device, torch.Tensor] = {}
        out = []
        for d in devices:
            key = canonical_device(d)
            if key in copies:
                out.append(copies[key].view_as(x))
            else:
                copies[key] = x.to(d)
                out.append(copies[key])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        acc = grads[0].to(ctx.home, torch.float32)
        for g in grads[1:]:
            acc = acc + g.to(ctx.home, torch.float32)
        return acc.to(ctx.dtype), None


def spread(x: torch.Tensor, devices: Sequence[torch.device]
           ) -> List[torch.Tensor]:
    """``x`` on each of ``devices``, copied once per distinct device; its
    gradient is the copies' summed on x's card in entry order, in
    float32 (``_Spread``)."""
    return list(_Spread.apply(x, tuple(devices)))


class _RowSum(torch.autograd.Function):
    """``row_sum``: the forward's fixed-order float32 sum; the backward
    hands each card its copy of the output gradient (one copy per
    distinct card), in its part's dtype."""

    @staticmethod
    def forward(ctx, dev, dtype, *parts):
        ctx.where = [(p.device, p.dtype) for p in parts]
        acc = parts[0].to(dev, torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(dev, torch.float32)
        return acc.to(dtype)

    @staticmethod
    def backward(ctx, g):
        copies: Dict[tuple, torch.Tensor] = {}
        out = []
        for dev, dtype in ctx.where:
            key = (canonical_device(dev), dtype)
            if key not in copies:
                copies[key] = g.to(dev, dtype)
            out.append(copies[key])
        return (None, None, *out)


def row_sum(parts: Sequence[torch.Tensor], dev, dtype) -> torch.Tensor:
    """Row-parallel reduction: the partial products summed on ``dev`` in
    entry order, in float32, cast to ``dtype`` once; its backward gives
    each part the output gradient on the part's card (``_RowSum``)."""
    return _RowSum.apply(dev, dtype, *parts)


def whole(x, dev) -> torch.Tensor:
    """Gather at use: a ``Placed`` leaf whole on ``dev`` (the home entry's
    piece itself where the leaf is whole there, no copy); a tensor as it
    is."""
    if not isinstance(x, Placed):
        return x
    layout = axis_pieces(x, AXIS)
    if layout is not None and (layout[0] is None
                               or len(layout[1]) == 1):
        for t in layout[1]:
            if canonical_device(t.device) == canonical_device(dev):
                return t
    return gather(x, dev)


def on(x, dev) -> torch.Tensor:
    """A leaf read whole on ``dev`` (a replicated piece there, or a
    copy)."""
    return whole(x, dev).to(dev)


def _cast(w: torch.Tensor, dtype) -> torch.Tensor:
    return w if dtype is None else w.to(dtype)


def _spreads(x: torch.Tensor):
    """``spread`` of ``x`` memoised by the devices asked for, so that the
    column products of one call copy ``x`` to a card once."""
    done: Dict[tuple, List[torch.Tensor]] = {}

    def get(devices):
        key = tuple(canonical_device(d) for d in devices)
        if key not in done:
            done[key] = spread(x, devices)
        return done[key]
    return get


def _product(x, w, dtype, spread_x) -> torch.Tensor:
    if not isinstance(w, Placed):
        return x @ _cast(w, dtype)
    dev, nd = x.device, len(w.shape)
    cols = _pieces_of(w, nd - 1)
    if cols is not None and len(cols) > 1:
        xs = spread_x([t.device for t in cols])
        return torch.cat([(xk @ _cast(wk, dtype)).to(dev)
                          for xk, wk in zip(xs, cols)], dim=-1)
    rows = _pieces_of(w, nd - 2) if nd > 1 else None
    if rows is not None and len(rows) > 1:
        parts = [xk.to(wk.device) @ _cast(wk, dtype) for xk, wk in zip(
            x.split([t.shape[0] for t in rows], dim=-1), rows)]
        return row_sum(parts, dev, parts[0].dtype)
    return x @ _cast(on(w, dev), dtype)


def matmul(x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """``x @ w`` on x's card (``w`` cast to ``dtype`` first, where given).

    A ``w`` split by ``model`` along its last dim (by column) runs one
    product per card on a copy of ``x`` there, the outputs concatenated
    on x's card in entry order; along its first dim (by row), card k
    multiplies the column slice of ``x`` that its rows read and
    ``row_sum`` adds the partial products in entry order.  A tensor, a
    replicated leaf (x's card's own piece) and a leaf that another mesh
    axis splits too (gathered, ``whole``) give ``x @ w``."""
    return _product(x, w, dtype, _spreads(x))


def columns(x: torch.Tensor, ws: Sequence, dtype=None
            ) -> List[torch.Tensor]:
    """``[matmul(x, w) for w in ws]``, ``x`` copied to each card once for
    all the column products."""
    spread_x = _spreads(x)
    return [_product(x, w, dtype, spread_x) for w in ws]


def column_row(x: torch.Tensor, ups: Sequence, down, act,
               biases: Sequence = ()) -> torch.Tensor:
    """``act(x @ U_1 [+ b_1], ..., x @ U_m [+ b_m]) @ D``.  With every ``U``
    split by column and ``D`` by row over the same cards, card k applies
    ``act`` to its pieces' outputs (each plus its slice of the replicated
    bias ``b``, where ``biases`` gives one) and multiplies by its rows of
    ``D``, and ``row_sum`` adds the partial products on x's card in entry
    order, in x's dtype: the activation never leaves its card.  Leaves
    not split so take ``columns`` and ``matmul``."""
    dev = x.device
    ws = split(list(ups) + [down], [1] * len(ups) + [0])
    if ws is None:
        outs = columns(x, ups)
        for j, b in enumerate(biases):
            if b is not None:
                outs[j] = outs[j] + on(b, dev)
        return matmul(act(*outs), down)
    parts = []
    lo = 0
    for k, xk in enumerate(spread(x, [w.device for w in ws[0]])):
        width = ws[0][k].shape[-1]
        outs = []
        for j, w in enumerate(ws[:-1]):
            o = xk @ w[k]
            b = biases[j] if j < len(biases) else None
            if b is not None:
                o = o + on(b, xk.device)[lo:lo + width]
            outs.append(o)
        parts.append(act(*outs) @ ws[-1][k])
        lo += width
    return row_sum(parts, dev, x.dtype)


def by_head(fn, x: torch.Tensor, w, heads: int) -> torch.Tensor:
    """``fn(x, W)`` for a product that reads ``w`` (r, heads * c) as (r,
    heads, c) and ``x`` by head along dim 2 (MLA's absorbed decode): with
    ``w`` split by column over n cards that divide ``heads``, card k runs
    ``fn`` on its head group (x's heads [k heads/n, (k+1) heads/n) and its
    piece), the outputs joined along dim 2 in entry order on x's card.
    Raises where the pieces would split a head."""
    dev = x.device
    ws = _pieces_of(w, 1)
    if ws is None or len(ws) == 1:
        t = on(w, dev)
        return fn(x, t.reshape(t.shape[0], heads, -1))
    if heads % len(ws):
        raise ValueError(f"{heads} heads do not split into {len(ws)} "
                         f"pieces of whole heads")
    g = heads // len(ws)
    return torch.cat([
        fn(xk.to(wk.device), wk.reshape(wk.shape[0], g, -1)).to(dev)
        for xk, wk in zip(x.split(g, dim=2), ws)], dim=2)


def embedding(ids: torch.Tensor, w) -> torch.Tensor:
    """Rows ``ids`` of the table ``w`` (V, d) on ids' device.  A table
    split by ``model`` along its rows takes the vocab-parallel route:
    card k looks up the ids of its range [lo_k, lo_k + V/n) and writes
    zeros for the others, and the home card sums the n lookups in entry
    order (exact: one nonzero term)."""
    dev = ids.device
    ws = _pieces_of(w, 0)
    if ws is None:
        return F.embedding(ids, on(w, dev))
    out, lo = None, 0
    for idk, wk in zip(spread(ids, [t.device for t in ws]), ws):
        local = idk - lo
        mine = (local >= 0) & (local < wk.shape[0])
        e = F.embedding(torch.where(mine, local, 0), wk)
        e = torch.where(mine[..., None], e, 0).to(dev)
        out = e if out is None else out + e
        lo += wk.shape[0]
    return out


def logits(x: torch.Tensor, head, tied: bool) -> torch.Tensor:
    """``x @ lm_head`` (or ``x @ embed.T`` where ``tied``) on x's device.
    A head split along the vocabulary (lm_head's columns, embed's rows)
    takes the vocab-parallel route: one product per card on its piece,
    concatenated on the home card in entry order."""
    dev = x.device
    ws = _pieces_of(head, 0 if tied else 1)
    if ws is None:
        w = on(head, dev)
        return x @ (w.T if tied else w)
    parts = [xk @ (w.T if tied else w)
             for xk, w in zip(spread(x, [w.device for w in ws]), ws)]
    return torch.cat([p.to(dev) for p in parts], dim=-1)


def placed_along(mesh: Mesh, spec: PartitionSpec, shape, dtype,
                 pieces: Sequence[torch.Tensor]) -> Placed:
    """A ``Placed`` of global ``shape`` on ``mesh`` (one whose other axes
    have size 1, ``axis_mesh``) from its pieces along ``model``, in entry
    order."""
    arr = np.empty(mesh.devices.shape, dtype=object)
    ax = mesh.axis_names.index(AXIS)
    index = [0] * arr.ndim
    for k, t in enumerate(pieces):
        index[ax] = k
        arr[tuple(index)] = t
    return Placed(NamedSharding(mesh, spec), shape, dtype, arr)


def head_mesh(cfg, attn) -> Optional[Mesh]:
    """The entries along ``model`` on which a GQA block's heads run in
    groups (``layers.gqa_forward``'s head route): its ``wq|wk|wv`` split
    by column and ``wo`` by row over the same devices, and a KV-head
    count the entries divide.  None where the block takes the gather
    route."""
    ws = split([attn["wq"], attn["wk"], attn["wv"], attn["wo"]],
               (1, 1, 1, 0))
    if ws is None or cfg.n_kv_heads % len(ws[0]):
        return None
    return axis_mesh(attn["wq"].mesh, AXIS)
