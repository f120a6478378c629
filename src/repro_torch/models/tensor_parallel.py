"""Products on weights in pieces: the model side of a parameter tree
placed by ``param_pspecs`` (``distributed.sharding.device_put``).

The reference has no counterpart: it jits its steps on a tree placed by
``named_shardings(param_pspecs(...))`` and XLA's partitioner splits each
product and inserts the collectives.  The port is single-controller (one
process drives every card of the mesh, as in ``models.sharded_decode``),
so the splits are explicit here, each on the pieces that
``sharding.axis_pieces`` reads along the mesh axis ``model``:

* **column-parallel**: ``x`` copied once to each card (``spread``), ``x @
  W_k`` there, the output left on its card (``wq|wk|wv``, ``w_gate``,
  ``w_up``, ``shared_gate|shared_up``; ``split`` reads their pieces);
* **row-parallel** (``row_sum``): the partial ``(..., d)`` products of the
  cards summed on the home card in entry order ``0 .. n-1``, accumulated
  in float32 and cast once (``wo``, ``w_down``, ``shared_down``): a fixed
  order, no atomics, no collective library;
* **vocab-parallel embedding** (``embedding``): each card looks up the
  ids in its row range and zeroes the others; the home card sums in
  entry order, which is exact (one nonzero term per element);
* **vocab-parallel logits** (``logits``): ``lm_head``'s column pieces, or
  ``embed.T``'s where the embeddings are tied, concatenated on the home
  card;
* **gather at use** (``whole``) for every other layout (a ``data`` axis of
  size > 1, ``auto``'s choices, the leaves of the families whose layers
  read no pieces): the leaf is whole on the computing card for the call
  that reads it and freed after it, the ZeRO-3 way.  It costs memory, not
  bits.

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

from ..distributed.fault import tree_flatten, tree_unflatten
from ..distributed.sharding import (Mesh, NamedSharding, PartitionSpec,
                                    Placed, axis_mesh, axis_pieces,
                                    canonical_device, gather)

__all__ = ["AXIS", "HEAD_SPEC", "home", "tree_home", "split", "spread",
           "row_sum", "embedding", "logits", "whole", "whole_tree", "on",
           "placed_along", "map_pieces", "head_mesh"]

AXIS = "model"
# a (B, S, Hkv, D) KV cache split by KV head: card k holds heads
# [k Hkv/n, (k + 1) Hkv/n), the head group its attention computes
HEAD_SPEC = PartitionSpec(None, None, AXIS, None)


def home(x) -> torch.device:
    """The device a leaf's consumer computes on: mesh entry 0's device of
    a ``Placed``, a tensor's own."""
    return x.pieces.flat[0].device if isinstance(x, Placed) else x.device


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


def spread(x: torch.Tensor, devices: Sequence[torch.device]
           ) -> List[torch.Tensor]:
    """``x`` on each of ``devices``, copied once per distinct device."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        key = canonical_device(d)
        if key not in copies:
            copies[key] = x.to(d)
        out.append(copies[key])
    return out


def row_sum(parts: Sequence[torch.Tensor], dev, dtype) -> torch.Tensor:
    """Row-parallel reduction: the partial products summed on ``dev`` in
    entry order, in float32, cast to ``dtype`` once."""
    acc = parts[0].to(dev, torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(dev, torch.float32)
    return acc.to(dtype)


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


def whole_tree(tree, dev):
    """``whole`` over every leaf of a tree."""
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [whole(x, dev) for x in leaves])


def on(x, dev) -> torch.Tensor:
    """A leaf read whole on ``dev`` (a replicated piece there, or a
    copy)."""
    return whole(x, dev).to(dev)


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


def map_pieces(fn, x: Placed, shape) -> Placed:
    """A ``Placed`` of global ``shape`` on ``x``'s mesh and spec whose
    pieces are ``fn`` of ``x``'s, entry by entry."""
    arr = np.empty(x.pieces.shape, dtype=object)
    for i in np.ndindex(arr.shape):
        arr[i] = fn(x.pieces[i])
    return Placed(x.sharding, shape, x.dtype, arr)


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
