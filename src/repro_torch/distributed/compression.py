"""Gradient compression with error feedback, the JAX package's
``repro/distributed/compression.py`` in torch ops.

Two schemes, both with error-feedback residuals (the compression error
is added back into the next step's gradient, Karimireddy et al. 2019):

  * ``int8_compress`` — per-tensor symmetric int8 quantization, modelled
    as quantize -> dequantize (round half to even, as ``jnp.round``);
  * ``topk_compress`` — keep the top-k fraction by magnitude (ties at the
    threshold are kept, so a tensor may keep more than k).

"Per tensor" means per tensor of the reference: the L per-layer leaves
at one path of the model's layer list are one stacked tensor there
(``fault.tree_stacks``), so they share one int8 scale and one top-k
threshold; a leaf that is 0-d in the reference passes through.  Both
return (grads, err) trees for ``train.optimizer.adamw_update``.

On a placed state (``Placed`` leaves, weights in pieces; the reference
takes one scale or threshold per tensor whatever its sharding, and XLA
reduces them over a sharded leaf) the scale and the threshold are the
whole tree's, bit for bit, and every piece is compressed on its card:

  * int8: each distinct block's ``|x|.max()`` (``sharding.blocks``; its
    replicas are equal) on its card, the maxes reduced on the home card
    (mesh entry 0's device) and the 0-d scale copied to each card; a max
    does not depend on order;
  * top-k: ``k`` from the stacked tensor's element count, the threshold
    the k-th largest ``|x|`` over one replica of each block, gathered on
    the home card (a replica counted twice would move it);
  * ``g + err``, the quantize-dequantize or the mask, and the new
    residual piece by piece: the replicas stay bitwise equal.  A 0-d
    residual (the reference cell's ``P()``) broadcasts; the new one is
    placed like the gradient.

A grads / residual pair that mixes ``Placed`` and whole leaves raises
``ValueError``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .fault import tree_flatten, tree_stacks, tree_unflatten
from .sharding import (Placed, blocks, canonical_device, home, is_placed,
                       map_pieces)

__all__ = ["int8_compress", "topk_compress", "compression_ratio"]


def _one_per_block(x) -> List[torch.Tensor]:
    """A tensor; of a ``Placed``, the first entry's piece of each distinct
    block (each element of the leaf once)."""
    if isinstance(x, Placed):
        return [x.pieces[e[0]] for e in blocks(x)]
    return [x]


def _copies(t: torch.Tensor) -> Callable[[torch.device], torch.Tensor]:
    """``t`` on a device, copied there once."""
    made: Dict[torch.device, torch.Tensor] = {canonical_device(t.device): t}

    def on(dev):
        key = canonical_device(dev)
        if key not in made:
            made[key] = t.to(dev)
        return made[key]
    return on


def _quant_dequant_int8(xs: List) -> List:
    dev = home(xs[0])
    scale = torch.stack([t.abs().max().to(dev) for x in xs
                         for t in _one_per_block(x)]).max() / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    on = _copies(scale)

    def qdq(t):
        s = on(t.device)
        return torch.clamp(torch.round(t / s), -127, 127) \
            .to(torch.int8).to(torch.float32) * s
    return [map_pieces(qdq, x) for x in xs]


def _top_fraction(xs: List, frac: float) -> List:
    dev = home(xs[0])
    flat = torch.cat([t.abs().reshape(-1).to(dev) for x in xs
                      for t in _one_per_block(x)])
    k = max(1, int(flat.shape[0] * frac))
    on = _copies(torch.topk(flat, k).values[-1])
    del flat
    return [map_pieces(lambda t: torch.where(t.abs() >= on(t.device), t,
                                             0.0), x) for x in xs]


def _error_feedback(fn: Callable, grads, err):
    """g' = fn(g + err) per stacked tensor; err' = (g + err) - g'."""
    is_placed((grads, err))           # all Placed or none
    g_leaves = tree_flatten(grads)[0]
    e_leaves = tree_flatten(err)[0]
    new_g, new_e = list(g_leaves), list(e_leaves)
    for idx, stacked in tree_stacks(grads):
        if len(g_leaves[idx[0]].shape) + stacked == 0:
            continue
        xs = [map_pieces(torch.add, g_leaves[i], e_leaves[i]) for i in idx]
        for i, x, y in zip(idx, xs, fn(xs)):
            new_g[i], new_e[i] = y, map_pieces(torch.sub, x, y)
    return tree_unflatten(grads, new_g), tree_unflatten(err, new_e)


def int8_compress(grads, err):
    """Error-feedback int8: g' = QDQ(g + err); err' = (g + err) - g'."""
    return _error_feedback(_quant_dequant_int8, grads, err)


def topk_compress(grads, err, frac: float = 0.1):
    """Error-feedback magnitude top-k (kept fraction ``frac``)."""
    return _error_feedback(lambda xs: _top_fraction(xs, frac), grads, err)


def compression_ratio(scheme: str, frac: float = 0.1) -> float:
    """Wire-bytes ratio vs an f32 all-reduce: int8 = 4x, top-k = 1/frac x
    (value + index pairs halve it)."""
    if scheme == "int8":
        return 4.0
    if scheme == "topk":
        return 1.0 / (2 * frac)
    return 1.0
