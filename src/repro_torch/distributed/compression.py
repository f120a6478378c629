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
"""

from __future__ import annotations

from typing import Callable, List

import torch

from .fault import tree_flatten, tree_stacks, tree_unflatten

__all__ = ["int8_compress", "topk_compress", "compression_ratio"]


def _quant_dequant_int8(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    scale = torch.stack([x.abs().max() for x in xs]).max() / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    return [torch.clamp(torch.round(x / scale), -127, 127)
            .to(torch.int8).to(torch.float32) * scale for x in xs]


def _top_fraction(xs: List[torch.Tensor], frac: float
                  ) -> List[torch.Tensor]:
    flat = torch.cat([x.abs().reshape(-1) for x in xs])
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return [torch.where(x.abs() >= thresh, x, 0.0) for x in xs]


def _error_feedback(fn: Callable, grads, err):
    """g' = fn(g + err) per stacked tensor; err' = (g + err) - g'."""
    g_leaves = tree_flatten(grads)[0]
    e_leaves = tree_flatten(err)[0]
    new_g, new_e = list(g_leaves), list(e_leaves)
    for idx, stacked in tree_stacks(grads):
        if g_leaves[idx[0]].dim() + stacked == 0:
            continue
        xs = [g_leaves[i] + e_leaves[i] for i in idx]
        for i, x, y in zip(idx, xs, fn(xs)):
            new_g[i], new_e[i] = y, x - y
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
