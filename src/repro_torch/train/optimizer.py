"""AdamW with mixed precision and an optional gradient compression hook.

The JAX package's optimizer (``repro/train/optimizer.py``) in plain torch
ops on tensors.  It is not ``torch.optim.AdamW``: that one decays the
weights before the moment update and on every leaf, where this one adds
``weight_decay * p`` to the Adam direction, only on leaves of more than
one dimension, with the reference's warm-up + cosine schedule and global
norm clipping of the uncompressed gradients.

The state is a ``TrainState`` of trees shaped like the params: f32
master params, Adam's two moments, and the compression residual (0-d
zeros when compression is off).  The port's params hold one dict per
layer where the reference stacks the layers on a leading L axis, so a
leaf of the layer list counts one dimension more for the decay rule
(``fault.tree_stacks``).  ``adamw_update`` writes the new params and
moments into the state's tensors (JAX's are immutable and its step
donates them; updating in place keeps one copy of the state on the
card) and returns a state holding them.

A state placed by ``distributed.sharding.device_put`` (the reference's
train cell: params, ``mu`` and ``nu`` by ``param_pspecs``, ZeRO-3; step
and residuals ``P()``), or built by ``adamw_init`` from placed params,
holds ``Placed`` leaves.  Every piece is updated on its own card, the
clip scale and the learning rate copied to each card once; the global
norm counts each distinct block of a leaf once (its replicas are equal)
and sums the entries' partial squares on the home card (mesh entry 0's
device) in entry order.  Replicas, given one gradient, stay bitwise
equal.  Compression is refused there (``distributed.compression``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..distributed.compression import refuse_placed
from ..distributed.fault import tree_flatten, tree_map, tree_stacks
from ..distributed.sharding import (Placed, blocks, canonical_device, home,
                                    is_placed, map_pieces)

__all__ = ["TrainState", "AdamWConfig", "adamw_init", "adamw_update",
           "global_norm", "step_count"]

F32 = torch.float32


class TrainState(NamedTuple):
    step: torch.Tensor   # 0-d int32, steps taken
    params: Any          # f32 master
    mu: Any              # Adam's first moment (f32)
    nu: Any              # Adam's second moment (f32)
    compress_err: Any    # error-feedback residual (0-d zeros without one)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _each(fn, x):
    """``fn`` of a tensor, or of every piece of a ``Placed`` on its card."""
    return map_pieces(fn, x) if isinstance(x, Placed) else fn(x)


def adamw_init(params, with_compression: bool = False) -> TrainState:
    """A fresh state on the params' device (the card, for params made by
    ``models.init_params`` without ``device="cpu"``): an f32 copy of the
    params, zero moments, and a zero residual per leaf (full-shape with
    compression, 0-d without).  Params in pieces (``Placed``) give
    params, ``mu`` and ``nu`` placed like them, each piece made on its
    card, and the step and the 0-d residuals on the home card (mesh
    entry 0's device); compression is refused there."""
    leaves = tree_flatten(params)[0]
    if with_compression:
        refuse_placed(params, "adamw_init(with_compression=True)")
    device = home(leaves[0])

    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    def scalar(p):
        return torch.zeros((), dtype=F32, device=home(p))

    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=tree_map(lambda x: _each(
            lambda p: p.detach().to(F32).clone(), x), params),
        mu=tree_map(lambda x: _each(zeros, x), params),
        nu=tree_map(lambda x: _each(zeros, x), params),
        compress_err=tree_map(lambda x: _each(zeros, x) if with_compression
                              else scalar(x), params))


def step_count(step) -> torch.Tensor:
    """The step counter as a tensor on the home card (a ``Placed`` 0-d
    step, as ``device_put`` of a state places it, read at entry 0)."""
    return step.pieces.flat[0] if isinstance(step, Placed) else step


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to a tenth of ``lr`` (f32)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.  On a placed
    tree each distinct block counts once: every entry sums the squares
    of the blocks it holds first (``sharding.blocks``) on its card, and
    the home card adds those partial sums in entry order."""
    leaves = tree_flatten(tree)[0]
    if not is_placed(tree):
        return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32)))
                              for leaf in leaves))
    parts: Dict[tuple, torch.Tensor] = {}
    for x in leaves:
        for entries in blocks(x):
            e = entries[0]
            sq = torch.sum(torch.square(x.pieces[e].to(F32)))
            parts[e] = sq if e not in parts else parts[e] + sq
    dev = home(leaves[0])
    total = None
    for e in sorted(parts):
        t = parts[e].to(dev)
        total = t if total is None else total + t
    return torch.sqrt(total)


def adamw_update(state: TrainState, grads, cfg: AdamWConfig,
                 compress: Optional[Callable] = None) -> TrainState:
    """One AdamW step from ``grads`` (a tree like the params, any float
    dtype): clip by the global norm, compress (``compress(grads, err) ->
    (grads, err)``) if asked, update.  The state's params and moments are
    written in place; ``grads`` is left as it was.

    A placed state takes placed gradients (``Placed`` like its params,
    ``train.steps.loss_and_grads``): each entry's piece is updated on its
    card from that entry's gradient piece, with the step's scalars (the
    learning rate, the bias corrections and the clip scale, made on the
    home card) copied to each card once.  A placed step counter is
    advanced in place on every entry."""
    if compress is not None:
        refuse_placed(state.params, "adamw_update(compress=...)")
    step = step_count(state.step) + 1
    t = step.to(F32)
    lr = _schedule(cfg, t)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    new_err = state.compress_err
    if compress is not None:
        grads = tree_map(lambda g: g.to(F32) * scale, grads)
        grads, new_err = compress(grads, state.compress_err)
        scale = None

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    first = canonical_device(t.device)
    scalars = {first: (lr, bc1, bc2, scale)}

    def on(dev):
        """The step's scalars on ``dev``, copied there once."""
        key = canonical_device(dev)
        if key not in scalars:
            scalars[key] = tuple(None if x is None else x.to(dev)
                                 for x in scalars[first])
        return scalars[key]

    def update(p, g, m, v, r):
        lr, bc1, bc2, scale = on(p.device)
        g = g.to(F32) * scale if scale is not None else g
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        p_new = p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p * float(r > 1))
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)

    params = tree_flatten(state.params)[0]
    rank = [0] * len(params)
    for idx, stacked in tree_stacks(state.params):
        for i in idx:
            rank[i] = len(params[i].shape) + stacked
    for p, g, m, v, r in zip(params, tree_flatten(grads)[0],
                             tree_flatten(state.mu)[0],
                             tree_flatten(state.nu)[0], rank):
        if not isinstance(p, Placed):
            update(p, g, m, v, r)
            continue
        for i in np.ndindex(p.pieces.shape):
            update(p.pieces[i], g.pieces[i], m.pieces[i], v.pieces[i], r)
    new_step = step
    if isinstance(state.step, Placed):
        for i in np.ndindex(state.step.pieces.shape):
            piece = state.step.pieces[i]
            piece.copy_(step.to(piece.device))
        new_step = state.step
    return TrainState(step=new_step, params=state.params, mu=state.mu,
                      nu=state.nu, compress_err=new_err)
