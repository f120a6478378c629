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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..distributed.fault import tree_flatten, tree_map, tree_stacks

__all__ = ["TrainState", "AdamWConfig", "adamw_init", "adamw_update",
           "global_norm"]

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


def adamw_init(params, with_compression: bool = False) -> TrainState:
    """A fresh state on the params' device (the card, for params made by
    ``models.init_params`` without ``device="cpu"``): an f32 copy of the
    params, zero moments, and a zero residual per leaf (full-shape with
    compression, 0-d without)."""
    leaves = tree_flatten(params)[0]
    device = leaves[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    def scalar(p):
        return torch.zeros((), dtype=F32, device=p.device)

    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=tree_map(lambda p: p.detach().to(F32).clone(), params),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        compress_err=tree_map(zeros if with_compression else scalar,
                              params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to a tenth of ``lr`` (f32)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32)))
                          for leaf in tree_flatten(tree)[0]))


def adamw_update(state: TrainState, grads, cfg: AdamWConfig,
                 compress: Optional[Callable] = None) -> TrainState:
    """One AdamW step from ``grads`` (a tree like the params, any float
    dtype): clip by the global norm, compress (``compress(grads, err) ->
    (grads, err)``) if asked, update.  The state's params and moments are
    written in place; ``grads`` is left as it was."""
    step = state.step + 1
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
    params = tree_flatten(state.params)[0]
    rank = [0] * len(params)
    for idx, stacked in tree_stacks(state.params):
        for i in idx:
            rank[i] = params[i].dim() + stacked
    for p, g, m, v, r in zip(params, tree_flatten(grads)[0],
                             tree_flatten(state.mu)[0],
                             tree_flatten(state.nu)[0], rank):
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
    return TrainState(step=step, params=state.params, mu=state.mu,
                      nu=state.nu, compress_err=new_err)
