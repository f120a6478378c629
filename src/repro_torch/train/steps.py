"""Step builders: the microbatched, mixed-precision train step and the
serving steps, as in the JAX package's ``repro/train/steps.py``.

``build_train_step(cfg)`` returns ``(state, batch) -> (state, metrics)``:

  * the f32 master params are cast to the compute dtype once per step,
    and the cast copies are the leaves the gradients are taken of (the
    reference differentiates the cast copy too: bf16 gradients);
  * ``n_micro`` contiguous row blocks of the batch run forward and
    backward one after another, their gradients accumulated in f32 and
    their losses averaged (activation memory scales with the
    microbatch);
  * remat per layer inside ``models.forward_train``;
  * optional gradient compression (error feedback) before AdamW.

The reference's ``dp_axes`` (a sharding constraint on the microbatches
for its mesh) has no counterpart: the port trains on one card.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.fault import tree_flatten, tree_unflatten
from ..models import (decode_step, forward_prefill, forward_train,
                      model_input_spec)
from .optimizer import AdamWConfig, TrainState, adamw_update, global_norm

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "train_batch_spec", "default_n_micro", "loss_and_grads"]


def default_n_micro(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Microbatch count keeping per-device residuals ~< 8 GB on the
    reference's production mesh (16-way DP): residual/layer/device =
    (mb/16) * seq * d_model * 2B."""
    if shape.kind != "train":
        return 1
    budget = 6e9
    per_seq_layer = shape.seq_len * cfg.d_model * 2
    total = shape.global_batch * per_seq_layer * cfg.n_layers / 16
    n = 1
    while total / n > budget and n < shape.global_batch:
        n *= 2
    return min(n, shape.global_batch)


def loss_and_grads(cfg: ArchConfig, params, batch, n_micro: int = 1,
                   compute_dtype=torch.bfloat16,
                   use_kernel: Optional[bool] = None):
    """(loss, grads) of one global batch without an update (the train
    step's first half; ``use_kernel=False`` runs the plain versions).

    The gradients are of the params cast to ``compute_dtype``: with one
    microbatch they come back in that dtype; with ``n_micro`` > 1 they
    are summed in f32 over the microbatches (rows ``i*B/n .. (i+1)*B/n``
    of every batch input: tokens, and VLM ``patches`` / audio
    ``frames``) and divided by ``n_micro``, as the loss is.  A leaf the
    loss does not reach (an audio encoder layer's ``xattn`` / ``norm_x``,
    which the reference allocates and never reads) gets zeros, as
    ``jax.grad`` gives it."""
    leaves = tree_flatten(params)[0]
    cast = [p.detach().to(compute_dtype).requires_grad_() for p in leaves]
    params_c = tree_unflatten(params, cast)
    with torch.enable_grad():
        if n_micro == 1:
            loss, _ = forward_train(cfg, params_c, batch,
                                    use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, cast, materialize_grads=True)
            return loss.detach(), tree_unflatten(params, list(grads))
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{n_micro} microbatches")
        mb = b // n_micro
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _ = forward_train(cfg, params_c, micro,
                                    use_kernel=use_kernel)
            for a, g in zip(acc, torch.autograd.grad(
                    loss, cast, materialize_grads=True)):
                a.add_(g.to(torch.float32))
            loss_acc = loss_acc + loss.detach()
    for a in acc:
        a.div_(n_micro)
    return loss_acc / n_micro, tree_unflatten(params, acc)


def build_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                     n_micro: int = 1, compress: Optional[Callable] = None,
                     compute_dtype=torch.bfloat16):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` is
    {"tokens": (B, S) int tensor} (+ ``"patches"`` for VLM, ``"frames"``
    for audio; ``train_batch_spec``) on the state's device.  The state's
    tensors are updated in place (``adamw_update``).  Metrics: the loss
    (f32), the global norm of the unclipped gradients and the new step,
    as 0-d tensors on the device (no host sync)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = loss_and_grads(cfg, state.params, batch, n_micro,
                                     compute_dtype)
        new_state = adamw_update(state, grads, opt_cfg, compress=compress)
        metrics = {"loss": loss.to(torch.float32),
                   "grad_norm": global_norm(grads),
                   "step": new_state.step}
        return new_state, metrics

    return train_step


def build_prefill_step(cfg: ArchConfig, cache_capacity: Optional[int] = None):
    def prefill_step(params, batch):
        return forward_prefill(cfg, params, batch,
                               cache_capacity=cache_capacity)
    return prefill_step


def build_decode_step(cfg: ArchConfig):
    def serve_step(params, state, token):
        return decode_step(cfg, params, state, token)
    return serve_step


def train_batch_spec(cfg: ArchConfig, shape: ShapeSpec):
    """{name: (shape, dtype)} of a train batch: the tokens, and the VLM
    family's bf16 ``patches`` or the audio family's bf16 ``frames`` (the
    labels are the shifted tokens, taken in the loss)."""
    return model_input_spec(cfg, shape)
