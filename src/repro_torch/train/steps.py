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
  * optional gradient compression (error feedback) before AdamW;
  * with ``dp_axes`` and ``mesh`` (the reference's ``dp_axes``, whose
    mesh comes from its ``jit``), data parallelism on a single
    controller: every microbatch's rows split contiguously over the
    mesh's entries along those axes (``P(None, dp_axes)`` on the
    microbatched batch), each block's forward and backward on its
    entry's device with a copy of the cast params placed there once per
    step, the blocks' losses and gradients brought back to the state's
    device and averaged in data order.  Accumulation, clipping,
    compression and AdamW stay on the state's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.fault import tree_flatten, tree_unflatten
from ..distributed.sharding import canonical_device
from ..models import (decode_step, forward_prefill, forward_train,
                      model_input_spec)
from .optimizer import AdamWConfig, TrainState, adamw_update, global_norm

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "train_batch_spec", "default_n_micro", "loss_and_grads",
           "dp_devices"]


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


def dp_devices(mesh, dp_axes: Sequence[str]) -> list:
    """The device of every data block of ``P(None, dp_axes)``: the mesh's
    entries along ``dp_axes`` (the first axis major, as a spec names
    them), at index 0 of its other axes."""
    missing = [a for a in dp_axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"mesh {dict(mesh.shape)} has no axes {missing}")
    names = mesh.axis_names
    other = [a for a in names if a not in dp_axes]
    devs = np.transpose(mesh.devices, [names.index(a) for a in dp_axes]
                        + [names.index(a) for a in other])
    return list(devs.reshape(int(np.prod([mesh.shape[a] for a in dp_axes])),
                             -1)[:, 0])


def loss_and_grads(cfg: ArchConfig, params, batch, n_micro: int = 1,
                   compute_dtype=torch.bfloat16,
                   use_kernel: Optional[bool] = None,
                   devices: Optional[Sequence[torch.device]] = None):
    """(loss, grads) of one global batch without an update (the train
    step's first half; ``use_kernel=False`` runs the plain versions).

    The gradients are of the params cast to ``compute_dtype``: with one
    microbatch they come back in that dtype; with ``n_micro`` > 1 they
    are summed in f32 over the microbatches (rows ``i*B/n .. (i+1)*B/n``
    of every batch input: tokens, and VLM ``patches`` / audio
    ``frames``) and divided by ``n_micro``, as the loss is.  A leaf the
    loss does not reach (an audio encoder layer's ``xattn`` / ``norm_x``,
    which the reference allocates and never reads) gets zeros, as
    ``jax.grad`` gives it.

    ``devices`` (``dp_devices``; more than one): each microbatch's rows
    split into ``len(devices)`` contiguous blocks, block j's forward and
    backward on ``devices[j]`` against a copy of the cast params placed
    there once per call; every block's loss and gradients come back to
    the params' device in f32 and are averaged in data order, within and
    over the microbatches.  Every family gives every row of a batch the
    same number of loss positions (``label_mask`` is the batch's, a VLM
    prefix on every row), so the mean of the equal blocks' mean losses is
    the microbatch's, and so are the gradients.  MoE layers are refused:
    ``moe_capacity`` would count a block's tokens, not the
    microbatch's."""
    leaves = tree_flatten(params)[0]
    cast = [p.detach().to(compute_dtype).requires_grad_() for p in leaves]
    params_c = tree_unflatten(params, cast)
    if devices is not None and len(devices) > 1:
        return _dp_loss_and_grads(cfg, params, cast, batch, n_micro,
                                  use_kernel, devices)
    with torch.enable_grad():
        if n_micro == 1:
            loss, _ = forward_train(cfg, params_c, batch,
                                    use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, cast, materialize_grads=True)
            return loss.detach(), tree_unflatten(params, list(grads))
        mb = _micro_rows(batch, n_micro)
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


def _micro_rows(batch, n_micro: int) -> int:
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch of {b} rows does not split into "
                         f"{n_micro} microbatches")
    return b // n_micro


def _refuse_moe(cfg: ArchConfig, n_dp: int) -> None:
    if cfg.moe is not None and n_dp > 1:
        raise ValueError(
            f"{cfg.name}: MoE under data parallelism over {n_dp} blocks: "
            f"moe_capacity would be sized from a block's tokens, not the "
            f"microbatch's as in the reference's partitioned step")


def _dp_loss_and_grads(cfg, params, cast, batch, n_micro, use_kernel,
                       devices):
    n_dp = len(devices)
    _refuse_moe(cfg, n_dp)
    home = cast[0].device
    mb = _micro_rows(batch, n_micro)
    if mb % n_dp:
        raise ValueError(f"a microbatch of {mb} rows does not split into "
                         f"{n_dp} data blocks")
    bl = mb // n_dp
    # the cast params once on every data device (the home device's own)
    devices = [canonical_device(d) for d in devices]
    on_dev = {}
    for dev in devices:
        if dev not in on_dev:
            on_dev[dev] = cast if dev == canonical_device(home) else [
                c.detach().to(dev).requires_grad_() for c in cast]
    acc = [torch.zeros(c.shape, dtype=torch.float32, device=home)
           for c in cast]
    loss_acc = torch.zeros((), dtype=torch.float32, device=home)
    with torch.enable_grad():
        for i in range(n_micro):
            for j, dev in enumerate(devices):
                lo = i * mb + j * bl
                block = {k: v[lo:lo + bl].to(dev) for k, v in batch.items()}
                leaves_j = on_dev[dev]
                loss, _ = forward_train(cfg, tree_unflatten(params, leaves_j),
                                        block, use_kernel=use_kernel)
                for a, g in zip(acc, torch.autograd.grad(
                        loss, leaves_j, materialize_grads=True)):
                    a.add_(g.to(device=home, dtype=torch.float32))
                loss_acc = loss_acc + loss.detach().to(home)
    for a in acc:
        a.div_(n_micro * n_dp)
    return loss_acc / (n_micro * n_dp), tree_unflatten(params, acc)


def build_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                     n_micro: int = 1, compress: Optional[Callable] = None,
                     compute_dtype=torch.bfloat16,
                     dp_axes: Optional[Tuple[str, ...]] = None, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` is
    {"tokens": (B, S) int tensor} (+ ``"patches"`` for VLM, ``"frames"``
    for audio; ``train_batch_spec``) on the state's device.  The state's
    tensors are updated in place (``adamw_update``).  Metrics: the loss
    (f32), the global norm of the unclipped gradients and the new step,
    as 0-d tensors on the device (no host sync).

    ``dp_axes`` (with ``mesh``, a ``distributed.sharding.Mesh``): the
    mesh axes carrying the batch, as the reference's; every microbatch's
    rows run in ``dp_devices(mesh, dp_axes)`` blocks (``loss_and_grads``'
    ``devices``; the gradients then come back f32 even with one
    microbatch).  An MoE config with more than one block raises
    ``ValueError``."""
    opt_cfg = opt_cfg or AdamWConfig()
    devices = None
    if dp_axes is not None:
        if mesh is None:
            raise ValueError("dp_axes needs the mesh that carries them")
        devices = dp_devices(mesh, tuple(dp_axes))
        _refuse_moe(cfg, len(devices))

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = loss_and_grads(cfg, state.params, batch, n_micro,
                                     compute_dtype, devices=devices)
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
