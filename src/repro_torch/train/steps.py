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
    compression and AdamW stay on the state's device;
  * on a state placed by ``distributed.sharding.device_put`` (the
    reference's train cell: params, ``mu`` and ``nu`` by
    ``param_pspecs``, ZeRO-3), weights in pieces: each piece is cast to
    the compute dtype on its own card once per step, the forward and
    backward read the pieces where they lie (``models.tensor_parallel``:
    the vocab-parallel embedding and logits, GQA head groups, SwiGLU and
    expert pieces on their cards, any other layout gathered for its
    layer and recomputed with it), each piece's gradient is summed over
    the microbatches in f32 on its card, and a block's gradient is the
    sum of its replicas' in entry order.  With ``dp_axes`` data block
    ``j`` runs on the pieces of row ``j`` of the mesh (a leaf that the
    data axes split is gathered whole for it).  AdamW updates every
    piece on its card (``train.optimizer``), so the step returns the
    same ``Placed`` leaves, updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.fault import tree_flatten, tree_unflatten
from ..distributed.sharding import (Placed, blocks, canonical_device,
                                    is_placed, map_pieces, mesh_rows,
                                    same_mesh, take_row)
from ..models import (decode_step, forward_prefill, forward_train,
                      model_input_spec)
from .optimizer import (AdamWConfig, TrainState, adamw_update, global_norm,
                        step_count)

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
    them), at index 0 of its other axes (the first entry of each of
    ``sharding.mesh_rows``)."""
    return [row.devices.flat[0] for _, row in mesh_rows(mesh, dp_axes)]


def loss_and_grads(cfg: ArchConfig, params, batch, n_micro: int = 1,
                   compute_dtype=torch.bfloat16,
                   use_kernel: Optional[bool] = None,
                   devices: Optional[Sequence[torch.device]] = None,
                   dp_axes: Optional[Sequence[str]] = None):
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
    microbatch's.

    Params in pieces (every leaf ``Placed``): ``_placed_loss_and_grads``,
    the gradients ``Placed`` like the params, in f32; ``dp_axes`` (not
    ``devices``) names the mesh axes whose rows take the data blocks."""
    if is_placed(params):
        if devices is not None:
            raise ValueError("params in pieces run their data blocks on "
                             "the rows of their own mesh: pass dp_axes, "
                             "not devices")
        return _placed_loss_and_grads(cfg, params, batch, n_micro,
                                      compute_dtype, use_kernel,
                                      tuple(dp_axes or ()))
    if dp_axes:
        raise ValueError("dp_axes reads the mesh of params in pieces; "
                         "whole params take devices (dp_devices)")
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


def _placed_loss_and_grads(cfg, params, batch, n_micro, compute_dtype,
                           use_kernel, dp_axes):
    """``loss_and_grads`` on params in pieces.

    Every piece is cast to ``compute_dtype`` on its card (once) and is an
    input of the backward.  The microbatch's rows split into one block
    per row of the mesh along ``dp_axes`` (``sharding.mesh_rows``; one
    block, the whole mesh, without them); block j's forward and backward
    read row j's pieces (``take_row``; a leaf that the data axes split is
    read whole, gathered from its pieces) with the activations on the
    row's first entry's device.  Each piece's gradient is summed in f32
    on its card over the microbatches; then each block of a leaf
    (``sharding.blocks``) sums its replicas' gradients in entry order
    (data order) on its first entry's card, divides by the number of
    blocks run, and hands every replica its copy.  The losses come back
    to mesh entry 0's device and are averaged in data order.

    The backward runs on the calling thread
    (``torch.autograd.set_multithreading_enabled(False)``): a layer's
    work spans cards, and the autograd engine's per-device threads could
    otherwise each start ``torch.utils.checkpoint``'s recompute of one
    layer at once (its non-reentrant recompute takes no lock, and the
    count of recomputed tensors overruns).  One thread also fixes the
    order in which every gradient is accumulated."""
    leaves = tree_flatten(params)[0]
    mesh = leaves[0].mesh
    if any(x.mesh is not mesh for x in leaves):
        raise ValueError("params in pieces on more than one mesh")
    rows = mesh_rows(mesh, dp_axes)
    n_dp = len(rows)
    _refuse_moe(cfg, n_dp)
    mb = _micro_rows(batch, n_micro)
    if mb % n_dp:
        raise ValueError(f"a microbatch of {mb} rows does not split into "
                         f"{n_dp} data blocks")
    bl = mb // n_dp
    cast = [map_pieces(lambda t: t.detach().to(compute_dtype)
                       .requires_grad_(), x) for x in leaves]
    entry = np.empty(mesh.devices.shape, dtype=object)
    for e in np.ndindex(entry.shape):
        entry[e] = e
    # per row: the tree its block reads, the (leaf, entry) pieces that
    # take its gradients, and the device of its activations
    views = []
    for index, row in rows:
        tree, inputs = [], []
        for li, x in enumerate(cast):
            v = take_row(x, index, row)
            tree.append(x if v is None else v)
            inputs += [(li, e) for e in
                       (entry if v is None else entry[index]).flat]
        views.append((tree_unflatten(params, tree), inputs,
                      row.devices.flat[0]))
    home = mesh.devices.flat[0]
    acc: Dict[tuple, torch.Tensor] = {}
    loss_acc = torch.zeros((), dtype=torch.float32, device=home)
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(
            False):
        for i in range(n_micro):
            for j, (tree, inputs, dev) in enumerate(views):
                lo = i * mb + j * bl
                block = {k: v[lo:lo + bl].to(dev) for k, v in batch.items()}
                loss, _ = forward_train(cfg, tree, block,
                                        use_kernel=use_kernel)
                grads = torch.autograd.grad(
                    loss, [cast[li].pieces[e] for li, e in inputs],
                    materialize_grads=True)
                for key, g in zip(inputs, grads):
                    g = g.to(torch.float32)
                    if key in acc:
                        acc[key].add_(g)
                    else:
                        acc[key] = g
                loss_acc = loss_acc + loss.detach().to(home)
    del views
    return (loss_acc / (n_micro * n_dp),
            tree_unflatten(params, [_block_grads(x, li, acc, n_micro * n_dp)
                                    for li, x in enumerate(cast)]))


def _block_grads(x: Placed, li: int, acc, div: int) -> Placed:
    """Leaf ``li``'s gradient, placed like ``x``: per block, its entries'
    f32 sums added in entry order on the block's first card, divided by
    ``div``, one copy per card that holds the block."""
    pieces = np.empty(x.pieces.shape, dtype=object)
    for entries in blocks(x):
        first = x.pieces[entries[0]]
        total = None
        for e in entries:
            g = acc.pop((li, e), None)
            if g is not None:
                g = g.to(first.device)
                total = g if total is None else total + g
        if total is None:
            total = torch.zeros(first.shape, dtype=torch.float32,
                                device=first.device)
        total = total / div
        copies = {}
        for e in entries:
            dev = x.pieces[e].device
            key = canonical_device(dev)
            if key not in copies:
                copies[key] = total.to(dev)
            pieces[e] = copies[key]
    return Placed(x.sharding, x.shape, torch.float32, pieces)


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
    ``ValueError``.

    A state in pieces (``device_put`` of a state placed by
    ``param_pspecs``, or ``adamw_init`` of placed params) steps as it is
    placed: ``mesh`` must be its params' mesh, whose rows along
    ``dp_axes`` take the data blocks; compression is refused there
    (``adamw_update``).
    The returned state holds the same ``Placed`` leaves, updated in
    place, and the metrics stay on the home card (mesh entry 0's
    device)."""
    opt_cfg = opt_cfg or AdamWConfig()
    devices = None
    if dp_axes is not None:
        if mesh is None:
            raise ValueError("dp_axes needs the mesh that carries them")
        devices = dp_devices(mesh, tuple(dp_axes))
        _refuse_moe(cfg, len(devices))

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if is_placed(state.params):
            placed_on = tree_flatten(state.params)[0][0].mesh
            if mesh is not None and not same_mesh(mesh, placed_on):
                raise ValueError(f"the step's mesh {mesh} is not the mesh "
                                 f"of the state's pieces {placed_on}")
            loss, grads = loss_and_grads(cfg, state.params, batch, n_micro,
                                         compute_dtype, dp_axes=dp_axes)
        else:
            loss, grads = loss_and_grads(cfg, state.params, batch, n_micro,
                                         compute_dtype, devices=devices)
        new_state = adamw_update(state, grads, opt_cfg, compress=compress)
        metrics = {"loss": loss.to(torch.float32),
                   "grad_norm": global_norm(grads),
                   "step": step_count(new_state.step).clone()}
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
