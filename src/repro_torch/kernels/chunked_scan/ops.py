"""Public op: first-order linear recurrence with kernel/plain dispatch
(``kernels.dispatch``): the CUDA kernels for tensors on the card, the
plain versions for tensors on the CPU.  The op is differentiable: a
``torch.autograd.Function`` whose backward runs ``linear_scan_bwd_cuda``
or ``linear_scan_bwd_ref`` on the route the forward took.  Tensors on
``meta`` take neither: both passes return outputs of the right shape.
``cost`` is a call's least work."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import dispatch
from .kernel import linear_scan_bwd_cuda, linear_scan_cuda
from .ref import linear_scan_bwd_ref, linear_scan_ref

__all__ = ["linear_scan", "pad_to_chunk", "cost"]


def cost(n: int, backward: bool = False) -> dispatch.KernelCost:
    """Least work of one scan over ``n`` elements: forward, a and b read
    once and y written once, a multiply and an add per element; backward,
    a, y and g read once and da, db written once, a multiply and an add
    for the adjoint and a multiply for da per element.  No contraction."""
    if backward:
        return dispatch.KernelCost(5 * n * 4, 3 * n, 0)
    return dispatch.KernelCost(3 * n * 4, 2 * n, 0)


def pad_to_chunk(a: torch.Tensor, b: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the time axis (-2) of ``a``/``b`` to a multiple of ``chunk``
    with a = 1, b = 0: padding steps are exact no-ops of the recurrence
    (the reference's rule, ``repro/kernels/chunked_scan/ops.py``)."""
    pad = (-a.shape[-2]) % chunk
    if not pad:
        return a, b
    shape = a.shape[:-2] + (pad, a.shape[-1])
    ones = torch.ones(shape, dtype=a.dtype, device=a.device)
    return (torch.cat([a, ones], dim=-2),
            torch.cat([b, torch.zeros_like(ones)], dim=-2))


class _LinearScan(torch.autograd.Function):
    """y = scan(a, b) on one route, its gradients on the same route.

    The kernel route pads T to a multiple of ``chunk`` inside the forward
    (a = 1, b = 0: exact no-ops), saves the padded ``a`` and ``y``, pads
    the upstream gradient with zeros in the backward and cuts the padded
    steps' gradients off.  The plain route saves ``a`` and ``y`` as they
    are."""

    @staticmethod
    def forward(ctx, a, b, kernel: bool, chunk: int):
        t = a.shape[-2]
        ctx.kernel, ctx.t, ctx.n = kernel, t, a.numel()
        ctx.dtypes = (a.dtype, b.dtype)
        with dispatch.kernel_cost("linear_scan", cost(ctx.n)):
            a32, b32 = a.to(torch.float32), b.to(torch.float32)
            if dispatch.is_meta(a32):
                y = torch.empty_like(a32)
            elif kernel:
                a32, b32 = pad_to_chunk(a32, b32, chunk)
                a32 = a32.contiguous()
                y = linear_scan_cuda(a32, b32.contiguous())
            else:
                y = linear_scan_ref(a32, b32)
            ctx.save_for_backward(a32, y)
            return y[..., :t, :].clone() if y.shape[-2] != t else y

    @staticmethod
    def backward(ctx, g):
        a32, y = ctx.saved_tensors
        t = ctx.t
        with dispatch.kernel_cost("linear_scan_bwd", cost(ctx.n, True)):
            g = g.to(torch.float32)
            if dispatch.is_meta(g):
                da, db = torch.empty_like(a32), torch.empty_like(a32)
            elif ctx.kernel:
                pad = y.shape[-2] - t
                if pad:
                    g = torch.cat([g, g.new_zeros(g.shape[:-2] + (pad,) +
                                                  g.shape[-1:])], dim=-2)
                da, db = linear_scan_bwd_cuda(a32, y, g.contiguous())
                da, db = da[..., :t, :], db[..., :t, :]
            else:
                da, db = linear_scan_bwd_ref(a32, y, g)
            da_dtype, db_dtype = ctx.dtypes
            return (da.to(da_dtype) if ctx.needs_input_grad[0] else None,
                    db.to(db_dtype) if ctx.needs_input_grad[1] else None,
                    None, None)


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                use_kernel: Optional[bool] = None,
                chunk: int = 128) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + b_t over the -2 axis, from a zero state.

    a, b: (T, D) or (B, T, D), computed in float32, differentiable in
    both.  The kernel path pads T to a multiple of ``chunk``
    (``pad_to_chunk``) and slices the padding off again, as the
    reference's Pallas path does.
    """
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two, got {chunk}")
    kernel = not dispatch.is_meta(a) and dispatch.resolve(use_kernel, a)
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    y = _LinearScan.apply(a, b, kernel, chunk)
    return y[0] if squeeze else y
