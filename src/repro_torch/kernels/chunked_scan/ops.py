"""Public op: first-order linear recurrence with kernel/plain dispatch
(``kernels.dispatch``): the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import dispatch
from .kernel import linear_scan_cuda
from .ref import linear_scan_ref

__all__ = ["linear_scan", "pad_to_chunk"]


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


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                use_kernel: Optional[bool] = None,
                chunk: int = 128) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + b_t over the -2 axis, from a zero state.

    a, b: (T, D) or (B, T, D), computed in float32.  The kernel path
    pads T to a multiple of ``chunk`` (``pad_to_chunk``) and slices the
    padding off again, as the reference's Pallas path does.
    """
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two, got {chunk}")
    if not dispatch.resolve(use_kernel, a):
        return linear_scan_ref(a, b)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    t = a.shape[-2]
    a, b = pad_to_chunk(a.to(torch.float32), b.to(torch.float32), chunk)
    y = linear_scan_cuda(a.contiguous(), b.contiguous())[..., :t, :]
    return y[0] if squeeze else y
