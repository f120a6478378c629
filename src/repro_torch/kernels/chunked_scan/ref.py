"""Plain PyTorch linear recurrence — the CPU path and the version the
CUDA kernel (``csrc/linear_scan.cu``) is held against on the card.

Bracketing, fixed here for both versions: the exact sequential
recurrence from a zero state,

    h_{-1} = 0;   h_t = a_t * h_{t-1} + b_t   (one multiply, then one add,
                                               each rounded to float32)

walked t = 0, 1, ..., T-1 over every (batch, lane) column.  The kernel
is compiled with ``--fmad=false`` and spells the same two roundings
(``__fmul_rn``, ``__fadd_rn``), so on the card it equals this version
bit for bit.  The JAX reference brackets the same recurrence as an
associative scan (Hillis-Steele within 128-row chunks on the TPU), so
the two packages agree to a float tolerance, not bitwise.
"""

from __future__ import annotations

import torch

__all__ = ["linear_scan_ref"]


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + b_t over axis -2 (time), y_{-1} = 0.

    a, b: (..., T, D), cast to float32.  Returns y: (..., T, D) float32.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    y = torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                    dtype=torch.float32, device=b.device)
    h = torch.zeros_like(y[..., 0, :])
    for t in range(y.shape[-2]):
        h = a[..., t, :] * h + b[..., t, :]
        y[..., t, :] = h
    return y
