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

The backward (``linear_scan_bwd_ref``) walks t = T-1, ..., 0 with the
same two roundings per step, and the CUDA backward kernel repeats it bit
for bit; the JAX reference's gradient is ``jax.vjp`` of its associative
scan, so there too the packages agree to a float tolerance.
"""

from __future__ import annotations

import torch

__all__ = ["linear_scan_ref", "linear_scan_bwd_ref"]


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """y_t = a_t * y_{t-1} + b_t over axis -2 (time), y_{-1} = 0.

    a, b: (..., T, D), cast to ``dtype`` (float32; float64 only for
    ``torch.autograd.gradcheck``).  Returns y: (..., T, D) in ``dtype``.
    """
    a = a.to(dtype)
    b = b.to(dtype)
    y = torch.empty(torch.broadcast_shapes(a.shape, b.shape), dtype=dtype,
                    device=b.device)
    h = torch.zeros_like(y[..., 0, :])
    for t in range(y.shape[-2]):
        h = a[..., t, :] * h + b[..., t, :]
        y[..., t, :] = h
    return y


def linear_scan_bwd_ref(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                        dtype=torch.float32):
    """Gradients of ``linear_scan_ref`` given ``y`` and g = dL/dy.

    lam_{T-1} = g_{T-1},  lam_t = g_t + a_{t+1} * lam_{t+1}  (a multiply,
    then an add, each rounded);  db_t = lam_t,  da_t = lam_t * y_{t-1}
    with da_0 = 0 (y_{-1} = 0).  a, y, g: (..., T, D) of one shape, cast
    to ``dtype``.  Returns (da, db) in ``dtype``.
    """
    a, y, g = (x.to(dtype) for x in (a, y, g))
    da = torch.empty(y.shape, dtype=dtype, device=y.device)
    db = torch.empty_like(da)
    last = y.shape[-2] - 1
    lam = g[..., last, :]
    for t in range(last, -1, -1):
        if t < last:
            lam = g[..., t, :] + a[..., t + 1, :] * lam
        db[..., t, :] = lam
        if t:
            da[..., t, :] = lam * y[..., t - 1, :]
        else:
            da[..., 0, :] = 0.0
    return da, db
