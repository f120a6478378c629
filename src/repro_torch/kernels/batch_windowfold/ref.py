"""Plain PyTorch batched window fold — the CPU path and the version the
CUDA kernel (``csrc/batch_windowfold.cu``) is held against on the card.

For request b and store row i the membership predicate is

    m[b, i] = (keys[i] == qkey[b]) & (qt0[b] <= ts[i] <= qt1[b])

and the fold of every additive leaf is one masked product:

    out[b, f] = sum_i m[b, i] * vals[i, f]

As in the reference, the product is dense: a NaN or Inf value in a row
that matches no request still reaches every output of its lane
(0 * NaN = NaN).  The store axis is cut into chunks so the (B, C) mask
is never built whole (at B = 256 and C = 1.6 M it would take 1.6 GB).
"""

from __future__ import annotations

import torch

__all__ = ["batch_windowfold_ref", "MASK_ELEMS"]

MASK_ELEMS = 1 << 24           # mask elements per chunk (64 MB of f32)


def batch_windowfold_ref(keys: torch.Tensor, ts: torch.Tensor,
                         vals: torch.Tensor, qkey: torch.Tensor,
                         qt0: torch.Tensor, qt1: torch.Tensor
                         ) -> torch.Tensor:
    """keys/ts: (C,) int32 store columns; vals: (C, F) f32 lifted leaf
    values; qkey/qt0/qt1: (B,) int32 request keys and inclusive frames.
    Returns (B, F) f32 window sums, the chunks' products summed in
    chunk order."""
    c, f = vals.shape
    b = qkey.shape[0]
    vals = vals.to(torch.float32)
    out = torch.zeros((b, f), dtype=torch.float32, device=vals.device)
    step = max(1, MASK_ELEMS // max(1, b))
    for lo in range(0, c, step):
        k = keys[lo:lo + step]
        t = ts[lo:lo + step]
        mask = (k[None, :] == qkey[:, None]) & \
            (t[None, :] >= qt0[:, None]) & (t[None, :] <= qt1[:, None])
        out = out + mask.to(torch.float32) @ vals[lo:lo + step]
    return out
