"""Plain PyTorch segmented aggregation — the CPU path and the version the
CUDA kernel (``csrc/segagg.cu``) is held against on the card.

The reference's ``segment_sum`` after ``where(ok)``: rows whose segment
id lies outside [0, n_segments) are dropped (their values zeroed onto
segment 0), so a NaN poisons only its own segment.  ``index_add_`` is
torch's scatter-add; on a CUDA tensor it adds in no fixed order, so the
plain version matches the kernel within a tolerance there, not bitwise.
"""

from __future__ import annotations

import torch

__all__ = ["segagg_ref"]


def segagg_ref(values: torch.Tensor, seg_ids: torch.Tensor,
               n_segments: int) -> torch.Tensor:
    """Per-segment sums: (N, F) float32 values x (N,) int32 ids ->
    (n_segments, F) float32."""
    values = values.to(torch.float32)
    ok = (seg_ids >= 0) & (seg_ids < n_segments)
    safe = torch.where(ok, seg_ids, 0).long()
    vals = torch.where(ok[:, None], values, 0.0)
    out = torch.zeros((n_segments, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    return out.index_add_(0, safe, vals)
