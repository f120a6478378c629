"""Public ops: segmented sums and the §5.1 pre-aggregation bucket build,
with kernel/plain dispatch (``kernels.dispatch``): the CUDA kernel for
tensors on the card, the plain version for tensors on the CPU, an
output of the right shape for tensors on ``meta``; ``cost`` is a call's
least work."""

from __future__ import annotations

from typing import Optional

import torch

from .. import dispatch
from .kernel import segagg_cuda
from .ref import segagg_ref

__all__ = ["segagg", "bucket_build", "cost"]


def cost(n: int, f: int, n_segments: int) -> dispatch.KernelCost:
    """Least work of summing ``n`` rows of ``f`` float32 lanes into
    ``n_segments``: the lanes and the ids read once, the sums written
    once; one add per row and lane.  No contraction."""
    return dispatch.KernelCost(n * (4 * f + 4) + n_segments * f * 4, n * f,
                               0)


def segagg(values: torch.Tensor, seg_ids: torch.Tensor, n_segments: int,
           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Per-segment sums: (N, F) x (N,) -> (n_segments, F); ids outside
    [0, n_segments) are dropped."""
    n, f = values.shape
    with dispatch.kernel_cost("segagg",
                              cost(n, f, n_segments) if n else None):
        values = values.to(torch.float32).contiguous()
        seg_ids = seg_ids.to(torch.int32).contiguous()
        if dispatch.is_meta(values):
            return values.new_empty((n_segments, f))
        if dispatch.resolve(use_kernel, values):
            return segagg_cuda(values, seg_ids, n_segments)
        return segagg_ref(values, seg_ids, n_segments)


def bucket_build(values: torch.Tensor, ts: torch.Tensor, bucket_ms: int,
                 n_buckets: int, use_kernel: Optional[bool] = None
                 ) -> torch.Tensor:
    """Pre-aggregation bucket build (§5.1): sum + count per time bucket.

    Returns (n_buckets, F+1): per-bucket feature sums with a trailing
    count column (a ones column makes counts one more summed lane)."""
    ones = torch.ones((values.shape[0], 1), dtype=torch.float32,
                      device=values.device)
    aug = torch.cat([values.to(torch.float32), ones], dim=1)
    seg = torch.div(ts.to(torch.int32), bucket_ms, rounding_mode="floor")
    return segagg(aug, seg, n_buckets, use_kernel=use_kernel)
