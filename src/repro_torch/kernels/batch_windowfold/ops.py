"""Public ops: batched request-window fold with kernel/plain dispatch
(``kernels.dispatch``): the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import dispatch
from .kernel import batch_windowfold_cuda
from .ref import batch_windowfold_ref

__all__ = ["batch_windowfold", "store_windowfold"]


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def batch_windowfold(keys: torch.Tensor, ts: torch.Tensor,
                     vals: torch.Tensor, qkey: torch.Tensor,
                     qt0: torch.Tensor, qt1: torch.Tensor,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Per-request masked window sums: (C, F) x (B,) queries -> (B, F).
    The additive-leaf fast path; the general fused serving path is
    ``kernels.unit_fold``."""
    args = (_i32(keys), _i32(ts), vals.to(torch.float32).contiguous(),
            _i32(qkey), _i32(qt0), _i32(qt1))
    if dispatch.resolve(use_kernel, args[2]):
        return batch_windowfold_cuda(*args)
    return batch_windowfold_ref(*args)


def store_windowfold(state: Dict, vals: torch.Tensor, qkey: torch.Tensor,
                     qt0: torch.Tensor, qt1: torch.Tensor,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fold pre-lifted store rows ``vals`` (capacity, F) against a batch
    of request frames over an ``OnlineStore`` table state (``keys``,
    ``ts``, ``count``), reading rows at or past the live count as 0
    (their lifted values may be garbage computed from zero padding)."""
    vals = vals.to(torch.float32).contiguous()
    count = state["count"]
    if dispatch.resolve(use_kernel, vals):
        return batch_windowfold_cuda(
            _i32(state["keys"]), _i32(state["ts"]), vals, _i32(qkey),
            _i32(qt0), _i32(qt1), count=_i32(count))
    live = torch.arange(vals.shape[0], dtype=torch.int32,
                        device=vals.device) < count
    vals = torch.where(live[:, None], vals, 0.0)
    return batch_windowfold_ref(state["keys"], state["ts"], vals, qkey, qt0,
                                qt1)
