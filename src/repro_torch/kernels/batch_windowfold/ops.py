"""Public ops: batched request-window fold with kernel/plain dispatch
(``kernels.dispatch``): the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU, an output of the right shape for
tensors on ``meta``; ``cost`` is a call's least work."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import dispatch
from .kernel import batch_windowfold_cuda
from .ref import batch_windowfold_ref

__all__ = ["batch_windowfold", "store_windowfold", "cost"]


def cost(rows: int, b: int, f: int) -> dispatch.KernelCost:
    """Least work of folding ``rows`` store rows of ``f`` lanes for ``b``
    requests: each row's key, ts and lanes read once, the requests'
    (key, t0, t1) read and the (B, F) sums written once; the bound counts
    bytes only (``ops`` 0), and the contraction over rows is the
    reference's dense product, 2·B·rows·F FLOPs.  The public ops report
    a call over every row passed (C: the wrapper reads no device count
    on the host); ``chip_smoke.py``'s bound passes the live count."""
    return dispatch.KernelCost(rows * (8 + 4 * f) + b * 12 + b * f * 4, 0,
                               2 * b * rows * f)


def _cost(c: int, b: int, f: int):
    # the kernel launches only when every extent is positive
    return cost(c, b, f) if c and b and f else None


def _meta_or_empty(vals: torch.Tensor, b: int):
    """The (B, F) output of a call that launches nothing: shape only on
    ``meta``; None where a launch (or the plain version) runs."""
    if dispatch.is_meta(vals):
        return vals.new_empty((b, vals.shape[1]), dtype=torch.float32)
    return None


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def batch_windowfold(keys: torch.Tensor, ts: torch.Tensor,
                     vals: torch.Tensor, qkey: torch.Tensor,
                     qt0: torch.Tensor, qt1: torch.Tensor,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Per-request masked window sums: (C, F) x (B,) queries -> (B, F).
    The additive-leaf fast path; the general fused serving path is
    ``kernels.unit_fold``."""
    (c, f), b = vals.shape, qkey.shape[0]
    with dispatch.kernel_cost("batch_windowfold", _cost(c, b, f)):
        args = (_i32(keys), _i32(ts), vals.to(torch.float32).contiguous(),
                _i32(qkey), _i32(qt0), _i32(qt1))
        meta = _meta_or_empty(vals, b)
        if meta is not None:
            return meta
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
    (c, f), b = vals.shape, qkey.shape[0]
    with dispatch.kernel_cost("batch_windowfold", _cost(c, b, f)):
        vals = vals.to(torch.float32).contiguous()
        count = state["count"]
        meta = _meta_or_empty(vals, b)
        if meta is not None:
            return meta
        if dispatch.resolve(use_kernel, vals):
            return batch_windowfold_cuda(
                _i32(state["keys"]), _i32(state["ts"]), vals, _i32(qkey),
                _i32(qt0), _i32(qt1), count=_i32(count))
        live = torch.arange(vals.shape[0], dtype=torch.int32,
                            device=vals.device) < count
        vals = torch.where(live[:, None], vals, 0.0)
        return batch_windowfold_ref(state["keys"], state["ts"], vals, qkey,
                                    qt0, qt1)
