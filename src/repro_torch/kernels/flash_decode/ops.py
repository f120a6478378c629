"""Public ops: decode attention with mergeable partials, kernel/plain
dispatch (``kernels.dispatch``): the CUDA kernel for tensors on the
card, the plain version for tensors on the CPU."""

from __future__ import annotations

from typing import Optional

import torch

from .. import dispatch
from .kernel import decode_partials_cuda
from .ref import (decode_attention_ref, decode_partials_ref,
                  finalize_partials, merge_partials)

__all__ = ["decode_partials", "decode_attention", "merge_partials",
           "finalize_partials", "decode_attention_ref"]


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lo: Optional[torch.Tensor] = None,
                    hi: Optional[torch.Tensor] = None,
                    use_kernel: Optional[bool] = None):
    """Partial-softmax states (m, l, o) of one query token over the live
    keys [lo, hi) of a KV cache (or shard).

    q: (B, Hq, D); k/v: (B, S, Hkv, D) with Hq a multiple of Hkv (query
    head h reads KV head h // (Hq / Hkv)); lo/hi: (B,), default 0 and S.
    Returns m, l: (B, Hq); o: (B, Hq, D), float32.
    """
    b, s = k.shape[0], k.shape[1]
    if lo is None:
        lo = torch.zeros((b,), dtype=torch.int32, device=k.device)
    if hi is None:
        hi = torch.full((b,), s, dtype=torch.int32, device=k.device)
    if dispatch.resolve(use_kernel, k):
        return decode_partials_cuda(
            q.to(torch.float32).contiguous(), k.contiguous(), v.contiguous(),
            lo.to(device=k.device, dtype=torch.int32).contiguous(),
            hi.to(device=k.device, dtype=torch.int32).contiguous())
    return decode_partials_ref(q, k, v, lo.to(k.device), hi.to(k.device))


def decode_attention(q, k, v, lo=None, hi=None,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Full single-shard decode attention (partials finalized locally),
    (B, Hq, D) float32."""
    return finalize_partials(*decode_partials(q, k, v, lo, hi,
                                              use_kernel=use_kernel))
