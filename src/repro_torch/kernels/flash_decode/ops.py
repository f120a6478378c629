"""Public ops: decode attention with mergeable partials, kernel/plain
dispatch (``kernels.dispatch``): the CUDA kernel for tensors on the
card, the plain version for tensors on the CPU, outputs of the right
shape for tensors on ``meta``; ``cost`` is the call's least work."""

from __future__ import annotations

from typing import Optional

import torch

from .. import dispatch
from .kernel import decode_partials_cuda
from .ref import (decode_attention_ref, decode_partials_ref,
                  finalize_partials, merge_partials)

__all__ = ["decode_partials", "decode_attention", "merge_partials",
           "finalize_partials", "decode_attention_ref", "cost"]


def cost(b: int, hq: int, hkv: int, d: int, live_keys: int,
         kv_itemsize: int = 2) -> dispatch.KernelCost:
    """Least work of one ``decode_partials`` call over ``live_keys``
    (row, key) pairs (the sum over rows of hi - lo): each live K and V
    row read once, q (float32) read and the partials (m, l, o) written
    once; the q·k and p·v products, 2·D FLOPs each per live key and
    query head.  ``decode_partials`` reports the call over every cache
    slot (B·S), as the reference's masked decode attention multiplies
    every slot, and because a wrapper reads no device tensor on the
    host; ``chip_smoke.py``'s bounds pass the run's live count."""
    nbytes = (2 * live_keys * hkv * d * kv_itemsize + b * hq * d * 4
              + b * hq * (d + 2) * 4)
    flops = 4 * d * live_keys * hq
    return dispatch.KernelCost(nbytes, flops, flops)


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
    b, s, hkv, d = k.shape
    hq = q.shape[1]
    with dispatch.kernel_cost("decode_partials", cost(
            b, hq, hkv, d, b * s, k.element_size())):
        if dispatch.is_meta(k):
            return (q.new_empty((b, hq), dtype=torch.float32),
                    q.new_empty((b, hq), dtype=torch.float32),
                    q.new_empty((b, hq, d), dtype=torch.float32))
        if lo is None:
            lo = torch.zeros((b,), dtype=torch.int32, device=k.device)
        if hi is None:
            hi = torch.full((b,), s, dtype=torch.int32, device=k.device)
        if dispatch.resolve(use_kernel, k):
            return decode_partials_cuda(
                q.to(torch.float32).contiguous(), k.contiguous(),
                v.contiguous(),
                lo.to(device=k.device, dtype=torch.int32).contiguous(),
                hi.to(device=k.device, dtype=torch.int32).contiguous())
        return decode_partials_ref(q, k, v, lo.to(k.device), hi.to(k.device))


def decode_attention(q, k, v, lo=None, hi=None,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Full single-shard decode attention (partials finalized locally),
    (B, Hq, D) float32."""
    return finalize_partials(*decode_partials(q, k, v, lo, hi,
                                              use_kernel=use_kernel))
