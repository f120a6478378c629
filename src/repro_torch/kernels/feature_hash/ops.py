"""Public op: feature-signature hashing with kernel/plain dispatch (the
Triton kernel on the card, the plain version on the CPU, an output of
the right shape on ``meta``); ``cost`` is a call's least work."""

from __future__ import annotations

from typing import Optional

import torch

from .. import dispatch
from .kernel import feature_hash_triton
from .ref import SALT, feature_hash_ref

__all__ = ["feature_hash", "signature_batch", "cost"]


def cost(n: int) -> dispatch.KernelCost:
    """Least work of hashing ``n`` codes: each int32 code read once and
    its index written once; 12 integer operations each (the fmix32
    rounds and the modulus).  No contraction."""
    return dispatch.KernelCost(8 * n, 12 * n, 0)


def feature_hash(codes: torch.Tensor, dim: int, salt: int = SALT,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Hash discrete codes into [0, dim) feature indices (§4.1(5)): the
    Triton kernel for a CUDA tensor, the plain version for a CPU one."""
    n = codes.numel()
    with dispatch.kernel_cost("feature_hash", cost(n) if n else None):
        codes = codes.to(torch.int32)
        if dispatch.is_meta(codes):
            return torch.empty_like(codes)
        if dispatch.resolve(use_kernel, codes):
            return feature_hash_triton(codes, dim, salt=salt)
        return feature_hash_ref(codes, dim, salt=salt)


def signature_batch(discrete_codes: torch.Tensor, continuous: torch.Tensor,
                    dim: int, use_kernel: Optional[bool] = None):
    """Assemble an ML-ready (indices, values) sparse batch + dense block:
    LibSVM-style output without materializing the high-dim space.

    discrete_codes: (N, Cd) int32; continuous: (N, Cc) float32.
    Returns (hash_idx (N, Cd) int32, ones (N, Cd) float32, continuous
    float32); the hash runs the Triton kernel on a CUDA tensor.
    """
    idx = feature_hash(discrete_codes, dim, use_kernel=use_kernel)
    vals = torch.ones(discrete_codes.shape, dtype=torch.float32,
                      device=discrete_codes.device)
    return idx, vals, continuous.to(torch.float32)
