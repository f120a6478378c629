"""Public op: feature-signature hashing with kernel/plain dispatch."""

from __future__ import annotations

from typing import Optional

import torch

from .. import dispatch
from .kernel import feature_hash_triton
from .ref import SALT, feature_hash_ref

__all__ = ["feature_hash"]


def feature_hash(codes: torch.Tensor, dim: int, salt: int = SALT,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Hash discrete codes into [0, dim) feature indices (§4.1(5)): the
    Triton kernel for a CUDA tensor, the plain version for a CPU one."""
    codes = codes.to(torch.int32)
    if dispatch.resolve(use_kernel, codes):
        return feature_hash_triton(codes, dim, salt=salt)
    return feature_hash_ref(codes, dim, salt=salt)
