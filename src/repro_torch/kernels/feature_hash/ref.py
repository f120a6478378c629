"""Plain PyTorch feature-signature hashing — the CPU path and the
version the Triton kernel is held against on the card.

murmur3 fmix32 of (code ^ salt) in uint32, mod dim.  torch has no full
uint32 arithmetic, so the lanes are held in int64 and masked to 32 bits
after each multiply: an int64 product of two 32-bit values can wrap, but
its low 32 bits are the uint32 product.  A code is reinterpreted as
uint32 first (negative codes included), as the reference does.
"""

from __future__ import annotations

import torch

__all__ = ["C1", "C2", "SALT", "mix32", "feature_hash_ref"]

C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
SALT = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of 32-bit lanes (reinterpreted as uint32), as int64
    holding the uint32 result."""
    x = x.to(torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = (x * C1) & _MASK32
    x = x ^ (x >> 13)
    x = (x * C2) & _MASK32
    return x ^ (x >> 16)


def feature_hash_ref(codes: torch.Tensor, dim: int,
                     salt: int = SALT) -> torch.Tensor:
    """Dictionary code -> hashed feature index in [0, dim), int32."""
    x = mix32((codes.to(torch.int64) & _MASK32) ^ (salt & _MASK32))
    return (x % dim).to(torch.int32)
