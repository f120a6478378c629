"""Triton kernel: feature-signature hashing on the card.

Replaces ``src/repro/kernels/feature_hash/kernel.py::feature_hash_pallas``
(body ``_hash_kernel``).  One elementwise integer pass — xor, shifts, two
wrapping uint32 multiplies and a mod — with no reduction, no reuse and no
shared memory, so it is bound by bytes: 4 bytes read and 4 written per
code over the card's 3.35 TB/s.  The design streams BLOCK codes per
program with 16-byte-friendly contiguous loads and does the arithmetic
in native ``tl.uint32``, where a multiply wraps exactly as the
reference's does.  ``triton`` is imported inside the launcher, so the
module imports where Triton is absent.
"""

from __future__ import annotations

import torch

from .. import dispatch
from .ref import C1, C2, SALT

__all__ = ["feature_hash_triton", "BLOCK"]

BLOCK = 1024
_KERNELS = {}


def _kernel():
    fn = _KERNELS.get("hash")
    if fn is not None:
        return fn
    import triton
    import triton.language as tl

    @triton.jit
    def _hash_kernel(codes_ptr, out_ptr, n, SALT_C: tl.constexpr,
                     DIM: tl.constexpr, C1_C: tl.constexpr,
                     C2_C: tl.constexpr, BLOCK_C: tl.constexpr):
        offs = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        mask = offs < n
        x = tl.load(codes_ptr + offs, mask=mask, other=0)
        x = x.to(tl.uint32, bitcast=True)
        x = x ^ tl.full([BLOCK_C], SALT_C, tl.uint32)
        x = x ^ (x >> 16)
        x = x * tl.full([BLOCK_C], C1_C, tl.uint32)
        x = x ^ (x >> 13)
        x = x * tl.full([BLOCK_C], C2_C, tl.uint32)
        x = x ^ (x >> 16)
        x = x % tl.full([BLOCK_C], DIM, tl.uint32)
        tl.store(out_ptr + offs, x.to(tl.int32, bitcast=True), mask=mask)

    _KERNELS["hash"] = _hash_kernel
    return _hash_kernel


def feature_hash_triton(codes: torch.Tensor, dim: int,
                        salt: int = SALT) -> torch.Tensor:
    """Launch the hash kernel on a CUDA int32 tensor of any shape."""
    if codes.device.type != "cuda":
        raise dispatch.KernelUnsupportedError(
            f"feature_hash_triton needs a CUDA tensor, got {codes.device}")
    if codes.dtype != torch.int32:
        raise TypeError(f"feature_hash_triton takes int32 codes, got "
                        f"{codes.dtype}")
    if not 0 < dim < 2**31:
        raise ValueError(f"dim must be in (0, 2^31), got {dim}")
    flat = codes.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    n = flat.numel()
    if n:
        grid = (-(-n // BLOCK),)
        _kernel()[grid](flat, out, n, SALT_C=salt & 0xFFFFFFFF, DIM=dim,
                        C1_C=C1, C2_C=C2, BLOCK_C=BLOCK, num_warps=4)
        dispatch.count_launch("feature_hash")
    return out.reshape(codes.shape)
