"""Segmented aggregation + pre-aggregation bucket build (§5.1)
(ref.py = plain PyTorch version; kernel.py + csrc/ = the CUDA kernel for
sm_90a; ops.py = dispatch)."""

from .ops import bucket_build, segagg  # noqa: F401

__all__ = ["segagg", "bucket_build"]
