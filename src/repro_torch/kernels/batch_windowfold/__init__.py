"""Batched request-window fold (masked time-frame sum over the store).

The additive-leaf fast path: one masked product over pre-lifted store
rows (ref.py = plain PyTorch version; kernel.py + csrc/ = the CUDA
kernel for sm_90a; ops.py = dispatch).  ``kernels.unit_fold`` is the
general fused serving path for every leaf family.
"""

from .ops import batch_windowfold, store_windowfold  # noqa: F401

__all__ = ["batch_windowfold", "store_windowfold"]
