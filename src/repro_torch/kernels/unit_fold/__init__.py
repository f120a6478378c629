"""Fused unit fold: bounds + build + query of one window group in one
dispatch (ref.py = plan + plain PyTorch version; kernel.py + csrc/ =
the CUDA kernel for sm_90a; ops.py = dispatch)."""

from .ops import unit_fold

__all__ = ["unit_fold"]
