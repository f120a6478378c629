"""First-order linear recurrence y_t = a_t * y_{t-1} + b_t (the SSM
branch's prefill scan) (ref.py = plain PyTorch version; kernel.py +
csrc/ = the CUDA kernel for sm_90a; ops.py = dispatch)."""

from .ops import linear_scan  # noqa: F401

__all__ = ["linear_scan"]
