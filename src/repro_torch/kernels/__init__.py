"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* :func:`repro_torch.kernels.unit_fold.unit_fold` — fused unit fold
  (CUDA C++ for sm_90a, ``unit_fold/csrc/unit_fold.cu``)
* :func:`repro_torch.kernels.feature_hash.feature_hash` — signature
  hashing (Triton)

``dispatch`` routes CUDA tensors to the kernels and CPU tensors to the
plain versions, and counts every kernel launch.
"""

from . import dispatch  # noqa: F401
from .feature_hash import feature_hash  # noqa: F401
from .unit_fold import unit_fold  # noqa: F401

__all__ = ["dispatch", "unit_fold", "feature_hash"]
