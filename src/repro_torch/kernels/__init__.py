"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* :func:`repro_torch.kernels.unit_fold.unit_fold` — fused unit fold
  (CUDA C++ for sm_90a, ``unit_fold/csrc/unit_fold.cu``)
* :func:`repro_torch.kernels.batch_windowfold.batch_windowfold` /
  ``store_windowfold`` — additive-leaf masked request fold (CUDA C++,
  ``batch_windowfold/csrc/batch_windowfold.cu``)
* :func:`repro_torch.kernels.segagg.segagg` / ``bucket_build`` —
  segmented sums (CUDA C++, ``segagg/csrc/segagg.cu``)
* :func:`repro_torch.kernels.feature_hash.feature_hash` — signature
  hashing (Triton), and ``signature_batch``, the LibSVM-style batch
  around it
* :func:`repro_torch.kernels.chunked_scan.linear_scan` — the linear
  recurrence of the SSM prefill (CUDA C++, ``chunked_scan/csrc/
  linear_scan.cu``)
* :func:`repro_torch.kernels.flash_decode.decode_partials` /
  ``decode_attention`` — decode-attention partials over a live key range
  with GQA grouping (CUDA C++, ``flash_decode/csrc/flash_decode.cu``)

``dispatch`` routes CUDA tensors to the kernels and CPU tensors to the
plain versions, and counts every kernel launch.
"""

from . import dispatch  # noqa: F401
from .batch_windowfold import batch_windowfold, store_windowfold  # noqa: F401
from .chunked_scan import linear_scan  # noqa: F401
from .feature_hash import feature_hash, signature_batch  # noqa: F401
from .flash_decode import decode_attention, decode_partials  # noqa: F401
from .segagg import bucket_build, segagg  # noqa: F401
from .unit_fold import unit_fold  # noqa: F401

__all__ = ["dispatch", "unit_fold", "batch_windowfold", "store_windowfold",
           "segagg", "bucket_build", "feature_hash", "signature_batch",
           "linear_scan", "decode_partials", "decode_attention"]
