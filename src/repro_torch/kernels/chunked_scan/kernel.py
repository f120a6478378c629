"""Launch wrapper of the CUDA linear-recurrence kernel
(``csrc/linear_scan.cu``).

Replaces ``src/repro/kernels/chunked_scan/kernel.py::linear_scan_pallas``.
Built with ``nvcc`` for ``sm_90a`` on first use and loaded with
``ctypes`` (``kernels.build``).  The wrapper checks every input,
allocates the output with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch reports an error, and counts the launch.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import build, dispatch

__all__ = ["SOURCE", "linear_scan_cuda"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"

_LIB = {}


def _library() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = build.load_library(SOURCE)
        p = ctypes.c_void_p
        lib.linear_scan_launch.argtypes = [p, p, p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_longlong, p]
        lib.linear_scan_launch.restype = ctypes.c_int
        _LIB["lib"] = lib
    return lib


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, T, D) float32 ``a`` and ``b`` on one card,
    contiguous -> (B, T, D) float32 ``y``.  Same contract as
    ``ref.linear_scan_ref``."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise dispatch.KernelUnsupportedError(
                f"linear_scan_cuda: {name} lies on {t.device}, not a CUDA "
                f"device")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"linear_scan_cuda: {name} must be a float32 "
                             f"(B, T, D) tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"linear_scan_cuda: {name} must be contiguous")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"linear_scan_cuda: a {tuple(a.shape)} on "
                         f"{a.device} and b {tuple(b.shape)} on {b.device} "
                         f"differ")
    nb, t, d = a.shape
    if not (1 <= nb <= 65535 and t >= 1 and d >= 1):
        raise ValueError(f"linear_scan_cuda: unsupported shape "
                         f"{tuple(a.shape)}")
    y = torch.empty_like(a)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.linear_scan_launch(a.data_ptr(), b.data_ptr(),
                                     y.data_ptr(), nb, t, d, stream)
    if err != 0:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("linear_scan")
    return y
