"""Launch wrappers of the CUDA linear-recurrence kernels
(``csrc/linear_scan.cu``): the forward scan and its backward.

The forward replaces
``src/repro/kernels/chunked_scan/kernel.py::linear_scan_pallas``; the
backward has no TPU kernel to replace (the reference differentiates its
plain scan with ``jax.vjp``).
Built with ``nvcc`` for ``sm_90a`` on first use and loaded with
``ctypes`` (``kernels.build``).  The wrapper checks every input,
allocates the output with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch reports an error, and counts the launch
(``linear_scan`` and ``linear_scan_bwd``).
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import build, dispatch

__all__ = ["SOURCE", "linear_scan_cuda", "linear_scan_bwd_cuda"]

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
        lib.linear_scan_bwd_launch.argtypes = [p, p, p, p, p, ctypes.c_int,
                                               ctypes.c_int,
                                               ctypes.c_longlong, p]
        lib.linear_scan_bwd_launch.restype = ctypes.c_int
        _LIB["lib"] = lib
    return lib


def _check(fn: str, **tensors: torch.Tensor) -> None:
    """Every tensor float32 (B, T, D), contiguous, on one card, of one
    shape; B, T and D within the launch's limits."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise dispatch.KernelUnsupportedError(
                f"{fn}: {name} lies on {t.device}, not a CUDA device")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"{fn}: {name} must be a float32 (B, T, D) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{fn}: " + " and ".join(
                f"{k} {tuple(v.shape)} on {v.device}"
                for k, v in tensors.items()) + " differ")
    nb, t, d = first.shape
    if not (1 <= nb <= 65535 and t >= 1 and d >= 1):
        raise ValueError(f"{fn}: unsupported shape {tuple(first.shape)}")


def _launch(name: str, entry, first: torch.Tensor, *ptrs) -> None:
    nb, t, d = first.shape
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        err = entry(*ptrs, nb, t, d, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    dispatch.count_launch(name)


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (B, T, D) float32 ``a`` and ``b`` on one card,
    contiguous -> (B, T, D) float32 ``y``.  Same contract as
    ``ref.linear_scan_ref``."""
    _check("linear_scan_cuda", a=a, b=b)
    y = torch.empty_like(a)
    _launch("linear_scan", _library().linear_scan_launch, a, a.data_ptr(),
            b.data_ptr(), y.data_ptr())
    return y


def linear_scan_bwd_cuda(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """Launch the backward kernel: the forward's ``a`` and output ``y`` and
    the upstream gradient ``g``, (B, T, D) float32 on one card, contiguous
    -> (da, db).  Same contract as ``ref.linear_scan_bwd_ref``."""
    _check("linear_scan_bwd_cuda", a=a, y=y, g=g)
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    _launch("linear_scan_bwd", _library().linear_scan_bwd_launch, a,
            a.data_ptr(), y.data_ptr(), g.data_ptr(), da.data_ptr(),
            db.data_ptr())
    return da, db
