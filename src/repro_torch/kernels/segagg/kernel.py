"""Launch wrapper of the CUDA segmented-sum kernel (``csrc/segagg.cu``).

Replaces ``src/repro/kernels/segagg/kernel.py::segagg_pallas``.  Built
with ``nvcc`` for ``sm_90a`` on first use and loaded with ``ctypes``
(``kernels.build``).  The wrapper checks every input, allocates the
output and the two passes' scratch with ``torch.empty`` (its size from
the library's own plan, computed on the host from N, F and S alone),
launches on PyTorch's current stream, raises if the launch reports an
error, and counts the launch (one count for the two passes of every lane
slice).
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import build, dispatch

__all__ = ["SOURCE", "segagg_cuda"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "segagg.cu"

_LIB = {}


def _library() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = build.load_library(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segagg_scratch_floats.argtypes = [ll, i, i]
        lib.segagg_scratch_floats.restype = ll
        lib.segagg_launch.argtypes = [p, p, ll, i, i, p, p, p]
        lib.segagg_launch.restype = ctypes.c_int
        _LIB["lib"] = lib
    return lib


def _need(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise dispatch.KernelUnsupportedError(
            f"segagg_cuda: {name} lies on {t.device}, not a CUDA device")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"segagg_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"segagg_cuda: {name} must be contiguous")


def segagg_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Launch the kernel: (N, F) float32 ``values`` and (N,) int32
    ``seg_ids`` on one card -> (n_segments, F) float32 sums, ids outside
    [0, n_segments) dropped.  Same contract as ``ref.segagg_ref``."""
    n, f = values.shape
    _need(values, "values", torch.float32, (n, f))
    _need(seg_ids, "seg_ids", torch.int32, (n,))
    if seg_ids.device != values.device:
        raise ValueError("segagg_cuda: values and seg_ids lie on different "
                         "devices")
    if n_segments < 1 or f < 1 or n >= 2**31 or n_segments * f >= 2**31:
        raise ValueError(f"segagg_cuda: unsupported shape N={n}, F={f}, "
                         f"S={n_segments}")
    dev = values.device
    out = torch.empty((n_segments, f), dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    lib = _library()
    partial = torch.empty((lib.segagg_scratch_floats(n, f, n_segments),),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segagg_launch(
            values.data_ptr(), seg_ids.data_ptr(), n, f, n_segments,
            out.data_ptr(), partial.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segagg kernel launch failed: CUDA error {err}")
    dispatch.count_launch("segagg")
    return out
