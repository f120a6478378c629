"""Launch wrapper of the CUDA segmented-sum kernel (``csrc/segagg.cu``).

Replaces ``src/repro/kernels/segagg/kernel.py::segagg_pallas``.  Built
with ``nvcc`` for ``sm_90a`` on first use and loaded with ``ctypes``
(``kernels.build``).  The wrapper checks every input, allocates the
output and the two passes' scratch with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch reports an error, and
counts the launch (one count for the two passes).
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import build, dispatch

__all__ = ["SOURCE", "CHUNK", "segagg_cuda"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "segagg.cu"
CHUNK = 2048                   # rows per pass-1 block (csrc CHUNK)

_LIB = {}


def _library() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = build.load_library(SOURCE)
        if lib.segagg_chunk_rows() != CHUNK:
            raise RuntimeError("segagg.cu CHUNK differs from kernel.CHUNK")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segagg_launch.argtypes = [p, p, i, i, i, p, p, p, p, p, p]
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
    n_chunks = -(-n // CHUNK)
    chunk_seg = torch.empty((n_chunks * CHUNK,), dtype=torch.int32,
                            device=dev)
    chunk_sum = torch.empty((n_chunks * CHUNK * f,), dtype=torch.float32,
                            device=dev)
    bounds = torch.empty((2, n_chunks), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segagg_launch(
            values.data_ptr(), seg_ids.data_ptr(), n, f, n_segments,
            out.data_ptr(), chunk_seg.data_ptr(), chunk_sum.data_ptr(),
            bounds[0].data_ptr(), bounds[1].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segagg kernel launch failed: CUDA error {err}")
    dispatch.count_launch("segagg")
    return out
