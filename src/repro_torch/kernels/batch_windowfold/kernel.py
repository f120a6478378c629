"""Launch wrapper of the CUDA batched window fold
(``csrc/batch_windowfold.cu``).

Replaces ``src/repro/kernels/batch_windowfold/kernel.py::
batch_windowfold_pallas``.  Built with ``nvcc`` for ``sm_90a`` on first
use and loaded with ``ctypes`` (``kernels.build``).  The wrapper checks
every input, allocates the output and one scratch buffer (chunk and
32-row group key ranges, non-finite flags, per-chunk partials) with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch reports an error, and counts the launch (one count for the three
passes).
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from .. import build, dispatch

__all__ = ["SOURCE", "CHUNK_ROWS", "batch_windowfold_cuda"]

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "batch_windowfold.cu")
CHUNK_ROWS = 4096              # store rows per pass-1 block (csrc)

_LIB = {}


def _library() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = build.load_library(SOURCE)
        if lib.bwf_chunk_rows() != CHUNK_ROWS:
            raise RuntimeError("batch_windowfold.cu CHUNK_ROWS differs from "
                               "kernel.CHUNK_ROWS")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bwf_launch.argtypes = [p, p, p, p, i, p, p, p, i, i, p, p, p]
        lib.bwf_launch.restype = ctypes.c_int
        lib.bwf_scratch_words.argtypes = [i, i, i]
        lib.bwf_scratch_words.restype = ctypes.c_longlong
        _LIB["lib"] = lib
    return lib


def _need(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device.type != "cuda":
        raise dispatch.KernelUnsupportedError(
            f"batch_windowfold_cuda: {name} lies on {t.device}, not a CUDA "
            f"device")
    if t.device != dev:
        raise ValueError(f"batch_windowfold_cuda: {name} lies on "
                         f"{t.device}, the store on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"batch_windowfold_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"batch_windowfold_cuda: {name} must be "
                         f"contiguous")


def batch_windowfold_cuda(keys: torch.Tensor, ts: torch.Tensor,
                          vals: torch.Tensor, qkey: torch.Tensor,
                          qt0: torch.Tensor, qt1: torch.Tensor,
                          count: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Launch the kernel: (C,) int32 ``keys``/``ts``, (C, F) float32
    ``vals``, (B,) int32 request keys and inclusive frames -> (B, F)
    float32 sums.  ``count`` (a () int32 device tensor) reads rows at or
    past it as 0, as ``store_windowfold`` masks them."""
    c, f = vals.shape
    b = qkey.shape[0]
    dev = vals.device
    _need(vals, "vals", torch.float32, (c, f), dev)
    _need(keys, "keys", torch.int32, (c,), dev)
    _need(ts, "ts", torch.int32, (c,), dev)
    for name, q in (("qkey", qkey), ("qt0", qt0), ("qt1", qt1)):
        _need(q, name, torch.int32, (b,), dev)
    if count is not None:
        _need(count, "count", torch.int32, (), dev)
    if c >= 2**31 or b * f >= 2**31:
        raise ValueError(f"batch_windowfold_cuda: unsupported shape C={c}, "
                         f"B={b}, F={f}")
    out = torch.empty((b, f), dtype=torch.float32, device=dev)
    if b == 0 or f == 0:
        return out
    if c == 0:
        return out.zero_()
    lib = _library()
    scratch = torch.empty((lib.bwf_scratch_words(c, b, f),),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bwf_launch(
            keys.data_ptr(), ts.data_ptr(), vals.data_ptr(),
            None if count is None else count.data_ptr(), c,
            qkey.data_ptr(), qt0.data_ptr(), qt1.data_ptr(), b, f,
            out.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"batch_windowfold kernel launch failed: CUDA "
                           f"error {err}")
    dispatch.count_launch("batch_windowfold")
    return out
