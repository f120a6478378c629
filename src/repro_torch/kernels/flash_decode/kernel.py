"""Launch wrapper of the CUDA decode-attention partials kernel
(``csrc/flash_decode.cu``).

Replaces ``src/repro/kernels/flash_decode/kernel.py::
decode_partials_pallas``.  Built with ``nvcc`` for ``sm_90a`` on first
use and loaded with ``ctypes`` (``kernels.build``).  The wrapper checks
every input, allocates the partials and the split pass's scratch with
``torch.empty``, launches the two passes (split, merge) on PyTorch's
current stream, raises if a launch reports an error, and counts one
launch.  The grid is sized from S alone: the wrapper reads no device
tensor on the host, so a decode step adds no synchronisation.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from .. import build, dispatch

__all__ = ["SOURCE", "decode_partials_cuda"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = {}


def _library() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = build.load_library(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_partials_launch.argtypes = [p, p, p, p, p, p, p, p, p, i,
                                               i, i, i, i, i, ctypes.c_float,
                                               p]
        lib.decode_partials_launch.restype = ctypes.c_int
        _LIB["lib"] = lib
    return lib


def _need(t: torch.Tensor, name: str, dtypes, shape, dev) -> None:
    if t.device.type != "cuda":
        raise dispatch.KernelUnsupportedError(
            f"decode_partials_cuda: {name} lies on {t.device}, not a CUDA "
            f"device")
    if t.device != dev:
        raise ValueError(f"decode_partials_cuda: {name} lies on {t.device}, "
                         f"the cache on {dev}")
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_partials_cuda: {name} must be one of "
                         f"{dtypes} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decode_partials_cuda: {name} must be contiguous")


def decode_partials_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel: (B, Hq, D) float32 ``q``, (B, S, Hkv, D) float32
    or bfloat16 ``k``/``v`` (one type), (B,) int32 ``lo``/``hi`` on one
    card -> m, l (B, Hq) and o (B, Hq, D) float32.  Same contract as
    ``ref.decode_partials_ref``."""
    b, s, hkv, d = k.shape
    hq = q.shape[1]
    dev = k.device
    _need(k, "k", tuple(KV_TYPES), (b, s, hkv, d), dev)
    _need(v, "v", (k.dtype,), (b, s, hkv, d), dev)
    _need(q, "q", (torch.float32,), (b, hq, d), dev)
    _need(lo, "lo", (torch.int32,), (b,), dev)
    _need(hi, "hi", (torch.int32,), (b,), dev)
    lib = _library()
    if hq % hkv or not (1 <= hq // hkv <= lib.decode_partials_max_g()) \
            or not (1 <= d <= lib.decode_partials_max_d()) or s < 1 \
            or not (1 <= b <= 65535) or hkv > 65535:
        raise ValueError(f"decode_partials_cuda: unsupported shape Hq={hq}, "
                         f"Hkv={hkv}, D={d}, S={s}")
    m = torch.empty((b, hq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hq), dtype=torch.float32, device=dev)
    o = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    n_split = -(-s // lib.decode_partials_split())
    part = torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_partials_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
            part.data_ptr(), b, s, hkv, hq // hkv, d, KV_TYPES[k.dtype],
            d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_partials kernel launch failed: CUDA "
                           f"error {err}")
    dispatch.count_launch("decode_partials")
    return m, l, o
