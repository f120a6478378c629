"""Launch wrapper of the CUDA unit-fold kernel (``csrc/unit_fold.cu``).

Replaces ``src/repro/kernels/unit_fold/kernel.py::unit_fold_pallas``.
The source is built with ``nvcc`` for ``sm_90a`` on first use and loaded
with ``ctypes`` (``kernels.build``).  The wrapper checks every input,
allocates every output with ``torch.empty``, packs the static plan (member
frames, group descriptors, lane tiles) into a small int32 header cached
per (rp, Q, real rows), launches on PyTorch's current stream, raises if
the launch reports an error, and counts the launch.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import build, dispatch
from .ref import FAMILIES, KINDS, UnitFoldPlan, member_rows

__all__ = ["SOURCE", "unit_fold_cuda", "smem_bytes", "lane_tiles",
           "SMEM_LIMIT"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "unit_fold.cu"
SMEM_LIMIT = 232_448          # dynamic shared memory one block may use
THREADS = 256
MAX_GROUPS = 16               # csrc/unit_fold.cu MAX_GROUPS / MAX_MEMBERS
MAX_MEMBERS = 16
_HDR = 9
_GROUP_INTS = 7 + MAX_MEMBERS


def smem_bytes(kind: str, rp: int, mg: int, q: int, ft: int) -> int:
    """Shared memory of one block: order column, (Mg, Q) bounds, the
    tile's identity and its structure levels."""
    log2rp = rp.bit_length() - 1
    levels = (log2rp + 1) * rp if kind == "sparse" else 2 * rp - 1
    return 4 * (rp + 2 * mg * q + ft + levels * ft)


def lane_tiles(plan: UnitFoldPlan, rp: int, q: int) -> List[int]:
    """Lane-tile width per group: the widest tile whose structure fits a
    block (stacked lanes are independent); a 3-lane group mixes its
    lanes and is one tile, or the plan cannot run."""
    tiles = []
    for grp in plan.groups:
        mg = len(grp.members_ix)
        if grp.family in ("drawdown", "ew"):
            widths = [grp.width]
        else:
            widths = range(grp.width, 0, -1)
        fit = next((t for t in widths
                    if smem_bytes(grp.kind, rp, mg, q, t) <= SMEM_LIMIT),
                   None)
        if fit is None:
            raise ValueError(
                f"unit_fold group {grp.keys} needs "
                f"{smem_bytes(grp.kind, rp, mg, q, widths[-1])} bytes of "
                f"shared memory at rp={rp}, Q={q}; a block has "
                f"{SMEM_LIMIT}")
        tiles.append(fit)
    return tiles


def _check_plan(plan: UnitFoldPlan) -> None:
    expect = {"add": "scan", "min": "sparse", "max": "sparse",
              "drawdown": "tree", "ew": "scan"}
    if not 1 <= len(plan.groups) <= MAX_GROUPS:
        raise ValueError(f"unit_fold kernel takes 1..{MAX_GROUPS} groups, "
                         f"plan has {len(plan.groups)}")
    if not 1 <= len(plan.specs) <= MAX_MEMBERS:
        raise ValueError(f"unit_fold kernel takes 1..{MAX_MEMBERS} member "
                         f"windows, plan has {len(plan.specs)}")
    for grp in plan.groups:
        if expect[grp.family] != grp.kind:
            raise ValueError(f"no kernel for a {grp.kind} fold of the "
                             f"{grp.family} family")
        if grp.family in ("drawdown", "ew") and grp.width != 3:
            raise ValueError(f"{grp.family} group must be 3 lanes wide")


def _header(plan: UnitFoldPlan, rp: int, q: int, r_real: int
            ) -> Tuple[np.ndarray, int, int]:
    """(int32 header with U unset, shared-memory bytes, grid.y), cached
    on the plan per (rp, Q, real rows)."""
    key = ("cuda_header", rp, q, r_real)
    hit = plan.launch_cache.get(key)
    if hit is not None:
        return hit
    _check_plan(plan)
    tiles = lane_tiles(plan, rp, q)
    n_m = len(plan.specs)
    hdr = np.zeros(_HDR + 4 * n_m + _GROUP_INTS * len(plan.groups),
                   np.int32)
    tile_start, smem = 0, 0
    gh = []
    for grp, tile in zip(plan.groups, tiles):
        mg = len(grp.members_ix)
        n_tiles = -(-grp.width // tile)
        smem = max(smem, smem_bytes(grp.kind, rp, mg, q, tile))
        decay_bits = int(np.float32(grp.log_decay).view(np.int32))
        members = list(grp.members_ix) + [0] * (MAX_MEMBERS - mg)
        gh += [FAMILIES[grp.family], KINDS[grp.kind], grp.width, tile,
               tile_start, mg, decay_bits] + members
        tile_start += n_tiles
    if tile_start > 65535:
        raise ValueError(f"unit_fold needs {tile_start} lane tiles per "
                         f"unit; a grid takes 65535")
    hdr[1:_HDR] = [rp, rp.bit_length() - 1, q, len(plan.groups), n_m,
                   tile_start, smem, THREADS]
    hdr[_HDR:_HDR + 4 * n_m] = np.asarray(
        member_rows(plan.specs, r_real), np.int32).reshape(-1)
    hdr[_HDR + 4 * n_m:] = gh
    out = (hdr, smem, tile_start)
    plan.launch_cache[key] = out
    return out


_LIB = {}


def _library() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = build.load_library(SOURCE)
        fn = lib.unit_fold_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB["lib"] = lib
    return lib


def _need(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise dispatch.KernelUnsupportedError(
            f"unit_fold_cuda: {name} lies on {t.device}, not a CUDA device")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"unit_fold_cuda: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"unit_fold_cuda: {name} must be contiguous")


def unit_fold_cuda(plan: UnitFoldPlan, data_list: Sequence[torch.Tensor],
                   ident_list: Sequence[torch.Tensor], ts: torch.Tensor,
                   queries: torch.Tensor, r_real: int
                   ) -> List[torch.Tensor]:
    """Launch the kernel: same contract as ``ref.unit_fold_plain`` —
    (U, rp, F_g) identity-padded lane blocks, (U, rp) INT_MAX-padded
    int32 ``ts`` with rp a power of two, (U, Q) int32 ``queries`` — and
    one (U, Mg, Q, F_g) float32 fold block per group."""
    u, rp = ts.shape
    nq = queries.shape[1]
    if rp < 2 or rp & (rp - 1):
        raise ValueError(f"rp must be a power of two >= 2, got {rp}")
    _need(ts, "ts", torch.int32, (u, rp))
    _need(queries, "queries", torch.int32, (u, nq))
    outs = []
    for grp, data, ident in zip(plan.groups, data_list, ident_list):
        _need(data, f"data[{grp.keys[0]}]", torch.float32,
              (u, rp, grp.width))
        _need(ident, f"ident[{grp.keys[0]}]", torch.float32, (grp.width,))
        outs.append(torch.empty((u, len(grp.members_ix), nq, grp.width),
                                dtype=torch.float32, device=ts.device))
    if u == 0 or nq == 0:
        return outs
    hdr, _, _ = _header(plan, rp, nq, r_real)
    hdr = hdr.copy()
    hdr[0] = u
    ptrs = [ts.data_ptr(), queries.data_ptr()]
    for data, out, ident in zip(data_list, outs, ident_list):
        ptrs += [data.data_ptr(), out.data_ptr(), ident.data_ptr()]
    ptrs = np.asarray(ptrs, np.int64)
    lib = _library()
    with torch.cuda.device(ts.device):
        stream = torch.cuda.current_stream(ts.device).cuda_stream
        err = lib.unit_fold_launch(hdr.ctypes.data, ptrs.ctypes.data,
                                   stream)
    if err != 0:
        raise RuntimeError(f"unit_fold kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("unit_fold")
    return outs
