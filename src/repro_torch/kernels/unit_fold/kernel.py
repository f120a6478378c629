"""Launch wrapper of the CUDA unit-fold kernel (``csrc/unit_fold.cu``).

Replaces ``src/repro/kernels/unit_fold/kernel.py::unit_fold_pallas``.
The source is built with ``nvcc`` for ``sm_90a`` on first use and loaded
with ``ctypes`` (``kernels.build``).  The wrapper checks every input,
allocates every output with ``torch.empty``, packs the static plan (member
frames, group descriptors, lane tiles) into a small int32 header cached
per (rp, Q, real rows), launches on PyTorch's current stream, raises if
the launch reports an error, and counts the launch.

Two variants of the one kernel: where every group's lane tile fits a
block's shared memory (``lane_tiles``), the order column, bounds and
structure live there; otherwise (an offline unit thousands of rows wide,
queried at every row) the wrapper allocates a global-memory scratch
buffer, one slice per block, and the kernel keeps bounds and levels in
it (``wide_tiles``).  The choice is made here from ``smem_bytes``; both
variants run the same code on the same bracketing, so both give the
plain version's bits.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import build, dispatch
from .ref import FAMILIES, KINDS, UnitFoldPlan, member_rows

__all__ = ["SOURCE", "unit_fold_cuda", "smem_bytes", "lane_tiles",
           "wide_tiles", "scratch_words", "SMEM_LIMIT", "SCRATCH_BYTES"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "unit_fold.cu"
SMEM_LIMIT = 232_448          # dynamic shared memory one block may use
SCRATCH_BYTES = 1 << 30       # wide variant: scratch above this launches
                              # fewer block columns than units
THREADS = 256
MAX_GROUPS = 16               # csrc/unit_fold.cu MAX_GROUPS / MAX_MEMBERS
MAX_MEMBERS = 16
_HDR = 11
_GROUP_INTS = 7 + MAX_MEMBERS


def _levels(kind: str, rp: int) -> int:
    """Rows of one lane's structure: a sparse table's log2(rp)+1 levels
    or a packed tree's 2rp-1 nodes."""
    log2rp = rp.bit_length() - 1
    return (log2rp + 1) * rp if kind == "sparse" else 2 * rp - 1


def smem_bytes(kind: str, rp: int, mg: int, q: int, ft: int) -> int:
    """Shared memory of one block: order column, (Mg, Q) bounds, the
    tile's identity and its structure levels."""
    return 4 * (rp + 2 * mg * q + ft + _levels(kind, rp) * ft)


def lane_tiles(plan: UnitFoldPlan, rp: int, q: int) -> Optional[List[int]]:
    """Lane-tile width per group for the shared-memory variant: the
    widest tile whose structure fits a block (stacked lanes are
    independent; a 3-lane drawdown/EW group mixes its lanes and is one
    tile).  None when some group's narrowest tile does not fit: the
    launch then takes the wide variant (``wide_tiles``)."""
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
            return None
        tiles.append(fit)
    return tiles


def wide_tiles(plan: UnitFoldPlan) -> List[int]:
    """Lane tiles of the wide (global-memory) variant: one lane per block
    for stacked add/min/max lanes, so a hot unit's lanes fold on many
    SMs at once; the 3 mixed lanes of a drawdown/EW group together."""
    return [grp.width if grp.family in ("drawdown", "ew") else 1
            for grp in plan.groups]


def scratch_words(plan: UnitFoldPlan, tiles: Sequence[int], rp: int,
                  q: int) -> int:
    """4-byte words of one block's global slice in the wide variant: the
    (Mg, Q) bounds and the largest tile's structure levels."""
    return max(2 * len(grp.members_ix) * q + _levels(grp.kind, rp) * tile
               for grp, tile in zip(plan.groups, tiles))


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
    """(int32 header with U and the block columns unset, scratch words
    per block (0 for the shared-memory variant), lane tiles per unit),
    cached on the plan per (rp, Q, real rows)."""
    key = ("cuda_header", rp, q, r_real)
    hit = plan.launch_cache.get(key)
    if hit is not None:
        return hit
    _check_plan(plan)
    tiles = lane_tiles(plan, rp, q)
    words = 0
    if tiles is None:
        tiles = wide_tiles(plan)
        words = scratch_words(plan, tiles, rp, q)
    n_m = len(plan.specs)
    hdr = np.zeros(_HDR + 4 * n_m + _GROUP_INTS * len(plan.groups),
                   np.int32)
    tile_start, smem = 0, 0
    gh = []
    for grp, tile in zip(plan.groups, tiles):
        mg = len(grp.members_ix)
        n_tiles = -(-grp.width // tile)
        if not words:
            smem = max(smem, smem_bytes(grp.kind, rp, mg, q, tile))
        decay_bits = int(np.float32(grp.log_decay).view(np.int32))
        members = list(grp.members_ix) + [0] * (MAX_MEMBERS - mg)
        gh += [FAMILIES[grp.family], KINDS[grp.kind], grp.width, tile,
               tile_start, mg, decay_bits] + members
        tile_start += n_tiles
    if tile_start > 65535:
        raise ValueError(f"unit_fold needs {tile_start} lane tiles per "
                         f"unit; a grid takes 65535")
    if words >= 2**31:
        raise ValueError(f"unit_fold block slice of {words} words at "
                         f"rp={rp}, Q={q} overflows the kernel's int32 "
                         f"offsets")
    hdr[1:_HDR] = [rp, rp.bit_length() - 1, q, len(plan.groups), n_m,
                   tile_start, smem, THREADS, 0, words]
    hdr[_HDR:_HDR + 4 * n_m] = np.asarray(
        member_rows(plan.specs, r_real), np.int32).reshape(-1)
    hdr[_HDR + 4 * n_m:] = gh
    out = (hdr, words, tile_start)
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
    hdr, words, n_tasks = _header(plan, rp, nq, r_real)
    hdr = hdr.copy()
    hdr[0] = u
    scratch = None
    if words:
        # the wide variant: one global slice per block, as many block
        # columns as SCRATCH_BYTES allows (blocks walk the units)
        grid_x = max(1, min(u, SCRATCH_BYTES // (4 * words * n_tasks)))
        scratch = torch.empty((grid_x * n_tasks * words,),
                              dtype=torch.int32, device=ts.device)
    else:
        grid_x = u
    hdr[9] = grid_x
    ptrs = [ts.data_ptr(), queries.data_ptr()]
    for data, out, ident in zip(data_list, outs, ident_list):
        ptrs += [data.data_ptr(), out.data_ptr(), ident.data_ptr()]
    ptrs.append(0 if scratch is None else scratch.data_ptr())
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
