"""Launch wrapper of the CUDA unit-fold kernel (``csrc/unit_fold.cu``).

Replaces ``src/repro/kernels/unit_fold/kernel.py::unit_fold_pallas``.
The source is built with ``nvcc`` for ``sm_90a`` on first use and loaded
with ``ctypes`` (``kernels.build``).  The wrapper checks every input,
allocates every output with ``torch.empty``, packs the static plan (member
frames, group descriptors, lane tiles, shared-memory offsets) into a small
int32 header cached per (real rows, Q), launches on PyTorch's current
stream, raises if the launch reports an error, and counts the launch.

The kernel reads the unpadded (U, R, F) lanes and the (U, R) order column
and treats rows at or past R as identity rows and INT_MAX timestamps, so
no padded copy is made on this path.  Three variants, chosen here from
the shapes alone (the host reads no device tensor):

* ``few`` — at most ``FEW_QUERIES`` queries per unit (serving, the
  consistency replay): one block per unit for every group, bounds once,
  no structure (``few_layout``);
* ``shared`` — many queries per unit (offline, Q = rp): a bounds pass,
  then one block per (unit, lane tile) with its group's structure in
  shared memory (``lane_tiles``);
* ``wide`` — the same where even one lane's structure does not fit a
  block's shared memory: it lives in a global-memory slice per block
  (``wide_tiles``, ``scratch_words``).

Every variant follows the plain version's bracketing, so all give its
bits.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import build, dispatch
from .ref import FAMILIES, KINDS, UnitFoldPlan, member_rows

__all__ = ["SOURCE", "unit_fold_cuda", "few_layout", "lane_tiles",
           "wide_tiles", "scratch_words", "structure_words",
           "launch_threads", "many_smem_bytes", "variant", "padded_rows",
           "SMEM_LIMIT", "SCRATCH_BYTES", "FEW_QUERIES"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "unit_fold.cu"
SMEM_LIMIT = 232_448          # dynamic shared memory one block may use
SCRATCH_BYTES = 1 << 30       # wide variant: scratch above this launches
                              # fewer block columns than units
FEW_QUERIES = 4               # queries per unit the few variant takes
MAX_GROUPS = 16               # csrc/unit_fold.cu MAX_GROUPS / MAX_MEMBERS
MAX_MEMBERS = 16
_HDR = 14
_GROUP_INTS = 10 + MAX_MEMBERS
_MODES = {"few": 0, "shared": 1, "wide": 1}


def padded_rows(r: int) -> int:
    """rp: the power of two (>= 2) the plain version pads R rows to."""
    return max(2, 1 << max(0, (r - 1).bit_length()))


def launch_threads(mode: str) -> int:
    """Threads per block: 512 for a few-query block (on the H100 the
    fastest of 256-1,024 over the serving and the replay shapes together),
    1,024 for a many-query block (its queries are chains of dependent
    combines: more threads keep more chains in flight)."""
    return 512 if mode == "few" else 1024


def _three_lanes(grp) -> bool:
    return grp.family in ("drawdown", "ew")


def few_layout(plan: UnitFoldPlan, r: int, q: int
               ) -> Optional[Tuple[int, List[Tuple[int, int, int]], int]]:
    """Shared memory of the few variant: (float offset of the groups'
    region in words, per group (stage, upper levels, kept nodes) word
    offsets past it, bytes), or None when Q exceeds ``FEW_QUERIES`` or
    the block does not fit.  Per group: the staged rows (R x F), and but
    for min/max the levels 5.. over R's 32-row chunks (2 rp / 32 - 1
    nodes x F) and ten kept low nodes (two sides x levels 0-4) per
    (member, query) frame."""
    if q > FEW_QUERIES:
        return None
    rp = padded_rows(r)
    n_up = 2 * (rp >> 5) - 1 if rp >= 32 else 1
    base = r + 2 * len(plan.specs) * q + 2
    base += -base % 4
    offs, off = [], 0
    for grp in plan.groups:
        w = grp.width
        # min/max fold their rows directly: no levels, no kept nodes
        nodes = grp.family not in ("min", "max")
        stage, up = off, off + r * w
        stash = up + n_up * w * nodes
        off = stash + len(grp.members_ix) * q * 10 * w * nodes
        offs.append((stage, up, stash))
    nbytes = 4 * (base + off)
    return (base, offs, nbytes) if nbytes <= SMEM_LIMIT else None


def structure_words(kind: str, rp: int) -> int:
    """Words of one lane's structure: a sparse table's log2(rp)+1 levels
    (sized for the widest span; the kernel fills only the levels its
    frames read), packed tree levels' 2rp-1 nodes, and for a scan the
    prefixes of the rp/32 + 1 chunk starts after them (the levels padded
    to 2rp; the other prefixes replace level 0)."""
    log2rp = rp.bit_length() - 1
    if kind == "sparse":
        return (log2rp + 1) * rp
    return 2 * rp + (rp >> 5) + 1 if kind == "scan" else 2 * rp - 1


def many_smem_bytes(kind: str, rp: int, ft: int) -> int:
    """Shared memory of a many-query block: four ints of frame ranges and
    the tile's structure."""
    return 4 * (4 + structure_words(kind, rp) * ft)


def lane_tiles(plan: UnitFoldPlan, rp: int) -> Optional[List[int]]:
    """Lane-tile width per group for the shared variant: the widest tile
    whose structure fits half a block's shared memory (two blocks an SM),
    else the whole of it (stacked lanes are independent; a 3-lane
    drawdown/EW group mixes its lanes and is one tile).  None when some
    group's narrowest tile does not fit: the wide variant."""
    tiles = []
    for grp in plan.groups:
        widths = ([grp.width] if _three_lanes(grp)
                  else range(grp.width, 0, -1))
        fit = None
        for limit in (SMEM_LIMIT // 2, SMEM_LIMIT):
            fit = next((t for t in widths
                        if many_smem_bytes(grp.kind, rp, t) <= limit), None)
            if fit is not None:
                break
        if fit is None:
            return None
        tiles.append(fit)
    return tiles


def wide_tiles(plan: UnitFoldPlan) -> List[int]:
    """Lane tiles of the wide (global-memory) variant: one lane per block
    for stacked add/min/max lanes, so a hot unit's lanes fold on many
    SMs at once; the 3 mixed lanes of a drawdown/EW group together."""
    return [grp.width if _three_lanes(grp) else 1 for grp in plan.groups]


def scratch_words(plan: UnitFoldPlan, tiles: Sequence[int], rp: int) -> int:
    """4-byte words of one block's global slice in the wide variant: the
    largest tile's structure."""
    return max(structure_words(grp.kind, rp) * tile
               for grp, tile in zip(plan.groups, tiles))


def variant(plan: UnitFoldPlan, r: int, q: int) -> str:
    """``few``, ``shared`` or ``wide``: the variant a launch at R real
    rows and Q queries per unit takes."""
    if few_layout(plan, r, q) is not None:
        return "few"
    return "shared" if lane_tiles(plan, padded_rows(r)) is not None \
        else "wide"


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
        if _three_lanes(grp) and grp.width != 3:
            raise ValueError(f"{grp.family} group must be 3 lanes wide")


def _header(plan: UnitFoldPlan, r: int, q: int
            ) -> Tuple[np.ndarray, str, int, int]:
    """(int32 header with U and the block columns unset, variant, scratch
    words per block (wide variant, else 0), lane tiles per unit), cached
    on the plan per (real rows, Q)."""
    key = ("cuda_header", r, q)
    hit = plan.launch_cache.get(key)
    if hit is not None:
        return hit
    _check_plan(plan)
    rp = padded_rows(r)
    few = few_layout(plan, r, q)
    tiles = [grp.width for grp in plan.groups]
    words, smem, few_base = 0, 0, 0
    if few is not None:
        mode = "few"
        few_base, offs, smem = few
    else:
        offs = [(0, 0, 0)] * len(plan.groups)
        mode, got = "shared", lane_tiles(plan, rp)
        if got is None:
            mode, got = "wide", wide_tiles(plan)
            words = scratch_words(plan, got, rp)
        tiles = got
    n_m = len(plan.specs)
    hdr = np.zeros(_HDR + 4 * n_m + _GROUP_INTS * len(plan.groups),
                   np.int32)
    tile_start = 0
    gh = []
    for grp, tile, off in zip(plan.groups, tiles, offs):
        mg = len(grp.members_ix)
        if mode == "shared":
            smem = max(smem, many_smem_bytes(grp.kind, rp, tile))
        decay_bits = int(np.float32(grp.log_decay).view(np.int32))
        members = list(grp.members_ix) + [0] * (MAX_MEMBERS - mg)
        gh += [FAMILIES[grp.family], KINDS[grp.kind], grp.width, tile,
               tile_start, mg, decay_bits, *off] + members
        tile_start += -(-grp.width // tile)
    if mode == "wide":
        smem = 16                     # the frame ranges; levels in scratch
    if tile_start > 65535:
        raise ValueError(f"unit_fold needs {tile_start} lane tiles per "
                         f"unit; a grid takes 65535")
    if words >= 2**31:
        raise ValueError(f"unit_fold block slice of {words} words at "
                         f"rp={rp} overflows the kernel's int32 offsets")
    hdr[1:_HDR] = [r, rp, rp.bit_length() - 1, q, len(plan.groups), n_m,
                   _MODES[mode], tile_start, smem, 0, 0, words,
                   few_base]
    hdr[_HDR:_HDR + 4 * n_m] = np.asarray(
        member_rows(plan.specs, r), np.int32).reshape(-1)
    hdr[_HDR + 4 * n_m:] = gh
    out = (hdr, mode, words, tile_start)
    plan.launch_cache[key] = out
    return out


_LIB = {}


def _library() -> ctypes.CDLL:
    lib = _LIB.get("lib")
    if lib is None:
        lib = build.load_library(SOURCE)
        if (lib.unit_fold_header_ints() != _HDR
                or lib.unit_fold_group_ints() != _GROUP_INTS):
            raise RuntimeError("unit_fold.cu header layout differs from "
                               "kernel.py")
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
                   queries: torch.Tensor) -> List[torch.Tensor]:
    """Launch the kernel on UNPADDED rows: (U, R, F_g) lane blocks, the
    (U, R) int32 order column ``ts`` (any R >= 1), (U, Q) int32
    ``queries`` (rows below R).  Returns one (U, Mg, Q, F_g) float32 fold
    block per group, equal to ``ref.unit_fold_plain`` over the rows
    padded to rp with identity rows and INT_MAX timestamps
    (``ops.pad_rows``)."""
    u, r = ts.shape
    nq = queries.shape[1]
    if r < 1:
        raise ValueError("unit_fold_cuda needs at least one row per unit")
    _need(ts, "ts", torch.int32, (u, r))
    _need(queries, "queries", torch.int32, (u, nq))
    outs = []
    for grp, data, ident in zip(plan.groups, data_list, ident_list):
        _need(data, f"data[{grp.keys[0]}]", torch.float32,
              (u, r, grp.width))
        _need(ident, f"ident[{grp.keys[0]}]", torch.float32, (grp.width,))
        outs.append(torch.empty((u, len(grp.members_ix), nq, grp.width),
                                dtype=torch.float32, device=ts.device))
    if u == 0 or nq == 0:
        return outs
    hdr, mode, words, n_tasks = _header(plan, r, nq)
    hdr = hdr.copy()
    hdr[0] = u
    hdr[10] = launch_threads(mode)
    bounds = scratch = None
    grid_x = u
    if mode != "few":
        bounds = torch.empty((2 * u * len(plan.specs) * nq,),
                             dtype=torch.int32, device=ts.device)
    if words:
        # one global slice per block, as many block columns as
        # SCRATCH_BYTES allows (blocks walk the units)
        grid_x = max(1, min(u, SCRATCH_BYTES // (4 * words * n_tasks)))
        scratch = torch.empty((grid_x * n_tasks * words,),
                              dtype=torch.float32, device=ts.device)
    hdr[11] = grid_x
    ptrs = [ts.data_ptr(), queries.data_ptr(),
            0 if bounds is None else bounds.data_ptr()]
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
