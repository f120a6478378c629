"""Multi-window parallel optimization (§6.1) — schedule shims.

The plan builder (``plan.py``) shares one merged layout per window group;
the execution policies are offline schedules in ``core.lowering.drivers``:

* fused   (``CompiledScript.offline``)        — all groups, no barrier;
* serial  (``CompiledScript.offline_serial``) — a barrier between groups,
  the baseline the paper compares against;
* reference serial (``run_reference_serial``) — the seed algorithm: one
  global sort and fold per window, a barrier between windows.

These helpers keep the reference package's API for callers and for the
ConcatJoin alignment checks.  Each runs on ``device``: the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..kernels.dispatch import resolve_device
from .compiler import CompiledScript
from .lowering import drivers as _drv
from .types import Table

__all__ = ["run_parallel", "run_serial", "run_reference_serial",
           "branch_outputs"]


def branch_outputs(cs: CompiledScript, tables: Dict[str, Table],
                   device="cuda") -> List[Dict[str, np.ndarray]]:
    """Per-branch feature dicts: every branch returns its features in
    base-row order (ConcatJoin alignment)."""
    dev = resolve_device(device)
    return [_drv.offline_branch(cs, tables, wi, dev)
            for wi in range(len(cs.windows))]


def run_parallel(cs: CompiledScript, tables: Dict[str, Table],
                 device="cuda") -> Dict[str, np.ndarray]:
    """Fused execution: every window group, no barrier between them."""
    return cs.offline(tables, device=device)


def run_serial(cs: CompiledScript, tables: Dict[str, Table],
               device="cuda") -> Dict[str, np.ndarray]:
    """Serialized schedule: window groups one by one with a barrier
    between them (bitwise equal to ``run_parallel``)."""
    return cs.offline_serial(tables, device=device)


def run_reference_serial(cs: CompiledScript, tables: Dict[str, Table],
                         device="cuda") -> Dict[str, np.ndarray]:
    """The seed-algorithm baseline (per-window merge + sort + global
    segmented scan / segment tree, ``core.window.fold_windows``): integer
    features equal ``run_parallel``'s bitwise; sums carry the rounding of
    prefixes over a key's whole history."""
    return _drv.offline_reference_serial(cs, tables,
                                         resolve_device(device))
