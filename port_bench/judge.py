"""The comparisons that decide ``correct``: each number against its
limit, the limits kept in the cell's workload file."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keys: Iterable[str]) -> List[float]:
    """|got - ref| / max(ref, the median leaf's ref) for each of ``keys``:
    the gap between two norms, not the norm of a difference."""
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return [abs(got[k] - ref[k]) / max(ref[k], med) for k in keys]


def worst_leaf_gap(got, ref, keys) -> float:
    return max(leaf_gaps(got, ref, keys))


def median_leaf_gap(got, ref, keys) -> float:
    return float(np.median(leaf_gaps(got, ref, keys)))


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> List[Tuple[str, float, float]]:
    """(name, number, limit) for every limit; a number missing or not
    finite reads as infinite."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name)
        v = float("inf") if v is None or not np.isfinite(v) else float(v)
        out.append((name, v, float(limit)))
    return out


def passed(rows: List[Tuple[str, float, float]]) -> bool:
    return bool(rows) and all(v <= limit for _, v, limit in rows)
