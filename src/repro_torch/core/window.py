"""Window specifications: the frame grammar the parser and planner share.

Frame semantics (matching OpenMLDB SQL):

  * ``ROWS BETWEEN k PRECEDING AND CURRENT ROW``       (count frame)
  * ``ROWS_RANGE BETWEEN <interval> PRECEDING AND CURRENT ROW`` (time frame;
    peers — rows with equal timestamp — are included, standard SQL RANGE)
  * optional ``MAXSIZE n`` row cap, optional ``UNION table, ...``.

The fold machinery that executes these frames lives in
``kernels.unit_fold``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["WindowSpec", "parse_interval_ms"]

_UNITS_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
             "d": 86_400_000}


def parse_interval_ms(text: str) -> int:
    """``"3s" -> 3000``; bare integers are milliseconds."""
    t = text.strip().lower()
    for suffix in ("ms", "s", "m", "h", "d"):
        if t.endswith(suffix):
            head = t[: -len(suffix)]
            if head and head.replace(".", "", 1).isdigit():
                return int(float(head) * _UNITS_MS[suffix])
    return int(t)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    name: str
    partition_by: str
    order_by: str
    preceding: int                 # rows (ROWS) or milliseconds (ROWS_RANGE)
    frame_rows: bool = False       # True = ROWS, False = ROWS_RANGE
    union_tables: Tuple[str, ...] = ()
    maxsize: int = 0               # 0 = unlimited
    instance_not_in_window: bool = False

    def canonical(self) -> str:
        """Fingerprint used for window merging (§4.2 parsing optimization):
        windows with identical canonical forms share one physical window."""
        return (
            f"p={self.partition_by}|o={self.order_by}|"
            f"f={'rows' if self.frame_rows else 'range'}:{self.preceding}|"
            f"u={','.join(sorted(self.union_tables))}|m={self.maxsize}|"
            f"x={int(self.instance_not_in_window)}"
        )
