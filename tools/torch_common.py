"""Shared plumbing for the port's tools/ gates: the copy of
``tools/_common.py`` that imports nothing of the JAX package.

``src/`` importable from any invoking directory, the two canonical gate
scripts (short raw window + long pre-agg window), the integer-valued
price trick that makes float combines bitwise, tail-int argv parsing,
and the ``--device`` flag every port gate takes (the card unless the
caller asks for the CPU).
"""

from __future__ import annotations

import pathlib
import sys
from typing import List, Optional, Tuple

_SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")


def ensure_src_on_path() -> None:
    """Make ``import repro_torch`` work from any invoking directory."""
    if _SRC not in sys.path:
        sys.path.insert(0, _SRC)


ensure_src_on_path()

# The two canonical gate scripts.  RAW: short window, no pre-agg —
# exercises the gather + unit-fold serving path.  PREAGG: 3000s window
# with 100s buckets — exercises the §5.1 pre-agg planes.
RAW_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx, min(price) OVER w AS mn
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW)
"""

PREAGG_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""


def int_prices(tables):
    """Floor prices to integer-valued float32 in place.

    Every f32 combine over integer-valued operands (within 2**24) is
    exact, so even the re-bracketed pre-agg path is bitwise — the
    certifier's C-PREAGG-FLOAT rule stays conservative about this, the
    gates exploit it deliberately.
    """
    import numpy as np

    for t in tables.values():
        if "price" in t.columns:
            t.columns["price"] = np.floor(t.columns["price"]).astype(
                np.float32)
    return tables


def tail_int_argv(argv: Optional[List[str]], default: int,
                  *flags: str) -> Tuple[int, dict]:
    """Parse ``[--flag ...] [n]`` tails shared by every gate CLI.

    Returns ``(n, {flag_name: bool})`` where flag names are stripped of
    the leading dashes.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    seen = {f.lstrip("-"): False for f in flags}
    for f in flags:
        if f in argv:
            seen[f.lstrip("-")] = True
            argv = [a for a in argv if a != f]
    return (int(argv[0]) if argv else default), seen


def device_argv(argv: Optional[List[str]] = None,
                default: str = "cuda") -> Tuple[str, List[str]]:
    """Take ``--device NAME`` out of ``argv``: (the device, the rest)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" not in argv:
        return default, argv
    i = argv.index("--device")
    if i + 1 >= len(argv):
        raise SystemExit("--device needs a value (cuda or cpu)")
    return argv[i + 1], argv[:i] + argv[i + 2:]
