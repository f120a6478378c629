"""HyperLogLog constants shared by the sketch leaf (``functions.HLLLeaf``).

Standard Flajolet et al. 2007 construction: ``_alpha`` is the bias
correction of the harmonic-mean estimator for ``m`` registers.
"""

from __future__ import annotations

__all__ = ["_alpha"]


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)
