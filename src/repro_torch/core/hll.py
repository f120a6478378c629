"""HyperLogLog cardinality estimation (§6.2 uses it to approximate key
distributions without a full scan), and the constants the sketch leaf
(``functions.HLLLeaf``) shares.

Standard Flajolet et al. 2007 construction with the small-range linear
counting correction.  Hashing is splitmix64 (deterministic, vectorized
numpy) — good avalanche behaviour, no dependencies.  Host numpy only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["splitmix64", "HyperLogLog", "_alpha"]

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
            & _MASK64
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
            & _MASK64
        return x ^ (x >> np.uint64(31))


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


class HyperLogLog:
    def __init__(self, p: int = 12):
        if not 4 <= p <= 18:
            raise ValueError("p in [4, 18]")
        self.p = p
        self.m = 1 << p
        self.registers = np.zeros(self.m, dtype=np.uint8)

    def add(self, values: np.ndarray):
        h = splitmix64(np.asarray(values, dtype=np.uint64))
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (h << np.uint64(self.p)) & _MASK64
        # rank = leading zeros of `rest` + 1 (cap at 64 - p + 1)
        nz = rest != 0
        lz = np.zeros_like(idx)
        r = rest.copy()
        for shift in (32, 16, 8, 4, 2, 1):
            mask = nz & (r < (np.uint64(1) << np.uint64(64 - shift)))
            lz = np.where(mask, lz + shift, lz)
            r = np.where(mask, (r << np.uint64(shift)) & _MASK64, r)
        rank = np.where(nz, lz + 1, 64 - self.p + 1).astype(np.uint8)
        np.maximum.at(self.registers, idx, rank)

    def estimate(self) -> float:
        m = float(self.m)
        inv = np.power(2.0, -self.registers.astype(np.float64))
        e = _alpha(self.m) * m * m / inv.sum()
        if e <= 2.5 * m:
            zeros = int((self.registers == 0).sum())
            if zeros:
                return m * np.log(m / zeros)
        return float(e)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if other.p != self.p:
            raise ValueError("precision mismatch")
        out = HyperLogLog(self.p)
        out.registers = np.maximum(self.registers, other.registers)
        return out
