"""Memory estimation & runtime memory management (paper §8).

§8.1's empirical model:

    mem_total = sum_i n_replica_i * [ sum_j n_pk_ij * (|pk_ij| + 156)
                                      + n_index_i * n_row_i * C
                                      + K * n_row_i * |row_i| ]

with C = 70 for "latest"/"absorlat" tables, 74 for "absolute"/"absandlat",
and K in [1, n_index] the number of stored data copies (host
arithmetic).  §8.2's runtime features: per-tablet ``max_memory``
isolation (writes fail, reads continue) and a threshold alerting hook;
the serving engine charges every stored row and its retention pass
credits the evicted ones through ``release``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

__all__ = ["TableMemSpec", "estimate_memory", "recommend_engine",
           "MemoryGuard"]

_C_BY_TYPE = {
    "latest": 70,
    "absorlat": 70,
    "absolute": 74,
    "absandlat": 74,
}

PK_OVERHEAD = 156  # per unique primary key, per index (paper constant)


@dataclasses.dataclass
class TableMemSpec:
    name: str
    n_rows: int
    avg_row_bytes: float
    n_replicas: int = 1
    table_type: str = "latest"
    # per-index: (n unique primary keys, avg key length in bytes)
    indexes: Sequence[tuple] = ((1, 8),)
    data_copies: Optional[int] = None  # K; default 1

    @property
    def n_index(self) -> int:
        return len(self.indexes)


def estimate_memory(tables: Sequence[TableMemSpec]) -> Dict[str, float]:
    """§8.1 model.  Returns per-table and total bytes."""
    out: Dict[str, float] = {}
    total = 0.0
    for t in tables:
        c = _C_BY_TYPE.get(t.table_type)
        if c is None:
            raise ValueError(f"unknown table type {t.table_type!r}")
        k = t.data_copies if t.data_copies is not None else 1
        if not (1 <= k <= max(1, t.n_index)):
            raise ValueError("K must be in [1, n_index]")
        pk_term = sum(n_pk * (pk_len + PK_OVERHEAD)
                      for n_pk, pk_len in t.indexes)
        node_term = t.n_index * t.n_rows * c
        data_term = k * t.n_rows * t.avg_row_bytes
        bytes_ = t.n_replicas * (pk_term + node_term + data_term)
        out[t.name] = bytes_
        total += bytes_
    out["__total__"] = total
    return out


def recommend_engine(estimated_bytes: float, available_bytes: float,
                     latency_budget_ms: float) -> str:
    """§8.1 guidance: in-memory engine when it fits and ~10ms latency is
    required; disk engine (~20-30ms, ~80% hardware saving) otherwise."""
    if estimated_bytes <= available_bytes and latency_budget_ms <= 15:
        return "memory"
    if latency_budget_ms >= 20:
        return "disk"
    return "memory" if estimated_bytes <= available_bytes else "disk"


class MemoryGuard:
    """§8.2 runtime isolation + alerting.

    ``charge``/``release`` track live bytes per tablet.  When usage would
    exceed ``max_memory_bytes`` a write raises ``MemoryError`` (writes
    fail, reads continue — the caller keeps serving); crossing
    ``alert_fraction`` fires the alert callback once per crossing.
    """

    def __init__(self, max_memory_bytes: int, alert_fraction: float = 0.8,
                 on_alert: Optional[Callable[[int, int], None]] = None):
        self.max_memory_bytes = int(max_memory_bytes)
        self.alert_fraction = alert_fraction
        self.on_alert = on_alert
        self.used = 0
        self._alerted = False
        self.rejected_writes = 0

    def charge(self, n_bytes: int) -> bool:
        """Account a write.  Returns True if accepted; raises on overflow."""
        if self.used + n_bytes > self.max_memory_bytes:
            self.rejected_writes += 1
            raise MemoryError(
                f"tablet over max_memory ({self.used + n_bytes} > "
                f"{self.max_memory_bytes}); write rejected, reads continue")
        self.used += n_bytes
        threshold = self.alert_fraction * self.max_memory_bytes
        if self.used >= threshold and not self._alerted:
            self._alerted = True
            if self.on_alert:
                self.on_alert(self.used, self.max_memory_bytes)
        elif self.used < threshold:
            self._alerted = False
        return True

    def release(self, n_bytes: int):
        self.used = max(0, self.used - n_bytes)
