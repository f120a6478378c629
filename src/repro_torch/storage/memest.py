"""Runtime memory management (paper §8.2): per-tablet ``max_memory``
isolation (writes fail, reads continue) and a threshold alerting hook.
"""

from __future__ import annotations

from typing import Callable, Optional

__all__ = ["MemoryGuard"]


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
