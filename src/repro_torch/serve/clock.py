"""Injectable clocks for the serving loop.

Every time-dependent decision in ``serve.loop.ServeLoop`` — deadline
flushes, SLO accounting, trace timestamps — reads ONE injected clock
instead of calling ``time`` directly.  That is the Causify-DataFlow
discipline (PAPERS.md): the same serving computation driven by a real
clock in production and a replayed/virtual one in tests, which is what
turns tail-latency behavior from "observed in benchmarks, flaky in CI"
into a deterministic, assertable property (tests/test_torch_serve_loop.py).

``SystemClock``
    wall time (``time.perf_counter``); ``wait_until`` really sleeps.

``VirtualClock``
    manually advanced simulated time; ``wait_until`` jumps.  Time is
    monotone by construction (``set`` clamps backwards jumps) so a
    replayed trace can restamp the clock from recorded event times
    without ever running it backwards.
"""

from __future__ import annotations

import time

__all__ = ["Clock", "SystemClock", "VirtualClock"]


class Clock:
    """Minimal clock surface the serving loop depends on."""

    def now(self) -> float:
        """Current time in seconds (monotone; origin arbitrary)."""
        raise NotImplementedError

    def wait_until(self, t: float) -> None:
        """Block (or jump) until ``now() >= t``."""
        raise NotImplementedError


class SystemClock(Clock):
    """Real wall time — production serving."""

    def now(self) -> float:
        return time.perf_counter()

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class VirtualClock(Clock):
    """Simulated time — deterministic tests and trace replay.

    ``now()`` returns whatever the harness last set; nothing moves
    unless ``advance``/``set``/``wait_until`` is called, so a test can
    pin the exact instant every batching decision is made.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time by {dt} (< 0)")
        self._t += float(dt)
        return self._t

    def set(self, t: float) -> float:
        """Jump to absolute time ``t`` (backwards jumps are clamped:
        virtual time is monotone like the real thing)."""
        self._t = max(self._t, float(t))
        return self._t

    def wait_until(self, t: float) -> None:
        self.set(t)
