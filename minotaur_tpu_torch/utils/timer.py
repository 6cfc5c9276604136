"""CPU + wall timers (reference: src/base/Timer.h:40-126).

The reference distinguishes process-CPU time (getrusage/clock) from wall
time (steady_clock); both matter when reporting batched-device throughput,
so we keep the split.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self._wall0 = 0.0
        self._cpu0 = 0.0
        self._running = False

    def start(self) -> None:
        self._wall0 = time.monotonic()
        self._cpu0 = time.process_time()
        self._running = True

    def query_wall(self) -> float:
        if not self._running:
            return 0.0
        return time.monotonic() - self._wall0

    def query_cpu(self) -> float:
        if not self._running:
            return 0.0
        return time.process_time() - self._cpu0

    # reference Timer::query() returns CPU time by default
    def query(self) -> float:
        return self.query_cpu()

    def stop(self) -> None:
        self._running = False


class TimerFactory:
    """Kept for API parity with the reference (Timer.h:131)."""

    def get_timer(self) -> Timer:
        return Timer()
