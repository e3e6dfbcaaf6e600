"""Host-side microsecond timer (ref ``driver/xrt/include/accl/timing.hpp``:
a start/stop/elapsed µs timer used by the benchmark harness)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._t0 = 0
        self._t1 = 0
        self._running = False

    def start(self) -> None:
        self._t0 = time.perf_counter_ns()
        self._running = True

    def stop(self) -> None:
        self._t1 = time.perf_counter_ns()
        self._running = False

    def elapsed_us(self) -> float:
        end = time.perf_counter_ns() if self._running else self._t1
        return (end - self._t0) / 1e3

    def elapsed_ns(self) -> int:
        end = time.perf_counter_ns() if self._running else self._t1
        return end - self._t0

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
