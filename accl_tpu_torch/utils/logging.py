"""Leveled engine logging (ref: the emulator's hlslib ``Log`` with a
verbosity flag, cclo_emu.cpp:511-514 — every DMA/switch/packet event is
printed at high verbosity).  Level comes from the ``ACCL_DEBUG`` env var
like the reference host driver's ``debug()`` gate (driver/xrt/src/common.cpp).

TRACE routing: per-message wire events (``ACCL_DEBUG=TRACE``) are
BUFFERED into the telemetry plane's ring (``accl_tpu_torch.telemetry.
wire_event``) instead of written synchronously to stderr — a synchronous
write under the emitter's lock costs tens of microseconds per message and
perturbs exactly the timings tracing is meant to observe.  The buffered
events render on dump: ``ACCL.telemetry_snapshot()["wire_trace"]`` and as
instant events in the exported Chrome/Perfetto trace.  Set
``ACCL_TRACE_STDERR=1`` to opt the synchronous stderr sink back in
(sampling still applies to the ring via ``ACCL_TELEMETRY_SAMPLE``).
ERROR/INFO/DEBUG keep the stderr behavior — they are low-rate.
"""

from __future__ import annotations

import enum
import os
import sys
import threading
import time

from ..telemetry import wire_event


class LogLevel(enum.IntEnum):
    NONE = 0
    ERROR = 1
    INFO = 2
    DEBUG = 3
    TRACE = 4  # per-message wire events


def trace_to_stderr() -> bool:
    """The opt-in synchronous sink for TRACE events (legacy behavior)."""
    return os.environ.get("ACCL_TRACE_STDERR", "0") == "1"


class Log:
    _lock = threading.Lock()

    def __init__(self, name: str, level=None):
        self.name = name
        if level is None:
            raw = os.environ.get("ACCL_DEBUG", "0")
            try:
                level = int(raw)
            except ValueError:
                # accept level names ("trace"); anything else means off —
                # a debug env var must never crash startup
                level = getattr(LogLevel, raw.strip().upper(), LogLevel.NONE)
        clamped = max(int(LogLevel.NONE), min(int(level), int(LogLevel.TRACE)))
        self.level = LogLevel(clamped)

    def _emit(self, lvl: LogLevel, msg: str) -> None:
        if lvl > self.level:
            return
        if lvl == LogLevel.TRACE and not trace_to_stderr():
            # buffered: the wire ring, rendered on dump (telemetry
            # snapshot / trace export) — never a synchronous write on
            # the path being traced
            wire_event(self.name, msg)
            return
        with Log._lock:
            print(
                f"[{time.monotonic():12.6f}] {lvl.name:5s} {self.name}: {msg}",
                file=sys.stderr,
            )

    def error(self, msg: str) -> None:
        self._emit(LogLevel.ERROR, msg)

    def info(self, msg: str) -> None:
        self._emit(LogLevel.INFO, msg)

    def debug(self, msg: str) -> None:
        self._emit(LogLevel.DEBUG, msg)

    def trace(self, msg: str) -> None:
        self._emit(LogLevel.TRACE, msg)
