"""Asynchronous request model (the port's copy of ``accl_tpu/request.py``).

An engine completes a request when it has LAUNCHED the call's device
work; on a CUDA device it also hands over the event recorded on the
launching stream right after the launch.  ``wait()`` then blocks on that
event alone, so waiting on one call never synchronises the whole device.

:class:`CommandQueue` holds the facade's open batch: calls queue there
between ``begin_batch()`` and ``flush()``, and ``drain()`` hands the run
to ``engine.start_batch`` as one flush.
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Optional

from .constants import ACCLError, ErrorCode


class RequestStatus(enum.IntEnum):
    QUEUED = 0
    EXECUTING = 1
    COMPLETED = 2


_request_ids = itertools.count(1)


class Request:
    def __init__(self, op_name: str = ""):
        self.id = next(_request_ids)
        self.op_name = op_name
        self._done = threading.Event()
        self._status = RequestStatus.QUEUED
        self._retcode = ErrorCode.OK
        self._duration_ns = 0
        #: structured failure context recorded by the engine at completion
        self.error_context: Optional[dict] = None
        #: CUDA event recorded after the call's last launch (None on CPU)
        self.event = None
        #: flush hook armed by the facade while the request sits in an
        #: unflushed batch (waiting on it dispatches the batch)
        self._pre_wait = None
        #: True when the call ran as a slot of a command-ring window
        self.ring_resident: Optional[bool] = None

    # -- engine side --------------------------------------------------------
    def mark_executing(self) -> None:
        self._status = RequestStatus.EXECUTING

    def complete(
        self,
        retcode: ErrorCode,
        duration_ns: int = 0,
        context: Optional[dict] = None,
        event=None,
    ) -> None:
        self._retcode = ErrorCode(retcode)
        self.error_context = context
        self._duration_ns = int(duration_ns)
        self.event = event
        self._status = RequestStatus.COMPLETED
        self._done.set()

    # -- user side ----------------------------------------------------------
    def done(self) -> bool:
        """Engine-side completion probe: no batch flush, no device wait."""
        return self._done.is_set()

    def _auto_flush(self) -> None:
        hook, self._pre_wait = self._pre_wait, None
        if hook is not None:
            hook()  # waiting on a queued request flushes its batch

    @property
    def status(self) -> RequestStatus:
        return self._status

    def test(self) -> bool:
        """Non-blocking: True once the call was launched and its device
        work has finished (flushes the batch that holds it)."""
        self._auto_flush()
        if not self._done.is_set():
            return False
        return self.event is None or self.event.query()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the call was launched (at most ``timeout`` seconds),
        then until its device work has finished.  False on timeout.
        Flushes the batch that holds it."""
        self._auto_flush()
        if not self._done.wait(timeout):
            return False
        if self.event is not None:
            self.event.synchronize()
        return True

    def get_retcode(self) -> ErrorCode:
        return self._retcode

    def get_duration_ns(self) -> int:
        """Host-measured launch duration of the call in nanoseconds."""
        return self._duration_ns

    def check(self, context: str = "") -> None:
        if self._retcode != ErrorCode.OK:
            raise ACCLError(
                self._retcode, context or self.op_name,
                details=self.error_context,
            )


class CommandQueue:
    """FIFO of ``(options, request)`` pairs: the facade's open batch,
    drained as one flush unit (the counterpart of the JAX package's
    ``CommandQueue`` push/drain)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: list = []

    def push(self, item) -> None:
        with self._lock:
            self._items.append(item)

    def drain(self) -> list:
        """Atomically take every queued item; [] when empty."""
        with self._lock:
            items, self._items = self._items, []
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
