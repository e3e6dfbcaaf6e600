"""Asynchronous request model (the port's copy of ``accl_tpu/request.py``).

An engine completes a request when it has LAUNCHED the call's device
work; on a CUDA device it also hands over the event recorded on the
launching stream right after the launch.  ``wait()`` then blocks on that
event alone, so waiting on one call never synchronises the whole device.
An engine may also park the call's result placement on the request
(:meth:`Request.defer_result`: a received payload's copy into the
receiver's buffer); ``wait()`` / ``test()`` / ``check()`` run it first.
:meth:`Request.add_done_callback` runs a function once the request
completes (at once if it already has); the facade chains a hierarchical
call's stages and completes a pipelined call's aggregate on it.  An
aggregate's ``event`` is an :class:`EventGroup` of its stages' events.

:class:`CommandQueue` holds the facade's open batch: calls queue there
between ``begin_batch()`` and ``flush()``, and ``drain()`` hands the run
to ``engine.start_batch`` as one flush.
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Callable, Optional

from .constants import ACCLError, ErrorCode


class EventGroup:
    """The events of several launches, read as one: ``synchronize()``
    waits for every one, ``query()`` is True once all have passed.  An
    aggregate request (a hierarchical or pipelined call) holds its
    stages' events this way, so its ``wait()`` returns only after the
    last stage's device work."""

    __slots__ = ("events",)

    def __init__(self, events):
        self.events = [e for e in events if e is not None]

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()

    def query(self) -> bool:
        return all(e.query() for e in self.events)


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
        #: a parked result placement (:meth:`defer_result`), run once by
        #: the first wait / test / check after completion
        self._resolver = None
        self._cb_lock = threading.Lock()
        #: the payload the parked placement reads (dropped once it ran)
        self.device_handle = None
        #: called once by the first wait that returns: a command-ring
        #: window is drained there
        self._drain_hook = None
        #: functions run once at completion (:meth:`add_done_callback`)
        self._callbacks: list = []

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
        with self._cb_lock:
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb()

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once the request completes: at once (on this
        thread) if it already has, else on the completing thread.  Each
        callback runs exactly once."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn()

    def defer_result(self, resolver, handle=None) -> None:
        """Engine side: park the result placement (the device copy that
        delivers the result into the user's buffer) until the user waits
        or tests.  Must be called BEFORE ``complete()``."""
        self._resolver = resolver
        self.device_handle = handle

    # -- user side ----------------------------------------------------------
    def materialize(self) -> None:
        """Run the parked result placement, once (safe from concurrent
        waiters: the locked swap runs it exactly once).  A placement that
        fails downgrades an OK retcode to INVALID_OPERATION, so
        ``check()`` raises it as an ACCLError."""
        with self._cb_lock:
            resolver, self._resolver = self._resolver, None
        if resolver is None:
            return
        try:
            resolver()
        except Exception as e:
            if self._retcode == ErrorCode.OK:
                self._retcode = ErrorCode.INVALID_OPERATION
                self.error_context = {
                    "op": self.op_name,
                    "error": f"{type(e).__name__}: {e}"[:300]}
        finally:
            self.device_handle = None

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
        self.materialize()
        return self.event is None or self.event.query()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the call was launched (at most ``timeout`` seconds),
        then until its device work has finished.  False on timeout.
        Flushes the batch that holds it."""
        self._auto_flush()
        if not self._done.wait(timeout):
            return False
        self.materialize()
        if self.event is not None:
            self.event.synchronize()
        hook, self._drain_hook = self._drain_hook, None
        if hook is not None:
            hook()
        return True

    def get_retcode(self) -> ErrorCode:
        return self._retcode

    def get_duration_ns(self) -> int:
        """Host-measured launch duration of the call in nanoseconds."""
        return self._duration_ns

    def check(self, context: str = "") -> None:
        if self._done.is_set():
            self.materialize()
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
