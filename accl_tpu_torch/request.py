"""Asynchronous request model (the port's copy of ``accl_tpu/request.py``).

The gang engine completes a request when the call's device work has
ended: its in-flight window (``overlap.InflightWindow``) waits on the
event recorded on the launching stream right after the launch and then
completes the request, handing the event over with it (an engine may
still complete a request whose device work is queued with its event: a
p2p delivery, a stream port's copy).  ``wait()`` then blocks on that
event alone, so waiting on one call never synchronises the whole device.
An engine may also park the call's result placement on the request
(:meth:`Request.defer_result`: a received payload's copy into the
receiver's buffer); ``wait()`` / ``test()`` / ``check()`` run it first.
:meth:`Request.add_done_callback` runs a function once the request
completes (at once if it already has); the facade chains a hierarchical
call's stages and completes a pipelined call's aggregate on it.  An
aggregate's ``event`` is an :class:`EventGroup` of its stages' events.

The telemetry plane hooks in at completion: the facade arms a request
through ``Telemetry.attach`` (``_telemetry`` and ``_tmeta``, set under
``_cb_lock``), and ``complete()`` appends its one flight record.  A
later failure of a completed request (a parked placement that fails, a
run's failure latch after its windows completed at post) appends an
amended record, and ``check()`` ships the flight-recorder tail in the
``ACCLError``'s details.  A gang call's record carries ``duration_ns``
from the gang's start to its device end, and the window's
``overlap_ns`` / ``inflight_depth``.

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
        #: the telemetry plane: armed by ``Telemetry.attach``; complete()
        #: appends one CallRecord (``_recorded`` keeps it to one)
        self._telemetry = None
        self._tmeta: Optional[dict] = None
        self._recorded = False
        #: the overlap plane, stamped by the in-flight window's drainer
        #: before complete(): how long the call stayed in flight while a
        #: later launch of its communicator was parked (None when nothing
        #: overlapped it), and the window depth it was parked at (None
        #: for a call that rode no window)
        self.overlap_ns: Optional[int] = None
        self.inflight_depth: Optional[int] = None

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
        prev = self._retcode
        self._retcode = ErrorCode(retcode)
        self.error_context = context
        self._duration_ns = int(duration_ns)
        self.event = event
        self._status = RequestStatus.COMPLETED
        with self._cb_lock:
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
            tel, meta = self._telemetry, self._tmeta
            first = not self._recorded
            self._recorded = True
        if tel is not None and (first or (
                prev == ErrorCode.OK and self._retcode != ErrorCode.OK)):
            # one record a call; a completed call failing later (a run's
            # failure latch) is amended, never counted twice.  A
            # telemetry failure must never fail the call it observes
            try:
                tel.record(meta, self._duration_ns, self._retcode,
                           self.error_context, amend=not first,
                           overlap_ns=self.overlap_ns,
                           inflight_depth=self.inflight_depth,
                           ring_resident=self.ring_resident)
            except Exception:  # pragma: no cover - defensive
                pass
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
                if self._telemetry is not None and self._tmeta is not None:
                    # the completion-time record said OK: amend it, so
                    # the failed placement is in the history and counted
                    try:
                        self._telemetry.record(
                            self._tmeta, self._duration_ns, self._retcode,
                            self.error_context, amend=True)
                    except Exception:  # pragma: no cover - defensive
                        pass
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
        """Non-blocking: True once the call completed and its device work
        has finished (flushes the batch that holds it)."""
        self._auto_flush()
        if not self._done.is_set():
            return False
        self.materialize()
        return self.event is None or self.event.query()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the call completed (at most ``timeout`` seconds),
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
        """The call's duration in nanoseconds on the host's clock: for a
        gang call from the gang's start to its device end (the in-flight
        window's view of it), as the JAX gang measures it."""
        return self._duration_ns

    def check(self, context: str = "") -> None:
        if self._done.is_set():
            self.materialize()
        if self._retcode != ErrorCode.OK:
            details = self.error_context
            if self._telemetry is not None:
                # a failure ships with its recent history
                details = dict(details or {})
                details["flight_recorder"] = self._telemetry.tail_dicts()
            raise ACCLError(
                self._retcode, context or self.op_name,
                details=details,
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
