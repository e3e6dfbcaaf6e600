"""The overlap plane: the in-flight window behind the gang engine.

The port's copy of ``accl_tpu/overlap.py``.  A gang call's launch returns
as soon as its device work is queued; :class:`InflightWindow` holds the
launched call until that work has ended and then completes its requests,
so a request completes when its device work ends, not when it was
launched, and the host may launch the next call meanwhile.

* ``park(key, waiter, on_ready, on_error)`` hands a launched call to the
  window; ``waiter`` blocks until its device work has ended (on the card
  :func:`device_waiter`: the launch's CUDA event, asked first and then,
  while it has not passed, its blocking ``synchronize``, which sleeps in
  the driver; or a persistent run's ticket).  One drainer
  thread per active key (a communicator id) runs the waiters in launch
  order and fires ``on_ready(overlap_ns, depth, ready_ns)``; keys drain
  independently, so a wedged communicator never holds up another.
* ``park`` applies backpressure: a key with ``depth`` calls in flight
  makes the next launch wait for the oldest, bounded by
  ``park_timeout_s`` (past it the launch parks over depth, so the
  facade's own deadlines can still fire).  ``set_key_depth`` gives one
  key its own bound (the QoS arbiter's per-tenant window share).
* ``drain()`` / ``drain_key()`` block until the window (or one key) is
  empty, bounded by their timeout: the drain points (``flush()``, config
  writes, ``soft_reset``, a barrier, an inline completion's ordering
  fence).  ``stop()`` (the gang's last engine shutdown) drains and then
  completes later parks on the launching thread.

``overlap_ns`` is nonzero only when a later launch of the same key parked
while the call was still in flight: evidence that its device time hid
behind host work.  A lone synchronous call reports 0.

Imports no JAX and nothing of the JAX package; on the CPU a waiter
returns at once (the plain versions run synchronously), and the window
keeps its order, depth and accounting all the same.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from .constants import (
    DEFAULT_INFLIGHT_WINDOW,
    MAX_INFLIGHT_WINDOW,
    drain_deadline_s,
)

__all__ = ["InflightWindow", "default_window_depth", "device_waiter",
           "drain_deadline_s"]

#: how long an idle per-key drainer lingers for more work before exiting
#: (one thread per ACTIVE communicator rather than one per call)
_DRAINER_LINGER_S = 5.0


def default_window_depth() -> int:
    """Window depth from ``ACCL_INFLIGHT_WINDOW`` (clamped to
    [1, MAX_INFLIGHT_WINDOW]), defaulting small and conservative."""
    try:
        depth = int(
            os.environ.get("ACCL_INFLIGHT_WINDOW", DEFAULT_INFLIGHT_WINDOW)
        )
    except ValueError:
        depth = DEFAULT_INFLIGHT_WINDOW
    return max(1, min(depth, MAX_INFLIGHT_WINDOW))


def device_waiter(event) -> Callable[[], None]:
    """The waiter of a launch that recorded ``event``: a CUDA event, an
    ``EventGroup`` of several, or a persistent run's ``RunTicket`` (each
    has ``query()`` and ``synchronize()``).  It asks first: a short
    call's work has usually ended by the time the drainer reaches it,
    and then no blocking wait (the driver's wake-up) is paid.  None (the
    CPU, where the plain versions have run by the time the launch
    returns) waits for nothing."""
    if event is None:
        return _no_wait

    def wait(event=event) -> None:
        if not event.query():
            event.synchronize()

    return wait


def _no_wait() -> None:
    return None


class _Entry:
    __slots__ = (
        "key", "waiter", "on_ready", "on_error", "parked_ns", "depth",
        "overlapped", "ring",
    )

    def __init__(self, key, waiter, on_ready, on_error, parked_ns, depth,
                 ring=False):
        self.key = key
        self.waiter = waiter
        self.on_ready = on_ready
        self.on_error = on_error
        self.parked_ns = parked_ns
        self.depth = depth
        # set when a LATER launch of this key parks while this entry is
        # still in flight: the witness that its device time was hidden
        self.overlapped = False
        # a command-ring window (one entry for a whole window of calls)
        self.ring = ring


class InflightWindow:
    """Bounded per-key FIFO of launched calls whose device work has not
    ended.

    One drainer thread per ACTIVE key (started lazily, lingering briefly,
    exiting when idle) completes that key's entries in park order;
    per-key counts enforce the depth bound.  Every counter in
    :meth:`stats` is cumulative over the window's lifetime.
    """

    def __init__(self, depth: Optional[int] = None,
                 park_timeout_s: float = 120.0):
        self.depth = depth if depth is not None else default_window_depth()
        self.park_timeout_s = float(park_timeout_s)
        # per-key depth overrides: a tenant communicator's share of the
        # window (SET_TENANT_WINDOW_SHARE); other keys ride the depth
        self._key_depth: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # per-key FIFO; the head is the entry its drainer waits on (still
        # counted in flight until its completion ran)
        self._pending: Dict[Any, List[_Entry]] = {}
        self._threads: Dict[Any, threading.Thread] = {}
        self._total = 0
        self._stopped = False
        self.launched = 0
        self.completed = 0
        self.failed = 0
        self.max_depth_seen = 0
        self.overlap_ns_total = 0
        # command-ring windows parked with ring=True (each one entry for
        # a whole window of calls; counted in windows, never in runs)
        self.ring_launched = 0
        self.ring_completed = 0

    # -- engine side ---------------------------------------------------------
    def set_depth(self, depth: int) -> None:
        with self._cv:
            self.depth = max(1, min(int(depth), MAX_INFLIGHT_WINDOW))
            self._cv.notify_all()

    def set_key_depth(self, key: Any, depth: Optional[int]) -> None:
        """Per-key depth override (the QoS arbiter's per-tenant window
        share): ``key``'s launches bound at ``depth`` instead of the
        global depth; ``None`` clears the override.  Widening wakes
        parked launchers as :meth:`set_depth` does."""
        with self._cv:
            if depth is None:
                self._key_depth.pop(key, None)
            else:
                self._key_depth[key] = max(
                    1, min(int(depth), MAX_INFLIGHT_WINDOW)
                )
            self._cv.notify_all()

    def depth_for(self, key: Any) -> int:
        """The depth bound governing ``key`` right now."""
        with self._lock:
            return self._key_depth.get(key, self.depth)

    def park(
        self,
        key: Any,
        waiter: Callable[[], None],
        on_ready: Callable[[int, int, int], None],
        on_error: Callable[[BaseException], None],
        ring: bool = False,
    ) -> None:
        """Queue one launched call.  ``waiter`` blocks until its device
        work has ended; ``on_ready(overlap_ns, depth_at_park,
        ready_perf_ns)`` completes its requests; ``on_error(exc)`` maps a
        failure of the waiter onto them.  Blocks the caller while ``key``
        is at its depth bound (backpressure, bounded by
        ``park_timeout_s``), and runs synchronously once the window was
        stopped.  ``ring=True`` marks a command-ring window (counted in
        ``ring_launched`` / ``ring_completed``)."""
        with self._cv:
            stopped = self._stopped
            if not stopped:
                # backpressure: wait for the key's oldest in-flight call,
                # but only up to the bound; past it park over depth so the
                # launch still returns and the facade's deadlines can fire
                deadline = time.monotonic() + self.park_timeout_s
                while (
                    len(self._pending.get(key, ()))
                    >= self._key_depth.get(key, self.depth)
                    and not self._stopped
                ):
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    self._cv.wait(min(rem, 1.0))
                stopped = self._stopped
            if not stopped:
                fifo = self._pending.setdefault(key, [])
                for earlier in fifo:
                    # this launch witnesses that every in-flight call of
                    # the key overlapped host work
                    earlier.overlapped = True
                parked_ns = time.perf_counter_ns()
                depth = len(fifo) + 1
                entry = _Entry(key, waiter, on_ready, on_error,
                               parked_ns, depth, ring=ring)
                fifo.append(entry)
                self._total += 1
                self.launched += 1
                if ring:
                    self.ring_launched += 1
                self.max_depth_seen = max(self.max_depth_seen, depth)
                t = self._threads.get(key)
                if t is None:
                    t = threading.Thread(
                        target=self._run, args=(key,),
                        name=f"accl-overlap-drain-{key}", daemon=True,
                    )
                    self._threads[key] = t
                    t.start()
                self._cv.notify_all()
                return
        # stopped: complete on the launching thread (still a launch, so
        # completed == launched stays the leak check)
        with self._lock:
            self.launched += 1
            if ring:
                self.ring_launched += 1
        self._complete(
            _Entry(key, waiter, on_ready, on_error,
                   time.perf_counter_ns(), 1, ring=ring)
        )

    # -- drain points --------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every parked call has completed (True) or the
        timeout expired (False)."""
        deadline = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        with self._cv:
            while self._total > 0:
                rem = None
                if deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        return False
                self._cv.wait(rem if rem is not None else 1.0)
            return True

    def drain_key(self, key: Any, timeout: Optional[float] = None) -> bool:
        """Block until every parked call of ``key`` has completed (True)
        or the timeout expired (False): the per-communicator ordering
        fence (an inline completion must not overtake the key's launched
        calls).  A no-op on the key's own drainer thread (a completion
        callback that re-enters the engine must not wait on itself)."""
        deadline = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        with self._cv:
            if self._threads.get(key) is threading.current_thread():
                return True
            while self._pending.get(key):
                rem = None
                if deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        return False
                self._cv.wait(rem if rem is not None else 1.0)
            return True

    def stop(self, timeout: float = 60.0) -> None:
        """Engine shutdown: drain (bounded: shutdown ends even over a
        wedged call), then complete later parks on the launching thread
        (no thread left behind)."""
        self.drain(timeout)
        with self._cv:
            self._stopped = True
            threads = list(self._threads.values())
            self._cv.notify_all()
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    # -- introspection -------------------------------------------------------
    def in_flight(self) -> int:
        with self._lock:
            return self._total

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": self.depth,
                "key_depths": dict(self._key_depth),
                "in_flight": self._total,
                "max_depth_seen": self.max_depth_seen,
                "launched": self.launched,
                "completed": self.completed,
                "failed": self.failed,
                "overlap_ns_total": self.overlap_ns_total,
                "ring_launched": self.ring_launched,
                "ring_completed": self.ring_completed,
            }

    # -- drainer (one per active key) ----------------------------------------
    def _run(self, key) -> None:
        while True:
            with self._cv:
                fifo = self._pending.get(key)
                if not fifo:
                    if self._stopped:
                        self._threads.pop(key, None)
                        return
                    # linger for more work before exiting, so steady
                    # traffic reuses one thread per communicator
                    self._cv.wait_for(
                        lambda: bool(self._pending.get(key))
                        or self._stopped,
                        timeout=_DRAINER_LINGER_S,
                    )
                    fifo = self._pending.get(key)
                    if not fifo:
                        self._threads.pop(key, None)
                        return
                entry = fifo[0]  # stays counted until completion ran
            self._complete(entry)
            with self._cv:
                fifo = self._pending.get(key)
                if fifo and fifo[0] is entry:
                    fifo.pop(0)
                    if not fifo:
                        self._pending.pop(key, None)
                self._total -= 1
                self._cv.notify_all()

    def _complete(self, entry: _Entry) -> None:
        try:
            entry.waiter()
        except Exception as e:  # the device work failed or never ended
            with self._lock:
                self.failed += 1
                self.completed += 1
                if entry.ring:
                    self.ring_completed += 1
            try:
                entry.on_error(e)
            except Exception:  # a completion must never kill the drainer
                traceback.print_exc()
            return
        ready_ns = time.perf_counter_ns()
        overlap_ns = (
            max(0, ready_ns - entry.parked_ns) if entry.overlapped else 0
        )
        with self._lock:
            self.completed += 1
            if entry.ring:
                self.ring_completed += 1
            self.overlap_ns_total += overlap_ns
        try:
            entry.on_ready(overlap_ns, entry.depth, ready_ns)
        except Exception:  # a completion must never kill the drainer
            traceback.print_exc()
