"""The gang engine's command ring: batched windows as sequencer launches
and persistent runs.

The counterpart of ``accl_tpu/backends/xla/cmdring.py``.  A flushed batch
of eligible collectives (and, on a world-2 gang, matched SEND/RECV pairs,
one slot each with root = src and peer = dst) is encoded into the slots
of the communicator's ring (``seqn`` and ``head`` advance per slot, the
head wraps past the ring depth); each window of at most ``depth`` slots
is one refill, the one host interaction of its window:

* a lone window runs inline: ONE launch of the sequencer kernel
  (``ops/cmdring.py``), which decodes the slot words on the device;
* a window posted while an earlier window of its session is still in
  flight arms a persistent *run* (one dispatch) and rides it; later
  windows of that shape are mailbox posts while the run accepts them
  (``mailbox_posts``), so a warm stream of K windows costs at most one
  dispatch.  On the card a window is in flight until the gang's
  in-flight window retired it (its event or its run's ticket passed), as
  JAX's drainer retires a window; on the CPU, where the plain sequencer
  has run by the time the launch returns, the stream detector counts a
  window in flight until every rank of it passed a facade drain point
  (``end_batch`` or a request's ``wait``).  On the CPU a run is a thread
  (``accl-cmdring-run``) draining the port's
  :class:`~accl_tpu_torch.cmdring.SequencerMailbox` with the plain
  sequencer; on the card it is one cooperative launch of the persistent
  kernel (``ops.cuda.cmdring.PersistentRun``) polling host-mapped memory,
  each window's ticket standing in for an event.  As in the JAX package,
  the lowering that arms runs (``xla``) is the default off the
  accelerator; on the card the default is ``pallas``, every window
  inline, and ``ACCL_CMDRING_LOWERING=xla`` arms runs there too
  (``default_lowering``).

Every window, inline or posted, is parked in the gang's in-flight window
(``ring=True``) under its communicator's id, and its requests complete
from there once its device work has ended (at once for the CPU's inline
window, at the run thread's completion for a CPU run's), with the
window's ``overlap_ns`` and ``inflight_depth``; a failed wait (a run's
failure latch, the drain deadline) fails them.  A communicator with a QoS
slot budget (``set_slot_budget``, the arbiter's ``SET_TENANT_RING_SLOTS``)
has its batches cut into windows of at most that many slots
(``budgeted_windows``); ``comm_slots`` counts each communicator's slots.

A batch the ring refuses runs position by position through the per-call
path, with the reason counted in :meth:`GangCommandRing.stats` under the
JAX package's names: ``tuning_override``, ``unsupported_op``,
``oversized``, ``host_operands``, ``mixed_dtype``, ``data_dependency``,
``p2p_unpaired`` and the ``fused_*`` reasons (``fused_decomposed`` is
counted by the engine).

Lifecycle, as the JAX ring's: *parked* (no run accepting, no window in
flight), *resident* (a run lingers on its mailbox), *armed* (windows in
flight).  ``reset()`` halts every run and realigns seqn and head at 0;
``halt_sessions()`` (engine shutdown) halts and joins every run.

The window log (the JAX ring's introspection plane): every window is
logged exactly once, whichever way it completed (inline, a run, or a
failure), with its slots' seqn, opcode, retcode and issuing trace id
beside its host-side timing (``basis: "host"``) and, for a run's window,
its mailbox timestamps (``mailbox_us``); ``stats()`` carries the log's
tail and a window-latency histogram, and :meth:`GangCommandRing.
trace_events` renders the log as Perfetto spans flow-linked to the
issuing calls.  A window is logged when the in-flight window retires it,
so its logged duration runs from the gang's start to its device end.

The fault planes, as the JAX ring's: each communicator has a circuit
breaker (``breaker_for``, ``ACCL_CMDRING_COOLDOWN_S``); a failed window
(a dispatch error, a run's failure latch) is a strike, and while the
breaker is open the ring refuses the comm's batches, counted as
``circuit_open`` (:func:`circuit_open_total` sums them over the
process); after the cool-down one probe window runs inline, and its
completion closes the breaker.  What takes a refused batch is the
gang's choice: on the CPU JAX's host path, on the card never the plain
lowering (``CudaGangContext._circuit_refused``).  The chaos hook shows
each window to the fault injector installed by
``contract.install_fault_plan`` as one ``RING`` pseudo-message:
``corrupt`` and ``drop`` write an opcode outside every lowering's range
into the first slot, so the sequencer reports BAD_OP (status word 2)
and that slot's requests fail with INVALID_OPERATION at once;
``delay`` sleeps a bounded time before the doorbell.  ``stats()``
carries ``breakers`` and ``chaos_faults``; ``reset()`` closes every
breaker.  ``on_failure(comm_id, error)`` is the facade's postmortem
hook on a failed window.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ...cmdring import (
    _F,
    SequencerMailbox,
    WindowShape,
    complementary_pair,
    default_linger_s,
    default_run_windows,
    encode_fparam,
    encode_slot,
    fused_slot_eligible,
    register_mailbox,
    ring_widths,
    unregister_mailbox,
)
from ...constants import (
    CMDRING_DEPTH_DEFAULT,
    CMDRING_DEPTH_ENV,
    CMDRING_ENV,
    CMDRING_FUSED_OPCODES,
    CMDRING_LOWERING_ENV,
    CMDRING_MAX_BYTES_ENV,
    CMDRING_MAX_DEPTH,
    CMDRING_MAX_PAYLOAD_BYTES,
    CMDRING_OPCODES,
    CMDRING_SLOT_WORDS,
    CMDRING_ST_OK,
    ErrorCode,
    FusedCompute,
    Operation,
    drain_deadline_s,
    dtype_to_torch,
)
from ...membership import CircuitBreaker
from ...ops.cmdring import run_window, status_words
from ...telemetry import _perf_to_epoch_us
from ...utils.profiling import annotate
from ...ops.cuda.cmdring import (
    PersistentRun,
    RunTicket,
    launches_for,
    result_width,
    sequencer_plain,
    spans_of,
    takes_lanes,
    _check_window,
    _hazards,
    _words,
)

#: ops whose operand/result widths scale with world size
_P_WIDE = (Operation.REDUCE_SCATTER, Operation.ALLTOALL)

#: the algorithm registers whose non-default value keeps its meaning
#: (the ring is its own lowering and must not shadow a requested one)
BATCH_TUNING_KEYS = (
    "allreduce_algorithm", "reduce_algorithm", "bcast_algorithm",
    "scatter_algorithm", "gather_algorithm",
)


#: the ring's circuit breaker (the membership plane): strikes a comm's
#: failed windows, opens after the threshold, re-probes after the
#: cool-down
CMDRING_BREAKER_COOLDOWN_ENV = "ACCL_CMDRING_COOLDOWN_S"
CMDRING_BREAKER_COOLDOWN_S = 2.0
CMDRING_BREAKER_THRESHOLD = 2

#: ``circuit_open`` refusals over every ring of the process
_circuit_opens = 0
_circuit_lock = threading.Lock()


def circuit_open_total() -> int:
    """Batches an open breaker refused, over every ring of the
    process."""
    return _circuit_opens


#: the opcode word chaos poisoning writes into a window's first slot: out
#: of every lowering's range, so the sequencer reports BAD_OP
_CHAOS_BAD_OPCODE = 0x7F
#: the longest sleep a ``delay`` verdict may put before a doorbell
_CHAOS_MAX_DELAY_S = 1.0


class _RingMsgType:
    """The message type a window shows the fault injector:
    ``FaultRule(msg_type="RING")`` matches it, an int rule never does."""

    name = "RING"

    def __int__(self) -> int:
        return -1

    def __str__(self) -> str:
        return "RING"


_RING_MSG_TYPE = _RingMsgType()


class _RingRefillMsg:
    """One window as the fault injector sees it: the host encode (src 0)
    ringing the doorbell; ``dst`` is None, so only wildcard-dst rules
    reach it."""

    __slots__ = ("comm_id", "src", "dst", "tag", "msg_type", "seqn")

    def __init__(self, comm_id: int, seqn: int):
        self.comm_id = comm_id
        self.src = 0
        self.dst = None
        self.tag = 0
        self.msg_type = _RING_MSG_TYPE
        self.seqn = seqn


def _env_mode() -> str:
    return os.environ.get(CMDRING_ENV, "1").strip().lower()


def default_lowering(device: torch.device) -> str:
    """The sequencer lowering: ``pallas`` (every window inline, one
    launch) on the card, ``xla`` (a stream of windows arms a persistent
    run) on the CPU, as the JAX package keeps its inline kernel on the
    TPU and its persistent session elsewhere.  ``ACCL_CMDRING_LOWERING``
    overrides it."""
    explicit = os.environ.get(CMDRING_LOWERING_ENV, "").strip().lower()
    if explicit in ("xla", "pallas"):
        return explicit
    return "pallas" if device.type == "cuda" else "xla"


def buffer_root(buf) -> int:
    """Identity of the storage a buffer views (slices of one buffer share
    it), the key of the ``data_dependency`` screen."""
    return buf.tensor.untyped_storage().data_ptr()


class _Window:
    """One refill window: its slots' plans, calls and requests, and how it
    completes.  ``event`` is the inline launch's CUDA event or a run's
    ticket (None on the CPU); ``status`` its slots' status words; ``done``
    is set once its results are in place; ``settled`` once its requests
    completed (the in-flight window retired it) or failed, and ``error``
    names the failure.  It is drained once every rank of it (``ranks``,
    their world sessions) passed a facade drain point after it ran.
    ``slots_info`` (per slot: seqn, opcode, the issuing trace id),
    ``form`` (``inline`` or ``mailbox``), ``run`` (the run it rode) and
    ``logged`` feed the window log."""

    __slots__ = ("window_id", "comm_id", "plans", "calls", "reqs", "widths",
                 "t0", "event", "status", "done", "settled", "error",
                 "ranks", "drained_by", "writes", "slots_info", "form",
                 "run", "logged")

    def __init__(self, window_id, plans, calls, reqs, widths, t0, ranks,
                 comm_id=0):
        self.window_id = window_id
        self.comm_id = comm_id
        self.slots_info: list = []
        self.form = "inline"
        self.run = None
        self.logged = False
        self.plans = plans
        self.calls = calls
        self.reqs = reqs
        self.widths = widths
        self.t0 = t0
        self.event = None
        self.status = None
        self.done = threading.Event()
        self.settled = False
        self.error: Optional[str] = None
        self.ranks = tuple(ranks)
        self.drained_by: set = set()
        self.writes = {buffer_root(calls[k][r].res)
                       for k, plan in enumerate(plans)
                       for r in plan["writers"]
                       if calls[k][r].res is not None
                       and not calls[k][r].res.is_dummy}

    @property
    def drained(self) -> bool:
        return len(self.drained_by) >= len(self.ranks)

    def in_flight(self) -> bool:
        """The stream detector's notion: on the card until the in-flight
        window retired it; on the CPU (no event) until every rank of it
        passed a drain point."""
        if self.event is None:
            return not self.drained
        return not self.settled

    def wait(self, timeout: float) -> None:
        ev = self.event
        if ev is not None:
            ev.synchronize()
        else:
            self.done.wait(timeout)


class _ResidentRun:
    """One live sequencer run: its mailbox, what executes it (the CPU's
    ``accl-cmdring-run`` thread, or the card's persistent kernel), the
    windows it took and its failure latch.  The thread exists per run,
    not per window: a warm stream of K windows costs one spawn, as it
    costs one dispatch."""

    __slots__ = ("mbox", "mbox_id", "shape", "thread", "device_run",
                 "failed", "exc", "windows")

    def __init__(self, mbox, shape, device_run=None):
        self.mbox = mbox
        self.mbox_id = register_mailbox(mbox) if device_run is None else 0
        self.shape = shape
        self.thread: Optional[threading.Thread] = None
        self.device_run: Optional[PersistentRun] = device_run
        self.failed = threading.Event()
        self.exc: Optional[BaseException] = None
        self.windows: List[tuple] = []  # (index in the run, _Window)

    def ended(self) -> bool:
        """Whether what executes the run has returned."""
        if self.device_run is not None:
            return self.device_run.ended()
        return self.thread is None or not self.thread.is_alive()

    def join(self, timeout: float) -> None:
        self.mbox.halt()
        if self.device_run is not None:
            self.device_run.join(timeout)
        elif self.thread is not None:
            self.thread.join(timeout)
        if self.mbox_id:
            unregister_mailbox(self.mbox_id)


class _DeviceMailbox:
    """A card run's mailbox: the host side of
    :class:`~accl_tpu_torch.cmdring.SequencerMailbox` over a
    :class:`PersistentRun`, which pulls its windows from mapped memory.
    ``post``'s payload is the window's ``(operand rows, result rows)``."""

    def __init__(self, run: PersistentRun):
        self.run = run
        self.run_windows = run.run_windows
        self.linger_s = run.linger_s
        self.index: Dict[int, int] = {}  # window id -> index in the run
        # the host's post time a window (the run pulls and pushes on the
        # device, where the host has no clock to read)
        self._timings: Dict[int, Dict[str, int]] = {}

    def post(self, window_id: int, slots, payload) -> bool:
        xs, outs = payload
        t = time.perf_counter_ns()
        k = self.run.post(slots, xs, outs)
        if k is None:
            return False
        self.index[window_id] = k
        self._timings[window_id] = {"posted_ns": t}
        return True

    def take_timing(self, window_id: int) -> Optional[Dict[str, int]]:
        """The window's host timing record, removed."""
        return self._timings.pop(window_id, None)

    def halt(self) -> None:
        self.run.halt()

    @property
    def accepting(self) -> bool:
        return self.run.accepting

    def depth(self) -> int:
        return max(0, self.run.posted - self.run.done())


class _RingSession:
    """Per-communicator ring state: the host mirror of the ring (slot i of
    refill k+1 reuses the words of slot i of refill k-depth), the monotone
    seqn, the live run, the windows not yet drained, and the last window's
    status words."""

    __slots__ = ("ring", "head", "seqn", "run", "windows", "last")

    def __init__(self, depth: int):
        self.ring = np.zeros((depth, CMDRING_SLOT_WORDS), np.int32)
        self.head = 0
        self.seqn = 0
        self.run: Optional[_ResidentRun] = None
        self.windows: List[_Window] = []
        # the last window's status: ("host", tensor, event), ("run",
        # PersistentRun, index, slots) or ("words", array)
        self.last = None


class GangCommandRing:
    """One gang context's command ring (all communicators' sessions)."""

    def __init__(self, gang):
        self.gang = gang
        mode = _env_mode()
        self.enabled = mode not in ("0", "off", "false", "")
        self.eager = mode == "eager"
        try:
            depth = int(os.environ.get(CMDRING_DEPTH_ENV,
                                       CMDRING_DEPTH_DEFAULT))
        except ValueError:
            depth = CMDRING_DEPTH_DEFAULT
        self.depth = max(1, min(depth, CMDRING_MAX_DEPTH))
        try:
            self.max_bytes = int(os.environ.get(CMDRING_MAX_BYTES_ENV,
                                                CMDRING_MAX_PAYLOAD_BYTES))
        except ValueError:
            self.max_bytes = CMDRING_MAX_PAYLOAD_BYTES
        self.lowering = default_lowering(gang.device)
        self.run_windows = default_run_windows()
        self.linger_s = default_linger_s()
        self._lock = threading.Lock()
        self._sessions: Dict[int, _RingSession] = {}
        self._retired: List[_ResidentRun] = []  # halted, maybe still running
        # windows a CPU run has not completed, by id (ids are the ring's,
        # monotone, so a reset never reuses one)
        self._pending: Dict[int, _Window] = {}
        self._next_window = 0
        self.refills = 0          # refill windows (= doorbells)
        self.dispatches = 0       # launches: inline windows and runs armed
        self.mailbox_posts = 0    # refills that rode a live run
        self.slots_enqueued = 0   # collectives executed ring-resident
        self.wraps = 0            # head wrapped past the ring depth
        self.resets = 0           # reset() teardowns
        self.max_window = 0
        self.last_window = 0
        self.op_slots: Dict[str, int] = {}
        self.fallbacks: Dict[str, int] = {}
        # the window log: per-slot facts beside the host-side timing, and
        # a window-latency log2-us histogram
        try:
            log_cap = int(os.environ.get("ACCL_CMDRING_WINDOW_LOG", "64"))
        except ValueError:
            log_cap = 64
        self._window_log = deque(maxlen=max(8, log_cap))
        self.windows_logged = 0
        self.window_latency: Dict[int, int] = {}
        self.window_latency_sum_us = 0.0
        # the postmortem hook: on_failure(comm_id, error) for a failed
        # window (a dispatch error or a run's failure latch)
        self.on_failure = None
        # per-comm circuit breakers, and the chaos plane's verdicts applied
        # to windows, by action
        try:
            cooldown = float(os.environ.get(CMDRING_BREAKER_COOLDOWN_ENV,
                                            CMDRING_BREAKER_COOLDOWN_S))
        except ValueError:
            cooldown = CMDRING_BREAKER_COOLDOWN_S
        self.breaker_cooldown_s = cooldown
        self._breakers: Dict[int, CircuitBreaker] = {}
        self.chaos_faults: Dict[str, int] = {}
        # the QoS arbiter plane (SET_TENANT_RING_SLOTS): per-comm slot
        # budgets (a budgeted comm's batches cut into windows of at most
        # its budget, so a flooder pays extra doorbells instead of taking
        # whole windows), each comm's slots, and the windows a budget cut
        self._slot_budgets: Dict[int, int] = {}
        self.comm_slots: Dict[int, int] = {}
        self.budgeted_windows = 0

    # -- introspection -------------------------------------------------------
    def supports(self, op) -> bool:
        """Whether ``op`` has a sequencer opcode (SEND / RECV as matched
        pair slots)."""
        return op in CMDRING_OPCODES

    def p2p_eligible(self, options) -> bool:
        """Whether a batched SEND / RECV joins its gang's run: both ends
        must classify alike, so only pair-symmetric facts decide (the
        ring is on, a world of 2, a count); the planner screens the rest
        with both calls in view."""
        return self.enabled and options.comm.size == 2 and options.count > 0

    def _in_flight(self) -> int:
        """Windows in flight (the caller holds the lock)."""
        return sum(w.in_flight() for s in self._sessions.values()
                   for w in s.windows) + len(self._pending)

    def _resident(self) -> bool:
        """Whether a run still accepts posts, or its executor has not
        returned (the caller holds the lock)."""
        runs = [s.run for s in self._sessions.values() if s.run is not None]
        return any(r.mbox.accepting or not r.ended()
                   for r in runs + self._retired)

    @property
    def parked(self) -> bool:
        """True when no window is in flight and no run accepts posts or
        lingers: the sequencer holds nothing of the device."""
        with self._lock:
            return not self._in_flight() and not self._resident()

    def last_status(self, comm_id: int) -> Optional[np.ndarray]:
        """The most recent window's status words of a communicator, read
        from host memory once that window has completed (waiting on its
        event or ticket alone, never on the device)."""
        with self._lock:
            s = self._sessions.get(comm_id)
            last = None if s is None else s.last
        if last is None:
            return None
        if last[0] == "host":
            _, status, event = last
            if event is not None:
                event.synchronize()
            return status.numpy().copy()
        if last[0] == "run":
            _, run, k, n = last
            if not run.wait_window(k) or run.ptr is None:
                return None
            return run.status(k, n)
        return np.asarray(last[1]).copy()

    def stats(self) -> dict:
        breakers = self._breaker_snapshots()
        with self._lock:
            mboxes = [s.run.mbox for s in self._sessions.values()
                      if s.run is not None]
        mailbox_depth = sum(m.depth() for m in mboxes)
        with self._lock:
            state = ("armed" if self._in_flight()
                     else ("resident" if self._resident() else "parked"))
            return {
                "enabled": self.enabled,
                "mode": "eager" if self.eager else
                        ("batch" if self.enabled else "off"),
                "lowering": self.lowering,
                "depth": self.depth,
                "run_windows": self.run_windows,
                "linger_ms": round(self.linger_s * 1e3, 3),
                "state": state,
                "refills": self.refills,
                "doorbells": self.refills,  # every refill rings once
                "dispatches": self.dispatches,
                "mailbox_posts": self.mailbox_posts,
                "slots": self.slots_enqueued,
                "wraps": self.wraps,
                "resets": self.resets,
                "max_window": self.max_window,
                "occupancy": round(self.last_window / self.depth, 3)
                if self.last_window else 0.0,
                # refill windows a dispatch served (> 1: a run survived
                # across refills)
                "sustained_occupancy": round(
                    self.refills / self.dispatches, 3)
                if self.dispatches else 0.0,
                "ops": dict(self.op_slots),
                "fallbacks": dict(self.fallbacks),
                "chaos_faults": dict(self.chaos_faults),
                "breakers": breakers,
                # the QoS plane: budgets, each comm's slots (the ring share
                # the fairness checks read) and the windows a budget cut
                "slot_budgets": {
                    str(c): b for c, b in sorted(self._slot_budgets.items())},
                "comm_slots": {
                    str(c): n for c, n in sorted(self.comm_slots.items())},
                "budgeted_windows": self.budgeted_windows,
                "mailbox_depth": mailbox_depth,
                # the window log: windows logged, the latency histogram
                # (host basis) and the log's tail
                "windows_logged": self.windows_logged,
                "window_latency_sum_us": round(
                    self.window_latency_sum_us, 3),
                "window_latency_log2_us": {
                    str(k): v
                    for k, v in sorted(self.window_latency.items())},
                "windows": list(self._window_log)[-16:],
            }

    # -- the window log ------------------------------------------------------
    def _log_window(self, rec: "_Window", status, end_ns: int,
                    error: Optional[str] = None) -> None:
        """One completed (or failed) window into the bounded log: per slot
        its seqn, opcode, retcode and issuing trace id, beside the
        host-side timing (``basis: "host"``: a window's requests complete
        at launch, and the host reads no device clock beside the status
        words); a run's window adds its mailbox timestamps.  Logged
        exactly once a window, whichever completion path ran."""
        with self._lock:
            if rec.logged:
                return
            rec.logged = True
        codes = None if status is None else np.asarray(status)[:, 1]
        slots = [dict(info, retcode=None if codes is None or k >= len(codes)
                      else int(codes[k]))
                 for k, info in enumerate(rec.slots_info)]
        t0_us = _perf_to_epoch_us(rec.t0)
        end_us = _perf_to_epoch_us(end_ns)
        lat_us = max(end_us - t0_us, 0.001)
        entry = {
            "window_id": rec.window_id,
            "comm": rec.comm_id,
            "form": rec.form,
            "ts_us": round(t0_us, 3),
            "dur_us": round(lat_us, 3),
            "slots": slots,
            "basis": "host",
        }
        if error is not None:
            entry["error"] = str(error)[:200]
        if rec.run is not None:
            timing = rec.run.mbox.take_timing(rec.window_id)
            if timing is not None:
                entry["mailbox_us"] = {
                    k.replace("_ns", "_us"): round(_perf_to_epoch_us(v), 3)
                    for k, v in timing.items()}
        with self._lock:
            self._window_log.append(entry)
            self.windows_logged += 1
            b = max(1, int(lat_us)).bit_length() - 1
            self.window_latency[b] = self.window_latency.get(b, 0) + 1
            self.window_latency_sum_us += lat_us

    def window_log(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            log = list(self._window_log)
        return log if last is None else log[-last:]

    def trace_events(self) -> List[dict]:
        """The window log as Chrome/Perfetto events: a span a window and
        a span a slot nested under it (cat ``cmdring``, which
        ``merge_traces`` dedups across rank files), each slot a flow step
        on its issuing call's trace id."""
        pid = os.getpid()
        log = self.window_log()
        if not log:
            return []
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 2,
             "args": {"name": f"cmdring (pid {pid})"}},
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": 2,
             "args": {"name": "ring windows"}},
        ]
        for entry in log:
            ts, dur = entry["ts_us"], entry["dur_us"]
            events.append({
                "name": f"cmdring::window[{len(entry['slots'])}]",
                "cat": "cmdring", "ph": "X", "ts": ts, "dur": dur,
                "pid": pid, "tid": 2,
                "args": {k: v for k, v in entry.items() if k != "slots"},
            })
            n = max(1, len(entry["slots"]))
            for k, slot in enumerate(entry["slots"]):
                # slots run in order within the window: equal sub-spans
                s_ts = ts + dur * k / n
                s_dur = dur / n
                events.append({
                    "name": f"cmdring::{slot['opcode'].lower()}",
                    "cat": "cmdring", "ph": "X", "ts": round(s_ts, 3),
                    "dur": round(s_dur, 3), "pid": pid, "tid": 2,
                    "args": dict(slot, window=entry["window_id"]),
                })
                if slot.get("trace_id"):
                    # a step on the issuing call's flow, never an end: the
                    # call's own s / f pair lives on the rank rows
                    events.append({
                        "name": "accl::flow", "cat": "cmdring", "ph": "t",
                        "id": f"0x{slot['trace_id']:08x}",
                        "ts": round(s_ts + s_dur / 2, 3),
                        "pid": pid, "tid": 2,
                        "args": {"window": entry["window_id"]},
                    })
        return events

    def _breaker_snapshots(self) -> dict:
        with self._lock:
            items = list(self._breakers.items())
        # the breakers' locks are taken outside the ring's
        return {str(c): brk.snapshot() for c, brk in items}

    def breaker_for(self, comm_id: int) -> CircuitBreaker:
        """The communicator's circuit breaker (made at first use)."""
        with self._lock:
            brk = self._breakers.get(comm_id)
            if brk is None:
                brk = self._breakers[comm_id] = CircuitBreaker(
                    threshold=CMDRING_BREAKER_THRESHOLD,
                    cooldown_s=self.breaker_cooldown_s)
            return brk

    def _window_failed(self, comm_id: int, error: str) -> None:
        """A failed window: a strike on the comm's breaker, and the
        facade's postmortem hook."""
        self.breaker_for(comm_id).record_failure(error.split(":")[0])
        hook = self.on_failure
        if hook is not None:
            try:
                hook(comm_id, error)
            except Exception:  # must never mask the failure path
                pass

    def _fallback(self, reason: str) -> bool:
        global _circuit_opens
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        if reason == "circuit_open":
            with _circuit_lock:
                _circuit_opens += 1
        return False

    def note_fallback(self, reason: str) -> None:
        """Count a ring miss decided outside run_batch (the engine's fused
        host decomposition)."""
        self._fallback(reason)

    def set_slot_budget(self, comm_id: int, slots: Optional[int]) -> None:
        """The comm's slot budget a window (the QoS arbiter's
        SET_TENANT_RING_SLOTS): its batches cut into windows of at most
        ``slots`` slots (clamped to the ring's depth); None clears it.  A
        budget is configuration and survives ``reset()``."""
        with self._lock:
            if slots is None:
                self._slot_budgets.pop(int(comm_id), None)
            else:
                self._slot_budgets[int(comm_id)] = max(
                    1, min(int(slots), self.depth))

    def slot_budget_of(self, comm_id: int) -> Optional[int]:
        with self._lock:
            return self._slot_budgets.get(int(comm_id))

    # -- drain points and teardown -------------------------------------------
    def drain(self, rank: int) -> None:
        """A facade drain point of the rank of world session ``rank``
        (its ``end_batch``): wait for every window of it not yet drained;
        a window is drained once every rank of it has passed one."""
        with self._lock:
            windows = [w for s in self._sessions.values() for w in s.windows
                       if rank in w.ranks]
        timeout = drain_deadline_s(self.gang_timeout())
        for w in windows:
            w.wait(timeout)
        with self._lock:
            for w in windows:
                w.drained_by.add(rank)
            for s in self._sessions.values():
                s.windows = [w for w in s.windows if not w.drained]

    def _drain_one(self, comm_id: int, window: _Window, rank: int) -> None:
        """A request's ``wait`` drains the window it rode for its rank."""
        with self._lock:
            window.drained_by.add(rank)
            s = self._sessions.get(comm_id)
            if s is not None and window.drained and window in s.windows:
                s.windows.remove(window)

    def gang_timeout(self) -> float:
        peers = getattr(self.gang, "peers", {})
        return max((e.timeout_s for e in peers.values()), default=30.0)

    def wait_in_flight(self, end: float) -> bool:
        """Wait until every window in flight has finished on the device
        (its event or ticket passed, or its CPU run completed it), or
        until the monotonic time ``end``; False when the time ran out."""
        with self._lock:
            windows = [w for s in self._sessions.values()
                       for w in s.windows] + list(self._pending.values())
        for w in windows:
            while True:
                ev = w.event
                if ev is None:
                    if w.done.wait(max(0.0, min(0.05,
                                                end - time.monotonic()))):
                        break
                else:
                    try:
                        if ev.query():
                            break
                    except RuntimeError:
                        break
                    time.sleep(0.0005)
                if time.monotonic() > end:
                    return False
        return True

    def reset(self) -> None:
        """Halt every run (each finishes what it was posted and returns),
        realign every session's seqn and head at 0 and close every
        breaker (the full recovery re-closes the ring)."""
        with self._lock:
            runs = [s.run for s in self._sessions.values()
                    if s.run is not None]
            self._sessions.clear()
            self._breakers.clear()
            self.resets += 1
            self._retired.extend(runs)
        for run in runs:
            run.mbox.halt()
        self._prune_retired()

    def _prune_retired(self) -> None:
        """Release the retired runs whose executors have returned."""
        with self._lock:
            keep, drop = [], []
            for run in self._retired:
                (drop if run.ended() else keep).append(run)
            self._retired = keep
        for run in drop:
            run.join(1.0)

    def halt_sessions(self) -> None:
        """Engine shutdown: halt every run and join it (bounded), so no
        thread or kernel outlives the gang."""
        with self._lock:
            runs = [s.run for s in self._sessions.values()
                    if s.run is not None]
            runs += self._retired
            self._retired = []
            for s in self._sessions.values():
                s.run = None
        for run in runs:
            run.mbox.halt()
        for run in runs:
            run.join(10.0)

    # -- position planning ---------------------------------------------------
    def _plan_barrier(self, comm, dtype) -> dict:
        return {"op": Operation.BARRIER, "n": 1, "dtype": dtype,
                "compressed": False, "wire": None, "writers": set()}

    def _plan_p2p(self, comm, calls) -> Optional[dict]:
        """A matched SEND/RECV pair position of a world-2 gang: one slot
        with root = src and peer = dst.  None when the position is not a
        complementary pair, is oversized or has an end off the device."""
        if comm.size != 2:
            return None
        pair = complementary_pair(calls)
        if pair is None:
            return None
        src, dst = pair
        snd, rcv = calls[src], calls[dst]
        n = snd.count
        if n * snd.arithcfg.uncompressed_elem_bytes > self.max_bytes:
            return None
        dtype = snd.arithcfg.uncompressed
        from ...buffer import DeviceBuffer

        def on_device(buf):
            return (isinstance(buf, DeviceBuffer) and not buf.is_dummy
                    and buf.device == self.gang.device and buf.count >= n
                    and buf.dtype == dtype)

        if not (on_device(snd.op0) and on_device(rcv.res)):
            return None
        return {"op": snd.op, "n": n, "dtype": dtype_to_torch(dtype),
                "compressed": False, "wire": None, "writers": {dst},
                "p2p": (src, dst)}

    def _plan_fused(self, comm, calls, lead, plan, fuse: int):
        """Re-validate a planned position against the fused geometry;
        returns the plan with its fuse fields, or the fallback reason."""
        in_w, _ = ring_widths(lead.op, lead.count, comm.size, fuse=fuse)
        opn = in_w
        for c in calls:
            buf = c.op0
            if buf is None or buf.is_dummy:
                opn = 0
                break
            if buf.count < in_w:
                opn = min(opn, int(buf.count))
        reason = fused_slot_eligible(
            fuse, lead.op, comm.size, lead.count, opn, plan["dtype"],
            compressed=bool(plan["compressed"]),
        )
        if reason is not None:
            return reason
        patched = dict(plan)
        patched["fuse"] = int(fuse)
        patched["fparam"] = float(lead.fuse_param)
        if FusedCompute(fuse) == FusedCompute.ATTN_HOP:
            patched["hop"] = int(lead.root_src) % comm.size
        return patched

    def _slot_opcode(self, plan):
        fuse = plan.get("fuse", 0)
        if fuse:
            return CMDRING_FUSED_OPCODES[FusedCompute(fuse)]
        return CMDRING_OPCODES[plan["op"]]

    # -- the refill path -----------------------------------------------------
    def run_batch(self, comm, entries, npos: int,
                  t0: Optional[int] = None) -> bool:
        """Execute a fully matched batch ring-resident.  Returns False,
        having launched NOTHING, when any position disqualifies (the
        sequential path then owns the batch); True once the ring owns the
        requests' completion."""
        if not self.enabled or npos == 0:
            return False
        gang = self.gang
        # the circuit breaker: an open comm's batches are refused until
        # the cool-down; half-open, one probe window runs inline (no run
        # to wedge); the probe's completion closes it
        brk = self.breaker_for(comm.id)
        verdict = brk.allow()
        if verdict == CircuitBreaker.OPEN:
            return self._fallback("circuit_open")
        probe = verdict == "probe"
        # an algorithm register (the table, or a call's tuning-plan
        # overlay) naming another lowering keeps its meaning: the ring is
        # a lowering of its own and must not shadow the requested one
        if any(gang.tuning.get(k, "xla") != "xla"
               for k in BATCH_TUNING_KEYS):
            return self._fallback("tuning_override")
        for options_list, _ in entries:
            for c in options_list:
                if c.tuning and any(c.tuning.get(k, "xla") != "xla"
                                    for k in BATCH_TUNING_KEYS):
                    return self._fallback("tuning_override")
        if t0 is None:
            t0 = time.perf_counter_ns()
        plans = []
        written: set = set()  # result roots of earlier positions
        window_dtype = None
        barrier_positions = []
        for i in range(npos):
            calls = [e[0][i] for e in entries]
            lead = calls[0]
            if lead.op in (Operation.SEND, Operation.RECV):
                plan = self._plan_p2p(comm, calls)
                if plan is None:
                    # not a complementary pair: the per-position path
                    # owns the batch (direct delivery or the channel)
                    return self._fallback("p2p_unpaired")
            elif not self.supports(lead.op):
                return self._fallback("unsupported_op")
            elif any(gang._sig(c) != gang._sig(lead) for c in calls[1:]):
                return False  # torn gang: surface through the per-call path
            elif lead.op == Operation.BARRIER:
                barrier_positions.append(i)
                plans.append((calls, lead, None))
                continue
            else:
                fuse = int(lead.fuse)
                if fuse:
                    n_eff, _ = ring_widths(lead.op, lead.count, comm.size,
                                           fuse=fuse)
                else:
                    n_eff = lead.count * (comm.size if lead.op in _P_WIDE
                                          else 1)
                if (n_eff * lead.arithcfg.uncompressed_elem_bytes
                        > self.max_bytes):
                    return self._fallback("oversized")
                plan = gang._plan_device_call(comm, calls, lead)
                if plan is None:
                    return self._fallback("host_operands")
                if fuse:
                    plan = self._plan_fused(comm, calls, lead, plan, fuse)
                    if isinstance(plan, str):
                        return self._fallback(plan)
            if window_dtype is None:
                window_dtype = plan["dtype"]
            elif plan["dtype"] != window_dtype:
                return self._fallback("mixed_dtype")
            # every slot reads its operands as they were before the
            # window: a position reading an earlier position's result
            # must run in order on the per-call path
            for call in calls:
                buf = call.op0
                if (buf is not None and not buf.is_dummy
                        and buffer_root(buf) in written):
                    return self._fallback("data_dependency")
            for r in plan["writers"]:
                res = calls[r].res
                if res is not None and not res.is_dummy:
                    written.add(buffer_root(res))
            plans.append((calls, lead, plan))
        if window_dtype is None:
            window_dtype = torch.float32  # an all-barrier window
        for i in barrier_positions:
            calls, lead, _ = plans[i]
            plans[i] = (calls, lead, self._plan_barrier(comm, window_dtype))

        # windows of at most `depth` slots, or of the comm's QoS budget
        with self._lock:
            budget = self._slot_budgets.get(comm.id)
        width = min(self.depth, budget) if budget else self.depth
        for lo in range(0, npos, width):
            window = plans[lo:lo + width]
            if budget and npos > width:
                with self._lock:
                    self.budgeted_windows += 1
            reqs_per_slot = [[e[1][i] for e in entries]
                             for i in range(lo, lo + len(window))]
            try:
                self._dispatch_window(comm, window, reqs_per_slot, t0,
                                      probe=probe)
            except Exception as e:
                # fail this window's slots and the rest; earlier windows
                # were launched and stay completed.  Never re-execute.
                traceback.print_exc()
                self._window_failed(comm.id,
                                    f"dispatch_error: {type(e).__name__}")
                ctx = {"comm": comm.id,
                       "error": f"{type(e).__name__}: {e}"[:300]}
                dt = time.perf_counter_ns() - t0
                for i in range(lo, npos):
                    for e_ in entries:
                        req = e_[1][i]
                        if not req.done():
                            req.ring_resident = True
                            req.complete(ErrorCode.INVALID_OPERATION, dt,
                                         context=dict(ctx, op=req.op_name))
                break
        return True

    # -- slot encoding -------------------------------------------------------
    def _encode(self, session: _RingSession, lead, plan) -> np.ndarray:
        op = plan["op"]
        wire = int(lead.arithcfg.compressed) if plan["wire"] is not None else 0
        if "p2p" in plan:
            root, peer = plan["p2p"]
        else:
            root = lead.root_src if op == Operation.BCAST else 0
            peer = plan.get("hop", 0)
        words = encode_slot(
            session.seqn, self._slot_opcode(plan), plan["n"],
            dtype=int(lead.arithcfg.uncompressed),
            function=lead.reduce_function, root=root,
            # the call's stochastic-rounding seed rides the flags word
            flags=int(lead.wire_seed) & 0x7FFFFFFF,
            nseg=1, peer=peer, wire=wire,
            fparam=encode_fparam(plan["fparam"]) if plan.get("fuse") else 0,
        )
        session.ring[session.head % session.ring.shape[0]] = words
        session.head += 1
        session.seqn += 1
        return words

    def _window_shape(self, comm, window) -> WindowShape:
        in_ws, out_ws, wires = [], [], []
        dtype = None
        for _, _, plan in window:
            in_w, out_w = ring_widths(plan["op"], plan["n"], comm.size,
                                      fuse=plan.get("fuse", 0))
            in_ws.append(in_w)
            out_ws.append(out_w)
            wires.append(plan["wire"])
            dtype = plan["dtype"]
        return WindowShape(len(window), in_ws, out_ws, wires, dtype)

    def _window_posture(self, lead=None):
        """The run posture an arming window gives its run: the
        ``cmdring_run_windows`` / ``cmdring_linger_us`` registers as the
        window's lead call reads them (its tuning-plan overlay over the
        gang's table; the table alone without a lead; 0: the ring's env
        default, ``run_windows`` / ``linger_s``)."""
        t = (self.gang.tuning if lead is None
             else lead.effective_tuning(self.gang.tuning))
        rw = int(t.get("cmdring_run_windows", 0) or 0)
        lus = int(t.get("cmdring_linger_us", 0) or 0)
        return (rw if rw > 0 else self.run_windows,
                lus / 1e6 if lus > 0 else self.linger_s)

    # -- dispatch ------------------------------------------------------------
    def _rows(self, window, shape: WindowShape):
        """Every slot's operand rows, result rows and buffers: a pair
        slot's source operand alone, its destination's result alone."""
        xs, outs, bufs = [], [], []
        for k, (calls, lead, plan) in enumerate(window):
            in_w, out_w = shape.in_ws[k], shape.out_ws[k]
            row_x, row_o = [], []
            src = plan.get("p2p", (None, None))[0]
            for r, call in enumerate(calls):
                if plan["op"] == Operation.BARRIER:
                    row_x.append(None)
                    row_o.append(None)
                    continue
                buf = call.op0
                if src is not None and r != src:
                    buf = None
                res = call.res if r in plan["writers"] else None
                for b in (buf, res):
                    if b is not None and not b.is_dummy:
                        b.resolve_pending()  # parked placements land first
                dummy = buf is None or buf.is_dummy
                row_x.append(None if dummy else buf.tensor[:in_w])
                take = res is not None and not res.is_dummy
                row_o.append(res.tensor[:result_width(in_w, out_w,
                                                      len(calls))]
                             if take else None)
                bufs += [b for b in (buf, res) if b is not None
                         and not b.is_dummy]
            xs.append(row_x)
            outs.append(row_o)
        return xs, outs, bufs

    def _chaos_hook(self, comm, slots_np: np.ndarray) -> np.ndarray:
        """The chaos plane's reach into the ring: the injector installed
        by ``contract.install_fault_plan`` sees the window as one ``RING``
        message.  ``corrupt`` / ``drop`` return the words with the first
        slot's opcode poisoned (the sequencer reports BAD_OP and those
        requests fail at once, never a hang); ``delay`` sleeps a bounded
        time before the doorbell."""
        from ...contract import _injector_for

        inj = _injector_for(None)
        if inj is None:
            return slots_np
        v = inj.on_send(_RingRefillMsg(comm.id,
                                       int(slots_np[0, _F["seqn"]])))
        action = None
        if v.corrupt or v.drop or v.dead_dst:
            action = "corrupt" if v.corrupt else "drop"
            slots_np = slots_np.copy()
            slots_np[0, _F["opcode"]] = _CHAOS_BAD_OPCODE
        if v.delay_s > 0:
            with self._lock:
                self.chaos_faults["delay"] = (
                    self.chaos_faults.get("delay", 0) + 1)
            time.sleep(min(float(v.delay_s), _CHAOS_MAX_DELAY_S))
        if action is not None:
            with self._lock:
                self.chaos_faults[action] = (
                    self.chaos_faults.get(action, 0) + 1)
        return slots_np

    def _dispatch_window(self, comm, window, reqs_per_slot, t0,
                         probe: bool = False) -> None:
        """Encode the window and run it: inline (one launch, its requests
        completing at launch with the window's event), or through a run
        (never a breaker's probe)."""
        n = len(window)
        shape = self._window_shape(comm, window)
        with self._lock:
            session = self._sessions.get(comm.id)
            if session is None:
                session = self._sessions[comm.id] = _RingSession(self.depth)
            start = session.head
            slot_rows = [self._encode(session, lead, plan)
                         for _, lead, plan in window]
            if (start % self.depth) + n > self.depth:
                self.wraps += 1
            self.refills += 1
            self.slots_enqueued += n
            self.comm_slots[comm.id] = self.comm_slots.get(comm.id, 0) + n
            self.last_window = n
            self.max_window = max(self.max_window, n)
            for _, _, plan in window:
                name = self._slot_opcode(plan).name
                self.op_slots[name] = self.op_slots.get(name, 0) + 1
            window_id = self._next_window
            self._next_window += 1
            calls = [c for c, _, _ in window]
            widths = [result_width(shape.in_ws[k], shape.out_ws[k],
                                   comm.size) for k in range(n)]
            ranks = [c.comm.ranks[r].session
                     for r, c in enumerate(window[0][0])]
            rec = _Window(window_id, [p for _, _, p in window], calls,
                          reqs_per_slot, widths, t0, ranks, comm.id)
            # the window log's per-slot facts, at encode time: the seqn
            # written into the slot words and the issuing call's trace id
            for k, (_, _, plan) in enumerate(window):
                tid = None
                for req in reqs_per_slot[k]:
                    meta = req._tmeta
                    if meta and meta.get("trace_id"):
                        tid = meta["trace_id"]
                        break
                rec.slots_info.append({
                    "seqn": int(slot_rows[k][_F["seqn"]]),
                    "opcode": self._slot_opcode(plan).name,
                    "trace_id": tid,
                })
            live = (session.run is not None and session.run.shape == shape
                    and session.run.mbox.accepting)
            # the stream detector: an earlier window of this session is
            # still in flight, so the host runs ahead of the device
            session.windows = [w for w in session.windows if w.in_flight()]
            streaming = bool(session.windows)
            session.windows.append(rec)
        for slot_reqs in reqs_per_slot:  # a request's wait drains it
            for rank, req in zip(rec.ranks, slot_reqs):
                req._drain_hook = (lambda c=comm.id, w=rec, k=rank:
                                   self._drain_one(c, w, k))
        slots_np = self._chaos_hook(comm, np.stack(slot_rows))
        xs, outs, bufs = self._rows(window, shape)
        device = self.gang.device
        self._wait_written(session, rec, window)
        self.gang.interactions.bump()  # THE refill: one per window
        use_run = (self.lowering == "xla" and (live or streaming)
                   and not probe and launches_for(comm.size, n) == 1)
        try:
            with annotate(f"accl::cmdring[{n}]"):
                if use_run:
                    rec.form = "mailbox"
                    self._post_or_dispatch(comm, session, shape, rec,
                                           slots_np, xs, outs, bufs, device)
                else:
                    self._dispatch_inline(comm, session, shape, rec,
                                          slots_np, xs, outs, bufs, device)
        except BaseException as e:
            with self._lock:
                if rec in session.windows:
                    session.windows.remove(rec)
                self._pending.pop(window_id, None)
            self._log_window(rec, None, time.perf_counter_ns(),
                             error=f"{type(e).__name__}: {e}")
            raise

    def _wait_written(self, session, rec, window) -> None:
        """A window whose operand a window a CPU run has not completed
        writes waits for it (the card's stream, and its host waits on
        operand events, order the rest)."""
        roots = set()
        for calls, _, _ in window:
            for call in calls:
                buf = call.op0
                if buf is not None and not buf.is_dummy:
                    roots.add(buffer_root(buf))
        with self._lock:
            pending = [w for w in self._pending.values()
                       if w is not rec and w.writes & roots]
        timeout = drain_deadline_s(self.gang_timeout())
        for w in pending:
            if not w.done.wait(timeout):
                raise TimeoutError("command-ring window blocked on an "
                                   "earlier window writing its operand")

    def _dispatch_inline(self, comm, session, shape, rec, slots_np, xs, outs,
                         bufs, device) -> None:
        """One launch of the sequencer for the window; its requests
        complete now, with the window's one CUDA event."""
        from .engine import _record_event, _wait_operands

        n = len(rec.plans)
        _wait_operands(device, bufs)
        status = run_window(slots_np, xs, outs, shape, device=device)
        if device.type == "cuda":
            host = torch.empty(status.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(status, non_blocking=True)
        else:
            host = status
        event = _record_event(device)
        rec.event = event
        for k, plan in enumerate(rec.plans):
            for r in plan["writers"]:
                res = rec.calls[k][r].res
                if res is not None and not res.is_dummy:
                    res.ready = event
        with self._lock:
            self.dispatches += launches_for(comm.size, n)
            session.last = ("host", host, event)
        # the retcodes the device writes, known on the host from the same
        # words; the requests complete once the event has passed
        rec.status = status_words(slots_np)
        if event is None:
            rec.done.set()  # the CPU's plain sequencer has run
        self._park(rec)

    def _park(self, rec) -> None:
        """Hand a launched or posted window to the gang's in-flight window
        (``ring=True``, under its comm's id): its waiter blocks until the
        window's device work has ended -- its blocking CUDA event, its
        card run's ticket, or (the CPU) its results being in place, each
        bounded by the drain deadline -- and the drainer then settles it
        (:meth:`_settle`) or fails it (:meth:`_fail`)."""
        ev = rec.event
        timeout = drain_deadline_s(self.gang_timeout())

        def waiter():
            if isinstance(ev, RunTicket):
                if not ev.run.wait_window(ev.k, timeout):
                    raise RuntimeError(
                        f"sequencer run failed: {ev.run.failed}")
            elif ev is not None:
                if not ev.query():
                    ev.synchronize()
            elif not rec.done.wait(timeout):
                raise TimeoutError("command-ring window never completed "
                                   "(a run wedged past the drain deadline)")
            if rec.error is not None:
                raise RuntimeError(rec.error)

        def on_ready(overlap_ns, depth, ready_ns):
            self._settle(rec, ready_ns, overlap_ns, depth)

        def on_error(exc):
            self._fail(rec, f"{type(exc).__name__}: {exc}")

        self.gang.window.park(rec.comm_id, waiter, on_ready, on_error,
                              ring=True)

    def _settle(self, rec, end: int, overlap_ns: int = 0,
                depth: Optional[int] = None) -> None:
        """The window's device work has ended: log it, close its comm's
        breaker and complete its requests with their slots' retcodes and
        the in-flight window's facts (once; a failure first wins)."""
        with self._lock:
            if rec.settled:
                return
            rec.settled = True
        dt = max(end - rec.t0, 1)
        self._log_window(rec, rec.status, end)
        # a completed window closes (or restores) the comm's breaker: a
        # slot's BAD_OP is an opcode error, not a transport failure
        self.breaker_for(rec.comm_id).success()
        codes = np.asarray(rec.status)[:, 1]
        for k, slot_reqs in enumerate(rec.reqs):
            code = (ErrorCode.OK if int(codes[k]) == CMDRING_ST_OK
                    else ErrorCode.INVALID_OPERATION)
            for req in slot_reqs:
                req.ring_resident = True
                req.overlap_ns = overlap_ns or None
                req.inflight_depth = depth
                req.complete(code, dt, event=rec.event)
        rec.done.set()

    def _fail(self, rec, reason: str) -> None:
        """Fail a window's requests (a run's failure latch, a failed or
        timed-out wait): never re-executed; once (a completion first
        wins)."""
        with self._lock:
            if rec.settled:
                return
            rec.settled = True
            rec.error = reason
        end = time.perf_counter_ns()
        dt = end - rec.t0
        self._log_window(rec, None, end, error=reason)
        self._window_failed(rec.comm_id, reason)
        ctx = {"error": reason[:300]}
        for slot_reqs in rec.reqs:
            for req in slot_reqs:
                req.ring_resident = True
                req.complete(ErrorCode.INVALID_OPERATION, dt,
                             context=dict(ctx, op=req.op_name))
        rec.done.set()

    # -- the persistent run --------------------------------------------------
    def _post_or_dispatch(self, comm, session, shape, rec, slots_np, xs,
                          outs, bufs, device) -> None:
        """The persistent doorbell: post into the live run when it takes
        this shape, else arm a fresh run (ONE dispatch) with the window as
        its first."""
        cuda = device.type == "cuda"
        with self._lock:
            run = session.run
        live = (run is not None and run.shape == shape
                and not run.failed.is_set())
        if cuda:
            # a stream cannot wait inside a running kernel: before a post
            # the host waits for the operands' (and results') last
            # writers, but for windows of runs, which the stream keeps in
            # order (every run launches on the current stream, after the
            # last); a window that arms a run waits for them on the stream
            # (_arm).  A device write made outside the facade is not
            # among them: it must be complete before the batched call
            if live:
                for b in bufs:
                    ev = getattr(b, "ready", None)
                    if ev is not None and not isinstance(ev, RunTicket):
                        ev.synchronize()
            payload = (xs, outs)
        else:
            # the CPU run reads its snapshot of the operands, as the JAX
            # mailbox holds immutable rows; results land by adoption
            _hazards(_words(slots_np), spans_of(
                *_check_window(_words(slots_np), xs, outs, shape)[1:],
                shape, comm.size), shape, comm.size)
            payload = [None if plan["op"] == Operation.BARRIER else
                       [None if x is None else x.clone() for x in row]
                       for row, plan in zip(xs, rec.plans)]
            with self._lock:
                self._pending[rec.window_id] = rec
        posted = False
        if live:
            rec.run = run  # before the post: the run may complete it at once
            posted = run.mbox.post(rec.window_id, slots_np, payload)
            if posted:
                with self._lock:
                    self.mailbox_posts += 1
        if not posted:
            if run is not None:
                run.mbox.halt()  # stale shape, spent or lingered out
                with self._lock:
                    self._retired.append(run)
                    session.run = None
                self._prune_retired()
            run = self._arm(comm, session, shape, slots_np, rec, payload,
                            bufs, device)
        self._posted(comm, session, run, rec, slots_np, cuda)

    def _arm(self, comm, session, shape, slots_np, rec, payload, bufs,
             device):
        """A fresh run with ``rec`` posted as its first window, started:
        one dispatch, ordered on the stream after the last writers of the
        window's buffers.  A run that cannot build or launch raises (its
        window fails; nothing turns into the inline form)."""
        from .engine import _wait_operands

        run_windows, linger_s = self._window_posture(rec.calls[0][0])
        if device.type == "cuda":
            _wait_operands(device, bufs)
            drun = PersistentRun(shape, comm.size, device, run_windows,
                                 linger_s, takes_lanes(slots_np, shape.wires))
            run = _ResidentRun(_DeviceMailbox(drun), shape, drun)
            rec.run = run
            if not run.mbox.post(rec.window_id, slots_np, payload):
                drun.join(0.0)
                raise RuntimeError("a fresh sequencer run refused its "
                                   "first window")
            try:
                drun.launch()
            except BaseException:
                drun.join(0.0)
                raise
            drun.on_fail = lambda reason, run=run: self._run_failed(
                comm.id, run, reason)
        else:
            mbox = SequencerMailbox(
                comm.size, shape, run_windows=run_windows,
                linger_s=linger_s,
                on_window_done=self._make_window_done(comm.id))
            run = _ResidentRun(mbox, shape)
            rec.run = run
            ok = mbox.post(rec.window_id, slots_np, payload)
            assert ok  # a fresh mailbox takes its first window
            self._start_thread(comm.id, run, comm.size)
        with self._lock:
            session.run = run
            self.dispatches += 1
        return run

    def _posted(self, comm, session, run, rec, slots_np, cuda) -> None:
        """A window a run took, parked in the in-flight window: on the card
        it retires when its ticket passes; on the CPU when the run has
        completed it (``_make_window_done``)."""
        if not cuda:
            with self._lock:
                run.windows.append((None, rec))
            self._park(rec)
            return
        drun = run.device_run
        k = run.mbox.index.pop(rec.window_id)
        ticket = drun.ticket(k)
        rec.event = ticket
        rec.status = status_words(slots_np)
        with self._lock:
            run.windows.append((k, rec))
            session.last = ("run", drun, k, len(rec.plans))
        for j, plan in enumerate(rec.plans):
            for r in plan["writers"]:
                res = rec.calls[j][r].res
                if res is not None and not res.is_dummy:
                    res.ready = ticket
        self._park(rec)

    def _run_failed(self, comm_id, run, reason: str) -> None:
        """A card run's failure latch: every window it had not completed
        fails with INVALID_OPERATION."""
        done = run.device_run.done() if run.device_run is not None else 0
        with self._lock:
            failed = [w for k, w in run.windows if k is None or k >= done]
            run.exc = RuntimeError(reason)
            run.failed.set()
            s = self._sessions.get(comm_id)
            if s is not None and s.run is run:
                s.run = None
        for w in failed:
            self._fail(w, f"sequencer run failed: {reason}")

    def _start_thread(self, comm_id, run: _ResidentRun, size: int) -> None:
        """The CPU's run: a thread that pulls each step for every rank (the
        first pull decides), runs the window with the plain sequencer and
        pushes every rank's status and results."""
        mbox, shape = run.mbox, run.shape

        def drive():
            try:
                while True:
                    pulls = [mbox.pull(r) for r in range(size)]
                    live, slots, _ = pulls[0]
                    if not int(live):
                        return
                    rows = [[pulls[r][2][i] for r in range(size)]
                            for i in range(shape.depth)]
                    outs = [[torch.empty(result_width(
                        shape.in_ws[i], shape.out_ws[i], size),
                        dtype=shape.dtype) for _ in range(size)]
                        for i in range(shape.depth)]
                    st = sequencer_plain(slots, rows, outs, shape).numpy()
                    for r in range(size):
                        mbox.push(r, 1, st,
                                  [outs[i][r] for i in range(shape.depth)])
            except BaseException as e:  # surface to every queued window
                traceback.print_exc()
                mbox.halt()
                with self._lock:
                    run.exc = e
                    run.failed.set()
                    pending = [w for _, w in run.windows
                               if not w.done.is_set()]
                    for w in pending:
                        self._pending.pop(w.window_id, None)
                for w in pending:
                    self._fail(w, f"sequencer run failed: "
                                  f"{type(e).__name__}: {e}")

        t = threading.Thread(target=drive, name="accl-cmdring-run",
                             daemon=True)
        run.thread = t
        t.start()

    def _make_window_done(self, comm_id: int):
        """The completion a CPU run's mailbox fires once every rank pushed
        a window: the results land in the result buffers and the window is
        done, so the in-flight window's waiter returns and its drainer
        completes the requests with their slots' retcodes."""

        def on_done(window_id, status, results, comm_id=comm_id):
            with self._lock:
                s = self._sessions.get(comm_id)
                rec = self._pending.pop(window_id, None)
            if rec is None:
                return  # failed by the run's latch
            for k, plan in enumerate(rec.plans):
                for r in sorted(plan["writers"]):
                    res = rec.calls[k][r].res
                    if res is None or res.is_dummy or r not in results:
                        continue
                    width = rec.widths[k]
                    res.tensor[:width].copy_(results[r][k][:width])
            with self._lock:
                if s is not None:
                    s.last = ("words", np.asarray(status, np.int32))
            rec.status = status
            rec.done.set()

        return on_done
