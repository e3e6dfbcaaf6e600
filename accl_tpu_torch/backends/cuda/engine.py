"""The gang engine: the facade over P ranks whose buffers share one device.

The counterpart of ``accl_tpu/backends/xla/engine.py``.  Rank handles
submit their calls into a shared :class:`CudaGangContext`; when every rank
of a communicator has posted the matching call, the LAST arriving rank's
thread runs the collective once for all of them through ``ops.driver``
(on the card: a hand-written kernel or plain PyTorch, by the tuning
registers) and completes every rank's request.

Streams: the collective launches on the executing thread's current
stream, after that stream waits on every operand's last-writer event; it
then records one event (``blocking``: a host wait on it sleeps in the
driver), which every rank's request and result buffer carry, so a waiter
synchronises on that event and not on the device.

The in-flight window (``overlap.InflightWindow``, the JAX gang's
``window``): a launched call is parked there under its communicator's id
with its event as the waiter, and the window's drainer completes every
rank's request once the event has passed, in launch order per
communicator; so a request completes when its device work ends, its
duration runs from the gang's start to that end, and its ``overlap_ns``
and ``inflight_depth`` are the window's.  Up to ``window.depth`` calls of
a communicator (or a tenant's window share) are in flight; one more
waits for the oldest.  The paths JAX's gang parks (the device lowering,
the prepared path, the fused batch, the command ring's windows) park on
the CPU too, where the waiter returns at once; anything else that
launched device work parks on the card, and the rest completes inline
behind the communicator's parked calls (``drain_key``).

Dispatch: a call whose facade plan (``accl_tpu_torch.plans``) holds the
gang's prepared state takes the warm path -- its operands held against
the template, then ONE prepared handle (``ops.driver.prepare``: the
resolved lowering and its pointer tables); otherwise the full path runs
and parks that state on the plan.  A call with a host-only operand or
result is staged through the host (:meth:`CudaGangContext._run_op_host`).
Every dispatch bumps the gang's :class:`InteractionCounter` once.

Batches: a flushed ``with accl.batch():`` run arrives as one gang event
(``submit_batch``); the command ring (``cmdring.GangCommandRing``) runs it
as windows, one sequencer launch each or posts into a persistent run, or
refuses it with a counted reason; a refused batch runs as one fused
dispatch of the plain lowerings when it qualifies
(:meth:`CudaGangContext._run_batch_fused`), and otherwise each position
in order through the per-call path.  On a world-2 gang a batched send and
recv join the run: a matched pair rides one ring slot, or delivers
directly off the ring, and any other p2p position takes the channel.

Point-to-point: a send and a recv meet in the gang's tag-matched
:class:`P2PChannel`; the send posts a fresh device copy of its operand
(narrowed to the wire dtype by row 5 when compressed).  The match checks
the pair and parks the copy into the receiver's buffer (widened by row
5) on that buffer: it runs at the receiver's ``wait()`` or first device
read, as the JAX engine's ``defer_store`` delivery does.  Every rank
shares the device, so the hop is a device copy; a hop between two
devices is not ported (ROADMAP B14 / A6) and fails the pair.  The stream
ports hold host bytes, as in the JAX package (:class:`StreamPortMixin`).

Faults, as the JAX gang's: a slot not assembled by the gang's timeout
completes with RECEIVE_TIMEOUT naming the absent ranks, each of which
takes a strike in the health map (two make it dead, and later calls
addressing it fail at intake); ``RESET`` of 1 (``ACCL.soft_reset``)
drains the device work and abandons the slots, sequence numbers, health
map and ring sessions; a contract verdict fails a communicator's parked
slots (``contract_fail``); a membership cutover realigns a reshaped
communicator's sequence (``realign``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from ...arithconfig import reduce_op
from ...buffer import DeviceBuffer, DummyBuffer, HostBuffer, make_buffer
from ...cmdring import complementary_pair, ring_widths
from ...communicator import Communicator
from ...constants import (
    ALGORITHM_TUNING_KEYS,
    CMDRING_MAX_RUN_WINDOWS,
    AllreduceAlgorithm,
    CompressionFlags,
    ConfigFunction,
    DataType,
    DEFAULT_TIMEOUT_S,
    ErrorCode,
    FusedCompute,
    MAX_EAGER_SIZE_LIMIT,
    MAX_INFLIGHT_WINDOW,
    Operation,
    ROOTED_ALGORITHMS,
    ReduceFunction,
    StreamFlags,
    TUNING_DEFAULTS,
    TUNING_KEY_NAMES,
    TuningKey,
    WIRE_LANE_DTYPES,
    drain_deadline_s,
    dtype_to_torch,
)
from ...arbiter import tenant_config_field, tenant_config_valid
from ...membership import CircuitBreaker
from ...ops import driver as opdriver
from ...ops.cuda.combine import combine as kernel_combine
from ...ops.wire import wire_lane_roundtrip_rows
from ...overlap import InflightWindow, device_waiter
from ...wire import astype, is_wire_dtype, rank_seed, roundtrip, widen
from ...request import Request
from ...utils.profiling import annotate
from ..base import (
    BaseEngine,
    CallOptions,
    InteractionCounter,
    StreamPortMixin,
    convert,
    tensor_bytes,
)
from .cmdring import BATCH_TUNING_KEYS, GangCommandRing, buffer_root


def apply_tuning(tuning: dict, options: CallOptions) -> ErrorCode:
    """Validate and apply one SET_TUNING register write (the JAX device
    tier's ``apply_tuning``: every register of the table, with its
    checks)."""
    try:
        key = TuningKey(int(options.cfg_key))
    except ValueError:
        return ErrorCode.CONFIG_ERROR
    val = options.cfg_value
    if val < 0:
        return ErrorCode.CONFIG_ERROR
    name = TUNING_KEY_NAMES[key]
    if key in ALGORITHM_TUNING_KEYS:
        try:
            algo = AllreduceAlgorithm(int(val))
        except ValueError:
            return ErrorCode.CONFIG_ERROR
        if (key != TuningKey.ALLREDUCE_ALGORITHM
                and algo not in ROOTED_ALGORITHMS):
            return ErrorCode.CONFIG_ERROR  # no ring form of a rooted op
        tuning[name] = algo.name.lower()
    elif key == TuningKey.RING_SEGMENTS:
        if int(val) < 1:
            return ErrorCode.CONFIG_ERROR
        tuning[name] = int(val)
    elif key in (TuningKey.WIRE_DTYPE, TuningKey.WIRE_DTYPE_ICI,
                 TuningKey.WIRE_DTYPE_DCN):
        # a registered wire lane or 0 (off; on a per-class register,
        # "defer to wire_dtype")
        if int(val) != 0 and not is_wire_dtype(int(val)):
            return ErrorCode.CONFIG_ERROR
        tuning[name] = int(val)
    elif key == TuningKey.HIERARCHICAL:
        if int(val) > 1:
            return ErrorCode.CONFIG_ERROR
        tuning[name] = int(val)
    elif key == TuningKey.CMDRING_RUN_WINDOWS:
        # the persistent run's posture (0: the env default), clamped as
        # the env knob is: an unbounded run would hold the device
        if int(val) > CMDRING_MAX_RUN_WINDOWS:
            return ErrorCode.CONFIG_ERROR
        tuning[name] = int(val)
    elif key == TuningKey.CMDRING_LINGER_US:
        if int(val) > 1_000_000:  # above 1 s a run would hold the device
            return ErrorCode.CONFIG_ERROR
        tuning[name] = int(val)
    else:
        # pipeline_threshold and the flat-tree thresholds (stored; the
        # latter select nothing on the gang tier, as on JAX's gang)
        if key == TuningKey.GATHER_FLAT_TREE_MAX_FANIN and val < 1:
            return ErrorCode.CONFIG_ERROR
        tuning[name] = int(val)
    return ErrorCode.OK


def run_allreduce_with_tuning(xs, mesh, fn, wire: Optional[DataType],
                              tuning: dict, out=None):
    """Allreduce with algorithm, segmentation and wire lane from the
    tuning registers: under ``pallas_ring*`` the lane runs inside K1 (as
    JAX's kernel casts each hop, int8 included), otherwise through the
    compressed allreduce's codec."""
    algo = tuning.get("allreduce_algorithm", "xla")
    nseg = int(tuning.get("ring_segments", 1))
    bidir = algo == "pallas_ring_bidir"
    pallas = algo in ("pallas_ring", "pallas_ring_bidir")
    if wire is not None:
        wire_name = WIRE_LANE_DTYPES[wire.name]
        if pallas:  # the wire lane runs inside the kernel
            return opdriver.run_pallas_allreduce(
                xs, mesh, fn, nseg, wire_dtype=wire_name,
                bidirectional=bidir, out=out,
            )
        return opdriver.run_compressed_allreduce(
            xs, mesh, fn, wire_dtype=wire_name, out=out
        )
    if algo == "ring":
        return opdriver.run_ring_allreduce(xs, mesh, fn, nseg, out=out)
    if pallas:
        return opdriver.run_pallas_allreduce(
            xs, mesh, fn, nseg, bidirectional=bidir, out=out
        )
    return opdriver.run_allreduce(xs, mesh, fn, out=out)


def run_rooted_with_tuning(op, xs, mesh, lead: CallOptions, tuning: dict,
                           out=None):
    """Rooted collective with the lowering from its algorithm register:
    the plain PyTorch form (``xla``) or the ring relay kernels
    (``pallas_ring``).  ``out`` entries of None take no result."""
    nseg = int(tuning.get("ring_segments", 1))
    fn = lead.reduce_function
    if op == Operation.REDUCE:
        if tuning.get("reduce_algorithm", "xla") == "pallas_ring":
            return opdriver.run_pallas_reduce(
                xs, mesh, lead.root_dst, fn, nseg, out=out
            )
        return opdriver.run_reduce(xs, mesh, lead.root_dst, fn, out=out)
    if op == Operation.BCAST:
        if tuning.get("bcast_algorithm", "xla") == "pallas_ring":
            return opdriver.run_pallas_bcast(
                xs, mesh, lead.root_src, nseg, out=out
            )
        return opdriver.run_bcast(xs, mesh, lead.root_src, out=out)
    if op == Operation.SCATTER:
        if tuning.get("scatter_algorithm", "xla") == "pallas_ring":
            return opdriver.run_pallas_scatter(
                xs, mesh, lead.root_src, nseg, out=out
            )
        return opdriver.run_scatter(xs, mesh, lead.root_src, out=out)
    if op == Operation.GATHER:
        if tuning.get("gather_algorithm", "xla") == "pallas_ring":
            return opdriver.run_pallas_gather(
                xs, mesh, lead.root_src, nseg, out=out
            )
        return opdriver.run_gather(xs, mesh, lead.root_src, out=out)
    raise ValueError(op)


def resolve_lowering(op, lead: CallOptions, tuning: dict,
                     wire: Optional[DataType]):
    """``(driver op name, extra)`` of the prepared handle a plan caches:
    the selection :func:`run_allreduce_with_tuning` and
    :func:`run_rooted_with_tuning` make per call, resolved once (the JAX
    engine's ``resolve_lowering``).  ``wire`` is the call's wire lane
    (it rides the allreduce's lowering; the other ops round their
    operands through it in the handle's ``prep``)."""
    nseg = int(tuning.get("ring_segments", 1))
    wire_name = WIRE_LANE_DTYPES[wire.name] if wire is not None else None
    if op == Operation.ALLREDUCE:
        algo = tuning.get("allreduce_algorithm", "xla")
        if algo in ("pallas_ring", "pallas_ring_bidir"):
            return "pallas_allreduce", (nseg, wire_name,
                                        algo == "pallas_ring_bidir")
        if wire_name is not None:
            return "compressed_allreduce", wire_name
        if algo == "ring":
            return "ring_allreduce", nseg
        return "allreduce", None
    rooted = {Operation.REDUCE: ("reduce", lead.root_dst),
              Operation.SCATTER: ("scatter", lead.root_src),
              Operation.GATHER: ("gather", lead.root_src)}
    if op in rooted:
        name, root = rooted[op]
        if tuning.get(f"{name}_algorithm", "xla") == "pallas_ring":
            return f"pallas_{name}", (root, nseg)
        return name, root
    if op == Operation.ALLGATHER:
        return "allgather", None
    if op == Operation.REDUCE_SCATTER:
        return "reduce_scatter", None
    if op == Operation.ALLTOALL:
        return "alltoall", None
    raise ValueError(op)  # callers gate on _FAST_OPS


#: the config writes of the QoS arbiter plane
_TENANT_CONFIG = (
    ConfigFunction.SET_TENANT_CLASS, ConfigFunction.SET_TENANT_WEIGHT,
    ConfigFunction.SET_TENANT_WINDOW_SHARE,
    ConfigFunction.SET_TENANT_RING_SLOTS, ConfigFunction.SET_TENANT_RATE,
)

#: ops of the prepared warm path (BCAST stays on the full path, as in
#: the JAX engine)
_FAST_OPS = frozenset((
    Operation.ALLREDUCE, Operation.REDUCE, Operation.SCATTER,
    Operation.GATHER, Operation.ALLGATHER, Operation.REDUCE_SCATTER,
    Operation.ALLTOALL,
))


# per-op operand/result widths in units of ``count`` ('P' = size*count)
IN_W = {
    Operation.ALLREDUCE: 1, Operation.REDUCE: 1, Operation.BCAST: 1,
    Operation.ALLGATHER: 1, Operation.GATHER: 1,
    Operation.REDUCE_SCATTER: "P", Operation.SCATTER: "P",
    Operation.ALLTOALL: "P",
}
OUT_W = {
    Operation.ALLREDUCE: 1, Operation.REDUCE: 1, Operation.BCAST: 1,
    Operation.SCATTER: 1, Operation.REDUCE_SCATTER: 1,
    Operation.ALLGATHER: "P", Operation.GATHER: "P",
    Operation.ALLTOALL: "P",
}
ROOTED_OPS = (Operation.REDUCE, Operation.BCAST, Operation.SCATTER,
              Operation.GATHER)


def _record_event(device: torch.device):
    """An event on the current stream of ``device`` (None on the CPU).
    Blocking: the in-flight window's drainer, and any host waiter, sleeps
    in the driver until it passes instead of spinning a core."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(blocking=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait_operands(device: torch.device, bufs) -> None:
    """Order this thread's stream after the last writers of ``bufs``."""
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device)
    for buf in bufs:
        ev = getattr(buf, "ready", None)
        if ev is not None:
            stream.wait_event(ev)


def _check(buf, width: int, dtype: DataType, what: str) -> torch.Tensor:
    """``buf``'s first ``width`` elements, after any placement parked on
    it (a later call reads or writes it in issue order)."""
    if isinstance(buf, DeviceBuffer):
        buf.resolve_pending()
    elif not isinstance(buf, HostBuffer):
        raise ValueError(f"{what}: not a buffer with storage")
    if buf.count < width or buf.dtype != dtype:
        raise ValueError(
            f"{what}: needs {width} {dtype.name} elements, buffer holds "
            f"{buf.count} {buf.dtype.name}"
        )
    return buf.tensor[:width]


class Payload:
    """A posted send: a tensor the sender no longer writes (a fresh copy of
    its operand, in the wire dtype) and the event recorded after it was
    made (None on the CPU and for host bytes from a stream port)."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event=None):
        self.tensor = tensor
        self.event = event

    def wait(self, device: torch.device) -> None:
        """Order ``device``'s current stream after the payload's copy."""
        if self.event is not None and device.type == "cuda":
            torch.cuda.current_stream(device).wait_event(self.event)

    def host_bytes(self) -> bytes:
        if self.event is not None:
            self.event.synchronize()
        return tensor_bytes(self.tensor)


def p2p_check(payload: Payload, res, count: int) -> None:
    """Refuse, at match time, a payload the receiver cannot take: one that
    does not fit, a result buffer that is too small, and a hop between
    two devices, which the port does not have yet (ROADMAP B14 / A6)."""
    t = payload.tensor
    if t.dim() != 1 or t.numel() < count:
        raise ValueError(
            f"p2p payload of shape {tuple(t.shape)} into count {count}")
    if not isinstance(res, (DeviceBuffer, HostBuffer)) or res.count < count:
        raise ValueError(f"p2p result buffer too small for {count} elements")
    dst = res.tensor.device
    # host bytes cross to any device, and a host-only receiver takes a
    # payload from any; a hop between two devices is refused
    if (t.device != dst and t.device.type != "cpu"
            and not isinstance(res, HostBuffer)):
        raise NotImplementedError(
            f"a p2p hop from {t.device} to {dst}: transfers between "
            "devices are not ported (ROADMAP B14 / A6)")


def p2p_device_deliver(payload: Payload, res, count: int):
    """Copy a matched send's payload into the receiver's buffer and return
    the event recorded after it (the counterpart of the JAX engine's
    ``_p2p_device_deliver``).  Every rank shares one device, so this is
    JAX's self-device branch, a device copy; host bytes (a stream port's,
    or a host-only sender's) cross to the device first, and a host-only
    receiver takes the payload on the host.  A compressed payload widens
    to the buffer's dtype by row 5 on the receiving side."""
    p2p_check(payload, res, count)
    dst = res.tensor[:count]
    t = payload.tensor
    if t.device != dst.device:
        if payload.event is not None:
            payload.event.synchronize()
        t = t.to(dst.device)
    else:
        payload.wait(dst.device)
    src = t[:count]
    _wait_operands(dst.device, [res])
    convert(src, dst.dtype, out=dst)  # row 5 widens a compressed payload
    event = _record_event(dst.device)
    if isinstance(res, DeviceBuffer):
        res.ready = event
    return event


class P2PChannel:
    """Tag-matched send/recv rendezvous between rank engines (the JAX
    engine's ``_P2PChannel``).

    Sends and recvs match by ``(comm id, tag, src session, dst
    session)``, in posting order, independent of the gang's call
    sequence.  A receiver registers a *sink* (its buffer, or its stream
    port), so one channel serves both.  An unmatched post parks with a
    watchdog (a daemon timer at the engine timeout) that completes it
    with SEND_TIMEOUT or RECEIVE_TIMEOUT and ``{"op", "comm", "peer",
    "elapsed_s"}``.  Delivery runs outside the lock, on the thread of
    the side that arrives second.  Durations are measured: each request
    completes with its post-to-delivery wall-clock nanoseconds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sends: Dict[tuple, list] = {}
        self._recvs: Dict[tuple, list] = {}

    def parked(self) -> Dict[str, int]:
        """Unmatched posts by kind."""
        with self._lock:
            return {"send": sum(map(len, self._sends.values())),
                    "recv": sum(map(len, self._recvs.values()))}

    def dump_parked(self) -> List[str]:
        """One ``rxbuf`` line per unmatched post, as the JAX channel
        dumps them (a parked send holds its payload alive)."""
        lines = []
        with self._lock:
            for kind, table in (("SEND", self._sends),
                                ("RECV", self._recvs)):
                for (comm_id, tag, src, dst), entries in table.items():
                    lines += [f"rxbuf p2p-{kind} comm={comm_id} tag={tag} "
                              f"src={src} dst={dst} PARKED"] * len(entries)
        return lines

    def post_send(self, key, payload, request, timeout_s=None) -> None:
        t0 = time.perf_counter_ns()
        match = None
        with self._lock:
            if self._recvs.get(key):
                sink, rreq, rtimer, rt0 = self._recvs[key].pop(0)
                if rtimer is not None:
                    rtimer.cancel()
                match = (sink, rreq, rt0)
            else:
                self._park(self._sends, key, [payload, request], timeout_s,
                           t0)
        if match is not None:
            self._deliver(match[0], match[1], payload, request, match[2], t0)

    def post_recv(self, key, sink, request, timeout_s=None) -> None:
        t0 = time.perf_counter_ns()
        match = None
        with self._lock:
            if self._sends.get(key):
                payload, sreq, stimer, st0 = self._sends[key].pop(0)
                if stimer is not None:
                    stimer.cancel()
                match = (payload, sreq, st0)
            else:
                self._park(self._recvs, key, [sink, request], timeout_s, t0)
        if match is not None:
            self._deliver(sink, request, match[0], match[1], t0, match[2])

    def _park(self, table, key, entry, timeout_s, t0) -> None:
        """Append an unmatched post (the caller holds the lock), with a
        watchdog when a timeout is set."""
        entry.append(None)
        entry.append(t0)
        if timeout_s:
            code = (ErrorCode.SEND_TIMEOUT if table is self._sends
                    else ErrorCode.RECEIVE_TIMEOUT)
            t = threading.Timer(timeout_s, self._expire,
                                (table, key, entry, code))
            t.daemon = True
            entry[2] = t
            t.start()
        table.setdefault(key, []).append(entry)

    def _unpark(self, table, key, entry) -> bool:
        """Remove a parked entry by identity (the caller holds the lock);
        False when it was matched in the meantime."""
        lst = table.get(key, [])
        idx = next((i for i, e in enumerate(lst) if e is entry), None)
        if idx is None:
            return False
        del lst[idx]
        if not lst:
            del table[key]
        return True

    def _expire(self, table, key, entry, code) -> None:
        with self._lock:
            if not self._unpark(table, key, entry):
                return
        dt = time.perf_counter_ns() - entry[3]
        comm_id, _tag, src, dst = key
        entry[1].complete(code, dt, context={
            "op": entry[1].op_name,
            "comm": comm_id,
            # the absent partner: the sender for a starved recv, the
            # receiver for a starved send (global rank identities)
            "peer": src if code == ErrorCode.RECEIVE_TIMEOUT else dst,
            "elapsed_s": round(dt / 1e9, 3),
        })

    def cancel(self, session: int) -> int:
        """Fail every parked post made by rank ``session`` (its engine is
        shutting down): stop its watchdog and complete it with
        INVALID_OPERATION.  Returns how many were cancelled."""
        cancelled = []  # (comm id, peer, entry); keys: (comm, tag, src, dst)
        with self._lock:
            for table, me, peer in ((self._sends, 2, 3), (self._recvs, 3, 2)):
                for key in [k for k in table if k[me] == session]:
                    cancelled += [(key[0], key[peer], e) for e in table[key]]
                    del table[key]
        for comm_id, peer, entry in cancelled:
            if entry[2] is not None:
                entry[2].cancel()
            entry[1].complete(ErrorCode.INVALID_OPERATION, context={
                "op": entry[1].op_name, "comm": comm_id, "peer": peer,
                "error": "engine shut down",
            })
        return len(cancelled)

    @staticmethod
    def _deliver(sink, rreq: Request, payload, sreq: Request,
                 recv_t0: int, send_t0: int) -> None:
        try:
            event = sink(payload)
        except Exception as e:  # a payload the receiver cannot take
            t1 = time.perf_counter_ns()
            context = {"op": "RECV", "error":
                       f"{type(e).__name__}: {e}"[:300]}
            rreq.complete(ErrorCode.INVALID_OPERATION,
                          max(t1 - recv_t0, 1), context=context)
            sreq.complete(ErrorCode.INVALID_OPERATION,
                          max(t1 - send_t0, 1), context=context)
            return
        t1 = time.perf_counter_ns()
        rreq.complete(ErrorCode.OK, max(t1 - recv_t0, 1), event=event)
        sreq.complete(ErrorCode.OK, max(t1 - send_t0, 1))


class _GangSlot:
    """One gang event being assembled: each rank's entry, the world it
    waits for, its sequence number and reset generation, and the deadline
    of its watchdog (``comm`` names the absent ranks when it fires)."""

    __slots__ = ("calls", "world", "seq", "gen", "deadline", "comm")

    def __init__(self, world: int, seq: int, gen: int, timeout_s: float,
                 comm: Communicator):
        self.calls: Dict[int, tuple] = {}
        self.world = world
        self.seq = seq
        self.gen = gen
        self.deadline = time.monotonic() + timeout_s
        self.comm = comm

    def requests(self):
        """Every request parked in the slot (batch entries hold lists)."""
        for _, req in self.calls.values():
            if isinstance(req, list):
                yield from req
            else:
                yield req


class _SlotWatchdog:
    """The gang's slot timers: one deadline a slot being assembled, on one
    daemon thread (``accl-gang-watchdog``), which fires ``fire(key, slot)``
    at a slot's deadline unless the slot was cancelled (it assembled, or
    a reset or a verdict took it).  Arming wakes the thread only for a
    deadline earlier than the one it sleeps to, so a warm call, whose
    slot assembles long before its deadline, costs a dict insert and
    delete, never a thread wake-up.  The thread is started by an arm and
    exits once nothing was armed for a second, or at ``stop``."""

    _IDLE_S = 1.0

    def __init__(self, fire):
        self._fire = fire
        self._cv = threading.Condition()
        self._armed: Dict[tuple, _GangSlot] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._wake_at = float("inf")  # when the sleeping thread wakes
        self._last_arm = 0.0

    def arm(self, key: tuple, slot: _GangSlot) -> None:
        with self._cv:
            self._armed[key] = slot
            self._last_arm = time.monotonic()
            self._stop = False
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="accl-gang-watchdog",
                    daemon=True)
                self._thread.start()
            elif slot.deadline < self._wake_at:
                self._cv.notify()

    def cancel(self, key: tuple) -> None:
        with self._cv:
            self._armed.pop(key, None)

    def clear(self) -> None:
        with self._cv:
            self._armed.clear()

    def stop(self) -> None:
        """Cancel every timer and end the thread (a later arm restarts
        it)."""
        with self._cv:
            self._armed.clear()
            self._stop = True
            t, self._thread = self._thread, None
            self._cv.notify()
        if t is not None and t is not threading.current_thread():
            t.join(2.0)

    def _sleep_until(self, t: float, now: float) -> None:
        """Wait on the condition (held) until ``t`` or a notify."""
        self._wake_at = t
        self._cv.wait(t - now)
        self._wake_at = float("inf")

    def _loop(self) -> None:
        idle_since = time.monotonic()
        while True:
            due = []
            with self._cv:
                if self._stop:
                    return
                now = time.monotonic()
                if not self._armed:
                    idle_since = max(idle_since, self._last_arm)
                    if now - idle_since >= self._IDLE_S:
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                    self._sleep_until(idle_since + self._IDLE_S, now)
                    continue
                idle_since = now
                nxt = min(s.deadline for s in self._armed.values())
                if nxt > now:
                    self._sleep_until(nxt, now)
                    continue
                for key, slot in list(self._armed.items()):
                    if slot.deadline <= now:
                        del self._armed[key]
                        due.append((key, slot))
            for key, slot in due:
                try:
                    self._fire(key, slot)
                except Exception:  # a timer must never kill the thread
                    traceback.print_exc()


class CudaGangContext:
    """Shared per-process rendezvous point of every rank handle; every
    rank's buffers lie on ``device`` (the card unless the caller asks for
    another: ``ops.driver.resolve_device``, which raises without one).

    A communicator's rank i is the rank whose ``Rank.session`` it names
    (JAX's ``submesh``); on one card every member's buffers share the
    device, so a sub-communicator of P members runs the same lowerings
    over P rows.  Slots and sequence numbers are keyed by ``comm.id``.

    The fault plane, as the JAX gang's: a slot not assembled by its
    deadline (``timeout_s``) completes with RECEIVE_TIMEOUT naming the
    absent ranks, each of which takes a strike in the per-session
    ``health`` map; two strikes mark a session dead, and later calls
    addressing it fail at intake.  :meth:`soft_reset` drains the device
    work and abandons every table; :meth:`contract_fail` fails a
    communicator's parked slots on a contract verdict."""

    _DEAD_AFTER_TIMEOUTS = 2

    def __init__(self, device=None):
        self._lock = threading.Lock()
        self._slots: Dict[tuple, _GangSlot] = {}
        self._seq: Dict[Tuple[int, int], int] = {}
        # a communicator's gang events run in their sequence order, one at
        # a time (the last rank to arrive at event k may come before the
        # one of event k - 1 has finished it): _executed is the next
        # sequence number to run, _finished the later ones already done
        # (run, reaped by the watchdog or failed by a verdict), and
        # _reset_gen the generation soft_reset bumps, which strands no
        # waiter of an abandoned slot
        self._executed: Dict[int, int] = {}
        self._finished: Dict[int, set] = {}
        self._reset_gen = 0
        self._order = threading.Condition()
        self.timeout_s = DEFAULT_TIMEOUT_S
        self.watchdog = _SlotWatchdog(self._slot_expired)
        # per-session health, fed by the slot watchdog; soft_reset
        # clears it
        self.health: Dict[int, dict] = {}
        self._health_listeners: list = []
        self.tuning = dict(TUNING_DEFAULTS)
        # bumped by every register write: prepared state parked on a plan
        # under an older register set is rebuilt, never served
        self.tuning_epoch = 0
        self.device = opdriver.resolve_device(device)
        self.interactions = InteractionCounter()
        # the in-flight window: launched calls by communicator id, each
        # completed by the window's drainer once its device work ended
        self.window = InflightWindow()
        self.cmdring = GangCommandRing(self)
        # point-to-point: the tag-matched channel, and each rank's engine
        # by session (the destination of a stream_put)
        self.p2p = P2PChannel()
        self.peers: Dict[int, "CudaEngine"] = {}
        self.live: set = set()  # sessions whose engine is not shut down

    # -- the health map ------------------------------------------------------
    def add_health_listener(self, fn) -> None:
        """Register ``fn(session, old, new)``, called on every health
        transition (the membership plane's hook, one a rank handle)."""
        if fn not in self._health_listeners:
            self._health_listeners.append(fn)

    def remove_health_listener(self, fn) -> None:
        """Deregister (engine deinit): the gang outlives its handles."""
        if fn in self._health_listeners:
            self._health_listeners.remove(fn)

    def _health_note_absent(self, session: int) -> None:
        h = self.health.setdefault(
            session, {"state": "ok", "timeouts": 0, "failures": 0,
                      "last_event": ""})
        old = h["state"]
        h["timeouts"] += 1
        h["last_event"] = "gang_timeout"
        h["state"] = ("dead" if h["timeouts"] >= self._DEAD_AFTER_TIMEOUTS
                      else "suspect")
        if h["state"] != old:
            for fn in list(self._health_listeners):
                try:
                    fn(session, old, h["state"])
                except Exception:  # a listener must never fail the gang
                    pass

    def dead_rank_in(self, comm: Communicator) -> Optional[int]:
        """Comm-relative rank of a member other than the local one that
        the health map holds dead, or None."""
        if not self.health:
            return None
        for i, r in enumerate(comm.ranks):
            if i == comm.local_rank:
                continue
            h = self.health.get(r.session)
            if h is not None and h["state"] == "dead":
                return i
        return None

    # -- gang assembly -------------------------------------------------------
    def submit(self, comm: Communicator, options: CallOptions,
               request: Request) -> None:
        self._submit_entry(comm, (options, request))

    def submit_batch(self, comm: Communicator,
                     options_list: List[CallOptions],
                     requests: List[Request]) -> None:
        """A whole flushed batch as ONE gang event: every rank of the
        communicator must flush a batch of the same length at the same
        point of its call sequence."""
        self._submit_entry(comm, (list(options_list), list(requests)))

    def _submit_entry(self, comm: Communicator, entry: tuple) -> None:
        with self._lock:
            dead = self.dead_rank_in(comm)
            if dead is not None:
                h = dict(self.health.get(comm.ranks[dead].session, {}))
        if dead is not None:
            # fail fast: a member is dead, so a slot would only burn the
            # deadline again.  No sequence number is consumed; recovery
            # is the collective soft_reset
            ctx = {"comm": comm.id, "peer": dead,
                   "attempts": h.get("timeouts", 0), "elapsed_s": 0.0}
            opts = entry[0] if isinstance(entry[0], list) else [entry[0]]
            reqs = entry[1] if isinstance(entry[1], list) else [entry[1]]
            for o, req in zip(opts, reqs):
                req.complete(ErrorCode.RECEIVE_TIMEOUT,
                             context=dict(ctx, op=o.op.name))
            return
        with self._lock:
            seq_key = (comm.id, comm.local_rank)
            seq = self._seq.get(seq_key, 0)
            self._seq[seq_key] = seq + 1
            slot_key = (comm.id, seq)
            slot = self._slots.get(slot_key)
            arm = False
            if slot is None:
                slot = _GangSlot(comm.size, seq, self._reset_gen,
                                 self.timeout_s, comm)
                self._slots[slot_key] = slot
                arm = comm.size > 1  # one watchdog a slot
            slot.calls[comm.local_rank] = entry
            ready = len(slot.calls) == slot.world
            if ready:
                del self._slots[slot_key]
        if ready:
            self.watchdog.cancel(slot_key)
            with self._order:
                while (self._executed.get(comm.id, 0) < seq
                       and self._reset_gen == slot.gen):
                    # acclint: allow[unbounded-wait] every earlier number
                    # of the comm ends by _finish_seq: it runs, or its
                    # slot's watchdog reaps it at the gang timeout, or a
                    # soft_reset bumps the generation and notifies
                    self._order.wait()
                stale = self._reset_gen != slot.gen
            if stale:  # abandoned by a soft_reset while it waited
                for req in slot.requests():
                    if not req.done():
                        req.complete(ErrorCode.RECEIVE_TIMEOUT)
                return
            try:
                self._execute(comm, slot.calls)
            finally:
                self._finish_seq(comm.id, seq, slot.gen)
        elif arm:
            self.watchdog.arm(slot_key, slot)

    def _finish_seq(self, comm_id: int, seq: int, gen: int) -> None:
        """Sequence number ``seq`` of a communicator is done (it ran, or
        its slot was reaped or failed): the next one may run."""
        with self._order:
            if gen != self._reset_gen:
                return
            nxt = self._executed.get(comm_id, 0)
            if seq < nxt:  # a late slot of a number already reaped
                return
            done = self._finished.setdefault(comm_id, set())
            done.add(seq)
            while nxt in done:
                done.discard(nxt)
                nxt += 1
            self._executed[comm_id] = nxt
            self._order.notify_all()

    def _slot_expired(self, slot_key: tuple, slot: _GangSlot) -> None:
        """A slot's watchdog: if it is still being assembled, every member
        that never posted takes a strike and the slot's requests complete
        with RECEIVE_TIMEOUT naming them."""
        absent = []
        with self._lock:
            live = self._slots.get(slot_key) is slot
            if live:
                del self._slots[slot_key]
                for r in range(slot.world):
                    if r not in slot.calls:
                        absent.append(r)
                        self._health_note_absent(slot.comm.ranks[r].session)
        if not live:
            return
        self._finish_seq(slot_key[0], slot.seq, slot.gen)
        ctx = {"comm": slot_key[0],
               "peer": absent if len(absent) != 1 else absent[0],
               "elapsed_s": round(self.timeout_s, 3)}
        for req in slot.requests():
            req.complete(ErrorCode.RECEIVE_TIMEOUT,
                         context=dict(ctx, op=req.op_name))

    # -- recovery ------------------------------------------------------------
    def drain_device(self, deadline_s: float, reset_ring: bool = False
                     ) -> bool:
        """Wait, bounded, for the device work the gang launched: the
        in-flight window (every parked call completed), every
        command-ring window still in flight, then (on the card) every
        kernel queued on the current stream.  ``reset_ring`` halts the
        ring's live runs (and realigns it) before the stream drains, so a
        run lingering on its mailbox returns instead of holding the
        stream.  False when the bound ran out first."""
        end = time.monotonic() + deadline_s
        ok = self.window.drain(deadline_s)
        ok = self.cmdring.wait_in_flight(end) and ok
        if reset_ring:
            self.cmdring.reset()
        if self.device.type == "cuda":
            ev = _record_event(self.device)
            while not ev.query():
                if time.monotonic() > end:
                    return False
                time.sleep(0.0005)
        return ok

    def soft_reset(self) -> None:
        """The recovery reset (the reference's ``soft_reset``,
        accl.cpp:57-89), collective by contract: every rank handle issues
        it with nothing in flight, and each call idempotently clears the
        shared tables.  The device work drains first (bounded, so a
        wedged kernel cannot wedge recovery): the in-flight window, then
        the command ring, which halts its runs and realigns at 0 before
        the stream drains; then the parked slots, the sequence numbers
        and the health map go, the register epoch bumps (prepared plan
        state dies), and every parked call completes with
        RECEIVE_TIMEOUT (its gang never assembled)."""
        self.drain_device(drain_deadline_s(self.timeout_s), reset_ring=True)
        with self._lock:
            slots = list(self._slots.values())
            self._slots.clear()
            self._seq.clear()
            self.health.clear()
            self.tuning_epoch += 1
            with self._order:
                self._reset_gen += 1
                self._executed.clear()
                self._finished.clear()
                self._order.notify_all()
        self.watchdog.clear()
        for slot in slots:
            for req in slot.requests():
                if not req.done():
                    req.complete(ErrorCode.RECEIVE_TIMEOUT)

    def contract_fail(self, verdict: dict) -> None:
        """The contract plane convicted a divergence on
        ``verdict["comm"]``: every slot parked on it completes with
        CONTRACT_VIOLATION now (the detecting rank fails before dispatch,
        so its peers' parked calls would otherwise starve until the
        watchdog).  Idempotent: every rank's verifier calls it."""
        from ...contract import verdict_context

        comm_id = verdict.get("comm")
        with self._lock:
            keys = [k for k in self._slots if k[0] == comm_id]
            slots = [(k, self._slots.pop(k)) for k in keys]
        for key, slot in slots:
            self.watchdog.cancel(key)
            self._finish_seq(comm_id, slot.seq, slot.gen)
            for req in slot.requests():
                if not req.done():
                    req.complete(ErrorCode.CONTRACT_VIOLATION,
                                 context=verdict_context(verdict,
                                                         req.op_name))

    def realign(self, comm_id: int, local_rank: int) -> None:
        """A membership cutover re-shaped ``comm_id``: this rank's
        sequence restarts at 0 under its new comm-relative rank, and so
        does the comm's order of execution.  Every member realigns at its
        cutover, before its first call in the new membership, and no
        event of the new membership can assemble before the last member
        has, so the restart strands nothing.  (JAX's gang keeps the old
        numbering, so a joiner, which missed the old membership's calls,
        never matches again: ROADMAP §C.)"""
        with self._lock:
            self._seq[(comm_id, local_rank)] = 0
        with self._order:
            self._executed[comm_id] = 0
            self._finished.pop(comm_id, None)
            self._order.notify_all()

    def dump_state(self) -> List[str]:
        """One ``rxbuf`` line per parked gang slot (a collective some rank
        posted that never assembled), as the JAX gang dumps them."""
        with self._lock:
            return [f"rxbuf gang-slot comm={comm_id} seq={seq} PENDING "
                    f"posted_ranks={sorted(slot.calls)} world={slot.world}"
                    for (comm_id, seq), slot in self._slots.items()]

    @staticmethod
    def _sig(c: CallOptions) -> tuple:
        return (c.op, c.count, c.reduce_function, c.root_src, c.root_dst,
                c.compression, c.fuse, c.fuse_param)

    def _execute(self, comm: Communicator, calls: Dict[int, tuple]) -> None:
        entries = [calls[r] for r in range(comm.size)]
        batched = [isinstance(e[0], list) for e in entries]
        if any(batched) and not all(batched):
            # one rank flushed a batch where another posted a single
            # call: the gang sequence is torn, fail every request
            for opts, reqs in entries:
                for req in (reqs if isinstance(reqs, list) else [reqs]):
                    req.complete(ErrorCode.INVALID_OPERATION, context={
                        "error": "torn gang: batched and unbatched calls"})
            return
        if all(batched):
            self._execute_batch(comm, entries)
            return
        self._execute_calls(comm, [e[0] for e in entries],
                            [e[1] for e in entries])

    def _execute_calls(self, comm: Communicator, calls: List[CallOptions],
                       reqs: List[Request]) -> None:
        lead = calls[0]
        t0 = time.perf_counter_ns()
        event, context = None, None
        launched = False  # a device lowering ran: the window completes it
        p2p = [c.op in (Operation.SEND, Operation.RECV) for c in calls]
        try:
            if all(p2p):
                # a batched p2p position off the ring: a complementary pair
                # delivers directly, any other shape takes the channel as
                # unbatched calls would (the channel then completes them)
                code, event = self._execute_p2p_pair(comm, calls, reqs)
                if code is None:
                    return
            elif any(p2p):
                # p2p beside a collective in one position: a torn gang,
                # failed at once on every rank (the channel must not take
                # a collective as a recv)
                code = ErrorCode.INVALID_OPERATION
                context = {"op": lead.op.name,
                           "error": "torn gang: p2p and a collective at "
                                    "one batch position"}
            elif any(self._sig(c) != self._sig(lead) for c in calls[1:]):
                code = ErrorCode.INVALID_OPERATION  # mismatched gang calls
                context = {"op": lead.op.name, "error": "mismatched calls"}
            elif lead.fuse:
                # a fused call off the ring: its operand is packed for the
                # slot, so the plain base op has no correct spelling
                with annotate(f"accl::fused{int(lead.fuse)}_decomposed"):
                    code, event = self._execute_fused_decomposed(comm,
                                                                 calls)
            elif (self.cmdring.eager and self.cmdring.supports(lead.op)
                  and self.cmdring.run_batch(
                      comm, [([c], [q]) for c, q in zip(calls, reqs)], 1,
                      t0=t0)):
                return  # a one-slot window: the ring completed the calls
            elif (self.cmdring.eager and self.cmdring.supports(lead.op)
                  and self._circuit_refused(
                      comm, [([c], [q]) for c, q in zip(calls, reqs)])):
                return
            else:
                # the call's named range (the per-call span the
                # reference's perf counter provides), around its launch
                with annotate(f"accl::{lead.op.name.lower()}"):
                    code, event, launched = self._run_op(comm, calls, lead)
        except Exception as e:  # the gang boundary: fail every rank's call
            code = ErrorCode.INVALID_OPERATION
            context = {"op": lead.op.name,
                       "error": f"{type(e).__name__}: {e}"[:300]}
        if code == ErrorCode.OK and (launched or event is not None):
            self._park_inflight(comm.id, reqs, event, t0)
            return
        # an inline completion must not overtake the communicator's
        # parked calls (bounded: a wedged one must not wedge this one)
        self.window.drain_key(comm.id, drain_deadline_s(self.timeout_s))
        dt = time.perf_counter_ns() - t0
        for req in reqs:
            req.complete(code, dt, context=context, event=event)

    def _park_inflight(self, comm_id, reqs: List[Request], event,
                       t0: int) -> None:
        """Hand a launched call to the in-flight window (the JAX gang's
        ``_park_inflight``): its requests complete once ``event`` has
        passed (at once on the CPU), with the duration from ``t0`` to that
        end and the window's ``overlap_ns`` (None when nothing overlapped
        it) and ``inflight_depth``; a failed wait fails them with
        INVALID_OPERATION."""

        def on_ready(overlap_ns, depth, ready_ns):
            dt = max(ready_ns - t0, 1)
            for req in reqs:
                req.overlap_ns = overlap_ns or None
                req.inflight_depth = depth
                req.complete(ErrorCode.OK, dt, event=event)

        def on_error(exc):
            dt = max(time.perf_counter_ns() - t0, 1)
            ctx = {"comm": comm_id,
                   "error": f"{type(exc).__name__}: {exc}"[:300]}
            for req in reqs:
                if not req.done():
                    req.complete(ErrorCode.INVALID_OPERATION, dt,
                                 context=dict(ctx, op=req.op_name))

        self.window.park(comm_id, device_waiter(event), on_ready, on_error)

    def _execute_batch(self, comm: Communicator, entries: List[tuple]) -> None:
        """A fully matched batch: ``entries[r]`` is rank r's
        ``(options_list, requests_list)``.  The command ring first, then
        one fused dispatch of the plain lowerings (:meth:`_run_batch_fused`),
        else every position in order through the per-call path."""
        if len({len(e[0]) for e in entries}) != 1:
            for _, batch_reqs in entries:
                for req in batch_reqs:
                    req.complete(ErrorCode.INVALID_OPERATION, context={
                        "error": "batches of different lengths"})
            return
        npos = len(entries[0][0])
        try:
            handled = self.cmdring.run_batch(comm, entries, npos)
        except Exception:
            import traceback

            traceback.print_exc()
            handled = False
        if not handled and self._circuit_refused(comm, entries):
            return
        if not handled:
            handled = self._run_batch_fused(comm, entries, npos)
        if handled:
            return
        for i in range(npos):
            self._execute_calls(comm, [e[0][i] for e in entries],
                                [e[1][i] for e in entries])

    def _circuit_refused(self, comm: Communicator,
                         entries: List[tuple]) -> bool:
        """A batch the ring refused because the comm's breaker is open,
        on the card: under the ``xla`` registers the ring was the batch's
        kernel, and the plain lowering is no stand-in for a failing one,
        so every request fails at once with INVALID_OPERATION naming
        ``circuit_open`` (True).  A kernel register sends the batch on,
        position by position, to that kernel; on the CPU it takes JAX's
        host path (False for both)."""
        if self.device.type != "cuda":
            return False
        brk = self.cmdring.breaker_for(comm.id)
        if brk.state != CircuitBreaker.OPEN or any(
                c.effective_tuning(self.tuning).get(k, "xla") != "xla"
                for e in entries for c in e[0] for k in BATCH_TUNING_KEYS):
            return False
        context = {"comm": comm.id, "error": "circuit_open",
                   "breaker": brk.snapshot()}
        for _, reqs in entries:
            for req in reqs:
                req.complete(ErrorCode.INVALID_OPERATION, context=context)
        return True

    def _execute_p2p_pair(self, comm: Communicator, calls: List[CallOptions],
                          reqs: List[Request]):
        """A batched p2p position that did not ride the ring.  A
        complementary SEND/RECV pair delivers directly (the position is
        the rendezvous): one copy of the source operand into the
        receiver's result.  Any other shape (the cross exchange, whose
        pairs meet ACROSS positions, a mismatched tag, a compressed end)
        goes to the tag-matched channel call by call, as unbatched calls
        do; returns ``(None, None)`` then (the channel completes them),
        else ``(code, event)``."""
        pair = complementary_pair(calls)
        if pair is not None:
            src, dst = pair
            snd, rcv = calls[src], calls[dst]
            res = rcv.res
            if res is not None and not res.is_dummy:
                n = snd.count
                op0 = snd.op0
                src_t = _check(op0, n, snd.arithcfg.uncompressed,
                               "send operand")
                _wait_operands(src_t.device, [op0])
                self.interactions.bump()  # the delivery copy
                return ErrorCode.OK, p2p_device_deliver(
                    Payload(src_t), res, n)
        for call, req in zip(calls, reqs):
            engine = self.peers[comm.ranks[call.comm.local_rank].session]
            if call.op == Operation.SEND:
                engine._start_send(call, req)
            else:
                engine._start_recv(call, req)
        return None, None

    def _execute_fused_decomposed(self, comm: Communicator,
                                  calls: List[CallOptions]):
        """The fused semantics off the ring, in plain PyTorch on the
        operands' device, as the JAX engine's host reference computes
        them (rank-order fold, the scalar as given, not its Q16.16 word);
        counted as the ``fused_decomposed`` ring fallback."""
        lead = calls[0]
        size = len(calls)
        try:
            fuse = FusedCompute(int(lead.fuse))
        except ValueError:
            return ErrorCode.INVALID_OPERATION, None
        n = int(lead.count)
        if n <= 0 or fuse == FusedCompute.NONE:
            return ErrorCode.INVALID_OPERATION, None
        in_w, _ = ring_widths(lead.op, n, size, fuse=fuse)
        rows = []
        for c in calls:
            if (not isinstance(c.op0, DeviceBuffer)
                    or c.op0.count < in_w):
                return ErrorCode.INVALID_OPERATION, None
            rows.append(_check(c.op0, in_w, c.op0.dtype, "fused operand"))
        self.cmdring.note_fallback("fused_decomposed")
        self.interactions.bump()  # the decomposition's device work
        device = rows[0].device
        _wait_operands(device, [c.op0 for c in calls])
        fp = float(lead.fuse_param)
        outs = []
        if fuse == FusedCompute.ATTN_HOP:
            hop = int(lead.root_src)
            for r in range(size):
                src = (r - hop + size) % size
                outs.append(fp * (rows[r][n:2 * n] * rows[src][:n]))
        else:
            op = reduce_op(lead.reduce_function)
            reduced = rows[0][:n * size]
            for row in rows[1:]:
                reduced = op(reduced, row[:n * size])
            for r in range(size):
                chunk = reduced[r * n:(r + 1) * n]
                if fuse == FusedCompute.MATMUL_RS:
                    outs.append(fp * chunk)
                else:  # APPLY: the param tail minus the scaled chunk
                    outs.append(rows[r][size * n:(size + 1) * n] - fp * chunk)
        writers = [r for r, c in enumerate(calls)
                   if c.res is not None and not c.res.is_dummy]
        for r in writers:
            _check(calls[r].res, n, lead.arithcfg.uncompressed,
                   "fused result").copy_(outs[r])
        event = _record_event(device)
        for r in writers:
            calls[r].res.ready = event
        return ErrorCode.OK, event

    def _plan_device_call(self, comm: Communicator, calls: List[CallOptions],
                          lead: CallOptions) -> Optional[dict]:
        """Validate a gang call for the ring BEFORE any device work, as the
        JAX engine's ``_plan_device_call`` does: operands and results must
        be device buffers on the gang's device, of the call's dtype and at
        least its widths, and BCAST in place.  None: the call cannot ride
        a ring slot (``host_operands``)."""
        op = lead.op
        if op not in IN_W:
            return None
        size, n = comm.size, lead.count
        if n <= 0:
            return None
        in_w = n * (size if IN_W[op] == "P" else 1)
        out_w = n * (size if OUT_W[op] == "P" else 1)
        dtype = lead.arithcfg.uncompressed
        compressed = bool(lead.compression & CompressionFlags.ETH_COMPRESSED)
        if op in (Operation.REDUCE, Operation.GATHER):
            writers = {lead.root_dst if op == Operation.REDUCE
                       else lead.root_src}
        else:
            writers = set(range(size))

        def on_device(buf, width):
            return (isinstance(buf, DeviceBuffer)
                    and buf.device == self.device
                    and buf.count >= width and buf.dtype == dtype)

        any_device = False
        for r, call in enumerate(calls):
            buf = call.op0
            if buf is not None and not buf.is_dummy:
                if not on_device(buf, in_w):
                    return None
                any_device = True
            res = call.res
            if (r in writers and res is not None and not res.is_dummy
                    and not on_device(res, out_w)):
                return None
        if not any_device:
            return None
        if op == Operation.BCAST and any(c.op0 is not c.res for c in calls):
            return None
        return {
            "op": op, "n": n, "in_w": in_w, "out_w": out_w,
            "dtype": dtype_to_torch(dtype), "compressed": compressed,
            "wire": (dtype_to_torch(lead.arithcfg.compressed)
                     if compressed else None),
            "writers": writers,
        }

    def _run_batch_fused(self, comm: Communicator, entries: List[tuple],
                         npos: int) -> bool:
        """A batch the command ring refused (``oversized``, ``wire_lane``),
        as ONE gang dispatch: every position runs its plain ``xla``
        lowering, in position order, and every request completes with the
        batch's one event (the JAX engine's ``_run_batch_fused``).
        Returns False, having launched nothing, when a position
        disqualifies: a non-``xla`` algorithm register, a fused slot, a
        torn gang signature, operands off the device path, or a position
        reading what an earlier one writes (JAX's fused program reads
        every operand before it writes any result).  Once it runs, it
        owns the requests' completion: a failure fails the rest, and no
        position runs twice."""
        if npos == 0 or any(
                c.effective_tuning(self.tuning).get(k, "xla") != "xla"
                for e in entries for c in e[0] for k in BATCH_TUNING_KEYS):
            return False
        if any(c.op in (Operation.SEND, Operation.RECV)
               for e in entries for c in e[0]):
            return False  # p2p positions run position by position
        positions = []
        written: set = set()  # result roots of earlier positions
        for i in range(npos):
            calls = [e[0][i] for e in entries]
            lead = calls[0]
            if lead.fuse or any(self._sig(c) != self._sig(lead)
                                for c in calls[1:]):
                return False
            plan = self._plan_device_call(comm, calls, lead)
            if plan is None:
                return False
            for call in calls:
                buf = call.op0
                if (buf is not None and not buf.is_dummy
                        and buffer_root(buf) in written):
                    return False
            for r in plan["writers"]:
                res = calls[r].res
                if res is not None and not res.is_dummy:
                    written.add(buffer_root(res))
            positions.append((calls, lead))
        t0 = time.perf_counter_ns()
        done = 0
        all_reqs = [req for _, batch_reqs in entries for req in batch_reqs]
        try:
            self.interactions.bump()  # ONE dispatch for the whole batch
            writers = []
            with annotate(f"accl::batch[{len(positions)}]"):
                for calls, lead in positions:
                    writers += [calls[r].res
                                for r in self._lower(comm, calls, lead)]
                    done += 1
            event = _record_event(self.device)
            for res in writers:
                res.ready = event
        except Exception as e:
            context = {"comm": comm.id, "position": done,
                       "error": f"{type(e).__name__}: {e}"[:300]}
            self.window.drain_key(comm.id, drain_deadline_s(self.timeout_s))
            dt = time.perf_counter_ns() - t0
            for req in all_reqs:
                req.complete(ErrorCode.INVALID_OPERATION, dt, context=context)
            return True
        # one launch: every position completes together, from the window
        self._park_inflight(comm.id, all_reqs, event, t0)
        return True

    def _run_op(self, comm: Communicator, calls: List[CallOptions],
                lead: CallOptions):
        """One gang call: the prepared warm path when the call's plan holds
        its state, else the full device path (which parks that state on
        the plan), or the host-staged path when an operand or result is
        host-only.  Returns ``(code, event, launched)``: ``launched`` when
        a device lowering ran (the call then rides the in-flight
        window)."""
        op = lead.op
        if op == Operation.BARRIER:
            # gang assembly IS the barrier (every rank posted the call),
            # and a drain point of the communicator: it passes once the
            # comm's parked calls completed, or fails within the deadline
            if not self.window.drain_key(comm.id,
                                         drain_deadline_s(self.timeout_s)):
                return ErrorCode.RECEIVE_TIMEOUT, None, False
            return ErrorCode.OK, None, False
        if op not in IN_W:
            return ErrorCode.COLLECTIVE_NOT_IMPLEMENTED, None, False
        if any(isinstance(b, HostBuffer) for c in calls
               for b in (c.op0, c.res)):
            return (*self._run_op_host(comm, calls, lead), False)
        fp = lead.plan
        if fp is not None and op in _FAST_OPS:
            # prepared state is keyed by the exact count: the plan is
            # bucket-keyed, and counts within one bucket keep their own
            states = fp.engine.get("gang")
            state = states.get(lead.count) if states else None
            if state is not None and state["tuning_epoch"] == self.tuning_epoch:
                done = self._run_op_device_prepared(calls, lead, state)
                if done is not None:
                    return (*done, True)
            elif all(type(c.op0) is DeviceBuffer for c in calls):
                # a shape the warm path can take (every rank an operand):
                # park its template on the plan
                tmpl = self._plan_device_call(comm, calls, lead)
                if tmpl is not None:
                    states = fp.engine.setdefault("gang", {})
                    if len(states) > 8 and lead.count not in states:
                        states.clear()  # count churn within one bucket
                    states[lead.count] = {
                        "tmpl": tmpl, "tuning_epoch": self.tuning_epoch,
                        "mesh": opdriver.Mesh(comm.size, self.device),
                        "handles": {},
                    }
        self.interactions.bump()  # THE dispatch
        writers = self._lower(comm, calls, lead)
        event = _record_event(self.device)
        for r in writers:
            calls[r].res.ready = event
        return ErrorCode.OK, event, True

    def _run_op_device_prepared(self, calls: List[CallOptions],
                                lead: CallOptions, state: dict):
        """The warm path of a planned call (the JAX engine's
        ``_run_op_device_prepared``): per call only the operands are held
        against the template -- the same refusals as JAX's: a view, a
        dummy, another device, another dtype, ranks of unequal width, a
        width below ``in_w`` -- and the ONE prepared handle runs.  None
        takes the full path."""
        tmpl = state["tmpl"]
        dev, tdt = self.device, tmpl["dtype"]
        xs, bufs = [], []
        w = None
        for call in calls:
            buf = call.op0
            if (type(buf) is not DeviceBuffer or buf._parent is not None
                    or buf.device != dev or buf.tensor.dtype != tdt):
                return None
            buf.resolve_pending()
            if w is None:
                w = buf.count
            elif buf.count != w:
                return None
            xs.append(buf.tensor)
            bufs.append(buf)
        if w < tmpl["in_w"]:
            return None
        out_w = tmpl["out_w"]
        writers = tmpl["writers"]
        outs = []
        for r, call in enumerate(calls):
            res = call.res
            if r not in writers or res is None or res.is_dummy:
                outs.append(None)
                continue
            if not (type(res) is DeviceBuffer and res.device == dev
                    and res.count >= out_w and res.tensor.dtype == tdt):
                return None
            res.resolve_pending()
            outs.append(res.tensor if res.count == out_w
                        else res.tensor[:out_w])
        handle = state["handles"].get(w)
        if handle is None:
            op, wire = tmpl["op"], (lead.arithcfg.compressed
                                    if tmpl["compressed"] else None)
            name, extra = resolve_lowering(
                op, lead, lead.effective_tuning(self.tuning), wire)
            prep_wire = (WIRE_LANE_DTYPES[wire.name]
                         if wire is not None and op != Operation.ALLREDUCE
                         else None)
            # as JAX's: a prep step only for width slack or a wire
            prep = ((tmpl["in_w"], prep_wire)
                    if w != tmpl["in_w"] or prep_wire is not None else None)
            handle = opdriver.prepare(
                name, state["mesh"], lead.reduce_function, extra, prep)
            state["handles"][w] = handle
        _wait_operands(dev, bufs)
        self.interactions.bump()  # THE dispatch: one prepared handle
        handle(xs, outs)
        event = _record_event(dev)
        for r, o in enumerate(outs):
            if o is not None:
                calls[r].res.ready = event
        return ErrorCode.OK, event

    def _lower(self, comm: Communicator, calls: List[CallOptions],
               lead: CallOptions):
        """Run one gang call's device lowering on the current stream (the
        registers pick it); returns the ranks whose results it wrote."""
        op = lead.op
        n, size = lead.count, comm.size
        dtype = lead.arithcfg.uncompressed
        wire = (
            lead.arithcfg.compressed
            if lead.compression & CompressionFlags.ETH_COMPRESSED else None
        )
        in_w = n * (size if IN_W[op] == "P" else 1)
        out_w = n * (size if OUT_W[op] == "P" else 1)
        root = lead.root_dst if op == Operation.REDUCE else lead.root_src
        # only the root reads an operand for SCATTER and takes a result
        # for REDUCE / GATHER; the other ranks may pass DummyBuffers
        readers = {root} if op == Operation.SCATTER else range(size)
        writers = ({root} if op in (Operation.REDUCE, Operation.GATHER)
                   else range(size))
        xs = [_check(c.op0, in_w, dtype, f"{op.name} operand")
              if r in readers else None for r, c in enumerate(calls)]
        outs = [_check(c.res, out_w, dtype, f"{op.name} result")
                if r in writers else None for r, c in enumerate(calls)]
        device = xs[root].device
        mesh = opdriver.Mesh(size, device)
        _wait_operands(device, [c.op0 for c in calls])
        fn = lead.reduce_function
        tuning = lead.effective_tuning(self.tuning)
        if op == Operation.ALLREDUCE:
            # the wire lane runs inside the allreduce (one rounding)
            run_allreduce_with_tuning(xs, mesh, fn, wire, tuning, out=outs)
            return writers
        if wire is not None:
            # each contribution rounded once through the wire, every
            # rank's row in one launch per kernel; deterministic, as the
            # JAX gang's in-program lane (its per-call seeds feed the
            # host-staged path and the facade's error feedback)
            live = [r for r, x in enumerate(xs) if x is not None]
            rounded = wire_lane_roundtrip_rows([xs[r] for r in live], wire)
            for r, x in zip(live, rounded):
                xs[r] = x
        if op == Operation.SCATTER:
            xs = [xs[root]] * size  # only the root's operand is read
        if op in ROOTED_OPS:
            run_rooted_with_tuning(op, xs, mesh, lead, tuning, out=outs)
        elif op == Operation.ALLGATHER:
            opdriver.run_allgather(xs, mesh, out=outs)
        elif op == Operation.ALLTOALL:
            opdriver.run_alltoall(xs, mesh, out=outs)
        else:
            opdriver.run_reduce_scatter(xs, mesh, fn, out=outs)
        return writers

    # -- the host-staged path ------------------------------------------------
    def _run_op_host(self, comm: Communicator, calls: List[CallOptions],
                     lead: CallOptions):
        """A call with a host-only operand or result, staged through the
        host (the JAX engine's ``_run_op_host`` where its ranks have no
        device mesh): every rank's operand read to the host (one counted
        interaction a device operand), the collective computed there with
        the rank-order fold of ``_host_reduce`` (NaN-propagating MAX),
        compressed contributions rounded by the host codec with each
        rank's mixed seed (the allreduce: one cast of every operand
        through the wire, as JAX's ``_allreduce`` has it), and every
        result written back (one counted interaction a device result)."""
        op = lead.op
        size, n = comm.size, lead.count
        fn = lead.reduce_function
        tdt = dtype_to_torch(lead.arithcfg.uncompressed)
        compressed = bool(lead.compression & CompressionFlags.ETH_COMPRESSED)
        wire = lead.arithcfg.compressed if compressed else None
        ic = self.interactions

        def stack(width: int) -> List[torch.Tensor]:
            rows = []
            for call in calls:
                buf = call.op0
                row = torch.zeros(width, dtype=tdt)
                if buf is not None and not buf.is_dummy:
                    if isinstance(buf, DeviceBuffer):
                        ic.bump()  # the device-to-host read of the operand
                        buf.resolve_pending()
                        buf.wait_ready()
                    src = buf.tensor[:width].to("cpu")
                    row[:src.numel()] = src
                rows.append(row)
            return rows

        def wire_cast(rows):
            if wire is None:
                return rows
            return [astype(roundtrip(row, wire,
                                     rank_seed(lead.wire_seed, r)), tdt)
                    for r, row in enumerate(rows)]

        def host_reduce(rows) -> torch.Tensor:
            # numpy's fold: each step computed in float32 and rounded to
            # a 16-bit dtype as its astype rounds it; its maximum hands
            # on the NaN operand itself (torch's makes a NaN of its own)
            red = reduce_op(fn)
            if fn == ReduceFunction.MAX and tdt.is_floating_point:
                def red(a, b):
                    return torch.where(a.isnan(), a, torch.where(
                        b.isnan(), b, torch.maximum(a, b)))
            narrow = tdt in (torch.float16, torch.bfloat16)
            acc = rows[0]
            for row in rows[1:]:
                acc = (astype(red(widen(acc), widen(row)), tdt) if narrow
                       else red(acc, row))
            return acc

        def write(call, row, width: int) -> None:
            buf = call.res
            if buf is None or buf.is_dummy:
                return
            if buf.count < width:
                raise ValueError(f"{op.name} result: needs {width} elements, "
                                 f"buffer holds {buf.count}")
            val = convert(row[:width], buf.tensor.dtype)
            if isinstance(buf, DeviceBuffer):
                buf.store(val, width)
                ic.bump()  # the host-to-device write of the result
            else:
                buf.tensor[:width].copy_(val)

        if op == Operation.ALLREDUCE:
            rows = stack(n)
            if wire is not None:
                # JAX's host _allreduce: every operand cast through the
                # wire and back (numpy's astype, no seed; an int8 wire is
                # the C cast, not the scaled lane)
                wdt = dtype_to_torch(wire)
                rows = [astype(astype(row, wdt), tdt) for row in rows]
            full = host_reduce(rows)
            for call in calls:
                write(call, full, n)
        elif op in (Operation.REDUCE, Operation.BCAST, Operation.GATHER,
                    Operation.ALLGATHER):
            rows = wire_cast(stack(n))
            if op == Operation.REDUCE:
                write(calls[lead.root_dst], host_reduce(rows), n)
            elif op == Operation.BCAST:
                for call in calls:
                    write(call, rows[lead.root_src], n)
            elif op == Operation.GATHER:
                write(calls[lead.root_src], torch.cat(rows), size * n)
            else:
                full = torch.cat(rows)
                for call in calls:
                    write(call, full, size * n)
        else:  # the ops whose operands hold size * n elements
            rows = wire_cast(stack(size * n))
            if op == Operation.REDUCE_SCATTER:
                full = host_reduce(rows)
                for r, call in enumerate(calls):
                    write(call, full[r * n:(r + 1) * n], n)
            elif op == Operation.SCATTER:
                blocks = rows[lead.root_src]
                for r, call in enumerate(calls):
                    write(call, blocks[r * n:(r + 1) * n], n)
            else:  # ALLTOALL
                for r, call in enumerate(calls):
                    write(call, torch.cat([rows[p][r * n:(r + 1) * n]
                                           for p in range(size)]), size * n)
        return ErrorCode.OK, None


class CudaEngine(StreamPortMixin, BaseEngine):
    """One rank handle's engine over a shared gang context.  Local ops
    (copy / combine) run at once on the caller's thread; collectives
    rendezvous at the gang; sends and recvs meet in the gang's
    :class:`P2PChannel`; each engine owns its rank's stream ports."""

    def __init__(self, gang: CudaGangContext, device, session: int = 0):
        self.gang = gang
        self.device = torch.device(device)
        self.session = int(session)
        self.timeout_s = DEFAULT_TIMEOUT_S
        self._mbr_fwd = None
        # the QoS arbiter plane's mirror of this handle's SET_TENANT_*
        # writes: comm id -> {class, weight, window_share, ring_slots,
        # rate}, as the JAX gang engine keeps it
        self.tenants: Dict[int, dict] = {}
        gang.peers[self.session] = self
        gang.live.add(self.session)
        self._init_streams()

    def start(self, options: CallOptions) -> Request:
        req = Request(op_name=options.op.name)
        req.mark_executing()
        self._start_with(options, req)
        return req

    def start_batch(self, items) -> None:
        """Dispatch a flushed batch.  Maximal runs of gang collectives on
        one communicator submit as ONE gang batch event; local ops, sends,
        recvs, calls with a stream operand and config calls break the run
        and run on their own, in issue order."""
        run: list = []
        run_comm = None

        def flush_run():
            nonlocal run, run_comm
            if run:
                self.gang.submit_batch(run_comm, [o for o, _ in run],
                                       [r for _, r in run])
            run, run_comm = [], None

        for options, req in items:
            req.mark_executing()
            gang_eligible = ((options.op in IN_W
                              or options.op == Operation.BARRIER)
                             and options.stream == StreamFlags.NO_STREAM)
            # a batched SEND / RECV on a world-2 gang joins the run, so a
            # matched pair can ride one ring slot (root = src, peer =
            # dst); unpaired positions fall back per position
            if (options.op in (Operation.SEND, Operation.RECV)
                    and options.stream == StreamFlags.NO_STREAM
                    and self.gang.cmdring.p2p_eligible(options)):
                gang_eligible = True
            if gang_eligible:
                if run_comm is not None and options.comm is not run_comm:
                    flush_run()
                run_comm = options.comm
                run.append((options, req))
            else:
                flush_run()
                self._start_with(options, req)
        flush_run()

    def _start_with(self, options: CallOptions, req: Request) -> None:
        op = options.op
        if op == Operation.CONFIG:
            req.complete(self._apply_config(options))
        elif op == Operation.NOP:
            req.complete(ErrorCode.OK)
        elif op in (Operation.COPY, Operation.COMBINE):
            if options.stream & StreamFlags.OP0_STREAM:
                # the operand arrives from a producer on the stream port:
                # wait for it off the caller's thread
                self._spawn_completing(
                    lambda: self._complete_local(options, req), req)
            else:
                self._complete_local(options, req)
        elif (op == Operation.REDUCE
              and options.stream != StreamFlags.NO_STREAM):
            self._spawn_completing(
                lambda: self._gang_with_streams(options, req), req)
        elif op == Operation.SEND:
            self._start_send(options, req)
        elif op == Operation.RECV:
            self._start_recv(options, req)
        else:
            self.gang.submit(options.comm, options, req)

    def _complete_local(self, options: CallOptions, req: Request) -> None:
        """A copy or combine, run on the caller's thread: a launch on the
        card rides the in-flight window under this rank's own key and
        completes when its event passed; the CPU's completes at once, as
        the JAX engine's host-side local ops do."""
        t0 = time.perf_counter_ns()
        try:
            code, event = self._local_op(options)
        except Exception as e:
            req.complete(ErrorCode.INVALID_OPERATION, context={
                "op": options.op.name,
                "error": f"{type(e).__name__}: {e}"[:300],
            })
            return
        if code == ErrorCode.OK and event is not None:
            self.gang._park_inflight(f"local-{self.session}", [req], event,
                                     t0)
            return
        req.complete(code, time.perf_counter_ns() - t0, event=event)

    # -- point-to-point ------------------------------------------------------
    def _start_recv(self, options: CallOptions, req: Request) -> None:
        """Post a receive: into the result buffer, or (RES_STREAM) into
        this rank's stream port as the payload's bytes, in its wire
        dtype.  Keys use global rank identities (``Rank.session``)."""
        comm = options.comm
        src_world = comm.ranks[options.root_src].session
        me_world = comm.ranks[comm.local_rank].session
        key = (comm.id, options.tag, src_world, me_world)
        if options.stream & StreamFlags.RES_STREAM:
            def sink(payload):
                self.stream_push(options.stream_id, payload.host_bytes())
        else:
            ic = self.gang.interactions

            def sink(payload, res=options.res, n=options.count):
                # checked now, so a pair that cannot match fails both
                # sides at the channel; the copy itself is parked on the
                # result buffer and runs at the receiver's wait() or
                # first device read (JAX's lazy delivery)
                p2p_check(payload, res, n)

                def deliver():
                    req.event = p2p_device_deliver(payload, res, n)
                    ic.bump()  # the delivery copy

                if isinstance(res, HostBuffer):
                    deliver()  # a host-only receiver takes it at once
                    return req.event
                res.defer_store(deliver)
                req.defer_result(res.resolve_pending, handle=payload.tensor)
                return None
        self.gang.p2p.post_recv(key, sink, req, timeout_s=self.timeout_s)

    def _start_send(self, options: CallOptions, req: Request) -> None:
        """SEND with all four routings: a buffer or this rank's stream port
        as the source, a tag-matched receive or the destination's stream
        port (RES_STREAM: ``stream_put``) as the destination."""
        comm = options.comm

        def resolve_and_route():
            t0 = time.perf_counter_ns()
            cfg = options.arithcfg
            wire = (dtype_to_torch(cfg.compressed)
                    if options.compression & CompressionFlags.ETH_COMPRESSED
                    else None)
            if options.stream & StreamFlags.OP0_STREAM:
                t = self._pop_stream_payload(options)
                if t is None:
                    req.complete(ErrorCode.DMA_TIMEOUT, context={
                        "op": "SEND", "stream_id": options.stream_id})
                    return
                payload = Payload(t if wire is None else convert(t, wire))
            else:
                src = _check(options.op0, options.count, cfg.uncompressed,
                             "send operand")
                _wait_operands(src.device, [options.op0])
                if isinstance(options.op0, DeviceBuffer):
                    self.gang.interactions.bump()  # the payload copy
                if wire is not None:
                    # row 5 narrows on the sending side: the wire (and the
                    # copy the receiver makes) carries the narrow dtype
                    t = convert(src, wire)
                elif options.stream & StreamFlags.RES_STREAM:
                    t = src  # copied to the host below, before returning
                else:
                    # a fresh copy: the sender may overwrite its buffer
                    # as soon as the call returns
                    t = src.clone()
                payload = Payload(t, _record_event(t.device))
            dst_world = comm.ranks[options.root_dst].session
            me_world = comm.ranks[comm.local_rank].session
            if options.stream & StreamFlags.RES_STREAM:
                peer = self.gang.peers.get(dst_world)
                if peer is None:
                    req.complete(ErrorCode.TRANSPORT_ERROR, context={
                        "op": "SEND", "peer": dst_world})
                    return
                peer.stream_push(options.stream_id, payload.host_bytes())
                req.complete(ErrorCode.OK,
                             max(time.perf_counter_ns() - t0, 1))
                return
            key = (comm.id, options.tag, me_world, dst_world)
            self.gang.p2p.post_send(key, payload, req,
                                    timeout_s=self.timeout_s)

        def guarded():
            try:
                resolve_and_route()
            except Exception as e:  # an operand the send cannot take
                req.complete(ErrorCode.INVALID_OPERATION, context={
                    "op": "SEND", "error": f"{type(e).__name__}: {e}"[:300],
                })

        if options.stream & StreamFlags.OP0_STREAM:
            # the operand arrives from a producer on the stream port: wait
            # for it off the caller's thread
            self._spawn_completing(guarded, req)
        else:
            guarded()

    def _spawn_completing(self, fn, req: Request) -> None:
        """Run ``fn`` on a daemon thread; an escaping exception completes
        the request with an error instead of leaving its waiter hanging."""

        def run():
            try:
                fn()
            except Exception as e:
                if not req.done():
                    req.complete(ErrorCode.INVALID_OPERATION, context={
                        "op": req.op_name,
                        "error": f"{type(e).__name__}: {e}"[:300],
                    })

        threading.Thread(target=run, name="accl-cuda-op", daemon=True).start()

    def _gang_with_streams(self, options: CallOptions, req: Request) -> None:
        """A reduce with stream operands: pull OP0 from this rank's stream
        port into a device buffer, run the gang collective on it, and push
        the root's result to its stream port (RES_STREAM)."""
        opts = options
        dtype = opts.arithcfg.uncompressed
        if opts.stream & StreamFlags.OP0_STREAM:
            payload = self._pop_stream_payload(opts)
            if payload is None:
                req.complete(ErrorCode.DMA_TIMEOUT, context={
                    "op": opts.op.name, "stream_id": opts.stream_id})
                return
            tmp = make_buffer(self.device, opts.count, dtype,
                              data=convert(payload, dtype_to_torch(dtype)))
            opts = dataclasses.replace(
                opts, op0=tmp, stream=opts.stream & ~StreamFlags.OP0_STREAM)
        res_to_stream = bool(opts.stream & StreamFlags.RES_STREAM)
        tmp_res = None
        if res_to_stream:
            is_root = opts.comm.local_rank == opts.root_dst
            tmp_res = (DeviceBuffer(opts.count, dtype, self.device)
                       if is_root else DummyBuffer(0, dtype))
            opts = dataclasses.replace(
                opts, res=tmp_res,
                stream=opts.stream & ~StreamFlags.RES_STREAM)
        inner = Request(op_name=opts.op.name)
        inner.mark_executing()
        self.gang.submit(opts.comm, opts, inner)
        if not inner.wait(drain_deadline_s(self.timeout_s)):
            req.complete(ErrorCode.DEADLOCK_SUSPECTED, context={
                "op": opts.op.name, "error": "the gang never assembled"})
            return
        code = inner.get_retcode()
        if code == ErrorCode.OK and res_to_stream and not tmp_res.is_dummy:
            self._push_stream_result(options, tmp_res.tensor)
        req.complete(code, inner.get_duration_ns(),
                     context=inner.error_context)

    # -- local ops -------------------------------------------------------------
    def _local_op(self, options: CallOptions):
        """COPY or COMBINE; returns ``(code, event)``.  OP0_STREAM takes
        the first operand from this rank's stream port (DMA_TIMEOUT when
        it does not arrive in time), RES_STREAM pushes the result there."""
        n = options.count
        dtype = options.arithcfg.uncompressed
        combine = options.op == Operation.COMBINE
        if options.stream & StreamFlags.OP0_STREAM:
            payload = self._pop_stream_payload(options)
            if payload is None:
                return ErrorCode.DMA_TIMEOUT, None
            src = convert(payload, dtype_to_torch(dtype)).to(self.device)
            waits = [options.op1] if combine else []
        else:
            src = _check(options.op0, n, dtype, "operand")
            waits = [options.op0, options.op1]
        if not options.stream & StreamFlags.RES_STREAM:
            res = options.res
            if (not isinstance(res, (DeviceBuffer, HostBuffer))
                    or res.count < n):
                raise ValueError(f"result buffer too small for {n} elements")
            waits.append(res)
            _wait_operands(res.tensor.device, waits)
        else:
            _wait_operands(src.device, waits)
        if options.stream & StreamFlags.RES_STREAM:
            out = src
            if combine:
                out = kernel_combine(
                    src, _check(options.op1, n, dtype, "second operand"),
                    options.reduce_function)
            self._push_stream_result(options, out)
            return ErrorCode.OK, None
        dst = res.tensor[:n]
        if src.device != dst.device:  # a host-only side: stage the operand
            _wait_operands(src.device, waits)
            src = src.to(dst.device)
        if isinstance(res, DeviceBuffer):
            self.gang.interactions.bump()  # the device copy or combine
        if combine:
            other = _check(options.op1, n, dtype, "second operand")
            if other.device != dst.device:
                other = other.to(dst.device)
            # K4: op(a, b) cast to the result buffer's dtype, in place
            # when the result is the first operand
            kernel_combine(src, other, options.reduce_function,
                           dst.dtype, out=dst)
        else:
            convert(src, dst.dtype, out=dst)  # row 5 between wire dtypes
        event = _record_event(dst.device)
        if isinstance(res, DeviceBuffer):
            res.ready = event
        return ErrorCode.OK, event

    def _apply_config(self, options: CallOptions) -> ErrorCode:
        fn = ConfigFunction(options.cfg_function)
        val = options.cfg_value
        if fn == ConfigFunction.RESET:
            # 0: the handle's init-time reset, with nothing to abandon;
            # 1 or more: the full flush of soft_reset
            if val >= 1:
                self.gang.soft_reset()
        elif fn == ConfigFunction.SET_TIMEOUT:
            # the deadline of parked sends and recvs and of stream pops,
            # and the gang's slot watchdog
            if val <= 0:
                return ErrorCode.CONFIG_ERROR
            self.timeout_s = float(val)
            self.gang.timeout_s = float(val)
        elif fn in (ConfigFunction.SET_RETRY_LIMIT,
                    ConfigFunction.SET_RETRY_BACKOFF):
            # validated only: the gang has no host retransmit (its ranks
            # share a device), as JAX's device tier has none
            if val < 0 or (val == 0
                           and fn == ConfigFunction.SET_RETRY_BACKOFF):
                return ErrorCode.CONFIG_ERROR
        elif fn == ConfigFunction.SET_MAX_EAGER_SIZE:
            # validated only: the gang has no eager protocol (one device,
            # no wire); the plan's eager verdict reads the handle's copy
            if not 0 < val <= MAX_EAGER_SIZE_LIMIT:
                return ErrorCode.CONFIG_ERROR
        elif fn == ConfigFunction.SET_MAX_RENDEZVOUS_SIZE:
            if val <= 0:
                return ErrorCode.CONFIG_ERROR
        elif fn == ConfigFunction.SET_TUNING:
            code = apply_tuning(self.gang.tuning, options)
            if code == ErrorCode.OK:
                self.gang.tuning_epoch += 1
            return code
        elif fn == ConfigFunction.SET_INFLIGHT_WINDOW:
            if not 1 <= val <= MAX_INFLIGHT_WINDOW:
                return ErrorCode.CONFIG_ERROR
            # a drain point: nothing launched under the old depth is in
            # flight when the new one starts admitting (bounded)
            if not self.gang.window.drain(
                    drain_deadline_s(self.gang.timeout_s)):
                return ErrorCode.RECEIVE_TIMEOUT
            self.gang.window.set_depth(int(val))
        elif fn in _TENANT_CONFIG:
            # the QoS arbiter plane, through the validator every tier
            # shares; WINDOW_SHARE becomes the communicator's depth in the
            # in-flight window (after a drain, as SET_INFLIGHT_WINDOW) and
            # RING_SLOTS its command-ring slot budget; class, weight and
            # rate are the arbiter's, mirrored here
            if not tenant_config_valid(fn, val):
                return ErrorCode.CONFIG_ERROR
            key = int(options.cfg_key)
            if fn == ConfigFunction.SET_TENANT_WINDOW_SHARE:
                if not self.gang.window.drain(
                        drain_deadline_s(self.gang.timeout_s)):
                    return ErrorCode.RECEIVE_TIMEOUT
                self.gang.window.set_key_depth(key, int(val))
            elif fn == ConfigFunction.SET_TENANT_RING_SLOTS:
                self.gang.cmdring.set_slot_budget(key, int(val))
            self.tenants.setdefault(key, {})[tenant_config_field(fn)] = val
        return ErrorCode.OK

    def create_buffer(self, count: int, dtype, data=None,
                      host_only: bool = False):
        return make_buffer(self.device, count, dtype, data=data,
                           host_only=host_only)

    def device_interactions(self) -> int:
        return self.gang.interactions.read()

    # -- the telemetry and monitor planes ------------------------------------
    def contract_anchor(self):
        """The gang context: every rank handle of the group shares it, so
        their skew trackers meet on one judge (``monitor.judge_for``)."""
        return self.gang

    def skew_exchange_mode(self) -> str:
        return "board"

    # -- the contract, membership and postmortem planes ---------------------
    def set_contract_verifier(self, verifier) -> None:
        """A verdict must fail the gang's PARKED slots too: the detecting
        rank raises before dispatch, so its peers' calls would otherwise
        starve their slot until the watchdog."""
        self.contract_verifier = verifier
        if verifier is not None:
            verifier.add_verdict_listener(self.gang.contract_fail)

    def set_membership(self, view) -> None:
        """Arm (or with None disarm) the membership plane: the gang's
        health transitions forward to the facade's hook.  Disarming
        removes the forwarder from the shared gang."""
        self.membership = view
        fwd = self._mbr_fwd
        if view is None:
            if fwd is not None:
                self.gang.remove_health_listener(fwd)
                self._mbr_fwd = None
            return
        if fwd is None:
            def fwd(session, old, new, eng=self):
                hook = eng.on_health_transition
                if hook is not None:
                    hook(session, old, new)

            self._mbr_fwd = fwd
            self.gang.add_health_listener(fwd)

    def on_membership_cutover(self, plan: dict, addresses: tuple = (),
                              comm_ids: tuple = ()) -> None:
        """After a shrink or grow: drop the health entries of the evicted
        and admitted sessions, clear the survivors' suspect strikes, and
        halt the command ring's runs and sessions (they re-arm over the
        new membership at the next window)."""
        for s in tuple(plan.get("evict", ())) + tuple(plan.get("admit", ())):
            self.gang.health.pop(s, None)
        for h in list(self.gang.health.values()):
            if h["state"] == "suspect":
                h["state"] = "ok"
                h["timeouts"] = 0
        self.gang.cmdring.reset()

    def drain_inflight(self, timeout=None) -> bool:
        """A drain point (``flush()``, a cutover): the in-flight window
        until every parked call completed, then the command ring's windows
        in flight, bounded together by ``timeout`` (default
        ``drain_deadline_s`` of the gang's timeout).  False when the bound
        ran out first."""
        if timeout is None:
            timeout = drain_deadline_s(self.gang.timeout_s)
        end = time.monotonic() + timeout
        ok = self.gang.window.drain(timeout)
        return self.gang.cmdring.wait_in_flight(end) and ok

    def health_report(self, comm: Communicator) -> Dict[int, dict]:
        """Per-peer health from the gang's watchdog, keyed by
        comm-relative rank."""
        report: Dict[int, dict] = {}
        for i, r in enumerate(comm.ranks):
            if i == comm.local_rank:
                continue
            h = self.gang.health.get(r.session)
            report[i] = dict(h) if h else {
                "state": "ok", "timeouts": 0, "failures": 0,
                "last_event": ""}
        return report

    def dump_rx_buffers(self) -> str:
        """The gang's live rendezvous state, in the JAX gang's ``rxbuf``
        lines: parked gang slots, unmatched p2p posts and undrained
        stream ports (a clean engine prints no ``rxbuf`` line)."""
        lines = ["CUDA gang rx state "
                 f"(device={self.device}, "
                 f"device_interactions={self.gang.interactions.read()}):"]
        lines += self.gang.dump_state()
        lines += self.gang.p2p.dump_parked()
        with self._stream_cv:
            for sid, chunks in sorted(self._streams.items()):
                if chunks:
                    lines.append(f"rxbuf stream-port {sid} "
                                 f"depth={len(chunks)} UNDRAINED")
        if len(lines) == 1:
            lines.append("all slots IDLE")
        return "\n".join(lines)

    def telemetry_report(self) -> dict:
        """The gang tier's counters for the telemetry snapshot, under the
        JAX gang's keys: pending rendezvous slots, the register epoch,
        parked p2p posts, undrained stream ports, the in-flight window's
        ``stats()`` (``inflight``), the command ring's ``stats()`` (its
        window log, breakers, chaos counts and slot budgets included) and
        this handle's mirror of its tenant writes (``tenants``).
        ``faults`` is None, as the JAX gang reports it (the injector
        reaches the gang through ``contract.install_fault_plan``)."""
        with self.gang._lock:
            pending_slots = len(self.gang._slots)
        with self._stream_cv:
            stream_depths = {sid: len(chunks)
                             for sid, chunks in sorted(self._streams.items())
                             if chunks}
        return {
            "device_interactions": self.gang.interactions.read(),
            "gang_pending_slots": pending_slots,
            "gang_tuning_epoch": self.gang.tuning_epoch,
            "p2p_parked": sum(self.gang.p2p.parked().values()),
            "stream_depths": stream_depths,
            "inflight": self.gang.window.stats(),
            "cmdring": self.gang.cmdring.stats(),
            "tenants": {str(k): dict(v)
                        for k, v in sorted(self.tenants.items())},
            "faults": None,
            "skew_exchange": "board",
        }

    def trace_events(self) -> list:
        """The command ring's window and slot spans (every rank handle
        shares the gang, so every rank's export embeds the same rows;
        ``merge_traces`` keeps one copy, cat ``cmdring``)."""
        return self.gang.cmdring.trace_events()

    def drain_windows(self) -> None:
        """A facade drain point: wait for the gang's command-ring windows
        not yet drained."""
        self.gang.cmdring.drain(self.session)

    def shutdown(self) -> None:
        """Cancel this rank's parked sends and recvs (their watchdogs stop
        and their requests fail), and halt and join every command-ring run
        (no thread or kernel outlives the engine); the last engine of the
        gang stops the slot watchdog and the in-flight window (drained,
        bounded, its drainers joined; a later park completes on the
        launching thread)."""
        self.gang.p2p.cancel(self.session)
        self.gang.live.discard(self.session)
        last = not self.gang.live
        if last:  # the runs finish what the window waits on first
            self.gang.window.stop(drain_deadline_s(self.gang.timeout_s))
        self.gang.cmdring.halt_sessions()
        if last:
            self.gang.watchdog.stop()
