"""The gang engine: the facade over P ranks whose buffers share one device.

The counterpart of ``accl_tpu/backends/xla/engine.py``.  Rank handles
submit their calls into a shared :class:`CudaGangContext`; when every rank
of a communicator has posted the matching call, the LAST arriving rank's
thread runs the collective once for all of them through ``ops.driver``
(on the card: a hand-written kernel or plain PyTorch, by the tuning
registers) and completes every rank's request.

Streams: the collective launches on the executing thread's current
stream, after that stream waits on every operand's last-writer event; it
then records one event, which every rank's request and result buffer
carry, so a waiter synchronises on that event and not on the device.

Batches: a flushed ``with accl.batch():`` run arrives as one gang event
(``submit_batch``); the command ring (``cmdring.GangCommandRing``) runs it
as windows of one sequencer launch each, or refuses it with a counted
reason, and then each position runs in order through the per-call path.

Point-to-point: a send and a recv meet in the gang's tag-matched
:class:`P2PChannel`; the send posts a fresh device copy of its operand
(narrowed to the wire dtype by row 5 when compressed), and the match
copies it into the receiver's buffer (widened by row 5).  Every rank
shares the device, so the hop is a device copy; a hop between two
devices is not ported (ROADMAP B14 / A6) and fails the pair.  The stream
ports hold host bytes, as in the JAX package (:class:`StreamPortMixin`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ...arithconfig import reduce_op
from ...buffer import DeviceBuffer, DummyBuffer, make_buffer
from ...cmdring import ring_widths
from ...communicator import Communicator
from ...constants import (
    ALGORITHM_TUNING_KEYS,
    AllreduceAlgorithm,
    CompressionFlags,
    ConfigFunction,
    DataType,
    DEFAULT_TIMEOUT_S,
    ErrorCode,
    FusedCompute,
    Operation,
    ROOTED_ALGORITHMS,
    StreamFlags,
    TUNING_DEFAULTS,
    TuningKey,
    WIRE_LANE_DTYPES,
    drain_deadline_s,
    dtype_to_torch,
)
from ...ops import driver as opdriver
from ...ops.cuda.combine import combine as kernel_combine
from ...ops.wire import wire_lane_roundtrip_rows
from ...wire import is_wire_dtype
from ...request import Request
from ..base import (
    BaseEngine,
    CallOptions,
    StreamPortMixin,
    convert,
    tensor_bytes,
)
from .cmdring import GangCommandRing


def apply_tuning(tuning: dict, options: CallOptions) -> ErrorCode:
    """Validate and apply one SET_TUNING register write."""
    try:
        key = TuningKey(int(options.cfg_key))
    except ValueError:
        return ErrorCode.CONFIG_ERROR
    val = options.cfg_value
    if val < 0:
        return ErrorCode.CONFIG_ERROR
    if key in ALGORITHM_TUNING_KEYS:
        try:
            algo = AllreduceAlgorithm(int(val))
        except ValueError:
            return ErrorCode.CONFIG_ERROR
        if (key != TuningKey.ALLREDUCE_ALGORITHM
                and algo not in ROOTED_ALGORITHMS):
            return ErrorCode.CONFIG_ERROR  # no ring form of a rooted op
        tuning[key.name.lower()] = algo.name.lower()
    elif key == TuningKey.RING_SEGMENTS:
        if int(val) < 1:
            return ErrorCode.CONFIG_ERROR
        tuning["ring_segments"] = int(val)
    elif key == TuningKey.WIRE_DTYPE:
        if int(val) != 0 and not is_wire_dtype(int(val)):
            return ErrorCode.CONFIG_ERROR
        tuning["wire_dtype"] = int(val)
    else:
        return ErrorCode.CONFIG_ERROR  # a register this engine does not serve
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
    """An event on the current stream of ``device`` (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
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
    if not isinstance(buf, DeviceBuffer):
        raise ValueError(f"{what}: not a device buffer")
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


def p2p_device_deliver(payload: Payload, res, count: int):
    """Copy a matched send's payload into the receiver's buffer and return
    the event recorded after it (the counterpart of the JAX engine's
    ``_p2p_device_deliver``).  Every rank shares one device, so this is
    JAX's self-device branch, a device copy; host bytes from a stream
    port cross to the device first.  A compressed payload widens to the
    buffer's dtype by row 5 on the receiving side.  Raises on a payload
    that does not fit, and on a hop between two devices, which the port
    does not have yet (ROADMAP B14 / A6)."""
    t = payload.tensor
    if t.dim() != 1 or t.numel() < count:
        raise ValueError(
            f"p2p payload of shape {tuple(t.shape)} into count {count}")
    if not isinstance(res, DeviceBuffer) or res.count < count:
        raise ValueError(f"p2p result buffer too small for {count} elements")
    dst = res.tensor[:count]
    if t.device != dst.device:
        if t.device.type != "cpu":
            raise NotImplementedError(
                f"a p2p hop from {t.device} to {dst.device}: transfers "
                "between devices are not ported (ROADMAP B14 / A6)")
        t = t.to(dst.device)
    src = t[:count]
    payload.wait(dst.device)
    _wait_operands(dst.device, [res])
    convert(src, dst.dtype, out=dst)  # row 5 widens a compressed payload
    event = _record_event(dst.device)
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


class CudaGangContext:
    """Shared per-process rendezvous point of every rank handle; every
    rank's buffers lie on ``device``."""

    def __init__(self, device=None):
        self._lock = threading.Lock()
        self._slots: Dict[tuple, Dict[int, tuple]] = {}
        self._seq: Dict[Tuple[int, int], int] = {}
        self.tuning = dict(TUNING_DEFAULTS)
        self.device = torch.device("cpu" if device is None else device)
        self.cmdring = GangCommandRing(self)
        # point-to-point: the tag-matched channel, and each rank's engine
        # by session (the destination of a stream_put)
        self.p2p = P2PChannel()
        self.peers: Dict[int, "CudaEngine"] = {}

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
            seq_key = (comm.id, comm.local_rank)
            seq = self._seq.get(seq_key, 0)
            self._seq[seq_key] = seq + 1
            slot_key = (comm.id, seq)
            slot = self._slots.setdefault(slot_key, {})
            slot[comm.local_rank] = entry
            ready = len(slot) == comm.size
            if ready:
                del self._slots[slot_key]
        if ready:
            self._execute(comm, slot)

    @staticmethod
    def _sig(c: CallOptions) -> tuple:
        return (c.op, c.count, c.reduce_function, c.root_src, c.root_dst,
                c.compression, c.fuse, c.fuse_param)

    def _execute(self, comm: Communicator, slot) -> None:
        entries = [slot[r] for r in range(comm.size)]
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
        try:
            if any(self._sig(c) != self._sig(lead) for c in calls[1:]):
                code = ErrorCode.INVALID_OPERATION  # mismatched gang calls
                context = {"op": lead.op.name, "error": "mismatched calls"}
            elif lead.fuse:
                # a fused call off the ring: its operand is packed for the
                # slot, so the plain base op has no correct spelling
                code, event = self._execute_fused_decomposed(comm, calls)
            elif (self.cmdring.eager and self.cmdring.supports(lead.op)
                  and self.cmdring.run_batch(
                      comm, [([c], [q]) for c, q in zip(calls, reqs)], 1,
                      t0=t0)):
                return  # a one-slot window: the ring completed the calls
            else:
                code, event = self._run_op(comm, calls, lead)
        except Exception as e:  # the gang boundary: fail every rank's call
            code = ErrorCode.INVALID_OPERATION
            context = {"op": lead.op.name,
                       "error": f"{type(e).__name__}: {e}"[:300]}
        dt = time.perf_counter_ns() - t0
        for req in reqs:
            req.complete(code, dt, context=context, event=event)

    def _execute_batch(self, comm: Communicator, entries: List[tuple]) -> None:
        """A fully matched batch: ``entries[r]`` is rank r's
        ``(options_list, requests_list)``.  The command ring first; else
        every position in order through the per-call path."""
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
        if handled:
            return
        for i in range(npos):
            self._execute_calls(comm, [e[0][i] for e in entries],
                                [e[1][i] for e in entries])

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
            rows.append(c.op0.tensor[:in_w])
        self.cmdring.note_fallback("fused_decomposed")
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
            "op": op, "n": n, "dtype": dtype_to_torch(dtype),
            "compressed": compressed,
            "wire": (dtype_to_torch(lead.arithcfg.compressed)
                     if compressed else None),
            "writers": writers,
        }

    def _run_op(self, comm: Communicator, calls: List[CallOptions],
                lead: CallOptions):
        op = lead.op
        if op == Operation.BARRIER:
            # gang assembly IS the barrier: every rank posted the call
            return ErrorCode.OK, None
        if op not in IN_W:
            return ErrorCode.COLLECTIVE_NOT_IMPLEMENTED, None
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
        if op == Operation.ALLREDUCE:
            # the wire lane runs inside the allreduce (one rounding)
            run_allreduce_with_tuning(xs, mesh, fn, wire, self.tuning,
                                      out=outs)
        else:
            if wire is not None:
                # each contribution rounded once through the wire, every
                # rank's row in one launch per kernel; deterministic, as
                # the JAX gang's in-program lane (its per-call seeds are
                # read by the facade's error feedback, not here)
                live = [r for r, x in enumerate(xs) if x is not None]
                rounded = wire_lane_roundtrip_rows([xs[r] for r in live],
                                                   wire)
                for r, x in zip(live, rounded):
                    xs[r] = x
            if op == Operation.SCATTER:
                xs = [xs[root]] * size  # only the root's operand is read
            if op in ROOTED_OPS:
                run_rooted_with_tuning(op, xs, mesh, lead, self.tuning,
                                       out=outs)
            elif op == Operation.ALLGATHER:
                opdriver.run_allgather(xs, mesh, out=outs)
            elif op == Operation.ALLTOALL:
                opdriver.run_alltoall(xs, mesh, out=outs)
            else:
                opdriver.run_reduce_scatter(xs, mesh, fn, out=outs)
        event = _record_event(device)
        for r in writers:
            calls[r].res.ready = event
        return ErrorCode.OK, event


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
        gang.peers[self.session] = self
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
            if ((options.op in IN_W or options.op == Operation.BARRIER)
                    and options.stream == StreamFlags.NO_STREAM):
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
        t0 = time.perf_counter_ns()
        try:
            code, event = self._local_op(options)
        except Exception as e:
            req.complete(ErrorCode.INVALID_OPERATION, context={
                "op": options.op.name,
                "error": f"{type(e).__name__}: {e}"[:300],
            })
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
            def sink(payload):
                return p2p_device_deliver(payload, options.res,
                                          options.count)
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
            if not isinstance(res, DeviceBuffer) or res.count < n:
                raise ValueError(f"result buffer too small for {n} elements")
            waits.append(res)
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
        if combine:
            other = _check(options.op1, n, dtype, "second operand")
            # K4: op(a, b) cast to the result buffer's dtype, in place
            # when the result is the first operand
            kernel_combine(src, other, options.reduce_function,
                           dst.dtype, out=dst)
        else:
            convert(src, dst.dtype, out=dst)  # row 5 between wire dtypes
        event = _record_event(dst.device)
        res.ready = event
        return ErrorCode.OK, event

    def _apply_config(self, options: CallOptions) -> ErrorCode:
        fn = ConfigFunction(options.cfg_function)
        if fn == ConfigFunction.SET_TIMEOUT:
            # the deadline of parked sends and recvs and of stream pops
            if options.cfg_value <= 0:
                return ErrorCode.CONFIG_ERROR
            self.timeout_s = float(options.cfg_value)
        elif fn == ConfigFunction.SET_TUNING:
            return apply_tuning(self.gang.tuning, options)
        return ErrorCode.OK

    def create_buffer(self, count: int, dtype, data=None) -> DeviceBuffer:
        return make_buffer(self.device, count, dtype, data=data)

    def shutdown(self) -> None:
        """Cancel this rank's parked sends and recvs (their watchdogs stop
        and their requests fail); the gang itself runs on its callers'
        threads and has nothing to stop."""
        self.gang.p2p.cancel(self.session)
