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
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ...arithconfig import reduce_op
from ...buffer import DeviceBuffer, make_buffer
from ...cmdring import ring_widths
from ...communicator import Communicator
from ...constants import (
    ALGORITHM_TUNING_KEYS,
    AllreduceAlgorithm,
    CompressionFlags,
    ConfigFunction,
    DataType,
    ErrorCode,
    FusedCompute,
    Operation,
    ROOTED_ALGORITHMS,
    TUNING_DEFAULTS,
    TuningKey,
    WIRE_LANE_DTYPES,
    dtype_to_torch,
)
from ...ops import driver as opdriver
from ...ops.cuda.combine import combine as kernel_combine
from ...ops.wire import wire_lane_roundtrip_rows
from ...wire import is_wire_dtype
from ...request import Request
from ..base import BaseEngine, CallOptions
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


class CudaEngine(BaseEngine):
    """One rank handle's engine over a shared gang context.  Local ops
    (copy / combine) run at once on the caller's thread; collectives
    rendezvous at the gang."""

    def __init__(self, gang: CudaGangContext, device):
        self.gang = gang
        self.device = torch.device(device)

    def start(self, options: CallOptions) -> Request:
        req = Request(op_name=options.op.name)
        req.mark_executing()
        self._start_with(options, req)
        return req

    def start_batch(self, items) -> None:
        """Dispatch a flushed batch.  Maximal runs of gang collectives on
        one communicator submit as ONE gang batch event; local ops and
        config calls break the run and run on their own, in issue order."""
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
            if options.op in IN_W or options.op == Operation.BARRIER:
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
            t0 = time.perf_counter_ns()
            try:
                event = self._local_op(options)
                req.complete(ErrorCode.OK, time.perf_counter_ns() - t0,
                             event=event)
            except Exception as e:
                req.complete(ErrorCode.INVALID_OPERATION, context={
                    "op": op.name, "error": f"{type(e).__name__}: {e}"[:300],
                })
        else:
            self.gang.submit(options.comm, options, req)

    def _local_op(self, options: CallOptions):
        n = options.count
        dtype = options.arithcfg.uncompressed
        src = _check(options.op0, n, dtype, "operand")
        res = options.res
        if not isinstance(res, DeviceBuffer) or res.count < n:
            raise ValueError(f"result buffer too small for {n} elements")
        dst = res.tensor[:n]
        _wait_operands(src.device, [options.op0, options.op1, res])
        if options.op == Operation.COMBINE:
            other = _check(options.op1, n, dtype, "second operand")
            # K4: op(a, b) cast to the result buffer's dtype, in place
            # when the result is the first operand
            kernel_combine(src, other, options.reduce_function,
                           dst.dtype, out=dst)
        else:
            dst.copy_(src)
        event = _record_event(dst.device)
        res.ready = event
        return event

    def _apply_config(self, options: CallOptions) -> ErrorCode:
        fn = ConfigFunction(options.cfg_function)
        if fn == ConfigFunction.SET_TIMEOUT:
            # the facade waits with the timeout; the engine validates it
            if options.cfg_value <= 0:
                return ErrorCode.CONFIG_ERROR
        elif fn == ConfigFunction.SET_TUNING:
            return apply_tuning(self.gang.tuning, options)
        return ErrorCode.OK

    def create_buffer(self, count: int, dtype, data=None) -> DeviceBuffer:
        return make_buffer(self.device, count, dtype, data=data)

    def shutdown(self) -> None:
        """Nothing to stop: the gang runs on its callers' threads."""
