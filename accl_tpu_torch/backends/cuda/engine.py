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
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ...buffer import DeviceBuffer, make_buffer
from ...communicator import Communicator
from ...constants import (
    ALGORITHM_TUNING_KEYS,
    AllreduceAlgorithm,
    CompressionFlags,
    ConfigFunction,
    DataType,
    ErrorCode,
    Operation,
    ROOTED_ALGORITHMS,
    TUNING_DEFAULTS,
    TuningKey,
    WIRE_LANE_DTYPES,
    dtype_to_torch,
)
from ...ops import driver as opdriver
from ...ops.cuda.combine import combine as kernel_combine
from ...ops.wire import wire_lane_roundtrip
from ...request import Request
from ..base import BaseEngine, CallOptions


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
        if int(val) != 0 and int(val) not in WIRE_LANE_DTYPES:
            return ErrorCode.CONFIG_ERROR
        tuning["wire_dtype"] = int(val)
    else:
        return ErrorCode.CONFIG_ERROR  # a register this engine does not serve
    return ErrorCode.OK


def run_allreduce_with_tuning(xs, mesh, fn, wire: Optional[DataType],
                              tuning: dict, out=None):
    """Allreduce with algorithm, segmentation and wire lane from the
    tuning registers."""
    algo = tuning.get("allreduce_algorithm", "xla")
    nseg = int(tuning.get("ring_segments", 1))
    bidir = algo == "pallas_ring_bidir"
    pallas = algo in ("pallas_ring", "pallas_ring_bidir")
    if wire is not None:
        wire_name = wire.name.lower()
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
    """Shared per-process rendezvous point of every rank handle."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: Dict[tuple, Dict[int, Tuple[CallOptions, Request]]] = {}
        self._seq: Dict[Tuple[int, int], int] = {}
        self.tuning = dict(TUNING_DEFAULTS)

    def submit(self, comm: Communicator, options: CallOptions,
               request: Request) -> None:
        with self._lock:
            seq_key = (comm.id, comm.local_rank)
            seq = self._seq.get(seq_key, 0)
            self._seq[seq_key] = seq + 1
            slot_key = (comm.id, seq)
            slot = self._slots.setdefault(slot_key, {})
            slot[comm.local_rank] = (options, request)
            ready = len(slot) == comm.size
            if ready:
                del self._slots[slot_key]
        if ready:
            self._execute(comm, slot)

    @staticmethod
    def _sig(c: CallOptions) -> tuple:
        return (c.op, c.count, c.reduce_function, c.root_src, c.root_dst,
                c.compression)

    def _execute(self, comm: Communicator, slot) -> None:
        calls = [slot[r][0] for r in range(comm.size)]
        reqs = [slot[r][1] for r in range(comm.size)]
        lead = calls[0]
        t0 = time.perf_counter_ns()
        event, context = None, None
        try:
            if any(self._sig(c) != self._sig(lead) for c in calls[1:]):
                code = ErrorCode.INVALID_OPERATION  # mismatched gang calls
                context = {"op": lead.op.name, "error": "mismatched calls"}
            else:
                code, event = self._run_op(comm, calls, lead)
        except Exception as e:  # the gang boundary: fail every rank's call
            code = ErrorCode.INVALID_OPERATION
            context = {"op": lead.op.name,
                       "error": f"{type(e).__name__}: {e}"[:300]}
        dt = time.perf_counter_ns() - t0
        for req in reqs:
            req.complete(code, dt, context=context, event=event)

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
                xs = [x if x is None
                      else wire_lane_roundtrip(x, dtype_to_torch(wire))
                      for x in xs]
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
        return req

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
