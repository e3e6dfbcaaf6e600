"""The ACCL facade: the user-facing MPI-like API over the gang engine.

The counterpart of ``accl_tpu/core.py``'s ``ACCL`` (:72) for the calls of
this port: buffers, tuning registers, copy / combine, the rooted bcast,
reduce, scatter and gather, allgather, allreduce (with a wire dtype and
``run_async``), reduce_scatter, alltoall, barrier and the fused compute
slots (``fused_matmul_reduce_scatter``, ``fused_apply``,
``fused_attn_hop``), point-to-point ``send`` / ``recv`` (tag-matched,
with the cast wire lanes), the stream ports (``stream_push`` /
``stream_pop``, ``stream_put`` into a peer's port, ``copy_from_stream``
/ ``copy_to_stream`` / ``copy_from_to_stream`` and ``reduce`` with
stream operands).  Compressed collectives take any registered wire
lane (float16, bfloat16, fp8 e4m3 / e5m2, int8), by ``compress_dtype``
or the ``wire_dtype`` register, and the allreduce error feedback
(:meth:`ACCL.set_error_feedback`).  Calls are synchronous unless
``run_async=True``, which returns the
:class:`~accl_tpu_torch.request.Request`.  Inside
``with accl.batch():`` calls queue and dispatch together at the end (or
when a queued request is waited on): the gang runs the batch as command-
ring windows, one sequencer launch each.  A rank that contributes or
takes no data in a rooted call passes None, which becomes a
:class:`~accl_tpu_torch.buffer.DummyBuffer`, as in the JAX facade.

:func:`cuda_group` builds N rank handles over one device — the
counterpart of ``core.xla_group``.  Collectives are blocking per rank:
drive each rank from its own thread, or use ``run_async=True``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from . import wire as _wire
from .arithconfig import DEFAULT_ARITH_CONFIG
from .backends.base import BaseEngine, CallOptions, tensor_bytes
from .backends.cuda.engine import CudaEngine, CudaGangContext
from .buffer import BaseBuffer, DeviceBuffer, DummyBuffer, host_tensor
from .communicator import Communicator, Rank
from .constants import (
    ACCLError,
    AllreduceAlgorithm,
    CompressionFlags,
    ConfigFunction,
    DataType,
    DEFAULT_TIMEOUT_S,
    ErrorCode,
    FusedCompute,
    Operation,
    ReduceFunction,
    StreamFlags,
    TuningKey,
    as_datatype,
    drain_deadline_s,
    dtype_to_numpy,
)
from .errorfeedback import ResidualStore
from .ops.driver import resolve_device
from .request import CommandQueue, Request

#: the collectives whose compressed calls take a per-call stochastic-
#: rounding seed (the JAX facade derives one for these three)
_SEEDED_OPS = (Operation.ALLREDUCE, Operation.REDUCE,
               Operation.REDUCE_SCATTER)


def _wire_dtype_value(name: str) -> int:
    """The ``wire_dtype`` register's value for a name: "off" (0), a
    DataType name (``FLOAT8_E4M3``) or a dtype name (``float8_e4m3fn``)."""
    if name.lower() in ("off", "none"):
        return 0
    if name.upper() in DataType.__members__:
        return int(DataType[name.upper()])
    return int(as_datatype(name))


class ACCL:
    """One rank's handle onto the collective engine."""

    def __init__(
        self,
        engine: BaseEngine,
        ranks: Sequence[Rank],
        local_rank: int,
        arith_config: Optional[dict] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ):
        self.engine = engine
        self._arith = dict(arith_config or DEFAULT_ARITH_CONFIG)
        self._world = Communicator(ranks, local_rank, comm_id=0)
        self._timeout_s = float(timeout_s)
        # the open batch (None outside one); nested batch() contexts only
        # count depth
        self._pending: Optional[CommandQueue] = None
        self._batch_depth = 0
        # the quantized wire: per-comm stochastic-rounding call counters
        # (SPMD-uniform: every rank issues the same compressed calls, so
        # the derived seeds match) and the error-feedback residuals,
        # opt-in (ACCL_ERROR_FEEDBACK=1 or set_error_feedback)
        self._wire_ctr: dict = {}
        self._residuals = ResidualStore()
        self._error_feedback = (
            os.environ.get("ACCL_ERROR_FEEDBACK", "0") == "1")
        self._config(ConfigFunction.SET_TIMEOUT, timeout_s)
        self._initialized = True

    def _config(self, fn: ConfigFunction, value: float, key: int = 0) -> None:
        req = self.engine.start(CallOptions(
            op=Operation.CONFIG, cfg_function=int(fn), cfg_value=value,
            cfg_key=int(key),
        ))
        req.check(f"config {fn.name}")

    # -- introspection -------------------------------------------------------
    @property
    def comm(self) -> Communicator:
        return self._world

    @property
    def rank(self) -> int:
        return self._world.local_rank

    @property
    def size(self) -> int:
        return self._world.size

    def set_timeout(self, seconds: float) -> None:
        self._config(ConfigFunction.SET_TIMEOUT, seconds)
        self._timeout_s = float(seconds)

    def set_tuning(self, key, value) -> None:
        """Write a tuning register: ``allreduce_algorithm`` ("xla" /
        "ring" / "pallas_ring" / "pallas_ring_bidir"), the rooted
        ``bcast_algorithm`` / ``reduce_algorithm`` / ``scatter_algorithm``
        / ``gather_algorithm`` ("xla" / "pallas_ring"), ``ring_segments``
        or ``wire_dtype`` (a DataType value or name, a dtype name, or
        "off" / 0).  ``key`` is
        a :class:`TuningKey`, its name, or its int value."""
        if isinstance(key, str):
            try:
                key = TuningKey[key.upper()]
            except KeyError:
                raise ValueError(f"unknown tuning key {key!r}") from None
        else:
            key = TuningKey(key)
        if isinstance(value, str):
            if key == TuningKey.WIRE_DTYPE:
                value = _wire_dtype_value(value)
            else:
                try:
                    value = AllreduceAlgorithm[value.upper()]
                except KeyError:
                    raise ValueError(
                        f"unknown algorithm {value!r}; valid: "
                        f"{[a.name.lower() for a in AllreduceAlgorithm]}"
                    ) from None
        self._config(ConfigFunction.SET_TUNING, float(value), key=int(key))
        # a register write may change the wire a residual was kept for
        self._residuals.invalidate("set_tuning")

    # -- the quantized wire --------------------------------------------------
    @property
    def sr_calls(self) -> int:
        """Compressed calls that drew a stochastic-rounding seed."""
        return sum(self._wire_ctr.values())

    @property
    def residuals(self) -> ResidualStore:
        """The error-feedback residual store (``stats()`` reports it)."""
        return self._residuals

    def _derive_wire_seed(self, comm: Communicator, op: Operation,
                          wire: Optional[DataType]) -> int:
        """The per-call stochastic-rounding seed of a compressed
        collective (0 for the f16 / bf16 lanes and uncompressed calls):
        from the comm id, its epoch and a per-comm counter every rank
        advances for the same calls, so every rank holds the same seed;
        each rank mixes its own rank in where it rounds
        (``wire.rank_seed``)."""
        if wire is None or op not in _SEEDED_OPS or not _wire.is_stochastic(
                wire):
            return 0
        ctr = self._wire_ctr.get(comm.id, 0)
        self._wire_ctr[comm.id] = ctr + 1
        return _wire.call_seed(comm.id, comm.epoch, ctr, int(wire))

    def set_error_feedback(self, enabled: bool = True) -> None:
        """Arm (or disarm) error feedback for the compressed allreduce on
        this handle: each contribution carries the previous call's
        compression residual (``compress(grad + residual)``, ``residual
        = grad_eff - decompress(wire)``).  Collective by contract: every
        rank arms it at the same point.  Also armed by
        ``ACCL_ERROR_FEEDBACK=1`` at handle construction."""
        was = self._error_feedback
        self._error_feedback = bool(enabled)
        if was and not enabled:
            self._residuals.invalidate("error_feedback_off")

    def _error_feedback_operand(self, comm: Communicator,
                                sendbuf: BaseBuffer, n: int,
                                function: ReduceFunction,
                                wire: Optional[DataType],
                                seed: int) -> Optional[DeviceBuffer]:
        """A staging buffer holding ``grad + residual`` for one allreduce
        contribution, or None when error feedback does not apply (not
        armed, no wire, or not SUM).  The residual is keyed as the JAX
        facade keys it — (comm, epoch, op, count, segment position, link
        class) — with the port's segment 0 and no link class (-1); the
        roundtrip uses this rank's mixed seed."""
        if (not self._error_feedback or wire is None
                or function != ReduceFunction.SUM):
            return None
        key = (comm.id, comm.epoch, Operation.ALLREDUCE, n, 0, -1)
        x = sendbuf.tensor[:n]
        if sendbuf.ready is not None:
            torch.cuda.current_stream(x.device).wait_event(sendbuf.ready)
        x_eff = self._residuals.apply(
            key, _wire.widen(x), wire, _wire.rank_seed(seed, comm.local_rank))
        staged = _wire.astype(x_eff, x.dtype)
        buf = DeviceBuffer(n, sendbuf.dtype, x.device, tensor=staged,
                           host=staged.new_zeros((), device="cpu").expand(n))
        if x.device.type == "cuda":
            buf.ready = torch.cuda.Event()
            buf.ready.record(torch.cuda.current_stream(x.device))
        return buf

    # -- buffers -------------------------------------------------------------
    def create_buffer(self, count: int, dtype) -> BaseBuffer:
        """A zeroed buffer of ``count`` elements on this rank's device."""
        return self.engine.create_buffer(count, as_datatype(dtype))

    def create_buffer_from(self, array) -> BaseBuffer:
        """Wrap a host array (numpy or a CPU tensor, flattened): the
        buffer's host side ALIASES it when it is contiguous, and the device
        side is synced on return."""
        host = host_tensor(array)
        return self.engine.create_buffer(
            host.numel(), as_datatype(host.dtype), data=host
        )

    # -- call plumbing -------------------------------------------------------
    def _resolve_arithcfg(self, dtype: DataType, compress_dtype) -> tuple:
        cdt = dtype if compress_dtype is None else as_datatype(compress_dtype)
        key = (dtype, cdt)
        if key not in self._arith:
            raise ACCLError(
                ErrorCode.INVALID_DTYPE,
                f"no arithmetic config for {dtype.name}->{cdt.name}",
                details={"available": sorted(
                    f"{u.name}->{c.name}" for u, c in self._arith
                )},
            )
        flags = (CompressionFlags.ETH_COMPRESSED if cdt != dtype
                 else CompressionFlags.NO_COMPRESSION)
        return self._arith[key], flags

    def _advance_wire_seed(self, comm: Communicator, op: Operation,
                           dtype: DataType, compress_dtype) -> None:
        """Draw the call's seed for a compressed reduce or reduce-scatter:
        the gang rounds those deterministically, but the per-comm counter
        advances as on every rank of the JAX facade, so later seeds
        match it."""
        cfg, flags = self._resolve_arithcfg(dtype, compress_dtype)
        self._derive_wire_seed(comm, op, cfg.compressed if flags else None)

    # -- batched dispatch (the command ring) --------------------------------
    def begin_batch(self) -> None:
        """Open a batch: later calls queue instead of dispatching until
        :meth:`flush` (explicit, or on waiting for a queued request, a
        synchronous call, or :meth:`end_batch`).  The gang runs a flushed
        batch of collectives as command-ring windows, one sequencer launch
        per window.  Collective by contract: every rank of the
        communicator opens and flushes its batches at the same points."""
        self._batch_depth += 1
        if self._pending is None:
            self._pending = CommandQueue()

    def flush(self) -> None:
        """Dispatch everything queued in the open batch; the batch stays
        open.  When it returns, every call of the batch that has been
        launched has finished on the device (a call whose peers have not
        flushed yet is not launched)."""
        for req in self._dispatch_pending():
            if req.done() and req.event is not None:
                req.event.synchronize()

    def _dispatch_pending(self) -> list:
        """Dispatch the open batch without waiting (the hook behind
        ``Request.wait`` / ``test`` on a queued call); returns its
        requests."""
        q = self._pending
        items = q.drain() if q is not None else []
        if items:
            for _, req in items:
                req._pre_wait = None  # dispatched: a later wait must not
                # flush whatever unrelated batch is open then
            self.engine.start_batch(items)
        return [req for _, req in items]

    def end_batch(self) -> None:
        """Close the outermost batch: flush and return to immediate
        dispatch (an inner ``batch()`` only decrements the depth)."""
        if self._batch_depth > 1:
            self._batch_depth -= 1
            return
        self._batch_depth = 0
        self.flush()
        self._pending = None

    def batch(self):
        """Context manager form::

            with accl.batch():
                accl.allreduce(a, b, n, run_async=True)
                accl.allgather(c, d, n, run_async=True)
            # the exit flushes: both ride one command-ring window
        """
        import contextlib

        @contextlib.contextmanager
        def _cm():
            self.begin_batch()
            try:
                yield self
            finally:
                self.end_batch()

        return _cm()

    def _launch(self, options: CallOptions, run_async: bool,
                context: str) -> Request:
        if self._pending is not None:
            req = Request(op_name=options.op.name)
            req._pre_wait = self._dispatch_pending  # dispatch on wait
            self._pending.push((options, req))
            if run_async:
                return req
            # a synchronous call inside a batch dispatches the whole run
            self._dispatch_pending()
        else:
            req = self.engine.start(options)
        if run_async:
            return req
        deadline = drain_deadline_s(self._timeout_s)
        if not req.wait(timeout=deadline):
            raise ACCLError(
                ErrorCode.DEADLOCK_SUSPECTED, context,
                details={"op": options.op.name, "timeout_s": deadline},
            )
        req.check(context)
        return req

    @staticmethod
    def _count_of(buf: BaseBuffer, count: Optional[int]) -> int:
        n = buf.count if count is None else int(count)
        if n < 0:
            raise ACCLError(ErrorCode.INVALID_COUNT, f"count {n}")
        return n

    def _check_rank(self, comm: Communicator, rank: int) -> None:
        if not 0 <= rank < comm.size:
            raise ACCLError(ErrorCode.INVALID_RANK, f"rank {rank}")

    def _collective(self, op: Operation, comm, count: int, dtype: DataType,
                    compress_dtype, run_async: bool, context=None,
                    **fields):
        cfg, flags = self._resolve_arithcfg(dtype, compress_dtype)
        opts = CallOptions(op=op, comm=comm or self._world, count=count,
                           arithcfg=cfg, compression=flags, **fields)
        return self._launch(opts, run_async, context or op.name.lower())

    # -- primitives ----------------------------------------------------------
    def copy(self, srcbuf: BaseBuffer, dstbuf: BaseBuffer,
             count: Optional[int] = None, run_async: bool = False):
        n = self._count_of(srcbuf, count)
        return self._collective(Operation.COPY, None, n, srcbuf.dtype, None,
                                run_async, op0=srcbuf, res=dstbuf)

    def copy_from_stream(self, dstbuf: BaseBuffer,
                         count: Optional[int] = None, stream_id: int = 0,
                         run_async: bool = False):
        """Pull ``count`` elements from this rank's stream port into
        ``dstbuf`` (ref ``copy_from_stream``)."""
        n = self._count_of(dstbuf, count)
        return self._collective(
            Operation.COPY, None, n, dstbuf.dtype, None, run_async,
            stream=StreamFlags.OP0_STREAM, stream_id=stream_id,
            op0=DummyBuffer(n, dstbuf.dtype), res=dstbuf,
            context="copy_from_stream")

    def copy_to_stream(self, srcbuf: BaseBuffer, count: Optional[int] = None,
                       stream_id: int = 0, run_async: bool = False):
        """Push ``count`` elements of ``srcbuf`` into this rank's stream
        port (ref ``copy_to_stream``)."""
        n = self._count_of(srcbuf, count)
        return self._collective(
            Operation.COPY, None, n, srcbuf.dtype, None, run_async,
            stream=StreamFlags.RES_STREAM, stream_id=stream_id, op0=srcbuf,
            res=DummyBuffer(n, srcbuf.dtype), context="copy_to_stream")

    def copy_from_to_stream(self, dtype, count: int, stream_id: int = 0,
                            run_async: bool = False):
        """Relay ``count`` elements of ``dtype`` through the engine from
        the stream port back to it (ref ``copy_from_to_stream``)."""
        dt = as_datatype(dtype)
        n = int(count)
        return self._collective(
            Operation.COPY, None, n, dt, None, run_async,
            stream=StreamFlags.OP0_STREAM | StreamFlags.RES_STREAM,
            stream_id=stream_id, op0=DummyBuffer(n, dt),
            res=DummyBuffer(n, dt), context="copy_from_to_stream")

    def combine(self, function: ReduceFunction, op0: BaseBuffer,
                op1: BaseBuffer, res: BaseBuffer,
                count: Optional[int] = None, run_async: bool = False):
        """``res = function(op0, op1)`` on this rank's device (kernel K4),
        cast to ``res``'s dtype; ``res`` may be ``op0`` (in place)."""
        n = self._count_of(op0, count)
        return self._collective(Operation.COMBINE, None, n, op0.dtype, None,
                                run_async, reduce_function=function,
                                op0=op0, op1=op1, res=res)

    # -- collectives ---------------------------------------------------------
    def bcast(self, buf: BaseBuffer, count: Optional[int] = None,
              root: int = 0, comm: Optional[Communicator] = None,
              compress_dtype=None, run_async: bool = False):
        comm = comm or self._world
        self._check_rank(comm, root)
        n = self._count_of(buf, count)
        return self._collective(Operation.BCAST, comm, n, buf.dtype,
                                compress_dtype, run_async, root_src=root,
                                op0=buf, res=buf)

    def scatter(self, sendbuf: Optional[BaseBuffer], recvbuf: BaseBuffer,
                count: Optional[int] = None, root: int = 0,
                comm: Optional[Communicator] = None, compress_dtype=None,
                run_async: bool = False):
        """Rank r gets block r of the root's ``sendbuf`` (size * count
        elements); ``count`` is the per-rank RESULT count.  Only the
        root's ``sendbuf`` is read (None elsewhere)."""
        comm = comm or self._world
        self._check_rank(comm, root)
        n = self._count_of(recvbuf, count)
        if sendbuf is None:
            sendbuf = DummyBuffer(0, recvbuf.dtype)
        return self._collective(Operation.SCATTER, comm, n, recvbuf.dtype,
                                compress_dtype, run_async, root_src=root,
                                op0=sendbuf, res=recvbuf)

    def gather(self, sendbuf: BaseBuffer, recvbuf: Optional[BaseBuffer],
               count: Optional[int] = None, root: int = 0,
               comm: Optional[Communicator] = None, compress_dtype=None,
               run_async: bool = False):
        """The root's ``recvbuf`` gets every rank's ``sendbuf``
        concatenated in rank order; the other ranks' ``recvbuf`` (None,
        or a buffer) is left as it was."""
        comm = comm or self._world
        self._check_rank(comm, root)
        n = self._count_of(sendbuf, count)
        if recvbuf is None:
            recvbuf = DummyBuffer(0, sendbuf.dtype)
        return self._collective(Operation.GATHER, comm, n, sendbuf.dtype,
                                compress_dtype, run_async, root_src=root,
                                op0=sendbuf, res=recvbuf)

    def allgather(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                  count: Optional[int] = None,
                  comm: Optional[Communicator] = None, compress_dtype=None,
                  run_async: bool = False):
        n = self._count_of(sendbuf, count)
        return self._collective(Operation.ALLGATHER, comm, n, sendbuf.dtype,
                                compress_dtype, run_async, op0=sendbuf,
                                res=recvbuf)

    def reduce(self, sendbuf: Optional[BaseBuffer],
               recvbuf: Optional[BaseBuffer], count: Optional[int] = None,
               root: int = 0, function: ReduceFunction = ReduceFunction.SUM,
               comm: Optional[Communicator] = None, compress_dtype=None,
               from_stream: bool = False, to_stream: bool = False,
               stream_id: int = 0, dtype=None, run_async: bool = False):
        """Reduce to ``root``: its ``recvbuf`` gets ``function`` over
        every rank's ``sendbuf``; the other ranks' ``recvbuf`` (None, or a
        buffer) is left as it was.  The lowering follows the
        ``reduce_algorithm`` register.  ``from_stream`` takes this rank's
        operand from its stream port ``stream_id`` (``sendbuf`` None, the
        operand's ``dtype`` and ``count`` given or read off ``recvbuf``);
        ``to_stream`` delivers the root's result to its stream port
        (``recvbuf`` None) — the reference's four reduce overloads."""
        comm = comm or self._world
        self._check_rank(comm, root)
        if sendbuf is not None:
            op_dtype = sendbuf.dtype
            n = self._count_of(sendbuf, count)
        else:
            if not from_stream:
                raise ACCLError(
                    ErrorCode.INVALID_OPERATION,
                    "reduce needs sendbuf unless from_stream",
                    details={"op": "reduce", "from_stream": from_stream},
                )
            op_dtype = (as_datatype(dtype) if dtype is not None
                        else recvbuf.dtype if recvbuf is not None
                        else DataType.FLOAT32)
            if count is None and recvbuf is not None:
                n = self._count_of(recvbuf, count)
            elif count is None:
                raise ACCLError(
                    ErrorCode.INVALID_COUNT,
                    "stream reduce needs an explicit count without recvbuf",
                    details={"op": "reduce", "from_stream": from_stream},
                )
            else:
                n = int(count)
        stream = StreamFlags.NO_STREAM
        if from_stream:
            stream |= StreamFlags.OP0_STREAM
        if to_stream:
            stream |= StreamFlags.RES_STREAM
        self._advance_wire_seed(comm, Operation.REDUCE, op_dtype,
                                compress_dtype)
        return self._collective(
            Operation.REDUCE, comm, n, op_dtype, compress_dtype, run_async,
            root_dst=root, reduce_function=function, stream=stream,
            stream_id=stream_id,
            op0=sendbuf if sendbuf is not None else DummyBuffer(n, op_dtype),
            res=recvbuf if recvbuf is not None else DummyBuffer(0, op_dtype))

    def allreduce(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                  count: Optional[int] = None,
                  function: ReduceFunction = ReduceFunction.SUM,
                  comm: Optional[Communicator] = None, compress_dtype=None,
                  run_async: bool = False):
        """Every rank gets ``function`` over all ranks' ``sendbuf``.  The
        lowering follows the ``allreduce_algorithm`` register; with no
        ``compress_dtype`` the ``wire_dtype`` register picks the wire."""
        comm = comm or self._world
        n = self._count_of(sendbuf, count)
        if compress_dtype is None:
            # the wire_dtype register's verdict, unless the lane's arith
            # pair cannot run this reduce function (int8 under MAX keeps
            # the uncompressed wire)
            wd = int(self.engine.gang.tuning.get("wire_dtype", 0))
            pair = (sendbuf.dtype, DataType(wd)) if wd else None
            if pair in self._arith and self._arith[pair].supports(
                    ReduceFunction(int(function))):
                compress_dtype = DataType(wd)
        cfg, flags = self._resolve_arithcfg(sendbuf.dtype, compress_dtype)
        wire = cfg.compressed if flags else None
        seed = self._derive_wire_seed(comm, Operation.ALLREDUCE, wire)
        staged = self._error_feedback_operand(comm, sendbuf, n, function,
                                              wire, seed)
        return self._collective(Operation.ALLREDUCE, comm, n, sendbuf.dtype,
                                compress_dtype, run_async,
                                reduce_function=function,
                                op0=sendbuf if staged is None else staged,
                                res=recvbuf)

    def reduce_scatter(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                       count: Optional[int] = None,
                       function: ReduceFunction = ReduceFunction.SUM,
                       comm: Optional[Communicator] = None,
                       compress_dtype=None, run_async: bool = False):
        """``count`` is the per-rank RESULT count (``sendbuf`` holds
        size * count)."""
        comm = comm or self._world
        n = self._count_of(recvbuf, count)
        self._advance_wire_seed(comm, Operation.REDUCE_SCATTER,
                                recvbuf.dtype, compress_dtype)
        return self._collective(Operation.REDUCE_SCATTER, comm, n,
                                recvbuf.dtype, compress_dtype, run_async,
                                reduce_function=function, op0=sendbuf,
                                res=recvbuf)

    def alltoall(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                 count: Optional[int] = None,
                 comm: Optional[Communicator] = None, compress_dtype=None,
                 run_async: bool = False):
        """Block transpose: rank r's block p of ``recvbuf`` is rank p's
        block r of ``sendbuf``.  ``count`` is the elements per block
        (``sendbuf.count // size`` by default)."""
        comm = comm or self._world
        n = sendbuf.count // comm.size if count is None else int(count)
        return self._collective(Operation.ALLTOALL, comm, n, sendbuf.dtype,
                                compress_dtype, run_async, op0=sendbuf,
                                res=recvbuf)

    # -- point-to-point ------------------------------------------------------
    @staticmethod
    def _check_p2p_wire(cfg, flags, opname: str) -> None:
        """Scaled wire lanes (int8) are reduction lanes, refused on a
        point-to-point call at intake, as the JAX facade refuses them;
        the cast lanes (float16, bfloat16, fp8) work."""
        if flags & CompressionFlags.ETH_COMPRESSED and _wire.is_scaled(
                cfg.compressed):
            raise ACCLError(
                ErrorCode.COMPRESSION_ERROR,
                f"{opname}: scaled wire lane {cfg.compressed.name} is "
                "collective-only",
                details={
                    "op": opname, "wire": cfg.compressed.name,
                    "hint": "use a cast lane (float16/bfloat16/fp8) for "
                            "p2p, scaled int8 for allreduce",
                },
            )

    def send(self, srcbuf: Optional[BaseBuffer], count: Optional[int],
             dst: int, tag: int = 0, comm: Optional[Communicator] = None,
             compress_dtype=None, from_stream: bool = False,
             stream_id: int = 0, run_async: bool = False):
        """Send ``count`` elements of ``srcbuf`` to rank ``dst``'s receive
        of the same ``tag`` (or, ``from_stream``, the next ``count``
        elements of this rank's stream port ``stream_id``, with
        ``srcbuf`` None).  A synchronous send returns when the receiver
        has taken the data, or fails with SEND_TIMEOUT after the engine
        timeout (``set_timeout``); the buffer may be overwritten as soon
        as the call returns, asynchronous or not."""
        comm = comm or self._world
        self._check_rank(comm, dst)
        dtype = srcbuf.dtype if srcbuf is not None else DataType.FLOAT32
        n = (self._count_of(srcbuf, count) if srcbuf is not None
             else int(count))
        cfg, flags = self._resolve_arithcfg(dtype, compress_dtype)
        self._check_p2p_wire(cfg, flags, "send")
        opts = CallOptions(
            op=Operation.SEND, comm=comm, count=n, root_dst=dst, tag=tag,
            arithcfg=cfg, compression=flags,
            stream=(StreamFlags.OP0_STREAM if from_stream
                    else StreamFlags.NO_STREAM),
            stream_id=stream_id,
            op0=srcbuf if srcbuf is not None else DummyBuffer(n, dtype),
        )
        return self._launch(opts, run_async, "send")

    def recv(self, dstbuf: Optional[BaseBuffer], count: Optional[int],
             src: int, tag: int = 0, comm: Optional[Communicator] = None,
             compress_dtype=None, to_stream: bool = False,
             stream_id: int = 0, run_async: bool = False):
        """Receive ``count`` elements from rank ``src``'s send of the same
        ``tag`` into ``dstbuf`` (or, ``to_stream``, into this rank's
        stream port ``stream_id``, in the wire dtype, with ``dstbuf``
        None).  Fails with RECEIVE_TIMEOUT after the engine timeout."""
        comm = comm or self._world
        self._check_rank(comm, src)
        dtype = dstbuf.dtype if dstbuf is not None else DataType.FLOAT32
        n = (self._count_of(dstbuf, count) if dstbuf is not None
             else int(count))
        cfg, flags = self._resolve_arithcfg(dtype, compress_dtype)
        self._check_p2p_wire(cfg, flags, "recv")
        opts = CallOptions(
            op=Operation.RECV, comm=comm, count=n, root_src=src, tag=tag,
            arithcfg=cfg, compression=flags,
            stream=(StreamFlags.RES_STREAM if to_stream
                    else StreamFlags.NO_STREAM),
            stream_id=stream_id,
            res=dstbuf if dstbuf is not None else DummyBuffer(n, dtype),
        )
        return self._launch(opts, run_async, "recv")

    def stream_put(self, srcbuf: BaseBuffer, count: Optional[int], dst: int,
                   stream_id: int, tag: int = 0,
                   comm: Optional[Communicator] = None,
                   run_async: bool = False):
        """Send straight into rank ``dst``'s stream port ``stream_id``, with
        no tag matching (the reference's ``stream_put``).  The port holds
        host bytes, so the payload crosses to the host."""
        comm = comm or self._world
        self._check_rank(comm, dst)
        n = self._count_of(srcbuf, count)
        cfg, flags = self._resolve_arithcfg(srcbuf.dtype, None)
        opts = CallOptions(
            op=Operation.SEND, comm=comm, count=n, root_dst=dst, tag=tag,
            arithcfg=cfg, compression=flags, stream=StreamFlags.RES_STREAM,
            stream_id=stream_id, op0=srcbuf,
        )
        return self._launch(opts, run_async, "stream_put")

    # -- device stream ports -------------------------------------------------
    def stream_push(self, data, stream_id: int = 0) -> None:
        """Push ``data`` (numpy, or a tensor on any device: a CUDA tensor
        is copied to the host) into this rank's stream port."""
        import numpy as np

        raw = (tensor_bytes(data) if isinstance(data, torch.Tensor)
               else np.ascontiguousarray(data).tobytes())
        self.engine.stream_push(stream_id, raw)

    def stream_pop(self, count: int, dtype, stream_id: int = 0,
                   timeout: float = 30.0):
        """Pop ``count`` elements of ``dtype`` from this rank's stream port
        as a numpy array; raises TimeoutError when the port stays empty
        for ``timeout`` seconds."""
        import numpy as np

        npdt = dtype_to_numpy(as_datatype(dtype))
        need = int(count) * npdt.itemsize
        out = b""
        while len(out) < need:
            out += self.engine.stream_pop(stream_id, timeout=timeout)
        return np.frombuffer(out[:need], dtype=npdt).copy()

    # -- fused compute slots -------------------------------------------------
    def _fused_launch(self, op, fuse, sendbuf, recvbuf, n, function, comm,
                      fuse_param, root_src, run_async, context):
        cfg, flags = self._resolve_arithcfg(recvbuf.dtype, None)
        opts = CallOptions(
            op=op, comm=comm, count=n, reduce_function=function,
            root_src=root_src, arithcfg=cfg, compression=flags,
            op0=sendbuf, res=recvbuf, fuse=int(fuse),
            fuse_param=float(fuse_param),
        )
        return self._launch(opts, run_async, context)

    @staticmethod
    def _fused_operand_check(sendbuf, need: int, what: str) -> None:
        if sendbuf.count < need:
            raise ValueError(
                f"{what} needs a packed operand of at least {need} "
                f"elements, got {sendbuf.count}"
            )

    def fused_matmul_reduce_scatter(
        self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
        count: Optional[int] = None, scale: float = 1.0,
        function: ReduceFunction = ReduceFunction.SUM,
        comm: Optional[Communicator] = None, run_async: bool = False,
    ):
        """GEMM partials straight into a reduce-scatter slot: ``sendbuf``
        holds this rank's ``size*count`` partials as ``size`` destination
        chunks; ``recvbuf`` gets ``scale *`` this rank's reduced chunk."""
        comm = comm or self._world
        n = self._count_of(recvbuf, count)
        self._fused_operand_check(sendbuf, n * comm.size,
                                  "fused_matmul_reduce_scatter")
        return self._fused_launch(
            Operation.REDUCE_SCATTER, FusedCompute.MATMUL_RS, sendbuf,
            recvbuf, n, function, comm, scale, 0, run_async,
            "fused_matmul_reduce_scatter",
        )

    def fused_apply(
        self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
        count: Optional[int] = None, lr: float = 1.0,
        function: ReduceFunction = ReduceFunction.SUM,
        comm: Optional[Communicator] = None, run_async: bool = False,
    ):
        """Optimizer apply on arrival: ``sendbuf`` packs this rank's
        gradient (``size*count``, as ``size`` chunks) followed by its own
        ``count``-wide parameter shard; ``recvbuf`` gets
        ``param - lr * reduced_grad_chunk``."""
        comm = comm or self._world
        n = self._count_of(recvbuf, count)
        self._fused_operand_check(sendbuf, n * (comm.size + 1), "fused_apply")
        return self._fused_launch(
            Operation.ALLREDUCE, FusedCompute.APPLY, sendbuf, recvbuf, n,
            function, comm, lr, 0, run_async, "fused_apply",
        )

    def fused_attn_hop(
        self, sendbuf: BaseBuffer, recvbuf: BaseBuffer, hop: int,
        count: Optional[int] = None, scale: float = 1.0,
        comm: Optional[Communicator] = None, run_async: bool = False,
    ):
        """One ring-attention hop as a slot: ``sendbuf`` packs this rank's
        KV block (``count``) then its Q block (``count``); ``recvbuf``
        gets ``scale * q * kv`` against the KV block of the rank ``hop``
        positions behind on the ring (``hop`` is the same on every
        rank)."""
        comm = comm or self._world
        n = self._count_of(recvbuf, count)
        self._fused_operand_check(sendbuf, 2 * n, "fused_attn_hop")
        hop = int(hop) % max(comm.size, 1)
        return self._fused_launch(
            Operation.ALLREDUCE, FusedCompute.ATTN_HOP, sendbuf, recvbuf, n,
            ReduceFunction.SUM, comm, scale, hop, run_async, "fused_attn_hop",
        )

    def barrier(self, comm: Optional[Communicator] = None,
                run_async: bool = False):
        return self._collective(Operation.BARRIER, comm, 0, DataType.FLOAT32,
                                None, run_async)

    def deinit(self) -> None:
        if self._initialized:
            self.engine.shutdown()
            self._initialized = False


def cuda_group(n: int, device=None, **accl_kwargs) -> List[ACCL]:
    """N rank handles whose buffers share one device — on the card unless
    ``device`` asks for another (tests pass ``device="cpu"``); raises when
    there is no CUDA device to run on."""
    dev = resolve_device(device)
    gang = CudaGangContext(dev)
    ranks = [Rank(address=f"{dev}:{i}", session=i) for i in range(n)]
    return [
        ACCL(CudaEngine(gang, dev, session=i), ranks, i, **accl_kwargs)
        for i in range(n)
    ]
