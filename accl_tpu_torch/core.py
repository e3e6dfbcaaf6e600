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
:meth:`ACCL.create_communicator` gives sub-communicators (the JAX
facade's ids) that every collective takes as ``comm``.  Each collective
resolves its plan once (:meth:`ACCL._plan_for`, ``accl_tpu_torch.plans``),
and :meth:`ACCL.capabilities` reports the plan pool's counters and the
engine's device interactions.  ``create_buffer(..., host_only=True)``
makes a host-only buffer, which the gang stages through the host.

The data path's topology plane: a handle takes a
:class:`~accl_tpu_torch.topology.Topology` (``topology=``, or
``ACCL_TOPOLOGY`` / ``ACCL_SLICE_SIZE``; :meth:`ACCL.set_topology`), its
signature is a plan-key axis, and with the ``hierarchical`` register set
the allreduce, allgather, reduce_scatter and bcast of a multi-slice
communicator run as stages on derived sub-communicators (the slice, the
rail, the leaders), chained on done-callbacks into one aggregate
request.  Above ``pipeline_threshold`` bytes an allreduce or bcast runs
as ``ring_segments`` sub-calls (segmented pipelining).  A loaded
:class:`~accl_tpu_torch.tuning.TuningPlan` (:meth:`ACCL.load_tuning_plan`
or ``ACCL_TUNING_PLAN``) overlays its per-size-bucket registers on every
reader of a register.

:func:`cuda_group` builds N rank handles over one device — the
counterpart of ``core.xla_group``.  Collectives are blocking per rank:
drive each rank from its own thread, or use ``run_async=True``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import zlib
from typing import List, Optional, Sequence

import torch

from . import hierarchical as _hier
from . import wire as _wire
from .arithconfig import DEFAULT_ARITH_CONFIG
from .backends.base import BaseEngine, CallOptions, tensor_bytes
from .backends.cuda.engine import (
    CudaEngine,
    CudaGangContext,
    _record_event,
    _wait_operands,
)
from .buffer import (
    BaseBuffer,
    DeviceBuffer,
    DummyBuffer,
    HostBuffer,
    host_tensor,
)
from .communicator import Communicator, Rank
from .constants import (
    ACCLError,
    AllreduceAlgorithm,
    CompressionFlags,
    ConfigFunction,
    DataType,
    DEFAULT_TIMEOUT_S,
    EAGER_THRESHOLD_DEFAULT,
    ErrorCode,
    FusedCompute,
    HostFlags,
    Operation,
    RENDEZVOUS_THRESHOLD_DEFAULT,
    ReduceFunction,
    StreamFlags,
    TuningKey,
    as_datatype,
    drain_deadline_s,
    dtype_size,
    dtype_to_numpy,
    dtype_to_torch,
)
from .errorfeedback import ResidualStore
from .ops.driver import resolve_device
from .plans import CollectivePlan, PlanCache, size_bucket
from .request import CommandQueue, EventGroup, Request
from .topology import LinkClass, Topology

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
        max_eager_size: int = EAGER_THRESHOLD_DEFAULT,
        max_rendezvous_size: int = RENDEZVOUS_THRESHOLD_DEFAULT,
        topology: Optional[Topology] = None,
    ):
        self.engine = engine
        self._arith = dict(arith_config or DEFAULT_ARITH_CONFIG)
        self._world = Communicator(ranks, local_rank, comm_id=0)
        self._communicators: List[Communicator] = [self._world]
        self._timeout_s = float(timeout_s)
        # the topology plane: the world's slice / link-class descriptor,
        # given or from ACCL_TOPOLOGY / ACCL_SLICE_SIZE, inherited by
        # splits; the derived hierarchical subcomms are cached per (comm
        # id, epoch)
        if topology is None:
            topology = Topology.from_env(len(ranks))
        if topology is not None:
            if topology.world != len(ranks):
                raise ValueError(
                    f"topology describes world={topology.world}, this "
                    f"group is world={len(ranks)}")
            self._world.topology = topology
        self._hier_comms: dict = {}
        # the adopted TuningPlan (load_tuning_plan / ACCL_TUNING_PLAN):
        # its per-bucket registers ride the plans into CallOptions.tuning
        self._tuning_plan = None
        # per-thread call state: a hierarchical stage or a pipelined
        # segment being launched on this thread (never decomposed again)
        self._call_tls = threading.local()
        # async aggregates (hierarchical / pipelined) not yet drained by
        # flush(); appended from hop threads too, hence the lock
        self._aggregates: list = []
        self._agg_lock = threading.Lock()
        # the stage thread of hierarchical calls (started at the first)
        self._hop_q: Optional[queue.SimpleQueue] = None
        self._hop_lock = threading.Lock()
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
        # the cached per-call plans (accl_tpu_torch.plans): a warm
        # collective is pool lookup -> dispatch; a register write clears
        # the pool, and the residuals share its lifecycle (a cleared pool
        # may change the wire a residual was kept for)
        self._plans = PlanCache()
        self._plans.add_invalidation_hook(self._residuals.invalidate)
        self._error_feedback = (
            os.environ.get("ACCL_ERROR_FEEDBACK", "0") == "1")
        # the init sequence, as JAX's _initialize writes it
        self._max_eager_size = int(max_eager_size)
        self._config(ConfigFunction.RESET, 0)
        self._config(ConfigFunction.SET_TIMEOUT, timeout_s)
        self._config(ConfigFunction.SET_MAX_EAGER_SIZE, max_eager_size)
        self._config(ConfigFunction.SET_MAX_RENDEZVOUS_SIZE,
                     max_rendezvous_size)
        self._initialized = True
        env_plan = os.environ.get("ACCL_TUNING_PLAN")
        if env_plan:
            try:
                self.load_tuning_plan(env_plan, strict=False)
            except Exception as e:  # a stale plan must not brick startup
                import sys

                print(f"[accl] ignoring ACCL_TUNING_PLAN={env_plan!r}: {e}",
                      file=sys.stderr)

    #: config writes whose effect cached plans embed: a write clears the
    #: pool (JAX's set)
    _PLAN_INVALIDATING = frozenset((
        ConfigFunction.RESET,
        ConfigFunction.SET_TUNING,
        ConfigFunction.SET_MAX_EAGER_SIZE,
    ))

    def _config(self, fn: ConfigFunction, value: float, key: int = 0) -> None:
        self.flush()  # a config write must not overtake queued calls
        req = self.engine.start(CallOptions(
            op=Operation.CONFIG, cfg_function=int(fn), cfg_value=value,
            cfg_key=int(key),
        ))
        if not req.wait(timeout=drain_deadline_s(self._timeout_s)):
            raise ACCLError(ErrorCode.DEADLOCK_SUSPECTED, f"config {fn.name}")
        req.check(f"config {fn.name}")
        if fn in self._PLAN_INVALIDATING:
            self._plans.invalidate(fn.name.lower())

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

    def set_max_eager_size(self, nbytes: int) -> None:
        """The eager-vs-rendezvous threshold in bytes (clears the plan
        pool; the plans' ``eager`` verdict reads it)."""
        self._config(ConfigFunction.SET_MAX_EAGER_SIZE, nbytes)
        self._max_eager_size = int(nbytes)

    def set_max_rendezvous_size(self, nbytes: int) -> None:
        self._config(ConfigFunction.SET_MAX_RENDEZVOUS_SIZE, nbytes)

    def set_tuning(self, key, value) -> None:
        """Write a tuning register (any name of JAX's table, e.g.
        ``allreduce_algorithm`` ("xla" / "ring" / "pallas_ring" /
        "pallas_ring_bidir"), the rooted ``bcast_algorithm`` /
        ``reduce_algorithm`` / ``scatter_algorithm`` / ``gather_algorithm``
        ("xla" / "pallas_ring"), ``ring_segments``,
        ``pipeline_threshold`` (bytes), ``hierarchical`` (0 / 1), or
        ``wire_dtype`` / ``wire_dtype_ici`` / ``wire_dtype_dcn`` (a
        DataType value or name, a dtype name, or "off" / 0)).  ``key`` is
        a :class:`TuningKey`, its name, or its int value."""
        if isinstance(key, str):
            try:
                key = TuningKey[key.upper()]
            except KeyError:
                raise ValueError(f"unknown tuning key {key!r}") from None
        else:
            key = TuningKey(key)
        if isinstance(value, str):
            if key in (TuningKey.WIRE_DTYPE, TuningKey.WIRE_DTYPE_ICI,
                       TuningKey.WIRE_DTYPE_DCN):
                value = _wire_dtype_value(value)
            else:
                try:
                    value = AllreduceAlgorithm[value.upper()]
                except KeyError:
                    raise ValueError(
                        f"unknown algorithm {value!r}; valid: "
                        f"{[a.name.lower() for a in AllreduceAlgorithm]}"
                    ) from None
        # clears the plan pool, and with it the residuals (a register
        # write may change the wire a residual was kept for)
        self._config(ConfigFunction.SET_TUNING, float(value), key=int(key))

    # -- tuning plans (accl_tpu_torch.tuning) --------------------------------
    def load_tuning_plan(self, plan, strict: bool = True,
                         apply_defaults: bool = True):
        """Adopt a measured :class:`~accl_tpu_torch.tuning.TuningPlan`
        (the object or a JSON path): its defaults apply at once through
        SET_TUNING / SET_MAX_EAGER_SIZE (unless ``apply_defaults`` is
        False), and its per-size-bucket registers ride the plans, so each
        call dispatches with the registers measured best for its bucket.
        A plan for another world, or raced on another topology, raises
        (``strict``) or is skipped (returns None).  Returns the plan."""
        from .tuning import TuningPlan

        if not isinstance(plan, TuningPlan):
            plan = TuningPlan.load(os.fspath(plan))
        if plan.world and plan.world != self._world.size:
            if strict:
                raise ValueError(
                    f"tuning plan is for world={plan.world}, "
                    f"this group is world={self._world.size}")
            return None
        if plan.topology is not None:
            # a hierarchical / per-class winner holds only on the
            # link-class layout it was raced on
            here = (None if self._world.topology is None
                    else self._world.topology.signature())
            if plan.topology != here:
                if strict:
                    raise ValueError(
                        f"tuning plan was raced on topology "
                        f"{plan.topology!r}, this group's link-class "
                        f"layout is {here!r}")
                return None
        if apply_defaults:
            for name, val in sorted((plan.defaults or {}).items()):
                if name == "max_eager_size":
                    self.set_max_eager_size(int(val))
                else:
                    self.set_tuning(name, val)
        self._tuning_plan = plan
        self._plans.invalidate("load_tuning_plan")
        return plan

    def unload_tuning_plan(self, restore_defaults: bool = True) -> None:
        """Drop the adopted plan; by default also put every register it
        may have touched back to ``tuning.REGISTER_DEFAULTS``."""
        if self._tuning_plan is None:
            return
        self._tuning_plan = None
        if restore_defaults:
            from .tuning import REGISTER_DEFAULTS

            self.set_max_eager_size(REGISTER_DEFAULTS["max_eager_size"])
            for name, val in sorted(REGISTER_DEFAULTS.items()):
                if name != "max_eager_size":
                    self.set_tuning(name, val)
        self._plans.invalidate("unload_tuning_plan")

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
        class): a pipelined segment's position, and the comm's uniform
        link class (-1 when flat or mixed), so a hierarchical stage's
        per-class wire never blends into another's residual; the
        roundtrip uses this rank's mixed seed."""
        if (not self._error_feedback or wire is None
                or function != ReduceFunction.SUM):
            return None
        seg = getattr(self._call_tls, "pipeline_seg_index", 0)
        lc = -1
        if comm.topology is not None:
            cls = comm.topology.comm_link_class()
            lc = int(cls) if cls is not None else -1
        key = (comm.id, comm.epoch, Operation.ALLREDUCE, n, seg, lc)
        x = sendbuf.tensor[:n]
        if sendbuf.ready is not None:
            torch.cuda.current_stream(x.device).wait_event(sendbuf.ready)
        x_eff = self._residuals.apply(
            key, _wire.widen(x), wire, _wire.rank_seed(seed, comm.local_rank))
        staged = _wire.astype(x_eff, x.dtype)
        if sendbuf.is_host_only:
            return HostBuffer(n, sendbuf.dtype, host=staged)
        buf = DeviceBuffer(n, sendbuf.dtype, x.device, tensor=staged,
                           host=staged.new_zeros((), device="cpu").expand(n))
        if x.device.type == "cuda":
            buf.ready = torch.cuda.Event()
            buf.ready.record(torch.cuda.current_stream(x.device))
        return buf

    # -- buffers -------------------------------------------------------------
    def create_buffer(self, count: int, dtype,
                      host_only: bool = False) -> BaseBuffer:
        """A zeroed buffer of ``count`` elements on this rank's device, or
        in host memory alone (``host_only``: a call with such an operand
        or result is staged through the host)."""
        return self.engine.create_buffer(count, as_datatype(dtype),
                                         host_only=host_only)

    def create_buffer_from(self, array, host_only: bool = False) -> BaseBuffer:
        """Wrap a host array (numpy or a CPU tensor, flattened): the
        buffer's host side ALIASES it when it is contiguous, and the device
        side is synced on return (``host_only``: the array is the whole
        buffer)."""
        host = host_tensor(array)
        return self.engine.create_buffer(
            host.numel(), as_datatype(host.dtype), data=host,
            host_only=host_only,
        )

    # -- communicators -------------------------------------------------------
    def create_communicator(self, members: Sequence[int],
                            base: Optional[Communicator] = None
                            ) -> Optional[Communicator]:
        """A sub-communicator over ``members`` (ranks of ``base``, the
        world by default, in their new order); None on a rank that is not
        a member.  Collective: every member calls with the same list.  The
        id derives from the parent's id and the membership, as the JAX
        package derives it, so every rank agrees without exchanging it;
        a re-created same-membership communicator keeps the id and gets a
        fresh epoch (its first call re-plans)."""
        base = base or self._world
        comm_id = zlib.crc32(
            repr((base.id, tuple(members))).encode()) & 0x7FFFFFFF
        # split() derives the subcomm's topology from the base's (the
        # port has no fabric to register it with)
        comm = base.split(members, comm_id=comm_id)
        if comm is not None:
            self._communicators.append(comm)
        return comm

    # -- the topology plane (accl_tpu_torch.topology) ------------------------
    @property
    def topology(self) -> Optional[Topology]:
        """The world communicator's topology (None: flat)."""
        return self._world.topology

    def set_topology(self, topology: Optional[Topology],
                     comm: Optional[Communicator] = None) -> None:
        """Attach (or, with None, detach) a topology to ``comm`` (the
        world by default).  Collective by contract, like a register
        write: every rank attaches an equal descriptor.  The plan pool
        and the derived hierarchical subcomms of ``comm`` drop."""
        comm = comm or self._world
        if topology is not None and topology.world != comm.size:
            raise ValueError(
                f"topology describes world={topology.world}, "
                f"communicator {comm.id} is size={comm.size}")
        comm.topology = topology
        comm._full_topology = None
        self._plans.invalidate("set_topology")
        self._hier_comms = {k: v for k, v in self._hier_comms.items()
                            if k[0] != comm.id}

    # -- capabilities --------------------------------------------------------
    def capabilities(self) -> dict:
        """What this handle's engine can do, and its dispatch counters:
        the keys of the JAX facade's report that the port can fill
        truthfully (the rest -- health, telemetry, monitor, the in-flight
        window -- come with their planes, ROADMAP A11b-A11d)."""
        engine = type(self.engine).__name__
        return {
            "engine": engine,
            # by name, as JAX decides it; the port's gang engine is the
            # device tier
            "device_tier": engine == "CudaEngine",
            "wire_compression": sorted(
                f"{u.name}->{c.name}" for (u, c) in self._arith if u != c),
            "arithmetic": [f.name for f in ReduceFunction],
            "world_size": self._world.size,
            # one warm gang collective moves it by exactly 1
            "device_interactions": self.engine.device_interactions(),
            "plan_cache": self._plans.stats(),
            # the adopted measurement-driven TuningPlan, if any
            "tuning_plan": (
                None if self._tuning_plan is None else {
                    "tier": self._tuning_plan.tier,
                    "world": self._tuning_plan.world,
                    "collectives": sorted(self._tuning_plan.entries),
                }),
        }

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

    @staticmethod
    def _host_flags(*bufs: Optional[BaseBuffer]) -> HostFlags:
        flags = HostFlags.NO_HOST
        slots = (HostFlags.OP0_HOST, HostFlags.OP1_HOST, HostFlags.RES_HOST)
        for slot, buf in zip(slots, bufs):
            if buf is not None and buf.is_host_only:
                flags |= slot
        return flags

    def _algorithm_snapshot(self, op: Operation):
        """The algorithm register steering ``op`` now (read once a plan)."""
        tuning = self.engine.gang.tuning
        if op == Operation.ALLREDUCE:
            return tuning.get("allreduce_algorithm")
        return tuning.get(f"{op.name.lower()}_algorithm")

    #: collectives of segmented pipelining: a contiguous operand slice
    #: maps onto the same result slice, and every rank holds a buffer
    #: (REDUCE's stream operands would let one rank split where another
    #: cannot)
    _PIPELINE_OPS = frozenset((Operation.ALLREDUCE, Operation.BCAST))

    #: collectives the ``wire_dtype`` register's verdict may compress (an
    #: explicit ``compress_dtype`` works on every op that takes one)
    _WIRE_VERDICT_OPS = frozenset((Operation.ALLREDUCE,))

    def _plan_for(self, op: Operation, comm: Communicator, dtype: DataType,
                  count: int, compress_dtype, host: HostFlags,
                  extra: tuple = ()) -> CollectivePlan:
        """The cached plan of a collective (the JAX facade's ``_plan_for``):
        one per ``(op, comm id, comm epoch, dtype, size bucket, compress
        dtype, host flags, topology signature, extra)``; the signature
        sits before ``extra`` (``CollectivePlan.fuse`` reads ``key[-1]``).
        A miss resolves, with the loaded tuning plan's per-bucket overlay
        over the gang's table: the arithmetic config and compression
        flags, the wire verdict (the comm's link-class register first,
        then ``wire_dtype``), the eager verdict, the pipelining and
        hierarchical verdicts and the algorithm snapshot; ``plan.engine``
        takes the gang's prepared state."""
        cdt = None if compress_dtype is None else as_datatype(compress_dtype)
        bucket = size_bucket(count)
        topo = comm.topology
        tsig = None if topo is None else topo.signature()
        lc = None if topo is None else topo.comm_link_class()
        key = (op, comm.id, comm.epoch, dtype, bucket, cdt, int(host), tsig,
               extra)
        plan, _ = self._plans.get_with_flag(key)
        if plan is not None:
            return plan
        overlay = None
        if self._tuning_plan is not None:
            overlay = self._tuning_plan.registers_for(
                op.name.lower(), bucket) or None
        regs = dict(self.engine.gang.tuning)
        regs.update(overlay or {})
        if (cdt is None and op in self._WIRE_VERDICT_OPS
                and "fuse" not in extra):
            # the per-link-class ladder: a comm whose wire is uniformly
            # ICI or DCN reads its class register first, and 0 (or a
            # mixed comm) defers to wire_dtype.  The lane stays off when
            # its arith pair cannot run this call's reduce function (int8
            # under MAX); the verdict ops carry the function as extra[0].
            # Fused slots keep the plain wire.
            wd = int(regs.get({LinkClass.ICI: "wire_dtype_ici",
                               LinkClass.DCN: "wire_dtype_dcn"}.get(lc, ""),
                              0) or 0)
            if not wd:
                wd = int(regs.get("wire_dtype", 0) or 0)
            try:
                verdict = DataType(wd)
            except ValueError:
                verdict = DataType.NONE
            pair = (dtype, verdict)
            if (verdict not in (DataType.NONE, dtype)
                    and _wire.is_wire_dtype(verdict) and pair in self._arith
                    and (not extra or self._arith[pair].supports(
                        ReduceFunction(int(extra[0]))))):
                cdt = verdict
        cfg, flags = self._resolve_arithcfg(dtype, cdt)
        # the protocol verdict holds for the whole bucket or is None (the
        # threshold falls inside [2^b, 2^(b+1)) elements)
        eager_limit = regs.get("max_eager_size", self._max_eager_size)
        lo = (1 << bucket) * dtype_size(dtype)
        hi = ((1 << (bucket + 1)) - 1) * dtype_size(dtype)
        eager = (True if hi <= eager_limit
                 else False if lo > eager_limit else None)
        pthresh, psegs = 0, 1
        if op in self._PIPELINE_OPS:
            pthresh = int(regs.get("pipeline_threshold", 0) or 0)
            psegs = int(regs.get("ring_segments", 1) or 1)
        # the register half of the hierarchical verdict (the count half is
        # checked per call: counts vary within a bucket)
        hier = False
        if topo is not None and "fuse" not in extra:
            if (op.name.lower() in _hier.HIER_OPS
                    and _hier.multi_slice(topo)):
                hier = bool(int(regs.get("hierarchical", 0) or 0))
        plan = CollectivePlan(
            key, cfg, flags,
            wire_dtype=(cfg.compressed
                        if flags & CompressionFlags.ETH_COMPRESSED else None),
            bucket=bucket, eager=eager,
            algorithm=self._algorithm_snapshot(op), tuning=overlay,
            pipeline_threshold=pthresh, pipeline_segments=psegs,
            hierarchical=hier, link_class=lc,
        )
        return self._plans.store(plan)

    def _planned(self, op: Operation, comm: Communicator, count: int,
                 dtype: DataType, compress_dtype, run_async: bool, context: str,
                 extra: tuple = (), seeded: bool = False,
                 plan: Optional[CollectivePlan] = None, **fields):
        """Plan (unless the entry point already did), build the call's
        options and launch it (``seeded``: draw the per-call wire seed,
        for the reduce, allreduce and reduce_scatter)."""
        host = self._host_flags(fields.get("op0"), None, fields.get("res"))
        if plan is None:
            plan = self._plan_for(op, comm, dtype, count, compress_dtype,
                                  host, extra)
        if seeded:
            fields["wire_seed"] = self._derive_wire_seed(
                comm, op, plan.wire_dtype)
        opts = CallOptions(op=op, comm=comm, count=count,
                           arithcfg=plan.arithcfg,
                           compression=plan.compression, host=host,
                           plan=plan, tuning=plan.tuning, **fields)
        return self._launch(opts, run_async, context)

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
        flushed yet is not launched), and so has every async hierarchical
        or pipelined aggregate of this handle whose stages have all been
        launched (the drain point the port keeps in place of JAX's
        in-flight window, ROADMAP A11d)."""
        for req in self._dispatch_pending():
            if req.done() and req.event is not None:
                req.event.synchronize()
        with self._agg_lock:
            aggs, self._aggregates = self._aggregates, []
        for agg in aggs:
            if agg.done():
                if agg.event is not None:
                    agg.event.synchronize()
            else:
                with self._agg_lock:
                    self._aggregates.append(agg)

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
        self.engine.drain_windows()  # a drain point of the command ring

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
        # a hierarchical stage dispatches at once, whatever batch the
        # caller has opened since its call (it runs on a hop thread)
        if (self._pending is not None
                and not getattr(self._call_tls, "hier", False)):
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

    # -- aggregates: segmented pipelining and hierarchical stages ------------
    def _finish_aggregate(self, outer: Request, run_async: bool,
                          context: str) -> Request:
        """Return an async aggregate (flush() drains it), or wait for it
        and raise its failure."""
        if run_async:
            with self._agg_lock:
                # keep those whose device work may still be running
                self._aggregates = [
                    q for q in self._aggregates if not q.done()
                    or (q.event is not None and not q.event.query())]
                self._aggregates.append(outer)
            return outer
        deadline = drain_deadline_s(self._timeout_s)
        if not outer.wait(timeout=deadline):
            raise ACCLError(ErrorCode.DEADLOCK_SUSPECTED, context,
                            details={"op": outer.op_name,
                                     "timeout_s": deadline})
        outer.check(context)
        return outer

    def _pipeline_segments_for(self, plan: CollectivePlan, count: int,
                               dtype: DataType) -> int:
        """Sub-calls for this call, from the plan's pipelining verdict; 1
        when the split does not apply (below the threshold, registers
        off, or already a segment: segments never split again)."""
        if (plan.pipeline_segments <= 1
                or getattr(self._call_tls, "pipelining", False)):
            return 1
        nseg = plan.pipeline_for(count * dtype_size(dtype))
        return min(nseg, count) if count > 0 else 1

    def _launch_pipelined(self, op_name: str, count: int, nseg: int,
                          run_async: bool, launch_seg,
                          context: str) -> Request:
        """Segmented pipelining (the JAX facade's ``_launch_pipelined``):
        ``count`` split into ``nseg`` contiguous chunks, one async sub-call
        each (``launch_seg(start, stop)``), back to back; returns ONE
        aggregate request that completes when the last segment has (the
        first failing segment's retcode wins), holding every segment's
        event.  The gang keeps tag 0 on every segment, as JAX's device
        tier does (its order is the gang's sequence)."""
        base, rem = divmod(count, nseg)
        bounds, start = [], 0
        for i in range(nseg):
            stop = start + base + (1 if i < rem else 0)
            if stop > start:
                bounds.append((start, stop))
            start = stop
        outer = Request(op_name=op_name.upper())
        outer.mark_executing()
        if self._pending is not None:
            # segments queued into an open batch: waiting on the
            # aggregate flushes them, while that batch is still open
            batch_q = self._pending

            def _pw(batch_q=batch_q):
                if self._pending is batch_q:
                    self._dispatch_pending()

            outer._pre_wait = _pw
        t0 = time.perf_counter_ns()
        self._call_tls.pipelining = True
        inner = []
        try:
            for i, (s0, s1) in enumerate(bounds):
                # the segment's position keys its error-feedback residual
                self._call_tls.pipeline_seg_index = i
                inner.append(launch_seg(s0, s1))
        finally:
            self._call_tls.pipelining = False
            self._call_tls.pipeline_seg_index = 0

        def _resolve():
            for q in inner:
                q.materialize()
            for q in inner:
                if q.get_retcode() != ErrorCode.OK:
                    raise RuntimeError(
                        "pipelined segment failed: "
                        f"{ErrorCode.describe(q.get_retcode())}")

        outer.defer_result(_resolve)
        lock = threading.Lock()
        left = [len(inner)]

        def _seg_done():
            with lock:
                left[0] -= 1
                if left[0]:
                    return
            code, ctx = ErrorCode.OK, None
            for q in inner:
                if q.get_retcode() != ErrorCode.OK:
                    code, ctx = q.get_retcode(), q.error_context
                    break
            outer.complete(code, max(time.perf_counter_ns() - t0, 1),
                           context=ctx,
                           event=EventGroup([q.event for q in inner]))

        for q in inner:
            q.add_done_callback(_seg_done)
        return self._finish_aggregate(outer, run_async, context)

    def _hier_state(self, comm: Communicator) -> dict:
        """The derived subcomms of ``comm``, cached per (comm id, epoch);
        a stale epoch's entry is dropped."""
        key = (comm.id, comm.epoch)
        st = self._hier_comms.get(key)
        if st is None:
            for k in [k for k in self._hier_comms if k[0] == comm.id]:
                del self._hier_comms[k]
            st = {}
            self._hier_comms[key] = st
        return st

    def _hier_subcomm(self, comm: Communicator, st: dict, name,
                      members) -> Communicator:
        """The subcomm over ``members`` of ``comm``, derived once (every
        member derives the same list from the shared topology, and the
        id from the membership, so no exchange is needed)."""
        sub = st.get(name)
        if sub is None:
            sub = self.create_communicator(list(members), base=comm)
            st[name] = sub
        return sub

    def _hier_eligible_call(self, plan: CollectivePlan, comm: Communicator,
                            compress_dtype, op_name: str, count: int) -> bool:
        """The per-call half of the hierarchical verdict: the plan's
        register half set, no explicit ``compress_dtype`` (honoured
        exactly, flat), no open batch, not already a stage or a segment,
        and the (topology, count) shape decomposes.  (JAX also
        fingerprints the decomposed call for its contract plane, which
        the port has not yet: ROADMAP A11c.)"""
        if (not plan.hierarchical or compress_dtype is not None
                or self._pending is not None
                or getattr(self._call_tls, "hier", False)
                or getattr(self._call_tls, "pipelining", False)):
            return False
        return _hier.eligible(op_name, comm.topology, count)

    def _launch_hier_stages(self, op_name: str, stages, run_async: bool,
                            context: str) -> Request:
        """A hierarchical decomposition as a chain of async stages, ONE
        aggregate request.  Each stage thunk launches its sub-collective
        with ``run_async=True`` and returns its request, or None when
        this rank takes no part in it (a non-leader in the cross-slice
        stage), which goes straight on.  A stage's completion hands the
        next to this handle's stage thread (:meth:`_hop`): the callback
        runs on the gang's executing thread, which holds the
        communicator's turn, so launching there could deadlock the group;
        and a rank waiting at a later stage's rendezvous has posted, not
        blocked.  Device order between stages
        comes from the buffers' ``ready`` events (the engine waits on them
        before every launch).  The aggregate holds every stage's event;
        a failing stage fails it."""
        outer = Request(op_name=op_name.upper())
        outer.mark_executing()
        t0 = time.perf_counter_ns()
        inner: list = []
        lock = threading.Lock()
        state = {"i": 0, "done": False}

        def _finish(code, ctx):
            with lock:
                if state["done"]:
                    return
                state["done"] = True
            outer.complete(code, max(time.perf_counter_ns() - t0, 1),
                           context=ctx,
                           event=EventGroup([q.event for q in inner]))

        def _advance():
            while True:
                with lock:
                    if state["done"]:
                        return
                    idx = state["i"]
                    state["i"] += 1
                if idx >= len(stages):
                    _finish(ErrorCode.OK, None)
                    return
                self._call_tls.hier = True
                try:
                    req = stages[idx]()
                except ACCLError as e:
                    _finish(e.code, dict(e.details) or None)
                    return
                except Exception as e:  # a stage fails the aggregate
                    _finish(ErrorCode.INVALID_OPERATION, {
                        "op": op_name, "hier_stage": idx,
                        "error": f"{type(e).__name__}: {e}"[:300]})
                    return
                finally:
                    self._call_tls.hier = False
                if req is None:
                    continue  # not a participant: the next stage
                inner.append(req)

                def _done(q=req):
                    if q.get_retcode() != ErrorCode.OK:
                        _finish(q.get_retcode(), q.error_context)
                    elif not self._hop(_advance):
                        _finish(ErrorCode.INVALID_OPERATION, {
                            "op": op_name, "hier_stage": idx + 1,
                            "error": "the handle was deinitialised"})

                req.add_done_callback(_done)
                return

        def _resolve():
            for q in inner:
                q.materialize()

        outer.defer_result(_resolve)
        _advance()
        return self._finish_aggregate(outer, run_async, context)

    def _hop(self, fn) -> bool:
        """Run ``fn`` on this handle's stage thread, started at the first
        hop and stopped by :meth:`deinit`; False, with ``fn`` not run, once
        the handle is deinitialised.  JAX starts a fresh thread a
        hop; on an H100 80GB HBM3 host a fresh thread's start and first
        CUDA call cost 0.65-0.85 ms, and a hierarchical allreduce on 2 x
        4 took 28.1 ms p50 that way against 9.0 with one thread a handle
        (PERF.md, Findings).  The thread runs one stage launch at a time and never waits
        on another rank: a launch is a post, and the gang call it may
        run completes its requests without blocking."""
        with self._hop_lock:
            if not self._initialized:
                return False
            if self._hop_q is None:
                self._hop_q = queue.SimpleQueue()
                threading.Thread(target=self._hop_loop, args=(self._hop_q,),
                                 name=f"accl-hier-{self.rank}",
                                 daemon=True).start()
            self._hop_q.put(fn)
        return True

    @staticmethod
    def _hop_loop(q: queue.SimpleQueue) -> None:
        while True:
            fn = q.get()
            if fn is None:
                return
            fn()  # _advance completes its aggregate on any failure

    def _scratch(self, dtype: DataType, count: int) -> DeviceBuffer:
        """A stage's intermediate buffer on this rank's device: its device
        side uninitialised (the stage that writes it covers every element
        the next reads) and no host copy of its own."""
        t = torch.empty(count, dtype=dtype_to_torch(dtype),
                        device=self.engine.device)
        return DeviceBuffer(count, dtype, t.device, tensor=t,
                            host=t.new_zeros((), device="cpu").expand(count))

    def _hier_allreduce(self, comm: Communicator, sendbuf: BaseBuffer,
                        recvbuf: BaseBuffer, n: int,
                        function: ReduceFunction,
                        run_async: bool) -> Request:
        """Hierarchical allreduce.  Rail mode (symmetric topology, n
        divisible by the slice size S): intra-slice reduce-scatter ->
        allreduce over this chunk's rail (n/S elements) -> intra-slice
        allgather.  Leader mode (any other multi-slice shape): reduce to
        the slice leader -> allreduce over the leaders -> intra-slice
        bcast."""
        topo = comm.topology
        mode = _hier.allreduce_mode(topo, n)
        st = self._hier_state(comm)
        me = comm.local_rank
        sl = topo.slice_of(me)
        members = list(topo.slice_members(sl))
        intra = self._hier_subcomm(comm, st, ("intra", sl), members)
        if mode == "rail":
            S = len(topo.slices[0])
            li = topo.local_index(me)
            rail = self._hier_subcomm(comm, st, ("rail", li), topo.rail(li))
            chunk = n // S
            scratch = self._scratch(sendbuf.dtype, chunk)
            reduced = self._scratch(sendbuf.dtype, chunk)
            stages = [
                lambda: self.reduce_scatter(
                    sendbuf, scratch, chunk, function=function, comm=intra,
                    run_async=True),
                lambda: self.allreduce(
                    scratch, reduced, chunk, function=function, comm=rail,
                    run_async=True),
                lambda: self.allgather(
                    reduced, recvbuf, chunk, comm=intra, run_async=True),
            ]
        else:
            lead = topo.slice_leader(me)
            lead_idx = members.index(lead)
            scratch = self._scratch(sendbuf.dtype, n) if me == lead else None

            def _s1():
                return self.reduce(sendbuf, scratch, n, root=lead_idx,
                                   function=function, comm=intra,
                                   run_async=True)

            def _s2():
                if me != lead:
                    return None
                lcomm = self._hier_subcomm(comm, st, "leaders",
                                           topo.leaders())
                return self.allreduce(scratch, recvbuf, n, function=function,
                                      comm=lcomm, run_async=True)

            def _s3():
                if intra.size == 1:
                    return None
                return self.bcast(recvbuf, n, root=lead_idx, comm=intra,
                                  run_async=True)

            stages = [_s1, _s2, _s3]
        return self._launch_hier_stages("allreduce", stages, run_async,
                                        "allreduce")

    def _hier_allgather(self, comm: Communicator, sendbuf: BaseBuffer,
                        recvbuf: BaseBuffer, n: int,
                        run_async: bool) -> Request:
        """Hierarchical allgather (symmetric contiguous topology):
        intra-slice allgather -> rail allgather; contiguous slices make
        the rail's slice-major placement the flat rank-major one."""
        topo = comm.topology
        st = self._hier_state(comm)
        me = comm.local_rank
        sl = topo.slice_of(me)
        li = topo.local_index(me)
        S = len(topo.slices[0])
        intra = self._hier_subcomm(comm, st, ("intra", sl),
                                   topo.slice_members(sl))
        rail = self._hier_subcomm(comm, st, ("rail", li), topo.rail(li))
        scratch = self._scratch(sendbuf.dtype, S * n)
        stages = [
            lambda: self.allgather(sendbuf, scratch, n, comm=intra,
                                   run_async=True),
            lambda: self.allgather(scratch, recvbuf, S * n, comm=rail,
                                   run_async=True),
        ]
        return self._launch_hier_stages("allgather", stages, run_async,
                                        "allgather")

    def _hier_reduce_scatter(self, comm: Communicator, sendbuf: BaseBuffer,
                             recvbuf: BaseBuffer, n: int,
                             function: ReduceFunction,
                             run_async: bool) -> Request:
        """Hierarchical reduce-scatter (symmetric contiguous topology):
        the W send blocks permuted
        (:func:`~accl_tpu_torch.hierarchical.reduce_scatter_permutation`:
        chunk s*S+i goes through intra block i and rail block s) by one
        ``index_select`` on the operand's device -> intra-slice
        reduce-scatter over L*n-element blocks -> rail reduce-scatter
        over n-element blocks; every rank lands its own reduced chunk."""
        topo = comm.topology
        st = self._hier_state(comm)
        me = comm.local_rank
        sl = topo.slice_of(me)
        li = topo.local_index(me)
        L, S = topo.num_slices, len(topo.slices[0])
        W = L * S
        intra = self._hier_subcomm(comm, st, ("intra", sl),
                                   topo.slice_members(sl))
        rail = self._hier_subcomm(comm, st, ("rail", li), topo.rail(li))
        if isinstance(sendbuf, DeviceBuffer):
            sendbuf.resolve_pending()
        src = sendbuf.tensor[:W * n]
        dev = self.engine.device
        _wait_operands(src.device, [sendbuf])
        if src.device != dev:  # a host-only operand crosses first
            src = src.to(dev)
        idx = st.get("perm")
        if idx is None:
            idx = torch.tensor(_hier.reduce_scatter_permutation(topo),
                               dtype=torch.int64).to(dev)
            st["perm"] = idx
        staged = self._scratch(sendbuf.dtype, W * n)
        torch.index_select(src.view(W, n), 0, idx,
                           out=staged.tensor.view(W, n))
        staged.ready = _record_event(dev)
        self.engine.gang.interactions.bump()  # the permutation's launch
        scratch = self._scratch(sendbuf.dtype, L * n)
        stages = [
            lambda: self.reduce_scatter(staged, scratch, L * n,
                                        function=function, comm=intra,
                                        run_async=True),
            lambda: self.reduce_scatter(scratch, recvbuf, n,
                                        function=function, comm=rail,
                                        run_async=True),
        ]
        return self._launch_hier_stages("reduce_scatter", stages, run_async,
                                        "reduce_scatter")

    def _hier_bcast(self, comm: Communicator, buf: BaseBuffer, n: int,
                    root: int, run_async: bool) -> Request:
        """Hierarchical bcast (any multi-slice topology): bcast over one
        representative a slice (the root in its own, the leader
        elsewhere), then within each slice from its representative."""
        topo = comm.topology
        st = self._hier_state(comm)
        me = comm.local_rank
        sl = topo.slice_of(me)
        members = list(topo.slice_members(sl))
        reps = _hier.bcast_representatives(topo, root)
        my_rep = int(root) if sl == topo.slice_of(root) else members[0]
        rep_idx = members.index(my_rep)
        intra = self._hier_subcomm(comm, st, ("intra", sl), members)

        def _s1():
            if me not in reps:
                return None
            cross = self._hier_subcomm(comm, st, ("bcast", root), reps)
            return self.bcast(buf, n, root=reps.index(int(root)), comm=cross,
                              run_async=True)

        def _s2():
            if intra.size == 1:
                return None
            return self.bcast(buf, n, root=rep_idx, comm=intra,
                              run_async=True)

        return self._launch_hier_stages("bcast", [_s1, _s2], run_async,
                                        "bcast")

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
        host = self._host_flags(buf, None, buf)
        plan = self._plan_for(Operation.BCAST, comm, buf.dtype, n,
                              compress_dtype, host, (root,))
        if self._hier_eligible_call(plan, comm, compress_dtype, "bcast", n):
            return self._hier_bcast(comm, buf, n, root, run_async)
        nseg = self._pipeline_segments_for(plan, n, buf.dtype)
        if nseg > 1:
            return self._launch_pipelined(
                "bcast", n, nseg, run_async,
                lambda s0, s1: self.bcast(
                    buf.slice(s0, s1), s1 - s0, root=root, comm=comm,
                    compress_dtype=compress_dtype, run_async=True),
                "bcast")
        return self._planned(Operation.BCAST, comm, n, buf.dtype,
                             compress_dtype, run_async, "bcast", (root,),
                             plan=plan, root_src=root, op0=buf, res=buf)

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
        return self._planned(Operation.SCATTER, comm, n, recvbuf.dtype,
                             compress_dtype, run_async, "scatter", (root,),
                             root_src=root, op0=sendbuf, res=recvbuf)

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
        return self._planned(Operation.GATHER, comm, n, sendbuf.dtype,
                             compress_dtype, run_async, "gather", (root,),
                             root_src=root, op0=sendbuf, res=recvbuf)

    def allgather(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                  count: Optional[int] = None,
                  comm: Optional[Communicator] = None, compress_dtype=None,
                  run_async: bool = False):
        comm = comm or self._world
        n = self._count_of(sendbuf, count)
        host = self._host_flags(sendbuf, None, recvbuf)
        plan = self._plan_for(Operation.ALLGATHER, comm, sendbuf.dtype, n,
                              compress_dtype, host)
        if self._hier_eligible_call(plan, comm, compress_dtype, "allgather",
                                    n):
            return self._hier_allgather(comm, sendbuf, recvbuf, n, run_async)
        return self._planned(Operation.ALLGATHER, comm, n, sendbuf.dtype,
                             compress_dtype, run_async, "allgather",
                             plan=plan, op0=sendbuf, res=recvbuf)

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
        return self._planned(
            Operation.REDUCE, comm, n, op_dtype, compress_dtype, run_async,
            "reduce", (root, int(function), int(stream)), seeded=True,
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
        ``compress_dtype`` the ``wire_dtype`` registers pick the wire.  On
        a multi-slice topology with ``hierarchical`` set the call runs as
        stages; above ``pipeline_threshold`` bytes as segments."""
        comm = comm or self._world
        n = self._count_of(sendbuf, count)
        host = self._host_flags(sendbuf, None, recvbuf)
        # the plan carries the wire_dtype register's verdict
        plan = self._plan_for(Operation.ALLREDUCE, comm, sendbuf.dtype, n,
                              compress_dtype, host, (int(function),))
        # the hierarchical check first, then the split: the stages are
        # plain calls on the derived subcomms and may split there
        if self._hier_eligible_call(plan, comm, compress_dtype, "allreduce",
                                    n):
            return self._hier_allreduce(comm, sendbuf, recvbuf, n, function,
                                        run_async)
        nseg = self._pipeline_segments_for(plan, n, sendbuf.dtype)
        if nseg > 1:
            return self._launch_pipelined(
                "allreduce", n, nseg, run_async,
                lambda s0, s1: self.allreduce(
                    sendbuf.slice(s0, s1), recvbuf.slice(s0, s1), s1 - s0,
                    function=function, comm=comm,
                    compress_dtype=compress_dtype, run_async=True),
                "allreduce")
        wire = plan.wire_dtype
        seed = self._derive_wire_seed(comm, Operation.ALLREDUCE, wire)
        staged = self._error_feedback_operand(comm, sendbuf, n, function,
                                              wire, seed)
        opts = CallOptions(
            op=Operation.ALLREDUCE, comm=comm, count=n,
            reduce_function=function, arithcfg=plan.arithcfg,
            compression=plan.compression, host=host,
            op0=sendbuf if staged is None else staged, res=recvbuf,
            plan=plan, tuning=plan.tuning, wire_seed=seed)
        return self._launch(opts, run_async, "allreduce")

    def reduce_scatter(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                       count: Optional[int] = None,
                       function: ReduceFunction = ReduceFunction.SUM,
                       comm: Optional[Communicator] = None,
                       compress_dtype=None, run_async: bool = False):
        """``count`` is the per-rank RESULT count (``sendbuf`` holds
        size * count)."""
        comm = comm or self._world
        n = self._count_of(recvbuf, count)
        host = self._host_flags(sendbuf, None, recvbuf)
        plan = self._plan_for(Operation.REDUCE_SCATTER, comm, recvbuf.dtype,
                              n, compress_dtype, host, (int(function),))
        if self._hier_eligible_call(plan, comm, compress_dtype,
                                    "reduce_scatter", n):
            return self._hier_reduce_scatter(comm, sendbuf, recvbuf, n,
                                             function, run_async)
        return self._planned(Operation.REDUCE_SCATTER, comm, n,
                             recvbuf.dtype, compress_dtype, run_async,
                             "reduce_scatter", (int(function),), seeded=True,
                             plan=plan, reduce_function=function,
                             op0=sendbuf, res=recvbuf)

    def alltoall(self, sendbuf: BaseBuffer, recvbuf: BaseBuffer,
                 count: Optional[int] = None,
                 comm: Optional[Communicator] = None, compress_dtype=None,
                 run_async: bool = False):
        """Block transpose: rank r's block p of ``recvbuf`` is rank p's
        block r of ``sendbuf``.  ``count`` is the elements per block
        (``sendbuf.count // size`` by default)."""
        comm = comm or self._world
        n = sendbuf.count // comm.size if count is None else int(count)
        return self._planned(Operation.ALLTOALL, comm, n, sendbuf.dtype,
                             compress_dtype, run_async, "alltoall",
                             op0=sendbuf, res=recvbuf)

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
        """Plan (the fuse folded into the key: a fused plan never aliases
        its plain base op's) and launch a fused slot; the uncompressed
        wire."""
        return self._planned(
            op, comm, n, recvbuf.dtype, None, run_async, context,
            (int(function), "fuse", int(fuse)), reduce_function=function,
            root_src=root_src, op0=sendbuf, res=recvbuf, fuse=int(fuse),
            fuse_param=float(fuse_param))

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
            with self._hop_lock:
                self._initialized = False  # a later hop fails its aggregate
                if self._hop_q is not None:
                    self._hop_q.put(None)  # stops the stage thread
                    self._hop_q = None


def cuda_group(n: int, device=None, **accl_kwargs) -> List[ACCL]:
    """N rank handles whose buffers share one device — on the card unless
    ``device`` asks for another (tests pass ``device="cpu"``); raises when
    there is no CUDA device to run on.  ``accl_kwargs`` go to every
    handle (``topology=``, ``timeout_s=``, ``max_eager_size=``, ...)."""
    dev = resolve_device(device)
    gang = CudaGangContext(dev)
    ranks = [Rank(address=f"{dev}:{i}", session=i) for i in range(n)]
    return [
        ACCL(CudaEngine(gang, dev, session=i), ranks, i, **accl_kwargs)
        for i in range(n)
    ]
