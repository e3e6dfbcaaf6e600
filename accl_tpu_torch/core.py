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

The telemetry plane (``accl_tpu_torch.telemetry``): every call gets a
flight record at completion (op, communicator, dtype, sizes, the plan's
verdicts, its causal trace id and parent), a pipelined or hierarchical
call one for the aggregate beside its stages' own, and a failure carries
the recorder's tail in its ``ACCLError``.  :meth:`ACCL.telemetry_snapshot`
merges it with the engine's counters and the command ring's window log;
:meth:`ACCL.export_chrome_trace` writes the rank's Perfetto trace
(``python -m accl_tpu_torch.telemetry merge`` folds the ranks' files);
the monitor plane (``accl_tpu_torch.monitor``) keeps a skew tracker and
an anomaly watchdog on every record and serves ``/metrics``,
``/snapshot``, ``/trace`` and ``/cmdring`` from :meth:`ACCL.start_monitor`
(or ``ACCL_MONITOR_PORT``), and streams trace files under
``ACCL_TRACE_STREAM``.  ``ACCL_TELEMETRY=0`` turns the plane off.

The fault planes (``accl_tpu_torch.faults``, ``.contract``,
``.membership``): a gang call whose peer never posts fails with
RECEIVE_TIMEOUT at the timeout and strikes the peer, a dead peer fails
later calls at intake (``capabilities()["health"]``,
:meth:`ACCL.dump_communicator`), and :meth:`ACCL.soft_reset` (collective)
recovers.  :meth:`ACCL.set_contract_verify` (or ``ACCL_VERIFY=1``)
fingerprints every collective and convicts a diverging rank with
CONTRACT_VIOLATION before it hangs its peers.  :meth:`ACCL.set_elastic`
(or ``ACCL_ELASTIC=1``) turns a dead verdict into an eviction the
survivors agree on: their calls fail once with RANK_EVICTED, they serve
at the smaller size, and ``soft_reset`` restores the full membership;
:meth:`ACCL.evict_rank` and :meth:`ACCL.join_rank` are the operator's
levers.  Under ``ACCL_POSTMORTEM_DIR`` a structured failure writes an
evidence bundle (``monitor.BlackBox``).

The overlap and QoS planes (``accl_tpu_torch.overlap``, ``.arbiter``): a
request completes when its device work has ended, through the gang's
in-flight window (:meth:`ACCL.set_inflight_window`, ``flush()`` drains
it); :meth:`ACCL.set_arbiter` (or ``ACCL_ARBITER=1``) arms the
deficit-weighted round-robin admission of registered tenants
(:meth:`ACCL.set_tenant_class`, :meth:`ACCL.set_tenant_quota`: a window
share, a ring slot budget, a bytes/s cap), whose snapshot is
``telemetry_snapshot()["tenants"]`` and the monitor's ``/tenants``.

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
import weakref
import zlib
from typing import List, Optional, Sequence

import torch

from . import arbiter as _arb
from . import hierarchical as _hier
from . import membership as _mbr
from . import monitor as _monitor
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
from .contract import (
    ContractVerifier,
    anchored,
    board_for,
    env_enabled as _verify_env,
    verdict_context,
)
from .errorfeedback import ResidualStore
from .faults import HealthTransitions
from .telemetry import (
    SCHEMA_VERSION,
    Telemetry,
    chrome_trace,
    collective_trace_id,
    p2p_trace_id,
    to_json,
    to_prometheus,
    wire_snapshot,
)
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


def _deepest(reqs) -> Optional[int]:
    """The largest in-flight window depth among an aggregate's sub-calls
    (None when none rode the window), as the JAX facade records it."""
    depths = [q.inflight_depth for q in reqs if q.inflight_depth]
    return max(depths) if depths else None


def _weak(method):
    """``method`` held weakly: the callback does nothing (None) once its
    handle is gone."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        bound = ref()
        return None if bound is None else bound(*args, **kwargs)

    return call


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
        # segment being launched on this thread (never decomposed again),
        # the plan verdict of the call being launched and its parent's
        # trace id (thread-local: concurrent callers on one handle must
        # not swap each other's)
        self._call_tls = threading.local()
        # the telemetry plane: flight recorder and metrics (None under
        # ACCL_TELEMETRY=0), and the monitor plane on it: the skew tracker
        # and anomaly watchdog on every record, the gang's rank handles
        # meeting on one judge anchored on the gang context
        self._telemetry = Telemetry.create(rank=local_rank,
                                           tier=type(engine).__name__)
        self._monitor = None
        if self._telemetry is not None:
            self._monitor = _monitor.Monitor(
                rank=local_rank, world=len(ranks),
                telemetry=self._telemetry,
                anchor=engine.contract_anchor(),
                tier=type(engine).__name__)
            self._monitor.tracker.begin_comm(self._world.id, local_rank,
                                             len(ranks))
            engine.set_skew_tracker(self._monitor.tracker)
        # the contract plane (accl_tpu_torch.contract): the opt-in
        # cross-rank verifier, armed by ACCL_VERIFY=1 or
        # set_contract_verify(); every collective is fingerprinted into a
        # per-comm digest the ranks compare on the gang's board
        self._contract: Optional[ContractVerifier] = None
        # the membership plane (accl_tpu_torch.membership): always-on
        # sensing (health transitions, the membership snapshot); the
        # acting half (shrink on a dead verdict, straggler demotion)
        # arms by ACCL_ELASTIC=1 or set_elastic().  The agreement rides
        # the gang's shared board.
        anchor = engine.contract_anchor()
        self._membership = _mbr.MembershipView(
            rank=ranks[local_rank].session, world=len(ranks),
            board=_mbr.board_for(anchor), ledger=_mbr.ledger_for(anchor),
            send_fn=None)  # the board exchanges; the gang has no wire
        self._membership.elastic = _mbr.env_elastic()
        # the planes a handle owns, and the gang it shares, call back
        # into it through weak methods: no reference cycle keeps a
        # dropped handle (and its buffers) alive until a full collection
        self._membership.handoff_fn = _weak(self._membership_handoff)
        self._health_events = HealthTransitions()
        self._demote_seq: dict = {}  # comm id -> routing call index
        self._demoted_seen: set = set()  # (comm, rank) demotions counted
        engine.set_membership(self._membership)
        engine.on_health_transition = _weak(self._on_health_transition)
        # the QoS arbiter plane (accl_tpu_torch.arbiter): one arbiter a
        # gang (every rank handle meets on one grant order and one
        # decision latch); registrations and quotas are always taken, the
        # acting half (DRR queueing, throttles) arms by ACCL_ARBITER=1 or
        # set_arbiter().  The per-comm admission index keys the latch, and
        # this handle is one owner of the per-rank window-share bound
        self._arbiter = _arb.arbiter_for(anchor) or _arb.QosArbiter()
        if _arb.env_arbiter():
            self._arbiter.armed = True
        self._arbiter_seq: dict = {}
        self._arbiter_owner = ranks[local_rank].session
        self._arbiter_exchange_ctr = 0
        if (_arb.env_ledger() and self._arbiter.ledger is None
                and hasattr(engine, "arbiter_kv")):
            # the cross-process tenant registry, on a tier with a KV plane
            self._arbiter.attach_ledger(_arb.TenantLedger(
                process_key=f"proc-{ranks[local_rank].session}"))
        # the postmortem plane (monitor.BlackBox): an evidence bundle on a
        # structured failure (CONTRACT_VIOLATION, RANK_EVICTED,
        # DEADLOCK_SUSPECTED, a failed ring window), written only under
        # ACCL_POSTMORTEM_DIR; the gang's rank handles solicit each other
        # over a registry anchored on the gang
        self._blackbox = None
        if self._telemetry is not None:
            pm_registry = anchored(anchor, "_accl_blackbox_registry", dict)
            session = ranks[local_rank].session
            if pm_registry is not None:
                pm_registry[session] = _weak(self._postmortem_evidence)
            self._blackbox = _monitor.BlackBox(
                rank=session, world=len(ranks),
                evidence_fn=_weak(self._postmortem_evidence),
                peers_fn=((lambda reg=pm_registry: reg)
                          if pm_registry is not None else None),
                metrics=self._telemetry.metrics)
            self._ring_hook = _weak(self._on_ring_failure)
            engine.gang.cmdring.on_failure = self._ring_hook
        # the causal trace plane: per-comm collective sequence counters
        # and directed p2p channel counters (every rank advances them
        # alike, so every rank of a call derives the same id), the
        # generation (re-keyed by soft_reset), the latest id per comm,
        # and the open batch's parent id
        self._trace_seq: dict = {}
        self._p2p_seq: dict = {}
        self._trace_gen = 1
        self._trace_last: dict = {}
        self._batch_trace = None
        self._batch_ctr = 0
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
        if _verify_env():
            self.set_contract_verify(True)
        if self._monitor is not None:
            if _monitor.env_port() is not None:
                try:
                    self.start_monitor()
                except OSError as e:
                    # in-process ranks race for one port: the first
                    # handle serves, the rest say so and skip (pass
                    # port=0 or a port a rank to serve them all)
                    import sys

                    print(f"[accl] monitor port busy, not serving rank "
                          f"{local_rank}: {e}", file=sys.stderr)
            tdir = os.environ.get(_monitor.TRACE_STREAM_ENV)
            if tdir:
                try:
                    self._monitor.start_trace_stream(tdir)
                except OSError as e:  # a bad dir must not brick startup
                    import sys

                    print(f"[accl] ignoring ACCL_TRACE_STREAM={tdir!r}: "
                          f"{e}", file=sys.stderr)
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
            raise self._deadlock_error(f"config {fn.name}")
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

    # -- recovery (the reference's soft_reset) -------------------------------
    def soft_reset(self) -> None:
        """Abandon stale engine state after a failed or timed-out
        collective (the reference's ``ACCL::soft_reset``,
        accl.cpp:57-89).  Collective by contract: every rank handle calls
        it, with nothing in flight, before any rank resumes work.  RESET
        of 1 makes the gang drain its device work and clear its slots,
        sequence numbers and health map; the facade then restores an
        elastic shrink's full membership (a fresh epoch), clears the
        demotions and the arbiter's latched decisions, realigns every
        per-comm counter (the wire seeds, the admission indices, the
        communicators' sequences, the contract digests, the skew
        baselines) and re-keys the trace plane's ids.  The in-flight
        window is drained first (``_config`` flushes, and RESET drains
        the gang), so nothing launched before it is in flight after."""
        self._config(ConfigFunction.RESET, 1)
        # the membership plane: soft_reset is the restore point (every
        # evicted rank re-admitted, a fresh epoch), collective like the
        # reset itself
        restored = self._membership.restore()
        if restored is not None:
            for comm in self._communicators:
                if comm.restore() and self._contract is not None:
                    self._contract.begin_comm(
                        comm.id, comm.local_rank,
                        tuple(r.session for r in comm.ranks), fresh=False)
            self.engine.on_membership_restore()
            self._plans.invalidate("membership_restore")
            for s in restored.get("readmitted", ()):
                self._health_events.note(s, "evicted", "restored")
        elif self._membership.ledger is not None:
            # demotion-only state clears too: the demote counter restarts
            # at 0 below, and a stale latched decision must not replay
            self._membership.ledger.reset()
        self._demote_seq.clear()
        self._demoted_seen.clear()
        # the arbiter: the admission indices restart with the rest of the
        # sequence space, so the latched decisions go with them (a stale
        # throttle must not replay); registrations and quotas survive
        self._arbiter_seq.clear()
        self._arbiter.reset_ledger()
        self._wire_ctr.clear()
        for comm in self._communicators:
            comm.reset_sequences()
        if self._contract is not None:
            # verdicts clear and a fresh digest generation starts
            self._contract.reset()
        if self._monitor is not None:
            # skew baselines and standing verdicts belong to the old
            # regime; the memberships survive
            self._monitor.reset()
            for comm in self._communicators:
                self._monitor.tracker.begin_comm(comm.id, comm.local_rank,
                                                 comm.size)
        # the trace plane: a new generation re-keys every id (collective,
        # so ids keep matching across ranks), and the postmortem latches
        # clear
        self._trace_gen += 1
        self._trace_seq.clear()
        self._p2p_seq.clear()
        self._trace_last.clear()
        if self._blackbox is not None:
            self._blackbox.reset()

    def set_inflight_window(self, depth: int) -> None:
        """Size the gang's per-communicator in-flight window: up to
        ``depth`` launched calls of a communicator may be in flight before
        a launch waits for the oldest (default
        :data:`~accl_tpu_torch.constants.DEFAULT_INFLIGHT_WINDOW`, or
        ``ACCL_INFLIGHT_WINDOW`` read when the gang is made).  The write
        is a drain point: nothing launched under the old depth is in
        flight when it returns."""
        self._config(ConfigFunction.SET_INFLIGHT_WINDOW, int(depth))

    def set_retry_policy(self, limit: int, backoff_s: float = 0.05) -> None:
        """The retransmit policy of the JAX package's emulated tiers; the
        gang validates the knobs and keeps neither (its ranks share a
        device, so there is no host retransmit)."""
        self._config(ConfigFunction.SET_RETRY_LIMIT, limit)
        self._config(ConfigFunction.SET_RETRY_BACKOFF, backoff_s)

    # -- the contract plane (accl_tpu_torch.contract) ------------------------
    def set_contract_verify(self, enabled: bool = True,
                            interval: Optional[int] = None
                            ) -> Optional[ContractVerifier]:
        """Arm (or with ``enabled=False`` disarm) the cross-rank contract
        verifier on this handle.  Collective by contract: every rank arms
        it at the same point of its sequence with the same ``interval``
        (default ``ACCL_VERIFY_INTERVAL``, 8).  Facade-local: no config
        write, no device work; a call costs one crc32 and a ring append,
        and every ``interval`` calls one board post."""
        if not enabled:
            v, self._contract = self._contract, None
            if v is not None:
                self.engine.set_contract_verifier(None)
                v.close()
            return None
        if self._contract is not None:
            if interval is None or interval == self._contract.interval:
                return self._contract
            self.set_contract_verify(False)
        tel = self._telemetry
        v = ContractVerifier(
            rank=self._world.local_rank, world=self._world.size,
            interval=interval,
            board=board_for(self.engine.contract_anchor()),
            tail_fn=tel.tail_dicts if tel is not None else None,
            health_fn=lambda: self.engine.health_report(self._world))
        self._contract = v
        self.engine.set_contract_verifier(v)
        # each comm's rank space (comm-relative blame), registered without
        # a begin marker: arming is not a new comm instance
        for comm in self._communicators:
            v.begin_comm(comm.id, comm.local_rank,
                         tuple(r.session for r in comm.ranks), fresh=False)
        return v

    def _contract_error(self, verdict: dict, context: str) -> ACCLError:
        details = verdict_context(verdict, context)
        if self._telemetry is not None:
            details["flight_recorder"] = self._telemetry.tail_dicts()
        return self._structured_failure(ACCLError(
            ErrorCode.CONTRACT_VIOLATION, context, details=details))

    def _contract_gate(self, options: CallOptions, context: str) -> None:
        """The contract plane at intake: fingerprint the collective into
        its comm's digest (exchanging at window boundaries) and fail
        before dispatch on a standing verdict."""
        c = self._contract
        if (c is None or options.comm is None
                or options.op not in self._CONTRACT_OPS):
            return
        cfg = options.arithcfg
        opname = options.op.name.lower()
        if options.fuse:
            # a fused call diverges from its plain base op
            opname += f".fused{int(options.fuse)}"
        verdict = c.record(
            op=opname, comm_id=options.comm.id,
            dtype=cfg.uncompressed.name if cfg is not None else None,
            count=options.count,
            root=f"{options.root_src}/{options.root_dst}",
            tag=options.tag)
        if verdict is not None:
            raise self._contract_error(verdict, context)

    def _hier_fingerprint(self, op_name: str, comm: Communicator,
                          dtype: DataType, count: int, root: int = 0,
                          context: str = "") -> None:
        """The contract record of a hierarchical call on its PARENT comm
        (op ``"<op>.hier"``): a rank going flat where its peers went
        hierarchical diverges within one window; the stages fingerprint
        on their subcomms as any call does."""
        c = self._contract
        if c is None:
            return
        verdict = c.record(op=f"{op_name}.hier", comm_id=comm.id,
                           dtype=dtype.name, count=count,
                           root=f"{root}/0", tag=0)
        if verdict is not None:
            raise self._contract_error(verdict, context or op_name)

    # -- the membership plane (accl_tpu_torch.membership) --------------------
    def set_elastic(self, enabled: bool = True) -> None:
        """Arm (or disarm) elastic membership: a ``dead`` health verdict
        proposes eviction, a confirmed majority shrinks the communicators
        at the next call boundary and the group serves at the new size,
        and convicted stragglers are demoted out of the barrier's root.
        Collective by contract (a lone elastic rank would shrink alone).
        Also read from ``ACCL_ELASTIC=1`` at construction."""
        self._membership.elastic = bool(enabled)

    def evict_rank(self, rank: int, comm: Optional[Communicator] = None):
        """Propose evicting ``rank`` (comm-relative in ``comm``, the world
        by default): the operator's lever.  Collective by contract: every
        survivor calls it; the eviction confirms by strict majority and
        this call applies the cutover.  Returns the applied plan, or None
        when confirmation did not arrive within ``ACCL_EVICT_CONFIRM_S``
        (the proposal stands)."""
        comm = comm or self._world
        self._check_rank(comm, rank)
        session = comm.ranks[rank].session
        mv = self._membership
        if session == self._world.ranks[self._world.local_rank].session:
            mv.propose({session}, reason="evict_rank_self")
            raise self._structured_failure(ACCLError(
                ErrorCode.RANK_EVICTED, "evict_rank",
                details={"membership": mv.evidence(), "rank": rank}))
        mv.propose({session}, reason="evict_rank")
        plan = mv.wait_confirmed(timeout=_mbr.env_confirm_s())
        if plan is None:
            return None
        self._apply_cutover()
        return plan

    def suggest_root(self, comm: Optional[Communicator] = None) -> int:
        """The lowest comm-relative rank not demoted as a straggler (the
        gang's shared ledger holds the demotions): the advisory root for
        callers that pick their own.  0 when nothing is demoted."""
        comm = comm or self._world
        demoted = set(self._membership.demoted(comm.id))
        if self._membership.ledger is None and self._monitor is not None:
            demoted |= set(self._monitor.slow_ranks(comm.id))
        for r in range(comm.size):
            if r not in demoted:
                return r
        return 0

    def join_rank(self, timeout: Optional[float] = None):
        """The candidate's side of elastic expansion: petition the group
        for admission, wait (bounded, ``ACCL_JOIN_CONFIRM_S``) for the
        strict-majority confirm, and cut over to the grown membership,
        adopting the group's warm-handoff artifacts (contract baselines,
        tuning plan, plan verdicts).  Survivors apply their half at their
        next call boundary.  Returns the applied join record, or None
        when no confirm arrived in time (the petition stands)."""
        mv = self._membership
        if not mv.elastic:
            raise ACCLError(
                ErrorCode.INVALID_OPERATION,
                "join_rank needs elastic membership "
                "(ACCL_ELASTIC=1 / set_elastic())",
                details={"op": "join_rank"})
        mv.petition_join()
        plan = mv.wait_confirmed(
            timeout=_mbr.env_join_s() if timeout is None else timeout)
        if plan is None or plan.get("kind") != "join":
            return None
        return self._apply_cutover()

    def join_decision(self) -> dict:
        """The latest APPLIED join record, identical on every member:
        safe to branch a collective sequence on."""
        return self._membership.join_decision()

    def _membership_handoff(self) -> dict:
        """The warm-handoff artifacts a join's confirm carries to the
        candidate: the contract baselines, the tuning plan, the plan
        verdicts, the trace generation and the wire-seed counters."""
        return {
            "contract": (self._contract.export_handoff()
                         if self._contract is not None else None),
            "tuning_plan": (self._tuning_plan.to_json()
                            if self._tuning_plan is not None else None),
            "plan_verdicts": self._plans.export_verdicts(),
            "trace_gen": self._trace_gen,
            "wire_ctr": {str(k): v for k, v in self._wire_ctr.items()},
        }

    def _on_health_transition(self, peer, old: str, new: str) -> None:
        """The gang's health-transition hook (its watchdog's thread):
        record the edge, and under elastic membership turn a fresh
        ``dead`` into an eviction proposal."""
        self._health_events.note(peer, old, new)
        mv = self._membership
        if new != "dead" or not mv.elastic:
            return
        session = int(peer)
        if session in mv.evicted:
            return
        mv.propose({session}, reason=f"health:{old}->dead",
                   evidence={"peer": str(peer), "event": f"{old}->dead"})

    def _apply_cutover(self) -> Optional[dict]:
        """Cut over to the confirmed plan (one-shot: ``take_cutover``):
        drain the device work, shrink every communicator that held an
        evicted session (a fresh epoch), fold the ``__shrink__`` marker
        into the contract digests, re-register the skew tracker's rank
        spaces and let the gang drop its ring sessions.  A self-evicted
        handle only marks."""
        mv = self._membership
        plan = mv.take_cutover()
        if plan is None:
            return None
        if plan.get("kind") == "join":
            return self._apply_join(plan)
        evicted = set(plan["evict"])
        if mv.self_evicted:
            return plan
        self.engine.drain_inflight()
        shrunk = []
        for comm in self._communicators:
            sessions = [r.session for r in comm.ranks]
            if not evicted & set(sessions):
                continue
            keep = [i for i, s in enumerate(sessions) if s not in evicted]
            if comm.shrink(keep) is None:
                continue
            shrunk.append(comm.id)
            self.engine.gang.realign(comm.id, comm.local_rank)
            if self._contract is not None:
                self._contract.shrink_comm(
                    comm.id, comm.local_rank,
                    tuple(r.session for r in comm.ranks), plan["epoch"])
            if self._monitor is not None:
                self._monitor.tracker.begin_comm(comm.id, comm.local_rank,
                                                 comm.size)
        self.engine.on_membership_cutover(plan, comm_ids=tuple(shrunk))
        # no plan of the old membership may serve the shrunk one
        self._plans.invalidate("membership_shrink")
        for s in plan["evict"]:
            self._health_events.note(s, "dead", "evicted")
        if self._telemetry is not None:
            self._telemetry.metrics.inc("accl_membership_evictions_total")
        if self._blackbox is not None:
            # one bundle an eviction, latched on the membership epoch
            self._blackbox.capture(
                "RANK_EVICTED", "membership_cutover",
                details={"plan": plan},
                key=("RANK_EVICTED", self._membership.epoch))
        return plan

    def _apply_join(self, plan: dict) -> dict:
        """Apply a consumed JOIN record: grow every communicator that knew
        an admitted session (original slots, a fresh epoch), migrate the
        survivors' error-feedback residuals to it, rebase the contract
        digests on the handoff's baseline with the ``__join__`` marker,
        re-register the skew tracker, and re-arm the gang.  The candidate
        also adopts the handoff's artifacts."""
        mv = self._membership
        admit = {int(s) for s in plan.get("admit") or ()}
        local_session = self._world.ranks[self._world.local_rank].session
        candidate = local_session in admit
        handoff = plan.get("handoff") or {}
        self.engine.drain_inflight()
        cdoc = handoff.get("contract") or {}
        grown = []
        for comm in self._communicators:
            known = ({r.session for r in comm._full_ranks or ()}
                     | {r.session for r in comm.ranks})
            hit = admit & known
            if not hit:
                continue
            old_epoch = comm.epoch
            comm.grow(hit)
            grown.append(comm.id)
            self.engine.gang.realign(comm.id, comm.local_rank)
            if not candidate:
                # the candidate's own residuals are stale by its absence
                self._residuals.migrate_epoch(comm.id, old_epoch,
                                              comm.epoch)
            if self._contract is not None:
                entry = (cdoc.get("comms") or {}).get(str(comm.id))
                base = (None if entry is None
                        else (entry.get("calls", 0), entry.get("digest", 0)))
                self._contract.join_comm(
                    comm.id, comm.local_rank,
                    tuple(r.session for r in comm.ranks),
                    plan.get("applied_epoch", mv.epoch), base=base)
            if self._monitor is not None:
                self._monitor.tracker.begin_comm(comm.id, comm.local_rank,
                                                 comm.size)
        if candidate:
            # adopt the group's artifacts before the pool clears, so the
            # first window meets the verdicts and generation it runs
            if (self._contract is not None
                    and cdoc.get("generation") is not None):
                self._contract.adopt_generation(cdoc["generation"])
            tp = handoff.get("tuning_plan")
            if tp:
                try:
                    from .tuning import TuningPlan

                    self.load_tuning_plan(TuningPlan.from_json(tp),
                                          strict=False)
                except Exception:  # a stale plan must never fail a join
                    pass
            try:
                self._wire_ctr.update(
                    {int(k): int(v)
                     for k, v in (handoff.get("wire_ctr") or {}).items()})
            except (TypeError, ValueError):
                pass
            gen = handoff.get("trace_gen")
            if isinstance(gen, int) and gen > self._trace_gen:
                self._trace_gen = gen
        self.engine.on_membership_cutover(plan, comm_ids=tuple(grown))
        # "membership_join" keeps the migrated residuals
        self._plans.invalidate("membership_join")
        if candidate:
            self._plans.adopt_verdicts(handoff.get("plan_verdicts"))
        for s in sorted(admit):
            self._health_events.note(s, "evicted", "joined")
        if self._telemetry is not None:
            self._telemetry.metrics.inc("accl_membership_joins_total")
        return plan

    def _membership_report(self) -> dict:
        """``telemetry_snapshot()["membership"]`` and the ``/membership``
        route: the elastic state machine's snapshot and the scale
        advisor's advisory recommendation, read from the arbiter's
        per-tenant latency histograms (``hot_tenants``)."""
        doc = self._membership.snapshot()
        doc["scale_advice"] = (
            self._monitor.scale_advice(self._arbiter.snapshot(),
                                       self._world.size)
            if self._monitor is not None else None)
        return doc

    def _membership_intake(self, options: CallOptions, context: str) -> None:
        """Before dispatch: apply a cutover confirmed between calls (every
        survivor applies it before its next collective), and fail a
        self-evicted handle's comm calls fast."""
        mv = self._membership
        comm = options.comm
        if comm is None:
            return
        if mv.self_evicted and (
                options.op in self._CONTRACT_OPS
                or options.op in (Operation.SEND, Operation.RECV)):
            raise self._structured_failure(ACCLError(
                ErrorCode.RANK_EVICTED, context,
                details={"membership": mv.evidence(), "comm": comm.id}))
        if mv.elastic and mv.cutover_ready() and self._pending is None:
            self._apply_cutover()

    def _membership_after_failure(self, options: CallOptions, req: Request,
                                  context: str) -> None:
        """After a synchronous call failed: a timeout during an eviction
        waits (bounded) for the confirm, applies the cutover and raises
        RANK_EVICTED, so every survivor fails the same call and resumes
        aligned at the new size.  Other failures pass through."""
        mv = self._membership
        if not mv.elastic or options.comm is None:
            return
        code = req.get_retcode()
        if code & ErrorCode.RANK_EVICTED:
            self._apply_cutover()
            return
        if not code & (ErrorCode.SEND_TIMEOUT | ErrorCode.RECEIVE_TIMEOUT):
            return
        if not mv.proposing():
            return
        plan = mv.wait_confirmed(timeout=_mbr.env_confirm_s())
        if plan is None:
            return  # unconfirmed: the raw timeout surfaces
        self._apply_cutover()
        details = {"membership": mv.evidence(), "comm": options.comm.id,
                   "op": options.op.name}
        if self._telemetry is not None:
            details["flight_recorder"] = self._telemetry.tail_dicts()
        raise self._structured_failure(ACCLError(
            ErrorCode.RANK_EVICTED, context, details=details))

    def _barrier_root(self, comm: Communicator) -> int:
        """The barrier's gather root, routed around demoted stragglers:
        decided from the shared judge's verdict and latched per (comm,
        call index) on the shared ledger, so every rank reads the same
        root.  0 unless elastic with a shared judge."""
        mv = self._membership
        if (not mv.elastic or mv.ledger is None or self._monitor is None
                or not self._monitor.tracker.shared_judge):
            return 0
        seq = self._demote_seq.get(comm.id, 0)
        self._demote_seq[comm.id] = seq + 1
        judge = self._monitor.tracker.judge
        slow = judge.slow_ranks(comm.id)
        candidates = mv.ledger.candidates(comm.id) | set(slow)
        recovered = {r: judge.recovered(comm.id, r)
                     for r in sorted(candidates)}
        decision = mv.demote_decision(comm.id, comm.size, seq, slow,
                                      recovered)
        metrics = self._telemetry.metrics if self._telemetry else None
        for r in decision.get("restored", ()):
            # re-admission lifts the standing verdict
            judge.clear_slow(comm.id, r)
            self._health_events.note(r, "demoted", "restored")
            if metrics is not None:
                metrics.inc("accl_membership_restores_total")
            self._demoted_seen.discard((comm.id, r))
        for r in decision.get("demoted", ()):
            if (comm.id, r) not in self._demoted_seen:
                self._demoted_seen.add((comm.id, r))
                self._health_events.note(r, "ok", "demoted")
                if metrics is not None:
                    metrics.inc("accl_membership_demotions_total")
        return int(decision.get("root", 0))

    # -- the postmortem plane (monitor.BlackBox) -----------------------------
    #: the structured failures that reach the BlackBox
    _POSTMORTEM_CODES = (ErrorCode.CONTRACT_VIOLATION
                         | ErrorCode.RANK_EVICTED
                         | ErrorCode.DEADLOCK_SUSPECTED)

    def _structured_failure(self, err: ACCLError) -> ACCLError:
        """The postmortem hook every covered failure passes: capture one
        evidence bundle (latched) and name it in
        ``details["postmortem"]``.  One flag check when the plane is
        off."""
        bb = self._blackbox
        if bb is None or not bb.enabled:
            return err
        if not err.code & self._POSTMORTEM_CODES:
            return err
        if err.code & ErrorCode.RANK_EVICTED:
            code_name = "RANK_EVICTED"
            # one bundle an eviction: keyed on the epoch it applies at
            mv = self._membership
            key = ("RANK_EVICTED",
                   mv.epoch + (1 if mv.cutover_ready() else 0))
        elif err.code & ErrorCode.CONTRACT_VIOLATION:
            code_name = "CONTRACT_VIOLATION"
            key = (code_name, err.details.get("comm"))
        else:
            code_name = "DEADLOCK_SUSPECTED"
            key = (code_name, self._trace_gen)
        path = bb.capture(code_name, context=str(err), details=err.details,
                          key=key)
        if path is not None:
            err.details["postmortem"] = path
        return err

    def _postmortem_evidence(self) -> dict:
        """This rank's evidence for a bundle: the flight recorder's tail
        and the merged snapshot (the ring's window log, the membership
        events, the skew baselines, the contract digests).  Bounded and
        side-effect-free: peers call it from their capture."""
        tel = self._telemetry
        return {
            "rank": self._world.local_rank,
            "session": self._world.ranks[self._world.local_rank].session,
            "tier": type(self.engine).__name__,
            "flight_recorder": tel.tail_dicts(64) if tel else [],
            "snapshot": self.telemetry_snapshot(),
        }

    def _on_ring_failure(self, comm_id: int, error: str) -> None:
        """The command ring's failure hook (a dispatch error or a run's
        failure latch): capture the ring's evidence."""
        if self._blackbox is not None:
            self._blackbox.capture(
                "RING_FAILURE", f"cmdring comm {comm_id}",
                details={"comm": comm_id, "error": error},
                key=("RING_FAILURE", comm_id))

    # -- the QoS arbiter plane (accl_tpu_torch.arbiter) ----------------------
    def set_arbiter(self, enabled: bool = True) -> None:
        """Arm (or disarm) the QoS arbiter this handle shares with its
        gang: registered tenants' collectives pass the deficit-weighted
        round-robin admission queue at intake, and quota throttles apply.
        Collective by contract: every rank arms it at the same point of
        its call sequence (admission delays are uniform per (comm, call
        index)).  Also read from ``ACCL_ARBITER=1`` at construction."""
        self._arbiter.armed = bool(enabled)

    def set_tenant_class(self, tenant_class, comm=None,
                         weight: Optional[int] = None,
                         name: Optional[str] = None):
        """Register communicator ``comm`` (default: the world) as a tenant
        with class ``tenant_class`` (:class:`~accl_tpu_torch.arbiter.
        TenantClass`, its name or its int) and an optional DRR ``weight``
        (default: the class's).  Collective by contract; the write rides
        a config write (a drain point).  Returns the tenant record."""
        comm = comm or self._world
        cls = _arb.coerce_class(tenant_class)
        self._config(ConfigFunction.SET_TENANT_CLASS, int(cls), key=comm.id)
        if weight is not None:
            self._config(ConfigFunction.SET_TENANT_WEIGHT, int(weight),
                         key=comm.id)
        return self._arbiter.register(comm.id, name=name, cls=cls,
                                      weight=weight, world=comm.size)

    def set_tenant_quota(self, comm=None,
                         window_share: Optional[int] = None,
                         ring_slots: Optional[int] = None,
                         bytes_per_s: Optional[float] = None):
        """Quotas of tenant ``comm`` (default: the world): its per-rank
        share of the in-flight window (the gang's depth for the comm, and
        the arbiter's outstanding-admission bound), its slot budget per
        command-ring window, and a token-bucket bytes/s cap (0 clears
        it).  Collective by contract.  Returns the tenant record, or None
        when ``comm`` was never registered."""
        comm = comm or self._world
        if window_share is not None:
            self._config(ConfigFunction.SET_TENANT_WINDOW_SHARE,
                         int(window_share), key=comm.id)
        if ring_slots is not None:
            self._config(ConfigFunction.SET_TENANT_RING_SLOTS,
                         int(ring_slots), key=comm.id)
        if bytes_per_s is not None:
            self._config(ConfigFunction.SET_TENANT_RATE, float(bytes_per_s),
                         key=comm.id)
        return self._arbiter.set_quota(
            comm.id, window_share=window_share, ring_slots=ring_slots,
            bytes_per_s=bytes_per_s)

    def _arbiter_gate(self, options: CallOptions) -> Optional[dict]:
        """Admission at intake: a registered tenant's collective or p2p
        call passes the shared DRR queue before dispatch (a bounded wait
        while its tenant is out of credit or at its window share).
        Returns the latched decision record, or None (disarmed, an
        unregistered comm, an op that moves no fabric bytes).  Only
        collectives consume the comm's admission index (the latch key);
        p2p is rank-asymmetric and admits unlatched.  A call queued into
        an open batch is charged, not paced: its dispatch unit is the
        flushed window, whose quota is the ring slot budget."""
        arb = self._arbiter
        comm = options.comm
        if (not arb.armed or comm is None
                or options.op not in self._ARBITER_OPS):
            return None
        if options.op in self._CONTRACT_OPS:
            seq = self._arbiter_seq.get(comm.id, 0)
            self._arbiter_seq[comm.id] = seq + 1
        else:
            seq = -1
        cfg = options.arithcfg
        cost = options.count * (cfg.uncompressed_elem_bytes
                                if cfg is not None else 1)
        return arb.admit(comm.id, seq, cost, self._timeout_s,
                         self._pending is None, self._arbiter_owner)

    def _arbiter_async(self, options: CallOptions, req: Request,
                       dec: dict) -> None:
        """An async admitted call: its completion frees the tenant's
        slot (when it took one) and folds its latency into the tenant's
        histogram, on the completing thread."""
        arb, comm_id = self._arbiter, options.comm.id
        paced, owner = bool(dec.get("paced")), self._arbiter_owner
        req.add_done_callback(lambda: arb.complete(
            comm_id, req.get_duration_ns(), owner=owner, release=paced))

    def _arbiter_done(self, options: CallOptions, req: Request,
                      dec: dict) -> None:
        """A synchronous admitted call, accounted on the calling thread
        after its wait; every 32nd runs the cross-process exchange when a
        ledger is attached."""
        self._arbiter.complete(
            options.comm.id, req.get_duration_ns(),
            owner=self._arbiter_owner, release=bool(dec.get("paced")))
        if self._arbiter.ledger is not None:
            self._arbiter_exchange_ctr += 1
            if self._arbiter_exchange_ctr % 32 == 1:
                self.arbiter_ledger_exchange()

    def arbiter_ledger_exchange(self) -> Optional[dict]:
        """One cross-process tenant-weight exchange through the engine's
        KV plane (fabric-share rates re-derived); the exchange counters,
        or None when no ledger is attached or the KV plane is unreachable.
        The gang has no KV plane, so on the port this is None until the
        multi-process tier (ROADMAP A6)."""
        if self._arbiter.ledger is None:
            return None
        try:
            kv = self.engine.arbiter_kv()
        except Exception:
            return None
        try:
            return self._arbiter.ledger_exchange(
                kv, is_notfound=getattr(self.engine, "_is_notfound", None))
        except Exception:  # advisory: admission never waits on it
            self._arbiter.ledger.errors += 1
            return None

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
            if self._monitor is not None:
                # the subcomm's membership registered up front: its skew
                # windows judge in its own rank space
                self._monitor.tracker.begin_comm(comm.id, comm.local_rank,
                                                 comm.size)
            if self._contract is not None:
                # its rank space, and a begin marker in its digest: a rank
                # that re-creates a subcomm its peers keep using diverges
                # at the next window
                self._contract.begin_comm(
                    comm.id, comm.local_rank,
                    tuple(r.session for r in comm.ranks))
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
        the keys of the JAX facade's report (``platform`` names the
        handle's device as JAX names its backends: ``"gpu"`` on the card,
        ``"cpu"`` for a ``device="cpu"`` group)."""
        engine = type(self.engine).__name__
        return {
            "engine": engine,
            # by name, as JAX decides it; the port's gang engine is the
            # device tier
            "device_tier": engine == "CudaEngine",
            # the C++ data plane comes with the host tiers (ROADMAP A12)
            "native_dataplane": False,
            "wire_compression": sorted(
                f"{u.name}->{c.name}" for (u, c) in self._arith if u != c),
            "arithmetic": [f.name for f in ReduceFunction],
            "streams": True,
            "rendezvous": True,
            "platform": ("gpu" if self.engine.device.type == "cuda"
                         else self.engine.device.type),
            "world_size": self._world.size,
            # one warm gang collective moves it by exactly 1
            "device_interactions": self.engine.device_interactions(),
            "plan_cache": self._plans.stats(),
            # the gang's in-flight window depth (set_inflight_window /
            # ACCL_INFLIGHT_WINDOW)
            "inflight_window": int(self.engine.gang.window.depth),
            # the adopted measurement-driven TuningPlan, if any
            "tuning_plan": (
                None if self._tuning_plan is None else {
                    "tier": self._tuning_plan.tier,
                    "world": self._tuning_plan.world,
                    "collectives": sorted(self._tuning_plan.entries),
                }),
            # the telemetry plane armed (ACCL_TELEMETRY), and the monitor's
            # services (start_monitor / ACCL_MONITOR_PORT)
            "telemetry": self._telemetry is not None,
            "monitor": (self._monitor.service_snapshot()
                        if self._monitor is not None else None),
            # the per-peer health of the world comm, fed by the gang's
            # slot watchdog (a "dead" peer fails calls at intake), with
            # the monitor's standing straggler verdicts as suspect_slow
            "health": self._annotated_health(self._world),
            # the membership plane's elastic state (the whole machine is
            # telemetry_snapshot()["membership"])
            "membership": {
                "elastic": self._membership.elastic,
                "epoch": self._membership.epoch,
                "evicted": sorted(self._membership.evicted),
                "demoted": self._membership.demoted(self._world.id),
                "joins_total": self._membership.joins_total,
            },
            # the contract verifier, when armed
            "contract_verify": (
                None if self._contract is None else {
                    "interval": self._contract.interval,
                    "calls_verified": self._contract.calls_verified,
                }),
        }

    def _annotated_health(self, comm: Communicator) -> dict:
        """The gang's health map of ``comm`` with the monitor plane's
        standing straggler verdicts as ``suspect_slow`` annotations (an
        annotation only: a slow rank never fails a call)."""
        health = self.engine.health_report(comm)
        if self._monitor is not None:
            for r in self._monitor.slow_ranks(comm.id):
                if r in health:
                    health[r]["suspect_slow"] = True
        return health

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
        # a cutover confirmed between calls applies before the plan is
        # keyed: the plan takes the comm's new epoch and size
        mv = self._membership
        if mv.elastic and mv.cutover_ready() and self._pending is None:
            self._apply_cutover()
        cdt = None if compress_dtype is None else as_datatype(compress_dtype)
        bucket = size_bucket(count)
        topo = comm.topology
        tsig = None if topo is None else topo.signature()
        lc = None if topo is None else topo.comm_link_class()
        key = (op, comm.id, comm.epoch, dtype, bucket, cdt, int(host), tsig,
               extra)
        plan, hit = self._plans.get_with_flag(key)
        self._call_tls.plan_hit = hit  # stamped onto this call's record
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
            # the batch's parent span id, from the per-handle batch
            # counter (batches are collective by contract, so every
            # rank's counter agrees): its calls' records name it
            self._batch_ctr += 1
            self._batch_trace = collective_trace_id(
                "__batch__", 0, self._trace_gen, self._batch_ctr)

    def flush(self) -> None:
        """Dispatch everything queued in the open batch (the batch stays
        open), then drain the gang's in-flight window: when it returns,
        every call the gang launched before it has finished on the device
        and completed (a call whose peers have not posted yet is not
        launched; a hierarchical aggregate's next stage is launched when
        the one before completes).  Bounded by ``drain_deadline_s``: a
        drain that runs out raises DEADLOCK_SUSPECTED."""
        self._dispatch_pending()
        if not self.engine.drain_inflight():
            raise self._deadlock_error("flush")

    def _dispatch_pending(self) -> None:
        """Dispatch the open batch without draining the in-flight window
        (the hook behind ``Request.wait`` / ``test`` on a queued call)."""
        q = self._pending
        items = q.drain() if q is not None else []
        if items:
            for _, req in items:
                req._pre_wait = None  # dispatched: a later wait must not
                # flush whatever unrelated batch is open then
            self.engine.start_batch(items)

    def end_batch(self) -> None:
        """Close the outermost batch: flush and return to immediate
        dispatch (an inner ``batch()`` only decrements the depth)."""
        if self._batch_depth > 1:
            self._batch_depth -= 1
            return
        self._batch_depth = 0
        self.flush()
        self._pending = None
        self._batch_trace = None
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
        tel = self._telemetry
        # a confirmed cutover applies before the call; the arbiter admits
        # it (it can only delay a whole call, never reorder one within a
        # comm, so the contract's digest stream is untouched); the
        # contract fingerprint fails a diverging call before dispatch
        self._membership_intake(options, context)
        qos = self._arbiter_gate(options)
        # from admission to the completion hooks, any raise (a verdict, a
        # failed start) frees the tenant's slot; once tracked, the done
        # callback or the synchronous path's finally owns the release
        tracked = False
        try:
            self._contract_gate(options, context)
            # the trace id is assigned at intake, before dispatch
            meta = (self._call_meta(options, qos) if tel is not None
                    else None)
            # a hierarchical stage dispatches at once, whatever batch the
            # caller has opened since its call (it runs on a hop thread)
            if (self._pending is not None
                    and not getattr(self._call_tls, "hier", False)):
                req = Request(op_name=options.op.name)
                req._pre_wait = self._dispatch_pending  # dispatch on wait
                if qos is not None and run_async:
                    self._arbiter_async(options, req, qos)
                    tracked = True
                if tel is not None:
                    tel.attach(req, meta)
                self._pending.push((options, req))
                if run_async:
                    return req
                # a synchronous call inside a batch dispatches the run
                self._dispatch_pending()
            else:
                req = self.engine.start(options)
                if qos is not None and run_async:
                    self._arbiter_async(options, req, qos)
                    tracked = True
                if tel is not None:
                    # after start: a call the engine completed inside
                    # start() is recorded by attach at once
                    tel.attach(req, meta)
            if run_async:
                return req
            tracked = True
            try:
                deadline = drain_deadline_s(self._timeout_s)
                if not req.wait(timeout=deadline):
                    raise self._deadlock_error(context, {
                        "op": options.op.name, "timeout_s": deadline})
                self._membership_after_failure(options, req, context)
                self._check_failed(req, context)
            finally:
                if qos is not None:  # freed however the call ends
                    self._arbiter_done(options, req, qos)
            return req
        except BaseException:
            if qos is not None and not tracked and qos.get("paced"):
                self._arbiter.release(options.comm.id,
                                      owner=self._arbiter_owner)
            raise

    def _check_failed(self, req: Request, context: str) -> None:
        """``Request.check`` through the postmortem hook: a structured
        failure surfacing on the synchronous path captures its bundle."""
        try:
            req.check(context)
        except ACCLError as e:
            raise self._structured_failure(e)

    # -- the causal trace plane (accl_tpu_torch.telemetry flows) ------------
    #: the collectives every rank of a communicator calls in one order:
    #: their trace ids come from the per-comm sequence counter
    _CONTRACT_OPS = frozenset((
        Operation.BCAST, Operation.SCATTER, Operation.GATHER,
        Operation.ALLGATHER, Operation.REDUCE, Operation.ALLREDUCE,
        Operation.REDUCE_SCATTER, Operation.ALLTOALL, Operation.BARRIER,
    ))

    #: the operations the QoS arbiter gates at intake: the collectives
    #: and plain p2p (local ops and config writes move no fabric bytes)
    _ARBITER_OPS = _CONTRACT_OPS | {Operation.SEND, Operation.RECV}

    def _assign_trace(self, options: CallOptions) -> tuple:
        """(trace_id, flow_phase, parent_id) of one call at intake.

        Collectives derive ``collective_trace_id`` from the per-comm
        intake counter (every rank issues them in one order); plain
        SEND / RECV derive ``p2p_trace_id`` from the directed channel's
        match counter (sends and receives on one (comm, src, dst, tag,
        stream) channel match in order).  Stream-port p2p gets no flow
        phase: its far end posts no matching record.  The phase is this
        rank's role in the merged flow: the lowest comm rank starts (s),
        the highest finishes (f), the rest step (t)."""
        comm = options.comm
        if comm is None:
            return None, None, None
        parent = getattr(self._call_tls, "parent_trace", None)
        if parent is None and self._pending is not None:
            parent = self._batch_trace
        op = options.op
        if op in self._CONTRACT_OPS:
            tid, phase = self._derive_collective_trace(op.name.lower(), comm)
            return tid, phase, parent
        if op in (Operation.SEND, Operation.RECV):
            if op == Operation.SEND:
                src, dst = comm.local_rank, options.root_dst
            else:
                src, dst = options.root_src, comm.local_rank
            key = (comm.id, src, dst, options.tag, int(options.stream))
            seqn = self._p2p_seq.get(key, 0)
            self._p2p_seq[key] = seqn + 1
            tid = p2p_trace_id(comm.id, src, dst, options.tag, seqn,
                               stream=int(options.stream))
            self._trace_last[comm.id] = tid
            phase = None
            if options.stream == StreamFlags.NO_STREAM:
                phase = "s" if op == Operation.SEND else "f"
            return tid, phase, parent
        return None, None, parent

    def _derive_collective_trace(self, op_name: str,
                                 comm: Communicator) -> tuple:
        """(trace_id, flow_phase) of one collective: consume the comm's
        intake counter, derive the id, note it as the comm's latest and
        pick this rank's flow role.  Single calls and the aggregates
        share it, so their ids and phases agree across ranks."""
        seqn = self._trace_seq.get(comm.id, 0)
        self._trace_seq[comm.id] = seqn + 1
        tid = collective_trace_id(op_name, comm.id, self._trace_gen, seqn)
        self._trace_last[comm.id] = tid
        if comm.size < 2:
            phase = None
        elif comm.local_rank == 0:
            phase = "s"
        elif comm.local_rank == comm.size - 1:
            phase = "f"
        else:
            phase = "t"
        return tid, phase

    def trace_stamp(self, comm_id: int) -> int:
        """This rank's latest intake trace id on the communicator, 0 when
        none (the JAX facade's wire piggyback provider; the port's gang
        has no wire to stamp)."""
        return self._trace_last.get(comm_id, 0)

    def _call_meta(self, options: CallOptions,
                   qos: Optional[dict] = None) -> dict:
        """The flight record's facts known at launch: resolved once a call
        (attribute reads, no device work) and carried to the request's
        completion by ``Telemetry.attach``.  ``tenant`` names the tenant
        that admitted the call (``qos``, the arbiter's decision), None
        when the arbiter passed it through."""
        comm = options.comm
        plan = options.plan
        dt = options.arithcfg.uncompressed if options.arithcfg else None
        trace_id, trace_phase, parent_id = self._assign_trace(options)
        return {
            "tenant": qos["tenant"] if qos else None,
            "trace_id": trace_id,
            "trace_phase": trace_phase,
            "parent_id": parent_id,
            "op": options.op.name.lower(),
            "comm": comm.id if comm is not None else None,
            "epoch": comm.epoch if comm is not None else None,
            # comm-relative identity for the skew tracker
            "comm_rank": comm.local_rank if comm is not None else None,
            "comm_world": comm.size if comm is not None else None,
            "dtype": dt.name if dt is not None else None,
            "count": options.count,
            "nbytes": options.count * dtype_size(dt) if dt is not None else 0,
            "bucket": (plan.bucket if plan is not None
                       else size_bucket(options.count)),
            "algorithm": plan.algorithm if plan is not None else None,
            "plan_hit": (getattr(self._call_tls, "plan_hit", None)
                         if plan is not None else None),
            "eager": plan.eager if plan is not None else None,
        }

    def _aggregate_meta(self, op_name: str, plan: CollectivePlan,
                        comm: Communicator, count: int, dtype: DataType,
                        trace: tuple, parent_id, **extra) -> dict:
        """The flight record's facts of a pipelined or hierarchical
        aggregate: the whole payload, under the aggregate's own trace id
        (``trace``: its id and phase), beside its stages' own records."""
        return {
            "op": op_name, "comm": comm.id, "epoch": comm.epoch,
            "comm_rank": comm.local_rank, "comm_world": comm.size,
            "dtype": dtype.name, "count": count,
            "nbytes": count * dtype_size(dtype),
            "bucket": plan.bucket, "algorithm": plan.algorithm,
            "plan_hit": getattr(self._call_tls, "plan_hit", None),
            "eager": plan.eager, **extra,
            "trace_id": trace[0], "trace_phase": trace[1],
            "parent_id": parent_id,
        }

    def _deadlock_error(self, context: str,
                        details: Optional[dict] = None) -> ACCLError:
        """DEADLOCK_SUSPECTED with the flight recorder's tail attached, as
        the JAX facade's watchdog and timeout paths raise it."""
        details = dict(details or {})
        if self._telemetry is not None:
            self._telemetry.metrics.inc("accl_deadlock_suspected_total")
            details["flight_recorder"] = self._telemetry.tail_dicts()
        return self._structured_failure(ACCLError(
            ErrorCode.DEADLOCK_SUSPECTED, context, details=details or None))

    @staticmethod
    def _count_of(buf: BaseBuffer, count: Optional[int]) -> int:
        n = buf.count if count is None else int(count)
        if n < 0:
            raise ACCLError(ErrorCode.INVALID_COUNT, f"count {n}",
                            details={"count": n, "buffer_count": buf.count})
        return n

    def _check_rank(self, comm: Communicator, rank: int) -> None:
        if not 0 <= rank < comm.size:
            raise ACCLError(ErrorCode.INVALID_RANK, f"rank {rank}",
                            details={"rank": rank, "comm": comm.id,
                                     "size": comm.size})

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
        """Return an async aggregate (its stages ride the in-flight window,
        which ``flush()`` drains), or wait for it and raise its failure."""
        if run_async:
            return outer
        deadline = drain_deadline_s(self._timeout_s)
        if not outer.wait(timeout=deadline):
            raise self._deadlock_error(context, {
                "op": outer.op_name, "timeout_s": deadline})
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

    def _launch_pipelined(self, op_name: str, plan: CollectivePlan,
                          comm: Communicator, count: int, nseg: int,
                          run_async: bool, launch_seg,
                          context: str) -> Request:
        """Segmented pipelining (the JAX facade's ``_launch_pipelined``):
        ``count`` split into ``nseg`` contiguous chunks, one async sub-call
        each (``launch_seg(start, stop)``), back to back; returns ONE
        aggregate request that completes when the last segment has (the
        first failing segment's retcode wins), holding every segment's
        event.  The gang keeps tag 0 on every segment, as JAX's device
        tier does (its order is the gang's sequence).  The aggregate's
        flight record covers the whole payload; it takes one trace id
        of the comm's sequence, and the segments' records name it as
        their parent."""
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
        tel = self._telemetry
        meta = agg_tid = None
        if tel is not None:
            trace = self._derive_collective_trace(op_name, comm)
            agg_tid = trace[0]
            meta = self._aggregate_meta(
                op_name, plan, comm, count, plan.arithcfg.uncompressed,
                trace, self._batch_trace if self._pending is not None
                else None)
        t0 = time.perf_counter_ns()
        self._call_tls.pipelining = True
        self._call_tls.parent_trace = agg_tid
        inner = []
        try:
            for i, (s0, s1) in enumerate(bounds):
                # the segment's position keys its error-feedback residual
                self._call_tls.pipeline_seg_index = i
                inner.append(launch_seg(s0, s1))
        finally:
            self._call_tls.pipelining = False
            self._call_tls.pipeline_seg_index = 0
            self._call_tls.parent_trace = None

        def _resolve():
            for q in inner:
                q.materialize()
            for q in inner:
                if q.get_retcode() != ErrorCode.OK:
                    raise RuntimeError(
                        "pipelined segment failed: "
                        f"{ErrorCode.describe(q.get_retcode())}")

        outer.defer_result(_resolve)
        if tel is not None:
            tel.attach(outer, meta)
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
            # the deepest segment's window depth; each segment recorded
            # its own overlap_ns, which the aggregate must not count again
            outer.inflight_depth = _deepest(inner)
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
        and the (topology, count) shape decomposes.  The decomposed call
        is fingerprinted on the parent comm (:meth:`_hier_fingerprint`)."""
        if (not plan.hierarchical or compress_dtype is not None
                or self._pending is not None
                or getattr(self._call_tls, "hier", False)
                or getattr(self._call_tls, "pipelining", False)):
            return False
        return _hier.eligible(op_name, comm.topology, count)

    def _launch_hier_stages(self, op_name: str, stages, run_async: bool,
                            context: str, *,
                            plan: Optional[CollectivePlan] = None,
                            comm: Optional[Communicator] = None,
                            count: int = 0,
                            dtype: Optional[DataType] = None) -> Request:
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
        a failing stage fails it.  Given the call's ``plan``, ``comm``,
        ``count`` and ``dtype``, the aggregate's flight record
        (``hierarchical``) takes one trace id of ``comm``'s sequence, and
        the stages' records name it as their parent."""
        outer = Request(op_name=op_name.upper())
        outer.mark_executing()
        tel = self._telemetry if plan is not None else None
        meta = tid = None
        if tel is not None:
            trace = self._derive_collective_trace(op_name, comm)
            tid = trace[0]
            meta = self._aggregate_meta(op_name, plan, comm, count, dtype,
                                        trace, None, hierarchical=True)
        t0 = time.perf_counter_ns()
        inner: list = []
        lock = threading.Lock()
        state = {"i": 0, "done": False}

        def _finish(code, ctx):
            with lock:
                if state["done"]:
                    return
                state["done"] = True
            outer.inflight_depth = _deepest(inner)
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
                # the stage guard and the parent trace id on whatever
                # thread runs the thunk (the caller's, or the stage thread)
                self._call_tls.hier = True
                self._call_tls.parent_trace = tid
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
                    self._call_tls.parent_trace = None
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
        if tel is not None:
            tel.attach(outer, meta)
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
            # acclint: allow[unbounded-wait] the stage thread's idle wait:
            # deinit posts the None that ends it, and every stage it runs
            # is a post that never blocks on another rank
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

    def _hier_allreduce(self, plan: CollectivePlan, comm: Communicator,
                        sendbuf: BaseBuffer, recvbuf: BaseBuffer, n: int,
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
        self._hier_fingerprint("allreduce", comm, sendbuf.dtype, n,
                               context="allreduce")
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
        return self._launch_hier_stages(
            "allreduce", stages, run_async, "allreduce", plan=plan,
            comm=comm, count=n, dtype=sendbuf.dtype)

    def _hier_allgather(self, plan: CollectivePlan, comm: Communicator,
                        sendbuf: BaseBuffer, recvbuf: BaseBuffer, n: int,
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
        self._hier_fingerprint("allgather", comm, sendbuf.dtype, n,
                               context="allgather")
        scratch = self._scratch(sendbuf.dtype, S * n)
        stages = [
            lambda: self.allgather(sendbuf, scratch, n, comm=intra,
                                   run_async=True),
            lambda: self.allgather(scratch, recvbuf, S * n, comm=rail,
                                   run_async=True),
        ]
        return self._launch_hier_stages(
            "allgather", stages, run_async, "allgather", plan=plan,
            comm=comm, count=n, dtype=sendbuf.dtype)

    def _hier_reduce_scatter(self, plan: CollectivePlan,
                             comm: Communicator, sendbuf: BaseBuffer,
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
        self._hier_fingerprint("reduce_scatter", comm, recvbuf.dtype, n,
                               context="reduce_scatter")
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
        return self._launch_hier_stages(
            "reduce_scatter", stages, run_async, "reduce_scatter",
            plan=plan, comm=comm, count=n, dtype=recvbuf.dtype)

    def _hier_bcast(self, plan: CollectivePlan, comm: Communicator,
                    buf: BaseBuffer, n: int, root: int,
                    run_async: bool) -> Request:
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
        self._hier_fingerprint("bcast", comm, buf.dtype, n, root=root,
                               context="bcast")

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

        return self._launch_hier_stages(
            "bcast", [_s1, _s2], run_async, "bcast", plan=plan, comm=comm,
            count=n, dtype=buf.dtype)

    def get_duration(self, request: Request) -> int:
        """Engine-measured call duration in ns (ref ACCL::get_duration)."""
        return request.get_duration_ns()

    # -- primitives ----------------------------------------------------------
    def nop(self, run_async: bool = False):
        return self._launch(CallOptions(op=Operation.NOP), run_async, "nop")

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
            return self._hier_bcast(plan, comm, buf, n, root, run_async)
        nseg = self._pipeline_segments_for(plan, n, buf.dtype)
        if nseg > 1:
            return self._launch_pipelined(
                "bcast", plan, comm, n, nseg, run_async,
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
            return self._hier_allgather(plan, comm, sendbuf, recvbuf, n,
                                        run_async)
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
            return self._hier_allreduce(plan, comm, sendbuf, recvbuf, n,
                                        function, run_async)
        nseg = self._pipeline_segments_for(plan, n, sendbuf.dtype)
        if nseg > 1:
            return self._launch_pipelined(
                "allreduce", plan, comm, n, nseg, run_async,
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
            return self._hier_reduce_scatter(plan, comm, sendbuf, recvbuf, n,
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
        comm = comm or self._world
        # the gather root routes around demoted stragglers (0 unless the
        # demotion routing is armed)
        return self._collective(Operation.BARRIER, comm, 0, DataType.FLOAT32,
                                None, run_async,
                                root_src=self._barrier_root(comm))

    # -- the telemetry plane (accl_tpu_torch.telemetry) ----------------------
    def telemetry_snapshot(self) -> dict:
        """ONE merged telemetry dict for this rank handle, under the JAX
        facade's top-level keys: the flight recorder's tail, the metrics
        registry, the (empty: no fabric) wire trace, the plan cache, the
        engine's report (the command ring's counters and window log
        included), the per-peer health, the contract verifier's counters
        and verdicts, the membership machine with its scale advice, the
        health-transition events, the compression plane, the monitor
        plane's stragglers, anomalies and services, the arbiter's tenants
        and the postmortem bundles.  ``faults`` is None, as on JAX's
        gang."""
        tel = self._telemetry
        mon = self._monitor
        engine_report = self.engine.telemetry_report()
        return {
            "schema_version": SCHEMA_VERSION,
            "telemetry_enabled": tel is not None,
            "rank": self._world.local_rank,
            "world": self._world.size,
            "tier": type(self.engine).__name__,
            "flight_recorder": tel.tail_dicts(64) if tel else [],
            "flight_recorder_total": tel.recorder.total if tel else 0,
            "metrics": tel.metrics.snapshot() if tel else {},
            "wire_trace": wire_snapshot(),
            "plan_cache": self._plans.stats(),
            "health": self._annotated_health(self._world),
            "device_interactions": self.engine.device_interactions(),
            "engine": engine_report,
            "faults": engine_report.get("faults"),
            "contract": (self._contract.snapshot()
                         if self._contract is not None
                         else {"enabled": False}),
            "membership": self._membership_report(),
            "health_events": self._health_events.snapshot(),
            "tenants": self._arbiter.snapshot(),
            "compression": {
                "sr_calls": self.sr_calls,
                "error_feedback": dict(self._residuals.stats(),
                                       enabled=self._error_feedback),
            },
            "stragglers": (mon.straggler_snapshot() if mon is not None
                           else {"enabled": False}),
            "anomalies": (mon.anomaly_snapshot() if mon is not None
                          else {"enabled": False}),
            "monitor": (mon.service_snapshot() if mon is not None
                        else {"serving": False}),
            "postmortem": (self._blackbox.snapshot()
                           if self._blackbox is not None
                           else {"enabled": False}),
        }

    # -- debug dumps -----------------------------------------------------------
    def dump_rx_buffers(self, as_dict: bool = False):
        """The rx-accounting dump (the reference's
        ``dump_eager_rx_buffers``): the gang's pending slots, parked p2p
        posts and undrained stream ports as ``rxbuf`` lines.
        ``as_dict=True`` adds the engine's ``telemetry_report``."""
        doc = {"engine": type(self.engine).__name__,
               "lines": self.engine.dump_rx_buffers().splitlines()}
        if as_dict:
            doc["report"] = self.engine.telemetry_report()
            return doc
        return "\n".join(doc["lines"])

    def dump_communicator(self, comm: Optional[Communicator] = None,
                          as_dict: bool = False):
        """The communicator table and its per-peer health; the string
        form is rendered from the dict, in the JAX facade's lines."""
        comm = comm or self._world
        doc = {"comm": comm.as_dict(),
               "health": self._annotated_health(comm)}
        if as_dict:
            return doc
        c = doc["comm"]
        lines = [f"communicator {c['id']}: size={c['size']} "
                 f"local={c['local_rank']}"]
        for i, r in enumerate(c["ranks"]):
            lines.append(f"  rank {i}: addr={r['address']} "
                         f"session={r['session']} "
                         f"seg={r['max_segment_size']} "
                         f"seq_out={r['seq_out']} seq_in={r['seq_in']}")
        for i in sorted(doc["health"]):
            h = doc["health"][i]
            line = (f"  health rank {i}: {h.get('state', 'ok')}"
                    f" timeouts={h.get('timeouts', 0)}"
                    f" failures={h.get('failures', 0)}")
            if h.get("last_event"):
                line += f" last={h['last_event']}"
            lines.append(line)
        return "\n".join(lines)

    def telemetry_prometheus(self) -> str:
        """The snapshot in Prometheus text exposition format."""
        return to_prometheus(self.telemetry_snapshot())

    def telemetry_json(self) -> str:
        """The snapshot as canonical JSON."""
        return to_json(self.telemetry_snapshot())

    def telemetry_trace_events(self) -> list:
        """This rank's flight records (and the command ring's window and
        slot spans, flow-linked to the issuing calls) as Chrome/Perfetto
        trace events; [] when telemetry is off."""
        if self._telemetry is None:
            return []
        events = self._telemetry.chrome_events()
        try:
            events.extend(self.engine.trace_events())
        except Exception:  # a ring render bug must not kill the export
            import traceback

            traceback.print_exc()
        events.sort(key=lambda e: e.get("ts", 0.0))
        return events

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Write (or return) this rank's Perfetto-loadable trace; fold the
        ranks' files with ``python -m accl_tpu_torch.telemetry merge``."""
        doc = chrome_trace(self.telemetry_trace_events())
        if path is not None:
            import json

            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    # -- the monitor plane (accl_tpu_torch.monitor) --------------------------
    def start_monitor(self, port: Optional[int] = None) -> int:
        """Start this rank handle's scrape service: a stdlib HTTP server
        on an ``accl-monitor`` thread, bound to 127.0.0.1, serving ``/``
        (a one-screen summary), ``/metrics`` (Prometheus text),
        ``/snapshot`` (the ``telemetry_snapshot()`` JSON), ``/trace`` (the
        Chrome trace), ``/cmdring`` (the command ring's stats and window
        log), ``/tenants`` (the arbiter's snapshot) and ``/membership``
        (the membership machine and the scale advisor's advice).  ``port`` 0 (the default without
        ``ACCL_MONITOR_PORT``) binds an ephemeral port.  Returns the bound
        port; idempotent while serving."""
        if self._monitor is None:
            raise ACCLError(
                ErrorCode.INVALID_OPERATION,
                "telemetry disabled (ACCL_TELEMETRY=0): nothing to serve",
                details={"op": "start_monitor"},
            )
        if self._monitor.server is not None:
            return self._monitor.server.port
        if port is None:
            port = _monitor.env_port() or 0

        def _trace_doc() -> str:
            import json

            return json.dumps(chrome_trace(self.telemetry_trace_events()))

        def _cmdring_doc() -> str:
            import json

            ring = self.engine.telemetry_report().get("cmdring")
            return json.dumps(ring if ring is not None
                              else {"enabled": False}, default=str)

        def _tenants_doc() -> str:
            import json

            return json.dumps(self._arbiter.snapshot(), default=str)

        def _membership_doc() -> str:
            import json

            return json.dumps(self._membership_report(), default=str)

        srv = _monitor.MonitorServer({
            "/": (self._monitor_index, "text/plain; charset=utf-8"),
            "/metrics": (self.telemetry_prometheus,
                         "text/plain; version=0.0.4; charset=utf-8"),
            "/snapshot": (self.telemetry_json, "application/json"),
            "/trace": (_trace_doc, "application/json"),
            "/cmdring": (_cmdring_doc, "application/json"),
            "/tenants": (_tenants_doc, "application/json"),
            "/membership": (_membership_doc, "application/json"),
        }, port=int(port))
        srv.start()
        self._monitor.server = srv
        return srv.port

    def _monitor_index(self) -> str:
        """The monitor's ``/`` page: the routes and a one-screen summary
        (the command ring, the postmortem bundles, standing stragglers,
        the last anomaly, the membership, one line a tenant)."""
        lines = [
            f"accl monitor — rank {self._world.local_rank}/"
            f"{self._world.size} ({type(self.engine).__name__})",
            "routes: /metrics /snapshot /trace /cmdring /tenants "
            "/membership",
            "",
        ]
        ring = self.engine.telemetry_report().get("cmdring") or {}
        if ring:
            lines.append(
                f"cmdring: state={ring.get('state', '?')} "
                f"refills={ring.get('refills', 0)} "
                f"dispatches={ring.get('dispatches', 0)} "
                f"mailbox_depth={ring.get('mailbox_depth', 0)} "
                f"fallbacks={sum((ring.get('fallbacks') or {}).values())}")
        else:
            lines.append("cmdring: (tier has no command ring)")
        bb = self._blackbox.snapshot() if self._blackbox else {}
        lines.append(f"postmortem: bundles={bb.get('bundles_written', 0)} "
                     f"last={bb.get('last_bundle') or '-'}"
                     if bb.get("enabled")
                     else "postmortem: disabled (set ACCL_POSTMORTEM_DIR)")
        standing = self._monitor.straggler_snapshot().get("standing") or {}
        for c, v in sorted(standing.items()):
            lines.append(f"straggler: comm {c} slow_rank={v.get('rank')} "
                         f"ewma={v.get('ewma_latency_us')}us "
                         f"streak={v.get('streak')}")
        if not standing:
            lines.append("straggler: none standing")
        anom = self._monitor.anomaly_snapshot()
        alerts = anom.get("alerts") or []
        if alerts:
            a = alerts[-1]
            lines.append(f"anomaly: {a.get('op')}/b{a.get('size_bucket')} "
                         f"{a.get('duration_us')}us vs baseline "
                         f"{a.get('baseline_us')}us "
                         f"(total {anom.get('alerts_total', 0)})")
        else:
            lines.append("anomaly: none")
        mem = self._membership_report()
        advice = mem.get("scale_advice") or {}
        lines.append(f"membership: epoch={mem.get('epoch')} "
                     f"elastic={mem.get('elastic')} "
                     f"evicted={sorted(mem.get('evicted') or [])} "
                     f"joins={mem.get('joins_total', 0)} "
                     f"scale_advice={advice.get('recommendation', '-')}")
        # the arbiter: one line a tenant (class, admissions, live p99)
        arb = self._arbiter.snapshot()
        tenants = arb.get("tenants") or {}
        if not tenants:
            lines.append(
                f"tenants: none registered (arbiter "
                f"{'armed' if arb.get('enabled') else 'disarmed'})")
        for _cid, t in sorted(tenants.items()):
            p99 = (t.get("latency") or {}).get("p99_us")
            lines.append(f"tenant {t.get('name')}: class={t.get('class')} "
                         f"weight={t.get('weight')} "
                         f"admitted={t.get('admitted')} "
                         f"queued={t.get('queued')} "
                         f"p99={p99 if p99 is not None else '-'}us")
        return "\n".join(lines) + "\n"

    def stop_monitor(self) -> bool:
        """Stop the scrape service (a bounded join of its thread); True
        when it exited.  No-op when not serving."""
        if self._monitor is None or self._monitor.server is None:
            return True
        srv, self._monitor.server = self._monitor.server, None
        return srv.stop()

    def deinit(self) -> None:
        if self._initialized:
            # the monitor's services first (bounded joins): a scrape
            # landing mid-teardown must not race the engine's shutdown
            if self._monitor is not None:
                self._monitor.close()
                self.engine.set_skew_tracker(None)
            # the contract verifier's, the postmortem registry's and the
            # membership plane's listeners on the shared gang must not
            # outlive the handle
            self.set_contract_verify(False)
            if self._blackbox is not None:
                reg = anchored(self.engine.contract_anchor(),
                               "_accl_blackbox_registry", dict)
                if reg is not None:
                    reg.pop(self._blackbox.rank, None)
                ring = self.engine.gang.cmdring
                if ring.on_failure is self._ring_hook:
                    ring.on_failure = None
            self._membership.close()
            self.engine.set_membership(None)
            self.engine.on_health_transition = None
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
