"""The telemetry plane: flight recorder, metrics registry, trace export.

The port's copy of ``accl_tpu/telemetry.py``, whole: the same classes,
functions, snapshot schema (``SCHEMA_VERSION``) and environment
variables, so a dashboard, an exporter test or the merge CLI reads the
two packages' output alike.

Three pillars:

* **Flight recorder** -- a bounded ring of structured :class:`CallRecord`
  s appended at ``Request.complete()`` (op, comm id+epoch, dtype, byte
  count, size bucket, algorithm, plan hit/miss, protocol verdict,
  duration, retcode, trace ids).  The last N records ride into
  ``ACCLError.details["flight_recorder"]`` automatically, so a failure
  arrives with its recent history attached.
* **Metrics registry** -- counters and log2-bucketed latency histograms
  per (op x size bucket), merged with the engine's own telemetry
  (``device_interactions``, plan-cache stats, the command ring's
  counters and window log) behind ``ACCL.telemetry_snapshot()``;
  exporters render the snapshot as Prometheus text or JSON.
* **Trace export** -- each rank's records render as Chrome/Perfetto
  trace events (``pid`` = rank, ``tid`` 0 = the engine tier, ``tid`` 1 =
  buffered wire events), named ``accl::<op>``, with causal flow events
  linking one collective's spans across ranks by a deterministic trace
  id.  ``python -m accl_tpu_torch.telemetry merge`` folds per-rank files
  into one Perfetto-loadable timeline.

Always-on cheap: recording is append-to-preallocated-ring plus a couple
of dict increments on the completion path (no device interactions),
with the ``ACCL_TELEMETRY=0`` kill switch and the
``ACCL_TELEMETRY_SAMPLE`` knob for TRACE-granularity wire events.  The
port's gang shares one device and has no fabric, so its wire-event ring
stays empty, as the JAX gang's does.  Zero dependencies: stdlib only.

Env knobs:

* ``ACCL_TELEMETRY=0``       -- kill switch (no recording, no metrics)
* ``ACCL_TELEMETRY_RING=N``  -- flight-recorder capacity (default 512)
* ``ACCL_TELEMETRY_SAMPLE=N``-- keep 1-in-N TRACE wire events (default 1)
* ``ACCL_TRACE_FLOWS=0``     -- render no flow events (ids are still
  stamped)
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

__all__ = [
    "CallRecord",
    "FlightRecorder",
    "MetricsRegistry",
    "SCHEMA_VERSION",
    "Telemetry",
    "chrome_trace",
    "collective_trace_id",
    "enabled",
    "flow_events_for",
    "flows_enabled",
    "merge_traces",
    "p2p_trace_id",
    "record_event",
    "to_json",
    "to_prometheus",
    "validate_flow_docs",
    "validate_flows",
    "wire_event",
    "wire_snapshot",
]

#: default flight-recorder capacity; the tail attached to errors
DEFAULT_RING = 512
ERROR_TAIL = 32

#: ``telemetry_snapshot()`` schema version: bumped whenever the merged
#: dict gains/renames sections, so dashboards and the exporter
#: round-trip tests can key on shape instead of sniffing.  2 = the
#: monitor plane (schema_version, stragglers, anomalies, monitor);
#: 3 = the membership plane (membership, health_events);
#: 4 = the causal trace plane (postmortem section, trace ids in
#: flight records, cmdring window timelines under engine.cmdring);
#: 5 = the QoS arbiter plane (tenants section: per-tenant admission
#: counters, quotas, and live latency histograms with p99 tails);
#: 6 = the quantized wire plane (compression section: per-wire-dtype
#: cast/bytes-saved counters, SR call count, error-feedback residual
#: store stats incl. the residual-norm gauge).
SCHEMA_VERSION = 6

# One epoch<->monotonic anchor per process: records carry perf_counter_ns
# timestamps (cheap, monotonic), trace export maps them onto the epoch
# clock so independently-captured per-rank traces merge onto one
# timeline.  Cross-host skew is whatever NTP leaves — good enough for a
# scrollable timeline, not for nanosecond causality.
_ANCHOR_EPOCH_NS = time.time_ns()
_ANCHOR_PERF_NS = time.perf_counter_ns()


def _perf_to_epoch_us(perf_ns: int) -> float:
    return (_ANCHOR_EPOCH_NS + (perf_ns - _ANCHOR_PERF_NS)) / 1e3


def enabled() -> bool:
    """The kill switch: ``ACCL_TELEMETRY=0`` disables recording (read
    per ACCL-handle construction, so tests can flip it per group)."""
    return os.environ.get("ACCL_TELEMETRY", "1") != "0"


def _ring_capacity() -> int:
    try:
        return max(8, int(os.environ.get("ACCL_TELEMETRY_RING", DEFAULT_RING)))
    except ValueError:
        return DEFAULT_RING


# ---------------------------------------------------------------------------
# causal trace ids (the cross-rank flow linkage)
# ---------------------------------------------------------------------------

#: ``ACCL_TRACE_FLOWS=0`` disables flow-event RENDERING (ids are still
#: derived and stamped — they are a handful of crc32s per call and the
#: postmortem bundles want them regardless)
TRACE_FLOWS_ENV = "ACCL_TRACE_FLOWS"


def flows_enabled() -> bool:
    return os.environ.get(TRACE_FLOWS_ENV, "1") != "0"


def collective_trace_id(op: str, comm_id: int, generation: int,
                        seqn: int) -> int:
    """Deterministic 32-bit trace id of one collective: the contract
    plane's fingerprint basis (op|comm|generation|seqn) hashed with
    crc32 — NEVER Python ``hash`` (process-salted), so every rank of
    the collective derives the SAME id with zero wire bytes.  The
    generation re-keys across soft_reset like the contract digests;
    nonzero by construction (0 means "unstamped")."""
    data = f"{op}|{comm_id}|{generation}|{seqn}".encode()
    return zlib.crc32(data) or 1


def p2p_trace_id(comm_id: int, src: int, dst: int, tag: int,
                 seqn: int, stream: int = 0) -> int:
    """Deterministic trace id of one send→recv pair: both ends derive
    it from the DIRECTED (comm, src, dst, tag, stream) channel's match
    counter — sends and receives on one channel match strictly in
    order, so the sender's k-th send and the receiver's k-th recv
    agree on the id with zero wire bytes (the wire stamp is
    corroboration, not the mechanism).  ``stream`` keeps stream-port
    p2p variants on their own id space: their counters are separate at
    intake, so without the discriminator a stream_put and a plain send
    on the same (comm, dst, tag) would collide at seqn 0."""
    data = f"p2p|{comm_id}|{src}|{dst}|{tag}|{stream}|{seqn}".encode()
    return zlib.crc32(data) or 1


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class CallRecord:
    """One completed engine call, structured (the reference's per-call
    exchange-memory perf/retcode words, plus the dispatch-plan facts the
    facade resolves per call)."""

    __slots__ = (
        "op", "comm", "epoch", "dtype", "count", "nbytes", "bucket",
        "algorithm", "plan_hit", "eager", "duration_ns", "retcode",
        "retcode_name", "end_perf_ns", "attempts", "peer",
        "overlap_ns", "inflight_depth", "ring_resident",
        "trace_id", "trace_phase", "parent_id", "tenant",
    )

    def __init__(self, op, comm, epoch, dtype, count, nbytes, bucket,
                 algorithm, plan_hit, eager, duration_ns, retcode,
                 retcode_name, end_perf_ns, attempts=None, peer=None,
                 overlap_ns=None, inflight_depth=None,
                 ring_resident=None, trace_id=None, trace_phase=None,
                 parent_id=None, tenant=None):
        self.op = op
        self.comm = comm
        self.epoch = epoch
        self.dtype = dtype
        self.count = count
        self.nbytes = nbytes
        self.bucket = bucket
        self.algorithm = algorithm
        self.plan_hit = plan_hit
        self.eager = eager
        self.duration_ns = duration_ns
        self.retcode = retcode
        self.retcode_name = retcode_name
        self.end_perf_ns = end_perf_ns
        self.attempts = attempts
        self.peer = peer
        # overlap plane: in-flight time past launch return + window depth
        # at park (None when the call never rode an in-flight window)
        self.overlap_ns = overlap_ns
        self.inflight_depth = inflight_depth
        # command-ring plane: True when the call executed ring-resident
        # (sequenced on device by the cmdring sequencer, not by host
        # dispatch); None on non-ring paths/tiers
        self.ring_resident = ring_resident
        # causal trace plane: the deterministic cross-rank trace id
        # (collective_trace_id / p2p_trace_id basis), this rank's flow
        # phase in the merged timeline ("s"/"t"/"f"; None = no flow),
        # and the parent span's id (pipelined segments / batched calls)
        self.trace_id = trace_id
        self.trace_phase = trace_phase
        self.parent_id = parent_id
        # QoS arbiter plane: which tenant admitted this call (None when
        # the arbiter is disarmed / the comm unregistered) — per-call
        # tenant forensics on the flight recorder
        self.tenant = tenant

    def as_dict(self) -> dict:
        d = {
            "op": self.op,
            "comm": self.comm,
            "epoch": self.epoch,
            "dtype": self.dtype,
            "count": self.count,
            "nbytes": self.nbytes,
            "bucket": self.bucket,
            "algorithm": self.algorithm,
            "plan_hit": self.plan_hit,
            "eager": self.eager,
            "duration_ns": self.duration_ns,
            "retcode": self.retcode,
            "retcode_name": self.retcode_name,
            "end_us": round(_perf_to_epoch_us(self.end_perf_ns), 3),
        }
        if self.attempts is not None:
            d["attempts"] = self.attempts
        if self.peer is not None:
            d["peer"] = self.peer
        if self.overlap_ns is not None:
            d["overlap_ns"] = self.overlap_ns
        if self.inflight_depth is not None:
            d["inflight_depth"] = self.inflight_depth
        if self.ring_resident is not None:
            d["ring_resident"] = self.ring_resident
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        if self.tenant is not None:
            d["tenant"] = self.tenant
        return d


class FlightRecorder:
    """Bounded ring of :class:`CallRecord`.  Appends are O(1) into a
    preallocated slot list under a short lock — the warm-path cost the
    <=5% ``facade_call_overhead_us`` budget covers."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity or _ring_capacity()
        self._slots: List[Optional[CallRecord]] = [None] * self.capacity
        self._next = 0  # total appended (monotone)
        self._lock = threading.Lock()

    def append(self, rec: CallRecord) -> None:
        with self._lock:
            self._slots[self._next % self.capacity] = rec
            self._next += 1

    def __len__(self) -> int:
        with self._lock:
            return min(self._next, self.capacity)

    @property
    def total(self) -> int:
        """Records ever appended (>= len once the ring rolled over)."""
        return self._next

    def tail(self, n: Optional[int] = None) -> List[CallRecord]:
        """Last ``n`` records, oldest first."""
        with self._lock:
            have = min(self._next, self.capacity)
            n = have if n is None else min(n, have)
            start = self._next - n
            return [
                self._slots[i % self.capacity]
                for i in range(start, self._next)
            ]

    def since(self, cursor: int) -> tuple:
        """``(records, new_cursor)``: every record appended after total
        count ``cursor``, oldest first — the streaming exporter's
        cursor.  Records that rolled out of the ring before being
        pulled are lost (bounded memory beats completeness; the stream
        flush cadence keeps the window comfortably inside capacity)."""
        with self._lock:
            total = self._next
            start = max(int(cursor), total - self.capacity, 0)
            return (
                [self._slots[i % self.capacity] for i in range(start, total)],
                total,
            )

    def tail_dicts(self, n: Optional[int] = None) -> List[dict]:
        return [r.as_dict() for r in self.tail(n)]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def _log2_bucket(value: float) -> int:
    """floor(log2(value)), floored at 0 — the histogram bucket scheme
    shared with plans.size_bucket (log2 duration in us here)."""
    return max(0, int(value).bit_length() - 1)


class MetricsRegistry:
    """Counters + log2-bucketed latency histograms per (op × size
    bucket).  Label cardinality is bounded by construction: ops are a
    small enum, size buckets ~log2(max count)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, int] = {}
        # (op, size_bucket) -> [count, sum_ns, {log2_us: n}]
        self._hist: Dict[tuple, list] = {}

    def inc(self, name: str, labels: tuple = (), n: int = 1) -> None:
        key = (name,) + tuple(labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def observe(self, op: str, size_bucket: int, duration_ns: int) -> None:
        key = (op, size_bucket)
        us = duration_ns // 1000
        b = _log2_bucket(us)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0, 0, {}]
            h[0] += 1
            h[1] += duration_ns
            h[2][b] = h[2].get(b, 0) + 1

    def record_call(self, op: str, size_bucket: int, duration_ns: int,
                    code: int, code_name: str, plan_hit,
                    attempts, overlap_ns=None,
                    ring_resident=None) -> None:
        """The completion-path fast lane: every counter/histogram update
        one call makes, under ONE lock acquisition (separate inc/observe
        calls each pay a lock + tuple build — measured at ~2x this)."""
        b = max(0, (duration_ns // 1000).bit_length() - 1)
        with self._lock:
            c = self._counters
            key = ("accl_calls_total", op)
            c[key] = c.get(key, 0) + 1
            if code != 0:
                key = ("accl_call_errors_total", op, code_name)
                c[key] = c.get(key, 0) + 1
            if plan_hit is True:
                key = ("accl_plan_hits_total", op)
                c[key] = c.get(key, 0) + 1
            elif plan_hit is False:
                key = ("accl_plan_misses_total", op)
                c[key] = c.get(key, 0) + 1
            if attempts:
                key = ("accl_call_attempts_total", op)
                c[key] = c.get(key, 0) + int(attempts)
            if overlap_ns:
                # overlap plane: device time hidden behind later host
                # work — the in-flight window's win, summed per op
                key = ("accl_overlap_ns_total", op)
                c[key] = c.get(key, 0) + int(overlap_ns)
                key = ("accl_overlapped_calls_total", op)
                c[key] = c.get(key, 0) + 1
            if ring_resident:
                # command-ring plane: calls the device sequencer executed
                # (host only refilled the ring)
                key = ("accl_ring_resident_calls_total", op)
                c[key] = c.get(key, 0) + 1
            h = self._hist.get((op, size_bucket))
            if h is None:
                h = self._hist[(op, size_bucket)] = [0, 0, {}]
            h[0] += 1
            h[1] += duration_ns
            h[2][b] = h[2].get(b, 0) + 1

    def snapshot(self) -> dict:
        """JSON-shaped view: ``counters`` keyed ``name[|label...]`` and
        ``histograms`` keyed ``op/b<size_bucket>`` with log2-us buckets."""
        with self._lock:
            counters = {
                "|".join(str(p) for p in key): v
                for key, v in sorted(self._counters.items())
            }
            hist = {}
            for (op, sb), (count, sum_ns, buckets) in sorted(
                self._hist.items()
            ):
                hist[f"{op}/b{sb}"] = {
                    "op": op,
                    "size_bucket": sb,
                    "count": count,
                    "sum_ns": sum_ns,
                    "mean_us": round(sum_ns / count / 1e3, 3) if count else 0,
                    # {log2(us): n}: key k covers [2^k, 2^(k+1)) us
                    "log2_us": {str(k): v for k, v in sorted(buckets.items())},
                }
        return {"counters": counters, "histograms": hist}


# ---------------------------------------------------------------------------
# buffered wire-event ring (the ACCL_DEBUG=TRACE path)
# ---------------------------------------------------------------------------

# Module-level because the wire is shared infrastructure (one fabric
# serves every rank engine in a process); utils/logging routes TRACE
# emissions here instead of synchronous stderr writes, so turning
# tracing on no longer perturbs the timings being traced.
_WIRE_CAP = 4096
_wire_lock = threading.Lock()
_wire_ring: List[Optional[dict]] = [None] * _WIRE_CAP
_wire_next = 0
_wire_seen = 0


def _wire_sample() -> int:
    try:
        return max(1, int(os.environ.get("ACCL_TELEMETRY_SAMPLE", "1")))
    except ValueError:
        return 1


def wire_event(source: str, message: str) -> None:
    """Buffer one TRACE-granularity wire event (sampled 1-in-N by
    ``ACCL_TELEMETRY_SAMPLE``).  Called from utils.logging on the send
    path — must stay allocation-light."""
    global _wire_next, _wire_seen
    with _wire_lock:
        _wire_seen += 1
        if (_wire_seen - 1) % _wire_sample():
            return
        _wire_ring[_wire_next % _WIRE_CAP] = {
            "ts_us": round(_perf_to_epoch_us(time.perf_counter_ns()), 3),
            "src": source,
            "event": message,
        }
        _wire_next += 1


def wire_snapshot(last: int = 64) -> dict:
    """The rendered-on-dump view of the wire ring."""
    with _wire_lock:
        have = min(_wire_next, _WIRE_CAP)
        n = min(last, have)
        events = [
            _wire_ring[i % _WIRE_CAP]
            for i in range(_wire_next - n, _wire_next)
        ]
        return {
            "seen": _wire_seen,
            "recorded": _wire_next,
            "sample_1_in": _wire_sample(),
            "events": events,
        }


def wire_events(limit: Optional[int] = None) -> List[dict]:
    with _wire_lock:
        have = min(_wire_next, _WIRE_CAP)
        n = have if limit is None else min(limit, have)
        return [
            _wire_ring[i % _WIRE_CAP]
            for i in range(_wire_next - n, _wire_next)
        ]


def wire_reset() -> None:
    """Test hook: drop buffered wire events and counters."""
    global _wire_next, _wire_seen, _flow_next, _flow_seen
    with _wire_lock:
        _wire_next = 0
        _wire_seen = 0
        for i in range(_WIRE_CAP):
            _wire_ring[i] = None
        _flow_next = 0
        _flow_seen = 0
        for i in range(_WIRE_CAP):
            _flow_ring[i] = None


# wire-arrival flow steps (the causal trace plane's delivery-side
# corroboration): a delivered message carrying a piggybacked trace id
# (Message.trc — the vfy_/skw_ stamp pattern) records one step here;
# exports render them as `t` flow phases on the wire row, so the merged
# timeline shows the wire hop INSIDE the send→recv / collective flow.
# Same process-wide + sampled discipline as the wire ring above.
_flow_ring: List[Optional[dict]] = [None] * _WIRE_CAP
_flow_next = 0
_flow_seen = 0


def wire_flow(trace_id: int, src: int, dst: int, comm_id: int) -> None:
    """One delivered message's piggybacked trace id (fabric delivery
    thread; sampled 1-in-N by ``ACCL_TELEMETRY_SAMPLE``)."""
    global _flow_next, _flow_seen
    with _wire_lock:
        _flow_seen += 1
        if (_flow_seen - 1) % _wire_sample():
            return
        _flow_ring[_flow_next % _WIRE_CAP] = {
            "ts_us": round(_perf_to_epoch_us(time.perf_counter_ns()), 3),
            "id": int(trace_id),
            "src": int(src),
            "dst": int(dst),
            "comm": int(comm_id),
        }
        _flow_next += 1


def wire_flow_events(limit: Optional[int] = None) -> List[dict]:
    with _wire_lock:
        have = min(_flow_next, _WIRE_CAP)
        n = have if limit is None else min(limit, have)
        return [
            _flow_ring[i % _WIRE_CAP]
            for i in range(_flow_next - n, _flow_next)
        ]


# ---------------------------------------------------------------------------
# the per-handle plane
# ---------------------------------------------------------------------------


class Telemetry:
    """One rank handle's telemetry plane: flight recorder + metrics.

    Created by the ACCL facade (one per handle), attached to Requests at
    launch; ``Request.complete()`` calls :meth:`record` on every tier.
    """

    def __init__(self, rank: int, tier: str,
                 capacity: Optional[int] = None):
        self.rank = rank
        self.tier = tier
        self.recorder = FlightRecorder(capacity)
        self.metrics = MetricsRegistry()
        # completion observers (the monitor plane's straggler tracker /
        # anomaly watchdog): called after every recorded completion
        # with (meta, duration_ns, code) — each must be cheap and must
        # never raise into the call it observes
        self._observers: List[Any] = []

    def add_observer(self, fn) -> None:
        """Register a completion observer ``fn(meta, duration_ns,
        code)`` — the monitor plane's hook onto the flight-recorder
        append path (one list iteration per call; empty by default)."""
        if fn not in self._observers:
            self._observers.append(fn)

    @classmethod
    def create(cls, rank: int, tier: str) -> Optional["Telemetry"]:
        """None when the ``ACCL_TELEMETRY=0`` kill switch is set."""
        return cls(rank, tier) if enabled() else None

    # -- recording (the Request.complete hook) ------------------------------
    def attach(self, req, meta: dict) -> None:
        """Arm ``req`` so its completion appends a CallRecord.  Handles
        the already-completed race (engines that complete synchronously
        inside ``start``) by recording immediately — and still arms
        ``req._telemetry`` so a later ``check()`` attaches the
        flight-recorder tail to its ACCLError (complete() has already
        run, so no double-record is possible)."""
        with req._cb_lock:
            if not req._done.is_set():
                req._telemetry = self
                req._tmeta = meta
                return
        self.record(
            meta, req.get_duration_ns(), req.get_retcode(),
            req.error_context,
            overlap_ns=getattr(req, "overlap_ns", None),
            inflight_depth=getattr(req, "inflight_depth", None),
            ring_resident=getattr(req, "ring_resident", None),
        )
        req._telemetry = self
        req._tmeta = meta

    def record(self, meta: dict, duration_ns: int, retcode,
               error_context: Optional[dict] = None,
               amend: bool = False, overlap_ns=None,
               inflight_depth=None, ring_resident=None) -> None:
        """Append one CallRecord + metrics.  ``amend=True`` re-records a
        call whose retcode changed AFTER completion (a deferred-result
        adoption failure downgrading OK): the corrected record is
        appended and the error counted, without double-counting the call
        in calls_total or the latency histogram."""
        ctx = error_context or {}
        code = int(retcode)
        code_name = getattr(retcode, "name", str(code))
        duration_ns = int(duration_ns)
        op = meta["op"] or "?"
        bucket = meta["bucket"]
        plan_hit = meta["plan_hit"]
        attempts = ctx.get("attempts")
        rec = CallRecord(
            op, meta["comm"], meta["epoch"], meta["dtype"], meta["count"],
            meta["nbytes"], bucket, meta["algorithm"], plan_hit,
            meta["eager"], duration_ns, code, code_name,
            time.perf_counter_ns(), attempts, ctx.get("peer"),
            overlap_ns, inflight_depth, ring_resident,
            meta.get("trace_id"), meta.get("trace_phase"),
            meta.get("parent_id"), meta.get("tenant"),
        )
        self.recorder.append(rec)
        if amend:
            if code != 0:
                self.metrics.inc(
                    "accl_call_errors_total", (op, code_name)
                )
            return
        self.metrics.record_call(
            op, bucket if bucket is not None else 0, duration_ns,
            code, code_name, plan_hit, attempts, overlap_ns,
            ring_resident,
        )
        for obs in self._observers:
            # monitor plane (skew tracker / anomaly watchdog): amended
            # records are skipped above — an observer must never see
            # the same call twice
            try:
                obs(meta, duration_ns, code)
            except Exception:  # pragma: no cover - defensive
                pass

    # -- views ---------------------------------------------------------------
    def tail_dicts(self, n: int = ERROR_TAIL) -> List[dict]:
        return self.recorder.tail_dicts(n)

    def chrome_events(self, wire: bool = True) -> List[dict]:
        """This rank's records as Chrome/Perfetto complete events.

        ``pid`` = rank, ``tid`` 0 = the engine tier's call stream, ``tid``
        1 = buffered wire events (instants).  Names use the
        ``accl::<op>`` convention of the JAX package's export, so the two
        packages' timelines line up span for span.
        """
        events: List[dict] = [
            {
                "ph": "M", "name": "process_name", "pid": self.rank,
                "tid": 0, "args": {"name": f"rank {self.rank}"},
            },
            {
                "ph": "M", "name": "thread_name", "pid": self.rank,
                "tid": 0, "args": {"name": self.tier},
            },
        ]
        flows = flows_enabled()
        for rec in self.recorder.tail():
            events.append(record_event(rec, self.rank))
            if flows:
                events.extend(flow_events_for(rec, self.rank))
        if wire:
            # The wire ring is PROCESS-wide (one fabric serves every
            # in-process rank handle), so wire events export under the
            # OS pid as their own process row — never under a rank pid,
            # which would misattribute shared-fabric traffic.  In-process
            # multi-rank exports each embed the same events; merge_traces
            # dedups identical wire instants so the merged timeline
            # carries one copy per process.
            wire_pid = os.getpid()
            wsnap = wire_events()
            if wsnap:
                events.append({
                    "ph": "M", "name": "process_name", "pid": wire_pid,
                    "tid": 1, "args": {"name": f"wire (pid {wire_pid})"},
                })
            for ev in wsnap:
                events.append({
                    "name": ev["event"][:64],
                    "cat": "wire",
                    "ph": "i",
                    "s": "t",
                    "ts": ev["ts_us"],
                    "pid": wire_pid,
                    "tid": 1,
                    "args": {"src": ev["src"], "event": ev["event"]},
                })
            if flows:
                # delivered piggybacked trace ids: wire-hop steps on
                # the flow (cat "wire.flow" so merge_traces dedups the
                # process-wide ring like the wire instants)
                for fv in wire_flow_events():
                    events.append({
                        "name": "accl::flow",
                        "cat": "wire.flow",
                        "ph": "t",
                        "id": f"0x{fv['id']:08x}",
                        "ts": fv["ts_us"],
                        "pid": wire_pid,
                        "tid": 1,
                        "args": {
                            "src": fv["src"], "dst": fv["dst"],
                            "comm": fv["comm"],
                        },
                    })
        events.sort(key=lambda e: e.get("ts", 0.0))
        return events


def flow_events_for(rec: CallRecord, rank: int) -> List[dict]:
    """One CallRecord's Perfetto flow events (Chrome ``s``/``t``/``f``
    phases): the cross-rank causal linkage.  Every rank of a collective
    derives the same ``trace_id`` and a deterministic phase — the
    lowest comm rank starts the flow (``s``), the highest finishes it
    (``f``), middles are steps (``t``) — so the MERGED timeline carries
    exactly one matched s/f pair per collective plus steps, and a
    send→recv pair contributes the sender's ``s`` and the receiver's
    ``f``.  Name and category are uniform (``accl::flow``) because
    Chrome binds flows by (cat, name, id)."""
    if not rec.trace_id or rec.trace_phase not in ("s", "t", "f"):
        return []
    dur_us = rec.duration_ns / 1e3
    end_us = _perf_to_epoch_us(rec.end_perf_ns)
    ev = {
        "name": "accl::flow",
        "cat": "accl.flow",
        "ph": rec.trace_phase,
        "id": f"0x{rec.trace_id:08x}",
        # anchored INSIDE the span (mid-point): flows bind to the
        # enclosing slice, and span starts/ends can coincide across
        # ranks on a fast mesh
        "ts": round(end_us - dur_us / 2, 3),
        "pid": rank,
        "tid": 0,
        "args": {"op": rec.op, "comm": rec.comm},
    }
    if rec.trace_phase == "f":
        ev["bp"] = "e"  # bind to the enclosing slice, Perfetto-style
    out = [ev]
    if rec.parent_id:
        # parent/child nesting (pipelined segments, batched calls):
        # a step on the PARENT's flow anchored at this child's span —
        # the merged timeline draws aggregate→segment arrows
        out.append({
            "name": "accl::flow",
            "cat": "accl.flow",
            "ph": "t",
            "id": f"0x{rec.parent_id:08x}",
            "ts": round(end_us - dur_us / 2, 3),
            "pid": rank,
            "tid": 0,
            "args": {"op": rec.op, "child": rec.trace_id},
        })
    return out


def validate_flows(events: List[dict]) -> List[str]:
    """Flow well-formedness over a (merged) event list: every flow
    start (``s``) must have at least one finish (``f``) and every
    finish a start — an unmatched end means a rank's span went missing
    from the merge (or a derivation diverged), which is exactly what
    the causal plane exists to surface.  Steps (``t``) are advisory
    and never error.  Returns human-readable problems ([] = valid)."""
    starts: Dict[str, int] = {}
    finishes: Dict[str, int] = {}
    for e in events:
        if e.get("cat") not in ("accl.flow", "wire.flow"):
            continue
        fid = str(e.get("id"))
        ph = e.get("ph")
        if ph == "s":
            starts[fid] = starts.get(fid, 0) + 1
        elif ph == "f":
            finishes[fid] = finishes.get(fid, 0) + 1
    problems = []
    for fid in sorted(set(starts) - set(finishes)):
        problems.append(f"flow {fid}: start without a finish")
    for fid in sorted(set(finishes) - set(starts)):
        problems.append(f"flow {fid}: finish without a start")
    return problems


def validate_flow_docs(docs: List[dict]) -> List[str]:
    """The merge CLI's truncation-aware form of :func:`validate_flows`:
    flight recorders are bounded rings, so a long run legitimately
    evicts one rank's old flow events while a peer's matching end
    survives.  Any flow carrying an event OLDER than the latest
    "earliest flow event" across the input files (the common covered
    window) is exempted whole — its counterpart may simply have rolled
    out.  A genuinely missing rank file contributes no floor, so its
    unmatched counterparts still error, which is the case the
    validation exists to catch."""
    events: List[dict] = []
    floor = None
    for doc in docs:
        evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
        evs = list(evs or ())
        events.extend(evs)
        ts = [
            e.get("ts", 0.0) for e in evs
            if e.get("cat") == "accl.flow"
        ]
        if ts:
            m = min(ts)
            floor = m if floor is None else max(floor, m)
    if floor is not None:
        exempt = {
            str(e.get("id")) for e in events
            if e.get("cat") == "accl.flow" and e.get("ts", 0.0) < floor
        }
        if exempt:
            events = [
                e for e in events
                if not (
                    e.get("cat") == "accl.flow"
                    and str(e.get("id")) in exempt
                )
            ]
    return validate_flows(events)


def record_event(rec: CallRecord, rank: int) -> dict:
    """One CallRecord as a Chrome/Perfetto complete event — the single
    rendering both the on-demand exporter (:meth:`Telemetry.
    chrome_events`) and the monitor plane's streaming writer use, so
    streamed and exported timelines line up event-for-event."""
    dur_us = rec.duration_ns / 1e3
    end_us = _perf_to_epoch_us(rec.end_perf_ns)
    return {
        "name": f"accl::{rec.op}",
        "cat": "accl",
        "ph": "X",
        "ts": round(end_us - dur_us, 3),
        "dur": round(dur_us, 3),
        "pid": rank,
        "tid": 0,
        "args": {
            k: v for k, v in rec.as_dict().items()
            if k not in ("op", "end_us") and v is not None
        },
    }


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def to_json(snapshot: dict) -> str:
    """The snapshot as canonical JSON (sorted keys, no NaN)."""
    return json.dumps(snapshot, sort_keys=True, default=str)


def _prom_escape(value) -> str:
    """Prometheus label-value escaping (exposition format): backslash,
    double quote and newline must be escaped or an op/comm id carrying
    one corrupts every later line of the scrape."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(**labels) -> str:
    inner = ",".join(
        f'{k}="{_prom_escape(v)}"'
        for k, v in sorted(labels.items()) if v is not None
    )
    return "{" + inner + "}" if inner else ""


def to_prometheus(snapshot: dict) -> str:
    """Render a ``telemetry_snapshot()`` dict as Prometheus text
    exposition (counters, gauges, and the per-(op × size-bucket) latency
    histograms with cumulative log2-us ``le`` buckets)."""
    rank = snapshot.get("rank")
    tier = snapshot.get("tier")
    base = {"rank": rank, "tier": tier}
    lines: List[str] = []

    metrics = snapshot.get("metrics") or {}
    counters = metrics.get("counters") or {}
    seen_types = set()
    for key, val in sorted(counters.items()):
        parts = key.split("|")
        name, labels = parts[0], parts[1:]
        if name not in seen_types:
            lines.append(f"# TYPE {name} counter")
            seen_types.add(name)
        lbl = dict(base)
        if labels:
            # compression counters label by wire lane, not collective op
            key0 = (
                "wire" if name.startswith("accl_compression_") else "op"
            )
            lbl[key0] = labels[0]
        if len(labels) > 1:
            lbl["code"] = labels[1]
        lines.append(f"{name}{_prom_labels(**lbl)} {val}")

    hist = metrics.get("histograms") or {}
    if hist:
        lines.append("# TYPE accl_call_duration_us histogram")
    for _key, h in sorted(hist.items()):
        lbl = dict(base, op=h["op"], size_bucket=h["size_bucket"])
        cum = 0
        for k, v in sorted(h["log2_us"].items(), key=lambda kv: int(kv[0])):
            cum += v
            le = 2 ** (int(k) + 1)
            lines.append(
                "accl_call_duration_us_bucket"
                f"{_prom_labels(le=le, **lbl)} {cum}"
            )
        lines.append(
            "accl_call_duration_us_bucket"
            f'{_prom_labels(le="+Inf", **lbl)} {h["count"]}'
        )
        lines.append(
            f"accl_call_duration_us_sum{_prom_labels(**lbl)} "
            f"{h['sum_ns'] / 1e3:.3f}"
        )
        lines.append(
            f"accl_call_duration_us_count{_prom_labels(**lbl)} {h['count']}"
        )

    # scalar gauges folded out of the merged snapshot (engine report,
    # plan cache): only numbers — structure stays in the JSON exporter.
    # ONE TYPE line per metric name however many label sets it carries:
    # a second TYPE line for the same name is invalid exposition and
    # fails the whole scrape (the per-(comm, peer) straggler gauges
    # would emit one per peer without the dedup)
    def gauge(name: str, value, **labels) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        if name not in seen_types:
            lines.append(f"# TYPE {name} gauge")
            seen_types.add(name)
        lines.append(f"{name}{_prom_labels(**dict(base, **labels))} {value}")

    gauge("accl_device_interactions", snapshot.get("device_interactions"))
    pc = snapshot.get("plan_cache") or {}
    for k in ("hits", "misses", "invalidations", "size"):
        gauge(f"accl_plan_cache_{k}", pc.get(k))
    gauge("accl_flight_records", len(snapshot.get("flight_recorder") or ()))
    engine = snapshot.get("engine") or {}
    for k, v in sorted(engine.items()):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            gauge(f"accl_engine_{k}", v)
        elif isinstance(v, dict):
            for kk, vv in sorted(v.items()):
                if isinstance(vv, (int, float)) and not isinstance(vv, bool):
                    gauge(f"accl_engine_{k}_{kk}", vv)

    # command-ring plane (the persistent sequencer): the sustained-
    # occupancy gauge (refill windows served per program dispatch — the
    # persistence evidence, >1 means the run survived across refills),
    # per-opcode ring-residency counters and per-reason fallbacks.  The
    # scalar ring counters (refills/dispatches/mailbox_posts/...) ride
    # the generic accl_engine_cmdring_* folding above; these are the
    # labeled third-level dicts that folding cannot reach.
    ring = engine.get("cmdring") or {}
    gauge(
        "accl_cmdring_sustained_occupancy",
        ring.get("sustained_occupancy"),
    )
    for opname, cnt in sorted((ring.get("ops") or {}).items()):
        gauge("accl_cmdring_op_slots_total", cnt, op=opname)
    for reason, cnt in sorted((ring.get("fallbacks") or {}).items()):
        gauge("accl_cmdring_fallbacks_total", cnt, reason=reason)
    # ring introspection (the causal trace plane): mailbox depth (how
    # far the host runs ahead of the sequencer), the run-thread state
    # as a numeric gauge (0 parked / 1 resident / 2 armed), and the
    # refill-window latency histogram (log2-us buckets, host basis)
    gauge("accl_cmdring_mailbox_depth", ring.get("mailbox_depth"))
    gauge("accl_cmdring_windows_total", ring.get("windows_logged"))
    state = ring.get("state")
    if state is not None:
        gauge(
            "accl_cmdring_run_state",
            {"parked": 0, "resident": 1, "armed": 2}.get(state, -1),
        )
    wl = ring.get("window_latency_log2_us") or {}
    if wl:
        # a REAL Prometheus histogram (cumulative _bucket / +Inf /
        # _sum / _count — the accl_call_duration_us pattern): raw
        # per-bucket gauges with an `le` label would feed
        # histogram_quantile garbage
        lines.append("# TYPE accl_cmdring_window_latency_us histogram")
        seen_types.add("accl_cmdring_window_latency_us")
        cum = 0
        for k, v in sorted(wl.items(), key=lambda kv: int(kv[0])):
            cum += v
            lines.append(
                "accl_cmdring_window_latency_us_bucket"
                f"{_prom_labels(le=2 ** (int(k) + 1), **base)} {cum}"
            )
        lines.append(
            "accl_cmdring_window_latency_us_bucket"
            f'{_prom_labels(le="+Inf", **base)} {cum}'
        )
        lines.append(
            "accl_cmdring_window_latency_us_sum"
            f"{_prom_labels(**base)} "
            f"{ring.get('window_latency_sum_us') or 0.0:.3f}"
        )
        lines.append(
            f"accl_cmdring_window_latency_us_count"
            f"{_prom_labels(**base)} {cum}"
        )

    # quantized wire plane: error-feedback health (the residual-norm
    # gauge is THE convergence signal — a norm growing without bound
    # means the wire verdict is too aggressive for the workload)
    comp = snapshot.get("compression") or {}
    ef = comp.get("error_feedback") or {}
    gauge(
        "accl_compression_ef_enabled", int(bool(ef.get("enabled")))
    )
    gauge("accl_compression_ef_entries", ef.get("entries"))
    # (ef updates are NOT re-exported here: the wire-labeled
    # accl_compression_ef_updates_total counter from the facade's
    # intake path already carries them — a second unlabeled sample
    # would double every sum() over the metric)
    gauge(
        "accl_compression_residual_norm", ef.get("max_residual_norm")
    )
    gauge("accl_compression_sr_calls_total", comp.get("sr_calls"))

    # QoS arbiter plane: per-tenant admission counters/gauges and the
    # per-tenant completion-latency histogram — a REAL Prometheus
    # histogram (cumulative _bucket / +Inf / _sum / _count, the
    # accl_call_duration_us pattern) so histogram_quantile() serves the
    # per-tenant p99 the fairness gate reads live
    arb = snapshot.get("tenants") or {}
    tenants = arb.get("tenants") or {}
    gauge("accl_tenant_arbiter_enabled", int(bool(arb.get("enabled"))))
    gauge("accl_tenant_rounds_total", arb.get("rounds"))
    gauge("accl_tenant_grant_timeouts_total", arb.get("grant_timeouts"))
    gauge("accl_tenant_passthrough_total", arb.get("passthrough"))
    for _cid, t in sorted(tenants.items()):
        lbl = {"tenant": t.get("name"), "tenant_class": t.get("class")}
        gauge("accl_tenant_weight", t.get("weight"), **lbl)
        gauge("accl_tenant_admitted_total", t.get("admitted"), **lbl)
        gauge("accl_tenant_completed_total", t.get("completed"), **lbl)
        gauge(
            "accl_tenant_cost_granted_bytes_total",
            t.get("cost_granted_bytes"), **lbl,
        )
        gauge(
            "accl_tenant_grant_wait_ns_total",
            t.get("grant_wait_ns_total"), **lbl,
        )
        gauge(
            "accl_tenant_throttle_ns_total",
            t.get("throttle_ns_total"), **lbl,
        )
        gauge("accl_tenant_outstanding", t.get("outstanding"), **lbl)
        gauge("accl_tenant_queued", t.get("queued"), **lbl)
        gauge(
            "accl_tenant_over_admissions_total",
            t.get("over_admissions"), **lbl,
        )
        lat = t.get("latency") or {}
        buckets = lat.get("log2_us") or {}
        if buckets:
            if "accl_tenant_call_duration_us" not in seen_types:
                lines.append(
                    "# TYPE accl_tenant_call_duration_us histogram"
                )
                seen_types.add("accl_tenant_call_duration_us")
            hlbl = dict(base, **lbl)
            cum = 0
            for k, v in sorted(
                buckets.items(), key=lambda kv: int(kv[0])
            ):
                cum += v
                lines.append(
                    "accl_tenant_call_duration_us_bucket"
                    f"{_prom_labels(le=2 ** (int(k) + 1), **hlbl)} {cum}"
                )
            lines.append(
                "accl_tenant_call_duration_us_bucket"
                f'{_prom_labels(le="+Inf", **hlbl)} {lat.get("count", cum)}'
            )
            lines.append(
                f"accl_tenant_call_duration_us_sum{_prom_labels(**hlbl)} "
                f"{(lat.get('sum_ns') or 0) / 1e3:.3f}"
            )
            lines.append(
                "accl_tenant_call_duration_us_count"
                f"{_prom_labels(**hlbl)} {lat.get('count', cum)}"
            )

    # postmortem plane: bundle accounting (the lifetime counter also
    # rides accl_postmortem_bundles_total in the counters section)
    pm = snapshot.get("postmortem") or {}
    gauge("accl_postmortem_enabled", int(bool(pm.get("enabled"))))
    gauge("accl_postmortem_bundles", pm.get("bundles_written"))
    gauge("accl_postmortem_solicit_timeouts", pm.get("solicit_timeouts"))

    # membership plane (elastic membership): the epoch gauge, eviction/
    # demotion/restore counters, per-(comm, rank) demotion breaker
    # states, and the health-transition edge counters — the
    # accl_membership_* / accl_health_transitions_total surface the
    # live monitor serves
    mem = snapshot.get("membership") or {}
    gauge("accl_membership_epoch", mem.get("epoch"))
    gauge("accl_membership_elastic", int(bool(mem.get("elastic"))))
    gauge("accl_membership_evicted_ranks", len(mem.get("evicted") or ()))
    gauge("accl_membership_evictions_total", mem.get("evictions_total"))
    gauge("accl_membership_restores_total", mem.get("restores_total"))
    gauge("accl_membership_proposals_total", mem.get("proposals"))
    demo = mem.get("demotion") or {}
    gauge("accl_membership_demotions_total", demo.get("demotions_total"))
    gauge(
        "accl_membership_demotion_restores_total",
        demo.get("restores_total"),
    )
    for key, brk in sorted((demo.get("breakers") or {}).items()):
        comm, _, peer = key.partition("/")
        gauge(
            "accl_membership_demoted", int(brk.get("state") != "closed"),
            comm=comm, peer=peer,
        )
    he = snapshot.get("health_events") or {}
    gauge("accl_health_transition_events", he.get("transitions_total"))
    for key, v in sorted((he.get("counters") or {}).items()):
        parts = key.split("|")
        if len(parts) != 3:
            continue
        gauge(
            "accl_health_transitions_total", v,
            **{"peer": parts[0], "from": parts[1], "to": parts[2]},
        )

    # monitor plane (live observability): per-peer straggler EWMA lags,
    # standing slow_rank verdicts, anomaly alert totals, scrape counts —
    # the gauges a dashboard alerts on
    strag = snapshot.get("stragglers") or {}
    for comm, ranks in sorted((strag.get("ewma_wait_lag_us") or {}).items()):
        for r, v in sorted(ranks.items()):
            gauge("accl_straggler_ewma_wait_lag_us", v, comm=comm, peer=r)
    for comm, ranks in sorted((strag.get("ewma_latency_us") or {}).items()):
        for r, v in sorted(ranks.items()):
            gauge("accl_straggler_ewma_latency_us", v, comm=comm, peer=r)
    for comm, v in sorted((strag.get("standing") or {}).items()):
        gauge("accl_straggler_slow_rank", v.get("rank"), comm=comm)
    gauge("accl_straggler_windows_judged", strag.get("windows_judged"))
    gauge("accl_straggler_verdicts", len(strag.get("verdicts") or ()))
    anom = snapshot.get("anomalies") or {}
    gauge("accl_anomaly_alerts_total", anom.get("alerts_total"))
    mon = snapshot.get("monitor") or {}
    server = mon.get("server") or {}
    if server.get("scrapes"):
        gauge("accl_monitor_scrapes_total", sum(server["scrapes"].values()))
        gauge("accl_monitor_scrape_errors_total", server.get("errors"))
    stream = mon.get("trace_stream") or {}
    gauge("accl_trace_stream_events_total", stream.get("events_streamed"))
    return "\n".join(lines) + "\n"


def chrome_trace(events: List[dict]) -> dict:
    """Wrap event lists in the Chrome/Perfetto JSON object form."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def merge_traces(docs: List[dict]) -> dict:
    """Fold per-rank trace documents into one timeline.  Events keep
    their own ``pid`` (= rank; wire rows ride the OS pid); the result is
    sorted by ``ts`` so the merged file is monotonically consistent.
    Wire/metadata events are deduplicated — in-process multi-rank
    exports each embed the same process-wide wire ring, and the merged
    timeline must carry one copy per process, not one per rank file."""
    merged: List[dict] = []
    seen: set = set()
    for doc in docs:
        evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
        for e in evs or ():
            # process-wide rows every in-process rank file embeds
            # (wire instants, wire-flow steps, cmdring spans, metadata)
            # merge to ONE copy per process
            if e.get("cat") in ("wire", "wire.flow", "cmdring") or (
                e.get("ph") == "M"
            ):
                key = json.dumps(e, sort_keys=True)
                if key in seen:
                    continue
                seen.add(key)
            merged.append(e)
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return chrome_trace(merged)


# ---------------------------------------------------------------------------
# CLI: python -m accl_tpu_torch.telemetry merge --out merged.json rank*.json
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m accl_tpu_torch.telemetry",
        description="telemetry artifact tools",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser(
        "merge",
        help="fold per-rank Chrome/Perfetto trace files into one "
             "timeline (open the result in ui.perfetto.dev or "
             "chrome://tracing)",
    )
    mp.add_argument("inputs", nargs="+", help="per-rank trace JSON files")
    mp.add_argument("--out", "-o", default="-",
                    help="merged trace path (default: stdout)")
    mp.add_argument(
        "--no-flow-check", action="store_true",
        help="skip the flow well-formedness validation (every flow "
             "start needs a finish and vice versa — unmatched ends "
             "are an error by default: they mean a rank's file is "
             "missing from the merge or an id derivation diverged)",
    )
    args = ap.parse_args(argv)

    docs = []
    for path in args.inputs:
        with open(path) as f:
            doc = json.load(f)
        evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
        if not evs:
            raise SystemExit(f"{path}: no traceEvents — refusing to merge "
                             "an empty/malformed trace")
        docs.append(doc)
    merged = merge_traces(docs)
    if not args.no_flow_check:
        # truncation-aware: flows partially evicted from a rank's
        # bounded flight ring are exempt; a MISSING rank file still
        # errors (validate_flow_docs explains the floor rule)
        problems = validate_flow_docs(docs)
        if problems:
            head = "; ".join(problems[:8])
            raise SystemExit(
                f"merged trace has {len(problems)} unmatched flow "
                f"end(s): {head} — a rank file is missing from the "
                "merge or a trace-id derivation diverged (pass "
                "--no-flow-check to merge anyway)"
            )
    text = json.dumps(merged)
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        import sys

        print(
            f"wrote {args.out}: {len(merged['traceEvents'])} events from "
            f"{len(docs)} rank files",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
